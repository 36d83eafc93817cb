"""Static HTML session report — the offline stand-in for the reference's
flask visualization server + web UI
(src/third_party/anipose/server.py:1-60 session browser,
/pose3d + /pose2dproj data routes, static/index.html viewer).

A flask app serving editable behavior labels makes no sense for an
offline batch framework; the equivalent deliverable is a browsable
report: one self-contained ``report.html`` per project listing every
session/recording with tracking-quality statistics, per-bodypart error
tables, trajectory plots, and inline <video> players for every rendered
artifact (videos-labeled / videos-3d / videos-combined).

Port of ``macaque_tpu/tools/report.py``, the same host code; pandas and
matplotlib are imported by the functions that use them.
"""

from __future__ import annotations

import html
import os
from glob import glob

import numpy as np

from macaque_tpu_torch.tools.session import (
    get_folders, natural_keys, true_basename,
)

_CSS = """
body { font-family: system-ui, sans-serif; margin: 2em auto;
       max-width: 1100px; color: #222; }
h1 { border-bottom: 2px solid #444; }
h2 { margin-top: 2em; color: #335; }
table { border-collapse: collapse; margin: 0.6em 0; }
td, th { border: 1px solid #bbb; padding: 3px 9px; font-size: 13px; }
th { background: #eef; }
video { max-width: 480px; margin: 4px; border: 1px solid #999; }
.stat { display: inline-block; background: #f4f6fa; border-radius: 6px;
        padding: 6px 14px; margin: 3px; font-size: 14px; }
.plot { max-width: 520px; border: 1px solid #ccc; margin: 4px; }
"""


def _pose3d_stats(csv_fname: str):
    import pandas as pd

    data = pd.read_csv(csv_fname)
    cols = [c for c in data.columns if c.endswith("_error")]
    bodyparts = [c[: -len("_error")] for c in cols]
    rows = []
    for bp in bodyparts:
        err = np.asarray(data[f"{bp}_error"], float)
        score = np.asarray(data[f"{bp}_score"], float)
        ncams = np.asarray(data[f"{bp}_ncams"], float)
        ok = np.isfinite(err)
        rows.append({
            "bodypart": bp,
            "tracked_%": 100.0 * ok.mean(),
            "err_mean_px": float(np.nanmean(err)) if ok.any() else np.nan,
            "err_p95_px": float(np.nanpercentile(err, 95))
            if ok.any() else np.nan,
            "score_mean": float(np.nanmean(score)),
            "ncams_mean": float(np.nanmean(ncams)),
        })
    n_frames = len(data)
    return rows, n_frames


def _traj_plot(csv_fname: str, out_png: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    data = pd.read_csv(csv_fname)
    cols = [c for c in data.columns if c.endswith("_error")]
    bodyparts = [c[: -len("_error")] for c in cols]
    fig, axes = plt.subplots(2, 1, figsize=(7, 5), sharex=True)
    for bp in bodyparts[:6]:
        axes[0].plot(data[f"{bp}_x"], lw=0.7, label=bp)
        axes[1].plot(data[f"{bp}_error"], lw=0.7)
    axes[0].set_ylabel("x (mm)")
    axes[0].legend(fontsize=6, ncol=3)
    axes[1].set_ylabel("reproj err (px)")
    axes[1].set_xlabel("frame")
    fig.tight_layout()
    fig.savefig(out_png, dpi=90)
    plt.close(fig)
    return out_png


def _fmt_table(rows: list[dict]) -> str:
    if not rows:
        return "<p>(no data)</p>"
    keys = list(rows[0].keys())
    out = ["<table><tr>"]
    out += [f"<th>{html.escape(str(k))}</th>" for k in keys]
    out.append("</tr>")
    for r in rows:
        out.append("<tr>")
        for k in keys:
            v = r[k]
            if isinstance(v, float):
                v = f"{v:.2f}"
            out.append(f"<td>{html.escape(str(v))}</td>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _session_block(config: dict, session_path: str, report_dir: str):
    pipe = config["pipeline"]
    rel = os.path.relpath(session_path, config["path"]) or "."
    parts = [f"<h2>Session: {html.escape(rel)}</h2>"]

    pose3d_files = sorted(glob(os.path.join(
        session_path, pipe["pose_3d"], "*.csv")), key=natural_keys)
    for csvf in pose3d_files:
        name = true_basename(csvf)
        rows, n_frames = _pose3d_stats(csvf)
        tracked = np.mean([r["tracked_%"] for r in rows]) if rows else 0
        err = np.nanmean([r["err_mean_px"] for r in rows]) if rows \
            else np.nan
        parts.append(f"<h3>{html.escape(name)}</h3>")
        parts.append(
            f"<span class='stat'>{n_frames} frames</span>"
            f"<span class='stat'>tracked {tracked:.1f}%</span>"
            f"<span class='stat'>mean reproj err {err:.2f} px</span>"
        )
        png = os.path.join(report_dir, "plots",
                           f"{rel.replace(os.sep, '_')}_{name}.png")
        os.makedirs(os.path.dirname(png), exist_ok=True)
        try:
            _traj_plot(csvf, png)
            rel_png = os.path.relpath(png, report_dir)
            parts.append(f"<br><img class='plot' src='{rel_png}'>")
        except Exception as e:  # plotting must never kill the report
            parts.append(f"<p>(plot failed: {html.escape(str(e))})</p>")
        parts.append("<details><summary>per-bodypart stats</summary>"
                     + _fmt_table(rows) + "</details>")

    # calibration errors, if computed
    cal_csv = os.path.join(session_path, pipe["calibration_results"],
                           "calibration_errors.csv")
    if os.path.exists(cal_csv):
        import pandas as pd

        parts.append("<h3>Calibration errors</h3>")
        parts.append(_fmt_table(
            pd.read_csv(cal_csv).to_dict("records")))

    # rendered videos
    for key, label in (("videos_labeled_2d", "2D labeled"),
                       ("videos_labeled_3d", "3D"),
                       ("videos_combined", "combined")):
        vdir = os.path.join(session_path, pipe.get(
            key, key.replace("_", "-")))
        vids = sorted(glob(os.path.join(vdir, "*.mp4")),
                      key=natural_keys)
        if not vids:
            continue
        parts.append(f"<h3>{label} videos</h3>")
        for v in vids:
            rel_v = os.path.relpath(v, report_dir)
            parts.append(
                f"<figure style='display:inline-block'>"
                f"<video controls preload='metadata' "
                f"src='{rel_v}'></video>"
                f"<figcaption>{html.escape(os.path.basename(v))}"
                f"</figcaption></figure>")
    return "".join(parts)


def generate_report(config: dict, out_dir: str | None = None) -> str:
    """Walk every session of the project and write
    ``<project>/report/report.html``. Returns the html path."""
    root = config["path"]
    report_dir = out_dir or os.path.join(root, "report")
    os.makedirs(report_dir, exist_ok=True)

    nesting = config["nesting"]
    sessions = [root]
    level = 0
    while level < nesting:
        nxt = []
        for s in sessions:
            nxt += [os.path.join(s, f) for f in get_folders(s)]
        sessions = nxt or sessions
        level += 1

    body = [f"<h1>{html.escape(config['project'])} — tracking report"
            f"</h1>"]
    for s in sorted(sessions, key=natural_keys):
        body.append(_session_block(config, s, report_dir))

    html_doc = ("<!doctype html><html><head><meta charset='utf-8'>"
                f"<title>{html.escape(config['project'])}</title>"
                f"<style>{_CSS}</style></head><body>"
                + "".join(body) + "</body></html>")
    out = os.path.join(report_dir, "report.html")
    with open(out, "w") as f:
        f.write(html_doc)
    return out
