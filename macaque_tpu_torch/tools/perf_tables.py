"""Regenerate the port's README and PERF.md performance tables from a
benchmark line, so that the documents' numbers cannot drift from the last
measurement (the JAX package's ``tools/perf_tables.py``).

Usage::

    python -m macaque_tpu_torch.tools.perf_tables     # newest card BENCH_r*.json
    python -m macaque_tpu_torch.tools.perf_tables --bench line.json

Accepts a bench artifact (``{"rc": .., "parsed": {...}}``) or a raw
``bench.py``-shaped line, with the JAX tool's keys
(``detail.kernel_ms_per_chunk.{det,pose,id,tri}``, ``kernel_cf_s``,
``_int8``, ``_serving``, ``_fast``, ``det_fast_ms``, ``det_640_ms``,
``pose_int8_ms``, ``pose_noflip_int8_ms``,
``pipeline.{camera_frames,stages_s,pipeline_rest_s,pipeline_rest_s_per_cf}``,
``tier_note``, ``value``). The tables, rows, rounding and paragraphs are
the JAX tool's, with these departures and no other:

- **Only the card's numbers.** A line must name the device it ran on:
  ``device`` at the top of the line, else in ``detail``, else in
  ``detail.pipeline`` (where ``tools/pipeline_bench.py`` puts the card's
  name and power limit, as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them). A
  line with no device, or with ``cpu``, is refused: the tool exits with a
  message and writes nothing. With no ``--bench`` it takes the newest
  ``BENCH_r*.json`` whose parsed line names a card, and exits if none
  does (the TPU runs' lines name none).
- **The device in the blocks.** The README table's header reads
  ``camera-frames/s (1x <device>)`` where the JAX tool's reads
  ``(1x v5e)``, and the PERF.md paragraph opens ``Bench on <device> (``
  where the JAX tool's opens ``Bench (``.
- **Its own name and markers.** The generated-by comment names
  ``macaque_tpu_torch/tools/perf_tables.py``. The tool rewrites the text
  between ``<!-- TORCH_BENCH:START -->`` and ``<!-- TORCH_BENCH:END -->``:
  the README block in README.md's port section, the architecture block in
  PERF.md §5. It never touches the JAX tool's ``BENCH`` markers, nor
  ARCHITECTURE.md.
- **Its own pointers.** "ARCHITECTURE.md §3b" becomes "PERF.md §1 and
  §6" (the tiers, and the kernels against their bounds), and the
  architecture block's "Tier semantics in §3b." becomes "Tier semantics
  in PERF.md §1.".

The reference's 6.4 camera-frames/s stays labelled as its aggregate on a
Quadro RTX 8000 (info_replication.md:44-45, as the JAX tool has it).
This module imports only the standard library.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

BASELINE = 6.4  # reference cf/s aggregate (info_replication.md:44-45)
START, END = "<!-- TORCH_BENCH:START -->", "<!-- TORCH_BENCH:END -->"
GENERATED = ("<!-- generated by macaque_tpu_torch/tools/perf_tables.py "
             "from {src}; do not hand-edit -->")


def repo_root() -> str:
    """The checkout that holds this package (the JAX tool takes it from
    ``core/compile_cache.py``, which the port does not have)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def card_of(p: dict) -> str | None:
    """The card the line names (its ``device`` at the top, then in
    ``detail``, then in ``detail.pipeline``), or None where it names no
    device or the CPU."""
    d = p.get("detail") or {}
    for where in (p, d, d.get("pipeline") or {}):
        if where.get("device"):
            dev = str(where["device"])
            return None if dev.strip().lower().startswith("cpu") else dev
    return None


def card_name(p: dict, src: str) -> str:
    """The card the line names; exits when it names none."""
    dev = card_of(p)
    if dev is None:
        raise SystemExit(f"{src}: the line names no card; only a line "
                         "measured on the card is rendered")
    return dev


def load_bench(path: str | None) -> tuple[dict, str]:
    root = repo_root()
    if path is None:
        candidates = sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))
        for cand in reversed(candidates):
            with open(cand) as f:
                art = json.load(f)
            if (isinstance(art, dict) and isinstance(art.get("parsed"), dict)
                    and card_of(art["parsed"])):
                return art["parsed"], os.path.basename(cand)
        raise SystemExit("no BENCH_r*.json with a parsed result measured on "
                         "the card found")
    with open(path) as f:
        data = json.load(f)
    src = os.path.basename(path)
    if "parsed" in data and isinstance(data.get("parsed"), dict):
        data = data["parsed"]
    card_name(data, src)
    return data, src


def fmt_x(v: float) -> str:
    return f"{v / BASELINE:.1f}x"


def _ms(v: float) -> str:
    return "<1" if v < 1 else f"{v:.0f}"


def readme_block(p: dict, src: str) -> str:
    dev = card_name(p, src)
    d = p["detail"]
    k = d["kernel_ms_per_chunk"]
    rows = [
        ("parity — exact mmdet/mmpose test cfg (1000 RoIs, flip test, "
         "bf16)", d.get("kernel_cf_s")),
        ("int8 pose (quantization bounded by tests, flip kept)",
         d.get("kernel_cf_s_int8")),
        ("serving — smaller RPN/RoI budgets (512/128), int8 pose",
         d.get("kernel_cf_s_serving")),
        ("fast — serving @640-target detector, single-pass int8 pose",
         d.get("kernel_cf_s_fast")),
    ]
    lines = [
        GENERATED.format(src=src),
        "",
        f"| tier (semantics) | camera-frames/s (1x {dev}) | vs reference "
        "~6.4 aggregate (RTX 8000) |",
        "|---|---|---|",
    ]
    for label, v in rows:
        if v is not None:
            lines.append(f"| {label} | **{v:.1f}** | {fmt_x(v)} |")
    det_bits = [f"{k['det']:.0f} ms parity"]
    if "det_fast_ms" in d:
        det_bits.append(f"{d['det_fast_ms']:.0f} serving")
    if "det_640_ms" in d:
        det_bits.append(f"{d['det_640_ms']:.0f} fast-640")
    pose_bits = [f"{k['pose']:.0f} ms bf16-flip"]
    if "pose_int8_ms" in d:
        pose_bits.append(f"{d['pose_int8_ms']:.0f} int8-flip")
    if "pose_noflip_int8_ms" in d:
        pose_bits.append(f"{d['pose_noflip_int8_ms']:.0f} single-pass int8")
    para = (f"Per 16-frame chunk: detection {' / '.join(det_bits)}, "
            f"pose (ViT-huge) {' / '.join(pose_bits)}, "
            f"ID {k['id']:.0f} ms, triangulation {_ms(k['tri'])} ms.")
    pipe = d.get("pipeline")
    if pipe:
        para += (
            f" The non-kernel pipeline (video decode, tracking, "
            f"cross-view/cross-frame graphs, 3D refinement, render) adds "
            f"~{pipe['pipeline_rest_s_per_cf'] * 1000:.1f} ms per "
            f"camera-frame of wall clock, measured end-to-end on the "
            f"synthetic {pipe['camera_frames'] // 120}-camera scene."
        )
        if "additive" in d.get("tier_note", ""):
            para += (f" Combined additive e2e at parity semantics: "
                     f"**{p['value']:.1f} cf/s per chip**"
                     f" ({fmt_x(p['value'])}).")
        elif "PARITY" in d.get("tier_note", ""):
            para += (f" Measured parity e2e (locally-attached device): "
                     f"**{p['value']:.1f} cf/s per chip** "
                     f"({fmt_x(p['value'])}).")
    lines += ["", para,
              "Tier trade-offs and the full roofline analysis: "
              "PERF.md §1 and §6."]
    return "\n".join(lines)


def arch_block(p: dict, src: str) -> str:
    dev = card_name(p, src)
    d = p["detail"]
    k = d["kernel_ms_per_chunk"]
    tiers = []
    for key, label in (
            ("kernel_cf_s", "exact-mmdet parity bf16"),
            ("kernel_cf_s_int8", "int8 pose"),
            ("kernel_cf_s_serving", "serving budgets"),
            ("kernel_cf_s_fast", "fast tier")):
        if key in d:
            tiers.append(f"{d[key]:.1f} {label} ({fmt_x(d[key])})")
    para = (
        GENERATED.format(src=src) + "\n\n"
        f"Bench on {dev} (real model sizes, 4 dets/frame), per-tier kernel "
        f"throughput: **{', '.join(tiers)}** vs the reference's "
        f"{BASELINE} cf/s on an RTX 8000. Stage split per 16-frame "
        f"chunk: det {k['det']:.0f} ms parity"
    )
    if "det_fast_ms" in d:
        para += f" / {d['det_fast_ms']:.0f} serving"
    if "det_640_ms" in d:
        para += f" / {d['det_640_ms']:.0f} fast-640"
    para += f", pose {k['pose']:.0f} bf16"
    if "pose_int8_ms" in d:
        para += f" / {d['pose_int8_ms']:.0f} int8"
    if "pose_noflip_int8_ms" in d:
        para += f" / {d['pose_noflip_int8_ms']:.0f} single-pass int8"
    para += f", id {k['id']:.0f} ms, 3D {_ms(k['tri'])} ms."
    pipe = d.get("pipeline")
    if pipe:
        s = pipe["stages_s"]
        headline = (d.get("tier_note", "").split(";")[0]
                    .replace("value = ", ""))
        para += (
            f" Pipeline-rest: {pipe['pipeline_rest_s']:.1f} s per "
            f"{pipe['camera_frames']} camera-frames (step1 host "
            f"{s['step1_host']:.1f}, step4 3D {s['step4_3d']:.1f}, "
            f"render {s.get('render', 0):.1f}; headline "
            f"{p['value']:.1f} cf/s = {headline})."
        )
    para += " Tier semantics in PERF.md §1."
    return para


def rewrite(path: str, block: str) -> bool:
    with open(path) as f:
        text = f.read()
    pat = re.compile(f"({re.escape(START)}\n).*?(\n{re.escape(END)})",
                     re.DOTALL)
    if not pat.search(text):
        print(f"{path}: no TORCH_BENCH markers found", file=sys.stderr)
        return False
    new = pat.sub(lambda m: m.group(1) + block + m.group(2), text)
    changed = new != text
    with open(path, "w") as f:
        f.write(new)
    return changed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default=None,
                    help="bench artifact or raw bench output JSON, measured "
                         "on the card (default: newest BENCH_r*.json with a "
                         "parse that names a card)")
    args = ap.parse_args(argv)
    parsed, src = load_bench(args.bench)
    root = repo_root()
    for path, make in (("README.md", readme_block),
                       ("PERF.md", arch_block)):
        full = os.path.join(root, path)
        changed = rewrite(full, make(parsed, src))
        print(f"{path}: {'updated' if changed else 'already current'} "
              f"(from {src})")


if __name__ == "__main__":
    main()
