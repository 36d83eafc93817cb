"""Tracker hyperparameter sweep harness.

Port of ``macaque_tpu/tools/sweep.py``. Replicates the reference's
multi-session BoTSORT grid sweep (notebooks/tracking_evaluation.ipynb
cells 1-4): for every (session, parameter combination) run the pipeline
into an isolated results root, validate the resulting kp3d against ground
truth (``check_performance`` — Hungarian centroid matching at 400 mm), and
append one row per run to ``sweep_log.csv``:

    session,match,prox,tlow,tbuf,fuse,results_root,tp,fn,fp,precision,recall

Per-root ``sweep_meta.json`` records the exact tracker parameters and a
timestamp; completed runs are skipped via the kp3d output + DONE flag
(same resumability protocol as the notebook).

The pipeline execution is injected (``run_fn``) so the harness drives
the real stage graph in production and synthetic stand-ins in tests.
``run_synthetic_sweep`` drives the port's steps 1-4, steps 2-4 on
``device`` in ``dtype``.
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from macaque_tpu_torch.tracking.botsort import TrackerParams


@dataclass(frozen=True)
class SweepPoint:
    """One grid point (the notebook's 5-tuple; cell 1)."""

    match_thresh: float = 0.80
    proximity_thresh: float = 0.50
    track_low_thresh: float = 0.10
    track_buffer: int = 72
    fuse_first_associate: bool = True

    def tag(self) -> str:
        """Folder tag (notebook cell 3 ``build_results_root``)."""
        t = (f"MT{self.match_thresh:.2f}_PR{self.proximity_thresh:.2f}"
             f"_TL{self.track_low_thresh:.2f}_TB{self.track_buffer}")
        return t + ("_FF" if self.fuse_first_associate else "")

    def tracker_params(self, base: Optional[TrackerParams] = None
                       ) -> TrackerParams:
        """Materialize full tracker params (fixed high/new thresholds as
        in the notebook: track_high 0.85, new_track 0.60)."""
        base = base or TrackerParams(track_high_thresh=0.85,
                                     new_track_thresh=0.60)
        return replace(
            base,
            match_thresh=self.match_thresh,
            proximity_thresh=self.proximity_thresh,
            track_low_thresh=self.track_low_thresh,
            track_buffer=self.track_buffer,
            fuse_score=self.fuse_first_associate,
        )


def sweep_grid(match=(0.65, 0.75, 0.85), prox=(0.3, 0.4, 0.5),
               tlow=(0.05, 0.15, 0.25), tbuf=(36, 72, 120),
               fuse=(False, True)) -> list[SweepPoint]:
    return [SweepPoint(*p) for p in
            itertools.product(match, prox, tlow, tbuf, fuse)]


CSV_HEADER = ("session,match,prox,tlow,tbuf,fuse,results_root,"
              "tp,fn,fp,precision,recall\n")

# the notebook's reduced grid (cell 1): the CLI's default
NOTEBOOK_GRID = [SweepPoint(m, p, t, b, f) for m, p, t, b, f in [
    (0.65, 0.30, 0.05, 36, False),
    (0.65, 0.30, 0.25, 120, False),
    (0.85, 0.50, 0.05, 36, True),
    (0.85, 0.50, 0.25, 120, True),
]]


def run_tracker_sweep(
    sessions: Sequence[str],
    grid: Sequence[SweepPoint],
    results_sweep_dir: str,
    run_fn: Callable[[str, SweepPoint, str], str],
    gt_centroids: dict,
    tp_threshold: float = 400.0,
    verbose: bool = True,
) -> str:
    """Run the grid; returns the sweep_log.csv path.

    run_fn(session, point, results_root) -> path of the produced
    kp3d.pickle (it should honor the tracker params via
    ``point.tracker_params()``).
    gt_centroids[session] -> (A, T, 3) ground-truth centroid array.
    """
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.tools.validation import (
        centroids_from_kp3d, check_performance,
    )

    os.makedirs(results_sweep_dir, exist_ok=True)
    log_csv = os.path.join(results_sweep_dir, "sweep_log.csv")
    if not os.path.exists(log_csv):
        with open(log_csv, "w") as f:
            f.write(CSV_HEADER)

    def log_row(session, p, root, metrics=""):
        line = (f"{session},{p.match_thresh},{p.proximity_thresh},"
                f"{p.track_low_thresh},{p.track_buffer},"
                f"{p.fuse_first_associate},{root}")
        if metrics:
            line += f",{metrics}"
        with open(log_csv, "a") as f:
            f.write(line + "\n")

    for session in sessions:
        for point in grid:
            root = os.path.join(results_sweep_dir, session, point.tag())
            os.makedirs(root, exist_ok=True)

            with open(os.path.join(root, "sweep_meta.json"), "w") as f:
                json.dump({
                    "session": session,
                    "params": {
                        "match_thresh": point.match_thresh,
                        "proximity_thresh": point.proximity_thresh,
                        "track_low_thresh": point.track_low_thresh,
                        "track_buffer": point.track_buffer,
                        "fuse_first_associate":
                            point.fuse_first_associate,
                        "track_high_thresh": 0.85,
                        "new_track_thresh": 0.60,
                    },
                    "timestamp": datetime.datetime.now().isoformat(),
                }, f, indent=2)

            done_flag = os.path.join(root, f"{session}_DONE.flag")
            if os.path.exists(done_flag):
                if verbose:
                    print(f"[skip] {session} {point.tag()}")
                log_row(session, point, root)
                continue

            if verbose:
                print(f"[sweep] {session} {point.tag()}")
            kp3d_path = run_fn(session, point, root)

            pred = centroids_from_kp3d(
                np.asarray(read_pickle(kp3d_path)["kp3d"]))
            r = check_performance(pred, np.asarray(gt_centroids[session]),
                                  tp_threshold)
            log_row(session, point, root,
                    metrics=f"{r.tp},{r.fn},{r.fp},"
                            f"{r.precision:.3f},{r.recall:.3f}")
            Path(done_flag).touch()
    return log_csv


def run_synthetic_sweep(
    results_sweep_dir: str,
    grid: Optional[Sequence[SweepPoint]] = None,
    n_frame: int = 96,
    n_cam: int = 4,
    verbose: bool = True,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> str:
    """Drive the REAL pipeline (steps 1-4, oracle perception) over the
    sweep grid on a synthetic recording — the CLI entry point of the
    harness. Each grid point re-runs step 1 with its tracker parameters;
    the session ground truth comes from the scene generator. Steps 2-4
    run on ``device`` (the card when None) in ``dtype``. The recording is
    written as FFV1 stores, as the JAX package writes it, where cv2 is
    installed, and as RGBA stores (the same frames, written and read
    without cv2) where it is not."""
    import dataclasses

    from macaque_tpu_torch.core.config import Step1Config, TrackerConfig
    from macaque_tpu_torch.core.device import resolve_device
    from macaque_tpu_torch.pipeline.step1 import run_step1
    from macaque_tpu_torch.pipeline.step2 import run_step2
    from macaque_tpu_torch.pipeline.step3 import run_step3
    from macaque_tpu_torch.pipeline.step4 import run_step4
    from macaque_tpu_torch.tools.synthetic import (
        SyntheticPerception, make_test_rig, project_scene, render_stores,
        simulate_scene,
    )
    from macaque_tpu_torch.tools.validation import centroids_from_kp3d

    device = resolve_device(device)
    if grid is None:
        grid = NOTEBOOK_GRID

    os.makedirs(results_sweep_dir, exist_ok=True)
    raw = os.path.join(results_sweep_dir, "videos")
    rig = make_test_rig(n_cam)
    kp3d_gt = simulate_scene(2, n_frame, seed=1)
    proj = project_scene(rig, kp3d_gt)
    if not os.path.exists(raw):
        try:
            import cv2  # noqa: F401
            fourcc = "FFV1"
        except ImportError:
            fourcc = "RGBA"
        render_stores(raw, "synth", rig, proj, fourcc=fourcc)

    def factory(cam_name):
        idx = rig.camera_ids.index(cam_name)
        return SyntheticPerception(idx, proj, noise=1.0, device=device)

    on = {"device": device, "dtype": dtype}

    def run_fn(session, point, root):
        tk = TrackerConfig(
            track_high_thresh=0.85,
            new_track_thresh=0.60,
            match_thresh=point.match_thresh,
            proximity_thresh=point.proximity_thresh,
            track_low_thresh=point.track_low_thresh,
            track_buffer=point.track_buffer,
        )
        cfg = dataclasses.replace(Step1Config(), tracker=tk)
        run_step1(session, root, raw, factory, cfg=cfg)
        rd = os.path.join(root, session)
        run_step2(rd, rig, **on)
        run_step3(rd, rig, **on)
        run_step4(rd, rig, **on)
        return os.path.join(rd, "kp3d.pickle")

    gt = {"synth": centroids_from_kp3d(kp3d_gt)}
    return run_tracker_sweep(["synth"], grid, results_sweep_dir, run_fn,
                             gt, verbose=verbose)


def rank_sweep(log_csv: str) -> list[dict]:
    """Aggregate sweep_log.csv over sessions and rank configurations by
    F1 (the notebook inspects the CSV by hand; this is the programmatic
    summary). Returns dicts sorted best-first."""
    import csv
    from collections import defaultdict

    by_cfg = defaultdict(lambda: {"tp": 0, "fn": 0, "fp": 0})
    with open(log_csv) as f:
        for row in csv.DictReader(f):
            if not row.get("tp"):
                continue  # skip-only rows carry no metrics
            key = (row["match"], row["prox"], row["tlow"], row["tbuf"],
                   row["fuse"])
            acc = by_cfg[key]
            acc["tp"] += int(row["tp"])
            acc["fn"] += int(row["fn"])
            acc["fp"] += int(row["fp"])

    out = []
    for key, acc in by_cfg.items():
        tp, fn, fp = acc["tp"], acc["fn"], acc["fp"]
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        out.append({
            "match": float(key[0]), "prox": float(key[1]),
            "tlow": float(key[2]), "tbuf": int(key[3]),
            "fuse": key[4] == "True",
            "tp": tp, "fn": fn, "fp": fp,
            "precision": prec, "recall": rec, "f1": f1,
        })
    return sorted(out, key=lambda d: -d["f1"])
