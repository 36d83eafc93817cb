"""The port's tracker sweep harness (``macaque_tpu_torch/tools/sweep.py``)
against the JAX package's: tests/test_sweep.py's four fast tests on the
port (a synthetic ``run_fn`` whose kp3d quality depends on the tracker
parameters, so the harness must rank the good configuration first; the
DONE-flag resumability; the CSV schema; the grid), ``SweepPoint``'s
tracker parameters equal field by field to the JAX package's, and
``run_synthetic_sweep`` on both packages (two grid points, 48 frames, 4
cameras; JAX under x64, the port in float64 on the CPU) with equal
``sweep_log.csv`` metric columns, the same ``sweep_meta.json`` keys and
parameters, and each point's step-1 rows equal: track ids, boxes and
collar IDs exactly, the oracle's keypoints within 1e-9 px (each package
projects the scene with its own ``project_scene``, which part by rounding:
6e-11 px seen)."""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from macaque_tpu.tools import sweep as jsweep
from macaque_tpu_torch.pipeline.artifacts import read_alldata, write_pickle
from macaque_tpu_torch.tools import sweep as tsweep
from macaque_tpu_torch.tools.sweep import (
    SweepPoint, rank_sweep, run_tracker_sweep, sweep_grid,
)

GOOD = SweepPoint(0.85, 0.50, 0.05, 72, True)
BAD1 = SweepPoint(0.65, 0.30, 0.25, 36, False)
BAD2 = SweepPoint(0.65, 0.50, 0.05, 120, False)

A, T, J = 2, 40, 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gt(session_seed):
    rng = np.random.default_rng(session_seed)
    base = np.cumsum(rng.normal(0, 12, (A, T, 3)), axis=1)
    return base + np.array([0.0, 0.0, 500.0])


def _fake_run(gts):
    def run_fn(session, point, root):
        gt = gts[session]
        kp3d = np.tile(gt[:, :, None, :], (1, 1, J, 1))
        rng = np.random.default_rng(hash((session, point.tag())) % 2**31)
        if point != GOOD:
            # degraded tracking: lose half the frames of animal 1 and
            # displace animal 0 beyond the TP threshold in some frames
            kp3d[1, ::2] = np.nan
            miss = rng.uniform(size=T) < 0.4
            kp3d[0, miss] += 2000.0
        path = os.path.join(root, "kp3d.pickle")
        write_pickle(path, {"kp3d": kp3d})
        return path

    return run_fn


# ------------------------------------------ tests/test_sweep.py, on the port

def test_sweep_ranks_good_config_first(tmp_path):
    sessions = ["sessA", "sessB"]
    gts = {s: _gt(i) for i, s in enumerate(sessions)}
    grid = [BAD1, GOOD, BAD2]

    log = run_tracker_sweep(sessions, grid, str(tmp_path / "sweep"),
                            _fake_run(gts), gts, verbose=False)
    assert os.path.basename(log) == "sweep_log.csv"

    with open(log) as f:
        header = f.readline().strip()
    assert header == ("session,match,prox,tlow,tbuf,fuse,results_root,"
                      "tp,fn,fp,precision,recall")

    ranking = rank_sweep(log)
    assert len(ranking) == 3
    best = ranking[0]
    assert (best["match"], best["prox"], best["tlow"], best["tbuf"],
            best["fuse"]) == (0.85, 0.50, 0.05, 72, True)
    assert best["recall"] > 0.99 and best["precision"] > 0.99
    assert ranking[1]["f1"] < best["f1"]

    # per-root artifacts: meta + DONE flag
    root = os.path.join(str(tmp_path / "sweep"), "sessA", GOOD.tag())
    assert os.path.exists(os.path.join(root, "sweep_meta.json"))
    assert os.path.exists(os.path.join(root, "sessA_DONE.flag"))


def test_sweep_resumes_with_skip(tmp_path):
    sessions = ["sessA"]
    gts = {s: _gt(0) for s in sessions}
    calls = []

    def run_fn(session, point, root):
        calls.append((session, point.tag()))
        return _fake_run(gts)(session, point, root)

    d = str(tmp_path / "sweep")
    run_tracker_sweep(sessions, [GOOD], d, run_fn, gts, verbose=False)
    run_tracker_sweep(sessions, [GOOD], d, run_fn, gts, verbose=False)
    assert len(calls) == 1  # second pass skipped via DONE flag

    # skip rows are appended without metrics and ignored by rank_sweep
    ranking = rank_sweep(os.path.join(d, "sweep_log.csv"))
    assert len(ranking) == 1


def test_sweep_point_to_tracker_params():
    tp = GOOD.tracker_params()
    assert tp.match_thresh == 0.85
    assert tp.proximity_thresh == 0.50
    assert tp.track_low_thresh == 0.05
    assert tp.track_buffer == 72
    assert tp.fuse_score is True
    assert tp.track_high_thresh == 0.85
    assert tp.new_track_thresh == 0.60


def test_sweep_grid_size():
    g = sweep_grid()
    assert len(g) == 3 * 3 * 3 * 3 * 2
    assert len({p.tag() for p in g}) == len(g)


# ------------------------------------------- against the JAX package

def test_grid_and_tracker_params_equal_the_jax_packages():
    from macaque_tpu.tracking.botsort import TrackerParams as JParams

    got, want = sweep_grid(), jsweep.sweep_grid()
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]
    assert tsweep.CSV_HEADER == jsweep.CSV_HEADER
    base = JParams(track_high_thresh=0.7, track_buffer=10)
    for p, q in zip(got, want):
        assert p.tag() == q.tag()
        for tp, jp in ((p.tracker_params(), q.tracker_params()),
                       (p.tracker_params(dataclasses.replace(
                           tsweep.TrackerParams(), track_high_thresh=0.7,
                           track_buffer=10)), q.tracker_params(base))):
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def _metrics(log):
    with open(log) as f:
        return [{k: row[k] for k in ("session", "match", "prox", "tlow",
                                      "tbuf", "fuse", "tp", "fn", "fp",
                                      "precision", "recall")}
                for row in csv.DictReader(f)]


def test_run_synthetic_sweep_equals_the_jax_packages(tmp_path):
    """Both packages' steps 1-4 over two grid points (~50 s here)."""
    grid = [SweepPoint(0.85, 0.50, 0.05, 72, True),
            SweepPoint(0.65, 0.30, 0.25, 36, False)]
    kw = dict(grid=grid, n_frame=48, n_cam=4, verbose=False)
    want = jsweep.run_synthetic_sweep(str(tmp_path / "jax"), **kw)
    got = tsweep.run_synthetic_sweep(str(tmp_path / "port"), **kw,
                                     device="cpu", dtype=torch.float64)
    rows = _metrics(got)
    assert rows == _metrics(want) and len(rows) == 2
    for row in rank_sweep(got):
        assert row["recall"] > 0.8 and row["precision"] > 0.8, row
    for p in grid:
        roots = [str(tmp_path / n / "synth" / p.tag()) for n in ("port", "jax")]
        metas = []
        for r in roots:
            with open(os.path.join(r, "sweep_meta.json")) as f:
                metas.append(json.load(f))
            assert os.path.exists(os.path.join(r, "synth_DONE.flag"))
        assert list(metas[0]) == list(metas[1])
        assert metas[0]["params"] == metas[1]["params"]
        for cam in sorted(os.listdir(os.path.join(roots[1], "synth"))):
            if not os.path.isdir(os.path.join(roots[1], "synth", cam)):
                continue
            g, fg = read_alldata(os.path.join(roots[0], "synth", cam))
            w, fw = read_alldata(os.path.join(roots[1], "synth", cam))
            np.testing.assert_array_equal(fg, fw)
            assert [len(r) for r in g] == [len(r) for r in w] and any(g)
            for eg, ew in zip(sum(g, []), sum(w, [])):
                assert eg[:5] + eg[6:] == ew[:5] + ew[6:]
                np.testing.assert_allclose(eg[5], ew[5], rtol=0, atol=1e-9)
    # a second call skips every point: rows without metrics
    tsweep.run_synthetic_sweep(str(tmp_path / "port"), **kw, device="cpu",
                               dtype=torch.float64)
    assert len(rank_sweep(got)) == 2 and len(_metrics(got)) == 4
