"""Step 3 of the port against the JAX package's: the tracklet helpers on
tests/test_step3_units.py's cases and on tracklets cut from a synthetic
scene, ``TraceCalculator`` within 1e-9 mm, ``solve_flow`` (the port's own
min-cost flow) against networkx's, and ``run_step3`` after both packages'
``run_step2`` on tests/test_torch_step2.py's three scenes and a scene
with broken tracks, writing equal ``keyframe_connection.pickle``,
``track.pickle``, ``collar_id.pickle`` and ``kp2d.pickle``. JAX runs
under x64 (tests/conftest.py), the port in float64 on the CPU."""

import copy
import itertools

import numpy as np
import pytest
import torch

from macaque_tpu.pipeline import step2 as js2
from macaque_tpu.pipeline import step3 as js3
from macaque_tpu.pipeline.artifacts import read_pickle, write_alldata
from macaque_tpu_torch.pipeline import step2 as ts2
from macaque_tpu_torch.pipeline import step3 as ts3
from macaque_tpu_torch.tools import synthetic as tsyn
from tests.test_step3_units import _mk_trk
from tests.test_torch_step2 import SCENES, _port_rig, _synthetic


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are many small tensor operations, faster
    on one thread than on all of them, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Equal dicts of arrays (keys in order), lists or arrays."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------- test_step3_units.py's cases

def _cid_cases():
    n = 400
    a = np.zeros((n, 4), int)
    a[100:300, 2] = 1
    b = np.zeros((600, 4), int)
    b[:200, 0] = 1
    b[400:, 3] = 1
    c = np.zeros((300, 4), int)
    c[10:15, 1] = 1
    return [({0: _mk_trk(400, 50, 350)}, {0: a}, 400),
            ({0: _mk_trk(600, 0, 599)}, {0: b}, 600),
            ({0: _mk_trk(300, 0, 299)}, {0: c}, 300)]


@pytest.mark.parametrize("case", range(3))
def test_set_tracklet_ids_matches_jax(case):
    Trk, cid, n = _cid_cases()[case]
    _same(ts3.set_tracklet_ids(Trk, cid, n, wsize=120),
          js3.set_tracklet_ids(Trk, cid, n, wsize=120))


@pytest.mark.parametrize("with_info", [False, True])
def test_split_and_breakdown_match_jax(with_info):
    n = 400
    cid = -np.ones(n, int)
    cid[0:150] = 1
    cid[250:400] = 2
    info = {0: [[0, 120], [140, 399]]} if with_info else None
    outs = []
    for mod in (ts3, js3):
        Trk, Cid = {0: _mk_trk(n, 0, 399), 5: _mk_trk(n, 10, 60)}, \
            {0: cid.copy(), 5: np.full(n, 3)}
        out = mod.split_multi_id_tracklets(Trk, Cid, copy.deepcopy(info),
                                           n_cam=4)
        if with_info:
            Trk, Cid, si = out
            si = {k: v for k, v in si.items() if v}
            out = out + mod.breakdown_stitched_tracklets(
                copy.deepcopy(Trk), copy.deepcopy(Cid), si, 4)
        outs.append(out)
    _same(outs[0], outs[1])


def test_helpers_match_jax():
    m = np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1])
    _same(ts3._to_intervals(m), js3._to_intervals(m))
    _same(ts3._to_intervals(np.zeros(4)), js3._to_intervals(np.zeros(4)))
    single = -np.ones((50, 4), int)
    single[5:40, 0] = 7
    for fn in ("remove_single_cam_tracklets",):
        _same(getattr(ts3, fn)({0: _mk_trk(50, 5, 40), 1: single.copy()}),
              getattr(js3, fn)({0: _mk_trk(50, 5, 40), 1: single.copy()}))
    cid = {0: -np.ones(50, int), 1: np.full(50, 2), 2: -np.ones(50, int)}
    trk = {0: _mk_trk(50, 5, 5), 1: _mk_trk(50, 5, 40),
           2: _mk_trk(50, 3, 30)}
    _same(ts3.remove_short_tracklets(copy.deepcopy(trk), cid, 0),
          js3.remove_short_tracklets(copy.deepcopy(trk), cid, 0))
    alldata = [[[] for _ in range(30)] for _ in range(4)]
    for f in range(30):
        alldata[0][f].append([1, 0, 0, 10, 10, [[0, 0, 0.9]] * 17, 2, 0.95])
        alldata[1][f].append([2, 0, 0, 10, 10, [[0, 0, 0.9]] * 17, 5,
                              0.5 + f / 60])
    trk = {0: _mk_trk(30, 0, 29)}
    _same(ts3.count_id_detections(alldata, trk, 30, 4),
          js3.count_id_detections(alldata, trk, 30, 4))
    _same(ts3.create_kp2d(alldata, trk, {0: np.full(30, 1)}, 30, 4),
          js3.create_kp2d(alldata, trk, {0: np.full(30, 1)}, 30, 4))


# ---------------------------------------------- traces on a real scene

@pytest.fixture(scope="module")
def scene8():
    rig, rows = _synthetic(8, 4, 60)
    return rig, rows


def _trace_calcs(rig):
    return (ts3.TraceCalculator(_port_rig(rig), device="cpu",
                                dtype=torch.float64),
            js3.TraceCalculator(rig))


def _animal_trk(n_frame, n_cam, a, lo, hi):
    trk = -np.ones((n_frame, n_cam), int)
    trk[lo:hi + 1] = a + 1
    return trk


def test_trace_calculator_matches_jax(scene8):
    rig, rows = scene8
    tc, jc = _trace_calcs(rig)
    trk = _animal_trk(60, 8, 2, 0, 59)
    trk[10:20, 1:] = -1            # frames with one camera: NaN centres
    frames = np.arange(0, 60, 3)
    kp = tc.gather_kp2d(rows, trk, frames)
    _same(kp, jc.gather_kp2d(rows, trk, frames))
    got, want = tc.triangulate(kp), jc.triangulate(kp)
    assert np.isfinite(got).mean() > 0.8
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    for red in ("median", "mean"):
        np.testing.assert_allclose(tc.trace(rows, trk, frames, red),
                                   jc.trace(rows, trk, frames, red),
                                   rtol=0, atol=1e-9)
    assert tc.calls == 3 and tc.seconds > 0
    assert tc.triangulate(kp[:0]).shape == (0, 17, 3)


def test_trim_stitch_graph_and_last_one_match_jax(scene8):
    """Overlapping pieces of one animal (trimmed), a continuation across a
    gap (a stitch edge with the ID bonus), and an unassigned tracklet
    beside three assigned ones (assign_lastone), each package with its own
    trace calculator."""
    rig, rows = scene8
    tc, jc = _trace_calcs(rig)
    base = {0: _animal_trk(60, 8, 0, 0, 35), 1: _animal_trk(60, 8, 0, 30, 59),
            2: _animal_trk(60, 8, 1, 0, 59), 3: _animal_trk(60, 8, 2, 0, 25),
            4: _animal_trk(60, 8, 2, 27, 59), 5: _animal_trk(60, 8, 3, 0, 59)}
    got = ts3.trim_tracklets(copy.deepcopy(base), rows, 60, tc)
    want = js3.trim_tracklets(copy.deepcopy(base), rows, 60, jc)
    _same(got, want)
    assert not np.array_equal(got[1], base[1])        # the trim happened
    cid = {k: np.full(60, a) for k, a in zip(base, [0, 0, 1, 2, 2, -1])}
    cid[3][:] = -1
    edges = ts3.build_stitch_graph(got, cid, rows, 60, tc)
    np.testing.assert_allclose(
        edges, js3.build_stitch_graph(want, cid, rows, 60, jc), atol=1e-9)
    assert edges.shape[0] > 0
    _same(ts3.stitch_tracklets(copy.deepcopy(got), cid, rows, 60, tc),
          js3.stitch_tracklets(copy.deepcopy(want), cid, rows, 60, jc))
    cid2 = {0: np.full(60, 0), 2: np.full(60, 1), 4: np.full(60, 2),
            5: -np.ones(60, int)}
    trk2 = {k: got[k] for k in cid2}
    trk2[5] = base[5]
    _same(ts3.assign_lastone(copy.deepcopy(trk2), copy.deepcopy(cid2), rows,
                             tc, 4, min_duration=12),
          js3.assign_lastone(copy.deepcopy(trk2), copy.deepcopy(cid2), rows,
                             jc, 4, min_duration=12))


def test_connect_build_dedup_match_jax(scene8):
    """connect_keyframes, build_tracklets and clean_id_duplication on a
    hand-made keyframe list with an identity swap in camera 3."""
    rig, rows = scene8
    kfs = []
    for f in range(1, 60, 12):
        bcomb = [np.arange(8) * 0 + a + 1 for a in range(4)]
        if f > 30:
            bcomb[0][3], bcomb[1][3] = 2, 1
        kfs.append({"frame": f, "bcomb": [b.copy() for b in bcomb],
                    "pose3d": [np.zeros((17, 3))] * 4})
    got = ts3.connect_keyframes(rows, copy.deepcopy(kfs), 8)
    want = js3.connect_keyframes(rows, copy.deepcopy(kfs), 8)
    _same(got, want)
    tt = ts3.build_tracklets(got[0], got[1], got[2], 8)
    _same(tt, js3.build_tracklets(want[0], want[1], want[2], 8))
    Trk, n = tt
    Trk_cid = ts3.count_id_detections(got[0], Trk, n, 8)
    Cid = ts3.set_tracklet_ids(Trk, Trk_cid, n, 120)
    Cid = {k: np.where(np.arange(n) < 40, 0, -1) if i < 2 else v
           for i, (k, v) in enumerate(Cid.items())}
    _same(ts3.clean_id_duplication(copy.deepcopy(Trk), copy.deepcopy(Cid),
                                   copy.deepcopy(Trk_cid), n, 120, 24),
          js3.clean_id_duplication(copy.deepcopy(Trk), copy.deepcopy(Cid),
                                   copy.deepcopy(Trk_cid), n, 120, 24))


# ------------------------------------------------------------- min-cost flow

def _chain_cost(chains, edges):
    w = {(int(a), int(b)): int(c * 100) for a, b, c in edges}
    return sum(2 * 100000 + sum(w[(c[i], c[i + 1])] for i in range(len(c) - 1))
               for c in chains)


def _brute_force(edges):
    """Every one-in/one-out choice of edges on the DAG with n_track in
    1..N-1 (what solve_flow keeps): (min cost, number of minimizers)."""
    nodes = [int(v) for v in np.unique(edges[:, :2])]
    succ = {v: [] for v in nodes}
    for a, b, w in edges:
        succ[int(a)].append((int(b), int(w * 100)))
    costs = []

    def rec(i, used, m, c):
        if i == len(nodes):
            if m >= 1:
                costs.append(2 * (len(nodes) - m) * 100000 + c)
            return
        rec(i + 1, used, m, c)
        for b, w in succ[nodes[i]]:
            if b not in used:
                rec(i + 1, used | {b}, m + 1, c + w)

    rec(0, frozenset(), 0, 0)
    best = min(costs)
    return best, costs.count(best)


def test_solve_flow_unit_cases_match_networkx():
    edges = np.array([[0, 1, 10.0], [0, 2, 900.0]])
    assert ts3.solve_flow(edges) == js3.solve_flow(edges) == [[0, 1], [2]]
    assert ts3.solve_flow(np.zeros((0, 3))) == [] == js3.solve_flow(
        np.zeros((0, 3)))


def test_solve_flow_matches_networkx_on_random_dags():
    """60 seeded random tracklet DAGs (2-8 nodes, some near-zero and some
    equal weights): the cost of the kept flow equals networkx's always;
    where the optimum is unique (enumerated), the chains are equal."""
    rng = np.random.default_rng(0)
    n_graphs = n_unique = 0
    while n_graphs < 60:
        N = int(rng.integers(2, 9))
        ids = np.sort(rng.choice(200, N, replace=False))
        E = [[ids[i], ids[j], rng.choice([rng.uniform(0, 800),
                                         rng.uniform(0, 0.05), 5.0])]
             for i, j in itertools.combinations(range(N), 2)
             if rng.random() < 0.4]
        if not E:
            continue
        E = np.array(E, float)
        got, want = ts3.solve_flow(E), js3.solve_flow(E)
        assert _chain_cost(got, E) == _chain_cost(want, E)
        assert sorted(sum(got, [])) == sorted(set(sum(got, [])))
        best, count = _brute_force(E)
        if count == 1 and best == _chain_cost(want, E):
            assert got == want
            n_unique += 1
        n_graphs += 1
    assert n_unique >= 30


def test_min_cost_flow_reports_infeasible_demands():
    assert ts3.min_cost_flow(2, [(0, 1, 1, 5)], [-2, 2]) is None
    assert ts3.min_cost_flow(2, [(0, 1, 2, 5)], [-2, 2]) == (10, [2])


# -------------------------------------------------------------- end to end

def _broken_tracks_scene():
    """4 cameras, 2 animals, 200 frames; animal 1 seen by camera 0 alone
    for frames 50-74 (its keyframe links break, a stitch edge bridges
    them) and camera 2's 2D track ids switch once per animal."""
    rig, rows = _synthetic(4, 2, 200)
    rows = copy.deepcopy(rows)
    rng = np.random.default_rng(7)
    for a in range(2):
        cut = int(rng.integers(20, 180))
        for f in range(cut, 200):
            for d in rows[2][f]:
                if d[0] == a + 1:
                    d[0] = 100 + 10 * a + 2
    for f in range(50, 75):
        for c in range(1, 4):
            rows[c][f] = [d for d in rows[c][f] if d[0] not in (2, 110 + c)]
    return rig, rows


STEP3_SCENES = {**SCENES, "4cam-2animal-200frame-broken": _broken_tracks_scene}


def run_both(tmp_path, name, dtype=torch.float64):
    """Both packages' run_step2 then run_step3 on one scene; returns the
    two result directories and the port's step-3 times."""
    rig, rows = STEP3_SCENES[name]()
    for pkg in ("jax", "port"):
        for c, cam_id in enumerate(rig.camera_ids):
            write_alldata(str(tmp_path / pkg / cam_id), rows[c],
                          np.arange(len(rows[c]), dtype=np.int32))
    js2.run_step2(str(tmp_path / "jax"), rig)
    js3.run_step3(str(tmp_path / "jax"), rig)
    trig = _port_rig(rig)
    ts2.run_step2(str(tmp_path / "port"), trig, device="cpu", dtype=dtype)
    times = {}
    ts3.run_step3(str(tmp_path / "port"), trig, device="cpu", dtype=dtype,
                  times=times)
    return rig, str(tmp_path / "jax"), str(tmp_path / "port"), times


@pytest.mark.parametrize("name", list(STEP3_SCENES))
def test_run_step3_writes_the_jax_packages_pickles(tmp_path, name):
    rig, jdir, pdir, times = run_both(tmp_path, name)
    for f in ("keyframe_connection.pickle", "track.pickle",
              "collar_id.pickle", "kp2d.pickle"):
        _same(read_pickle(f"{pdir}/{f}"), read_pickle(f"{jdir}/{f}"))
    trk = read_pickle(f"{pdir}/track.pickle")
    assert trk and np.asarray(read_pickle(f"{pdir}/kp2d.pickle")).any()
    assert set(times) == {"read", "connect", "build", "trim", "ids",
                          "stitch", "dedup", "last_one", "write", "flow",
                          "flow_solves", "trace_calls", "trace"}
    if name.endswith("broken"):
        assert times["flow_solves"] > 0 and times["trace_calls"] > 0
    # a second call finds the pickles and skips
    ts3.run_step3(pdir, _port_rig(rig), device="cpu")


def test_run_step3_refuses_a_mesh_and_needs_a_device(tmp_path):
    rig = tsyn.make_test_rig(4)
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        ts3.run_step3(str(tmp_path), rig, mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts3.run_step3(str(tmp_path), rig)
