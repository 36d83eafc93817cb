"""The port's joint angles and 3D median filter
(``macaque_tpu_torch/tools/angles.py``) against the JAX package's on the
same numpy inputs, made from a seed: ``compute_angles`` over animals and
frames, ``get_angles`` with every spec kind (flex, axis, cross-axis and a
chain with a flipped joint), and ``filter_3d_medfilt`` with error gating,
NaN gaps and a mostly-NaN series, and the CLI's ``angles``. Both are
host numpy and scipy; each is held within 1e-12 of the JAX package's
(absolute, degrees or mm; measured 0: the same operations in the same
order)."""

import numpy as np
import pytest

from macaque_tpu.tools import angles as jang
from macaque_tpu_torch.core.config import MACAQUE_BODYPARTS
from macaque_tpu_torch.tools import angles as tang

TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _walk(F=60, seed=0, nan=0.05):
    """(F, 17, 3) joints of a walking animal, a ``nan`` share of them NaN
    (scipy's ``Rotation`` in a chain takes no NaN)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 150, (17, 3))
    centre = np.cumsum(rng.normal(0, 10, (F, 3)), axis=0)
    kp = centre[:, None] + base[None] + rng.normal(0, 15, (F, 17, 3))
    kp[rng.uniform(size=(F, 17)) < nan] = np.nan
    return kp


def test_bodyparts_and_default_angles_are_jaxs():
    assert list(tang.MACAQUE_BODYPARTS) == list(jang.MACAQUE_BODYPARTS)
    assert MACAQUE_BODYPARTS == list(jang.MACAQUE_BODYPARTS)
    assert tang.DEFAULT_ANGLES == jang.DEFAULT_ANGLES


def test_compute_angles_matches_jax():
    kp = np.stack([_walk(seed=s) for s in range(3)])     # (A, F, J, 3)
    got, want = tang.compute_angles(kp), jang.compute_angles(kp)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k])
    custom = {"neck": ("nose", "left_shoulder", "left_hip")}
    _close(tang.compute_angles(kp, custom)["neck"],
           jang.compute_angles(kp, custom)["neck"])


SPECS = {
    "flex": {"elbow": ["left_shoulder", "left_elbow", "left_wrist"],
             "knee": ["flex", "left_hip", "left_knee", "left_ankle"]},
    "axis": {"rot": ["axis", "left_shoulder", "left_elbow", "left_wrist"]},
    "cross-axis": {"cross": ["cross-axis", "left_hip", "left_knee",
                             "left_ankle"]},
    "chain": {"arm": ["chain", "left_shoulder", "left_elbow/",
                      "left_wrist", "nose"]},
}


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_get_angles_matches_jax(kind):
    kp = _walk(seed=4, nan=0.0 if kind == "chain" else 0.05)
    vecs = {bp: kp[:, j] for j, bp in enumerate(MACAQUE_BODYPARTS)}
    got = tang.get_angles(vecs, SPECS[kind])
    want = jang.get_angles(vecs, SPECS[kind])
    assert list(got) == list(want) and got
    for k in want:
        _close(got[k], want[k])
        assert np.isfinite(got[k]).mean() > 0.5


def test_filter_3d_medfilt_matches_jax():
    rng = np.random.default_rng(7)
    kp = np.stack([_walk(90, seed=s) for s in (1, 2)])     # (A, T, J, 3)
    errors = rng.gamma(2.0, 5.0, kp.shape[:-1])
    errors[rng.uniform(size=errors.shape) < 0.03] = np.nan
    kp[0, :, 3] = np.nan                                    # all-NaN series
    kp[1, :80, 4] = np.nan                                  # mostly NaN
    for kw in ({}, {"errors": errors}, {"errors": errors, "size": 7,
                                         "error_threshold": 8.0}):
        got = tang.filter_3d_medfilt(kp, **kw)
        want = jang.filter_3d_medfilt(kp, **kw)
        _close(got, want)
    assert np.isfinite(got).mean() > 0.5


def test_cli_angles_writes_the_jax_npz(tmp_path, capsys):
    """``python -m macaque_tpu_torch angles`` against the JAX CLI on one
    ``kp3d.pickle``: the same keys and angles within 1e-12 [0]."""
    import pickle

    from macaque_tpu.__main__ import main as jmain
    from macaque_tpu_torch.__main__ import main

    path = tmp_path / "kp3d.pickle"
    with open(path, "wb") as f:
        pickle.dump({"kp3d": np.stack([_walk(seed=s) for s in range(2)])}, f)
    jmain(["angles", str(path), "--out", str(tmp_path / "jax.npz")])
    main(["angles", str(path), "--out", str(tmp_path / "port.npz")])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote {tmp_path / 'jax.npz'}",
                   f"wrote {tmp_path / 'port.npz'}"]
    with np.load(tmp_path / "port.npz") as g, \
            np.load(tmp_path / "jax.npz") as w:
        assert sorted(g.files) == sorted(w.files) == sorted(jang.DEFAULT_ANGLES)
        for k in w.files:
            _close(g[k], w[k])
