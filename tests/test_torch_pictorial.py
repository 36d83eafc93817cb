"""The port's pictorial-structure inference and transitive closure
(``macaque_tpu_torch/association/pictorial.py``) against the JAX package's
(``macaque_tpu/association/pictorial.py``, under x64), float64 on the CPU:
the picks of ``infer_pictorial_3d`` equal on 20 seeded problems and on
constructed ties (both take the first maximum), ``transitive_closure`` and
``closure_to_clusters`` equal, ``macaque_skeleton_tree`` and the tables
equal; tests/test_association.py's pictorial tests on the port; and the
port's own native oracle (``macaque_tpu_torch/native``, a copy of the JAX
package's C++) equal to the port's tensors, as tests/test_native.py holds
the JAX package's, without building or loading ``macaque_tpu.native``:
the port's build leaves that directory's files as they were."""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macaque_tpu.association import pictorial as jpic
from macaque_tpu_torch.association import pictorial as tpic
from macaque_tpu_torch.association import (
    infer_pictorial_3d, macaque_skeleton_tree, transitive_closure)
from macaque_tpu_torch.association.pictorial import (
    PICTORIAL_PARENT, closure_to_clusters)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "macaque_tpu", "native")


def _problem(rng, C):
    return (rng.uniform(0, 1, (13, C)), rng.uniform(-500, 500, (13, C, 3)),
            rng.uniform(80, 150, 13), rng.uniform(5, 30, 13))


def _picks_port(*args):
    out = infer_pictorial_3d(*(torch.as_tensor(a) for a in args))
    assert out.dtype == torch.int32 and out.shape == (13,)
    return out.numpy()


def _picks_jax(*args):
    return np.asarray(jpic.infer_pictorial_3d(*(jnp.asarray(a) for a in args)))


def _relation(rng, N, p):
    X = (rng.uniform(size=(N, N)) < p).astype(np.uint8)
    X = ((X + X.T) > 0).astype(np.uint8)
    np.fill_diagonal(X, 0)
    return X


def test_tables_and_tree_equal_the_jax_packages():
    assert macaque_skeleton_tree() == jpic.macaque_skeleton_tree()
    for name in ("PICTORIAL_PARENT", "COCO17_TO_PICTORIAL"):
        np.testing.assert_array_equal(getattr(tpic, name), getattr(jpic, name))
    assert tpic.PICTORIAL_NAMES == jpic.PICTORIAL_NAMES


@pytest.mark.parametrize("seed", range(20))
def test_picks_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    args = _problem(rng, int(rng.integers(2, 17)))
    np.testing.assert_array_equal(_picks_port(*args), _picks_jax(*args))


def test_ties_take_the_first_maximum():
    """Duplicated candidates make every score a tie between two columns;
    both packages pick the lower index at the root and in the backtrack.
    A uniform unary over candidates all at one point ties all C."""
    rng = np.random.default_rng(5)
    unary, cands, mean, std = _problem(rng, 3)
    unary = np.concatenate([unary, unary], 1)           # candidate c == c + 3
    cands = np.concatenate([cands, cands], 1)
    got, want = _picks_port(unary, cands, mean, std), _picks_jax(
        unary, cands, mean, std)
    np.testing.assert_array_equal(got, want)
    assert (got < 3).all()
    flat = (np.zeros((13, 4)), np.zeros((13, 4, 3)), np.full(13, 100.0),
            np.full(13, 10.0))
    np.testing.assert_array_equal(_picks_port(*flat), 0)
    np.testing.assert_array_equal(_picks_jax(*flat), 0)


def test_pictorial_picks_consistent_skeleton():
    """tests/test_association.py's test, on the port."""
    rng = np.random.default_rng(6)
    C = 4
    bone = np.full(13, 100.0)
    std = np.full(13, 10.0)
    pos = np.zeros((13, 3))
    for j in range(1, 13):
        p = PICTORIAL_PARENT[j]
        d = rng.normal(size=3)
        pos[j] = pos[p] + 100.0 * d / np.linalg.norm(d)
    cands = np.zeros((13, C, 3))
    cands[:, 0] = pos
    cands[:, 1:] = rng.uniform(-2000, 2000, (13, C - 1, 3))
    unary = np.full((13, C), 0.5)
    np.testing.assert_array_equal(_picks_port(unary, cands, bone, std), 0)


def test_transitive_closure_and_clusters():
    """tests/test_association.py's test, on the port."""
    X = np.zeros((5, 5), np.uint8)
    X[0, 1] = X[1, 0] = 1
    X[1, 2] = X[2, 1] = 1
    X[3, 4] = X[4, 3] = 1
    R = transitive_closure(torch.as_tensor(X)).numpy()
    assert R[0, 2] and R[2, 0]
    assert not R[0, 3]
    clusters = closure_to_clusters(X, device="cpu")
    assert clusters[:3, 0].all()
    assert clusters[3:, 3].all()
    assert clusters.sum() == 5


@pytest.mark.parametrize("N,p", [(1, 0.5), (2, 0.5), (5, 0.3), (12, 0.15),
                                 (48, 0.03), (65, 0.02)])
def test_closure_equals_the_jax_packages(N, p):
    """Symmetric relations, a directed one (the closure keeps JAX's
    ``R & ~eye | X``: a self-loop of X survives), and a batch."""
    rng = np.random.default_rng(N)
    X = _relation(rng, N, p)
    D = (rng.uniform(size=(N, N)) < p).astype(np.uint8)
    for rel in (X, D):
        got = transitive_closure(torch.as_tensor(rel)).numpy()
        want = np.asarray(jpic.transitive_closure(jnp.asarray(rel)))
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)
    batch = np.stack([X, D])
    np.testing.assert_array_equal(
        transitive_closure(torch.as_tensor(batch)).numpy(),
        np.asarray(jpic.transitive_closure(jnp.asarray(batch))))
    got = closure_to_clusters(X, device="cpu")
    assert got.dtype == X.dtype
    np.testing.assert_array_equal(got, jpic.closure_to_clusters(X))


def _tree_state(d):
    return {f: (os.stat(os.path.join(d, f)).st_mtime_ns,
                hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest())
            for f in sorted(os.listdir(d)) if os.path.isfile(os.path.join(d, f))}


def test_native_oracle_equals_the_port(tmp_path):
    """A fresh build of the port's oracle (into a temporary directory),
    held against the port's tensors on tests/test_native.py's problems and
    more; ``macaque_tpu/native`` keeps every file's bytes and mtime."""
    from macaque_tpu_torch.native import library_path, load_native

    before = _tree_state(JAX_NATIVE)
    nat = load_native(str(tmp_path))
    assert nat.library == library_path(str(tmp_path))
    assert os.path.dirname(nat.library) == str(tmp_path)
    rng = np.random.default_rng(0)
    for C in (5, 5, 5, 5, 5, 1, 2, 16, 16, 33):
        args = _problem(rng, C)
        np.testing.assert_array_equal(_picks_port(*args),
                                      nat.pictorial_infer(*args))
    for N in (12, 12, 12, 12, 12, 1, 48, 48, 70):
        X = _relation(rng, N, 1.8 / N)
        np.testing.assert_array_equal(closure_to_clusters(X, device="cpu"),
                                      nat.transform_closure(X))
    assert _tree_state(JAX_NATIVE) == before
    with pytest.raises(ValueError):
        nat.pictorial_infer(np.zeros((12, 4)), np.zeros((12, 4, 3)),
                            np.ones(12), np.ones(12))
    with pytest.raises(ValueError):
        nat.transform_closure(np.zeros((3, 4), np.uint8))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fall back: a compiler that fails makes the loader raise."""
    from macaque_tpu_torch.native import build

    monkeypatch.setenv("PATH", str(tmp_path))          # a g++ that fails
    (tmp_path / "g++").write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
    (tmp_path / "g++").chmod(0o755)
    with pytest.raises(RuntimeError, match="broken"):
        build.load_native(str(tmp_path / "lib"))
    assert not os.listdir(tmp_path / "lib")
