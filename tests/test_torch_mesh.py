"""The port's device mesh (``macaque_tpu_torch/core/mesh.py``) against the
JAX package's ``core/mesh.py`` on its eight virtual CPU devices
(tests/conftest.py), with meshes of repeated CPU entries on the port's
side: the grid rule, the specs, padding, splitting and gathering; the SVT
stepping its shards in lockstep; the perception sharded over eight
entries; and every kernel launch made under its input's device."""

import ast
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding

from macaque_tpu.core import mesh as jmesh
from macaque_tpu_torch import kernels
from macaque_tpu_torch.core import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam_sizes(n):
    return [None] + [c for c in range(1, n + 1) if n % c == 0]


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_grid_follows_jax(n):
    assert len(jax.devices()) >= 8
    for cam in _cam_sizes(n):
        want = jmesh.make_mesh(n, cam_axis_size=cam)
        got = tmesh.make_mesh(n, cam_axis_size=cam, devices=CPU8)
        assert got.devices.shape == want.devices.shape, (n, cam)
        assert got.shape == dict(want.shape), (n, cam)
        assert got.axis_names == want.axis_names
        assert got.size == want.size
        assert got.distinct() == [torch.device("cpu")]


def test_make_mesh_one_and_the_exports():
    want = jmesh.make_mesh(1)
    got = tmesh.make_mesh(1, devices=["cpu"])
    assert got.devices.shape == want.devices.shape == (1, 1)
    assert got.shape == dict(want.shape) == {"cam": 1, "frame": 1}
    from macaque_tpu_torch import core

    assert (core.make_mesh, core.shard_over, core.replicate) == (
        tmesh.make_mesh, tmesh.shard_over, tmesh.replicate)


def test_make_mesh_needs_a_card_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        tmesh.home_device(jmesh.make_mesh(1))


@pytest.mark.parametrize("shape,axis,m", [
    ((13, 3), 0, 8), ((5, 7, 2), 1, 4), ((6,), 0, 3), ((2, 3, 9), 2, 8),
    ((0, 4), 0, 8)])
def test_pad_to_multiple_equals_jax(shape, axis, m):
    x = np.random.default_rng(sum(shape)).normal(size=shape)
    got, n = tmesh.pad_to_multiple(x, m, axis)
    want, n_j = jmesh.pad_to_multiple(x, m, axis)
    assert n == n_j == shape[axis]
    np.testing.assert_array_equal(got, want)


def test_put_batch_sharded_passes_through_without_a_mesh():
    x = np.arange(12.0).reshape(4, 3)
    got, n = tmesh.put_batch_sharded(x, None, axis=1)
    assert got is x and n == 3
    assert tmesh.put_replicated(x, None) is x


def test_stage_mesh_is_one_entry_without_a_mesh():
    """A stage given no mesh runs its one path on a mesh of one entry, its
    home device; given a mesh, it runs on that mesh at ``device`` or the
    mesh's first entry."""
    mesh, home = tmesh.stage_mesh(None, "cpu")
    assert home == torch.device("cpu") and mesh.device_list == [home]
    assert mesh.shape == {"cam": 1, "frame": 1}
    x = np.arange(12.0).reshape(4, 3)
    shards, n = tmesh.put_batch_sharded(x, mesh, axis=1)
    assert n == 3 and len(shards) == 1
    np.testing.assert_array_equal(tmesh.gather_shards(tmesh.map_shards(
        lambda a: 2 * a, mesh, shards), n, axis=1).numpy(), 2 * x)
    cpu8 = tmesh.make_mesh(devices=CPU8)
    assert tmesh.stage_mesh(cpu8) == (cpu8, torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.stage_mesh(None)


@pytest.mark.parametrize("spec", [("cam", "frame"), ("frame",), (None, "cam"),
                                  (None, ("cam", "frame")), ()])
def test_device_put_blocks_equal_jax_shards(spec):
    """Each mesh entry holds the block JAX's NamedSharding gives the device
    at the same place of the grid."""
    jm = jmesh.make_mesh(8, cam_axis_size=2)
    tm = tmesh.make_mesh(8, cam_axis_size=2, devices=CPU8)
    x = np.random.default_rng(0).normal(size=(4, 8, 3))
    jx = jax.device_put(x, JNamedSharding(jm, jmesh.P(*spec)))
    where = {d: i for i, d in enumerate(jm.devices.flat)}
    want = [None] * 8
    for s in jx.addressable_shards:
        want[where[s.device]] = np.asarray(s.data)
    got = tmesh.device_put(x, tmesh.NamedSharding(tm, tmesh.P(*spec)))
    assert len(got) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if spec == ():
        assert all(g is got[0] for g in got)      # one copy a device
    assert tmesh.shard_over(tm, *spec) == (tm, tmesh.P(*spec))


def test_batch_spec_equals_jax():
    jm = jmesh.make_mesh(8, cam_axis_size=4)
    tm = tmesh.make_mesh(8, cam_axis_size=4, devices=CPU8)
    for axis in (0, 1, 2):
        assert tuple(tmesh.batch_spec(tm, axis)) == tuple(
            jmesh.batch_spec(jm, axis))
    assert tuple(tmesh.replicate(tm).spec) == tuple(jmesh.replicate(jm).spec)


@pytest.mark.parametrize("n,axis", [(13, 0), (3, 0), (8, 0), (5, 1)])
def test_split_pad_and_gather(n, axis):
    """Shards of the edge-padded batch, each device's copy of replicated
    weights, and the gather cut back to ``n``."""
    mesh = tmesh.make_mesh(devices=CPU8)
    shape = (n, 4) if axis == 0 else (3, n)
    x = np.random.default_rng(n).normal(size=shape).astype(np.float32)
    shards, n_out = tmesh.put_batch_sharded(x, mesh, axis, torch.float64)
    assert n_out == n and len(shards) == 8
    padded, _ = jmesh.pad_to_multiple(x, 8, axis)
    np.testing.assert_array_equal(
        torch.cat(shards, axis).numpy(), padded.astype(np.float64))
    assert all(s.dtype == torch.float64 for s in shards)
    w = tmesh.put_replicated({"w": torch.ones(2)}, mesh)
    assert len(w) == 8 and all(c is w[0] for c in w)
    outs = tmesh.map_shards(lambda s, c: (s * 2, s + c["w"].sum()), mesh,
                            shards, w)
    y, z = tmesh.gather_shards(outs, n, axis)
    np.testing.assert_array_equal(y.numpy(), 2 * x.astype(np.float64))
    np.testing.assert_array_equal(z.numpy(), x.astype(np.float64) + 2)
    size = shards[0].shape[axis]
    assert tmesh.live_shards(shards, n, axis) == list(range(-(-n // size)))


def _svt_batch(n_kf=8, seed=0):
    """``n_kf`` keyframes of 3 cameras x 4 slots: two animals seen by every
    camera with affinity noise that grows along the batch, so the matrices
    converge at different iterations."""
    rng = np.random.default_rng(seed)
    n_cam, slots = 3, 4
    N = n_cam * slots
    cam = np.repeat(np.arange(n_cam), slots)
    truth = np.zeros((N, N))
    for a in range(2):
        idx = cam * slots + a
        truth[np.ix_(idx, idx)] = 1.0
    S = np.empty((n_kf, N, N))
    for k in range(n_kf):
        noise = rng.uniform(0, 0.1 + 0.06 * k, (N, N))
        S[k] = np.clip(0.9 * truth + noise, 0, 1)
        S[k] = (S[k] + S[k].T) / 2
    valid = np.zeros((n_kf, N), bool)
    valid[:, np.tile(np.arange(slots), n_cam) < 3] = True
    return S, cam[:, None] == cam[None, :], valid


def test_svt_stops_all_shards_together():
    from macaque_tpu_torch.association.svt import match_svt

    S, same, valid = _svt_batch()
    kw = dict(dual_stochastic=True, block_size=4)
    one = {}
    want = match_svt(torch.as_tensor(S), torch.as_tensor(same),
                     valid=torch.as_tensor(valid), stats=one, **kw)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    s_sh, n = tmesh.put_batch_sharded(S, mesh)
    v_sh, _ = tmesh.put_batch_sharded(valid, mesh)
    sharded = {}
    got = match_svt(s_sh, tmesh.put_replicated(torch.as_tensor(same), mesh),
                    valid=v_sh, stats=sharded, **kw)
    assert n == 8 and len(got) == 4
    torch.testing.assert_close(tmesh.gather_shards(got, n), want, rtol=0,
                               atol=0)
    assert sharded["iterations"] == one["iterations"] == \
        one["first_converged"].max()
    assert sharded["host_reads"] == one["host_reads"] == one["iterations"]
    np.testing.assert_array_equal(sharded["first_converged"],
                                  one["first_converged"])
    # the shards alone would stop at different iterations: a shard-wise
    # stop would show in the stats
    own = one["first_converged"].reshape(4, 2).max(1)
    assert len(set(own.tolist())) > 1, own
    alone = {}
    match_svt(s_sh[0], torch.as_tensor(same), valid=v_sh[0], stats=alone,
              **kw)
    assert alone["iterations"] == own[0] < one["iterations"]


def test_perception_under_a_mesh_of_eight_entries():
    """The tiny perceptions' ``detect``, ``pose`` and ``classify`` under a
    mesh of eight CPU entries against ``mesh=None``, on 6 frames (not a
    multiple of 8: the padding path), within tests/test_multichip.py's
    tolerances (0.05 px, 1e-4 score, equal labels)."""
    import jax.numpy as jnp

    from macaque_tpu import nn as jnn
    from macaque_tpu_torch.pipeline.perception import TorchPerception
    from tests.torch_parity import (
        JTinyResNet, VIT, jax_detector, random_variables, tiny_perceptions)

    dvars = random_variables(jax_detector(), jnp.zeros((1, 128, 96, 3)),
                             seed=10)
    pvars = random_variables(jnn.ViTPose(jnn.VitPoseConfig(**VIT)),
                             jnp.zeros((1, 64, 48, 3)), seed=11)
    ivars = random_variables(jnn.ResNetClassifier(JTinyResNet()),
                             jnp.zeros((1, 224, 224, 3)), seed=12)
    _, single = tiny_perceptions(dvars, pvars, ivars, max_det=4,
                                 det_target=128)
    sharded = TorchPerception(single.detector_model, single.pose_model,
                              single.id_model, max_det=4, det_target=128,
                              mesh=tmesh.make_mesh(8, cam_axis_size=4,
                                                   devices=CPU8))
    assert sharded.device == torch.device("cpu")
    frames = np.random.default_rng(0).integers(0, 255, (6, 128, 96, 3),
                                               dtype=np.uint8)
    b0, s0 = single.detect(frames)
    b1, s1 = sharded.detect(frames)
    assert b0.shape == b1.shape and s0.shape == s1.shape == (6, 4)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(b1, b0, rtol=0, atol=0.05)

    tb = np.tile(np.array([10.0, 10, 60, 90]), (6, 4, 1))
    valid = np.ones((6, 4), bool)
    valid[2, 1:] = False
    k0 = single.pose(frames, tb, valid)
    k1 = sharded.pose(frames, tb, valid)
    np.testing.assert_array_equal(np.isnan(k1), np.isnan(k0))
    ok = ~np.isnan(k0)
    np.testing.assert_allclose(k1[ok], k0[ok], rtol=0, atol=0.05)

    l0, c0 = single.classify(frames, tb, valid)
    l1, c1 = sharded.classify(frames, tb, valid)
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_allclose(c1, c0, rtol=0, atol=1e-4)


# ------------------------------------------------ kernel launches, guarded

WRAPPERS = ["nn/attention.py", "nn/int8.py", "nn/roialign.py",
            "nn/swin_block.py"]


def test_launch_runs_under_the_inputs_device(monkeypatch):
    """``kernels.launch`` makes the input's device current around the C
    call, passes that device's stream, counts one launch, and raises on a
    launch error without counting."""
    current = [torch.device("cuda", 0)]
    calls = []

    class Guard:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            self.prev, current[0] = current[0], self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    class Lib:
        def __getattr__(self, entry):
            def call(*args):
                calls.append((entry, current[0], args))
                return 0 if args[0] != "fail" else 700
            return call

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(kernels, "current_stream",
                        lambda d: ("stream of", torch.device(d)))
    before = dict(kernels.LAUNCHES)
    dev1 = torch.device("cuda", 1)
    kernels.launch("attention", "attention", dev1, 1, 2)
    assert calls == [("macaque_attention", dev1, (1, 2, ("stream of", dev1)))]
    assert current[0] == torch.device("cuda", 0)
    assert kernels.LAUNCHES["attention"] == before["attention"] + 1
    with pytest.raises(RuntimeError, match="fused_swin_block.*700"):
        kernels.launch("swin_block", "swin_block", dev1, "fail",
                       name="fused_swin_block")
    assert kernels.LAUNCHES["swin_block"] == before["swin_block"]
    monkeypatch.setattr(kernels, "LAUNCHES", before)


@pytest.mark.parametrize("path", WRAPPERS)
def test_wrappers_launch_only_through_the_guard(path):
    """No wrapper calls a kernel's C entry point or takes a stream itself:
    every launch goes through ``kernels.launch``."""
    with open(os.path.join(ROOT, "macaque_tpu_torch", path)) as f:
        src = f.read()
    assert "kernels.current_stream" not in src
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Attribute) and node.attr.startswith("macaque_"):
            # only the occupancy queries, made under their own guard
            assert node.attr.endswith(("_slots", "_blocks_per_sm")), node.attr


def test_every_kernel_has_a_guarded_launch():
    srcs = ""
    for path in WRAPPERS:
        with open(os.path.join(ROOT, "macaque_tpu_torch", path)) as f:
            srcs += f.read()
    for kernel in kernels.LAUNCHES:
        assert re.search(r'kernels\.launch\(\s*"%s"' % kernel, srcs), kernel
