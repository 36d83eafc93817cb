"""The port's int8 serving path (``macaque_tpu_torch.nn.int8`` and
``nn.quant``) against the JAX package's: the quantize chain, the Pallas
kernels (interpret mode), the weight quantizers and an int8 ViTPose and
Swin at small width, on the same numpy inputs. The plain versions hold the
JAX functions bitwise: the int32 dot is exact on both sides, and the JAX
kernels' epilogue, as XLA compiles it, is one fused multiply-add, which the
port rounds the same way. The CUDA kernels are held against these plain
versions on a card in test_torch_cuda.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from macaque_tpu import nn as jnn
from macaque_tpu.nn import quant as jquant
from macaque_tpu.nn.pallas_int8 import (
    quant_int8_matmul as jax_fused, quant_int8_matmul_split as jax_split,
    quantize_rows as jax_quantize_rows)
from macaque_tpu.nn.swin import SwinConfig as JSwinConfig
from macaque_tpu_torch import kernels
from macaque_tpu_torch import nn as tnn
from macaque_tpu_torch.nn.convert import swin_maskrcnn_from_jax, vitpose_from_jax
from macaque_tpu_torch.nn.int8 import (
    fma_f32, quant_int8_matmul, quant_int8_matmul_reference,
    quant_int8_matmul_split, quantize_rows, quantize_rows_reference)
from macaque_tpu_torch.nn.quant import (
    Int8Linear, int8_matmul_reference, quantize_dense, quantize_swin_,
    quantize_vitpose_)
from macaque_tpu_torch.nn.swin import SwinConfig
from tests.torch_parity import (
    DET, SWIN, VIT, jax_detector, load, random_variables, torch_detector)

# the shapes of tests/test_pallas_int8.py: exact tiles, M and N padded, and
# a problem smaller than one tile
SHAPES = [(256, 1280, 512), (300, 1280, 640), (64, 384, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(M, K, N, dtype, seed=0):
    """x (M, K) in ``dtype`` on both sides, kernel_q (K, N) int8, wscale and
    bias (N,) f32; the port's weight_q is kernel_q transposed."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(jdt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    kq = rng.integers(-127, 128, (K, N), dtype=np.int8)
    ws = rng.uniform(0.001, 0.01, N).astype(np.float32)
    b = rng.normal(0, 0.1, N).astype(np.float32)
    port = (xt, torch.from_numpy(np.ascontiguousarray(kq.T)),
            torch.from_numpy(ws), torch.from_numpy(b))
    return (xj, jnp.asarray(kq), jnp.asarray(ws), jnp.asarray(b)), port


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_reference_is_the_jax_chain(M, K, N, dtype, bias):
    """``int8_matmul`` plus ``Int8Dense``'s bias, added after the cast."""
    (xj, kq, ws, b), (xt, wq, wst, bt) = _inputs(M, K, N, dtype)
    want = jquant.int8_matmul(xj, kq, ws)
    if bias:
        want = want + b.astype(want.dtype)
    _same(int8_matmul_reference(xt, wq, wst, bt if bias else None), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_quantize_rows_matches_pallas_kernel(M, K, N, dtype):
    (xj, *_), (xt, *_) = _inputs(M, K, N, dtype)
    pad = (-M) % 256                    # the Pallas kernel's callers pad M
    q, s = jax_quantize_rows(jnp.pad(xj, ((0, pad), (0, 0))), interpret=True)
    for fn in (quantize_rows_reference, quantize_rows):
        tq, ts = fn(xt)
        assert tq.dtype == torch.int8 and ts.shape == (M, 1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q)[:M])
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s)[:M])


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_fused_matmul_matches_pallas_kernel(M, K, N, dtype, bias):
    (xj, kq, ws, b), (xt, wq, wst, bt) = _inputs(M, K, N, dtype)
    want = jax_fused(xj, kq, ws, b if bias else None, interpret=True)
    for fn in (quant_int8_matmul_reference, quant_int8_matmul):
        _same(fn(xt, wq, wst, bt if bias else None), want)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_split_matches_pallas_split(M, K, N, dtype, bias):
    (xj, kq, ws, b), (xt, wq, wst, bt) = _inputs(M, K, N, dtype)
    want = jax_split(xj, kq, ws, b if bias else None, interpret=True)
    _same(quant_int8_matmul_split(xt, wq, wst, bt if bias else None), want)


def test_leading_dims_and_wrappers_launch_nothing_on_cpu():
    (xj, kq, ws, b), (xt, wq, wst, bt) = _inputs(6 * 50, 384, 128, "bfloat16", 2)
    before = dict(kernels.LAUNCHES)
    got = quant_int8_matmul(xt.reshape(6, 50, 384), wq, wst, bt)
    assert got.shape == (6, 50, 128) and got.dtype == torch.bfloat16
    _same(got.reshape(300, 128), jax_fused(xj, kq, ws, b, interpret=True))
    assert kernels.LAUNCHES == before


def test_fma_f32_rounds_once():
    """As XLA's fused multiply-add, and where rounding the sum to float64
    first would give another float32."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=100_000).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    # a * b + c = 1 + 2^-23 + 2^-24 - 2^-70: just below the tie between
    # 1 + 2^-23 and 1 + 2^-22, which float64 rounds onto
    a, b, c = (torch.tensor([v], dtype=torch.float32) for v in
               (2.0 ** -24 + 2.0 ** -47, 1 - 2.0 ** -23, 1 + 2.0 ** -23))
    assert fma_f32(a, b, c).item() == 1 + 2.0 ** -23
    assert (a.double() * b.double() + c.double()).float().item() == 1 + 2.0 ** -22


def test_quantize_dense_matches_jax():
    rng = np.random.default_rng(3)
    kernel = rng.normal(0, 0.02, (384, 256)).astype(np.float32)
    kernel[:, 7] = 0.0                  # a dead channel: the 1e-12 floor
    want = jquant.quantize_dense({"kernel": kernel})
    wq, wscale = quantize_dense(torch.from_numpy(np.ascontiguousarray(kernel.T)))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(wscale.numpy(), np.asarray(want["wscale"]))


def _vit_variables(seed=0):
    jm = jnn.ViTPose(jnn.VitPoseConfig(**VIT))
    return random_variables(jm, jnp.zeros((1, 64, 48, 3), jnp.float32),
                            seed=seed)


def _int8_layers(model):
    return {n: m for n, m in model.named_modules() if isinstance(m, Int8Linear)}


@pytest.mark.parametrize("from_checkpoint", [False, True],
                         ids=["own_weights", "checkpoint"])
def test_quantize_vitpose_matches_jax_tree(from_checkpoint):
    """quantize_vitpose_ on a float model (from its own float32 weights or
    from a float checkpoint) gives the JAX package's quantized tree."""
    v = _vit_variables()
    sd = vitpose_from_jax(v)
    tm = load(tnn.ViTPose(tnn.VitPoseConfig(**VIT), device="cpu"), sd)
    quantize_vitpose_(tm, sd if from_checkpoint else None)
    assert tm.cfg.quantize == "int8" and tm.cfg._gelu_approx
    want = load(tnn.ViTPose(tnn.VitPoseConfig(**VIT, quantize="int8"),
                            device="cpu"),
                vitpose_from_jax(jquant.quantize_vitpose_params(v)))
    layers, ref = _int8_layers(tm), _int8_layers(want)
    assert len(layers) == 4 * VIT["depth"] and layers.keys() == ref.keys()
    for name, m in layers.items():
        for buf in ("weight_q", "wscale", "bias"):
            torch.testing.assert_close(getattr(m, buf), getattr(ref[name], buf),
                                       rtol=0, atol=0)


@pytest.fixture(scope="module")
def swin_int8():
    """Float detector variables, JAX's quantized tree of them, one image."""
    img = np.random.default_rng(4).normal(size=(1, 128, 96, 3)).astype(
        np.float32)
    v = random_variables(jax_detector(), jnp.asarray(img), seed=4)
    return v, jquant.quantize_swin_params(v), img


def _int8_detector():
    return tnn.SwinMaskRCNN(tnn.DetectorConfig(
        swin=SwinConfig(**SWIN, quantize="int8"), **DET), device="cpu")


def test_quantize_swin_matches_jax_tree(swin_int8):
    v, qv, _ = swin_int8
    tm = quantize_swin_(load(torch_detector(), swin_maskrcnn_from_jax(v)))
    assert tm.backbone.cfg.quantize == "int8"
    layers = _int8_layers(tm)
    ref = _int8_layers(load(_int8_detector(), swin_maskrcnn_from_jax(qv)))
    assert len(layers) == 4 * sum(SWIN["depths"]) and layers.keys() == ref.keys()
    for name, m in layers.items():
        for buf in ("weight_q", "wscale", "bias"):
            torch.testing.assert_close(getattr(m, buf), getattr(ref[name], buf),
                                       rtol=0, atol=0)


def _codes(inputs):
    return [quantize_rows_reference(torch.as_tensor(np.asarray(x)).reshape(
        -1, x.shape[-1]))[0] for x in inputs]


def _run_both(monkeypatch, jax_fn, torch_model, torch_fn):
    """Both int8 models on their inputs, recording every int8 layer's input
    on both sides; returns the outputs, the number of activation codes that
    differ and the number of codes. The JAX model runs op by op (no jit), so
    its chain rounds as written."""
    seen_jax, seen_torch = [], []
    chain = jquant.int8_matmul

    def recording(x, kernel_q, wscale):
        seen_jax.append(np.asarray(x))
        return chain(x, kernel_q, wscale)

    monkeypatch.setattr(jquant, "int8_matmul", recording)
    want = jax_fn()
    for m in _int8_layers(torch_model).values():
        m.register_forward_pre_hook(lambda mod, args: seen_torch.append(
            args[0].detach().clone()))
    with torch.no_grad():
        got = torch_fn()
    assert len(seen_jax) == len(seen_torch) == len(_int8_layers(torch_model))
    cj, ct = _codes(seen_jax), _codes(seen_torch)
    flips = sum(int((a != b).sum()) for a, b in zip(cj, ct))
    return want, got, flips, sum(c.numel() for c in cj)


def _tolerance(flips: int, scale: float) -> float:
    """1e-4 (float32 noise, as the float models are held) when every code
    agrees. A flipped code moves its layer's output by one quantization step
    (up to 1/127 of its row's maximum), which can flip codes downstream;
    then 2^-6 of the output's ``scale``."""
    return 1e-4 if flips == 0 else 2.0 ** -6 * scale


@pytest.mark.parametrize("seed", [6, 7])
def test_int8_vitpose_matches_jax(monkeypatch, seed):
    """ViTPose(quantize="int8") at depth 2, width 64, float32, with JAX's
    quantized tree carried across. Identical codes need identical LayerNorm
    inputs; the two packages differ there by float32 noise (the patch
    embedding's convolution, summation order), so a value within that noise
    of a rounding boundary takes the neighbouring code. The test counts the
    codes that differ: seed 6 gives none (heatmaps within 5e-7), seed 7
    gives 428 of 43,008 (heatmaps within 3.4e-3 of a 1.0 range)."""
    v = jquant.quantize_vitpose_params(_vit_variables(seed=seed))
    x = np.random.default_rng(seed).normal(size=(4, 64, 48, 3)).astype(
        np.float32)
    jm = jnn.ViTPose(jnn.VitPoseConfig(**VIT, quantize="int8"))
    tm = load(tnn.ViTPose(tnn.VitPoseConfig(**VIT, quantize="int8"),
                          device="cpu"), vitpose_from_jax(v))
    want, got, flips, n = _run_both(
        monkeypatch, lambda: np.asarray(jm.apply(v, jnp.asarray(x))), tm,
        lambda: tm(torch.from_numpy(x)).numpy())
    print(f"int8 ViTPose seed {seed}: {flips} of {n} activation codes "
          f"differ; max |d heatmap| {np.abs(got - want).max():.2e}")
    assert flips <= n // 50
    assert got.shape == want.shape == (4, 16, 12, 17)
    np.testing.assert_allclose(
        got, want, atol=_tolerance(flips, np.ptp(want)), rtol=0)


def test_int8_swin_matches_jax(monkeypatch, swin_int8):
    """The int8 Swin backbone (8 blocks, window 7), float32, with JAX's
    quantized tree; codes counted as in the ViTPose test (0 of 380,928 with
    this seed, maps within 2e-6)."""
    _, qv, img = swin_int8
    jm = jnn.SwinMaskRCNN(jnn.DetectorConfig(
        swin=JSwinConfig(**SWIN, quantize="int8"), **DET))
    tm = load(_int8_detector(), swin_maskrcnn_from_jax(qv))
    want, got, flips, n = _run_both(
        monkeypatch,
        lambda: jm.apply(qv, jnp.asarray(img), method=lambda m, y: m.backbone(y)),
        tm, lambda: tm.backbone(torch.from_numpy(img)))
    print(f"int8 Swin: {flips} of {n} activation codes differ")
    assert flips <= n // 50 and len(got) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, atol=_tolerance(flips, np.abs(w).max()), rtol=0)


@pytest.mark.parametrize("K, route", [(384, "split"), (2048, "split"),
                                      (2080, "fused")])
def test_int8_linear_routes_on_cpu_and_checks_impl(K, route):
    """On the CPU every layer runs the JAX default tier's chain (bias after
    the cast); its card route follows from K alone: the split route up to
    K = 2048, the fused kernel above."""
    (_, _, _, _), (xt, wq, wst, bt) = _inputs(40, K, 128, "bfloat16", 9)
    m = Int8Linear(K, 128)
    m.load_state_dict({"weight_q": wq, "wscale": wst, "bias": bt})
    assert m.route == route
    torch.testing.assert_close(m(xt), int8_matmul_reference(xt, wq, wst, bt),
                               rtol=0, atol=0)
