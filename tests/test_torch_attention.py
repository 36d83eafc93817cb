"""The port's packed attention and its unpacked attention with the
dispatcher (``macaque_tpu_torch.nn.attention``) against the JAX package's
Pallas kernels (interpret mode) and jax.nn's attention, on the same numpy
inputs. The CUDA kernels are held against their plain versions on a card in
test_torch_cuda.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from macaque_tpu.nn import pallas_attention as pa
from macaque_tpu.nn.pallas_attention import fused_attention_packed
from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.attention import (
    attention, attention_reference, fused_attention, fused_attention_blocked,
    packed_attention, packed_attention_reference)

from attention_cases import cancelling_qkv


def _qkv(seed, B, N, H, D):
    return np.random.default_rng(seed).normal(size=(B, N, 3 * H * D)).astype(
        np.float32)


# float32 both sides: only summation order differs (<= ~1e-6 observed)
@pytest.mark.parametrize("B,N,H,D", [(2, 192, 4, 80), (3, 16, 2, 8)])
def test_reference_matches_pallas_kernel(B, N, H, D):
    x = _qkv(0, B, N, H, D)
    want = np.asarray(fused_attention_packed(jnp.asarray(x), heads=H,
                                             interpret=True))
    got = packed_attention_reference(torch.from_numpy(x), H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_reference_matches_jax_dot_product_attention():
    B, N, H, D = 2, 48, 4, 16
    x = _qkv(1, B, N, H, D)
    q, k, v = (jnp.asarray(t).reshape(B, N, H, D)
               for t in np.split(x, 3, axis=-1))
    want = np.asarray(jax.nn.dot_product_attention(q, k, v)).reshape(B, N, -1)
    got = packed_attention_reference(torch.from_numpy(x), H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_reference_bf16_matches_pallas_kernel_bf16():
    """bf16 in, bf16 out, probabilities rounded to bf16 before P V on both
    sides: agreement to one bf16 ulp of the output (2^-7 relative)."""
    B, N, H, D = 2, 64, 2, 16
    x = _qkv(2, B, N, H, D)
    want = np.asarray(fused_attention_packed(
        jnp.asarray(x, jnp.bfloat16), heads=H, interpret=True), np.float32)
    got = packed_attention_reference(
        torch.from_numpy(x).to(torch.bfloat16), H).float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -7 * np.abs(want).max())


def test_wrapper_runs_plain_version_on_cpu():
    x = torch.from_numpy(_qkv(3, 2, 16, 2, 8))
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(packed_attention(x, 2),
                               packed_attention_reference(x, 2), rtol=0, atol=0)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        packed_attention(torch.empty((1, 192, 3840), device="meta"), 16)


def _qkv_unpacked(seed, B, N, H, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, N, H, D)).astype(np.float32) for _ in range(3)]


JAX_UNPACKED = {"fused_attention": pa.fused_attention,
                "fused_attention_blocked": pa.fused_attention_blocked}
PORT_UNPACKED = {"attention_reference": attention_reference,
                 "attention": attention, "fused_attention": fused_attention,
                 "fused_attention_blocked": fused_attention_blocked}


# float32 both sides, the shapes of tests/test_pallas_attention.py and a
# small one: summation order only
@pytest.mark.parametrize("port", PORT_UNPACKED)
@pytest.mark.parametrize("kernel", JAX_UNPACKED)
@pytest.mark.parametrize("B,N,H,D", [(2, 192, 4, 80), (3, 16, 2, 8)])
def test_unpacked_attention_matches_pallas_kernels(B, N, H, D, kernel, port):
    q, k, v = _qkv_unpacked(4, B, N, H, D)
    want = np.asarray(JAX_UNPACKED[kernel](
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = PORT_UNPACKED[port](*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (B, N, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("kernel", JAX_UNPACKED)
def test_unpacked_attention_bf16_matches_pallas_kernels(kernel):
    """bf16 in and out, f32 inside on both sides (P not rounded): the two
    round one f32 result each to bf16, within one bf16 ulp of the largest
    output (2^-7 relative)."""
    q, k, v = _qkv_unpacked(5, 2, 64, 2, 16)
    want = np.asarray(JAX_UNPACKED[kernel](
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), interpret=True),
        np.float32)
    got = attention_reference(*(torch.from_numpy(t).to(torch.bfloat16)
                                for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_unpacked_wrappers_run_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv_unpacked(6, 2, 16, 2, 8))
    before = dict(kernels.LAUNCHES)
    want = attention_reference(q, k, v)
    for fn in (attention, fused_attention, fused_attention_blocked):
        torch.testing.assert_close(fn(q, k, v), want, rtol=0, atol=0)
    assert kernels.LAUNCHES == before     # the CPU path launches nothing


@pytest.mark.parametrize("fn", [attention, fused_attention,
                                fused_attention_blocked])
def test_unpacked_wrappers_refuse_other_devices(fn):
    t = torch.empty((1, 192, 16, 80), device="meta")
    with pytest.raises(ValueError):
        fn(t, t, t)


def test_split_p_keeps_f32_accuracy_where_values_cancel():
    """K4 keeps P at f32 precision on the card by splitting it into two bf16
    terms, hi = bf16(P) and lo = bf16(P - hi), and summing hi V + lo V in
    f32 (csrc/attention_core.cuh); the kernel cannot run here, so this
    emulates its arithmetic in f32 torch against JAX's all-f32
    ``fused_attention`` (interpret mode) on inputs whose value rows cancel
    (max |v| 66 times the largest output). hi + lo carries P to
    16 significant bits (|P - hi - lo| <= 2^-16 P); the cancellation
    multiplies that by the |v|-to-output ratio, and f32 summation noise
    adds about 2^-15, so the split must stay within 2^-12 of the largest
    output (seen: 2^-13.5). P rounded once to bf16 (2^-8 P) lands
    near 2^-4: outside 2^-12, and outside the card's 2^-6 tolerance too."""
    q, k, v = cancelling_qkv(0, 2, 192, 2, 80)
    want = np.asarray(pa.fused_attention(*map(jnp.asarray, (q, k, v)),
                                         interpret=True))
    qh, kh, vh = (torch.from_numpy(t).transpose(1, 2) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (80 ** -0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    split = (hi @ vh + lo @ vh).transpose(1, 2).numpy()
    single = (hi @ vh).transpose(1, 2).numpy()
    top = np.abs(want).max()
    assert np.abs(v).max() >= 50 * top             # the values do cancel
    assert np.abs(split - want).max() <= 2.0 ** -12 * top
    assert np.abs(single - want).max() > 2.0 ** -6 * top
