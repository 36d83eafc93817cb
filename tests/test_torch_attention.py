"""The port's packed attention (``macaque_tpu_torch.nn.attention``) against
the JAX package's Pallas kernel (interpret mode) and jax.nn's attention,
on the same numpy inputs. The CUDA kernel is held against its plain
version on a card in test_torch_cuda.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from macaque_tpu.nn.pallas_attention import fused_attention_packed
from macaque_tpu_torch import kernels
from macaque_tpu_torch.nn.attention import (
    packed_attention, packed_attention_reference)


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
