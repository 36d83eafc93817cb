"""The port's autoencoder score filter (``macaque_tpu_torch/filters/
autoencoder.py``) against the JAX package's on the CPU: 300 epochs of
full-batch Adam from the same threefry initial weights, the filtered
scores, and the ``.npz`` weights read by the other package both ways.

Tier 1 runs JAX with x64 on, where ``jax.random.normal`` draws float64:
the port trains in float64 here. Tolerances (found in brackets): initial
weights within 1e-12 relative [4e-15; the normal draws' erfinv is XLA's
polynomial on one side, see test_torch_train_detection.py], trained
weights within 1e-9 [1e-14] and filtered scores within 1e-9 [1.4e-15]
after 300 epochs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from macaque_tpu.filters import autoencoder as jae
from macaque_tpu_torch.filters import (
    AEParams, filter_scores_autoencoder, load_autoencoder, save_autoencoder,
    train_autoencoder)


def _scores(n=600, J=17, seed=0):
    """Keypoint scores with correlated occlusions (a side of the body
    hidden together) and NaNs."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.55, 1.0, (n, J))
    left = rng.uniform(0, 1, n) < 0.3
    s[left, 1:J:2] = rng.uniform(0.0, 0.4, (left.sum(), len(range(1, J, 2))))
    s[rng.uniform(0, 1, (n, J)) < 0.05] = np.nan
    return s


@pytest.fixture(scope="module")
def trained():
    scores = _scores()
    jp = jae.train_autoencoder(scores, epochs=300, seed=3)
    tp = train_autoencoder(scores, epochs=300, seed=3, device="cpu",
                           dtype=torch.float64)
    return scores, jp, tp


def test_initial_weights_are_jaxs():
    scores = _scores(50)
    jp = jae.train_autoencoder(scores, epochs=0, seed=5)
    tp = train_autoencoder(scores, epochs=0, seed=5, device="cpu",
                           dtype=torch.float64)
    for k in AEParams._fields:
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-12,
                                   atol=0, err_msg=k)
    assert np.abs(tp.w1.numpy()).max() > 0


def test_300_epochs_match_jax(trained):
    scores, jp, tp = trained
    for k in AEParams._fields:
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
    got = filter_scores_autoencoder(tp, scores)
    want = jae.filter_scores_autoencoder(jp, scores)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert got.shape == scores.shape and (got <= np.nan_to_num(scores)).all()
    # trained: hidden-side keypoints of occluded frames are suppressed more
    left = np.nanmean(np.where(np.isnan(scores), 1, scores)[:, 1::2], 1) < 0.5
    assert got[left, 1::2].mean() < got[~left, 1::2].mean()


def test_npz_exchanged_both_ways(trained, tmp_path):
    scores, jp, tp = trained
    save_autoencoder(tp, str(tmp_path / "torch.npz"))
    jae.save_autoencoder(jp, str(tmp_path / "jax.npz"))
    from_port = jae.load_autoencoder(str(tmp_path / "torch.npz"))
    from_jax = load_autoencoder(str(tmp_path / "jax.npz"), device="cpu")
    with np.load(tmp_path / "torch.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(AEParams._fields)
    for k in AEParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(from_port, k)),
                                      getattr(tp, k).numpy())
        np.testing.assert_array_equal(getattr(from_jax, k).numpy(),
                                      np.asarray(getattr(jp, k)))
    np.testing.assert_allclose(
        filter_scores_autoencoder(from_jax, scores),
        jae.filter_scores_autoencoder(from_port, scores), rtol=0, atol=1e-9)


def test_float32_training_on_the_default_dtype():
    tp = train_autoencoder(_scores(200), epochs=50, device="cpu")
    assert all(getattr(tp, k).dtype == torch.float32 for k in AEParams._fields)
    out = filter_scores_autoencoder(tp, _scores(200))
    assert np.isfinite(out).all()
