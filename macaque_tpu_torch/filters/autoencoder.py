"""Autoencoder keypoint-score filter.

The port of ``macaque_tpu/filters/autoencoder.py`` (anipose's autoencoder
filter family, reference src/third_party/anipose/filter_pose.py:263-330 +
train_autoencoder.py): a small MLP autoencoder is trained on the pattern of
visible keypoints of confident frames; at filtering time each frame's
visibility pattern is reconstructed, and each keypoint's score is capped by
its reconstructed visibility (implausible keypoints given the visible
context are suppressed).

The initial weights are JAX's: ``jax.random.normal`` under the two keys of
``PRNGKey(seed)`` split in two (``utils/threefry.py``), so both packages
start from the same weights; training is full-batch Adam. Weights are saved
as ``.npz`` with the JAX package's keys (``w1``, ``b1``, ``w2``, ``b2``), so
each package reads the other's file.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.nn import optim
from macaque_tpu_torch.utils import threefry


class AEParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _forward(params: AEParams, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ params.w1 + params.b1)
    return torch.sigmoid(h @ params.w2 + params.b2)


def _binarize(scores, score_threshold, params_like: torch.Tensor):
    x = (np.nan_to_num(scores) > score_threshold).astype(np.float32)
    return torch.from_numpy(x).to(params_like.device, params_like.dtype)


def train_autoencoder(
    scores: np.ndarray,
    score_threshold: float = 0.5,
    hidden: int = 16,
    epochs: int = 300,
    lr: float = 1e-2,
    seed: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> AEParams:
    """scores: (N_frames, J) keypoint confidences. Trains the reconstruction
    of the binarized visibility pattern, on ``device`` (the card unless told
    otherwise) in ``dtype``: float32, or float64 for the JAX package's
    stream with x64 on (``jax.random.normal``'s default dtype)."""
    dev = resolve_device(device)
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    J = np.asarray(scores).shape[1]
    k1, k2 = threefry.split(threefry.prng_key(seed))
    as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    params = {
        "w1": as_t(threefry.normal(k1, (J, hidden), np_dtype) * 0.3),
        "b1": torch.zeros(hidden, dtype=dtype, device=dev),
        "w2": as_t(threefry.normal(k2, (hidden, J), np_dtype) * 0.3),
        "b2": torch.zeros(J, dtype=dtype, device=dev),
    }
    x = _binarize(scores, score_threshold, params["w1"])
    opt = optim.adam(lr)
    state = opt.init(params)
    eps = 1e-7
    for _ in range(epochs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            pred = _forward(AEParams(**leaves), x)
            loss = -torch.mean(x * torch.log(pred + eps)
                               + (1 - x) * torch.log(1 - pred + eps))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, state = opt.update(grads, state, params)
        params = optim.apply_updates(params, updates)
    return AEParams(**params)


def save_autoencoder(params: AEParams, fname: str) -> str:
    """Persist trained filter weights as ``.npz`` (the JAX package's keys;
    the reference pickles an sklearn MLP to
    config['filter']['autoencoder_path'])."""
    np.savez(fname, **{k: v.detach().cpu().numpy()
                       for k, v in params._asdict().items()})
    return fname


def load_autoencoder(fname: str, device=None) -> AEParams:
    """Weights saved by either package, on ``device`` (the card unless told
    otherwise), in the dtype they were saved in."""
    dev = resolve_device(device)
    with np.load(fname) as d:
        return AEParams(**{k: torch.from_numpy(d[k]).to(dev)
                           for k in AEParams._fields})


@torch.no_grad()
def filter_scores_autoencoder(params: AEParams, scores: np.ndarray,
                              score_threshold: float = 0.5) -> np.ndarray:
    """Replace each keypoint's score with min(score, reconstructed
    visibility): implausible keypoints are suppressed (the semantics of
    anipose filter_pose_autoencoder_scores)."""
    recon = _forward(params, _binarize(scores, score_threshold, params.w1))
    return np.minimum(np.nan_to_num(scores), recon.cpu().numpy())
