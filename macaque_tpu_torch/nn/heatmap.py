"""UDP heatmap decoding and flip-test fusion, batched in PyTorch.

The UDPHeatmap codec of the reference's pose model, as
``macaque_tpu/nn/heatmap.py`` computes it: argmax, DARK sub-pixel
refinement (Gaussian blur, log, one Newton step on the edge-padded map),
then the UDP scale ``pixel = hm * (in-1)/(hm-1)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from macaque_tpu_torch.core.trace import count

# COCO/macaque 17-kp left-right swap pairs
MACAQUE_FLIP_PAIRS = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10),
                      (11, 12), (13, 14), (15, 16)]


def _gaussian_kernel1d(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma=0) semantics."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def gaussian_blur_heatmaps(heatmaps: torch.Tensor, kernel: int = 11
                           ) -> torch.Tensor:
    """Zero-padded separable Gaussian blur with per-map max re-scaling
    (mmpose ``gaussian_blur``). heatmaps: (..., H, W)."""
    count("host_reads.blur")            # copies that wait on a card
    k = torch.as_tensor(_gaussian_kernel1d(kernel), dtype=heatmaps.dtype,
                        device=heatmaps.device)
    border = (kernel - 1) // 2
    orig_max = heatmaps.amax(dim=(-2, -1), keepdim=True)
    shape = heatmaps.shape
    x = heatmaps.reshape(-1, 1, shape[-2], shape[-1])
    x = F.conv2d(x, k.view(1, 1, 1, kernel), padding=(0, border))
    x = F.conv2d(x, k.view(1, 1, kernel, 1), padding=(border, 0))
    x = x.reshape(shape)
    new_max = x.amax(dim=(-2, -1), keepdim=True)
    return x * orig_max / new_max.clamp_min(1e-12)


def udp_decode(heatmaps: torch.Tensor, input_size=(192, 256),
               blur_kernel: int = 11):
    """Heatmaps (B, H, W, K) -> (keypoints (B, K, 2) in input-pixel coords,
    scores (B, K)), mmpose UDPHeatmap.decode."""
    hm = heatmaps.movedim(-1, -3)               # (B, K, H, W)
    B, K, H, W = hm.shape
    flat = hm.reshape(B, K, -1)
    idx = flat.argmax(-1)
    vals = torch.gather(flat, -1, idx[..., None])[..., 0]
    x = (idx % W).to(torch.float32)
    y = (idx // W).to(torch.float32)

    blurred = gaussian_blur_heatmaps(hm, blur_kernel)
    logh = torch.log(blurred.clamp(1e-3, 50.0))
    padded = F.pad(logh.reshape(B * K, 1, H, W), (1, 1, 1, 1),
                   mode="replicate").reshape(B, K, H + 2, W + 2)
    xi = (idx % W) + 1
    yi = (idx // W) + 1
    bi = torch.arange(B, device=hm.device)[:, None]
    ki = torch.arange(K, device=hm.device)[None, :]

    def at(dy, dx):
        return padded[bi, ki, yi + dy, xi + dx]

    c = at(0, 0)
    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = at(0, 1) - 2 * c + at(0, -1)
    dyy = at(1, 0) - 2 * c + at(-1, 0)
    dxy = 0.5 * (at(1, 1) - at(0, 1) - at(1, 0) + 2 * c - at(0, -1)
                 - at(-1, 0) + at(-1, -1))
    eps = float(np.finfo(np.float32).eps)
    a11, a12, a22 = dxx + eps, dxy, dyy + eps
    det = a11 * a22 - a12 * a12
    inv_det = 1.0 / torch.where(det.abs() > 0, det, torch.ones_like(det))
    x = x + (-(a22 * dx - a12 * dy) * inv_det)
    y = y + (-(a11 * dy - a12 * dx) * inv_det)

    in_w, in_h = input_size
    kp = torch.stack([x * ((in_w - 1) / (W - 1)), y * ((in_h - 1) / (H - 1))],
                     dim=-1)
    return kp, vals


def flip_heatmaps(heatmaps: torch.Tensor, flip_pairs=MACAQUE_FLIP_PAIRS):
    """Undo a horizontal image flip on heatmaps (B, H, W, K): mirror W and
    swap left/right channels (flip_mode='heatmap', shift_heatmap=False)."""
    count("host_reads.flip")            # copies that wait on a card
    perm = np.arange(heatmaps.shape[-1])
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return heatmaps.flip(-2)[..., torch.as_tensor(perm, device=heatmaps.device)]


def pose_forward_flip(model, crops: torch.Tensor, flip_pairs=MACAQUE_FLIP_PAIRS
                      ) -> torch.Tensor:
    """Flip-test wrapper: the mean of the direct heatmaps and those of the
    horizontally flipped crops (B, H, W, 3) mapped back (reference
    step1:101). Takes the module ``model`` where the JAX package's takes
    ``apply_fn, params``; ``TorchPerception`` runs the same sum on one
    batch of direct and flipped crops."""
    hm = model(crops)
    return 0.5 * (hm + flip_heatmaps(model(crops.flip(2)), flip_pairs))
