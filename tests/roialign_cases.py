"""RoIs at the edges of the windowed RoIAlign's geometry, the weighted support
that the K2 kernel (csrc/roi_align_windowed.cu) reads, and a plain emulation
of the separable product with every sum taken in order, shared by the CPU
tests (test_torch_roialign.py) and the card test of K2
(test_torch_cuda.py). Imports neither JAX nor the JAX package."""

import numpy as np
import torch

KINDS = 7


def edge_rois(seed, B, R, img):
    """(B, R, 4) float64 xyxy boxes on an img x img image and their FPN
    levels (B, R) int32 (mmdet's finest-scale rule), cycling through seven
    kinds: touching the top-left border, touching the bottom-right border,
    2-6 px boxes (bins under one feature pixel at level 0, stride 4), wholly
    outside the image (beyond the right or bottom edge, or above and left of
    it: every sample outside the level, so a zero output), degenerate zero
    boxes, large boxes up to the whole image, and ordinary ones."""
    rng = np.random.default_rng(seed)
    boxes = np.empty((B, R, 4))
    for b in range(B):
        for i in range(R):
            kind = i % KINDS
            if kind == 0:                       # top-left border
                w, h = rng.uniform(8, img / 2, 2)
                x1, y1 = 0.0, rng.choice([0.0, rng.uniform(0, img - h)])
            elif kind == 1:                     # bottom-right border
                w, h = rng.uniform(8, img / 2, 2)
                x1, y1 = img - w, rng.choice([img - h, rng.uniform(0, img - h)])
            elif kind == 2:                     # bins under a pixel
                w, h = rng.uniform(2, 6, 2)
                x1, y1 = rng.uniform(0, img - 6, 2)
            elif kind == 3:                     # wholly outside
                w, h = rng.uniform(20, 120, 2)
                x1, y1 = ((img + rng.uniform(10, 50), rng.uniform(0, img))
                          if rng.random() < 0.5 else
                          (-w - rng.uniform(10, 50), -h - rng.uniform(10, 50)))
            elif kind == 4:                     # degenerate
                boxes[b, i] = 0.0
                continue
            elif kind == 5:                     # large, to the whole image
                w, h = rng.uniform(img / 2, img, 2)
                x1, y1 = rng.uniform(0, img - w), rng.uniform(0, img - h)
            else:
                w, h = np.exp(rng.uniform(np.log(8), np.log(img / 2), 2))
                x1, y1 = rng.uniform(0, img - w), rng.uniform(0, img - h)
            boxes[b, i] = (x1, y1, x1 + w, y1 + h)
    wh = np.maximum(boxes[..., 2:] - boxes[..., :2], 0)
    lvl = np.clip(np.floor(np.log2(np.sqrt(wh[..., 0] * wh[..., 1]) / 56.0
                                   + 1e-6)), 0, 3).astype(np.int32)
    return boxes, lvl


def weighted_support(ky, kx):
    """The window rows with a nonzero Ky entry and the window columns with a
    nonzero Kx entry, (R, window) bool each: the pixels the kernel reads."""
    return (ky != 0).any(1), (kx != 0).any(1)


def separable_in_order(ky, kx, win, rows=None, cols=None):
    """out[r, p, q, c] = sum_j Kx[r, q, j] (sum_i Ky[r, p, i] win[r, i, j, c])
    in float32, each sum taken one term at a time in ascending index order
    (a product, then a rounded add), over every window row and column, or
    only over the rows and columns where ``rows`` / ``cols`` is True.
    ky, kx (R, 7, w); win (R, w, w, C) -> (R, 7, 7, C)."""
    ky, kx, win = ky.float(), kx.float(), win.float()
    R, P, w = ky.shape
    mid = torch.zeros((R, P, w, win.shape[-1]), device=win.device)
    for i in range(w):
        mid = _add(mid, ky[:, :, i, None, None] * win[:, None, i],
                   None if rows is None else rows[:, i])
    out = torch.zeros((R, P, P, win.shape[-1]), device=win.device)
    for j in range(w):
        out = _add(out, kx[:, None, :, j, None] * mid[:, :, None, j],
                   None if cols is None else cols[:, j])
    return out


def _add(acc, term, keep):
    """acc + term, or acc where ``keep`` (R,) is False."""
    if keep is None:
        return acc + term
    return torch.where(keep[:, None, None, None], acc + term, acc)


def windows_of(canvas, plane, ys, xs, w):
    """The (R, w, w, C) window blocks the window step reads, with its start
    clamping."""
    _, H0, W0, _ = canvas.shape
    ar = torch.arange(w, device=canvas.device)
    iy = ys.long().clamp(0, H0 - w)[:, None] + ar
    ix = xs.long().clamp(0, W0 - w)[:, None] + ar
    return canvas[plane.long()[:, None, None], iy[:, :, None], ix[:, None, :]]
