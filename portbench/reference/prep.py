"""Pre- and post-processing of stage 1, plain float32 PyTorch.

Frozen copies of the published conventions (mmdet / mmpose / mmpretrain
test pipelines), written against ``torch`` alone:

* detector input: cv2's half-pixel bilinear resize, keep-ratio to the
  target (800), normalized, zero-padded to a multiple of 32;
* pose crops: the UDP affine warp of mmpose (box -> center and scale with
  1.25 padding and the 192:256 aspect snap);
* ID crops: crop the box, resize to 256x256, center-crop 224;
* UDP heatmap decoding: argmax, DARK refinement (Gaussian blur of kernel
  11, log, one Newton step on the edge-padded map), the UDP scale; the
  flip test's mirror with the left/right swap of the 17 joints.

Every resample is separable bilinear interpolation written as two
products with interpolation matrices, border replication folded in.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN_RGB = (123.675, 116.28, 103.53)
STD_RGB = (58.395, 57.12, 57.375)
FLIP_PAIRS = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
              (15, 16)]


def normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN_RGB, device=img.device)
    std = torch.tensor(STD_RGB, device=img.device)
    return (img.float() - mean) / std


def _interp(coords: torch.Tensor, size: int) -> torch.Tensor:
    c = coords.clamp(0.0, size - 1.0)
    idx = torch.arange(size, dtype=c.dtype, device=c.device)
    return (1.0 - (c[..., :, None] - idx).abs()).clamp_min(0.0)


def _resample(img, Wy, Wx):
    """img (B, H, W, C) through Wy (oh, H) and Wx (ow, W), or per-crop
    (B, n, oh, H) and (B, n, ow, W)."""
    img = img.float()
    B, H, W, C = img.shape
    flat = img.reshape(B, H, W * C)
    if Wy.dim() == 2:
        rows = (Wy @ flat).reshape(B, -1, W, C)
        return torch.einsum("jw,biwc->bijc", Wx, rows)
    n, oh = Wy.shape[1], Wy.shape[2]
    rows = (Wy.reshape(B, n * oh, H) @ flat).reshape(B, n, oh, W, C)
    return torch.einsum("bnjw,bniwc->bnijc", Wx, rows)


def detector_input(rgb: torch.Tensor, target: int, divisor: int = 32):
    """(B, H, W, 3) RGB -> (padded normalized input, scale)."""
    B, H, W, _ = rgb.shape
    scale = min(target / H, target / W)
    h, w = int(round(H * scale)), int(round(W * scale))
    dev = rgb.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) * (H / h) - 0.5
    xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) * (W / w) - 0.5
    x = normalize(_resample(rgb, _interp(ys, H), _interp(xs, W)))
    Hp, Wp = -(-h // divisor) * divisor, -(-w // divisor) * divisor
    return F.pad(x, (0, 0, 0, Wp - w, 0, Hp - h)), scale


def center_scale(boxes: torch.Tensor, aspect: float, padding: float = 1.25):
    x1, y1, x2, y2 = boxes.unbind(-1)
    center = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], -1)
    w, h = (x2 - x1) * padding, (y2 - y1) * padding
    wide = w > aspect * h
    return center, torch.stack([torch.where(wide, w, h * aspect),
                                torch.where(wide, w / aspect, h)], -1)


def pose_crops(rgb, centers, scales, out_hw=(256, 192)):
    """UDP crops: (B, H, W, 3), centers and scales (B, D, 2) ->
    (B, D, oh, ow, 3) normalized."""
    oh, ow = out_hw
    B, H, W, _ = rgb.shape
    dev = rgb.device
    xs = centers[..., 0:1] - scales[..., 0:1] / 2 \
        + torch.arange(ow, device=dev, dtype=torch.float32) * (scales[..., 0:1] / (ow - 1))
    ys = centers[..., 1:2] - scales[..., 1:2] / 2 \
        + torch.arange(oh, device=dev, dtype=torch.float32) * (scales[..., 1:2] / (oh - 1))
    return normalize(_resample(rgb, _interp(ys, H), _interp(xs, W)))


def id_crops(rgb, boxes, out=224, resize_to=256):
    """(B, H, W, 3), xyxy (B, D, 4) -> (B, D, out, out, 3) normalized."""
    B, H, W, _ = rgb.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    w = (x2 - x1).clamp_min(1.0)[..., None]
    h = (y2 - y1).clamp_min(1.0)[..., None]
    off = (resize_to - out) / 2
    ar = torch.arange(out, device=rgb.device, dtype=torch.float32)
    xs = x1[..., None] + (off + ar + 0.5) * (w / resize_to) - 0.5
    ys = y1[..., None] + (off + ar + 0.5) * (h / resize_to) - 0.5
    return normalize(_resample(rgb, _interp(ys, H), _interp(xs, W)))


def flip_heatmaps(hm: torch.Tensor) -> torch.Tensor:
    """Undo a horizontal flip on (B, H, W, K) heatmaps."""
    perm = list(range(hm.shape[-1]))
    for a, b in FLIP_PAIRS:
        perm[a], perm[b] = perm[b], perm[a]
    return hm.flip(-2)[..., perm]


def _blur(hm: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(kernel) - (kernel - 1) / 2.0
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = torch.as_tensor(k / k.sum(), dtype=hm.dtype, device=hm.device)
    border = (kernel - 1) // 2
    top = hm.amax((-2, -1), keepdim=True)
    shape = hm.shape
    y = hm.reshape(-1, 1, shape[-2], shape[-1])
    y = F.conv2d(y, k.view(1, 1, 1, kernel), padding=(0, border))
    y = F.conv2d(y, k.view(1, 1, kernel, 1), padding=(border, 0)).reshape(shape)
    return y * top / y.amax((-2, -1), keepdim=True).clamp_min(1e-12)


def udp_decode(heatmaps: torch.Tensor, input_size=(192, 256)):
    """(B, H, W, K) heatmaps -> (keypoints (B, K, 2) in crop pixels,
    scores (B, K)), in the heatmaps' dtype."""
    hm = heatmaps.movedim(-1, -3)
    B, K, H, W = hm.shape
    flat = hm.reshape(B, K, -1)
    idx = flat.argmax(-1)
    vals = torch.gather(flat, -1, idx[..., None])[..., 0]
    x = (idx % W).to(hm.dtype)
    y = (idx // W).to(hm.dtype)
    logh = torch.log(_blur(hm).clamp(1e-3, 50.0))
    pad = F.pad(logh.reshape(B * K, 1, H, W), (1, 1, 1, 1),
                mode="replicate").reshape(B, K, H + 2, W + 2)
    xi, yi = idx % W + 1, idx // W + 1
    bi = torch.arange(B, device=hm.device)[:, None]
    ki = torch.arange(K, device=hm.device)[None, :]

    def at(dy, dx):
        return pad[bi, ki, yi + dy, xi + dx]

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
    inv = 1.0 / torch.where(det.abs() > 0, det, torch.ones_like(det))
    x = x - (a22 * dx - a12 * dy) * inv
    y = y - (a11 * dy - a12 * dx) * inv
    in_w, in_h = input_size
    return torch.stack([x * ((in_w - 1) / (W - 1)),
                        y * ((in_h - 1) / (H - 1))], -1), vals


def crop_to_image(kps, centers, scales, out_hw=(256, 192)):
    """Keypoints (N, K, 2) in crop pixels -> image pixels."""
    oh, ow = out_hw
    s = scales[:, None, :] / torch.tensor([ow - 1, oh - 1], dtype=scales.dtype,
                                          device=scales.device)
    return centers[:, None, :] - scales[:, None, :] / 2 + kps * s
