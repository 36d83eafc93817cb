"""Batched on-device preprocessing: normalize, keep-ratio resize + pad, UDP
pose crops, classifier crops.

The conventions of ``macaque_tpu/nn/preprocess.py``: every resample is
axis-separable bilinear interpolation written as two products with
interpolation matrices (border replication folded into the matrices):
  * detector resize: cv2 half-pixel convention, keep-ratio to 800, pad /32
    (ViTDet: keep-ratio to 1024, pad to the 1024 square);
  * pose crops: mmpose UDP warp, bbox -> center/scale with 1.25 padding
    and aspect snap;
  * ID crops: crop, resize 256x256, center-crop 224.
Images are channels-last float tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from macaque_tpu_torch.core.trace import count

MEAN_RGB = (123.675, 116.28, 103.53)
STD_RGB = (58.395, 57.12, 57.375)


def normalize_rgb(img: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB (..., 3) -> normalized float32."""
    count("host_reads.normalize", 2)    # copies that wait on a card
    mean = torch.as_tensor(MEAN_RGB, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(STD_RGB, dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) - mean) / std


def _interp_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., n) sample coordinates -> (..., n, size) bilinear weights
    max(0, 1 - |coord - index|) after clamping to [0, size-1]."""
    c = coords.clamp(0.0, size - 1.0)
    idx = torch.arange(size, dtype=c.dtype, device=c.device)
    return (1.0 - (c[..., :, None] - idx).abs()).clamp_min(0.0)


def _resample(img: torch.Tensor, Wy: torch.Tensor, Wx: torch.Tensor
              ) -> torch.Tensor:
    """img (B, H, W, C) sampled through interpolation matrices, rows first,
    then columns, in Wy's dtype. Wy (oh, H), Wx (ow, W) give (B, oh, ow,
    C); per-frame crops Wy (B, n, oh, H), Wx (B, n, ow, W) give (B, n, oh,
    ow, C) without copying a frame per crop."""
    img = img.to(Wy.dtype)
    B, H, W, C = img.shape
    flat = img.reshape(B, H, W * C)
    if Wy.dim() == 2:
        rows = (Wy @ flat).reshape(B, -1, W, C)               # (B, oh, W, C)
        return torch.einsum("jw,biwc->bijc", Wx, rows)
    n, oh = Wy.shape[1], Wy.shape[2]
    rows = (Wy.reshape(B, n * oh, H) @ flat).reshape(B, n, oh, W, C)
    return torch.einsum("bnjw,bniwc->bnijc", Wx, rows)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) half-pixel convention: (H, W, C) -> float32
    (oh, ow, C)."""
    H, W, _ = img.shape
    oh, ow = out_hw
    ar = lambda n: torch.arange(n, device=img.device, dtype=torch.float32)  # noqa: E731
    ys = (ar(oh) + 0.5) * (H / oh) - 0.5
    xs = (ar(ow) + 0.5) * (W / ow) - 0.5
    return _resample(img[None], _interp_matrix(ys, H), _interp_matrix(xs, W))[0]


def detector_input(img: torch.Tensor, target: int = 800, divisor: int = 32,
                   square: int | None = None):
    """One image: (H, W, 3) -> (padded normalized (1, Hp, Wp, 3), scale,
    (h_res, w_res)), ``detector_input_batch`` of ``img[None]``."""
    return detector_input_batch(img[None], target, divisor, square)


def detector_input_batch(imgs: torch.Tensor, target: int = 800,
                         divisor: int = 32, square: int | None = None):
    """(B, H, W, 3) -> (padded normalized (B, Hp, Wp, 3), scale,
    (h_res, w_res)); scale and padding are functions of the input shape.
    The resized image is zero-padded after normalization to a multiple of
    ``divisor``, or with ``square`` to ``square`` x ``square``
    (detectron2's ``ImageList.from_tensors(square_size=...)``, ViTDet's
    1024)."""
    B, H, W, _ = imgs.shape
    scale = min(target / H, target / W)
    h_res, w_res = int(round(H * scale)), int(round(W * scale))
    dev = imgs.device
    ys = (torch.arange(h_res, device=dev, dtype=torch.float32) + 0.5) * (H / h_res) - 0.5
    xs = (torch.arange(w_res, device=dev, dtype=torch.float32) + 0.5) * (W / w_res) - 0.5
    norm = normalize_rgb(_resample(imgs, _interp_matrix(ys, H),
                                   _interp_matrix(xs, W)))
    if square is not None:
        if max(h_res, w_res) > square:
            raise ValueError(f"detector_input: a {h_res}x{w_res} image does "
                             f"not fit a {square} square")
        Hp = Wp = square
    else:
        Hp = -(-h_res // divisor) * divisor
        Wp = -(-w_res // divisor) * divisor
    padded = torch.nn.functional.pad(norm, (0, 0, 0, Wp - w_res, 0, Hp - h_res))
    return padded, scale, (h_res, w_res)


def bbox_to_center_scale(bboxes: torch.Tensor, aspect: float = 192.0 / 256.0,
                         padding: float = 1.25):
    """xyxy (..., 4) -> (center (..., 2), scale (..., 2)) with aspect
    snapping (mmpose bbox_xyxy2cs + fix_aspect_ratio)."""
    x1, y1, x2, y2 = bboxes.unbind(-1)
    center = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], -1)
    w = (x2 - x1) * padding
    h = (y2 - y1) * padding
    wide = w > aspect * h
    w_fix = torch.where(wide, w, h * aspect)
    h_fix = torch.where(wide, w / aspect, h)
    return center, torch.stack([w_fix, h_fix], -1)


def udp_crop(imgs: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
             out_hw: Tuple[int, int] = (256, 192)) -> torch.Tensor:
    """UDP affine crops: output pixel (i, j) samples the image at
    ``center - scale/2 + (j, i) * scale / (out-1)``.

    imgs (B, H, W, 3); centers, scales (B, D, 2) -> (B, D, oh, ow, 3)."""
    oh, ow = out_hw
    B, H, W, _ = imgs.shape
    dev = imgs.device
    ar_h = torch.arange(oh, device=dev, dtype=torch.float32)
    ar_w = torch.arange(ow, device=dev, dtype=torch.float32)
    xs = (centers[..., 0:1] - scales[..., 0:1] / 2
          + ar_w * (scales[..., 0:1] / (ow - 1)))
    ys = (centers[..., 1:2] - scales[..., 1:2] / 2
          + ar_h * (scales[..., 1:2] / (oh - 1)))
    return _resample(imgs, _interp_matrix(ys, H), _interp_matrix(xs, W))


def crop_coords_to_image(kps: torch.Tensor, centers: torch.Tensor,
                         scales: torch.Tensor,
                         out_hw: Tuple[int, int] = (256, 192)) -> torch.Tensor:
    """Keypoints decoded in crop space (N, K, 2) -> image pixels."""
    oh, ow = out_hw
    count("host_reads.crop_coords")     # copies that wait on a card
    s = scales[:, None, :] / torch.as_tensor([ow - 1, oh - 1],
                                             dtype=scales.dtype,
                                             device=scales.device)
    origin = centers[:, None, :] - scales[:, None, :] / 2
    return origin + kps * s


def id_crops(imgs: torch.Tensor, bboxes: torch.Tensor, out: int = 224,
             resize_to: int = 256) -> torch.Tensor:
    """Classifier patches: crop the xyxy box, resize to 256x256, center-crop
    224. imgs (B, H, W, 3); bboxes (B, D, 4) -> (B, D, out, out, 3)."""
    B, H, W, _ = imgs.shape
    bb = bboxes.to(torch.float32)
    x1, y1, x2, y2 = bb.unbind(-1)
    w = (x2 - x1).clamp_min(1.0)[..., None]
    h = (y2 - y1).clamp_min(1.0)[..., None]
    off = (resize_to - out) / 2
    ar = torch.arange(out, device=imgs.device, dtype=torch.float32)
    xs = x1[..., None] + (off + ar + 0.5) * (w / resize_to) - 0.5
    ys = y1[..., None] + (off + ar + 0.5) * (h / resize_to) - 0.5
    return _resample(imgs, _interp_matrix(ys, H), _interp_matrix(xs, W))
