"""Perception backend for stage 1: detection, top-down pose, collar ID.

``TorchPerception`` runs the three PyTorch models as whole-chunk calls
behind the three-method seam ``pipeline/step1.py`` drives (the
``PerceptionBackend`` protocol of the JAX package): frames and box tables
go to the device once per chunk and the results come back as numpy.
"""

from __future__ import annotations

from typing import Protocol, Tuple

import numpy as np
import torch

from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.nn.detector import detect_frames
from macaque_tpu_torch.nn.heatmap import flip_heatmaps, udp_decode
from macaque_tpu_torch.nn.preprocess import (
    bbox_to_center_scale, crop_coords_to_image, detector_input_batch,
    id_crops, normalize_rgb, udp_crop)


class PerceptionBackend(Protocol):
    max_det: int

    def detect(self, frames_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, H, W, 3) uint8 -> boxes (B, D, 4) xyxy image coords,
        scores (B, D); empty slots score 0."""

    def pose(self, frames_bgr: np.ndarray, boxes: np.ndarray,
             valid: np.ndarray) -> np.ndarray:
        """-> keypoints (B, D, 17, 3) [x, y, score] in image coords."""

    def classify(self, frames_bgr: np.ndarray, boxes: np.ndarray,
                 valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels (B, D) int, scores (B, D))."""


class TorchPerception:
    """Swin Mask R-CNN + ViTPose + ResNet-152 on one device: the card unless
    ``device`` says otherwise. ``flip_test`` (the parity default) averages
    the heatmaps of each crop and its mirror; the fast serving tier turns it
    off for a single pass."""

    def __init__(self, detector_model, pose_model, id_model, max_det: int = 8,
                 det_target: int = 800, device=None, flip_test: bool = True):
        self.device = resolve_device(device)
        self.detector_model = detector_model
        self.pose_model = pose_model
        self.id_model = id_model
        self.max_det = max_det
        # keep-ratio resize target of the detector input (mmdet's 800; the
        # fast tier's 640)
        self.det_target = det_target
        self.flip_test = flip_test

    def _rgb(self, frames_bgr):
        frames = torch.from_numpy(np.ascontiguousarray(frames_bgr))
        return frames.to(self.device).flip(-1).to(torch.float32)

    def _boxes(self, boxes, valid):
        return (torch.as_tensor(np.asarray(boxes, np.float32), device=self.device),
                torch.as_tensor(np.asarray(valid, bool), device=self.device))

    @torch.no_grad()
    def detect(self, frames_bgr):
        padded, scale, _ = detector_input_batch(self._rgb(frames_bgr),
                                                target=self.det_target)
        boxes, scores, valid = detect_frames(self.detector_model, padded)
        boxes = boxes / scale
        k = min(self.max_det, boxes.shape[1])
        top = torch.topk(torch.where(valid, scores, torch.full_like(
            scores, -float("inf"))), k, dim=1).indices
        b = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 4))
        s = torch.where(torch.gather(valid, 1, top), torch.gather(scores, 1, top),
                        torch.zeros_like(scores[:, :k]))
        return b.cpu().numpy(), s.cpu().numpy()

    @torch.no_grad()
    def pose(self, frames_bgr, boxes, valid):
        boxes, valid = self._boxes(boxes, valid)
        B, D = valid.shape
        pose_hw = tuple(self.pose_model.cfg.img_size)        # (H, W)
        centers, scales = bbox_to_center_scale(
            boxes, aspect=pose_hw[1] / pose_hw[0])
        crops = normalize_rgb(udp_crop(self._rgb(frames_bgr), centers, scales,
                                       out_hw=pose_hw))
        crops = crops.reshape(B * D, *crops.shape[2:])
        if self.flip_test:
            # direct and mirrored crops through the network as one batch
            hm2 = self.pose_model(torch.cat([crops, crops.flip(2)]))
            hm = 0.5 * (hm2[:B * D] + flip_heatmaps(hm2[B * D:]))
        else:
            hm = self.pose_model(crops)
        kp, scores = udp_decode(hm.to(torch.float32),
                                input_size=(pose_hw[1], pose_hw[0]))
        kp_img = crop_coords_to_image(kp, centers.reshape(B * D, 2),
                                      scales.reshape(B * D, 2), out_hw=pose_hw)
        out = torch.cat([kp_img, scores[..., None]], -1).reshape(B, D, -1, 3)
        out = torch.where(valid[..., None, None], out,
                          torch.full_like(out, float("nan")))
        return out.cpu().numpy()

    @torch.no_grad()
    def classify(self, frames_bgr, boxes, valid):
        boxes, valid = self._boxes(boxes, valid)
        B, D = valid.shape
        crops = normalize_rgb(id_crops(self._rgb(frames_bgr), boxes))
        logits = self.id_model(crops.reshape(B * D, *crops.shape[2:]))
        probs = torch.softmax(logits.to(torch.float32), -1)
        scores, labels = probs.max(-1)
        labels = torch.where(valid, labels.reshape(B, D), torch.full_like(valid, -1, dtype=torch.long))
        scores = torch.where(valid, scores.reshape(B, D), torch.zeros_like(scores.reshape(B, D)))
        return labels.cpu().numpy(), scores.cpu().numpy()
