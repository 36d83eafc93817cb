"""Perception backend for stage 1: detection, top-down pose, collar ID.

``TorchPerception`` runs the three PyTorch models as whole-chunk calls
behind the three-method seam ``pipeline/step1.py`` drives (the
``PerceptionBackend`` protocol of the JAX package): frames and box tables
go to the device once per chunk and the results come back as numpy.

Each call's uploads run in the span ``perception.upload`` (their bytes
counted as ``perception.upload_bytes``), its read-back in
``perception.gather``, and the detector's input preparation in
``detector.input`` (``core/trace.py``). ``host_reads.<site>`` counts each
point where the host waits on the card: the device-to-host reads
(``gather``, one a returned tensor; ``nms``, ``roi_buckets``, ``k2_check``
in the detector) and the copies from pageable host memory, which wait on
the card's stream (``upload``; the constants of ``anchors``,
``box_coder``, ``roi_grid``, ``normalize``, ``flip``, ``blur``,
``crop_coords``).
"""

from __future__ import annotations

from typing import Protocol, Tuple

import numpy as np
import torch

from macaque_tpu_torch.core.mesh import (
    gather_shards, map_shards, put_batch_sharded, put_replicated, stage_mesh)
from macaque_tpu_torch.core.trace import count, span
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
    """Swin Mask R-CNN (or ViTDet-H) + ViTPose + ResNet-152 on one device:
    the card unless ``device`` says otherwise. ``flip_test`` (the parity
    default) averages the heatmaps of each crop and its mirror; the fast
    serving tier turns it off for a single pass.

    With ``mesh`` (``core/mesh.py``) one copy of the three models lives on
    each device of the mesh, and ``detect``, ``pose`` and ``classify`` shard
    the frame batch over it (edge-padded to a multiple of its entries),
    every shard launched before any is read back, and cut the gathered
    results to the input length: the JAX package's ``FlaxPerception`` with
    a mesh. ``device`` then defaults to the mesh's first entry. Without a
    mesh the same path runs on a mesh of one entry, ``device``."""

    def __init__(self, detector_model, pose_model, id_model, max_det: int = 8,
                 det_target: int = 800, device=None, flip_test: bool = True,
                 mesh=None):
        self.mesh, self.device = stage_mesh(mesh, device)
        self.detector_model = detector_model
        self.pose_model = pose_model
        self.id_model = id_model
        self.max_det = max_det
        # a detector that states a square input (ViTDet's 1024) takes the
        # keep-ratio resize that fits it, padded to it; else the keep-ratio
        # target (mmdet's 800; the fast tier's 640), padded to /32
        self.det_square = getattr(detector_model, "square", None)
        self.det_target = self.det_square or det_target
        self.flip_test = flip_test
        self._replicas = put_replicated(
            (detector_model, pose_model, id_model), self.mesh)

    def _run(self, fn, *arrays):
        """``fn(models, *tensors)`` sharded over the mesh and gathered;
        returns its outputs as numpy."""
        with span("perception.upload"):
            put = [put_batch_sharded(a, self.mesh) for a in arrays]
            placed = [t for shards, _ in put
                      for t in {id(t): t for t in shards}.values()]
            count("perception.upload_bytes", sum(t.nbytes for t in placed))
            # from pageable memory each copy waits on the card's stream
            count("host_reads.upload", len(placed))
        outs = map_shards(fn, self.mesh, self._replicas, *(s for s, _ in put))
        with span("perception.gather"):
            out = gather_shards(outs, put[0][1], device="cpu")
            if isinstance(out, tuple):
                count("host_reads.gather", len(out) * len(outs))
                return tuple(o.numpy() for o in out)
            count("host_reads.gather", len(outs))
            return out.numpy()

    @staticmethod
    def _frames(frames_bgr):
        return np.ascontiguousarray(frames_bgr)

    @staticmethod
    def _boxes(boxes, valid):
        return np.asarray(boxes, np.float32), np.asarray(valid, bool)

    @staticmethod
    def _rgb(frames):
        return frames.flip(-1).to(torch.float32)

    @torch.no_grad()
    def detect(self, frames_bgr):
        return self._run(self._detect, self._frames(frames_bgr))

    def _detect(self, models, frames):
        with span("detector.input"):
            padded, scale, _ = detector_input_batch(
                self._rgb(frames), target=self.det_target,
                square=self.det_square)
        boxes, scores, valid = detect_frames(models[0], padded)
        boxes = boxes / scale
        k = min(self.max_det, boxes.shape[1])
        top = torch.topk(torch.where(valid, scores, torch.full_like(
            scores, -float("inf"))), k, dim=1).indices
        b = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 4))
        s = torch.where(torch.gather(valid, 1, top), torch.gather(scores, 1, top),
                        torch.zeros_like(scores[:, :k]))
        return b, s

    @torch.no_grad()
    def pose(self, frames_bgr, boxes, valid):
        return self._run(self._pose, self._frames(frames_bgr),
                         *self._boxes(boxes, valid))

    def _pose(self, models, frames, boxes, valid):
        pose_model = models[1]
        B, D = valid.shape
        pose_hw = tuple(pose_model.cfg.img_size)             # (H, W)
        centers, scales = bbox_to_center_scale(
            boxes, aspect=pose_hw[1] / pose_hw[0])
        crops = normalize_rgb(udp_crop(self._rgb(frames), centers, scales,
                                       out_hw=pose_hw))
        crops = crops.reshape(B * D, *crops.shape[2:])
        if self.flip_test:
            # direct and mirrored crops through the network as one batch
            hm2 = pose_model(torch.cat([crops, crops.flip(2)]))
            hm = 0.5 * (hm2[:B * D] + flip_heatmaps(hm2[B * D:]))
        else:
            hm = pose_model(crops)
        kp, scores = udp_decode(hm.to(torch.float32),
                                input_size=(pose_hw[1], pose_hw[0]))
        kp_img = crop_coords_to_image(kp, centers.reshape(B * D, 2),
                                      scales.reshape(B * D, 2), out_hw=pose_hw)
        out = torch.cat([kp_img, scores[..., None]], -1).reshape(B, D, -1, 3)
        return torch.where(valid[..., None, None], out,
                           torch.full_like(out, float("nan")))

    @torch.no_grad()
    def classify(self, frames_bgr, boxes, valid):
        return self._run(self._classify, self._frames(frames_bgr),
                         *self._boxes(boxes, valid))

    def _classify(self, models, frames, boxes, valid):
        B, D = valid.shape
        crops = normalize_rgb(id_crops(self._rgb(frames), boxes))
        logits = models[2](crops.reshape(B * D, *crops.shape[2:]))
        probs = torch.softmax(logits.to(torch.float32), -1)
        scores, labels = probs.max(-1)
        labels = torch.where(valid, labels.reshape(B, D), torch.full_like(valid, -1, dtype=torch.long))
        scores = torch.where(valid, scores.reshape(B, D), torch.zeros_like(scores.reshape(B, D)))
        return labels, scores
