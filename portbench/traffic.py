"""The one generator of stage-1 traffic: a camera's frames, from a mix's
parameters and the seed, and the in-memory store the camera loop reads.

A mix file (``portbench/mixes/<name>.json``) gives the segment's frame
count and size, the chunk, the frame rate, the box head's foreground bias
(which sets how many detections pass the loop's threshold with random
weights) and the chunks that the output check samples. The frames are a blocky textured cage with bright blobs that
drift a few pixels a frame, plus pixel noise, drawn on the device and
brought to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

KEYS = ("segment_frames", "chunk", "fps", "frame_hw", "fg_bias", "blobs",
        "check_chunks")


def check_mix(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise KeyError(f"mix {mix.get('name')}: missing {missing}")
    return mix


def frames(mix: dict, seed: int, device) -> np.ndarray:
    """(segment_frames, H, W, 3) uint8 BGR frames for ``seed``."""
    H, W = mix["frame_hw"]
    n = mix["segment_frames"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 62) + 17)
    cell = 32
    base = torch.randint(40, 200, (-(-H // cell), -(-W // cell), 3),
                         generator=gen, device=device, dtype=torch.uint8)
    base = base.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]
    k = mix["blobs"]
    p = torch.rand(k, 6, generator=gen, device=device)
    cy, cx = (0.2 + 0.6 * p[:, 0]) * H, (0.2 + 0.6 * p[:, 1]) * W
    ry, rx = (0.08 + 0.09 * p[:, 2]) * H, (0.04 + 0.06 * p[:, 3]) * W
    vy, vx = 6 * p[:, 4] - 3, 8 * p[:, 5] - 4
    colour = torch.randint(0, 256, (k, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    for t in range(n):
        f = base.clone()
        for b in range(k):
            m = (((yy - cy[b] - vy[b] * t) / ry[b]) ** 2
                 + ((xx - cx[b] - vx[b] * t) / rx[b]) ** 2) < 1.0
            f[m] = colour[b]
        noise = torch.randint(-8, 9, (H, W, 1), generator=gen, device=device,
                              dtype=torch.int16)
        out[t] = (f.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)
    return out.cpu().numpy()


class MemoryStore:
    """In-memory stand-in for an imgstore reader: BGR uint8 frames with
    frame numbers and times, what ``process_camera`` reads."""

    def __init__(self, frames: np.ndarray, fps: float):
        self.frames = frames
        self.filename = "memory.cam0"
        self.fnums = np.arange(len(frames))
        self.ftimes = self.fnums / fps

    def get_frame_metadata(self):
        return {"frame_number": self.fnums.copy(),
                "frame_time": self.ftimes.copy()}

    def get_image(self, frame_number=None, frame_index=None):
        i = int(frame_index if frame_index is not None else frame_number)
        return self.frames[i], (int(self.fnums[i]), float(self.ftimes[i]))
