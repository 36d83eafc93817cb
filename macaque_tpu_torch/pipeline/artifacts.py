"""Inter-stage artifact I/O (the de-facto public data API; SURVEY.md §2.4).

Formats are byte-compatible with the reference so its notebooks/analysis
tools read this framework's outputs directly:
  * ``<cam>/alldata.json`` — per frame, list of
    [track_id, x1, y1, x2, y2, [[x, y, score] x 17], assigned_id, id_score]
    (reference step1:353-362)
  * ``<cam>/frame_num.npy`` — int32 store frame numbers per row
  * ``match_keyframe.pickle`` — [{'frame', 'bcomb', 'pose3d'}] per keyframe
  * ``track.pickle`` / ``collar_id.pickle`` / ``kp2d.pickle`` /
    ``kp2d_f.pickle`` / ``kp3d.pickle`` (step3:86-89, step4:332-339)
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import numpy as np


def write_alldata(out_dir: str, results: list, frame_nums: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "alldata.json"), "w") as f:
        json.dump(results, f)
    np.save(os.path.join(out_dir, "frame_num.npy"),
            np.asarray(frame_nums, np.int32))


def read_alldata(cam_dir: str):
    with open(os.path.join(cam_dir, "alldata.json")) as f:
        data = json.load(f)
    fnums = np.load(os.path.join(cam_dir, "frame_num.npy"))
    return data, fnums


def write_pickle(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def read_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def stage_done(*paths: str) -> bool:
    """Idempotent skip-if-exists (reference step1:187, step4:91, vis:177)."""
    return all(os.path.exists(p) for p in paths)
