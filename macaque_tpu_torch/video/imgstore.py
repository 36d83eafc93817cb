"""Minimal imgstore-format video store reader/writer.

Port of ``macaque_tpu/video/imgstore.py``. Compatible with the 'loopbio
imgstore' directory layout the reference records with
(videos/example.<cam>/metadata.yaml: VideoImgStoreFFMPEG, chunked mp4/avi
files + per-chunk .npz index with ``frame_number`` and ``frame_time``; see
reference videos/example.22972495/metadata.yaml and notebooks/video/).
Only the subset the pipeline needs is implemented: sequential and
random-access reads plus global frame metadata.

``metadata.yaml`` is read and written by the port's own
``utils/yamlmeta.py``, never PyYAML. Chunks of format ``avi/RGBA``
(uncompressed RGBA frames) are read and written in NumPy
(``video/avi.py``); every other format goes through ``cv2``, imported by
the functions that decode or encode it. So a store of RGBA chunks reads
and writes where neither cv2 nor PyYAML is installed.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from macaque_tpu_torch.utils import yamlmeta
from macaque_tpu_torch.video.avi import RgbaAviReader, write_rgba_avi

RGBA = "RGBA"      # the fourcc whose .avi chunks are read and written in NumPy


class ImgStoreReader:
    """Reader over a store directory containing metadata.yaml and chunk
    pairs ``NNNNNN.<ext>`` + ``NNNNNN.npz``."""

    def __init__(self, path: str):
        if path.endswith("metadata.yaml"):
            path = os.path.dirname(path)
        self.filename = path
        with open(os.path.join(path, "metadata.yaml")) as f:
            meta = yamlmeta.load(f.read())
        self.metadata = meta.get("__store", meta)

        self._chunks = sorted(
            glob.glob(os.path.join(path, "[0-9]" * 6 + ".npz"))
        )
        if not self._chunks:
            raise FileNotFoundError(f"no chunk indexes in {path}")
        fnums, ftimes, chunk_of, idx_in_chunk = [], [], [], []
        for ci, npz in enumerate(self._chunks):
            d = np.load(npz)
            fn = np.asarray(d["frame_number"]).ravel()
            ft = np.asarray(d["frame_time"]).ravel()
            fnums.append(fn)
            ftimes.append(ft)
            chunk_of.append(np.full(fn.shape, ci))
            idx_in_chunk.append(np.arange(fn.shape[0]))
        self._fnums = np.concatenate(fnums)
        self._ftimes = np.concatenate(ftimes)
        self._chunk_of = np.concatenate(chunk_of)
        self._idx_in_chunk = np.concatenate(idx_in_chunk)
        self._fnum_to_row = {int(f): i for i, f in enumerate(self._fnums)}

        ext = None
        for cand in (".mp4", ".avi", ".mkv"):
            if os.path.exists(self._chunks[0].replace(".npz", cand)):
                ext = cand
                break
        self._ext = ext
        fourcc = str(self.metadata.get("format", "")).rpartition("/")[2]
        self._numpy = fourcc == RGBA and ext == ".avi"
        self._cap = None
        self._cap_chunk = -1
        self._cap_pos = -1
        self._row = -1

    # ----------------------------------------------------------- metadata

    def get_frame_metadata(self):
        return {"frame_number": self._fnums.copy(),
                "frame_time": self._ftimes.copy()}

    def __len__(self):
        return self._fnums.shape[0]

    # --------------------------------------------------------------- read

    def _open(self, ci: int, video: str):
        if self._cap is not None:
            self._cap.release()
        if self._numpy:
            self._cap = RgbaAviReader(video)
        else:
            import cv2

            self._cap = cv2.VideoCapture(video)
        self._cap_chunk = ci
        self._cap_pos = 0

    def _read_row(self, row: int) -> np.ndarray:
        ci = int(self._chunk_of[row])
        pos = int(self._idx_in_chunk[row])
        video = self._chunks[ci].replace(".npz", self._ext or ".mp4")
        if self._cap is None or self._cap_chunk != ci:
            self._open(ci, video)
        if self._numpy:
            if pos >= len(self._cap):
                raise IOError(f"failed to read frame {pos} of {video}")
            return self._cap.read(pos)
        import cv2

        if pos != self._cap_pos:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, pos)
            self._cap_pos = pos
        ok, img = self._cap.read()
        if not ok:
            raise IOError(f"failed to read frame {pos} of {video}")
        self._cap_pos = pos + 1
        return img  # BGR, like imgstore/cv2

    def get_image(self, frame_number: Optional[int] = None,
                  frame_index: Optional[int] = None
                  ) -> Tuple[np.ndarray, Tuple[int, float]]:
        if frame_number is not None:
            row = self._fnum_to_row[int(frame_number)]
        elif frame_index is not None:
            row = int(frame_index)
        else:
            raise ValueError("need frame_number or frame_index")
        self._row = row
        img = self._read_row(row)
        return img, (int(self._fnums[row]), float(self._ftimes[row]))

    def get_next_image(self):
        return self.get_image(frame_index=self._row + 1)

    def get_nearest_image(self, frame_time: float):
        """Frame whose timestamp is closest to ``frame_time`` (imgstore
        API used by the calibration/annotation tooling; reference
        mct:348,847,880)."""
        row = int(np.argmin(np.abs(self._ftimes - float(frame_time))))
        return self.get_image(frame_index=row)

    @property
    def frame_count(self) -> int:
        return len(self)

    @property
    def frame_min(self) -> int:
        return int(self._fnums[0])

    @property
    def frame_max(self) -> int:
        return int(self._fnums[-1])

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


def write_imgstore(
    path: str,
    frames: np.ndarray,
    frame_times: Optional[np.ndarray] = None,
    fps: float = 24.0,
    chunksize: int = 10000,
    frame_numbers: Optional[np.ndarray] = None,
    fourcc: str = "mp4v",
    ext: Optional[str] = None,
) -> str:
    """Write frames (N, H, W, 3) BGR uint8 as a single/multi-chunk
    imgstore (test fixture + demo-data generator).

    ``fourcc="RGBA"`` writes uncompressed ``.avi`` chunks in NumPy (no
    cv2), and refuses a chunk past 1 GiB; the JAX package's rule would
    give it ``.mp4``. Every other fourcc is encoded by cv2."""
    if ext is None:
        ext = ".avi" if fourcc in ("FFV1", "MJPG", RGBA) else ".mp4"
    if fourcc == RGBA and ext != ".avi":
        raise ValueError("RGBA chunks are written as .avi only")
    os.makedirs(path, exist_ok=True)
    N, H, W, _ = frames.shape
    if frame_numbers is None:
        frame_numbers = np.arange(N)
    if frame_times is None:
        frame_times = frame_numbers / fps

    # mp4 chunk stores carry the reference's production layout
    # (class VideoImgStoreFFMPEG, chunked NNNNNN.mp4 + NNNNNN.npz index;
    # reference videos/example.22972495/metadata.yaml:1-13); lossless
    # avi test fixtures keep the plain VideoImgStore class.
    store_class = "VideoImgStoreFFMPEG" if ext == ".mp4" else "VideoImgStore"
    meta = {
        "__store": {
            "class": store_class,
            "imgshape": [H, W, 3],
            "imgdtype": "uint8",
            "chunksize": int(chunksize),
            "format": f"{ext[1:]}/{fourcc}",
            "encoding": None,
            "version": 2,
            "framerate": float(fps),
        }
    }
    with open(os.path.join(path, "metadata.yaml"), "w") as f:
        f.write(yamlmeta.dump(meta))

    for ci in range(0, N, chunksize):
        chunk = frames[ci : ci + chunksize]
        base = os.path.join(path, f"{ci // chunksize:06d}")
        if fourcc == RGBA:
            write_rgba_avi(base + ext, chunk, fps)
        else:
            import cv2

            vw = cv2.VideoWriter(
                base + ext, cv2.VideoWriter_fourcc(*fourcc), fps, (W, H)
            )
            for fr in chunk:
                vw.write(fr)
            vw.release()
        np.savez(
            base + ".npz",
            frame_number=frame_numbers[ci : ci + chunksize],
            frame_time=frame_times[ci : ci + chunksize],
        )
    return path
