"""Stage 1 — per-camera 2D: detect -> track -> pose -> ID -> EMA smooth.

The loop of ``macaque_tpu/pipeline/step1.py`` on the PyTorch port: frames
are processed in chunks, one batched device call per model per chunk,
with the tracker, EMA and assembly on the host between them; with
``use_device_tracker`` the chunk is tracked on the perception's device
(``tracking/device_tracker.py``) instead of by the host tracker.

Per-frame behavioral parity (thresholds, margin expansion, aspect snap,
EMA gating, output schema) follows step1:226-362.
"""

from __future__ import annotations

import os
import numpy as np
import torch

from macaque_tpu_torch.core.config import Step1Config
from macaque_tpu_torch.core.trace import record, span
from macaque_tpu_torch.pipeline.artifacts import write_alldata, stage_done
from macaque_tpu_torch.pipeline.perception import PerceptionBackend
from macaque_tpu_torch.tracking import BotSortTracker, TrackerParams
from macaque_tpu_torch.video.imgstore import ImgStoreReader
from macaque_tpu_torch.video.timegrid import make_time_grid, align_time_grid

# the camera loop's stages: the keys of process_camera's record that hold
# its own seconds
STAGES = ("decode", "detect", "track", "pose+id", "assemble")


def expand_boxes(boxes: np.ndarray, cfg: Step1Config) -> np.ndarray:
    """Dynamic margin + aspect snap (reference step1:271-285).
    boxes (N, 4) int xyxy -> (N, 4) float xyxy (expanded)."""
    out = []
    for x1, y1, x2, y2 in boxes:
        w, h = float(x2 - x1), float(y2 - y1)
        cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
        frac = np.clip((h - 50.0) / 150.0, 0.0, 1.0)
        margin = cfg.max_margin - (cfg.max_margin - cfg.min_margin) * frac
        w_new, h_new = w * (1 + margin), h * (1 + margin)
        ar = w_new / h_new
        if abs(ar - cfg.desired_ar) > 0.20:
            if ar < cfg.desired_ar:
                w_new = h_new * cfg.desired_ar
            else:
                h_new = w_new / cfg.desired_ar
        out.append([cx - w_new / 2, cy - h_new / 2,
                    cx + w_new / 2, cy + h_new / 2])
    return np.asarray(out, np.float32).reshape(-1, 4)


class EmaSmoother:
    """Per-track EMA with displacement gate (reference step1:319-342)."""

    def __init__(self, alpha: float, disp_thr: float):
        self.alpha = alpha
        self.disp_thr = disp_thr
        self.prev: dict[int, np.ndarray] = {}

    def smooth(self, tid: int, kp: np.ndarray) -> np.ndarray:
        kp = kp.copy()
        prev = self.prev.get(tid)
        if prev is not None:
            vb = ~(np.isnan(prev[:, 0]) | np.isnan(kp[:, 0]))
            disp = np.zeros(kp.shape[0])
            disp[vb] = np.linalg.norm(kp[vb, :2] - prev[vb, :2], axis=1)
            m = (disp < self.disp_thr) & vb
            kp[m, :2] = self.alpha * prev[m, :2] + (1 - self.alpha) * kp[m, :2]
        self.prev[tid] = kp
        return kp


def process_camera(
    store: ImgStoreReader,
    out_dir: str,
    T: np.ndarray,
    perception: PerceptionBackend,
    cfg: Step1Config = Step1Config(),
    chunk: int = 32,
    redo: bool = False,
    use_device_tracker: bool = False,
    prefetch: bool | None = None,
) -> dict | None:
    """Stage 1 for one camera; writes ``alldata.json`` and
    ``frame_num.npy`` into ``out_dir`` and returns the call's record
    (``core/trace.py``; None when the outputs already exist): the
    wall-clock seconds of each sub-stage under the keys of ``STAGES``,
    beside the seconds of every span and the counters of the calls they
    make (``perception.upload``, ``detector.trunk``, ``host_reads.nms``,
    ``launches.<kernel>``, ...; ``<parent>/<span>`` for a nested span).
    ``use_device_tracker`` tracks each chunk with the on-device track table
    on the perception's ``device`` (the card unless it says otherwise), in
    float64: the host tracker's precision, and the JAX package's with
    x64 on."""
    if stage_done(os.path.join(out_dir, "alldata.json"),
                  os.path.join(out_dir, "frame_num.npy")) and not redo:
        print(f"[step1] skip (exists): {out_dir}")
        return

    md = store.get_frame_metadata()
    t_cam, fnums = md["frame_time"], md["frame_number"]
    rows = align_time_grid(t_cam, T)            # grid tick -> frame row
    uniq_rows = np.unique(rows)

    tracker = BotSortTracker(TrackerParams(
        track_high_thresh=cfg.tracker.track_high_thresh,
        track_low_thresh=cfg.tracker.track_low_thresh,
        new_track_thresh=cfg.tracker.new_track_thresh,
        track_buffer=cfg.tracker.track_buffer,
        match_thresh=cfg.tracker.match_thresh,
    ))
    ema = EmaSmoother(cfg.ema_alpha, cfg.disp_thr)
    D = perception.max_det

    per_row_result: dict[int, list] = {}
    missed_detections = 0  # runtime guardrails (reference step1:230-249)
    missed_tracks = 0

    dev_table = None
    if use_device_tracker:
        from macaque_tpu_torch.tracking.device_tracker import make_table

        dev_table = make_table(cfg.tracker.max_tracks,
                               device=getattr(perception, "device", None),
                               dtype=torch.float64)

    # Decode-ahead double buffering: one background thread decodes chunk
    # N+1 while chunk N waits on the device programs, hiding the video
    # decode (the dominant host cost, ~2.1 s/480 cf measured) under
    # device time. All store reads happen on the prefetch thread, so the
    # reader sees strictly sequential access. Adaptive: on a single-core
    # host there is no parallelism to win — the extra thread only adds
    # GIL/timeslice contention (measured 2.2 -> 5.4 s/480 cf on a 1-cpu
    # VM, the BENCH_r03 step1 regression) — so default to synchronous
    # decode there; ``prefetch`` forces it either way.
    from concurrent.futures import ThreadPoolExecutor

    chunks = [uniq_rows[c0 : c0 + chunk]
              for c0 in range(0, len(uniq_rows), chunk)]

    def _decode(rows_c):
        return np.stack([store.get_image(frame_index=int(r))[0]
                         for r in rows_c])

    if prefetch is None:
        prefetch = (os.cpu_count() or 1) > 1
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None

    fut = pool.submit(_decode, chunks[0]) if (pool and chunks) else None

    def track_chunk(rows_c, boxes_all, scores_all):
        """Threshold and track each frame of the chunk: its fixed box
        tables (pose boxes, ID boxes, validity, track ids)."""
        nonlocal dev_table, missed_detections, missed_tracks
        pose_boxes = np.zeros((len(rows_c), D, 4), np.float32)
        id_boxes = np.zeros((len(rows_c), D, 4), np.float32)
        valid = np.zeros((len(rows_c), D), bool)
        tids_tbl = np.full((len(rows_c), D), -1, int)

        def place(bi, ok):
            """The frame's tracked boxes (integer xyxy, track id) into the
            chunk's fixed tables, up to D of them."""
            ok = ok[:D]
            if ok:
                n = len(ok)
                id_boxes[bi, :n] = np.asarray([b for b, _ in ok], np.float32)
                pose_boxes[bi, :n] = expand_boxes(
                    np.asarray([b for b, _ in ok]), cfg)
                valid[bi, :n] = True
                tids_tbl[bi, :n] = [t for _, t in ok]

        if use_device_tracker:
            # association for the whole chunk on the device
            from macaque_tpu_torch.tracking.device_tracker import (
                track_chunk_device)

            sc = np.where(scores_all > cfg.score_thr, scores_all, 0.0)
            dev_table, tboxes, ttids = track_chunk_device(
                dev_table, boxes_all, sc,
                high_thresh=cfg.tracker.track_high_thresh,
                low_thresh=cfg.tracker.track_low_thresh,
                new_thresh=cfg.tracker.new_track_thresh,
                match_thresh=cfg.tracker.match_thresh,
                track_buffer=cfg.tracker.track_buffer,
            )
            tboxes = tboxes.cpu().numpy()
            ttids = ttids.cpu().numpy()
            for bi in range(len(rows_c)):
                act = np.where(ttids[bi] >= 0)[0]
                if (sc[bi] > 0).sum() == 0:
                    missed_detections += 1
                elif act.size == 0:
                    missed_tracks += 1
                ok = []
                for slot in act:
                    x1, y1, x2, y2 = map(int, tboxes[bi, slot])
                    if x2 > x1 and y2 > y1:
                        ok.append(((x1, y1, x2, y2), int(ttids[bi, slot])))
                place(bi, ok)
        else:
            for bi in range(len(rows_c)):
                keep = scores_all[bi] > cfg.score_thr
                det_boxes = boxes_all[bi][keep]
                det_scores = scores_all[bi][keep]
                if det_boxes.shape[0] == 0:
                    # the reference skips the tracker entirely on frames
                    # with no above-threshold detections (step1:229-236),
                    # so lost-track aging counts detection frames only
                    missed_detections += 1
                    continue
                tb, tids = tracker.update(det_boxes, det_scores)
                if det_boxes.shape[0] > 0 and len(tids) == 0:
                    missed_tracks += 1
                ok = []
                for (x1, y1, x2, y2), tid in zip(tb, tids):
                    xi1, yi1, xi2, yi2 = map(int, (x1, y1, x2, y2))
                    if xi2 > xi1 and yi2 > yi1:
                        ok.append(((xi1, yi1, xi2, yi2), tid))
                place(bi, ok)
        return pose_boxes, id_boxes, valid, tids_tbl

    def assemble_chunk(rows_c, valid, tids_tbl, id_boxes, kps, labels,
                       lscores):
        """Per-joint threshold, EMA and the chunk's rows."""
        for bi, r in enumerate(rows_c):
            frame_json = []
            for k in range(D):
                if not valid[bi, k]:
                    continue
                kp = kps[bi, k].copy()
                low = kp[:, 2] < cfg.kp_thr
                kp[low, :2] = np.nan
                kp[low, 2] = 0.0
                kp = ema.smooth(int(tids_tbl[bi, k]), kp)
                x1, y1, x2, y2 = id_boxes[bi, k]
                lab = int(labels[bi, k])
                lsc = float(lscores[bi, k])
                assigned = lab if lsc >= cfg.id_conf_thr else -1
                frame_json.append([
                    int(tids_tbl[bi, k]),
                    float(x1), float(y1), float(x2), float(y2),
                    [[float(a), float(b), float(c)] for a, b, c in kp],
                    assigned, lsc,
                ])
            per_row_result[int(r)] = frame_json

    # sub-stage wall-clock attribution: the record's five stage spans
    # (printed in the camera summary; with prefetch on, 'decode' is only
    # the non-overlapped wait) beside the spans and counters of what they
    # call (core/trace.py)
    with record(*STAGES) as tt:
        for ci, rows_c in enumerate(chunks):
            with span("decode"):
                if pool:
                    frames = fut.result()
                    fut = (pool.submit(_decode, chunks[ci + 1])
                           if ci + 1 < len(chunks) else None)
                else:
                    frames = _decode(rows_c)

            with span("detect"):
                boxes_all, scores_all = perception.detect(frames)

            # threshold + track per frame, build fixed box tables
            with span("track"):
                pose_boxes, id_boxes, valid, tids_tbl = track_chunk(
                    rows_c, boxes_all, scores_all)

            with span("pose+id"):
                if valid.any():
                    # (B, D, J, 3)
                    kps = perception.pose(frames, pose_boxes, valid)
                    labels, lscores = perception.classify(frames, id_boxes,
                                                          valid)
                else:
                    # nothing tracked in the whole chunk (empty cage, night
                    # footage): the pose/ID programs' outputs would be
                    # fully masked, so skip the device calls — the assembly
                    # loop below reads only valid slots. Exactly equivalent
                    # by construction.
                    kps = np.full((len(rows_c), D, 17, 3), np.nan, np.float32)
                    labels = np.full((len(rows_c), D), -1, int)
                    lscores = np.zeros((len(rows_c), D), np.float32)

            # host: per-joint threshold + EMA + row assembly
            with span("assemble"):
                assemble_chunk(rows_c, valid, tids_tbl, id_boxes, kps, labels,
                               lscores)

    if pool:
        pool.shutdown(wait=False)

    # expand unique-row results back onto the time grid, then keep rows
    # whose frame number exists in the store (reference step1:364-375)
    results_all = [per_row_result.get(int(r), []) for r in rows]
    fnums_out = [int(fnums[r]) for r in rows]
    valid_set = set(int(f) for f in fnums)
    clean_res, clean_fnums = [], []
    for res, fn in zip(results_all, fnums_out):
        if fn in valid_set:
            clean_res.append(res)
            clean_fnums.append(fn)
    write_alldata(out_dir, clean_res, np.asarray(clean_fnums))
    timing = " ".join(f"{k}={tt[k]:.2f}s" for k in STAGES)
    print(
        f"[step1] wrote {len(clean_res)} frames -> {out_dir} "
        f"({missed_detections} frames without detections, "
        f"{missed_tracks} with detections but no tracks) "
        f"[prefetch={'on' if pool else 'off'} {timing}]"
    )
    return tt


def run_step1(
    data_name: str,
    results_root: str,
    raw_root: str,
    perception: PerceptionBackend,
    fps: float = 24.0,
    t_intv=None,
    cfg: Step1Config = Step1Config(),
    chunk: int = 32,
    redo: bool = False,
    use_device_tracker: bool = False,
    parallel_cameras: int = 1,
    prefetch: bool | None = None,
) -> list[str]:
    """All cameras for a recording (the JAX package's run_step1).
    Per-camera state (tracker, EMA) is fresh per camera.

    ``parallel_cameras`` > 1 runs cameras on a thread pool. Default is
    the reference's sequential loop (step1:424): measured on the
    synthetic bench the per-camera host work is GIL-heavy enough that
    4 threads ran ~3x SLOWER (7.2 vs 2.2 s/480 camera-frames); the knob
    exists for deployments where decode or device dispatch dominates.
    """
    import glob
    from concurrent.futures import ThreadPoolExecutor

    pattern = os.path.join(raw_root, f"{data_name}.*", "metadata.yaml")
    metas = sorted(glob.glob(pattern))
    if not metas:
        raise FileNotFoundError(f"no imgstore for {data_name} in {raw_root}")
    stores = [ImgStoreReader(p) for p in metas]

    T = make_time_grid(stores[0].get_frame_metadata()["frame_time"], fps,
                       t_intv)

    # (standalone CLI at module bottom mirrors reference step1:455-479)
    def one(store):
        cam = os.path.basename(store.filename).split(".")[-1]
        # a camera-specific backend may be supplied as a factory, mirroring
        # the reference's per-camera ID-model variants (step1:424-430)
        backend = perception(cam) if callable(perception) else perception
        out_dir = os.path.join(results_root, data_name, cam)
        process_camera(store, out_dir, T, backend, cfg, chunk, redo,
                       use_device_tracker=use_device_tracker,
                       prefetch=prefetch)
        return out_dir

    n_workers = max(1, min(parallel_cameras, len(stores)))
    if n_workers == 1:
        return [one(s) for s in stores]
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        return list(ex.map(one, stores))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Stage 1: per-camera 2D on the PyTorch port"
    )
    parser.add_argument("data")
    parser.add_argument("--raw_root", default="./videos")
    parser.add_argument("--res_root", default="./results2d")
    parser.add_argument("--weights", default="./model")
    parser.add_argument("--fps", type=float, default=24.0)
    parser.add_argument("--start", type=float)
    parser.add_argument("--end", type=float)
    parser.add_argument("--redo", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device of the networks and the tracker "
                             "(the card when not given; 'cpu' for the CPU)")
    args = parser.parse_args()

    interval = None
    if args.start is not None and args.end is not None:
        interval = (args.start, args.end)

    from macaque_tpu_torch.pipeline.weights import build_torch_perception

    # every camera runs on the perception's device
    run_step1(
        data_name=args.data,
        results_root=args.res_root,
        raw_root=args.raw_root,
        perception=build_torch_perception(args.weights, args.device),
        fps=args.fps,
        t_intv=interval,
        redo=args.redo,
    )
