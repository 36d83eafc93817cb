"""Stage 2 - cross-view keyframe matching, batched on the card.

Port of ``macaque_tpu/pipeline/step2.py`` (reference
step2_crossviewmatching.py:854-959 + MultiEstimator :493-713):

  1. per-camera collar-ID voting over 2D tracklets (host, vectorized)
  2. pack every 12th frame's detections into fixed-size tensors
     (slot = camera * max_det + k)
  3. on the device: undistort all keypoints, build the ray-distance
     affinity, blend collar-ID agreement, and run SVT matching for all
     keyframes at once (keyframes are independent: the reference computes
     a temporal-continuity matrix and never uses it, step2:563-575)
  4. cluster extraction + per-camera best-combination refinement: every
     candidate combination of every keyframe triangulates in one batched
     call and is scored by reprojection RMSE (reference get_best_comb,
     step2:610-646)
  5. final 3D poses per matched person -> ``match_keyframe.pickle``

Everything on the device runs in ``dtype`` (float32 by default, as the JAX
package runs on its device; the tests pass float64).
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from macaque_tpu_torch.association.affinity import (
    combined_affinity, geometry_affinity)
from macaque_tpu_torch.association.svt import match_svt
from macaque_tpu_torch.cameras.omnidir import OmnidirCamera, omnidir_undistort
from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.core.config import CrossViewConfig
from macaque_tpu_torch.core.mesh import (
    gather_shards, make_mesh, map_shards, put_batch_sharded, put_replicated,
    stage_mesh)
from macaque_tpu_torch.pipeline.artifacts import (
    read_alldata, stage_done, write_pickle)
from macaque_tpu_torch.pipeline.geometry3d import (
    reprojection_rmse, triangulate_poses)
from macaque_tpu_torch.pipeline.idvote import collar_ids_per_camera


def pack_keyframes(
    alldata: list[list], cid2d: list[dict], keyframes: np.ndarray,
    n_cam: int, max_det: int, n_kp: int,
):
    """Pad per-keyframe detections into fixed arrays.

    Returns dict with pose (T, M, J, 3), valid (T, M), cids (T, M),
    bbox_ids (T, M) (2D track id, -1 pad), cam_idx (M,)."""
    T = len(keyframes)
    M = n_cam * max_det
    pose = np.full((T, M, n_kp, 3), np.nan)
    valid = np.zeros((T, M), bool)
    cids = np.full((T, M), -1, int)
    bids = np.full((T, M), -1, int)
    cam_idx = np.repeat(np.arange(n_cam), max_det)
    overflow = 0
    for ti, f in enumerate(keyframes):
        for cam in range(n_cam):
            dets = alldata[cam][f]
            if len(dets) > max_det:
                overflow += len(dets) - max_det
            for k, det in enumerate(dets[:max_det]):
                slot = cam * max_det + k
                pose[ti, slot] = np.asarray(det[5], float)
                valid[ti, slot] = True
                bids[ti, slot] = det[0]
                cid_arr = cid2d[cam].get(det[0])
                cids[ti, slot] = int(cid_arr[f]) if cid_arr is not None else -1
    if overflow:
        print(f"[step2] warning: {overflow} detections dropped by max_det")
    return {
        "pose": pose, "valid": valid, "cids": cids,
        "bbox_ids": bids, "cam_idx": cam_idx,
    }


def _mesh_of(cam: OmnidirCamera, mesh, cams):
    """The mesh (one entry on the camera's device when None) and the
    camera's replicas on it (``cams`` when given)."""
    if mesh is None:
        mesh = make_mesh(devices=[cam.K.device])
    return mesh, put_replicated(cam, mesh) if cams is None else cams


def _combo_rmse(cam, kp, use):
    return reprojection_rmse(cam, triangulate_poses(cam, kp), kp, use)


def _on_mesh(fn, mesh, cams, *arrays, dtype):
    """``fn(cam, *arrays)`` with the arrays' first axis sharded over the
    mesh (``cams``: the camera's replicas), gathered back on the host and
    cut to the batch. Float arrays go to ``dtype``, the others keep
    theirs."""
    put = [put_batch_sharded(a, mesh, dtype=dtype if a.dtype.kind == "f"
                             else None) for a in arrays]
    outs = map_shards(fn, mesh, cams, *(s for s, _ in put))
    return gather_shards(outs, put[0][1], device="cpu")


def batched_best_combs(candidates, combo_tensor, cam_of, cam, n_cam,
                       mesh=None, cams=None):
    """Batched get_best_comb (reference step2:610-646).

    For each ``(ti, person_slots)`` candidate, enumerate
    one-detection-per-camera combos, triangulate and reprojection-score
    all combos of all candidates in one batched call sharded over
    ``mesh`` (the camera's device when None; ``cams``, the camera's
    replicas on it, when given), and return the argmin-RMSE slot list per
    candidate. ``combo_tensor(ti, slots)`` builds the padded (n_cam, J, 3) keypoint
    array for a combo. Any number of same-camera detections per candidate
    is handled (the collision case the leftover-remnant pass must
    survive)."""
    combo_kp, combo_meta = [], []  # meta: (candidate_idx, combo)
    for ci, (ti, person) in enumerate(candidates):
        cam_groups = [
            [s for s in person if cam_of[s] == c] or [None]
            for c in range(n_cam)
        ]
        combos = list(itertools.product(*cam_groups))
        if len(combos) > 1:
            for combo in combos:
                slots = [s for s in combo if s is not None]
                combo_kp.append(combo_tensor(ti, slots))
                combo_meta.append((ci, combo))
    if combo_kp:
        kp_np = np.stack(combo_kp)
        use_np = (~np.isnan(kp_np[..., 0])).any(axis=2)       # (NC, C)
        rmse_all = _on_mesh(_combo_rmse, *_mesh_of(cam, mesh, cams), kp_np,
                            use_np, dtype=cam.K.dtype).numpy()
        rmse_all = np.where(use_np.any(axis=1), rmse_all, np.inf)
    else:
        rmse_all = np.zeros((0,))
    lookup: dict[int, list] = {}
    for gi, (ci, combo) in enumerate(combo_meta):
        lookup.setdefault(ci, []).append((gi, combo))
    out = []
    for ci, (ti, person) in enumerate(candidates):
        entries = lookup.get(ci, [])
        if not entries:  # single combo: the person IS the combo
            out.append(list(person))
        else:
            errs = [rmse_all[gi] for gi, _ in entries]
            _, combo_best = entries[int(np.argmin(errs))]
            out.append([s for s in combo_best if s is not None])
    return out


def _extract_clusters(match_mat: np.ndarray, valid: np.ndarray):
    """Reference cluster extraction (step2:597-607): columns with >= 2
    members, each row joins its argmax column's cluster."""
    mm = match_mat * (valid[:, None] & valid[None, :])
    col_sums = mm.sum(axis=0)
    cols = np.where(col_sums > 1.9)[0]
    if cols.size == 0:
        return []
    binm = mm[:, cols] > 0.9
    clusters = [[] for _ in range(cols.size)]
    for row in range(binm.shape[0]):
        if binm[row].sum() != 0:
            clusters[int(np.argmax(binm[row]))].append(row)
    return [np.asarray(c) for c in clusters]


def _affinity_program(cam, cam_idx, pose, valid, cids, alpha_id):
    """Undistort every keypoint, then the geometric affinity blended with
    collar-ID agreement: (T, M, M) on the camera's device."""
    per_det_cam = cam.__class__(*[f[cam_idx] for f in cam])
    und = omnidir_undistort(per_det_cam, pose[..., :2])
    scores = torch.nan_to_num(pose[..., 2])
    geo = geometry_affinity(cam, torch.nan_to_num(und), scores, cam_idx,
                            valid)
    return combined_affinity(geo, cids, cam_idx, alpha_id)


def affinity_and_match(cam: OmnidirCamera, packed: dict,
                       cfg: CrossViewConfig, max_det: int,
                       svt_stats: dict | None = None, lap=None, mesh=None,
                       cams=None):
    """Step 3 of the stage: the packed keyframes' affinity W (T, M, M)
    and SVT match matrices (T, M, M) uint8, gathered on the host.
    ``lap(name)``, if given, is called after each part. The keyframe axis
    is sharded over ``mesh`` (the camera's device when None; ``cams``, the
    camera's replicas on it, when given), and the SVT steps the shards in
    lockstep."""
    mesh, cams = _mesh_of(cam, mesh, cams)
    cam_idx = put_replicated(
        torch.as_tensor(packed["cam_idx"], dtype=torch.long), mesh)
    # keyframes are independent -> shard the keyframe axis over the mesh
    pose, n_kf = put_batch_sharded(packed["pose"], mesh, dtype=cam.K.dtype)
    valid, _ = put_batch_sharded(packed["valid"], mesh)
    cids, _ = put_batch_sharded(packed["cids"], mesh, dtype=torch.long)
    # alpha_id as a float32 scalar, as the JAX package passes it
    alpha = torch.tensor(cfg.alpha_id, dtype=torch.float32)
    W = map_shards(
        lambda c, ci, p, v, d: _affinity_program(c, ci, p, v, d, alpha),
        mesh, cams, cam_idx, pose, valid, cids)
    if lap:
        lap("affinity")
    same_cam = map_shards(lambda ci: ci[:, None] == ci[None, :], mesh,
                          cam_idx)
    match = match_svt(
        W, same_cam, alpha=cfg.alpha_svt, _lambda=cfg.lambda_svt,
        dual_stochastic=cfg.dual_stochastic_svt, valid=valid,
        block_size=max_det, stats=svt_stats)
    if svt_stats is not None:
        svt_stats["first_converged"] = svt_stats["first_converged"][:n_kf]
    if lap:
        lap("svt")
    return (gather_shards(W, n_kf, device="cpu"),
            gather_shards(match, n_kf, device="cpu"))


def match_persons(cam: OmnidirCamera, packed: dict, match: np.ndarray,
                  n_cam: int, n_joint: int, mesh=None, cams=None):
    """Step 4 of the stage: clusters of the match matrices, the best
    one-per-camera combination of each (and one extra pass over its
    leftovers), in reference order. Returns ``[(ti, slots)]`` and the
    host keypoint array (len, n_cam, J, 3) of each."""
    valid_np = packed["valid"]
    pose_np = packed["pose"]
    cam_of = packed["cam_idx"]

    def combo_tensor(ti, slots):
        kp = np.zeros((n_cam, n_joint, 3))
        for s in slots:
            kp[cam_of[s]] = pose_np[ti, s]
        return kp

    def best_combs(candidates):
        return batched_best_combs(candidates, combo_tensor, cam_of, cam,
                                  n_cam, mesh, cams)

    parents = []  # (ti, person_slots) in keyframe-then-cluster order
    for ti in range(match.shape[0]):
        for person in _extract_clusters(match[ti], valid_np[ti]):
            parents.append((ti, list(person)))

    parent_best = best_combs(parents)

    # leftover remnants get ONE extra best-comb pass of their own
    # (reference step2:649-656: refined.append(get_best_comb(leftover))
    # right after the parent; leftovers-of-leftovers are dropped)
    remnants, remnant_of = [], []
    for ci, ((ti, person), best) in enumerate(zip(parents, parent_best)):
        leftover = sorted(set(person) - set(best))
        if len(leftover) > 1:
            remnants.append((ti, leftover))
            remnant_of.append(ci)
    remnant_best = best_combs(remnants) if remnants else []
    extra_by_parent = dict(zip(remnant_of, remnant_best))

    # assemble in reference order (parent, then its remnant); persons with
    # < 2 views are dropped at the final stage (step2:698-700)
    finals = []  # (ti, slots)
    for ci, ((ti, _), best) in enumerate(zip(parents, parent_best)):
        if len(best) >= 2:
            finals.append((ti, best))
        extra = extra_by_parent.get(ci)
        if extra is not None and len(extra) >= 2:
            finals.append((ti, extra))
    kp = (np.stack([combo_tensor(ti, slots) for ti, slots in finals])
          if finals else np.zeros((0, n_cam, n_joint, 3)))
    return finals, kp


def bcomb_of(packed: dict, ti: int, slots, n_cam: int) -> np.ndarray:
    """A person's 2D track id in each camera (-1 where it has none)."""
    bcomb = -np.ones(n_cam, int)
    for s in slots:
        bcomb[packed["cam_idx"][s]] = packed["bbox_ids"][ti, s]
    return bcomb


def load_keyframes(result_dir: str, rig: CameraRig, cfg: CrossViewConfig,
                   max_det: int, lap=None):
    """Steps 1-2 of the stage, on the host: read every camera's
    ``alldata.json``, vote collar IDs, and pack every keyframe. Returns
    the keyframe numbers and :func:`pack_keyframes`' dict (None when
    there is no keyframe)."""
    alldata = [read_alldata(os.path.join(result_dir, str(cam_id)))[0]
               for cam_id in rig.camera_ids]
    n_frame = len(alldata[0])
    cid2d = [
        collar_ids_per_camera(alldata[c], n_frame, cfg.cid_thr,
                              cfg.id_vote_window)
        for c in range(rig.n_cam)
    ]
    if lap:
        lap("read_vote")
    keyframes = np.arange(1, n_frame - cfg.keyframe_stride,
                          cfg.keyframe_stride)
    if keyframes.size == 0:
        return keyframes, None
    return keyframes, pack_keyframes(alldata, cid2d, keyframes, rig.n_cam,
                                     max_det, cfg.n_joint)


def run_step2(
    result_dir: str,
    rig: CameraRig,
    cfg: CrossViewConfig = CrossViewConfig(),
    max_det: int = 6,
    redo: bool = False,
    mesh=None,
    device=None,
    dtype: torch.dtype = torch.float32,
    times: dict | None = None,
) -> str:
    """Stage 2 over ``result_dir``'s per-camera ``alldata.json`` files;
    writes and returns ``match_keyframe.pickle``. Runs on ``device`` (the
    card when None) in ``dtype``. ``times``, if given, receives the
    seconds of each part (read_vote, pack, affinity, svt, best_comb,
    write), the SVT's iterations and host reads, and each keyframe's
    first converged SVT iteration. ``mesh`` (``core/mesh.py``) shards the
    keyframes and the combinations over its devices, the camera
    replicated on each; the SVT stops on all shards together, so the
    pickle is the one ``mesh=None`` writes."""
    out_path = os.path.join(result_dir, "match_keyframe.pickle")
    if stage_done(out_path) and not redo:
        print(f"[step2] skip (exists): {out_path}")
        return out_path
    mesh, dev = stage_mesh(mesh, device)
    t_last = [time.perf_counter()]

    def lap(name):
        if times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            times[name] = now - t_last[0]
            t_last[0] = now

    keyframes, packed = load_keyframes(result_dir, rig, cfg, max_det, lap)
    if keyframes.size == 0:
        write_pickle(out_path, [])
        return out_path
    cam = rig.omni(dev, dtype)
    lap("pack")

    cams = put_replicated(cam, mesh)
    svt_stats = {}
    _, match = affinity_and_match(cam, packed, cfg, max_det, svt_stats, lap,
                                  mesh, cams)
    finals, kp_fin = match_persons(cam, packed, match.cpu().numpy(),
                                   rig.n_cam, cfg.n_joint, mesh, cams)
    p3d_fin = _on_mesh(triangulate_poses, mesh, cams, kp_fin,
                       dtype=dtype).numpy()
    lap("best_comb")

    per_kf: dict[int, list] = {ti: [] for ti in range(len(keyframes))}
    for (ti, slots), p3d in zip(finals, p3d_fin):
        per_kf[ti].append((bcomb_of(packed, ti, slots, rig.n_cam), p3d))

    match_keyframes = []
    for ti, f in enumerate(keyframes):
        match_keyframes.append({
            "frame": int(f),
            "bcomb": [b for b, _ in per_kf[ti]],
            "pose3d": [p for _, p in per_kf[ti]],
        })

    write_pickle(out_path, match_keyframes)
    lap("write")
    if times is not None:
        times["svt_iterations"] = svt_stats["iterations"]
        times["svt_host_reads"] = svt_stats["host_reads"]
        times["svt_first_converged"] = svt_stats["first_converged"]
    return out_path
