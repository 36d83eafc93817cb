"""Stage 4 — 2D Viterbi filtering + robust constrained 3D reconstruction.

Port of ``macaque_tpu/pipeline/step4.py`` (reference
step4_aniposefiltering.py:89-339), on the card unless the caller asks for
the CPU:
  * the Viterbi filter runs as one batch over every (animal, camera,
    joint) stream (filters/viterbi.py) instead of a process pool per
    joint (filter_pose.py:162-186)
  * triangulation is one batched undistort + DLT over all (animal, frame,
    joint) points (or the camera-subset RANSAC)
  * the constrained refinement is the LM-CGLS solver over every animal
    at once (geometry/refine3d.py) instead of scipy sparse TRF
Artifacts (kp2d_f.pickle, kp3d.pickle / kp3d_fxdJointLen.pickle,
joint_len.npy, config.toml, calibration.toml) keep the reference formats.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from macaque_tpu_torch.cameras.omnidir import omnidir_undistort
from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.core.config import (
    FilterConfig,
    TriangulationConfig,
    PipelineConfig,
    MACAQUE_BODYPARTS,
)
from macaque_tpu_torch.core.mesh import (
    device_guard, gather_shards, live_shards, map_shards, put_batch_sharded,
    put_replicated, stage_mesh)
from macaque_tpu_torch.filters.viterbi import viterbi_filter_joints
from macaque_tpu_torch.geometry.ransac import triangulate_ransac
from macaque_tpu_torch.geometry.refine3d import (
    refine_points_3d_batch, RefineConfig,
)
from macaque_tpu_torch.geometry.triangulate import triangulate_dlt
from macaque_tpu_torch.pipeline.artifacts import (
    read_pickle, write_pickle, stage_done)
from macaque_tpu_torch.pipeline.geometry3d import reproject_poses


def undistort_dlt(cam, flat_ca: torch.Tensor) -> torch.Tensor:
    """Raw pixels (C, N, 2), NaN = missing -> (N, 3) homogeneous-DLT
    points (the JAX package's ``_undistort_dlt``)."""
    und = omnidir_undistort(cam, flat_ca)
    undT = und.transpose(0, 1)                  # (N, C, 2)
    mask = ~torch.isnan(undT[..., 0])
    mask = mask & ~torch.isnan(flat_ca.transpose(0, 1)[..., 0])
    return triangulate_dlt(torch.nan_to_num(undT), cam.pmat, mask)


def _get_median(points: np.ndarray, ix: int) -> np.ndarray:
    pts = points[:, ix]
    pts = pts[~np.isnan(pts[:, 0])]
    return np.median(pts, axis=0)


def correct_coordinate_frame(points: np.ndarray, bodyparts, axes_spec,
                             ref_point: str):
    """Rotate/center the 3D frame from reference bodyparts (reference
    step4:43-87): first axis from a left/right pair, second orthogonalized,
    third by a right-handed cross product; origin at the reference part."""
    bp = {b: i for i, b in enumerate(bodyparts)}
    ax = dict(zip("xyz", range(3)))
    (a_dirx, a_l, a_r), (b_dirx, b_l, b_r) = axes_spec
    a_dir, b_dir = ax[a_dirx], ax[b_dirx]
    c_dir = int(np.setdiff1d([0, 1, 2], [a_dir, b_dir])[0])

    a_diff = _get_median(points, bp[a_r]) - _get_median(points, bp[a_l])
    b_raw = _get_median(points, bp[b_r]) - _get_median(points, bp[b_l])
    b_diff = b_raw - a_diff * np.dot(a_diff, b_raw) / np.dot(a_diff, a_diff)

    M = np.zeros((3, 3))
    M[a_dir] = a_diff
    M[b_dir] = b_diff
    if (a_dir, b_dir) in [(0, 1), (2, 0), (1, 2)]:
        M[c_dir] = np.cross(a_diff, b_diff)
    else:
        M[c_dir] = np.cross(b_diff, a_diff)
    M /= np.linalg.norm(M, axis=1)[:, None]

    adj = points @ M.T
    center = _get_median(adj, bp[ref_point])
    return adj - center, M, center


def _refine_sharded(refine, mesh, cams, p2d, p3d, dtype):
    """``refine(cam, p2d, p3d)`` with the animals sharded over the mesh,
    one shard after another (each LM loop reads its stop tests on the
    host), skipping the shards that hold edge padding only. Returns the
    gathered refinement and joint lengths, and the info of one batch:
    per lane iterations and sweeps, the slowest shard's LM steps and CG
    sweeps, and the sum of the host reads."""
    p2d_sh, n = put_batch_sharded(p2d, mesh, dtype=dtype)
    p3d_sh, _ = put_batch_sharded(p3d, mesh, dtype=dtype)
    outs = []
    for i in live_shards(p3d_sh, n):
        with device_guard(mesh.device_list[i]):
            outs.append(refine(cams[i], p2d_sh[i], p3d_sh[i]))
    p3, jl = gather_shards([o[:2] for o in outs], n, device="cpu")
    infos = [o[2] for o in outs]
    info = {k: gather_shards([inf[k] for inf in infos], n, device="cpu")
            for k in ("lm_iters", "cg_iters", "ftol_stop", "cost0", "cost")}
    info["lm_steps"] = max(inf["lm_steps"] for inf in infos)
    info["cg_sweeps"] = max(inf["cg_sweeps"] for inf in infos)
    info["host_reads"] = sum(inf["host_reads"] for inf in infos)
    return p3, jl, info


def run_step4(
    result_dir: str,
    rig: CameraRig,
    pipeline_cfg: Optional[PipelineConfig] = None,
    filter_cfg: FilterConfig = FilterConfig(),
    tri_cfg: TriangulationConfig = TriangulationConfig(),
    joint_len_path: Optional[str] = None,
    axes_spec=None,
    ref_point: Optional[str] = None,
    redo: bool = False,
    mesh=None,
    refine_overrides: Optional[dict] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
    times: dict | None = None,
) -> str:
    """Stage 4 over ``result_dir``'s ``kp2d.pickle``; returns the path of
    the 3D pickle. Runs on ``device`` (the card when None) in ``dtype``.
    refine_overrides: optional RefineConfig field overrides (e.g. tighter
    lm_iters/ftol for validation runs). ``times``, if given, receives the
    seconds of each part (viterbi, dlt, refine, reproject, write; configs
    and kp2d_f within write), the Viterbi's frame steps, the LM's
    iterations and CG sweeps per refined animal, and its loop's LM steps,
    CG sweeps and host reads (each once for all animals).

    ``mesh`` (``core/mesh.py``) shards the work over its devices as the
    JAX package does, the camera replicated on each: the Viterbi streams,
    the DLT's points, the refined animals and the reprojected frames.
    The refinement solves shard by shard (each lane's iterates do not
    depend on its siblings'), skipping shards of edge padding only;
    ``times`` then holds the slowest shard's LM steps and CG sweeps and
    the sum of the host reads."""
    pc = pipeline_cfg or PipelineConfig()
    fixed_mode = joint_len_path is not None and os.path.exists(joint_len_path)
    out_name = "kp3d_fxdJointLen.pickle" if fixed_mode else "kp3d.pickle"
    out_path = os.path.join(result_dir, out_name)
    if stage_done(out_path) and not redo:
        print(f"[step4] skip (exists): {out_path}")
        return out_path
    mesh, dev = stage_mesh(mesh, device)
    t_last = [time.perf_counter()]

    def lap(name):
        if times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            times[name] = times.get(name, 0.0) + now - t_last[0]
            t_last[0] = now

    # materialize anipose-compatible configs (reference step4:101-138)
    pc.to_anipose_config_toml(os.path.join(result_dir, "config.toml"))
    rig.to_calibration_toml(os.path.join(result_dir, "calibration.toml"),
                            halve_mtx=True)

    kp2d = np.asarray(read_pickle(os.path.join(result_dir, "kp2d.pickle")))
    n_animal, n_frame, n_cam, n_kp, _ = kp2d.shape
    cam = rig.omni(dev, dtype)
    cams = put_replicated(cam, mesh)

    def sharded(fn, x, axis=0, out_axis=0):
        """``fn(cam, x)`` with ``x``'s ``axis`` sharded over the mesh,
        gathered on the host along ``out_axis``."""
        shards, n = put_batch_sharded(x, mesh, axis, dtype)
        return gather_shards(map_shards(fn, mesh, cams, shards), n,
                             out_axis, device="cpu")

    lap("write")

    # ---------------- 2D Viterbi filter, one batch over (animal, cam, joint)
    print("[step4] 2D viterbi filtering...", flush=True)

    def viterbi(_, kp):
        return viterbi_filter_joints(
            kp[..., :2], kp[..., 2], filter_cfg.n_back,
            filter_cfg.offset_threshold, filter_cfg.score_threshold)

    # (animal, camera) streams are independent -> shard them over the mesh
    f_pts, f_scs = sharded(viterbi, kp2d.transpose(0, 2, 1, 3, 4).reshape(
        -1, n_frame, n_kp, 1, 3))
    f_pts = f_pts.numpy().reshape(n_animal, n_cam, n_frame, n_kp, 2)
    f_scs = f_scs.numpy().reshape(n_animal, n_cam, n_frame, n_kp)
    lap("viterbi")

    # kp2d_f in the reference layout (n_frame, n_kp, n_animal, 3, n_cam)
    kp2d_f = np.concatenate([f_pts, f_scs[..., None]], axis=-1)
    write_pickle(os.path.join(result_dir, "kp2d_f.pickle"),
                 kp2d_f.transpose(2, 3, 0, 4, 1))
    lap("write")

    # ---------------- 3D reconstruction per animal
    print("[step4] 3D reconstruction...", flush=True)
    constraints = pc.constraints()
    constraints_weak = pc.constraints_weak()
    joint_len_fixed = None
    if fixed_mode:
        jl = np.load(joint_len_path)
        joint_len_fixed = np.median(jl, axis=0)

    kp3d = np.zeros((n_animal, n_frame, n_kp, 3))
    E = np.zeros((n_animal, n_frame, n_kp))
    S = np.zeros((n_animal, n_frame, n_kp))
    joint_len_out = []

    rcfg = RefineConfig(
        scale_smooth=tri_cfg.scale_smooth,
        scale_length=tri_cfg.scale_length,
        scale_length_weak=tri_cfg.scale_length_weak,
        reproj_error_threshold=tri_cfg.reproj_error_threshold,
        n_deriv_smooth=tri_cfg.n_deriv_smooth,
    )
    if refine_overrides:
        rcfg = rcfg._replace(**refine_overrides)

    # threshold + undistort + DLT for ALL animals in one batched call
    # (semantically the reference's per-animal loop, step4:219)
    points_all = f_pts.copy()                    # (A, C, T, J, 2)
    bad_all = f_scs < tri_cfg.score_threshold
    points_all[bad_all] = np.nan
    # point axis (A*T*J) is the parallel axis here; cameras stay together
    p3d_init_all = sharded(
        (lambda c, x: triangulate_ransac(c, x)[0]) if tri_cfg.ransac
        else undistort_dlt,
        np.swapaxes(points_all, 0, 1).reshape(n_cam, -1, 2), axis=1)
    p3d_init_all = p3d_init_all.numpy().reshape(
        n_animal, n_frame, n_kp, 3)
    lap("dlt")

    do_refine = np.array([
        tri_cfg.optim and np.isfinite(p3d_init_all[a, ..., 0]).sum() >= 20
        for a in range(n_animal)
    ])
    # batch-solve ONLY the animals that refine: empty (all-NaN) lanes
    # would only cost time
    refine_pos = {a: i for i, a in enumerate(np.where(do_refine)[0])}
    info = None
    if refine_pos:
        sel = np.where(do_refine)[0]

        def refine(c, p2d, p3d):
            return refine_points_3d_batch(
                c, p2d, p3d,
                constraints=constraints, constraints_weak=constraints_weak,
                cfg=rcfg,
                joint_lengths=joint_len_fixed if fixed_mode else None,
                return_info=True,
            )

        p3d_ref_all, jl_all, info = _refine_sharded(
            refine, mesh, cams, points_all[sel], p3d_init_all[sel], dtype)
        p3d_ref_all = p3d_ref_all.numpy()
        jl_all = jl_all.numpy()
    lap("refine")

    # ONE batched reprojection for all animals
    p3d_final = np.empty((n_animal, n_frame, n_kp, 3))
    for a in range(n_animal):
        p3d_final[a] = (p3d_ref_all[refine_pos[a]] if do_refine[a]
                        else p3d_init_all[a])
    proj_all = sharded(reproject_poses, p3d_final.reshape(-1, n_kp, 3))
    proj_all = proj_all.numpy().reshape(
        n_animal, n_frame, n_cam, n_kp, 2).transpose(0, 2, 1, 3, 4)
    lap("reproject")

    for a in range(n_animal):
        points = points_all[a]
        scores = f_scs[a].copy()
        p3d = p3d_final[a]
        if do_refine[a]:
            joint_len_out.append(jl_all[refine_pos[a]])
            min_cams = 1
        else:
            min_cams = 2

        # reprojection errors + scores (reference step4:276-319)
        proj = proj_all[a]
        err = np.linalg.norm(points - proj, axis=-1)  # (C, T, J)
        good = ~np.isnan(points[..., 0])
        denom = good.sum(axis=0).astype(float)
        errs = np.where(
            denom >= 1, np.nansum(np.where(good, err, 0), axis=0)
            / np.maximum(denom, 1), np.nan
        )
        sc = scores.copy()
        sc[~good] = 2
        scores_3d = sc.min(axis=0)
        scores_3d[denom < min_cams] = np.nan
        errs[denom < min_cams] = np.nan

        if axes_spec is not None and ref_point is not None:
            p3d, _, _ = correct_coordinate_frame(
                p3d, MACAQUE_BODYPARTS, axes_spec, ref_point
            )
        kp3d[a] = p3d
        E[a] = errs
        S[a] = scores_3d

    if joint_len_out and not fixed_mode:
        np.save(os.path.join(result_dir, "joint_len.npy"),
                np.stack(joint_len_out))

    write_pickle(out_path, {
        "kp3d": kp3d, "kp3d_score": S, "kp3d_err": E,
        "joint_len": joint_len_out,
    })
    lap("write")
    if times is not None:
        times["viterbi_frame_steps"] = 2 * (n_frame - 1)  # forward + back
        times["lm_iters"] = ([] if info is None
                             else info["lm_iters"].tolist())
        times["cg_iters"] = ([] if info is None
                             else info["cg_iters"].tolist())
        for k in ("lm_steps", "cg_sweeps", "host_reads"):
            times[f"lm_{k}"] = 0 if info is None else info[k]
    return out_path
