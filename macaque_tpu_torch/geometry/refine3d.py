"""Constrained 3D trajectory refinement as matrix-free Levenberg-Marquardt.

Port of ``macaque_tpu/geometry/refine3d.py``, the replacement for
aniposelib's ``optim_points`` / ``optim_points_jointlenfix`` (reference:
src/third_party/aniposelib/cameras.py:1116-1270), whose residual model is:

  * soft-L1-robustified reprojection residuals per (camera, frame, joint,
    coord) — ``rp * 2 * (sqrt(1 + |e| / rp) - 1)``  (cameras.py:1591-1599)
  * temporal smoothness — n-th order time differences of the 3D points
    scaled by ``scale_smooth / mean|diff(medfilt(p3d))|`` (cameras.py:1153,
    1601-1602)
  * bone-length consistency — ``100 * (len - expected) / expected`` per
    frame for strong and weak constraint sets (cameras.py:1604-1617), with
    the expected lengths free parameters (or fixed, in jointlenfix mode).

The damped steps are solved matrix-free by CGLS (geometry/lm.py). Every
function takes a leading batch of independent trajectories (one per
animal), solved in one LM loop, as the JAX package's ``vmap`` does;
``refine_points_3d_possible``, the multi-hypothesis refinement of the
aniposelib facade, solves one trajectory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from macaque_tpu_torch.cameras.dispatch import project_points
from macaque_tpu_torch.filters.smoothing import (
    interpolate_nan, median, median_filter_1d)
from macaque_tpu_torch.geometry.lm import LMConfig, lm_solve


class RefineConfig(NamedTuple):
    scale_smooth: float = 4.0
    scale_length: float = 2.0
    scale_length_weak: float = 0.5
    reproj_error_threshold: float = 15.0
    reproj_loss: str = "soft_l1"
    n_deriv_smooth: int = 1
    # production iteration budget (see the JAX package's RefineConfig)
    lm_iters: int = 30
    cg_iters: int = 60
    cg_rtol: float = 1e-3
    ftol: float = 1e-3
    # initialization guard: init points further than this (mm) from the
    # median-filtered trajectory snap to it; <= 0 disables
    init_spike_clamp: float = 100.0


def _soft_l1(e: torch.Tensor, rp: float) -> torch.Tensor:
    return rp * 2.0 * (torch.sqrt(1.0 + e / rp) - 1.0)


def _huber(e: torch.Tensor, rp: float) -> torch.Tensor:
    return torch.where(e > rp, rp * (2.0 * torch.sqrt(e / rp) - 1.0), e)


def _cons(c, device) -> torch.Tensor:
    """Constraint pairs (a list, an array or a tensor) -> (K, 2) long."""
    if torch.is_tensor(c):
        return c.to(device=device, dtype=torch.long).reshape(-1, 2)
    return torch.as_tensor(np.asarray(c, np.int64).reshape(-1, 2),
                           device=device)


def _residuals(
    p3ds: torch.Tensor,             # (..., F, J, 3)
    joint_lengths: torch.Tensor,    # (..., Kc + Kw)
    cam,
    p2ds: torch.Tensor,             # (..., C, F, J, 2)
    valid: torch.Tensor,            # (..., C, F, J, 2) bool
    constraints: torch.Tensor,      # (Kc, 2) int
    constraints_weak: torch.Tensor,  # (Kw, 2) int
    scale_smooth_full,              # (...) or scalar
    cfg: RefineConfig,
    scores: Optional[torch.Tensor] = None,
):
    """The residual vector (..., m), in the JAX package's order:
    reprojection, smoothness, strong lengths, weak lengths."""
    C, F, J = p2ds.shape[-4], p2ds.shape[-3], p2ds.shape[-2]
    lead = p3ds.shape[:-3]
    flat3d = p3ds.reshape(*lead, 1, F * J, 3)
    proj = project_points(cam, flat3d).reshape(*lead, C, F, J, 2)
    err = torch.where(valid, torch.nan_to_num(p2ds) - proj, 0.0)
    if scores is not None:
        err = err * scores[..., None]
    abs_err = torch.abs(err)
    rp = cfg.reproj_error_threshold
    if cfg.reproj_loss == "soft_l1":
        r_reproj = _soft_l1(abs_err, rp)
    elif cfg.reproj_loss == "huber":
        r_reproj = _huber(abs_err, rp)
    else:
        r_reproj = abs_err
    r_reproj = torch.where(valid, r_reproj, 0.0)

    ssf = torch.as_tensor(scale_smooth_full, dtype=p3ds.dtype,
                          device=p3ds.device)
    r_smooth = torch.diff(p3ds, n=cfg.n_deriv_smooth, dim=-3) \
        * ssf.reshape(*ssf.shape, 1, 1, 1)

    def length_res(cons, expected, scale):
        if cons.shape[0] == 0:
            return p3ds.new_zeros((*lead, 0))
        seg = p3ds[..., cons[:, 0], :] - p3ds[..., cons[:, 1], :]  # (.., F, K, 3)
        lengths = torch.linalg.vector_norm(seg + 1e-12, dim=-1)    # (.., F, K)
        e = expected[..., None, :]
        rel = 100.0 * (lengths - e) / e
        return (rel.transpose(-1, -2) * scale).reshape(*lead, -1)

    Kc = constraints.shape[0]
    r_len = length_res(constraints, joint_lengths[..., :Kc], cfg.scale_length)
    r_len_w = length_res(constraints_weak, joint_lengths[..., Kc:],
                         cfg.scale_length_weak)
    return torch.cat([r_reproj.reshape(*lead, -1),
                      r_smooth.reshape(*lead, -1), r_len, r_len_w], dim=-1)


def initialize_joint_lengths(p3ds: torch.Tensor, constraints,
                             constraints_weak) -> torch.Tensor:
    """Median segment lengths with MAD outlier clamping (reference:
    cameras.py:1670-1699). p3ds (..., F, J, 3) -> (..., Kc + Kw)."""
    constraints = _cons(constraints, p3ds.device)
    constraints_weak = _cons(constraints_weak, p3ds.device)

    def med_len(cons):
        if cons.shape[0] == 0:
            return p3ds.new_zeros((*p3ds.shape[:-3], 0))
        seg = p3ds[..., cons[:, 0], :] - p3ds[..., cons[:, 1], :]
        return median(torch.linalg.vector_norm(seg, dim=-1), dim=-2,
                      ignore_nan=True)

    all_l = torch.nan_to_num(torch.cat(
        [med_len(constraints), med_len(constraints_weak)], dim=-1))
    med = median(all_l, dim=-1)
    med = torch.where(med == 0, 1e-3, med)[..., None]
    mad = median(torch.abs(all_l - med), dim=-1)[..., None]
    return torch.where((all_l == 0) | (all_l > med + mad * 5), med, all_l)


def refine_points_3d_batch(
    cam,
    p2ds: torch.Tensor,
    p3ds_init: torch.Tensor,
    constraints=(),
    constraints_weak=(),
    cfg: RefineConfig = RefineConfig(),
    joint_lengths: Optional[torch.Tensor] = None,
    scores: Optional[torch.Tensor] = None,
    return_info: bool = False,
):
    """Refine several independent trajectories in one LM loop (the JAX
    package's ``vmap`` of :func:`refine_points_3d`; the reference's
    per-animal loop, step4:219).

    cam: camera tuple stacked over C cameras.
    p2ds: (A, C, F, J, 2) observed pixels, NaN = missing.
    p3ds_init: (A, F, J, 3) initial triangulation (NaNs allowed).
    joint_lengths: (Kc+Kw,) held fixed for every lane when given.
    scores: (A, C, F, J) weights of the reprojection errors, or None.
    Returns (p3ds (A, F, J, 3), joint_lengths (A, Kc+Kw)), plus
    :func:`lm_solve`'s info with ``return_info``.
    """
    dev = p3ds_init.device
    cons = _cons(constraints, dev)
    cons_w = _cons(constraints_weak, dev)
    A, F, J, _ = p3ds_init.shape

    # interpolate + median-filter init exactly like the reference
    # (cameras.py:1149-1154), every coordinate series at once
    flat = p3ds_init.reshape(A, F, J * 3)
    interp = interpolate_nan(flat, dim=1)
    # contiguous, so that each lane's mean below sums in one order whatever
    # the batch (a lane then gets the same iterates alone as in a batch,
    # which the mesh's shard-by-shard solve relies on)
    med = median_filter_1d(interp, 7, dim=1).contiguous()
    p3ds_intp = interp.reshape(A, F, J, 3)
    p3ds_med = med.reshape(A, F, J, 3)
    default_smooth = 1.0 / torch.abs(torch.diff(p3ds_med, dim=1)).mean(
        (1, 2, 3))
    scale_smooth_full = cfg.scale_smooth * default_smooth   # (A,)

    if cfg.init_spike_clamp > 0:
        # snap meter-scale DLT outliers to the median-filtered trajectory
        dev_ = torch.linalg.vector_norm(p3ds_intp - p3ds_med, dim=-1,
                                        keepdim=True)
        p3ds_intp = torch.where(dev_ > cfg.init_spike_clamp, p3ds_med,
                                p3ds_intp)

    jl0 = initialize_joint_lengths(p3ds_intp, cons, cons_w)
    fix_lengths = joint_lengths is not None
    n_p3d = F * J * 3
    if fix_lengths:
        fixed = torch.as_tensor(joint_lengths, dtype=p3ds_init.dtype,
                                device=dev)
        x0 = p3ds_intp.reshape(A, -1)
    else:
        x0 = torch.cat([p3ds_intp.reshape(A, -1), jl0], dim=-1)
    x0 = torch.nan_to_num(x0)
    valid = ~torch.isnan(p2ds)

    def resid_fn(x):
        p3 = x[:, :n_p3d].reshape(-1, F, J, 3)
        jl = fixed.expand(x.shape[0], -1) if fix_lengths else x[:, n_p3d:]
        return _residuals(p3, jl, cam, p2ds, valid, cons, cons_w,
                          scale_smooth_full, cfg, scores)

    x, info = lm_solve(
        resid_fn, x0,
        LMConfig(lm_iters=cfg.lm_iters, cg_iters=cfg.cg_iters,
                 cg_rtol=cfg.cg_rtol, ftol=cfg.ftol),
        return_info=True)
    p3 = x[:, :n_p3d].reshape(A, F, J, 3)
    jl = fixed.expand(A, -1) if fix_lengths else x[:, n_p3d:]
    return (p3, jl, info) if return_info else (p3, jl)


def refine_points_3d(
    cam,
    p2ds: torch.Tensor,
    p3ds_init: torch.Tensor,
    constraints=(),
    constraints_weak=(),
    cfg: RefineConfig = RefineConfig(),
    joint_lengths: Optional[torch.Tensor] = None,
    scores: Optional[torch.Tensor] = None,
    return_info: bool = False,
):
    """Refine one trajectory (reference ``optim_points`` /
    ``optim_points_jointlenfix``): :func:`refine_points_3d_batch` on a
    batch of one. p2ds (C, F, J, 2); p3ds_init (F, J, 3); scores
    (C, F, J) or None. Returns (p3ds (F, J, 3), joint_lengths (Kc+Kw,)),
    plus the LM info."""
    out = refine_points_3d_batch(
        cam, p2ds[None], p3ds_init[None], constraints, constraints_weak, cfg,
        joint_lengths, None if scores is None else scores[None],
        return_info=True)
    p3, jl, info = out
    info = {k: (v[0] if torch.is_tensor(v) else v) for k, v in info.items()}
    return (p3[0], jl[0], info) if return_info else (p3[0], jl[0])


def _smoothed_init(p3ds_init: torch.Tensor, cfg: RefineConfig):
    """(interpolated (F, J, 3), ``scale_smooth_full``) of one trajectory,
    as the reference starts its solve (cameras.py:1149-1154)."""
    F, J, _ = p3ds_init.shape
    flat = p3ds_init.reshape(F, J * 3)
    interp = interpolate_nan(flat, dim=0)
    med = median_filter_1d(interp, 7, dim=0)
    default_smooth = 1.0 / torch.abs(torch.diff(med, dim=0)).mean()
    return interp.reshape(F, J, 3), cfg.scale_smooth * default_smooth


def _lm_solve_possible(x0, n_p3d, cam, p2ds, constraints, constraints_weak,
                       scale_smooth_full, cfg: RefineConfig, beta: float,
                       scores):
    """The JAX package's ``_lm_solve_possible`` on one lane: 3D points,
    bone lengths and per-candidate mixing weights in one LM solve, its
    sweeps replayed from CUDA graphs on the card. Returns (x (n,), the
    soft-argmax weights (C, F, J, P), NaN where the option was
    missing)."""
    C, F, J, P, _ = p2ds.shape
    n_len = constraints.shape[0] + constraints_weak.shape[0]
    opt_bad = torch.isnan(p2ds[..., 0])              # (C, F, J, P)
    all_bad = opt_bad.all(-1)                        # (C, F, J)
    valid = (~all_bad)[..., None].expand(C, F, J, 2)
    p2_0 = torch.nan_to_num(p2ds)

    def weights(alphas):
        a_exp = torch.where(opt_bad, 0.0, torch.exp(beta * alphas))
        a_sum = torch.where(all_bad, 1.0, a_exp.sum(-1))
        return a_exp / a_sum[..., None]

    def resid_fn(x):
        B = x.shape[0]
        p3 = x[:, :n_p3d].reshape(B, F, J, 3)
        jl = x[:, n_p3d:n_p3d + n_len]
        # soft-argmax blend over the P candidate 2D points
        # (reference cameras.py:1646-1659)
        a_norm = weights(x[:, n_p3d + n_len:].reshape(B, C, F, J, P))
        p2_blend = (a_norm[..., None] * p2_0).sum(-2)
        r_main = _residuals(p3, jl, cam, p2_blend, valid, constraints,
                            constraints_weak, scale_smooth_full, cfg, scores)
        # keep the blend decisive: penalize low std over options
        # (reference cameras.py:1664-1666), masked where all options are
        # bad; eps inside the sqrt keeps the uniform init differentiable
        var = ((a_norm - a_norm.mean(-1, keepdim=True)) ** 2).mean(-1)
        std = torch.sqrt(var + 1e-12)
        r_alpha = torch.where(all_bad, 0.0, (1.0 - std) * 10.0)
        return torch.cat([r_main, r_alpha.reshape(B, -1)], -1)

    x = lm_solve(resid_fn, x0[None],
                 LMConfig(lm_iters=cfg.lm_iters, cg_iters=cfg.cg_iters,
                          ftol=cfg.ftol))[0]
    a_norm = weights(x[n_p3d + n_len:].reshape(C, F, J, P))
    return x, torch.where(opt_bad, torch.nan, a_norm)


def refine_points_3d_possible(
    cam,
    p2ds: torch.Tensor,
    p3ds_init: torch.Tensor,
    constraints=(),
    constraints_weak=(),
    cfg: RefineConfig = RefineConfig(),
    beta: float = 5.0,
    scores: Optional[torch.Tensor] = None,
):
    """Multi-hypothesis 3D refinement (reference ``optim_points_possible``,
    cameras.py:1417-1513): each (camera, frame, joint) observation comes
    with P candidate 2D points; per-candidate mixing weights are free
    parameters blended by a beta-softmax, optimized jointly with the 3D
    trajectory and bone lengths.

    p2ds: (C, F, J, P, 2) candidate pixels, NaN = missing option.
    p3ds_init: (F, J, 3) initial trajectory.
    Returns (p3ds (F, J, 3), alphas_norm (C, F, J, P) — the converged
    soft-argmax weights, NaN where the option was missing).
    """
    dev = p3ds_init.device
    cons = _cons(constraints, dev)
    cons_w = _cons(constraints_weak, dev)
    C, F, J, P, _ = p2ds.shape

    p3ds_intp, scale_smooth_full = _smoothed_init(p3ds_init, cfg)
    jl0 = initialize_joint_lengths(p3ds_intp, cons, cons_w)
    alphas0 = p3ds_init.new_zeros(C * F * J * P)
    x0 = torch.nan_to_num(torch.cat([p3ds_intp.reshape(-1), jl0, alphas0]))

    x, a_norm = _lm_solve_possible(x0, F * J * 3, cam, p2ds, cons, cons_w,
                                   scale_smooth_full, cfg, float(beta),
                                   scores)
    return x[: F * J * 3].reshape(F, J, 3), a_norm
