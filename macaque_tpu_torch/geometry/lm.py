"""Matrix-free Levenberg-Marquardt with CGLS inner solves, over a batch of
independent problems.

Port of ``macaque_tpu/geometry/lm.py``, the replacement for the
reference's scipy sparse TRF solvers (aniposelib/cameras.py:926,1166).
``J^T u`` is the pullback of one ``torch.func.vjp`` per LM step, and
``J v`` the pullback of that pullback (a ``vjp`` of the linear map
``u -> J^T u``, built once per LM step): the same product as JAX's
``jvp``, but torch's forward-mode ``jvp`` costs about ten times a reverse
pass on the refinement's residual. The JAX package solves one problem
and ``vmap``s it; here one loop solves a batch of lanes, ``x`` of shape
(B, n), with per-lane dot products, the same stop tests and the same
lane freeze, so that a lane's result does not depend on its siblings. The
JAX ``while_loop``s are Python loops: one host read an LM iteration and
one a CGLS sweep (plus one ending each CGLS solve), counted in ``info``.

Why CGLS, Marquardt scaling and the gain-ratio update: see the JAX
module's docstring. The Hutchinson probes of the Marquardt scaling are
the JAX package's, drawn on the host by ``utils/threefry.py`` from
``fold_in(PRNGKey(7), it)`` as JAX draws them with ``jax_enable_x64`` on
(the mode its tests run in); JAX with x64 off draws another stream.

No product here is a ``matmul``: every dot product is an elementwise sum,
so nothing follows ``torch.backends.cuda.matmul.allow_tf32``.

On a CUDA tensor ``lm_solve`` replays each CGLS sweep and each Hutchinson
probe from a CUDA graph, captured once an LM step (the linearization
changes between steps): the same kernels on the same buffers, so the same
numbers as the eager loop, without the host's launch cost of the two
reverse passes (several hundred small kernels). The host still reads the
stop test after every sweep. The whole solve then runs on a side stream,
since the autograd engine issues a backward kernel on the stream its
forward ran on, and a capture takes only the kernels of its own stream.
On the CPU the loop runs eagerly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import vjp

from macaque_tpu_torch.utils import threefry

_PROBE_SEED = 7


class LMConfig(NamedTuple):
    lm_iters: int = 50
    cg_iters: int = 100
    ftol: float = 1e-3
    init_lambda: float = 1e-3
    # inner forcing tolerance: stop the CGLS sweep once the
    # normal-equation residual satisfies |s| < cg_rtol * |g|
    cg_rtol: float = 1e-3
    # Rademacher probes for the Hutchinson diag(J^T J) estimate
    diag_probes: int = 8


def hutchinson_probes(it: int, n_probes: int, n: int):
    """The probes of LM iteration ``it``: ``jax.random.rademacher(
    fold_in(PRNGKey(7), it), (n_probes, n))`` under x64, as float64."""
    key = threefry.fold_in(threefry.prng_key(_PROBE_SEED), it)
    return threefry.rademacher(key, (n_probes, n))


def _vdot(a, b):
    return (a * b).sum(-1)


def lm_solve(resid_fn: Callable, x0: torch.Tensor, cfg: LMConfig = LMConfig(),
             return_info: bool = False):
    """Minimize ``0.5 * |resid_fn(x)|^2`` from ``x0`` for every lane.

    ``x0`` (B, n) is a batch of independent problems and ``resid_fn`` maps
    (B, n) to (B, m) lane by lane. Returns x, or ``(x, info)`` with
    ``return_info``: per lane ``lm_iters`` / ``cg_iters`` actually
    executed, ``ftol_stop``, initial/final ``cost0`` / ``cost``; and for
    the batch ``lm_steps`` and ``cg_sweeps``, the LM steps and CG sweeps
    the loop ran (each once for all lanes), and ``host_reads``, its
    device-to-host reads. On a CUDA ``x0`` the sweeps and the probes are
    replayed from CUDA graphs.
    """
    if x0.is_cuda:
        side = torch.cuda.Stream(x0.device)
        cur = torch.cuda.current_stream(x0.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            x, info = _lm_solve_batch(resid_fn, x0, cfg, graph=True)
        cur.wait_stream(side)
        x.record_stream(cur)
    else:
        x, info = _lm_solve_batch(resid_fn, x0, cfg)
    return (x, info) if return_info else x


def _stepper(fn, state: list, graph: bool):
    """A call that advances ``state``, a list of tensors, by
    ``state[:] = fn(*state)``. With ``graph`` it replays one CUDA-graph
    capture of ``fn`` that writes the results into the state's own
    buffers (which must not alias one another)."""
    if not graph:
        def step():
            state[:] = fn(*state)
        return step

    def write():
        for buf, val in zip(state, fn(*state)):
            buf.copy_(val)

    g = torch.cuda.CUDAGraph()
    g.capture_begin()
    try:
        write()
    finally:
        g.capture_end()
    return g.replay


def _cgls(j_vec, jt_vec, r, g, lam, d, run, cfg, counts, graph=False):
    """Solve ``min_p |J p + r|^2 + lam * p^T D p`` lane by lane by CGLS in
    the scaled variable ``y = D^1/2 p`` (JAX ``cgls``). ``run`` (B,) marks
    the lanes whose LM step is live; the others' results are discarded
    and they take no sweep. Returns p and each lane's sweep count.
    ``graph``: the sweeps are replays of one captured sweep."""
    dinv = torch.rsqrt(d)
    stop2 = (cfg.cg_rtol ** 2) * _vdot(dinv * g, dinv * g)
    lam = lam[:, None]

    def more(k, gamma):
        # the per-lane while condition; a lane whose condition fails keeps
        # its state verbatim (JAX's batched while_loop selects the same)
        return run & (k < cfg.cg_iters) & (gamma > stop2)

    def sweep(y, u, s, dd, gamma, k, act):
        q = j_vec(dinv * dd)
        alpha = gamma / torch.clamp(_vdot(q, q) + lam[:, 0] * _vdot(dd, dd),
                                    min=1e-30)
        y2 = y + alpha[:, None] * dd
        u2 = u - alpha[:, None] * q
        s2 = dinv * jt_vec(u2) - lam * y2
        gamma2 = _vdot(s2, s2)
        beta = gamma2 / torch.clamp(gamma, min=1e-30)
        dd2 = s2 + beta[:, None] * dd
        a = act[:, None]
        gamma = torch.where(act, gamma2, gamma)
        k = k + act.long()
        return (torch.where(a, y2, y), torch.where(a, u2, u),
                torch.where(a, s2, s), torch.where(a, dd2, dd), gamma, k,
                more(k, gamma))

    s = dinv * (-g)          # A^T u0 - lam * y0 with y0 = 0
    gamma = _vdot(s, s)
    k = torch.zeros_like(gamma, dtype=torch.long)
    state = [torch.zeros_like(g), -r, s, s.clone(), gamma, k, more(k, gamma)]
    counts["host_reads"] += 1
    if bool(state[-1].any()):
        step = _stepper(sweep, state, graph)
        while True:
            counts["cg_sweeps"] += 1
            step()
            counts["host_reads"] += 1
            if not bool(state[-1].any()):
                break
    return dinv * state[0], state[5]


def _lm_solve_batch(resid_fn: Callable, x0: torch.Tensor, cfg: LMConfig,
                    graph: bool = False):
    B, n = x0.shape
    dev, dt = x0.device, x0.dtype
    x = x0
    lam = torch.full((B,), cfg.init_lambda, dtype=dt, device=dev)
    nu = torch.full((B,), 2.0, dtype=dt, device=dev)
    f_prev = torch.full((B,), torch.inf, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    cg_total = torch.zeros(B, dtype=torch.long, device=dev)
    f0 = torch.full((B,), torch.inf, dtype=dt, device=dev)
    counts = {"lm_steps": 0, "cg_sweeps": 0, "host_reads": 0}
    while True:
        live = (it < cfg.lm_iters) & ~done
        counts["host_reads"] += 1
        if not bool(live.any()):
            break
        r, pullback = vjp(resid_fn, x)
        f = 0.5 * _vdot(r, r)
        (g,) = pullback(r)

        def jt_vec(u, pullback=pullback):
            return pullback(u)[0]

        # J v as the transpose of the (linear) pullback
        _, transposed = vjp(jt_vec, torch.zeros_like(r))

        def j_vec(v, transposed=transposed):
            return transposed(v)[0]

        # Hutchinson: E[v * (J^T J v)] = diag(J^T J) for Rademacher v. All
        # live lanes are at this LM step, so they share its probes
        probes = torch.as_tensor(
            hutchinson_probes(counts["lm_steps"], cfg.diag_probes, n),
            dtype=dt, device=dev)
        vb = torch.empty_like(x)
        acc = [torch.zeros_like(x)]
        probe = _stepper(lambda d: (d + vb * jt_vec(j_vec(vb)),), acc, graph)
        for v in probes:
            vb.copy_(v.expand(B, n))
            probe()
        d = acc[0] / cfg.diag_probes
        d = torch.maximum(
            d, 1e-6 * d.abs().amax(-1, keepdim=True) + 1e-30)

        step, cg_k = _cgls(j_vec, jt_vec, r, g, lam, d, live, cfg, counts,
                           graph)
        x_new = x + step
        r_new = resid_fn(x_new)
        f_new = 0.5 * _vdot(r_new, r_new)

        # gain ratio: actual / predicted reduction of the GN model
        jstep = j_vec(step)
        pred = -_vdot(g, step) - 0.5 * _vdot(jstep, jstep)
        actual = f - f_new
        rho = actual / torch.clamp(pred, min=1e-30)
        accepted = (actual > 0) & (pred > 0)

        # lane freeze (JAX lm_step): done lanes keep their state; NaN or
        # zero-cost lanes latch done at once
        degenerate = torch.isnan(f) | (f <= 0.0)
        frozen = done | degenerate
        x_n = torch.where(frozen[:, None], x,
                          torch.where(accepted[:, None], x_new, x))
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_next = torch.clamp(torch.where(accepted, lam * shrink, lam * nu),
                               1e-12, 1e12)
        lam_n = torch.where(frozen, lam, lam_next)
        nu_n = torch.where(frozen, nu, torch.where(accepted, 2.0, nu * 2.0))
        done_now = accepted & (actual < cfg.ftol * f) & (rho > 0.25)
        f_out = torch.where(done, f_prev, torch.where(
            degenerate, f, torch.where(accepted, f_new, f)))
        cg_n = torch.where(frozen, cg_total, cg_total + cg_k)
        f0_n = torch.where(it == 0, f, f0)

        # the outer while condition per lane (JAX's batched while_loop)
        x = torch.where(live[:, None], x_n, x)
        lam = torch.where(live, lam_n, lam)
        nu = torch.where(live, nu_n, nu)
        f_prev = torch.where(live, f_out, f_prev)
        done = torch.where(live, frozen | done_now, done)
        cg_total = torch.where(live, cg_n, cg_total)
        f0 = torch.where(live, f0_n, f0)
        it = it + live.long()
        counts["lm_steps"] += 1
    info = {"lm_iters": it, "cg_iters": cg_total, "ftol_stop": done,
            "cost0": f0, "cost": f_prev, **counts}
    return x, info
