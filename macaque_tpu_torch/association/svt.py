"""Singular-value-thresholding (SVT) assignment matching, batched.

Port of ``macaque_tpu/association/svt.py``: one iteration of SVD shrinkage
and block constraints runs over a whole batch of keyframes at once. The
JAX package's ``lax.while_loop`` is a Python loop here with the same stop
test: the batch iterates until *every* matrix has converged, or until
``max_iter``; that test is one device-to-host read an iteration.
"""

from __future__ import annotations

import torch

from macaque_tpu_torch.core.mesh import device_guard


def project_simplex(y: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each trailing-axis vector onto
    ``{x >= 0, sum x <= 1}`` (the reference's ``proj2pav``, step2:79-94):
    pass-through when the positive part already sums below 1, else the
    sorted cumulative-sum threshold rule."""
    y = torch.clamp(y, min=0.0)
    n = y.shape[-1]
    u = torch.sort(y, dim=-1, descending=True).values
    sv = torch.cumsum(u, dim=-1)
    k = torch.arange(1, n + 1, dtype=y.dtype, device=y.device)
    cond = u > (sv - 1.0) / k
    rho = torch.clamp(cond.sum(-1) - 1, min=0)  # last true index
    sv_rho = torch.take_along_dim(sv, rho[..., None], dim=-1)[..., 0]
    theta = torch.clamp((sv_rho - 1.0) / (rho + 1.0), min=0.0)
    proj = torch.clamp(y - theta[..., None], min=0.0)
    needs = y.sum(-1) >= 1.0
    return torch.where(needs[..., None], proj, y)


def proj_2dpam(Y: torch.Tensor, tol: float = 1e-2, iters: int = 10,
               denom: torch.Tensor | None = None) -> torch.Tensor:
    """Alternating row/column simplex projection toward a doubly-stochastic
    matrix (the reference's ``myproj2dpam``, step2:110-126), batched over
    leading axes, with its quirk: when ``|X2 - X| / size < tol`` the
    pre-update ``X`` is kept. ``denom`` overrides the convergence
    normalizer (the number of real entries a matrix) for zero-padded
    blocks."""
    R, C = Y.shape[-2], Y.shape[-1]
    if denom is None:
        denom = torch.tensor(float(R * C), dtype=Y.dtype, device=Y.device)

    def colproj(M):
        return project_simplex(M.transpose(-1, -2)).transpose(-1, -2)

    X, I2 = Y, torch.zeros_like(Y)
    done = torch.zeros(Y.shape[:-2], dtype=torch.bool, device=Y.device)
    for _ in range(iters):
        X1 = project_simplex(X + I2)
        I1 = X1 - (X + I2)
        X2 = colproj(X + I1)
        I2n = X2 - (X + I1)
        conv = (X2 - X).abs().sum((-1, -2)) / torch.clamp(denom, min=1.0) < tol
        keep = (done | conv)[..., None, None]
        X = torch.where(keep, X, X2)
        I2 = torch.where(done[..., None, None], I2, I2n)
        done = done | conv
    return X


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says (the JAX package asks
    for ``Precision.HIGHEST`` here)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class _SVT:
    """One SVT problem batch on one device: the iterate and its update
    (one :meth:`step` an iteration), so that several shards of a batch can
    step in lockstep."""

    def __init__(self, S, same_block, valid, alpha, _lambda, mu0, pselect,
                 dual_stochastic, block_size):
        N = S.shape[-1]
        dev, dt = S.device, S.dtype
        self.device = dev
        eye = torch.eye(N, dtype=torch.bool, device=dev)
        self.same_block = same_block.to(dev)
        if valid is None:
            self.diag_mask = eye
            self.n_eff = torch.tensor(float(N), dtype=dt, device=dev)
            self.pair_valid = torch.ones((N, N), dtype=torch.bool, device=dev)
        else:
            valid = valid.to(dev)
            self.pair_valid = valid[..., :, None] & valid[..., None, :]
            self.diag_mask = eye & self.pair_valid
            self.n_eff = torch.clamp(valid.sum(-1).to(dt), min=1.0)
        self.valid = valid
        self._lambda, self.pselect = _lambda, pselect
        self.dual_stochastic, self.block_size = dual_stochastic, block_size

        S = torch.where(eye, 0.0, S)
        S = torch.where(self.pair_valid, S, 0.0)
        S = (S + S.transpose(-1, -2)) / 2
        self.X = S
        self.Y = torch.zeros_like(S)
        self.W = alpha - S
        self.mu = torch.full(S.shape[:-2], mu0, dtype=dt, device=dev)
        self.first = torch.zeros(S.shape[:-2], dtype=torch.long, device=dev)

    def step(self, it: int, tol: float) -> torch.Tensor:
        """Iteration ``it`` (from 1); returns each matrix's convergence."""
        X, Y, W, mu = self.X, self.Y, self.W, self.mu
        same_block, diag_mask = self.same_block, self.diag_mask
        pair_valid, valid = self.pair_valid, self.valid
        N = X.shape[-1]
        dt, dev = X.dtype, X.device
        Xprev = X
        muM = mu[..., None, None]
        U, s, Vh = torch.linalg.svd(Y / muM + X, full_matrices=False)
        s_th = torch.clamp(s - self._lambda / mu[..., None], min=0.0)
        Q = _product_f32(U * s_th[..., None, :], Vh)
        X = Q - (W + Y) / muM
        X = torch.where(same_block, 0.0, X)
        if self.pselect == 1:
            X = torch.where(diag_mask, 1.0, X)
        X = torch.where(pair_valid, X, 0.0)
        X = torch.clamp(X, 0.0, 1.0)
        if self.dual_stochastic:
            # every (cam_i, cam_j) block is (block_size, block_size) in the
            # padded camera-major layout: one reshape and a batched
            # proj_2dpam; zero padding is projection-neutral, and the
            # convergence normalizer counts real entries only
            block_size = self.block_size
            nc = N // block_size
            lead = X.shape[:-2]
            Xb = X.reshape(*lead, nc, block_size, nc, block_size)
            Xb = Xb.movedim(-3, -2)                  # (..., nc, nc, bs, bs)
            if valid is None:
                denom = torch.tensor(float(block_size * block_size),
                                     dtype=dt, device=dev)
            else:
                counts = valid.reshape(*lead, nc, block_size).sum(-1).to(dt)
                denom = counts[..., :, None] * counts[..., None, :]
            Xb = proj_2dpam(Xb, tol=1e-2, denom=denom)
            X = Xb.movedim(-2, -3).reshape(*lead, N, N)
            X = torch.where(same_block, 0.0, X)
            if self.pselect == 1:
                X = torch.where(diag_mask, 1.0, X)
            X = torch.where(pair_valid, X, 0.0)
        X = (X + X.transpose(-1, -2)) / 2
        self.Y = Y + muM * (X - Q)

        dQ = torch.where(pair_valid, X - Q, 0.0)
        pRes = torch.linalg.vector_norm(dQ, dim=(-2, -1)) / self.n_eff
        dRes = mu * torch.linalg.vector_norm(X - Xprev, dim=(-2, -1)) / self.n_eff
        conv = (pRes < tol) & (dRes < tol)

        mu = torch.where(pRes > 10 * dRes, mu * 2, mu)
        self.mu = torch.where(dRes > 10 * pRes, mu / 2, mu)
        self.X = X
        self.first = torch.where((self.first == 0) & conv, it, self.first)
        return conv

    def result(self) -> torch.Tensor:
        X = (self.X + self.X.transpose(-1, -2)) / 2
        return (X > 0.5).to(torch.uint8)


def match_svt(
    S,
    same_block,
    alpha: float = 0.5,
    _lambda: float = 50.0,
    mu0: float = 64.0,
    tol: float = 5e-4,
    max_iter: int = 500,
    pselect: int = 1,
    dual_stochastic: bool = False,
    valid=None,
    block_size: int | None = None,
    stats: dict | None = None,
):
    """Solve batched SVT matching.

    S: (..., N, N) affinity matrices (a batch axis is optional).
    same_block: (N, N) bool, True inside the per-camera diagonal blocks
      (forced to zero each iteration, reference step2:169-171).
    valid: optional (..., N) detection mask for padded problems. Invalid
      rows and columns are held at zero (their diagonal too), which keeps
      the padded iteration identical to the unpadded one; residual norms
      are normalized by the valid count.
    dual_stochastic: project every (camera, camera) block toward
      doubly-stochastic (reference step2:180-186); needs ``block_size``,
      the detections a camera in the padded slot layout.
    stats: if given, receives ``iterations``, ``host_reads`` (the
      stop-test reads) and ``first_converged``, each matrix's first
      iteration that met the tolerance (0: none), where it would have
      stopped alone.

    Sharded (``core/mesh.py``): ``S``, ``same_block`` and ``valid`` may
    each be a list with one entry per mesh entry (the batch's shards and
    the replicas); every shard then steps each iteration, and the batch
    stops only when all the shards' matrices have converged, as the JAX
    package's sharded program all-reduces its stop test: one host read an
    iteration, not one a shard. ``first_converged`` then runs over the
    shards in order.

    Returns binary match matrices (..., N, N) uint8 (threshold 0.5), a
    list of them (one a shard) when sharded.
    """
    if dual_stochastic and block_size is None:
        raise ValueError(
            "dual_stochastic=True needs block_size (detections per camera "
            "in the padded slot layout)")
    sharded = isinstance(S, (list, tuple))
    parts = list(zip(S, same_block, valid if valid is not None
                     else [None] * len(S))) if sharded \
        else [(S, same_block, valid)]
    shards = []
    for s_i, b_i, v_i in parts:
        with device_guard(s_i.device):
            shards.append(_SVT(s_i, b_i, v_i, alpha, _lambda, mu0, pselect,
                               dual_stochastic, block_size))
    home = shards[0].device
    it = 0
    while it < max_iter:
        it += 1
        conv = []
        for sh in shards:
            with device_guard(sh.device):
                conv.append(sh.step(it, tol).all())
        # one read for the whole batch, all shards' stop tests together
        if bool(torch.stack([c.to(home) for c in conv]).all()):
            break
    if stats is not None:
        stats["iterations"] = it
        stats["host_reads"] = it
        stats["first_converged"] = (
            torch.cat([sh.first.cpu() for sh in shards]) if sharded
            else shards[0].first.cpu()).numpy()
    if sharded:
        return [sh.result() for sh in shards]
    return shards[0].result()
