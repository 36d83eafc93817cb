"""Pictorial-structure inference and transitive closure on tensors.

Port of ``macaque_tpu/association/pictorial.py``. The reference ships these
as its only in-repo native kernels (Cython + OpenMP: src/m_lib/pictorial.pyx
— ``inferPict3D_MaxProd`` :109-150, ``transform_closure`` :152-185, skeleton
``getskel`` :22-51): max-product belief propagation over a 13-joint tree
and an O(N^3) boolean transitive closure.

The per-candidate loops are (C x C) tensor ops (the DP over the tree is a
short static Python loop over 12 edges), and the closure is log2(N)
boolean matrix squarings, on the device of the caller's tensors. Plain
PyTorch: the JAX package runs this as plain XLA. A C++/OpenMP parity
implementation lives in ``macaque_tpu_torch/native`` for CPU-oracle
testing.
"""

from __future__ import annotations

import numpy as np
import torch

from macaque_tpu_torch.core.device import resolve_device

# 13-joint mvpose skeleton: Nose, L/R shoulder, L/R elbow, L/R wrist,
# L/R hip, L/R knee, L/R ankle. parent[j] = parent joint of j (root -1).
PICTORIAL_PARENT = np.array([-1, 0, 0, 1, 2, 3, 4, 0, 0, 7, 8, 9, 10])

PICTORIAL_NAMES = [
    "Nose", "LSho", "RSho", "LElb", "RElb", "LWri", "RWri",
    "LHip", "RHip", "LKne", "RKne", "LAnk", "RAnk",
]

# map from the 17-keypoint COCO/macaque layout to the 13-joint tree
COCO17_TO_PICTORIAL = np.array([0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16])


def macaque_skeleton_tree() -> dict:
    """Skeleton tree in the reference's dict format (pictorial.pyx:22-51)."""
    children: list[list[int]] = [[] for _ in range(13)]
    for j, p in enumerate(PICTORIAL_PARENT):
        if p >= 0:
            children[p].append(j)
    return {
        "tree": [
            {"name": PICTORIAL_NAMES[j], "children": children[j]}
            for j in range(13)
        ]
    }


def infer_pictorial_3d(
    unary: torch.Tensor,
    candidates: torch.Tensor,
    bone_mean: torch.Tensor,
    bone_std: torch.Tensor,
) -> torch.Tensor:
    """Max-product assignment of one 3D candidate per joint, on the
    tensors' device.

    unary:      (13, C) log/score potentials per joint candidate
    candidates: (13, C, 3) candidate 3D positions
    bone_mean/bone_std: (13,) Gaussian bone-length prior per joint
      (indexed by child joint; entry 0 — the root — is unused)

    Returns (13,) int32 candidate index per joint; of equal scores the
    first wins, as ``jnp.argmax`` picks. Pairwise potential is
    ``exp(-(d - mean)^2 / (2 std^2)) / std`` (pictorial.pyx:136).
    """

    def pair_prior(j):
        p = PICTORIAL_PARENT[j]
        diff = candidates[j][:, None, :] - candidates[p][None, :, :]
        d = torch.sqrt((diff * diff).sum(-1))  # (C_child, C_parent)
        return torch.exp(-((d - bone_mean[j]) ** 2)
                         / (2 * bone_std[j] ** 2)) / bone_std[j]

    # Upward pass: children (higher index) before parents, like the
    # reference's reverse loop; each message is added into its parent's
    # unary.
    unary_acc = [unary[j] for j in range(13)]
    for j in range(12, 0, -1):
        p = PICTORIAL_PARENT[j]
        scores = pair_prior(j) + unary_acc[j][:, None]   # (C, C_parent)
        unary_acc[p] = unary_acc[p] + scores.max(dim=0).values

    picks = [None] * 13
    picks[0] = torch.argmax(unary_acc[0])
    for j in range(1, 13):
        p = PICTORIAL_PARENT[j]
        # reference backtrack (pictorial.pyx:146-150) recomputes
        # prior + accumulated unary of the child given the parent pick
        scores = pair_prior(j) + unary_acc[j][:, None]
        picks[j] = torch.argmax(scores.index_select(1, picks[p].reshape(1))[:, 0])
    return torch.stack(picks).to(torch.int32)


def transitive_closure(X: torch.Tensor) -> torch.Tensor:
    """Boolean transitive closure of (..., N, N) via iterated squaring
    (log2 N boolean matmuls instead of the reference's O(N^3) triple loop,
    pictorial.pyx:152-170), on ``X``'s device. PyTorch has no boolean
    matmul: each squaring is a float32 product of 0/1 matrices, ``> 0``,
    whose sums of at most N ones are exact for N < 2^24."""
    X = X.to(torch.bool)
    n = X.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=X.device)
    R = X | eye
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    for _ in range(steps):
        Rf = R.to(torch.float32)
        R = R | (Rf @ Rf > 0)
    return R & ~eye | X


def closure_to_clusters(X_bin: np.ndarray, device=None) -> np.ndarray:
    """Convert a binary relation matrix to a cluster/permutation matrix
    (semantics of ``transform_closure``'s second half, pictorial.pyx:171-185):
    scan representatives in index order; each unvisited row claims every
    node reachable from it. The closure runs on ``device`` (the card when
    None), the scan on the host."""
    X_bin = np.asarray(X_bin)
    X = transitive_closure(torch.as_tensor(X_bin).to(resolve_device(device))
                           ).cpu().numpy()
    N = X.shape[0]
    reach = X | np.eye(N, dtype=bool)
    vis = np.zeros(N, dtype=bool)
    out = np.zeros_like(X_bin)
    for i in range(N):
        if vis[i]:
            continue
        members = np.where(reach[i])[0]
        vis[members] = True
        out[members, i] = 1
    return out
