"""Stage 3 — cross-frame tracklet graph: keyframe linking, trimming,
ID voting, min-cost-flow stitching, dedup, dense 2D matrix.

Port of ``macaque_tpu/pipeline/step3.py`` (reference
step3_crossframematching.py:36-94, main_proc, and helpers). The control
flow is sequential small-graph logic and stays on the host, a copy of the
JAX package's; every 3D evaluation (tracklet traces) is batched through
:class:`TraceCalculator` on the device. The stitching's min-cost flows are
solved by the port's own successive-shortest-path solver
(:func:`min_cost_flow`), not networkx.

The reference hard-codes n_cam=8 in several helpers (step3:218,681,883) —
a quirk the JAX package fixes by threading the real camera count.
"""

from __future__ import annotations

import copy
import heapq
import os
import time
import warnings

import numpy as np
import torch

from macaque_tpu_torch.cameras.omnidir import omnidir_undistort
from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.core.config import CrossFrameConfig, VALID_COLLAR_CLASSES
from macaque_tpu_torch.core.mesh import (
    gather_shards, map_shards, put_batch_sharded, put_replicated, stage_mesh)
from macaque_tpu_torch.geometry.triangulate import triangulate_dlt_pinv
from macaque_tpu_torch.pipeline.artifacts import (
    read_alldata, read_pickle, write_pickle, stage_done,
)
from macaque_tpu_torch.tracking.hungarian import hungarian

MINDETCNT1 = 12   # reference step3:26
MINDETCNT2 = 6    # reference step3:27
CID_THR = 0.80    # reference step3:28


# --------------------------------------------------------------- 3D helper

class TraceCalculator:
    """Batched tracklet-trace triangulation on the device (replaces
    per-frame calc_3dpose/calc_3dtrace loops, reference step3:254-302):
    one omnidir undistort and pinv-DLT call a trace. ``calls`` and
    ``seconds`` count the device calls and their time."""

    def __init__(self, rig: CameraRig, n_kp: int = 17, kp_thr: float = 0.3,
                 device=None, dtype=torch.float32, mesh=None):
        # the camera replicated over the mesh, each trace sharded over it
        self.mesh, dev = stage_mesh(mesh, device)
        self.cam = rig.omni(dev, dtype)
        self.cams = put_replicated(self.cam, self.mesh)
        self.n_cam = rig.n_cam
        self.n_kp = n_kp
        self.kp_thr = kp_thr
        self.calls = 0
        self.seconds = 0.0

    def triangulate(self, kp2d: np.ndarray) -> np.ndarray:
        """(N, C, J, 3) -> (N, J, 3)."""
        n = kp2d.shape[0]
        if n == 0:
            return np.zeros((0, self.n_kp, 3))
        t = time.perf_counter()
        shards, n = put_batch_sharded(kp2d, self.mesh, dtype=self.cam.K.dtype)
        out = gather_shards(map_shards(self._tri, self.mesh, self.cams,
                                       shards), n, device="cpu").numpy()
        self.calls += 1
        self.seconds += time.perf_counter() - t
        return out

    def _tri(self, cam, kp):
        und = omnidir_undistort(cam, kp[..., :2])
        valid = (~torch.isnan(kp[..., 0])) & (kp[..., 2] >= self.kp_thr)
        undJ = torch.nan_to_num(und).transpose(-3, -2)
        validJ = valid.transpose(-2, -1)
        return triangulate_dlt_pinv(undJ, cam.pmat, validJ)

    def gather_kp2d(self, alldata, trk_rows: np.ndarray,
                    frames: np.ndarray) -> np.ndarray:
        """Collect (len(frames), C, J, 3) keypoints for a tracklet's
        per-frame box ids (NaN where absent)."""
        out = np.full((len(frames), self.n_cam, self.n_kp, 3), np.nan)
        for fi, f in enumerate(frames):
            row = trk_rows[f]
            for c in range(self.n_cam):
                if row[c] < 0:
                    continue
                for det in alldata[c][f]:
                    if det[0] == row[c]:
                        out[fi, c] = np.asarray(det[5])
                        break
        return out

    def trace(self, alldata, trk: np.ndarray, frames: np.ndarray,
              reduce: str = "median") -> np.ndarray:
        """Per-frame 3D body centre of a tracklet (reference calc_3dtrace:
        median over joints of the triangulated pose; frames with <2 boxes
        are NaN)."""
        frames = np.asarray(frames, int)
        use = np.array([np.sum(trk[f] >= 0) >= 2 for f in frames])
        kp = self.gather_kp2d(alldata, trk, frames[use])
        p3 = self.triangulate(kp)
        red = np.nanmedian if reduce == "median" else np.nanmean
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            centers = red(p3, axis=1)
        out = np.full((len(frames), 3), np.nan)
        out[use] = centers
        return out


def _intervals(Trk, min_cams=1):
    out = {}
    for k, trk in Trk.items():
        I = np.where((trk >= 0).sum(axis=1) >= min_cams)[0]
        out[k] = [int(I.min()), int(I.max())] if I.size else None
    return out


def _rmse(a: np.ndarray, b: np.ndarray) -> float:
    d = np.sum((a - b) ** 2, axis=1)
    d = d[~np.isnan(d)]
    if d.size == 0:
        return np.nan
    return float(np.sqrt(d.sum() / d.size))


# ------------------------------------------------------ keyframe connection

def connect_keyframes(alldata, match_keyframes, n_cam):
    """Hungarian-link consecutive keyframes on bbox-id overlap; split 2D
    track ids at identity inconsistencies (reference connect_keyframe,
    step3:669-837)."""
    n_kf = len(match_keyframes)
    n_frame = len(alldata[0])

    def bbox_similarity(b1, b2):
        s = np.zeros((len(b1), len(b2)))
        for i, x in enumerate(b1):
            for j, y in enumerate(b2):
                x = np.asarray(x)
                y = np.asarray(y)
                s[i, j] = np.sum((x == y) & (x >= 0) & (y >= 0))
        return s

    connections = []
    to_change: dict[int, list] = {c: [] for c in range(n_cam)}

    for i_kf in range(1, n_kf):
        f_pre = match_keyframes[i_kf - 1]["frame"]
        f_cur = match_keyframes[i_kf]["frame"]
        b_pre = match_keyframes[i_kf - 1]["bcomb"]
        b_cur = match_keyframes[i_kf]["bcomb"]
        sim = bbox_similarity(b_pre, b_cur)
        if sim.size:
            rows, cols = hungarian(-sim)
            c = [[int(r), int(cc)] for r, cc in zip(rows, cols)
                 if sim[r, cc] > 0]
        else:
            c = []
        connections.append(c)

        carr = np.asarray(c).reshape(-1, 2)
        # flag inconsistent box usage across the link
        for cam in range(n_cam):
            for p1, bb1 in enumerate(b_pre):
                if bb1[cam] < 0:
                    continue
                for p2, bb2 in enumerate(b_cur):
                    if bb2[cam] < 0:
                        continue
                    I1 = np.where(carr[:, 0] == p1)[0]
                    I2 = np.where(carr[:, 1] == p2)[0]
                    if I1.size and I2.size:
                        if I1[0] == I2[0]:
                            if bb1[cam] != bb2[cam]:
                                to_change[cam].append([int(bb1[cam]), f_pre, f_cur])
                                to_change[cam].append([int(bb2[cam]), f_pre, f_cur])
                        elif bb1[cam] == bb2[cam]:
                            to_change[cam].append([int(bb1[cam]), f_pre, f_cur])

    # renumber inconsistent 2D tracks past each inconsistency
    last_id = max(
        (det[0] for cam_data in alldata for fr in cam_data for det in fr),
        default=-1,
    ) + 1
    alldata2 = copy.deepcopy(alldata)
    kfs2 = copy.deepcopy(match_keyframes)
    for cam in range(n_cam):
        bc = np.unique(np.asarray(to_change[cam]).reshape(-1, 3), axis=0)
        for box in np.unique(bc[:, 0]) if bc.size else []:
            spans = bc[bc[:, 0] == box, 1:3]
            ids_T = np.full(n_frame, box, int)
            ids_kf = np.full(n_frame, box, int)
            for f0, f1 in spans:
                ids_kf[f0 + 1 : f1] = -1
                ids_kf[f1:] = last_id
                ids_T[f0 + 1 : f1] = -10
                ids_T[f1:] = last_id
                last_id += 1
            for f in range(n_frame):
                for det in alldata2[cam][f]:
                    if det[0] == box:
                        det[0] = int(ids_T[f])
            for kf in kfs2:
                for bb in kf["bcomb"]:
                    if bb[cam] == box:
                        bb[cam] = int(ids_kf[kf["frame"]])
    return alldata2, kfs2, connections


def build_tracklets(alldata, match_keyframes, connections, n_cam):
    """Chain keyframe persons into Trk[pid] = int[n_frame, n_cam]
    (reference get_tracklets merge loop, step3:1192-1259)."""
    n_frame_kf = match_keyframes[-1]["frame"]
    cur_ids = np.arange(len(match_keyframes[0]["bcomb"]), dtype=int)
    cnt = int(cur_ids.max()) + 1 if cur_ids.size else 0

    Trk: dict[int, np.ndarray] = {}
    for i_kf in range(1, len(match_keyframes)):
        f_pre = match_keyframes[i_kf - 1]["frame"]
        f_cur = match_keyframes[i_kf]["frame"]
        pre_ids = cur_ids.copy()
        c = connections[i_kf - 1]

        for i_box, pid in enumerate(pre_ids):
            if pid not in Trk:
                Trk[pid] = -np.ones((n_frame_kf, n_cam), int)
            for cc in c:
                if i_box == cc[0]:
                    bpre = np.asarray(
                        match_keyframes[i_kf - 1]["bcomb"][cc[0]]
                    )
                    bcur = np.asarray(match_keyframes[i_kf]["bcomb"][cc[1]])
                    a1 = bpre >= 0
                    a2 = bcur >= 0
                    consistent = ~(a1 & a2 & (bpre != bcur))
                    a1 = a1 & consistent
                    a2 = a2 & consistent
                    use = -np.ones(n_cam, int)
                    use[a2] = bcur[a2]
                    use[a1] = bpre[a1]  # previous keyframe wins
                    Trk[pid][f_pre:f_cur, :] = use

        cur_ids = -np.ones(len(match_keyframes[i_kf]["bcomb"]), int)
        for cc in c:
            cur_ids[cc[1]] = pre_ids[cc[0]]
        for i in range(len(cur_ids)):
            if cur_ids[i] < 0:
                cur_ids[i] = cnt
                cnt += 1

    for k in [k for k, v in Trk.items() if not (v >= 0).any()]:
        Trk.pop(k)
    return Trk, n_frame_kf


# -------------------------------------------------------------- trimming

def trim_tracklets(Trk, alldata, n_frame, tc: TraceCalculator,
                   rmse_thr=150.0):
    """Resolve short overlaps between staggered tracklets of the same
    animal (3D trace RMSE < 150mm) by trimming the shorter one
    (reference step3:1504-1568)."""
    Intv = _intervals(Trk)
    K = sorted(Trk.keys(), key=lambda k: Intv[k][1] - Intv[k][0])
    Trk2 = {k: v.copy() for k, v in Trk.items()}

    for k1 in K:
        for k2 in K:
            if k1 == k2:
                continue
            i1, i2 = Intv[k1], Intv[k2]
            lo = max(i1[0], i2[0])
            hi = min(i1[1], i2[1])
            n_overlap = max(0, hi - lo + 1)
            if n_overlap == 0:
                continue
            len1 = i1[1] - i1[0] + 1
            len2 = i2[1] - i2[0] + 1
            if n_overlap > len1 / 3 or n_overlap > len2 / 3 or n_overlap > 12:
                continue
            case_a = i1[0] > i2[0] and i1[1] > i2[1]
            case_b = i2[0] > i1[0] and i2[1] > i1[1]
            if not case_a and not case_b:
                continue
            frames = np.arange(lo, hi + 1)
            t1 = tc.trace(alldata, Trk2[k1], frames)
            t2 = tc.trace(alldata, Trk2[k2], frames)
            if _rmse(t1, t2) < rmse_thr:
                if case_a:
                    Intv[k1][0] = i2[1] + 1
                    Trk2[k1][: i2[1] + 1, :] = -1
                else:
                    Intv[k1][1] = i2[0] - 1
                    Trk2[k1][i2[0] :, :] = -1
    return Trk2


# ------------------------------------------------------------- ID voting

def count_id_detections(alldata, Trk, n_frame, n_cam):
    """Per-tracklet per-frame collar-class detection counts
    (reference step3:839-870)."""
    Trk_cid = {}
    for k, trk in Trk.items():
        I = np.where((trk >= 0).sum(axis=1) > 0)[0]
        lo, hi = int(I.min()), int(I.max())
        counts = np.zeros((n_frame, 6), int)
        for cam in range(n_cam):
            for f in range(lo, hi + 1):
                bid = trk[f, cam]
                if bid < 0:
                    continue
                for det in alldata[cam][f]:
                    if det[0] == bid and det[7] > CID_THR:
                        counts[f, int(det[6])] += 1
        Trk_cid[k] = counts[:, list(VALID_COLLAR_CLASSES)]
    return Trk_cid


def _window_counts(cid0, wsize, f):
    lo = f - wsize // 2
    hi = f + wsize // 2
    return cid0[max(lo, 0) : hi].sum(axis=0) if lo >= 0 else cid0[:hi].sum(axis=0)


def set_tracklet_ids(Trk, Trk_cid, n_frame, wsize):
    """Windowed vote with midpoint split (reference step3:1344-1444)."""
    Intv = _intervals(Trk)
    Cid = {}
    half = wsize // 2
    for k, cid0 in Trk_cid.items():
        lo, hi = Intv[k]
        cid1 = -np.ones(n_frame, int)

        cs = np.vstack([np.zeros((1, cid0.shape[1]), int),
                        np.cumsum(cid0, axis=0)])
        for f in range(max(lo, half), min(hi, n_frame - half)):
            cnt = cs[f + half] - cs[max(f - half, 0)]
            tot = cnt.sum()
            if tot and cnt.max() / tot > 0.8 and cnt.max() >= MINDETCNT1:
                cid1[f] = int(np.argmax(cnt))

        cid2 = -np.ones(n_frame, int)
        uid = np.unique(cid1[lo:hi])
        uid = uid[uid >= 0]
        if uid.size == 0:
            cnt = cid0.sum(axis=0)
            if cnt.sum() and cnt.max() / cnt.sum() > 0.8 \
                    and cnt.max() >= MINDETCNT1:
                cid2[:] = int(np.argmax(cnt))
        elif uid.size == 1:
            cid2[:] = int(uid[0])
        else:
            pre_id, pre_frame = -1, 0
            for f in range(n_frame):
                cur = cid1[f]
                if cur >= 0:
                    if cur != pre_id:
                        if pre_id == -1:
                            cid2[:f] = cur
                        elif f - pre_frame > 1:
                            w1 = np.where(cid0[:, pre_id] > 0)[0]
                            w1 = w1[(w1 >= max(1, pre_frame - half)) & (w1 <= f)]
                            ip = int(w1.max()) if w1.size else pre_frame
                            w2 = np.where(cid0[:, cur] > 0)[0]
                            w2 = w2[(w2 >= pre_frame) & (w2 <= min(f + half, n_frame))]
                            ic = int(w2.min()) if w2.size else f
                            mid = (ic - ip) // 2 + ip if ip < ic \
                                else (f - pre_frame) // 2 + pre_frame
                            cid2[pre_frame:mid] = pre_id
                            cid2[mid:f] = cur
                    else:
                        cid2[pre_frame:f] = cur
                    pre_id, pre_frame = cur, f
            cid2[pre_frame:] = pre_id
        Cid[k] = cid2
    return Cid


def split_multi_id_tracklets(Trk, Cid, stitch_info=None, n_cam=8):
    """Split tracklets whose frames carry several identities
    (reference div_3dtracklet, step3:917-983)."""
    Intv = _intervals(Trk)
    assigned = [k for k in Trk if (Cid[k] >= 0).any()]
    last = max(Trk.keys())
    for k in assigned:
        lo, hi = Intv[k]
        ids = np.unique(Cid[k][lo:hi])
        if ids.size <= 1:
            continue
        n_frame = Cid[k].shape[0]
        for cid in ids:
            mask = np.zeros(n_frame, bool)
            mask[lo:hi] = True
            runs = _to_intervals((Cid[k] == cid) & mask)
            for r0, r1 in runs:
                C = -np.ones(n_frame, int)
                C[r0 : r1 + 1] = cid
                trk = -np.ones((n_frame, n_cam), int)
                trk[r0 : r1 + 1] = Trk[k][r0 : r1 + 1]
                last += 1
                Cid[last] = C
                Trk[last] = trk
                if stitch_info is not None and k in stitch_info:
                    keep = [
                        f for f in stitch_info[k]
                        if min(r1, f[1]) - max(r0, f[0]) >= 0
                    ]
                    stitch_info[last] = keep
        Trk.pop(k)
        Cid.pop(k)
    if stitch_info is None:
        return Trk, Cid
    return Trk, Cid, stitch_info


def _to_intervals(mask: np.ndarray) -> np.ndarray:
    m = np.asarray(mask, int)
    if m.size and m[-1] == 1:
        m = np.append(m, 0)
    d = np.diff(np.append([0], m))
    start = np.where(d == 1)[0]
    stop = np.where(d == -1)[0] - 1
    return np.stack([start, stop], axis=1) if start.size else np.zeros((0, 2), int)


def remove_single_cam_tracklets(Trk):
    for k in [k for k, v in Trk.items()
              if not ((v >= 0).sum(axis=1) > 1).any()]:
        Trk.pop(k)
    return Trk


def remove_short_tracklets(Trk, Cid, min_frames=0):
    k_del = []
    for k, v in Trk.items():
        if not (Cid[k] >= 0).any():
            I = np.where((v >= 0).sum(axis=1) > 0)[0]
            if I.max() - I.min() <= min_frames:
                k_del.append(k)
    for k in k_del:
        Trk.pop(k)
    return Trk


# ------------------------------------------------------------- stitching

def build_stitch_graph(Trk, Cid, alldata, n_frame, tc: TraceCalculator,
                       window=120, id_bonus=0.01):
    """Candidate continuation edges (reference get_graph, step3:1079-1164):
    box continuity within 120 frames, <=50% interval overlap, 3D jump
    distance as weight (x0.01 when collar IDs agree; pruned when they
    conflict)."""
    Intv = _intervals(Trk, min_cams=2)
    edges = []
    for k1 in Trk:
        if Intv[k1] is None:
            continue
        i1 = Intv[k1]
        t_e = Trk[k1][i1[1], :].copy()
        t_e[t_e == -1] = -2
        for k2 in Trk:
            if k1 == k2 or Intv[k2] is None:
                continue
            seg = Trk[k2][i1[1] : min(i1[1] + window, n_frame)]
            chk = (seg == t_e[None, :]).sum(axis=0)
            if not (chk > 1).any():
                continue
            i2 = Intv[k2]
            n1 = i1[1] - i1[0]
            n2 = i2[1] - i2[0]
            lo = max(i1[0], i2[0])
            hi = min(i1[1], i2[1])
            n12 = max(0, hi - lo)
            if n12 / max(n1, 1) > 0.5 or n12 / max(n2, 1) > 0.5:
                continue

            f1 = i1[1]
            p1 = tc.trace(alldata, Trk[k1], np.array([f1]), reduce="mean")[0]
            I = np.where((Trk[k2] >= 0).sum(axis=1) > 1)[0]
            I = I[I >= i1[1]]
            if I.size == 0:
                continue
            f2 = int(I[0])
            p2 = tc.trace(alldata, Trk[k2], np.array([f2]), reduce="mean")[0]
            d = float(np.sqrt(np.sum((p1 - p2) ** 2)))
            c1, c2 = Cid[k1][f1], Cid[k2][f2]
            if c1 != -1 and c2 != -1 and c1 != c2:
                continue
            if c1 != -1 and c1 == c2:
                d *= id_bonus
            if np.isnan(d):
                continue
            edges.append([k1, k2, d])
    return np.asarray(edges, float).reshape(-1, 3)


def min_cost_flow(n_nodes: int, arcs, demand):
    """Minimum-cost flow by successive shortest paths (Dijkstra on
    reduced costs; the costs are non-negative integers).

    arcs: list of (tail, head, capacity, cost); demand[v] is the net
    inflow node v must receive (negative: it supplies). Returns (cost,
    flow per arc) or None when no flow meets the demands (networkx's
    ``NetworkXUnfeasible``)."""
    S, T = n_nodes, n_nodes + 1
    n = n_nodes + 2
    head, cap, cost, adj = [], [], [], [[] for _ in range(n)]

    def add(u, v, c, w):
        adj[u].append(len(head))
        head.append(v), cap.append(c), cost.append(w)
        adj[v].append(len(head))
        head.append(u), cap.append(0), cost.append(-w)

    for u, v, c, w in arcs:
        add(u, v, c, w)
    need = 0
    for v, d in enumerate(demand):
        if d < 0:
            add(S, v, -d, 0)
        elif d > 0:
            add(v, T, d, 0)
            need += d
    pot = [0] * n
    total, flow = 0, 0
    while flow < need:
        dist = [None] * n
        prev = [-1] * n
        dist[S] = 0
        heap = [(0, S)]
        while heap:
            du, u = heapq.heappop(heap)
            if du > dist[u]:
                continue
            for e in adj[u]:
                if cap[e] <= 0:
                    continue
                v = head[e]
                nd = du + cost[e] + pot[u] - pot[v]
                if dist[v] is None or nd < dist[v]:
                    dist[v] = nd
                    prev[v] = e
                    heapq.heappush(heap, (nd, v))
        if dist[T] is None:
            return None
        for v in range(n):
            if dist[v] is not None:
                pot[v] += dist[v]
        push, v = need - flow, T
        while v != S:
            e = prev[v]
            push = min(push, cap[e])
            v = head[e ^ 1]
        v = T
        while v != S:
            e = prev[v]
            cap[e] -= push
            cap[e ^ 1] += push
            total += push * cost[e]
            v = head[e ^ 1]
        flow += push
    # the flow on the caller's arcs: the capacity their reverses gained
    return total, [cap[2 * i + 1] for i in range(len(arcs))]


def solve_flow(edges: np.ndarray):
    """Min-cost-flow stitching, retried over every track count and keeping
    the cheapest feasible one-in/one-out solution (reference calc_flow,
    step3:313-402; the JAX package's ``solve_flow``). The same demand
    graph as the JAX package's networkx one — source, sink, an IN and an
    OUT node per tracklet — solved by :func:`min_cost_flow`; chains are
    followed from the source in node order. Where several flows share the
    optimal cost, the chains may differ from networkx's."""
    if edges.shape[0] == 0:
        return []
    out_cost = 1000 * 100
    nodes = np.unique(edges[:, :2]).astype(int)
    pos = {int(v): i for i, v in enumerate(nodes)}
    n = nodes.shape[0]
    SRC, SNK = 2 * n, 2 * n + 1      # IN of node i = 2 i, OUT = 2 i + 1
    arcs = []
    for i in range(n):
        arcs += [(2 * i, 2 * i + 1, 1, 0), (SRC, 2 * i, 1, out_cost),
                 (2 * i + 1, SNK, 1, out_cost)]
    links = {}                       # networkx's DiGraph keeps the last
    for a, b, w in edges:
        links[(pos[int(a)], pos[int(b)])] = int(w * 100)
    arcs += [(2 * a + 1, 2 * b, 1, w) for (a, b), w in links.items()]
    best, min_cost = None, 1000 * 100 * 1000

    for n_track in range(1, n):
        demand = [1, -1] * n + [-n_track, n_track]
        sol = min_cost_flow(2 * n + 2, arcs, demand)
        if sol is None:
            continue
        cost, flow = sol
        cnt_in, cnt_out = [0] * n, [0] * n
        for (u, v, _, _), f in zip(arcs, flow):
            if f == 1 and v < SRC and v % 2 == 0:
                cnt_in[v // 2] += 1
            if f == 1 and u < SRC and u % 2 == 1:
                cnt_out[u // 2] += 1
        if max(cnt_in) > 1 or max(cnt_out) > 1:
            continue
        if cost < min_cost:
            min_cost, best = cost, flow

    if best is None:
        return []
    succ = {u // 2: v // 2 for (u, v, _, _), f in zip(arcs, best)
            if f == 1 and u < SRC and u % 2 == 1 and v < SRC}

    def follow(i):
        path = [int(nodes[i])]
        if i in succ:
            path.extend(follow(succ[i]))
        return path

    starts = sorted(v // 2 for (u, v, _, _), f in zip(arcs, best)
                    if f == 1 and u == SRC)
    return [follow(i) for i in starts]

def stitch_tracklets(Trk, Cid, alldata, n_frame, tc: TraceCalculator,
                     stats: dict | None = None):
    """Merge flow chains into stitched tracklets (reference step3:1446-85).
    ``stats``, if given, receives the flow solve's seconds and the number
    of min-cost flows it solved."""
    edges = build_stitch_graph(Trk, Cid, alldata, n_frame, tc)
    stitch_info: dict = {}
    t = time.perf_counter()
    chains = solve_flow(edges)
    if stats is not None:
        stats["seconds"] = time.perf_counter() - t
        n = np.unique(edges[:, :2]).size
        stats["solves"] = max(n - 1, 0)
    if not chains:
        return Trk, stitch_info

    Intv = _intervals(Trk)
    last = max(Trk.keys())
    k_del = []
    for chain in chains:
        if len(chain) > 1:
            merged = Trk[chain[0]].copy()
            frames = []
            for k in chain:
                gap = merged == -1
                merged[gap] = Trk[k][gap]
                frames.append(Intv[k])
            last += 1
            Trk[last] = merged
            stitch_info[last] = frames
            k_del.extend(chain)
    for k in k_del:
        Trk.pop(k)
    return Trk, stitch_info


def breakdown_stitched_tracklets(Trk, Cid, stitch_info, n_cam):
    """Re-split stitched tracklets into their source spans, all inheriting
    the stitched identity (reference step3:216-252)."""
    Intv = _intervals(Trk)
    last = max(Trk.keys())
    for k, frames in stitch_info.items():
        if k not in Cid:
            continue
        n_frame = Cid[k].shape[0]
        lo, hi = Intv[k]
        cid = int(np.max(np.unique(Cid[k][lo:hi])))
        for f0, f1 in frames:
            trk = -np.ones((n_frame, n_cam), int)
            trk[f0 : f1 + 1] = Trk[k][f0 : f1 + 1]
            C = -np.ones(n_frame, int)
            C[f0 : f1 + 1] = cid
            last += 1
            Trk[last] = trk
            Cid[last] = C
        Trk.pop(k)
        Cid.pop(k)
    return Trk, Cid


# ------------------------------------------------------------- dedup

def clean_id_duplication(Trk, Cid, Trk_cid, n_frame, wsize, fps,
                         n_animal=4):
    """Resolve same-identity overlaps: drop tracklets without confident ID
    detections or unique contribution, shorten at confident-ID boundaries
    (reference step3:404-637)."""
    half = wsize // 2
    Intv = _intervals(Trk)
    Intv_fixed = copy.deepcopy(Intv)
    k_exclude: list = []
    k_del: list = []

    for sub in range(n_animal):
        K = [k for k in Trk if (np.unique(Cid[k]) == sub).any()]
        cnt_overlap = np.zeros(n_frame, int)
        for k in K:
            cnt_overlap[Intv[k][0] : Intv[k][1]] += 1
        if not (cnt_overlap > 1).any():
            continue

        Cid_conf = {}
        for k in K:
            cid0 = Trk_cid[k]
            cid1 = -np.ones(n_frame, int)
            for f in range(max(Intv[k][0], half),
                           min(Intv[k][1], n_frame - half)):
                cnt = cid0[f - half : f + half].sum(axis=0)
                tot = cnt.sum()
                if tot and cnt.max() / tot > 0.8 and cnt.max() >= MINDETCNT2:
                    i_max = int(np.argmax(cnt))
                    I = np.where(cid0[f - half : f + half, i_max])[0]
                    if I.min() <= half and I.max() >= half:
                        cid1[f] = i_max
            cid1[: Intv[k][0]] = -1
            cid1[Intv[k][1] :] = -1
            Cid_conf[k] = cid1

        K = sorted(K, key=lambda k: Intv[k][1] - Intv[k][0])

        # drop overlapping tracklets lacking any confident detection
        for k1 in K:
            e2 = np.zeros(n_frame, int)
            for k2 in K:
                if k2 == k1 or k2 in k_exclude:
                    continue
                e2[Intv[k2][0] : Intv[k2][1]] += 1
            if e2[Intv[k1][0] : Intv[k1][1]].sum() == 0:
                continue
            if not (Cid_conf[k1] == sub).any():
                k_exclude.append(k1)

        # drop tracklets with no unique contribution
        for k1 in K:
            if k1 in k_exclude:
                continue
            e1 = np.zeros(n_frame, int)
            e2 = np.zeros(n_frame, int)
            e1[Intv[k1][0] : Intv[k1][1]] = 1
            for k2 in K:
                if k2 == k1 or k2 in k_exclude:
                    continue
                e2[Intv[k2][0] : Intv[k2][1]] = 1
            if not (e1 > e2).any():
                lo, hi = Intv[k1]
                if not (cnt_overlap[lo:hi] > 2).any():
                    if lo == 0 or hi == n_frame - 1:
                        pass
                    else:
                        k_exclude.append(k1)
                        k_del.append(k1)
                else:
                    k_exclude.append(k1)
                    k_del.append(k1)

        K = [k for k in K if k not in k_exclude]
        K = sorted(K, key=lambda k: (Intv[k][0], Intv[k][1]))

        for i in range(len(K) - 1):
            k1, k2 = K[i], K[i + 1]
            if k1 in k_exclude:
                continue
            if Intv[k1][1] < Intv[k2][0]:
                continue
            f1 = np.where(Cid_conf[k1] == sub)[0]
            f2 = np.where(Cid_conf[k2] == sub)[0]
            if f1.size == 0:
                k_exclude.append(k1)
                continue
            if f2.size == 0:
                k_exclude.append(k2)
                continue
            f1 = int(f1.max())
            f2 = int(f2.min())
            if f1 < f2:
                Intv_fixed[k1][1] = f1
                Intv_fixed[k2][0] = f2
                Intv[k1] = Intv_fixed[k1]
                Intv[k2] = Intv_fixed[k2]
                Cid_conf[k1][f1:] = -1
                Cid_conf[k2][:f2] = -1
            elif f2 - Intv[k1][0] >= fps and Intv[k2][1] - f1 >= fps:
                Intv_fixed[k1][1] = f2
                Intv_fixed[k2][0] = f1
                Intv[k1] = Intv_fixed[k1]
                Intv[k2] = Intv_fixed[k2]
                Cid_conf[k1][f2:] = -1
                Cid_conf[k2][:f1] = -1
            else:
                loser = k2 if (Intv[k1][1] - Intv[k1][0]
                               > Intv[k2][1] - Intv[k2][0]) else k1
                k_exclude.append(loser)
                k_del.append(loser)

    for k in k_exclude:
        Cid[k][:] = -1
    for k, (lo, hi) in Intv_fixed.items():
        Trk[k][:lo, :] = -1
        Trk[k][hi:, :] = -1
    for k in list(Trk.keys()):
        if not ((Trk[k] >= 0).sum(axis=1) > 0).any():
            k_del.append(k)
    for k in set(k_del):
        Trk.pop(k, None)
        Cid.pop(k, None)
        Trk_cid.pop(k, None)
    return Trk, Cid, Trk_cid


# -------------------------------------------------------- last-one logic

def assign_lastone(Trk, Cid, alldata, tc: TraceCalculator, n_animal=4,
                   min_duration=12):
    """Assign the single missing identity by elimination (reference
    step3:96-214): when exactly 3 identities coexist around an unassigned
    tracklet, and it does not spatially coincide or temporally collide
    with an assigned one, it becomes the fourth."""
    flag_update = False
    Intv = _intervals(Trk)
    unassigned = [k for k in Trk if not (Cid[k] >= 0).any()]
    assigned = [k for k in Trk if (Cid[k] >= 0).any()]
    unassigned.sort(key=lambda k: Intv[k][1] - Intv[k][0], reverse=True)
    if not assigned or not unassigned:
        return Trk, Cid, False

    n_frame = Cid[assigned[0]].shape[0]
    A = np.zeros((n_frame, n_animal), bool)
    for k in assigned:
        lo, hi = Intv[k]
        for c in range(n_animal):
            A[lo:hi, c] |= Cid[k][lo:hi] == c

    for k in unassigned:
        lo, hi = Intv[k]
        if hi - lo <= min_duration:
            continue
        a = A[lo:hi]
        rows3 = a.sum(axis=1) == 3
        absent = (~a)[rows3]
        cnt = absent.sum(axis=0)
        if cnt.sum() == 0:
            continue
        i_max = int(np.argmax(cnt))
        if not (cnt[i_max] / cnt.sum() > 0.8 and cnt[i_max] >= 3):
            continue

        cog_u = None
        conflict = False
        for k2 in assigned:
            lo2, hi2 = Intv[k2]
            n_overlap = max(0, min(hi, hi2) - max(lo, lo2))
            if n_overlap == 0:
                continue
            thr = 2 if n_overlap > (hi - lo) / 2 else 12
            if cog_u is None:
                cog_u = tc.trace(alldata, Trk[k], np.arange(lo, hi + 1))
            cog_a = tc.trace(alldata, Trk[k2], np.arange(lo, hi + 1))
            d = np.sum((cog_u - cog_a) ** 2, axis=1)
            d = d[~np.isnan(d)]
            if d.size >= thr and np.sqrt(d.mean()) < 150:
                conflict = True
                break
        if conflict:
            continue
        for k2 in assigned:
            ids2 = np.unique(Cid[k2][Intv[k2][0] : Intv[k2][1]])
            ids2 = ids2[ids2 >= 0]
            if ids2.size != 1 or int(ids2[0]) != i_max:
                continue
            if max(0, min(hi, Intv[k2][1]) - max(lo, Intv[k2][0])) > 0:
                conflict = True
                break
        if conflict:
            continue
        flag_update = True
        Cid[k][:] = i_max
        assigned.append(k)
        A[lo:hi, i_max] = True
    return Trk, Cid, flag_update


# ------------------------------------------------------------- kp2d file

def create_kp2d(alldata, Trk, Cid, n_frame, n_cam, n_animal=4, n_kp=17):
    """Dense per-animal 2D matrix [n_animal, n_frame, n_cam, 17, 3]
    (reference create_kp2dfile, step3:872-915)."""
    kp2d = np.zeros((n_animal, n_frame, n_cam, n_kp, 3))
    done = np.zeros((n_animal, n_frame, n_cam), bool)
    # index detections once: (cam, frame, bbox_id) -> kp
    index: dict = {}
    for cam in range(n_cam):
        for f in range(n_frame):
            for det in alldata[cam][f]:
                index[(cam, f, det[0])] = det[5]
    for k in Trk:
        cid_arr = Cid[k]
        trk = Trk[k]
        for f in range(n_frame):
            a = cid_arr[f]
            if a < 0 or not (trk[f] >= 0).any():
                continue
            for cam in range(n_cam):
                if done[a, f, cam]:
                    continue
                kp = index.get((cam, f, int(trk[f, cam])))
                if kp is not None:
                    kp2d[a, f, cam] = np.asarray(kp)
                    done[a, f, cam] = True
    return kp2d


# ------------------------------------------------------------------ main

def run_step3(
    result_dir: str,
    rig: CameraRig,
    cfg: CrossFrameConfig = CrossFrameConfig(),
    fps: float = 24.0,
    redo: bool = False,
    mesh=None,
    device=None,
    dtype: torch.dtype = torch.float32,
    times: dict | None = None,
) -> str:
    """Stage 3 over ``result_dir``'s ``match_keyframe.pickle`` and
    per-camera ``alldata.json``; writes ``keyframe_connection.pickle``,
    ``kp2d.pickle``, ``track.pickle`` and ``collar_id.pickle`` and returns
    the path of ``kp2d.pickle``. The traces run on ``device`` (the card
    when None) in ``dtype``. ``times``, if given, receives the seconds of
    each part (read, connect, build, trim, ids, stitch with its flow
    solves, dedup, last_one, write), the flow solves' seconds and count,
    and the trace calculator's device calls and seconds. ``mesh``
    (``core/mesh.py``) shards each trace's frames over its devices, the
    camera replicated on each."""
    out_path = os.path.join(result_dir, "kp2d.pickle")
    if stage_done(out_path, os.path.join(result_dir, "track.pickle")) \
            and not redo:
        print(f"[step3] skip (exists): {out_path}")
        return out_path
    mesh, dev = stage_mesh(mesh, device)
    t_last = [time.perf_counter()]

    def lap(name):
        if times is not None:
            now = time.perf_counter()
            times[name] = times.get(name, 0.0) + now - t_last[0]
            t_last[0] = now

    n_cam = rig.n_cam
    alldata = []
    for cam_id in rig.camera_ids:
        d, _ = read_alldata(os.path.join(result_dir, str(cam_id)))
        alldata.append(d)
    match_keyframes = read_pickle(
        os.path.join(result_dir, "match_keyframe.pickle")
    )
    tc = TraceCalculator(rig, device=dev, dtype=dtype, mesh=mesh)
    wsize = int(fps * 5)
    lap("read")

    print("[step3] connect keyframes...")
    alldata2, kfs2, connections = connect_keyframes(
        alldata, match_keyframes, n_cam
    )
    write_pickle(os.path.join(result_dir, "keyframe_connection.pickle"),
                 connections)

    # duplicate-colour disqualification on the renumbered data
    for cam in range(n_cam):
        for f in range(len(alldata2[0])):
            cnt: dict = {}
            for det in alldata2[cam][f]:
                if det[6] in VALID_COLLAR_CLASSES and det[7] > CID_THR:
                    cnt[det[6]] = cnt.get(det[6], 0) + 1
            dup = {c for c, n in cnt.items() if n > 1}
            for det in alldata2[cam][f]:
                if det[6] in dup:
                    det[7] = 0.0
    lap("connect")

    Trk, n_frame = build_tracklets(alldata2, kfs2, connections, n_cam)
    lap("build")
    if not Trk:
        write_pickle(out_path, np.zeros((cfg.n_animal, len(alldata2[0]),
                                         n_cam, 17, 3)))
        write_pickle(os.path.join(result_dir, "track.pickle"), {})
        write_pickle(os.path.join(result_dir, "collar_id.pickle"), {})
        lap("write")
        _trace_times(times, tc, 0.0, 0)
        return out_path

    print("[step3] trim...")
    Trk = trim_tracklets(Trk, alldata2, n_frame, tc, cfg.trim_rmse_mm)
    lap("trim")

    print("[step3] assign ids...")
    Trk_cid = count_id_detections(alldata2, Trk, n_frame, n_cam)
    Cid = set_tracklet_ids(Trk, Trk_cid, n_frame, wsize)
    Trk, Cid = split_multi_id_tracklets(Trk, Cid, n_cam=n_cam)

    Trk = remove_single_cam_tracklets(Trk)
    Trk = remove_short_tracklets(Trk, Cid, min_frames=0)
    lap("ids")

    print("[step3] stitch...")
    flow_stats = {}
    Trk, stitch_info = stitch_tracklets(Trk, Cid, alldata2, n_frame, tc,
                                        flow_stats)

    Trk_cid = count_id_detections(alldata2, Trk, n_frame, n_cam)
    Cid = set_tracklet_ids(Trk, Trk_cid, n_frame, wsize)
    Trk, Cid, stitch_info = split_multi_id_tracklets(
        Trk, Cid, stitch_info, n_cam=n_cam
    )
    lap("stitch")

    print("[step3] clean duplication...")
    Trk, Cid = breakdown_stitched_tracklets(Trk, Cid, stitch_info, n_cam)
    Trk_cid = count_id_detections(alldata2, Trk, n_frame, n_cam)
    Trk, Cid, Trk_cid = clean_id_duplication(
        Trk, Cid, Trk_cid, n_frame, wsize, int(fps), cfg.n_animal
    )
    lap("dedup")

    print("[step3] assign last one...")
    for _ in range(cfg.n_animal):
        Trk, Cid, updated = assign_lastone(
            Trk, Cid, alldata2, tc, cfg.n_animal
        )
        if not updated:
            break
    lap("last_one")

    print("[step3] write kp2d...")
    kp2d = create_kp2d(alldata2, Trk, Cid, n_frame, n_cam, cfg.n_animal)
    write_pickle(out_path, kp2d)
    write_pickle(os.path.join(result_dir, "track.pickle"), Trk)
    write_pickle(os.path.join(result_dir, "collar_id.pickle"), Cid)
    lap("write")
    _trace_times(times, tc, flow_stats.get("seconds", 0.0),
                 flow_stats.get("solves", 0))
    return out_path


def _trace_times(times, tc, flow_s, flow_n):
    if times is not None:
        times["flow"] = flow_s
        times["flow_solves"] = flow_n
        times["trace_calls"] = tc.calls
        times["trace"] = tc.seconds
