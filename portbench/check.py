"""The output check: what the timed path produced against the plain
reference, number by number, each held to a limit of its own.

The judged side (``Judged``) is what the window produced on the chunks the
check samples: the detector's per-frame FPN maps and RPN outputs, its
proposals and detections, the pose network's heatmaps and the keypoints
the perception returned, the classifier's logits, labels and scores, and
the box tables the camera loop passed on. The reference recomputes each
stage in float32 (TF32 off) from the frames and the seeded weights.
Where the random weights make a choice chaotic (the RPN's and the box
head's rankings among scores within about 1e-4), the reference follows
the judged side from its own state into the next stage, and each stage is
compared by itself:

==================  =====================================================
``det_maps``        FPN maps from the frame; worst |d| over the map's range
``det_rpn``         RPN outputs from the judged maps; |d| over the range
``det_props``       proposals from the judged RPN outputs; the share of
                    judged proposals with no reference one at IoU >= 0.99
``det_box_px``      head boxes from the judged maps and proposals; each
                    detection against the nearest reference box, pixels
``det_score``       that box's score against the detection's
``det_cut``         how far a detection's reference score lies below the
                    reference's own k-th best after NMS
``det_count``       frames whose number of detections differs (exact)
``det_nms_iou``     the largest overlap (IoU) between two detections of
                    one frame; its limit is the configuration's own NMS
                    threshold, ``rcnn_iou_thr``
``pose_hm``         heatmaps from crops of the frame at the judged pose
                    boxes, flip test included; |d| over the range
``pose_kp_px``      keypoints decoded from the judged heatmaps, pixels
``pose_kp_score``   their scores
``id_prob``         class probabilities from crops at the judged ID boxes;
                    the gap of the judged label to the best and its score
``rows``            every window segment's box tables (the tracker run on
                    the judged detections) and ``alldata.json`` rows
                    rebuilt from them (exact, mismatching frames)
``path``            kernels launched against the configuration's path
                    (exact)
==================  =====================================================

``control_judged`` builds the judged side from the reference itself one
precision step lower: the networks' bfloat16 layers in fp8 (e4m3), their
quantized layers one step below (the serving pose's int8 blocks in int4),
and the float32 decoding of boxes, scores and keypoints in bfloat16. It is
the control that a limit has to separate from the program's own readings.

Each network comes from the architecture file that its configuration
block names (``files.arch``): the reference module, its quantization and,
for the detector, its input and the key of its foreground bias. The
stages run on a reference detector's ``maps``, ``rpn_head`` and
``roi_head.bbox_head`` (the contract in ``reference/nets.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from portbench import files
from portbench.reference import detect, lowp, prep, track
from portbench.weights import seeded_state

DETECTOR = ("det_maps", "det_rpn", "det_props", "det_box_px", "det_score",
            "det_cut", "det_count", "det_nms_iou")
CHUNK = DETECTOR + ("pose_hm", "pose_kp_px", "pose_kp_score", "id_prob")
NUMBERS = CHUNK + ("rows", "path")
EXACT = ("det_count", "rows", "path")


@dataclass
class Judged:
    """One sampled chunk as the judged side produced it."""
    frames: np.ndarray                     # (B, H, W, 3) uint8 BGR
    det: tuple                             # boxes (B, D, 4), scores (B, D)
    maps: list                             # per frame: 5 x (1, H, W, C)
    rpn: list                              # per frame: 5 x (cls, reg)
    proposals: list                        # per frame: (n, 4) valid, ranked
    pose_in: tuple | None = None           # boxes (B, D, 4), valid (B, D)
    heatmaps: torch.Tensor | None = None   # (B*D*(1+flip), 64, 48, 17)
    kps: np.ndarray | None = None          # (B, D, 17, 3)
    id_in: tuple | None = None
    id_out: tuple | None = None            # labels (B, D), scores (B, D)


class Reference:
    """The reference networks for a configuration and seed, in float32, or
    one precision step lower (``lower=True``: the control)."""

    def __init__(self, cfg: dict, seed: int, device, fg_bias: float,
                 lower: bool = False):
        lowp.tf32_off()
        self.cfg, self.device, self.fg_bias = cfg, device, fg_bias
        self.post = torch.bfloat16 if lower else torch.float32
        n = cfg["networks"]
        self.arch = {role: files.arch(block) for role, block in n.items()}
        self.det = self._net("detector", n["detector"], seed, lower)
        self.pose = (self._net("pose", n["pose"], seed, lower)
                     if "pose" in n else None)
        self.idm = (self._net("classifier", n["classifier"], seed, lower)
                    if "classifier" in n else None)

    def _net(self, kind, c, seed, lower):
        arch = self.arch[kind]
        with torch.device(self.device):
            net = arch.reference(c)
        sd = seeded_state(kind, c, seed, self.device)
        if kind == "detector":
            sd[arch.FG_BIAS][0] += self.fg_bias
        net.load_state_dict(sd)
        arch.quantize(net, c, lower)
        if lower:
            lowp.lower_(net, "fp8")
        return net

    def detector_input(self, rgb):
        """(B, H, W, 3) RGB -> the reference detector's input and scale."""
        return self.arch["detector"].reference_input(
            rgb, self.cfg["networks"]["detector"])


def _rgb(frames: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames[..., ::-1])).to(device)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf")
    span = (want.max() - want.min()).clamp_min(1e-30)
    return ((got - want).abs().max() / span).item()


def _iou_max(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if not len(b):
        return np.zeros(len(a))
    return detect.iou_np(a, b).max(1)


@torch.no_grad()
def compare(j: Judged, ref: Reference) -> dict:
    """The stage numbers of one judged chunk against the float32 reference."""
    dev, dc = ref.device, ref.cfg["networks"]["detector"]
    D = ref.cfg["max_det"]
    out = dict.fromkeys(DETECTOR, 0.0)
    rgb = _rgb(j.frames, dev)
    B = len(j.frames)
    if not (len(j.maps) == len(j.rpn) == len(j.proposals) == B
            and j.det[0].shape == (B, D, 4) and j.det[1].shape == (B, D)):
        return dict.fromkeys(DETECTOR, float("inf"))
    for f in range(B):
        x, scale = ref.detector_input(rgb[f:f + 1])
        img_shape = tuple(x.shape[1:3])
        rmaps = ref.det.maps(x)
        pmaps = [m.float() for m in j.maps[f]]
        out["det_maps"] = max([out["det_maps"]] + [
            _rel(p, r) for p, r in zip(pmaps, rmaps)])
        rrpn = ref.det.rpn_head(pmaps)
        out["det_rpn"] = max([out["det_rpn"]] + [
            _rel(p, r) for pr, rr in zip(j.rpn[f], rrpn) for p, r in zip(pr, rr)])
        rprops = detect.proposals([(c[0].float(), r[0].float()) for c, r in j.rpn[f]],
                                  dc, img_shape).numpy()
        pprops = j.proposals[f].float().cpu().numpy()
        miss = (np.sum(_iou_max(pprops, rprops) < 0.99)
                + abs(len(pprops) - len(rprops)))
        out["det_props"] = max(out["det_props"], miss / max(len(pprops), 1))
        props = j.proposals[f][:dc["rcnn_roi_topk"]].float().to(dev)
        rb, rs = detect.head(ref.det.roi_head.bbox_head,
                             [m[0] for m in pmaps[:4]], props, img_shape)
        rb = (rb / scale).double().cpu().numpy()
        rs = rs.double().cpu().numpy()
        _, _, kept = detect.detections(torch.as_tensor(rb), torch.as_tensor(rs),
                                       dc, D)
        boxes, scores = j.det[0][f], j.det[1][f]
        valid = scores > 0
        k = int(valid.sum())
        if k != min(D, len(kept)):
            out["det_count"] += 1
        cut = kept[k - 1] if 0 < k <= len(kept) else -np.inf
        if k > 1:
            b = boxes[valid].astype(np.float64)
            iou = detect.iou_np(b, b)[np.triu_indices(k, 1)]
            out["det_nms_iou"] = max(out["det_nms_iou"], float(iou.max()))
        for b, s in zip(boxes[valid], scores[valid]):
            d = np.abs(rb - b).max(1)
            i = int(d.argmin())
            out["det_box_px"] = max(out["det_box_px"], float(d[i]))
            out["det_score"] = max(out["det_score"], abs(float(s) - rs[i]))
            out["det_cut"] = max(out["det_cut"], max(0.0, cut - rs[i]))
    if j.pose_in is not None and ref.pose is not None:
        out.update(_pose(j, ref, rgb))
    if j.id_in is not None and ref.idm is not None:
        out["id_prob"] = _classify(j, ref, rgb)
    return out


def _pose(j: Judged, ref: Reference, rgb) -> dict:
    pc = ref.cfg["networks"]["pose"]
    dev = ref.device
    boxes = torch.as_tensor(j.pose_in[0], device=dev)
    valid = torch.as_tensor(j.pose_in[1], device=dev)
    B, D = valid.shape
    H, W = pc["img_size"]
    c, s = prep.center_scale(boxes, aspect=W / H)
    crops = prep.pose_crops(rgb, c, s, (H, W)).reshape(B * D, H, W, 3)
    flip = pc["flip_test"]
    inputs = torch.cat([crops, crops.flip(2)]) if flip else crops
    hm = torch.cat([ref.pose(inputs[i:i + 32]) for i in range(0, len(inputs), 32)])
    rows = valid.reshape(-1).repeat(2 if flip else 1)
    judged = j.heatmaps.float()
    hm_gap = _rel(judged[rows], hm[rows])
    fused = (0.5 * (judged[:B * D] + prep.flip_heatmaps(judged[B * D:]))
             if flip else judged)
    kp, score = prep.udp_decode(fused.to(ref.post), input_size=(W, H))
    kp = prep.crop_to_image(kp.float(), c.reshape(-1, 2), s.reshape(-1, 2), (H, W))
    got = torch.as_tensor(j.kps, device=dev).reshape(B * D, -1, 3)
    v = valid.reshape(-1)
    return {"pose_hm": hm_gap,
            "pose_kp_px": (got[v, :, :2] - kp[v]).abs().max().item() if v.any() else 0.0,
            "pose_kp_score": (got[v, :, 2] - score.float()[v]).abs().max().item()
            if v.any() else 0.0}


def _classify(j: Judged, ref: Reference, rgb) -> float:
    dev = ref.device
    boxes = torch.as_tensor(j.id_in[0], device=dev)
    valid = torch.as_tensor(j.id_in[1], device=dev).reshape(-1)
    B, D = j.id_in[1].shape
    crops = prep.id_crops(rgb, boxes).reshape(B * D, 224, 224, 3)
    p = torch.softmax(torch.cat([ref.idm(crops[i:i + 64])
                                 for i in range(0, len(crops), 64)]), -1)
    labels = torch.as_tensor(j.id_out[0], device=dev).reshape(-1)[valid]
    scores = torch.as_tensor(j.id_out[1], device=dev).reshape(-1)[valid].float()
    if not len(labels):
        return 0.0
    p = p[valid]
    at = p.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    return max((p.max(1).values - at).max().item(),
               (scores - at).abs().max().item())


@torch.no_grad()
def control_judged(j: Judged, low: Reference) -> Judged:
    """The judged side as the reference one precision step lower produces
    it, on the same frames and the same box tables."""
    dev, dc = low.device, low.cfg["networks"]["detector"]
    D = low.cfg["max_det"]
    rgb = _rgb(j.frames, dev)
    maps, rpn, props = [], [], []
    boxes = np.zeros((len(j.frames), D, 4), np.float32)
    scores = np.zeros((len(j.frames), D), np.float32)
    for f in range(len(j.frames)):
        x, scale = low.detector_input(rgb[f:f + 1])
        img_shape = tuple(x.shape[1:3])
        m = low.det.maps(x)
        r = low.det.rpn_head(m)
        p = detect.proposals([(c[0], g[0]) for c, g in r], dc, img_shape,
                             low.post).to(dev)
        b, s = detect.head(low.det.roi_head.bbox_head, [t[0] for t in m[:4]],
                           p[:dc["rcnn_roi_topk"]], img_shape, low.post)
        kb, ks, _ = detect.detections(b / scale, s, dc, D)
        boxes[f, :len(kb)], scores[f, :len(ks)] = kb, ks
        maps.append(m)
        rpn.append(r)
        props.append(p)
    out = Judged(j.frames, (boxes, scores), maps, rpn, props,
                 pose_in=j.pose_in, id_in=j.id_in)
    if j.pose_in is not None and low.pose is not None:
        pc = low.cfg["networks"]["pose"]
        bx = torch.as_tensor(j.pose_in[0], device=dev)
        B, Dd = j.pose_in[1].shape
        H, W = pc["img_size"]
        c, s = prep.center_scale(bx, aspect=W / H)
        crops = prep.pose_crops(rgb, c, s, (H, W)).reshape(B * Dd, H, W, 3)
        inputs = torch.cat([crops, crops.flip(2)]) if pc["flip_test"] else crops
        hm = torch.cat([low.pose(inputs[i:i + 32])
                        for i in range(0, len(inputs), 32)])
        fused = (0.5 * (hm[:B * Dd] + prep.flip_heatmaps(hm[B * Dd:]))
                 if pc["flip_test"] else hm)
        kp, sc = prep.udp_decode(fused.to(low.post), input_size=(W, H))
        kp = prep.crop_to_image(kp.float(), c.reshape(-1, 2), s.reshape(-1, 2),
                                (H, W))
        out.heatmaps = hm
        out.kps = torch.cat([kp, sc.float()[..., None]], -1).reshape(
            B, Dd, -1, 3).cpu().numpy()
    if j.id_in is not None and low.idm is not None:
        crops = prep.id_crops(rgb, torch.as_tensor(j.id_in[0], device=dev))
        B, Dd = j.id_in[1].shape
        p = torch.softmax(low.idm(crops.reshape(B * Dd, 224, 224, 3)), -1)
        sc, lab = p.max(1)
        out.id_out = (lab.reshape(B, Dd).cpu().numpy(),
                      sc.reshape(B, Dd).cpu().numpy())
    return out


def check_rows(segments: list, records: dict, D: int) -> int:
    """Frames whose box tables or rows differ from the reference loop's,
    over every window segment: ``segments`` holds (index, rows of its
    ``alldata.json``), ``records`` the recorder's per-chunk records."""
    bad = 0
    for seg, prog_rows in segments:
        tracker, ema, ref_rows = track.Tracker(), track.Ema(), []
        c = 0
        while (seg, c) in records:
            rec = records[(seg, c)]
            boxes, scores = rec["det"]
            pose_b, id_b, valid, tids = track.tables(tracker, boxes, scores, D)
            if valid.any():
                same = ("pose_in" in rec and "id_in" in rec
                        and np.array_equal(rec["pose_in"][0], pose_b)
                        and np.array_equal(rec["pose_in"][1], valid)
                        and np.array_equal(rec["id_in"][0], id_b))
                kps, (labels, lscores) = rec.get("kps"), rec.get("id_out", (None, None))
                if not same:
                    bad += rec["n"]
                    kps = np.full(valid.shape + (17, 3), np.nan, np.float32)
                    labels = np.full(valid.shape, -1)
                    lscores = np.zeros(valid.shape, np.float32)
            else:
                same = "pose_in" not in rec
                bad += 0 if same else rec["n"]
                kps = labels = lscores = None
            ref_rows += track.rows(ema, id_b, valid, tids, kps, labels, lscores)
            c += 1
        bad += abs(len(ref_rows) - len(prog_rows))
        bad += sum(json.dumps(a) != json.dumps(b)
                   for a, b in zip(ref_rows, prog_rows))
    return bad


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(all numbers within their limits, [(name, value, limit)]); a number
    with no limit fails."""
    lines, ok = [], True
    for name in NUMBERS:
        if name not in numbers:
            continue
        value = numbers[name]
        limit = 0 if name in EXACT else limits.get(name)
        good = limit is not None and value <= limit
        ok &= good
        lines.append((name, value, limit))
    return ok, lines
