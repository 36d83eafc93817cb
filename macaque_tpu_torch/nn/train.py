"""Training for the pose, ID and detection networks, in PyTorch.

The port of ``macaque_tpu/nn/train.py``: the same losses, targets,
schedules, optimizer chains and train steps, with the hyperparameters of
the reference configs:

  * pose (model/pose/td-hm_ViTPose-huge_8xb64-210e_coco-256x192_sn_
    macaque.py): UDPHeatmap codec (64x48, sigma 2), KeypointMSE with
    target weights, AdamW lr 5e-4 / wd 0.1 / betas (0.9, 0.999) with
    layer-wise lr decay 0.85 over the 32 blocks and no decay on
    bias/norm/pos_embed, grad-norm clip 1.0, 500-step linear warmup from
    0.001x + MultiStep x0.1;
  * ID (model/id/sn_resnet152_*.py:53-70): label-smoothing (0.1)
    cross-entropy with per-class weights;
  * detection (model/detection/SWIN-Mask_R-CNN_bbox_only.py): MaxIoUAssigner
    + RandomSampler targets, sigmoid-BCE/L1 (RPN) and softmax-CE/L1 (RoI)
    losses, AdamW lr 1e-4 / wd 0.05, no decay on bias/norm.

A train step is functional, as the JAX package's: it takes the parameters
(a dict of state-dict names to float32 tensors), the BatchNorm statistics
and the optimizer state, and returns new ones with the loss; the model
(made trainable by ``nn.layers.make_trainable``, see :func:`train_state`)
is only the program. The steps run no hand-written kernel: the ViT's
attention is the plain one (``use_pallas_attention=False``) and the RoI
features go through ``roi_align_windowed_reference``, the counterpart of
the JAX package's XLA ``ops.roi_align_windowed``. Random draws are JAX's
threefry stream (``utils/threefry.py``) from the same keys.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from macaque_tpu_torch.nn import optim
from macaque_tpu_torch.nn.layers import make_trainable
from macaque_tpu_torch.utils import threefry


# --------------------------------------------------------- model state

def train_state(model: torch.nn.Module):
    """``(params, batch_stats)`` of a model made trainable (in place, by
    ``make_trainable``): its parameters by state-dict name (float32,
    detached) and its BatchNorm running statistics."""
    make_trainable(model)
    params = {k: p.detach() for k, p in model.named_parameters()}
    stats = {k: b.detach() for k, b in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return params, stats


def _call(module, prefix: str, variables: dict, *args):
    """``module(*args)`` with the tensors of ``variables`` whose names start
    with ``prefix`` (the module's path in its model) as its own."""
    n = len(prefix)
    own = {k[n:]: v for k, v in variables.items() if k.startswith(prefix)}
    return functional_call(module, own, args)


def _grads(loss, leaves: dict) -> dict:
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if d is None else d
            for (k, v), d in zip(leaves.items(), g)}


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


# ------------------------------------------------------ UDP heatmap encode

def udp_encode(keypoints, visible, input_size=(192, 256),
               heatmap_size=(48, 64), sigma: float = 2.0):
    """mmpose UDPHeatmap.encode: keypoints (B, K, 2) in input-pixel coords
    + visibility (B, K) -> (heatmaps (B, H, W, K), weights (B, K)).

    UDP alignment: heatmap coords = pixel / ((input - 1) / (heatmap - 1)),
    a Gaussian of ``sigma`` heatmap px at the continuous position."""
    Wi, Hi = input_size
    Wh, Hh = heatmap_size
    fx = (Wi - 1) / (Wh - 1)
    fy = (Hi - 1) / (Hh - 1)
    mu = torch.stack([keypoints[..., 0] / fx, keypoints[..., 1] / fy], -1)
    xs = torch.arange(Wh, dtype=torch.float32, device=keypoints.device)
    ys = torch.arange(Hh, dtype=torch.float32, device=keypoints.device)
    dx2 = (xs - mu[..., 0:1]) ** 2                    # (B, K, W)
    dy2 = (ys - mu[..., 1:2]) ** 2                    # (B, K, H)
    hm = torch.exp(-(dy2[..., :, None] + dx2[..., None, :])
                   / (2.0 * sigma * sigma))           # (B, K, H, W)
    inside = ((mu[..., 0] >= 0) & (mu[..., 0] <= Wh - 1)
              & (mu[..., 1] >= 0) & (mu[..., 1] <= Hh - 1))
    weights = visible.to(torch.float32) * inside.to(torch.float32)
    hm = hm * weights[..., None, None]
    return hm.movedim(1, -1), weights


def keypoint_mse_loss(pred_hm, target_hm, target_weights):
    """mmpose KeypointMSELoss(use_target_weight=True): per-keypoint MSE over
    heatmap pixels, weighted by the target weight, mean-reduced."""
    per_kp = ((pred_hm - target_hm) ** 2).mean((1, 2))   # (B, K)
    return (per_kp * target_weights).mean()


# --------------------------------------------------- layer-decay optimizer

def _pose_layer_id(name: str, num_layers: int) -> int:
    """mmpose LayerDecayOptimWrapperConstructor layer of a ViTPose
    state-dict name: patch_embed/pos_embed at 0, block i
    (``backbone.layers.i``) at i + 1, everything after the backbone's
    blocks (final LN, head) at num_layers + 1."""
    if "patch_embed" in name or "pos_embed" in name:
        return 0
    parts = name.split(".")
    if parts[:2] == ["backbone", "layers"]:
        return int(parts[2]) + 1
    return num_layers + 1


def _no_decay(name: str, param: torch.Tensor) -> bool:
    """Biases, norm scales (the models' only 1-D weights: LayerNorm and
    BatchNorm), pos_embed and the relative position bias tables get zero
    weight decay (reference paramwise_cfg; the JAX package's ``_no_decay``
    and the detector's decay mask)."""
    last = name.rsplit(".", 1)[-1]
    return (last in ("bias", "pos_embed", "relative_position_bias_table")
            or (last == "weight" and param.dim() == 1))


def pose_lr_schedule(base_lr: float = 5e-4, warmup_steps: int = 500,
                     warmup_factor: float = 1e-3,
                     milestones_steps: Sequence[int] = (),
                     gamma: float = 0.1):
    """LinearLR warmup + MultiStep decay (reference param_scheduler;
    milestones in steps). Returns ``schedule(step) -> lr``, computed in
    float64 on the host."""
    def schedule(step):
        warm = warmup_factor + (1.0 - warmup_factor) * min(
            step / max(warmup_steps, 1), 1.0)
        decay = 1.0
        for m in milestones_steps:
            decay *= gamma if step >= m else 1.0
        return base_lr * warm * decay

    return schedule


def make_pose_optimizer(params: dict, base_lr: float = 5e-4,
                        weight_decay: float = 0.1, layer_decay: float = 0.85,
                        num_layers: int = 32, clip_norm: float = 1.0,
                        schedule=None) -> optim.Transform:
    """AdamW with layer-wise lr decay (a parameter of layer l scaled by
    ``layer_decay ** (num_layers + 1 - l)``), zero decay on
    bias/norm/pos_embed, global-norm clipping: the optax chain
    clip -> adam -> decayed weights -> layer scale -> learning rate."""
    lr_scale = {k: layer_decay ** (num_layers + 1 - _pose_layer_id(k, num_layers))
                for k in params}
    decay_mask = {k: not _no_decay(k, p) for k, p in params.items()}
    return optim.chain(
        optim.clip_by_global_norm(clip_norm),
        optim.scale_by_adam(0.9, 0.999),
        optim.add_decayed_weights(weight_decay, decay_mask),
        optim.scale_by_dict(lr_scale),
        optim.scale_by_learning_rate(schedule if schedule is not None
                                     else base_lr),
    )


# --------------------------------------------------------- pose train step

def make_pose_train_step(model, optimizer):
    """``train_step(params, batch_stats, opt_state, crops, kps, visible) ->
    (params, batch_stats, opt_state, loss)`` for a ViTPose model made
    trainable. Heatmap targets are UDP-encoded on the device from pixel
    keypoints."""
    cfg = model.cfg
    input_size = (cfg.img_size[1], cfg.img_size[0])
    heatmap_size = (cfg.grid[1] * 4, cfg.grid[0] * 4)

    def train_step(params, batch_stats, opt_state, crops, kps, visible):
        target, weights = udp_encode(kps, visible, input_size, heatmap_size)
        leaves = _leaves(params)
        stats = {k: v.clone() for k, v in batch_stats.items()}
        with torch.enable_grad():
            pred = functional_call(model, {**leaves, **stats}, (crops,))
            loss = keypoint_mse_loss(pred.to(torch.float32), target, weights)
        updates, opt_state = optimizer.update(_grads(loss, leaves), opt_state,
                                              params)
        return (optim.apply_updates(params, updates), stats, opt_state,
                loss.detach())

    return train_step


# ----------------------------------------------------------- ID classifier

# reference class weights (model/id/..._finetuned.py:54-61) for classes
# ['b', 'd', 'g', 'r', 'unknown', 'w']
ID_CLASS_WEIGHTS = (5.08130081300813, 4.693818601964183,
                    11.475988700564972, 9.057971014492754,
                    0.1894734387388648, 8.708467309753484)


def label_smooth_loss(logits, labels, class_weight=None, smooth: float = 0.1):
    """mmpretrain LabelSmoothLoss (mode='original') with per-class weights:
    smoothed one-hot eps/K + (1-eps), weighted cross-entropy, mean over the
    batch."""
    K = logits.shape[-1]
    y = F.one_hot(labels.long(), K).to(torch.float32) * (1.0 - smooth) \
        + smooth / K
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    w = (torch.ones(K, device=logits.device) if class_weight is None
         else torch.as_tensor(class_weight, dtype=torch.float32,
                              device=logits.device))
    return -torch.mean(torch.sum(y * w * logp, dim=-1))


def make_id_train_step(model, optimizer, class_weight=ID_CLASS_WEIGHTS,
                       smooth: float = 0.1):
    """``train_step(params, batch_stats, opt_state, images, labels) ->
    (params, batch_stats, opt_state, loss)`` for the ResNet collar-ID
    classifier made trainable."""

    def train_step(params, batch_stats, opt_state, images, labels):
        leaves = _leaves(params)
        stats = {k: v.clone() for k, v in batch_stats.items()}
        with torch.enable_grad():
            logits = functional_call(model, {**leaves, **stats}, (images,))
            loss = label_smooth_loss(logits, labels, class_weight, smooth)
        updates, opt_state = optimizer.update(_grads(loss, leaves), opt_state,
                                              params)
        return (optim.apply_updates(params, updates), stats, opt_state,
                loss.detach())

    return train_step


# ---------------------------------------------------- detection training
#
# mmdet's MaxIoUAssigner + RandomSampler target assignment and
# sigmoid-BCE/L1 (RPN) + softmax-CE/L1 (RoI) losses
# (model/detection/SWIN-Mask_R-CNN_bbox_only.py:186-222 train_cfg,
# :137-174 rpn_head losses, :90-124 roi_head), with the JAX package's
# fixed-shape sampling masks.


def iou_matrix(a, b):
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def bbox2delta(proposals, gt, stds=(1.0, 1.0, 1.0, 1.0)):
    """DeltaXYWHBBoxCoder.encode (means 0): the inverse of ops.delta2bbox."""
    pw = (proposals[..., 2] - proposals[..., 0]).clamp_min(1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp_min(1e-6)
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    return torch.stack([(gx - px) / pw / stds[0], (gy - py) / ph / stds[1],
                        torch.log(gw / pw) / stds[2],
                        torch.log(gh / ph) / stds[3]], dim=-1)


def max_iou_assign(boxes, gt, gt_valid, pos_iou_thr: float,
                   neg_iou_thr: float, min_pos_iou: float,
                   match_low_quality: bool = True):
    """mmdet MaxIoUAssigner. Returns ``assigned`` (N,) int64: -1 negative,
    -2 ignored (between the thresholds), >= 0 the assigned gt. With
    ``match_low_quality`` every box tying a gt's best overlap (at least
    ``min_pos_iou``) goes to that gt, later gts over earlier ones (mmdet's
    per-gt loop)."""
    ious = iou_matrix(boxes, gt)
    ious = torch.where(gt_valid[None, :], ious, torch.full_like(ious, -1.0))
    max_iou = ious.amax(1)
    argmax = ious.argmax(1)
    assigned = torch.where(
        max_iou >= pos_iou_thr, argmax,
        torch.where(max_iou < neg_iou_thr, -1, -2).to(argmax.dtype))
    if match_low_quality:
        M = gt.shape[0]
        gt_best = ious.amax(0)
        is_best = ((ious == gt_best[None, :]) & (gt_best[None, :] >= min_pos_iou)
                   & gt_valid[None, :])
        last_best = (M - 1) - is_best.flip(1).to(torch.uint8).argmax(1)
        assigned = torch.where(is_best.any(1), last_best, assigned)
    return assigned


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def random_sample_masks(assigned, num: int, pos_fraction: float, key,
                        dtype: torch.dtype = torch.float32):
    """mmdet RandomSampler as fixed-shape masks: ``(pos_sampled,
    neg_sampled, avg_factor)``, up to ``num * pos_fraction`` random
    positives and ``num - n_pos`` random negatives, and how many were
    sampled. Each candidate's rank comes from ``jax.random.uniform(key,
    (n,), dtype)``, drawn bit for bit (``dtype`` is JAX's default float:
    float32, float64 with ``jax_enable_x64``)."""
    n = assigned.shape[0]
    dev = assigned.device
    pos = assigned >= 0
    neg = assigned == -1
    r = torch.from_numpy(threefry.uniform(key, (n,), _np_dtype(dtype))).to(dev)
    inf = torch.full_like(r, float("inf"))

    def rank_of(mask):
        order = torch.argsort(torch.where(mask, r, inf), stable=True)
        return torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=dev))

    pos_sampled = pos & (rank_of(pos) < int(num * pos_fraction))
    n_pos = pos_sampled.sum()
    neg_sampled = neg & (rank_of(neg) < (num - n_pos))
    avg = (pos_sampled.sum() + neg_sampled.sum()).clamp_min(1)
    return pos_sampled, neg_sampled, avg.to(torch.float32)


def rpn_loss(rpn_outs, anchors, gt_boxes, gt_valid, key,
             pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
             num_samples=256, pos_fraction=0.5,
             sample_dtype: torch.dtype = torch.float32):
    """RPN losses for ONE image: sigmoid BCE on objectness + L1 on the
    deltas of sampled positives. rpn_outs: per level ((h, w, 3) cls,
    (h, w, 12) reg); anchors: per level (h*w*3, 4)."""
    cls_flat = torch.cat([cls.reshape(-1) for cls, _ in rpn_outs])
    reg_flat = torch.cat([reg.reshape(-1, 4) for _, reg in rpn_outs])
    anc = torch.cat([torch.as_tensor(a, device=gt_boxes.device)
                     for a in anchors]).to(gt_boxes.dtype)
    assigned = max_iou_assign(anc, gt_boxes, gt_valid, pos_iou_thr,
                              neg_iou_thr, min_pos_iou, True)
    pos_s, neg_s, avg = random_sample_masks(assigned, num_samples,
                                            pos_fraction, key, sample_dtype)
    x = cls_flat.to(torch.float32)
    labels = pos_s.to(torch.float32)
    bce = -labels * F.logsigmoid(x) - (1.0 - labels) * F.logsigmoid(-x)
    loss_cls = torch.where(pos_s | neg_s, bce, 0.0).sum() / avg
    tgt = bbox2delta(anc, gt_boxes[assigned.clamp_min(0)])
    l1 = (reg_flat.to(torch.float32) - tgt).abs().sum(-1)
    loss_reg = torch.where(pos_s, l1, 0.0).sum() / avg
    return loss_cls, loss_reg


def roi_loss(cls_logits, reg, proposals, assigned, gt_boxes, key,
             num_samples=512, pos_fraction=0.25, num_classes=1,
             sample_dtype: torch.dtype = torch.float32):
    """RoI box-head losses for ONE image: softmax CE (foreground classes,
    background last) + class-specific L1 on the sampled positives.
    ``assigned`` comes from max_iou_assign on the gt-augmented
    proposals."""
    pos_s, neg_s, avg = random_sample_masks(assigned, num_samples,
                                            pos_fraction, key, sample_dtype)
    labels = torch.where(pos_s, 0, num_classes)
    logits = cls_logits.to(torch.float32)
    ce = torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]
    loss_cls = torch.where(pos_s | neg_s, ce, 0.0).sum() / avg
    tgt = bbox2delta(proposals, gt_boxes[assigned.clamp_min(0)],
                     stds=(0.1, 0.1, 0.2, 0.2))
    l1 = (reg.reshape(-1, num_classes, 4)[:, 0].to(torch.float32) - tgt
          ).abs().sum(-1)
    loss_reg = torch.where(pos_s, l1, 0.0).sum() / avg
    return loss_cls, loss_reg


def make_detection_optimizer(params: dict, lr: float = 1e-4,
                             weight_decay: float = 0.05) -> optim.Transform:
    """AdamW per the reference's AmpOptimWrapper (config :227-238), no
    decay on bias/norm parameters, global-norm clip 1.0."""
    mask = {k: not _no_decay(k, p) for k, p in params.items()}
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(lr, 0.9, 0.999, weight_decay=weight_decay, mask=mask))


def _proposals(c, rpn_img, anchors, img_shape, num_proposals):
    """The RPN's train-budget proposals for one image (no gradient):
    top ``rpn_nms_pre`` per level, decoded, level-aware NMS."""
    from macaque_tpu_torch.nn.ops import batched_nms_fixed, delta2bbox

    boxes, scores, ids = [], [], []
    for lvl, ((cls, reg), anc) in enumerate(zip(rpn_img, anchors)):
        score = torch.sigmoid(cls.reshape(-1))
        delta = reg.reshape(-1, 4)
        k = min(c.rpn_nms_pre, score.shape[0])
        top_s, top_i = torch.topk(score, k)
        boxes.append(delta2bbox(anc[top_i], delta[top_i], max_shape=img_shape))
        scores.append(top_s)
        ids.append(torch.full((k,), lvl, dtype=torch.long, device=score.device))
    pb, ps, pi = torch.cat(boxes), torch.cat(scores), torch.cat(ids)
    keep, valid = batched_nms_fixed(pb, ps, pi, c.rpn_iou_thr,
                                    min(num_proposals, pb.shape[0]))
    return pb[keep], valid


def make_detection_train_step(model, optimizer, num_proposals: int = 512,
                              sample_dtype: torch.dtype = torch.float32):
    """The detection train step on a batch of images with padded gt boxes:
    ``train_step(params, opt_state, key, images, gt_boxes, gt_valid) ->
    (params, opt_state, metrics)``. The RoI stage trains on the RPN's own
    proposals (no gradient through NMS, as mmdet) with the gt boxes
    appended (add_gt_as_proposals). ``key`` is a JAX key (two uint32,
    ``utils.threefry.prng_key``), split ``2B`` ways: the RPN sampler of
    image i takes key i, its RoI sampler key B + i. ``sample_dtype``: the
    samplers' uniform draws (see :func:`random_sample_masks`)."""
    from macaque_tpu_torch.nn.ops import make_anchors
    from macaque_tpu_torch.nn.roialign import roi_align_windowed_reference

    c = model.cfg

    def loss_fn(p, key, images, gt_boxes, gt_valid):
        B = images.shape[0]
        dev = images.device
        feats = _call(model.backbone, "backbone.", p, images)
        fpn_feats = _call(model.neck, "neck.", p, feats)
        rpn_outs = _call(model.rpn_head, "rpn_head.", p, fpn_feats)
        anchors = [torch.as_tensor(a, device=dev) for a in make_anchors(
            [(f.shape[1], f.shape[2]) for f in fpn_feats], c.strides)]
        img_shape = (images.shape[1], images.shape[2])
        keys = threefry.split(key, 2 * B)

        rpn = [rpn_loss([(cls[i], reg[i]) for cls, reg in rpn_outs], anchors,
                        gt_boxes[i], gt_valid[i], keys[i],
                        sample_dtype=sample_dtype) for i in range(B)]
        loss_rpn_cls = torch.stack([r[0] for r in rpn]).mean()
        loss_rpn_reg = torch.stack([r[1] for r in rpn]).mean()

        props_all, assigned_all = [], []
        with torch.no_grad():
            for i in range(B):
                props, pvalid = _proposals(
                    c, [(cls[i].detach(), reg[i].detach())
                        for cls, reg in rpn_outs], anchors, img_shape,
                    num_proposals)
                props = torch.cat([props, gt_boxes[i]])
                pvalid = torch.cat([pvalid, gt_valid[i]])
                assigned = max_iou_assign(props, gt_boxes[i], gt_valid[i],
                                          0.5, 0.5, 0.5, True)
                props_all.append(props)
                assigned_all.append(torch.where(pvalid, assigned, -2))
        props_all = torch.stack(props_all)                  # (B, P, 4)

        w = (props_all[..., 2] - props_all[..., 0]).clamp_min(0)
        h = (props_all[..., 3] - props_all[..., 1]).clamp_min(0)
        lvl = torch.floor(torch.log2(torch.sqrt(w * h) / c.finest_scale
                                     + 1e-6)).clamp(0, 3).long()
        roi_feats = roi_align_windowed_reference(
            [f.to(c.compute_dtype) for f in fpn_feats[:4]], props_all, lvl,
            7, c.strides)
        P = props_all.shape[1]
        cls_logits, reg = _call(
            model.roi_head.bbox_head, "roi_head.bbox_head.", p,
            roi_feats.reshape(B * P, *roi_feats.shape[2:]).to(c.compute_dtype))
        cls_logits = cls_logits.reshape(B, P, -1)
        reg = reg.reshape(B, P, -1)
        roi = [roi_loss(cls_logits[i], reg[i], props_all[i], assigned_all[i],
                        gt_boxes[i], keys[B + i], num_classes=c.num_classes,
                        sample_dtype=sample_dtype) for i in range(B)]
        loss_roi_cls = torch.stack([r[0] for r in roi]).mean()
        loss_roi_reg = torch.stack([r[1] for r in roi]).mean()
        total = loss_rpn_cls + loss_rpn_reg + loss_roi_cls + loss_roi_reg
        return total, {"loss": total, "rpn_cls": loss_rpn_cls,
                       "rpn_reg": loss_rpn_reg, "roi_cls": loss_roi_cls,
                       "roi_reg": loss_roi_reg}

    def train_step(params, opt_state, key, images, gt_boxes, gt_valid):
        leaves = _leaves(params)
        with torch.enable_grad():
            total, metrics = loss_fn(leaves, key, images, gt_boxes, gt_valid)
        updates, opt_state = optimizer.update(_grads(total, leaves), opt_state,
                                              params)
        return (optim.apply_updates(params, updates), opt_state,
                {k: v.detach() for k, v in metrics.items()})

    return train_step
