"""Swin-S Mask R-CNN, bbox only (mmdet ``SWIN-Mask_R-CNN_bbox_only.py``),
the detector of the ``parity`` and ``serving`` configurations.

Program: ``SwinMaskRCNN`` over a ``SwinConfig``, built from the block's
widths and budgets; the perception resizes to the block's ``det_target``.
Reference: ``reference/nets.py::Detector`` (Swin + FPN + RPN + Shared2FC
box head), fed the keep-ratio resize to ``det_target`` padded to 32.
"""

from __future__ import annotations

from portbench.reference import nets, prep

FG_BIAS = "roi_head.bbox_head.fc_cls.bias"
INIT = {}


def program(block: dict, dtype, device):
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN
    from macaque_tpu_torch.nn.swin import SwinConfig

    b = block
    swin = SwinConfig(embed_dim=b["embed_dim"], depths=tuple(b["depths"]),
                      num_heads=tuple(b["num_heads"]), window=b["window"],
                      mlp_ratio=b["mlp_ratio"], patch_size=b["patch_size"],
                      compute_dtype=dtype)
    return SwinMaskRCNN(DetectorConfig(
        swin=swin, fpn_channels=b["fpn_channels"], num_classes=b["num_classes"],
        rpn_nms_pre=b["rpn_nms_pre"], rpn_iou_thr=b["rpn_iou_thr"],
        rpn_max=b["rpn_max"], rcnn_score_thr=b["rcnn_score_thr"],
        rcnn_iou_thr=b["rcnn_iou_thr"], rcnn_max=b["rcnn_max"],
        rcnn_roi_topk=b["rcnn_roi_topk"], rcnn_roi_chunk=b["rcnn_roi_chunk"],
        compute_dtype=dtype), device=device)


def loaded(model, block: dict, state: dict) -> None:
    pass


def perception_kwargs(block: dict) -> dict:
    return {"det_target": block["det_target"]}


def reference(block: dict):
    return nets.frozen(nets.Detector(block))


def quantize(net, block: dict, lower: bool) -> None:
    pass


def reference_input(rgb, block: dict):
    return prep.detector_input(rgb, block["det_target"])


def input_hw(frame_hw, block: dict, divisor: int = 32) -> tuple:
    H, W = frame_hw
    target = block["det_target"]
    s = min(target / H, target / W)
    h, w = int(round(H * s)), int(round(W * s))
    return -(-h // divisor) * divisor, -(-w // divisor) * divisor


def tiny(block: dict) -> dict:
    serving = block["rcnn_roi_topk"] < block["rpn_max"]
    return dict(block, embed_dim=8, depths=[2, 2, 2, 2], num_heads=[1, 1, 2, 2],
                fpn_channels=16, rpn_nms_pre=200, rpn_max=50,
                rcnn_roi_topk=20 if serving else 50, rcnn_roi_chunk=16,
                det_target=96)
