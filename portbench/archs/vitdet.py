"""ViTDet-H Mask R-CNN, bbox only (detectron2
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_h_75ep.py``, mmdet
``projects/ViTDet`` module names), the detector of the ``vitdet``
configuration.

Program: ``pipeline/weights.py::build_detector``
("vitdet"), over a ``ViTDetConfig`` (widths, windows, head depths) and a
``DetectorConfig`` (budgets), K7 for the attention on the card; the
perception resizes keeping the ratio to fit the ``img_size`` square the
detector states and pads to it. Reference:
``reference/vitdet.py::Detector``, fed the same keep-ratio resize
zero-padded to the square.

Initialization: the relative position tables (``rel_pos_h``,
``rel_pos_w``), which no rule of ``weights.py`` covers, are drawn by its
``std02`` rule and, once a side has loaded the seeded state dict, scaled to
the block's ``rel_pos_init_std`` (0.2): the program's in ``loaded``, the
reference's by a hook on its ``load_state_dict``. At 0.02 their terms
move the logits a third as much as q.k does and a run with the program's
tables zeroed passes the check; at 0.2 they move them as much (detectron2
zero-initializes the tables for pretraining; a released model has learned
ones). The LayerNorm2d scales and shifts end in ``weight`` and ``bias`` and
take ``weights.py``'s norm rules (1 and 0), as every other norm does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.files import load_module
from portbench.reference import nets, prep

FG_BIAS = "roi_head.bbox_head.fc_cls.bias"
INIT = {"rel_pos_h": "std02", "rel_pos_w": "std02"}

_VIT = ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
        "mlp_ratio", "window", "pretrain_grid", "rpn_convs", "box_convs")
_BUDGETS = ("fpn_channels", "num_classes", "rpn_nms_pre", "rpn_iou_thr",
            "rpn_max", "rcnn_score_thr", "rcnn_iou_thr", "rcnn_max",
            "rcnn_roi_topk", "rcnn_roi_chunk")


def program(block: dict, dtype, device):
    import torch

    from macaque_tpu_torch.nn import DetectorConfig
    from macaque_tpu_torch.nn.vitdet import ViTDetConfig
    from macaque_tpu_torch.pipeline.weights import build_detector

    vit = ViTDetConfig(**{k: block[k] for k in _VIT},
                       global_blocks=tuple(block["global_blocks"]),
                       compute_dtype=dtype,
                       use_pallas_attention=torch.device(device).type == "cuda")
    det = DetectorConfig(**{k: block[k] for k in _BUDGETS}, compute_dtype=dtype)
    return build_detector("vitdet", device, dtype, config=det, vit=vit)


STD02 = 0.02     # weights.py's std02 rule


def _rel_pos_to_std(net, block: dict) -> None:
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.mul_(block["rel_pos_init_std"] / STD02)


def loaded(model, block: dict, state: dict) -> None:
    _rel_pos_to_std(model, block)


def perception_kwargs(block: dict) -> dict:
    return {}           # the detector states its square input


def reference(block: dict):
    net = nets.frozen(load_module("reference/vitdet.py").Detector(block))
    net.register_load_state_dict_post_hook(
        lambda mod, keys: _rel_pos_to_std(mod, block))
    return net


def quantize(net, block: dict, lower: bool) -> None:
    pass


def reference_input(rgb, block: dict):
    S = block["img_size"]
    x, scale = prep.detector_input(rgb, S)
    return F.pad(x, (0, 0, 0, S - x.shape[2], 0, S - x.shape[1])), scale


def input_hw(frame_hw, block: dict) -> tuple:
    return block["img_size"], block["img_size"]


def tiny(block: dict) -> dict:
    # a 4 x 4 map in 3 x 3 windows: the window blocks pad it to 6 x 6
    return dict(block, img_size=64, embed_dim=32, depth=4, num_heads=2,
                window=3, global_blocks=[1, 3], pretrain_grid=3,
                fpn_channels=16, rpn_nms_pre=200, rpn_max=50,
                rcnn_roi_topk=50, rcnn_roi_chunk=16)
