"""ViTPose at any ViT width with its heatmap head (mmpose
``td-hm_ViTPose-huge_8xb64-210e_coco-256x192``), the pose network of the
``parity`` and ``serving`` configurations.

Program: ``ViTPose`` over a ``VitPoseConfig``, with K1 (packed attention)
on the card; a block with ``int8_blocks`` has its blocks' four Linear
layers quantized by ``quantize_vitpose_`` from the seeded float32 state
dict. The perception takes the block's ``flip_test``. Reference:
``reference/nets.py::ViTPose``; the int8 blocks emulated by
``reference/lowp.py``, int4 in the control.
"""

from __future__ import annotations

from portbench.reference import lowp, nets

INIT = {}


def program(block: dict, dtype, device):
    import torch

    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig

    b = block
    return ViTPose(VitPoseConfig(
        img_size=tuple(b["img_size"]), patch_size=b["patch_size"],
        patch_padding=b["patch_padding"], embed_dim=b["embed_dim"],
        depth=b["depth"], num_heads=b["num_heads"], mlp_ratio=b["mlp_ratio"],
        num_keypoints=b["num_keypoints"],
        deconv_channels=tuple(b["deconv_channels"]), compute_dtype=dtype,
        use_pallas_attention=torch.device(device).type == "cuda"),
        device=device)


def loaded(model, block: dict, state: dict) -> None:
    from macaque_tpu_torch.nn.quant import quantize_vitpose_

    if block["int8_blocks"]:
        quantize_vitpose_(model, state)


def perception_kwargs(block: dict) -> dict:
    return {"flip_test": block["flip_test"]}


def reference(block: dict):
    return nets.frozen(nets.ViTPose(block))


def quantize(net, block: dict, lower: bool) -> None:
    if block["int8_blocks"]:
        lowp.quantize_pose_blocks_(net, "int4" if lower else "int8")


def tiny(block: dict) -> dict:
    return dict(block, img_size=[32, 24], patch_size=8, embed_dim=32, depth=2,
                num_heads=2, deconv_channels=[8, 8])
