"""A tiny cell for the CPU tests: the real cell's files, with every width
and size cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import files  # noqa: E402


def tiny_cell(name: str = "parity.occupied", root: str = ROOT) -> dict:
    """The cell ``name`` of the benchmark at ``root``, or, for a cell it
    does not hold, one assembled from the configuration and mix files its
    name gives (``<config>.<mix>``)."""
    spec = files.bench(root)
    if name in {w["name"] for w in spec["workloads"]}:
        cell = files.cell(name, spec)
    else:
        config, mix = name.split(".")
        cell = files.assemble(name, f"portbench/configs/{config}.json", mix, spec)
    cfg = copy.deepcopy(cell["config"])
    n = cfg["networks"]
    serving = n["detector"]["rcnn_roi_topk"] < n["detector"]["rpn_max"]
    n["detector"].update(embed_dim=8, depths=[2, 2, 2, 2], num_heads=[1, 1, 2, 2],
                         fpn_channels=16, rpn_nms_pre=200, rpn_max=50,
                         rcnn_roi_topk=20 if serving else 50, rcnn_roi_chunk=16,
                         det_target=96)
    n["pose"].update(img_size=[32, 24], patch_size=8, embed_dim=32, depth=2,
                     num_heads=2, deconv_channels=[8, 8])
    n["classifier"].update(depth=50)
    cfg["max_det"] = 2
    mix = dict(cell["mix"], segment_frames=4, chunk=2, frame_hw=[64, 96])
    cell.update(config=cfg, mix=mix)
    return cell
