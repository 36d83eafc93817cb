"""A tiny cell for the CPU tests: the real cell's files, with every width
and size cut so that a run takes seconds on the CPU; each network's cut is
its architecture file's ``tiny``."""

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
    cfg["networks"] = {role: files.arch(block).tiny(block)
                       for role, block in cfg["networks"].items()}
    cfg["max_det"] = 2
    mix = dict(cell["mix"], segment_frames=4, chunk=2, frame_hw=[64, 96])
    cell.update(config=cfg, mix=mix)
    return cell
