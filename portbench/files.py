"""Where the benchmark finds its files: each configuration, traffic mix,
per-layer metric, kernel bound and limit by its name in ``BENCHMARK.json``,
and each network's architecture by the ``arch_file`` that its block in the
configuration names, under this folder."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def use_checkout_caches() -> None:
    """Point the program's kernel build (and Triton's cache) at fixed
    directories inside the checkout, so that only a checkout's first run
    builds. Call before importing the program."""
    os.environ["MACAQUE_TPU_TORCH_BUILD"] = os.path.join(HERE, ".cache", "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")


def load_json(rel: str) -> dict:
    with open(os.path.join(HERE, rel)) as f:
        return json.load(f)


def load_module(rel: str):
    """The Python file ``rel`` under this folder, loaded by path: names
    such as ``metrics/device.idle_share.py`` need not be identifiers."""
    path = os.path.join(HERE, rel)
    spec = importlib.util.spec_from_file_location(
        "portbench_" + rel.replace("/", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch(block: dict):
    """The architecture file that a configuration's network block names
    under ``arch_file`` (relative to this folder); a block without one is
    an error. Every such file gives, for its network and block:

    * ``program(block, dtype, device)``: the port's module, built through
      the port's public constructors (the port is imported inside);
      ``loaded(model, block, state)``: any step after the seeded float32
      state dict is loaded, such as quantizing; ``perception_kwargs(block)``:
      the keyword arguments the network gives ``TorchPerception``;
    * ``reference(block)``: the plain float32 reference module, in
      evaluation mode, from ``reference/``; ``quantize(net, block, lower)``:
      the reference's own quantized layers, and with ``lower`` the
      control's step below them (the check then puts every other layer in
      fp8);
    * ``INIT``: initialization rules by key suffix, consulted by
      ``weights.seeded_state`` for keys that its own rules do not cover;
    * ``tiny(block)``: the block cut for the CPU tests;
    * for the detector: ``FG_BIAS``, the state-dict key of the box head's
      class bias (index 0 the foreground); ``reference_input(rgb, block)``,
      the reference's padded normalized input and its scale from (B, H, W,
      3) RGB; ``input_hw(frame_hw, block)``, the padded input's shape, which
      the operation counts read.
    """
    if "arch_file" not in block:
        raise KeyError(f"the network block {block.get('arch', block)!r} "
                       "names no arch_file")
    return load_module(block["arch_file"])


def bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, spec: dict) -> dict:
    """The workload ``name`` of ``spec`` (``BENCHMARK.json``) with its
    configuration, mix, limits and the metrics it reports."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_file = {c["name"]: c for c in spec["configs"]}[w["config"]]["file"]
    return assemble(name, cfg_file, w["traffic"], spec, w)


def assemble(name: str, cfg_file: str, traffic: str, spec: dict,
             workload: dict | None = None) -> dict:
    """A cell from its files: {"workload", "config", "mix", "limits",
    "end_to_end", "per_layer"}; ``cfg_file`` is relative to the checkout,
    the mix and limits are found by name under this folder."""
    config = load_json(os.path.relpath(os.path.join(ROOT, cfg_file), HERE))
    mix = load_json(f"mixes/{traffic}.json")

    def listed(m):
        return name in m.get("workloads", [name])

    limits_path = os.path.join(HERE, "limits", f"{name}.json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    # a limit that the configuration states: its box-head NMS keeps no two
    # detections of a frame that overlap by more than its threshold. The
    # program decides in float32 on boxes it then rescales; 1e-6 covers that
    # rounding, which is about 1e-7 of an IoU.
    limits.setdefault("det_nms_iou",
                      config["networks"]["detector"]["rcnn_iou_thr"] + 1e-6)
    return {"workload": workload or {"name": name, "chips": 1},
            "config": config, "mix": mix, "limits": limits,
            "end_to_end": [m for m in spec["end_to_end"] if listed(m)],
            "per_layer": [m for m in spec["per_layer"] if listed(m)]}
