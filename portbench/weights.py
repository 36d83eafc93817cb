"""Seeded float32 state dicts, made on the device in one random call per
network, under the released checkpoints' (mm) keys.

The keys and shapes come from the reference network that the block's
architecture file builds, on the meta device; the values follow
PyTorch's default initialization, which the program's modules also use:
Linear and convolution weights and biases uniform in +-1/sqrt(fan_in),
norm scales 1 and shifts 0, the Swin relative position table and the ViT
position embedding at a standard deviation of 0.02, BatchNorm statistics
0 and 1. A key that these rules do not cover takes the rule of the
architecture file's ``INIT`` for the first suffix it ends with; those
rules add to these and never change them. The program and the reference
load the same dict; the program casts it to its own types.
"""

from __future__ import annotations

import math

import torch

from portbench import files

SALT = {"detector": 1, "pose": 2, "classifier": 3}


def _net_seed(seed: int, kind: str) -> int:
    return (int(seed) * 0x9E3779B1 + SALT[kind]) % (1 << 62)


def seeded_state(kind: str, cfg: dict, seed: int, device, net=None) -> dict:
    """The float32 state dict of network ``kind`` (its role: detector,
    pose or classifier) for ``seed``; ``cfg`` is its block, whose
    architecture file gives the reference and any further rules. ``net``,
    a module, gives the keys and shapes in place of that reference."""
    arch = files.arch(cfg)
    if net is None:
        with torch.device("meta"):
            net = arch.reference(cfg)
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    kinds = {k: _kind(k, s, shapes, arch.INIT) for k, s in shapes.items()}
    params = [k for k in shapes if kinds[k] in ("uniform", "std02")]
    total = sum(math.prod(shapes[k]) for k in params)
    gen = torch.Generator(device=device)
    gen.manual_seed(_net_seed(seed, kind))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    sd, off = {}, 0
    for k, shape in shapes.items():
        kind_k = kinds[k]
        if kind_k in ("uniform", "std02"):
            n = math.prod(shape)
            bound = (0.02 * math.sqrt(3.0) if kind_k == "std02"
                     else 1.0 / math.sqrt(_fan_in(k, shapes)))
            sd[k] = flat[off:off + n].view(shape).mul_(bound)
            off += n
        elif kind_k == "ones":
            sd[k] = torch.ones(shape, device=device)
        elif kind_k == "count":
            sd[k] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            sd[k] = torch.zeros(shape, device=device)
    return sd


def _fan_in(key: str, shapes: dict) -> int:
    w = shapes[key if key.endswith("weight") else key[:-4] + "weight"]
    return math.prod(w[1:])


# the rules an architecture file may give (uniform needs a weight's fan-in)
ARCH_RULES = ("std02", "ones", "zeros")


def _kind(key: str, shape, shapes: dict, init: dict) -> str:
    if key.endswith("num_batches_tracked"):
        return "count"
    if key.endswith("running_var"):
        return "ones"
    if key.endswith("running_mean"):
        return "zeros"
    if key.endswith(("relative_position_bias_table", "pos_embed")):
        return "std02"
    if key.endswith("weight"):
        return "uniform" if len(shape) >= 2 else "ones"
    if key.endswith("bias"):
        w = shapes.get(key[:-4] + "weight")
        return "uniform" if w is not None and len(w) >= 2 else "zeros"
    for suffix, rule in init.items():
        if key.endswith(suffix):
            if rule not in ARCH_RULES:
                raise ValueError(f"{key}: no initialization rule {rule!r}")
            return rule
    raise KeyError(f"no initialization rule for {key}")
