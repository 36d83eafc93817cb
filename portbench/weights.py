"""Seeded float32 state dicts, made on the device in one random call per
network, under the released checkpoints' (mm) keys.

The keys and shapes come from the reference networks, built on the meta
device; the values follow PyTorch's default initialization, which the
program's modules also use: Linear and convolution weights and biases
uniform in +-1/sqrt(fan_in), norm scales 1 and shifts 0, the Swin
relative position table and the ViT position embedding at a standard
deviation of 0.02, BatchNorm statistics 0 and 1. The program and the
reference load the same dict; the program casts it to its own types.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import nets

SALT = {"detector": 1, "pose": 2, "classifier": 3}


def _net_seed(seed: int, kind: str) -> int:
    return (int(seed) * 0x9E3779B1 + SALT[kind]) % (1 << 62)


def seeded_state(kind: str, cfg: dict, seed: int, device) -> dict:
    """The float32 state dict of network ``kind`` for ``seed``."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in nets.build(kind, cfg).state_dict().items()}
    params = [k for k, s in shapes.items() if _kind(k, s, shapes) == "uniform"
              or _kind(k, s, shapes) == "std02"]
    total = sum(math.prod(shapes[k]) for k in params)
    gen = torch.Generator(device=device)
    gen.manual_seed(_net_seed(seed, kind))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    sd, off = {}, 0
    for k, shape in shapes.items():
        kind_k = _kind(k, shape, shapes)
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


def _kind(key: str, shape, shapes: dict) -> str:
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
    raise KeyError(f"no initialization rule for {key}")
