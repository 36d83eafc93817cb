"""Checkpoints of converted weights and training state, with torch.save.

The counterpart of ``macaque_tpu/nn/checkpoint.py``, which keeps Orbax
checkpoints. The port cannot read those without orbax (which it does not
import), so its checkpoints are ``torch.save`` files of state dicts,
optimizer states (nested dicts, tuples and tensors) or anything else
``torch.load`` reads back, and its conversion cache is a ``.pt`` file
beside the JAX package's ``.orbax`` directory.
"""

from __future__ import annotations

import os

import torch


def save_params(path: str, variables) -> str:
    """Write ``variables`` (a state dict, an optimizer state, or a tuple of
    them) to ``path``, atomically; returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(variables, tmp)
    os.replace(tmp, path)
    return path


def load_params(path: str, like=None, map_location="cpu"):
    """Read a checkpoint. With ``like`` (a module, or a dict of tensors of
    the same names) the loaded tensors take its devices and dtypes: a module
    is loaded in place (every parameter must be present) and returned."""
    variables = torch.load(os.path.abspath(path), map_location=map_location,
                           weights_only=False)
    if like is None:
        return variables
    if isinstance(like, torch.nn.Module):
        like.load_state_dict(variables, strict=True)
        return like
    if set(like) != set(variables):
        raise KeyError(f"{path}: names differ from the template's: "
                       f"{sorted(set(like) ^ set(variables))[:5]}")
    return {k: v.to(device=like[k].device, dtype=like[k].dtype)
            for k, v in variables.items()}


def convert_and_cache(pth_path: str, converter, cache_dir: str):
    """Convert a .pth once (``converter`` maps its state dict to the
    variables to keep) and cache the result as ``<name>.pt``; later calls
    load the cache."""
    name = os.path.splitext(os.path.basename(pth_path))[0]
    out = os.path.join(os.path.abspath(cache_dir), name + ".pt")
    if os.path.exists(out):
        return load_params(out)
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    variables = converter(ckpt.get("state_dict", ckpt)
                          if isinstance(ckpt, dict) else ckpt)
    save_params(out, variables)
    return variables
