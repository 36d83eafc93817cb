"""On-card probe: the Swin trunk's sub-batching.

Port of ``macaque_tpu/tools/trunk_probe.py``. Times the Swin-S trunk
(``nn/swin.py::SwinBackbone``, bf16, random weights from seed 0) on one
16-frame 800x608 detector chunk as ``mapN``: the chunk in sub-batches of
N images, one after another (``map16`` is the production detector's
schedule, ``nn/detector.py::detect_frames``, which runs the trunk once over
whatever chunk its caller passes; ``map1`` is the frame-by-frame trunk).

The JAX probe's ``remat`` variant (``jax.checkpoint`` on the B=16 trunk,
to bound XLA's buffer liveness) has no counterpart here: eager
inference without a backward keeps no activations for rematerialization
to trade, so asking for it raises with that reason.

Each variant is timed with CUDA events over ``iters`` calls after one
warm call, in place of the JAX probe's difference of a long and a short
``fori_loop``.

Run: ``python -m macaque_tpu_torch.tools.trunk_probe [variants...]
[--device cpu]``. Prints one JSON line per variant; diagnostics on
stderr. It runs on the card and raises on any other device.
"""

from __future__ import annotations

import argparse
import json

import torch

from macaque_tpu_torch.tools.int8_probe import card, event_ms, log
from macaque_tpu_torch.tools.pipeline_bench import device_name

REMAT = ("trunk_probe: 'remat' (jax.checkpoint on the B=16 trunk) has no "
         "counterpart in the port: eager inference without a backward "
         "keeps no activations for rematerialization to trade")


def sub_batch(variant: str, B: int = 16) -> int:
    """``mapN`` -> N; ``remat`` and anything else raise."""
    if variant == "remat":
        raise NotImplementedError(REMAT)
    if not variant.startswith("map") or not variant[3:].isdigit():
        raise ValueError(f"unknown variant {variant!r} (mapN or remat)")
    n = int(variant[3:])
    if n < 1 or B % n:
        raise ValueError(f"{variant}: N must divide the chunk's {B} images")
    return n


def main(argv=None):
    from macaque_tpu_torch.nn.swin import SwinBackbone, SwinConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    variants = args.variants or ["map1", "map2", "map4", "map8"]
    B, H, W = 16, 800, 608
    subs = [sub_batch(v, B) for v in variants]
    dev = card(args.device)

    torch.manual_seed(0)
    model = SwinBackbone(SwinConfig(compute_dtype=torch.bfloat16), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = torch.randn((B, H, W, 3), generator=gen, device=dev)
    log(f"device: {device_name(dev)}  chunk B={B} {H}x{W}")
    out = []
    for v, n in zip(variants, subs):
        @torch.no_grad()
        def call(n=n):
            outs = [model(frames[i:i + n]) for i in range(0, B, n)]
            return sum(o.float().sum() for maps in outs for o in maps)

        ms = event_ms(call, args.iters)
        log(f"{v}: {ms:.1f} ms/chunk ({ms / B:.2f} ms/img)")
        line = {"variant": v, "ms_per_chunk": round(ms, 2),
                "ms_per_img": round(ms / B, 3),
                "route": f"torch: nn.swin.SwinBackbone, {n} image(s) a call"}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
