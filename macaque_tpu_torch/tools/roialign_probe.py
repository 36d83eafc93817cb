"""On-card probe: the windowed RoIAlign (K2) on the serving detector.

Port of ``macaque_tpu/tools/roialign_probe.py``. The JAX probe asks
whether chunking the RoIs (its per-chunk adaptive window buckets) pays at
serving scale; here the detector's RoI head runs K2 on each chunk of
``rcnn_roi_chunk`` bucket-sorted RoIs, so the probe times the whole
detect call of the ``serving`` detector (or the tier in
``ROI_PROBE_TIER``) on 16 frames of 800x608 at ``rcnn_roi_chunk`` in
{128, 64, 32} (or the chunks given), random weights from seed 0.

Each variant is timed with CUDA events over ``iters`` calls after one
warm call, in place of the JAX probe's difference of a long and a short
``fori_loop``; each JSON line also carries the K2 launches of one call.

Run: ``python -m macaque_tpu_torch.tools.roialign_probe [chunks...]
[--device cpu]``. Prints one JSON line per variant; diagnostics to
stderr. It runs on the card and raises on any other device.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from macaque_tpu_torch.tools.int8_probe import card, event_ms, log
from macaque_tpu_torch.tools.pipeline_bench import device_name


def main(argv=None):
    from macaque_tpu_torch import kernels
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN
    from macaque_tpu_torch.nn.detector import detect_frames
    from macaque_tpu_torch.nn.preprocess import normalize_rgb
    from macaque_tpu_torch.nn.swin import SwinConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("chunks", nargs="*", type=int)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = card(args.device)
    tier = os.environ.get("ROI_PROBE_TIER", "serving")
    chunks = args.chunks or [128, 64, 32]
    B, H, W = 16, 800, 608
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = torch.randint(0, 255, (B, H, W, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    imgs = normalize_rgb(frames)
    log(f"device: {device_name(dev)}  B={B}")
    state = None
    out = []
    for rc in chunks:
        cfg_cls = (DetectorConfig if tier == "parity"
                   else DetectorConfig.serving)
        torch.manual_seed(0)
        model = SwinMaskRCNN(cfg_cls(swin=SwinConfig(compute_dtype=bf16),
                                     compute_dtype=bf16, rcnn_roi_chunk=rc),
                             device=dev)
        # one set of weights for every chunk size
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)

        @torch.no_grad()
        def call(model=model):
            return detect_frames(model, imgs)

        call()
        before = kernels.LAUNCHES["roi_align_windowed"]
        call()
        launches = kernels.LAUNCHES["roi_align_windowed"] - before
        ms = event_ms(call, args.iters)
        log(f"{tier} rc={rc}: {ms:.1f} ms/chunk, K2 x{launches}")
        line = {"tier": tier, "rcnn_roi_chunk": rc,
                "ms_per_chunk": round(ms, 2),
                "route": "cuda: K2 (roi_align_windowed) in detect_frames",
                "k2_launches": launches}
        print(json.dumps(line), flush=True)
        out.append(line)
        del model
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
