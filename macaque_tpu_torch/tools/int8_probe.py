"""On-card probe: the dynamic-quant int8 matmul routes of the port.

Port of ``macaque_tpu/tools/int8_probe.py``. Measures the four ViT-huge
block Dense shapes (qkv/proj/fc1/fc2 at the 64-crop pose chunk's
M = 64*192 = 12288 rows) under the JAX probe's four variants, each JSON
line carrying its JAX name and a ``route`` saying what runs here:

  * ``xla``    -> the library route: the quantize ops, ``torch._int_mm``
                  (cuBLASLt int8), the float32 epilogue;
  * ``pallas`` -> K5b (``nn/int8.py::quant_int8_matmul``: the row
                  quantizer and the int8 GEMM in one C call);
  * ``split``  -> K5a (``quantize_rows``), then ``torch._int_mm`` and the
                  epilogue (``quant_int8_matmul_split``);
  * ``static`` -> ``torch._int_mm`` on codes quantized beforehand (no
                  quantize cost at all: the dynamic routes' floor);

plus the full int8 flip-test pose chunk of 64 crops (ViTPose-huge, random
weights from seed 0, its int8 layers quantized from the float32 ones)
with ``Int8Linear`` on the ``xla`` (library) and ``pallas`` (K5b) routes.

Each variant is timed with CUDA events over ``iters`` calls after one
warm call, in place of the JAX probe's difference of a long and a short
``fori_loop`` (which cancels a remote device's dispatch cost; a local
card has none to cancel).

Run: ``python -m macaque_tpu_torch.tools.int8_probe [micro|model|all]
[--shapes qkv,...] [--device cpu]``. Prints one JSON line per measurement
to stdout; diagnostics to stderr. It runs on the card; on the CPU
(``--device cpu``) every route is its plain version and there is no
int8 route to time, so it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from unittest import mock

import torch

from macaque_tpu_torch.core.device import resolve_device
from macaque_tpu_torch.tools.pipeline_bench import device_name

M_ROWS = 12288
SHAPES = {"qkv": (1280, 3840), "proj": (1280, 1280),
          "fc1": (1280, 5120), "fc2": (5120, 1280)}
ROUTES = {
    "xla": "library: quantize ops + torch._int_mm + epilogue",
    "pallas": "cuda: K5b (quant_int8_matmul)",
    "split": "cuda: K5a (quantize_rows) + torch._int_mm + epilogue",
    "static": "library: torch._int_mm on codes quantized beforehand",
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card(device) -> torch.device:
    """The probe's device: it times the card's routes and raises on any
    other device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"this probe times the card's kernels and library calls; on "
            f"{dev} every route is its plain version: run it on the card")
    return dev


def event_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm call, CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def library_matmul(x, wq, ws, bias=None):
    """The same function as K5b from PyTorch calls."""
    from macaque_tpu_torch.nn.int8 import (
        int_mm_epilogue, quantize_rows_reference)

    lead, K = x.shape[:-1], x.shape[-1]
    xq, s = quantize_rows_reference(x.reshape(-1, K))
    out = int_mm_epilogue(xq, s, wq, ws, bias, x.dtype)
    return out.reshape(*lead, wq.shape[0])


def micro_variants(x, wq, ws):
    """The four variants' calls on one layer's operands."""
    from macaque_tpu_torch.nn.int8 import (
        quant_int8_matmul, quant_int8_matmul_split)

    xq = torch.clamp(torch.round(x.float()), -127, 127).to(torch.int8)

    def static():
        acc = torch._int_mm(xq, wq.T)
        return (acc.to(torch.float32) * ws).to(torch.bfloat16)

    return {
        "xla": lambda: library_matmul(x, wq, ws),
        "pallas": lambda: quant_int8_matmul(x, wq, ws),
        "split": lambda: quant_int8_matmul_split(x, wq, ws),
        "static": static,
    }


def run_micro(dev, shapes=tuple(SHAPES), variants=tuple(ROUTES),
              iters: int = 50) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for sname in shapes:
        K, N = SHAPES[sname]
        x = torch.randn((M_ROWS, K), generator=gen, device=dev).to(
            torch.bfloat16)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(N, generator=gen, device=dev) * 9e-3 + 1e-3
        flops = 2.0 * M_ROWS * K * N
        calls = micro_variants(x, wq, ws)
        for vname in variants:
            ms = event_ms(calls[vname], iters)
            log(f"{sname}/{vname}: {ms:.3f} ms/call")
            line = {"probe": "int8_micro", "shape": sname, "variant": vname,
                    "route": ROUTES[vname], "ms": round(ms, 4),
                    "tflops": round(flops / (ms * 1e-3) / 1e12, 1)}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def run_model(dev, variants=("xla", "pallas"), iters: int = 3) -> list[dict]:
    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig, quant
    from macaque_tpu_torch.nn.heatmap import flip_heatmaps, udp_decode
    from macaque_tpu_torch.nn.quant import quantize_vitpose_

    B = 64
    torch.manual_seed(0)
    sd = ViTPose(VitPoseConfig(), device=dev).state_dict()
    model = ViTPose(VitPoseConfig(compute_dtype=torch.bfloat16,
                                  use_pallas_attention=True), device=dev)
    model.load_state_dict(sd)
    quantize_vitpose_(model, sd)
    del sd
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    crops = torch.randn((B, 256, 192, 3), generator=gen, device=dev)

    @torch.no_grad()
    def chunk():
        hm = model(crops).float()
        hm_f = model(crops.flip(2)).float()
        hm = 0.5 * (hm + flip_heatmaps(hm_f))
        return udp_decode(hm)

    def library_layer(x, wq, ws, bias=None, out_bias=None):
        out = library_matmul(x, wq, ws, bias)
        return out if out_bias is None else out + out_bias.to(out.dtype)

    out = []
    for impl in variants:
        with (mock.patch.object(quant, "quant_int8_matmul", library_layer)
              if impl == "xla" else contextlib.nullcontext()):
            ms = event_ms(chunk, iters)
        log(f"pose_int8/{impl}: {ms:.1f} ms/chunk")
        line = {"probe": "int8_pose_chunk", "variant": impl,
                "route": ROUTES[impl], "ms_per_chunk": round(ms, 1)}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", nargs="?", default="all",
                    choices=("micro", "model", "all"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variants", default=",".join(ROUTES))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = card(args.device)
    log(f"device: {device_name(dev)}")
    variants = args.variants.split(",")
    out = []
    if args.what in ("micro", "all"):
        out += run_micro(dev, args.shapes.split(","), variants)
    if args.what in ("model", "all"):
        out += run_model(dev, [v for v in variants if v in ("xla", "pallas")])
    return out


if __name__ == "__main__":
    main()
