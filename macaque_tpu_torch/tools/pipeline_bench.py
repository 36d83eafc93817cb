"""Full-pipeline wall-clock benchmark on the synthetic 4-camera scene.

Port of ``macaque_tpu/tools/pipeline_bench.py``. It measures what the
kernel checks do not: steps 2-4, the host-side graph logic, video decode
and rendering, the same work as the reference's ~30-min/1-min-demo figure
(info_replication.md:44-45).

Protocol: generate a synthetic recording, run the whole pipeline once to
warm every cache (cuDNN's and cuBLAS's set-up, the kernel library's load),
then re-run all stages on fresh output directories and report the
per-stage wall clock. Step 1 runs with the oracle perception, so its time
here is the host cost of step 1 (video decode, tracking, EMA,
serialization). On the card, step 1 is then timed again with the
full-width networks (random weights from seed 0) in the three serving
tiers: ``parity``, ``serving`` and ``fast``.

The recording is written as FFV1 stores where cv2 is installed and as
RGBA stores (written and read without cv2) where it is not; the render
needs cv2 and raises without it (pass ``render=False``/``--no-render``).

Run as ``python -m macaque_tpu_torch.tools.pipeline_bench``; prints one
JSON object on stdout. ``device`` holds the card's name and power limit
as nvidia-smi reports them (``cpu`` on the CPU).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

from macaque_tpu_torch.core.device import resolve_device

TIERS = ("parity", "serving", "fast")


def tier_settings(tier: str = "serving") -> dict:
    """What a tier sets (the JAX tool's ``_build_random_fullsize_perception``,
    ARCHITECTURE.md §3b): ``parity`` = the exact-mmdet detector budgets and
    a bf16 flip-test pose; ``serving`` = the 512/128 detector budgets and an
    int8 pose; ``fast`` = the serving detector at a 640 input target and a
    single-pass int8 pose."""
    from macaque_tpu_torch.nn import DetectorConfig
    from macaque_tpu_torch.nn.swin import SwinConfig

    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}: one of {TIERS}")
    bf16 = torch.bfloat16
    det_cfg_cls = (DetectorConfig if tier == "parity"
                   else DetectorConfig.serving)
    return {
        "detector": det_cfg_cls(swin=SwinConfig(compute_dtype=bf16),
                                compute_dtype=bf16),
        "int8_pose": tier != "parity",
        "flip_test": tier != "fast",
        "det_target": 640 if tier == "fast" else 800,
        "max_det": 4,
    }


def _build_random_fullsize_perception(tier: str = "serving", device=None):
    """Full-width ``TorchPerception`` of ``tier`` with random weights from
    seed 0: the same work and time as converted weights, without shipping
    checkpoints. The int8 pose is quantized from the float32 weights, as a
    checkpoint supplies them. Random box-head weights score nothing near
    step 1's 0.85 threshold, which would skip pose and ID (and their
    kernels): the foreground bias is raised, as ``chip_smoke.py`` does."""
    from macaque_tpu_torch.nn import (
        ResNetClassifier, ResNetConfig, SwinMaskRCNN, ViTPose, VitPoseConfig)
    from macaque_tpu_torch.nn.quant import quantize_vitpose_
    from macaque_tpu_torch.pipeline.perception import TorchPerception

    dev = resolve_device(device)
    st = tier_settings(tier)
    bf16 = torch.bfloat16
    torch.manual_seed(0)
    det = SwinMaskRCNN(st["detector"], device=dev)
    pose_sd = ViTPose(VitPoseConfig(), device=dev).state_dict()
    pose = ViTPose(VitPoseConfig(compute_dtype=bf16,
                                 use_pallas_attention=True), device=dev)
    pose.load_state_dict(pose_sd)
    if st["int8_pose"]:
        quantize_vitpose_(pose, pose_sd)
    del pose_sd
    idm = ResNetClassifier(ResNetConfig(compute_dtype=bf16), device=dev)
    with torch.no_grad():
        det.roi_head.bbox_head.fc_cls.bias[0] += 6.0
    return TorchPerception(det, pose, idm, max_det=st["max_det"],
                           det_target=st["det_target"], device=dev,
                           flip_test=st["flip_test"])


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or torch.cuda.get_device_name(index)


def run(n_frame: int = 120, n_cam: int = 4, render: bool = True,
        root: str | None = None, device=None) -> dict:
    """Both passes and, on the card, the real tiers; returns the JSON
    object. ``device``: the card when None, ``"cpu"`` for the CPU."""
    from macaque_tpu_torch.pipeline.step1 import run_step1
    from macaque_tpu_torch.pipeline.step2 import run_step2
    from macaque_tpu_torch.pipeline.step3 import run_step3
    from macaque_tpu_torch.pipeline.step4 import run_step4
    from macaque_tpu_torch.tools.synthetic import (
        SyntheticPerception, make_test_rig, project_scene, render_stores,
        simulate_scene)

    dev = resolve_device(device)
    try:
        import cv2  # noqa: F401
        fourcc = "FFV1"
    except ImportError as e:
        if render:
            raise RuntimeError(
                "pipeline_bench: render=True draws the overlay with cv2, "
                "which is not installed; pass render=False (--no-render)"
            ) from e
        fourcc = "RGBA"

    tmp = root or tempfile.mkdtemp(prefix="macaque_bench_")
    raw = os.path.join(tmp, "videos")
    rig = make_test_rig(n_cam)
    kp3d_gt = simulate_scene(2, n_frame, seed=1)
    proj = project_scene(rig, kp3d_gt)
    render_stores(raw, "synth", rig, proj, fourcc=fourcc)

    def factory(cam_name):
        idx = rig.camera_ids.index(cam_name)
        return SyntheticPerception(idx, proj, noise=1.0, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_pass(tag):
        from macaque_tpu_torch.tools.visualize import render_overlay

        results = os.path.join(tmp, f"results_{tag}")
        rd = os.path.join(results, "synth")
        stages = {}
        t0 = time.time()
        run_step1("synth", results, raw, factory)
        stages["step1_host"] = time.time() - t0
        t0 = time.time()
        run_step2(rd, rig, device=dev)
        sync()
        stages["step2_crossview"] = time.time() - t0
        t0 = time.time()
        run_step3(rd, rig, device=dev)
        sync()
        stages["step3_crossframe"] = time.time() - t0
        t0 = time.time()
        run_step4(rd, rig, device=dev)
        sync()
        stages["step4_3d"] = time.time() - t0
        if render:
            t0 = time.time()
            # all cameras, threaded like the production runner
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=max(1, min(
                    4, n_cam, os.cpu_count() or 1))) as ex:
                list(ex.map(
                    lambda i: render_overlay("synth", i, rd, raw, rig,
                                             device=dev),
                    range(n_cam),
                ))
            stages["render"] = time.time() - t0
        return stages

    one_pass("warmup")          # warm every cache once
    stages = one_pass("timed")  # measured pass, fresh artifact dirs

    # context for the stage timings: one host<->device round trip (a tiny
    # op and its read back). Measured BEFORE the real tiers so it can gate
    # them.
    x = torch.zeros((), device=dev)
    (x + 1.0).item()
    t0 = time.time()
    for i in range(3):
        (x + float(i)).item()
    null_fetch_s = (time.time() - t0) / 3

    # ---- step 1 with the full-width networks (random weights: the same
    # work and time as converted weights), measuring the decode-ahead
    # overlap: decode of chunk N+1 runs under the device time of chunk N
    # (pipeline/step1.py), so step 1's wall ~= max(decode, device) +
    # assembly, not their sum. Only on the card, as the JAX tool runs them
    # only off its CPU backend. BENCH_STEP1_REAL=1/0 forces them on/off
    # ("auto": when a round trip is local, under 5 ms).
    step1_real_s = None
    step1_fast_s = None
    step1_parity_s = None
    real_mode = os.environ.get("BENCH_STEP1_REAL", "auto")
    do_real = (real_mode == "1"
               or (real_mode == "auto" and null_fetch_s < 0.005))
    if do_real and dev.type != "cpu":
        def _timed_step1(tier, label):
            """Warm pass then timed pass; returns the TIMED duration only
            (the warm pass pays every set-up and is never reported). A
            failure propagates, so that a tier that failed cannot read as
            one that was not asked for."""
            perc = _build_random_fullsize_perception(tier, dev)
            try:
                for tag in (f"{label}_warm", f"{label}_timed"):
                    results = os.path.join(tmp, f"results_{tag}")
                    sync()
                    t0 = time.time()
                    run_step1("synth", results, raw,
                              lambda cam: perc, chunk=16)
                    sync()
                return time.time() - t0
            finally:
                perc = None
                torch.cuda.empty_cache()

        step1_real_s = _timed_step1("serving", "real")
        if (step1_real_s is not None
                and os.environ.get("BENCH_STEP1_PARITY", "1") == "1"):
            # parity tier: exact-mmdet detector + bf16 flip-test pose in
            # the overlapped step-1 path
            step1_parity_s = _timed_step1("parity", "parity")
        if (step1_real_s is not None
                and os.environ.get("BENCH_STEP1_FAST", "1") == "1"):
            # fast tier: 640-target detector + single-pass int8 pose
            step1_fast_s = _timed_step1("fast", "fast")

    n_cf = n_cam * n_frame
    total = sum(stages.values())
    out = {
        "camera_frames": n_cf,
        "stages_s": {k: round(v, 3) for k, v in stages.items()},
        "pipeline_rest_s": round(total, 3),
        "pipeline_rest_s_per_cf": round(total / n_cf, 5),
        "pipeline_cf_s": round(n_cf / total, 2),
        "device_round_trip_s": round(null_fetch_s, 3),
        "device": device_name(dev),
    }
    if step1_real_s is not None:
        # measured end to end: real step 1 (decode overlapped with device
        # inference, serving tier) + the host stages 2-4 + render
        rest = total - stages["step1_host"]
        out["step1_real_s"] = round(step1_real_s, 3)
        out["e2e_measured_s"] = round(step1_real_s + rest, 3)
        out["e2e_measured_cf_s"] = round(n_cf / (step1_real_s + rest), 2)
        if step1_parity_s is not None:
            out["step1_parity_s"] = round(step1_parity_s, 3)
            out["e2e_parity_cf_s"] = round(
                n_cf / (step1_parity_s + rest), 2)
        if step1_fast_s is not None:
            out["step1_fast_s"] = round(step1_fast_s, 3)
            out["e2e_fast_cf_s"] = round(n_cf / (step1_fast_s + rest), 2)
    if root is None:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None):
    import argparse

    # no compile cache to set up: the kernel library is built once into
    # macaque_tpu_torch/_build/, keyed by a hash of its sources
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int,
                    default=int(os.environ.get("BENCH_PIPE_FRAMES", 120)))
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the card otherwise)")
    args = ap.parse_args(argv)
    out = run(args.frames, args.cams, render=not args.no_render,
              device="cpu" if args.cpu else None)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
