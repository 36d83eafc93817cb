"""Demo entry point of the port: the JAX package's ``run_demo.py``
(``proc`` and ``run_synthetic``, API-compatible with the reference's
run_demo.py:21-55) on PyTorch.

Two modes:
  * real data: point --raw at imgstore directories + --config at a
    calib/config.yaml with cam_intrinsic.h5 / cam_extrinsic_optim.h5 and
    provide converted model weights in ``$MACAQUE_TPU_WEIGHTS`` (PyYAML
    and h5py read the calibration);
  * --synthetic: generate a synthetic 4-camera recording with
    ground-truth-driven perception (no weights needed) and run the full
    pipeline on it end to end; reports 3D error vs ground truth.

Both run on the card unless ``--device cpu`` is given:

    python -m macaque_tpu_torch.demo --synthetic --root ./demo_out --device cpu
"""

from __future__ import annotations

import argparse
import os


def proc(data_name, fps, results_dir_root, device_str, config_path,
         raw_data_dir, n_kp=17, render=True):
    """Reference-compatible entry: run steps 1-4 + render for a recording
    using real calibration + converted weights (the JAX package's
    ``run_demo.proc``). ``device_str`` is the torch device every stage
    runs on (``"cuda"``, ``"cuda:1"``, ``"cpu"``; None for the card)."""
    from macaque_tpu_torch.cameras.rig import CameraRig
    from macaque_tpu_torch.core.config import PipelineConfig
    from macaque_tpu_torch.pipeline.runner import run_pipeline
    from macaque_tpu_torch.pipeline.weights import build_torch_perception

    cfg = PipelineConfig.from_yaml(
        config_path, data_name=data_name, fps=fps,
        results_dir=results_dir_root, raw_data_dir=raw_data_dir, n_kp=n_kp,
    )
    rig = CameraRig.from_h5(config_path)

    weights_dir = os.environ.get("MACAQUE_TPU_WEIGHTS", "./model")
    perception = build_torch_perception(weights_dir, device=device_str)
    return run_pipeline(cfg, rig, perception, render=render,
                        device=device_str)


def run_synthetic(root: str, n_frame: int = 120, render: bool = True,
                  device=None):
    """The weight-free demo (the JAX package's ``run_demo.run_synthetic``):
    a 4-camera, 2-animal recording rendered into FFV1 imgstores under
    ``root/videos``, then steps 1-4 with the oracle perception and the
    overlay of camera 0, on ``device`` (the card when None) in float32.
    Prints each animal's median 3D error; returns the result directory."""
    import numpy as np

    from macaque_tpu_torch.core.config import PipelineConfig
    from macaque_tpu_torch.pipeline.artifacts import read_pickle
    from macaque_tpu_torch.pipeline.runner import run_pipeline
    from macaque_tpu_torch.tools.synthetic import (
        SyntheticPerception, make_test_rig, project_scene, render_stores,
        simulate_scene,
    )

    raw = os.path.join(root, "videos")
    results = os.path.join(root, "results3D")
    rig = make_test_rig(4)
    kp3d_gt = simulate_scene(2, n_frame, seed=1)
    proj = project_scene(rig, kp3d_gt)
    if not os.path.exists(os.path.join(raw, "synth.10000")):
        print("[demo] rendering synthetic 4-camera recording...")
        render_stores(raw, "synth", rig, proj)

    def factory(cam_name):
        idx = rig.camera_ids.index(cam_name)
        return SyntheticPerception(idx, proj, noise=1.0)

    cfg = PipelineConfig(data_name="synth", results_dir=results,
                         raw_data_dir=raw)
    rd = run_pipeline(cfg, rig, factory, render=render, render_cams=[0],
                      device=device)

    out = read_pickle(os.path.join(rd, "kp3d.pickle"))
    kp3d = np.asarray(out["kp3d"])
    T = min(kp3d.shape[1], kp3d_gt.shape[1])
    for a in range(2):
        e = np.linalg.norm(kp3d[a, :T] - kp3d_gt[a, :T], axis=-1)
        print(f"[demo] animal {a}: median 3D error "
              f"{np.nanmedian(e):.2f} mm over {T} frames")
    print(f"[demo] results in {rd}")
    return rd


def parser() -> argparse.ArgumentParser:
    """``run_demo.py``'s arguments, and ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m macaque_tpu_torch.demo")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the weight-free synthetic end-to-end demo")
    ap.add_argument("--root", default="./demo_out")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--data", default="example")
    ap.add_argument("--fps", type=float, default=24.0)
    ap.add_argument("--results", default="./results3D")
    ap.add_argument("--config", default="./calib/config.yaml")
    ap.add_argument("--raw", default="./videos")
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.synthetic:
        return run_synthetic(args.root, args.frames,
                             render=not args.no_render, device=args.device)
    return proc(args.data, args.fps, args.results, args.device, args.config,
                args.raw, render=not args.no_render)


if __name__ == "__main__":
    main()
