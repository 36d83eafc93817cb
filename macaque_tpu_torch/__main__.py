"""Umbrella CLI of the port: ``python -m macaque_tpu_torch <command>``.

The JAX package's ``python -m macaque_tpu`` subcommands that drive the
pipeline, with the same arguments: ``step1``, ``step2``, ``step3``,
``step4``, ``render``, ``pipeline`` and ``validate``; and the calibration's
``label-cage`` and ``calibrate`` (every ``--step``), the latter with
``--device`` last (the card when not given). Every stage runs on the card.
The calibration's ``config.yaml`` and ``.h5`` files are read with PyYAML
and h5py; ``render`` draws with cv2, and the calibration detects boards
and markers with cv2.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="macaque_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--data", default="example")
        sp.add_argument("--results", default="./results3D")
        sp.add_argument("--raw", default="./videos")
        sp.add_argument("--config", default="./calib/config.yaml")
        sp.add_argument("--redo", action="store_true")

    for name in ("step1", "step2", "step3", "step4", "render", "pipeline"):
        sp = sub.add_parser(name)
        add_common(sp)
        if name == "step1":
            sp.add_argument("--weights", default="./model")
            sp.add_argument("--fps", type=float, default=24.0)
        if name == "render":
            sp.add_argument("--cam", type=int, default=0)
            sp.add_argument("--style", choices=("v1", "v2"), default="v1")
        if name == "pipeline":
            sp.add_argument("--weights", default="./model")
            sp.add_argument("--fps", type=float, default=24.0)

    sp = sub.add_parser("validate")
    sp.add_argument("kp3d_pickle")
    sp.add_argument("gt_pickle")
    sp.add_argument("--threshold", type=float, default=400.0)

    sp = sub.add_parser(
        "label-cage", help="interactively click cage keypoints per "
        "camera (needs a display; writes cagepoints_annotation.h5)")
    sp.add_argument("config", help="path to calib config.yaml")

    sp = sub.add_parser(
        "calibrate",
        help="calibrate the rig from recorded board/marker videos "
             "(multicam_toolbox workflow)")
    sp.add_argument("config", help="path to calib config.yaml")
    sp.add_argument("--step", default="all",
                    choices=("all", "chessboard", "intrinsic",
                             "cage-extrinsic", "marker", "cube",
                             "optimize", "optimize-full", "fix"))
    sp.add_argument("--marker-mode", default="cube",
                    choices=("cube", "marker"))
    sp.add_argument("--frame-intv", type=int, default=5)
    sp.add_argument("--fps", type=float, default=24.0)
    sp.add_argument("--ref", type=int, default=0,
                    help="reference camera for the 'fix' step")
    sp.add_argument("--device", default=None,
                    help="torch device of the solvers (the card when not "
                         "given; 'cpu' for the CPU)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    from macaque_tpu_torch.cameras.rig import CameraRig
    from macaque_tpu_torch.core.config import PipelineConfig

    def rig_and_cfg():
        cfg = PipelineConfig.from_yaml(
            args.config, data_name=args.data,
            results_dir=args.results, raw_data_dir=args.raw,
        )
        return CameraRig.from_h5(args.config), cfg

    result_dir = None
    if hasattr(args, "results"):
        result_dir = os.path.join(args.results, args.data)

    if args.cmd == "step1":
        from macaque_tpu_torch.pipeline.step1 import run_step1
        from macaque_tpu_torch.pipeline.weights import build_torch_perception

        run_step1(args.data, args.results, args.raw,
                  build_torch_perception(args.weights), fps=args.fps,
                  redo=args.redo)
    elif args.cmd == "step2":
        from macaque_tpu_torch.pipeline.step2 import run_step2

        rig, cfg = rig_and_cfg()
        run_step2(result_dir, rig, cfg.cross_view, redo=args.redo)
    elif args.cmd == "step3":
        from macaque_tpu_torch.pipeline.step3 import run_step3

        rig, cfg = rig_and_cfg()
        run_step3(result_dir, rig, cfg.cross_frame, redo=args.redo)
    elif args.cmd == "step4":
        from macaque_tpu_torch.pipeline.step4 import run_step4

        rig, cfg = rig_and_cfg()
        run_step4(result_dir, rig, pipeline_cfg=cfg,
                  filter_cfg=cfg.filter, tri_cfg=cfg.triangulation,
                  redo=args.redo)
    elif args.cmd == "render":
        from macaque_tpu_torch.tools.visualize import render_overlay

        rig, cfg = rig_and_cfg()
        render_overlay(args.data, args.cam, result_dir, args.raw, rig,
                       style=args.style)
    elif args.cmd == "pipeline":
        from macaque_tpu_torch.demo import proc

        proc(args.data, args.fps, args.results, None, args.config,
             args.raw)
    elif args.cmd == "validate":
        from macaque_tpu_torch.tools.validation import validate_kp3d_file

        r = validate_kp3d_file(args.kp3d_pickle, args.gt_pickle,
                               args.threshold)
        print(r)
    elif args.cmd == "label-cage":
        from macaque_tpu_torch.calib.labeler import label_cage_keypoints

        print(label_cage_keypoints(args.config))
    elif args.cmd == "calibrate":
        from macaque_tpu_torch.calib import workflow as wf

        on = {"device": args.device}
        if args.step == "all":
            wf.calibrate_from_videos(
                args.config, marker_mode=args.marker_mode,
                frame_intv=args.frame_intv, fps=args.fps, **on)
        elif args.step == "chessboard":
            wf.analyze_chessboard_videos(args.config,
                                         frame_intv=args.frame_intv)
        elif args.step == "intrinsic":
            wf.calibrate_intrinsics_driver(args.config, **on)
        elif args.step == "cage-extrinsic":
            wf.get_extrinsics_from_cage_keypoints(args.config)
        elif args.step == "marker":
            wf.analyze_aruco_marker_videos(args.config)
        elif args.step == "cube":
            wf.analyze_aruco_cube_videos(args.config,
                                         frame_intv=args.frame_intv,
                                         fps=args.fps)
        elif args.step == "optimize":
            wf.optimize_extrinsics_driver(args.config, **on)
        elif args.step == "optimize-full":
            wf.optimize_all_camera_params_driver(args.config, **on)
        elif args.step == "fix":
            wf.fix_extrinsic_optim(args.config, ref=args.ref)


if __name__ == "__main__":
    main()
