"""Umbrella CLI of the port: ``python -m macaque_tpu_torch <command>``.

All 34 of the JAX package's ``python -m macaque_tpu`` subcommands, with
the same arguments: the pipeline's ``step1``, ``step2``, ``step3``,
``step4``, ``render``, ``pipeline`` and ``validate``; the analysis'
``angles`` and ``plots``; the 2D tools' ``pose2d`` and ``eval-coco``,
``convert-weights`` and the tracker ``sweep``; the anipose session tools
(``triangulate-session``, ``calibrate-session``, ``filter-2d``,
``filter-3d``, ``train-autoencoder``, ``project-2d``, ``summarize``,
``session-angles``, ``tracking-errors``, ``label-videos``, ``label-3d``,
``label-proj``, ``label-combined``, ``label-filter-compare``,
``convert-videos``, ``calibration-errors``, ``extract-frames``,
``pose-videos`` and ``report``); and the calibration's ``label-cage`` and
``calibrate`` (every ``--step``). The subcommands whose work reaches a
tensor take ``--device`` last (the card when not given; ``cpu`` for the
CPU). Every stage runs on the card.
The calibration's ``config.yaml`` and ``.h5`` files are read with PyYAML
and h5py; ``render``, the session tools' videos and the calibration's
board and marker detection use cv2; the session tools' tables use pandas
and h5py, their plots matplotlib; ``pose2d`` and ``eval-coco`` read their
videos and images with cv2.
"""

from __future__ import annotations

import argparse
import os

# the session subcommands in the JAX CLI's order, and those whose work
# reaches a tensor (they take ``--device``)
SESSION_COMMANDS = (
    "triangulate-session", "project-2d", "label-videos", "session-angles",
    "tracking-errors", "label-3d", "label-proj", "label-combined",
    "convert-videos", "calibration-errors", "report", "filter-2d",
    "filter-3d", "train-autoencoder", "label-filter-compare",
    "calibrate-session")
ON_DEVICE = ("triangulate-session", "project-2d", "tracking-errors",
             "calibration-errors", "filter-2d", "train-autoencoder",
             "calibrate-session", "extract-frames", "pose-videos")


def _cpu_detector():
    from macaque_tpu_torch.nn import DetectorConfig, SwinMaskRCNN

    return SwinMaskRCNN(DetectorConfig(), device="cpu")


def _cpu_pose():
    from macaque_tpu_torch.nn import ViTPose, VitPoseConfig

    return ViTPose(VitPoseConfig(), device="cpu")


def _cpu_id():
    from macaque_tpu_torch.nn import ResNetClassifier, ResNetConfig

    return ResNetClassifier(ResNetConfig(), device="cpu")


# ``convert-weights``: the JAX CLI's four checkpoints, each with the
# float32 CPU module its state dict loads into
CONVERT_JOBS = (
    ("detection/detection.pth", _cpu_detector),
    ("pose/pose.pth", _cpu_pose),
    ("id/id_finetuned.pth", _cpu_id),
    ("id/id_mff1y.pth", _cpu_id),
)


def add_device(sp, what="work"):
    sp.add_argument("--device", default=None,
                    help=f"torch device of the {what} (the card when not "
                         "given; 'cpu' for the CPU)")


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
        if name != "render":
            add_device(sp, "stage")

    sp = sub.add_parser("validate")
    sp.add_argument("kp3d_pickle")
    sp.add_argument("gt_pickle")
    sp.add_argument("--threshold", type=float, default=400.0)

    sp = sub.add_parser("angles")
    sp.add_argument("kp3d_pickle")
    sp.add_argument("--out", default="angles.npz")

    sp = sub.add_parser("plots")
    sp.add_argument("kp3d_pickle")
    sp.add_argument("--out", default="./plots")
    sp.add_argument("--fps", type=float, default=24.0)

    sp = sub.add_parser(
        "pose2d", help="2D-only detect+pose skeleton overlay on a plain "
        "video (reference run_2D notebook). NOTE: no tracking/ID — "
        "boxes are per-frame; use `step1` for the tracked 2D pipeline")
    sp.add_argument("video")
    sp.add_argument("--out", default="pose2d.mp4")
    sp.add_argument("--weights", default=None,
                    help="converted weights dir (default "
                    "$MACAQUE_TPU_WEIGHTS)")
    sp.add_argument("--det-thr", type=float, default=0.85)
    sp.add_argument("--max-frames", type=int, default=None)
    add_device(sp, "networks")

    sp = sub.add_parser(
        "eval-coco", help="COCO-dataset detector/pose AP eval "
        "(det_pose_optim notebook flow)")
    sp.add_argument("--ann", required=True,
                    help="COCO annotation json")
    sp.add_argument("--images", required=True, help="images dir")
    sp.add_argument("--weights", default=None)
    sp.add_argument("--det-thr", type=float, default=0.85)
    sp.add_argument("--max-images", type=int, default=None)
    add_device(sp, "networks")

    sp = sub.add_parser("convert-weights")
    sp.add_argument("--weights", default="./model",
                    help="dir with detection/pose/id .pth checkpoints")
    sp.add_argument("--cache", default="./model/cache")

    # anipose-style session workflows (project config.toml driven)
    for name in SESSION_COMMANDS:
        sp = sub.add_parser(name)
        sp.add_argument("--config", default="config.toml",
                        help="anipose project config.toml")
        if name == "tracking-errors":
            sp.add_argument("--labeled", default="labeled-data")
        if name == "report":
            sp.add_argument("--out", default=None,
                            help="report output dir (default "
                            "<project>/report)")
        if name in ON_DEVICE:
            add_device(sp)

    sp = sub.add_parser(
        "extract-frames", help="mine worst/best/random frames for "
        "relabeling (anipose extract_frames)")
    sp.add_argument("--config", default="config.toml")
    sp.add_argument("--mode", default="bad",
                    choices=("bad", "good", "random"))
    sp.add_argument("--num", type=int, default=250)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--spacing", type=int, default=10,
                    help="min frames between picks of one video")
    add_device(sp, "reprojections")

    sp = sub.add_parser(
        "pose-videos", help="run the 2D pose stack over raw session "
        "videos missing pose-2d files (anipose pose_videos)")
    sp.add_argument("--config", default="config.toml")
    sp.add_argument("--weights", default=None)
    add_device(sp, "networks")

    sp = sub.add_parser(
        "sweep", help="tracker hyperparameter sweep on the synthetic "
                      "scene (tracking_evaluation notebook harness)")
    sp.add_argument("--out", default="./results3D_sweep")
    sp.add_argument("--frames", type=int, default=96)
    sp.add_argument("--cams", type=int, default=4)
    add_device(sp, "steps 2-4")

    sp = sub.add_parser("summarize")
    sp.add_argument("what", choices=("pose3d", "pose3d-filtered",
                                     "pose2d", "pose2d-filtered",
                                     "angles", "errors"))
    sp.add_argument("--config", default="config.toml")

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
    add_device(sp, "solvers")
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
                  build_torch_perception(args.weights, args.device),
                  fps=args.fps, redo=args.redo)
    elif args.cmd == "step2":
        from macaque_tpu_torch.pipeline.step2 import run_step2

        rig, cfg = rig_and_cfg()
        run_step2(result_dir, rig, cfg.cross_view, redo=args.redo,
                  device=args.device)
    elif args.cmd == "step3":
        from macaque_tpu_torch.pipeline.step3 import run_step3

        rig, cfg = rig_and_cfg()
        run_step3(result_dir, rig, cfg.cross_frame, redo=args.redo,
                  device=args.device)
    elif args.cmd == "step4":
        from macaque_tpu_torch.pipeline.step4 import run_step4

        rig, cfg = rig_and_cfg()
        run_step4(result_dir, rig, pipeline_cfg=cfg,
                  filter_cfg=cfg.filter, tri_cfg=cfg.triangulation,
                  redo=args.redo, device=args.device)
    elif args.cmd == "render":
        from macaque_tpu_torch.tools.visualize import render_overlay

        rig, cfg = rig_and_cfg()
        render_overlay(args.data, args.cam, result_dir, args.raw, rig,
                       style=args.style)
    elif args.cmd == "pipeline":
        from macaque_tpu_torch.demo import proc

        proc(args.data, args.fps, args.results, args.device, args.config,
             args.raw)
    elif args.cmd == "validate":
        from macaque_tpu_torch.tools.validation import validate_kp3d_file

        r = validate_kp3d_file(args.kp3d_pickle, args.gt_pickle,
                               args.threshold)
        print(r)
    elif args.cmd == "angles":
        import numpy as np

        from macaque_tpu_torch.pipeline.artifacts import read_pickle
        from macaque_tpu_torch.tools.angles import compute_angles

        kp3d = np.asarray(read_pickle(args.kp3d_pickle)["kp3d"])
        np.savez(args.out, **compute_angles(kp3d))
        print(f"wrote {args.out}")
    elif args.cmd == "plots":
        from macaque_tpu_torch.tools.plots import plot_all

        for p in plot_all(args.kp3d_pickle, args.out, args.fps):
            print(f"wrote {p}")
    elif args.cmd == "pose2d":
        from macaque_tpu_torch.pipeline.weights import build_torch_perception
        from macaque_tpu_torch.tools.run2d import render_2d_video

        weights = args.weights or os.environ.get("MACAQUE_TPU_WEIGHTS",
                                                 "./model")
        out = render_2d_video(args.video, args.out,
                              build_torch_perception(weights, args.device),
                              det_thr=args.det_thr,
                              max_frames=args.max_frames)
        print(out)
    elif args.cmd == "eval-coco":
        import json

        from macaque_tpu_torch.pipeline.weights import build_torch_perception
        from macaque_tpu_torch.tools.coco_eval import run_coco_eval

        weights = args.weights or os.environ.get("MACAQUE_TPU_WEIGHTS",
                                                 "./model")
        res = run_coco_eval(build_torch_perception(weights, args.device),
                            args.images, args.ann, det_thr=args.det_thr,
                            max_images=args.max_images)
        print(json.dumps(res))
    elif args.cmd == "convert-weights":
        convert_weights(args.weights, args.cache)
    elif args.cmd == "sweep":
        from macaque_tpu_torch.tools.sweep import (
            rank_sweep, run_synthetic_sweep)

        log = run_synthetic_sweep(args.out, n_frame=args.frames,
                                  n_cam=args.cams, device=args.device)
        print(f"wrote {log}")
        for row in rank_sweep(log):
            print(row)
    elif args.cmd in SESSION_COMMANDS + ("extract-frames", "pose-videos",
                                         "summarize"):
        for files in session_command(args).values():
            for f in files or ():
                print(f"wrote {f}")
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


def convert_weights(weights_dir: str, cache_dir: str) -> None:
    """``convert-weights``: each checkpoint of ``CONVERT_JOBS`` that exists
    under ``weights_dir`` is loaded into its float32 CPU module (every
    parameter must be present; unconsumed keys are reported) and the
    module's state dict is cached as ``<cache_dir>/<name>.pt``."""
    from macaque_tpu_torch.nn.checkpoint import convert_and_cache
    from macaque_tpu_torch.pipeline.weights import load_checkpoint

    def converter(make, path):
        def convert(state_dict):
            model = make()
            load_checkpoint(model, path, state_dict)
            return model.state_dict()
        return convert

    for rel, make in CONVERT_JOBS:
        p = os.path.join(weights_dir, rel)
        if os.path.exists(p):
            convert_and_cache(p, converter(make, p), cache_dir)
            print(f"converted {rel}")
        else:
            print(f"missing {rel} (skipped)")


def session_command(args) -> dict:
    """One session subcommand: {session folders: files written}."""
    from macaque_tpu_torch.tools import session as ses
    from macaque_tpu_torch.tools import session_extras as sx

    config = ses.load_session_config(args.config)
    on = {"device": args.device} if args.cmd in ON_DEVICE else {}
    if args.cmd == "triangulate-session":
        return ses.triangulate_all(config, **on)
    if args.cmd == "filter-2d":
        return ses.filter_pose_2d_all(config, **on)
    if args.cmd == "filter-3d":
        return ses.filter_pose_3d_all(config)
    if args.cmd == "train-autoencoder":
        return {(): [ses.train_autoencoder_project(config, **on)]}
    if args.cmd == "label-filter-compare":
        return sx.label_filter_compare_all(config)
    if args.cmd == "calibrate-session":
        return {k: ([v] if v else [])
                for k, v in ses.calibrate_all(config, **on).items()}
    if args.cmd == "project-2d":
        return ses.project_2d_all(config, **on)
    if args.cmd == "label-videos":
        return ses.label_videos_all(config)
    if args.cmd == "session-angles":
        return ses.angles_all(config)
    if args.cmd == "label-3d":
        return sx.label_videos_3d_all(config)
    if args.cmd == "label-proj":
        return sx.label_videos_proj_all(config)
    if args.cmd == "label-combined":
        return sx.label_combined_all(config)
    if args.cmd == "convert-videos":
        return sx.convert_videos_all(config)
    if args.cmd == "calibration-errors":
        return sx.calibration_errors_all(config, **on)
    if args.cmd == "extract-frames":
        return {(): sx.extract_frames(config, mode=args.mode,
                                      num_frames_pick=args.num,
                                      seed=args.seed, spacing=args.spacing,
                                      **on)}
    if args.cmd == "pose-videos":
        from macaque_tpu_torch.pipeline.weights import build_torch_perception

        weights = args.weights or os.environ.get("MACAQUE_TPU_WEIGHTS",
                                                 "./model")
        return sx.pose_videos_all(config,
                                  build_torch_perception(weights, **on))
    if args.cmd == "report":
        from macaque_tpu_torch.tools.report import generate_report

        return {(): [generate_report(config, args.out)]}
    if args.cmd == "tracking-errors":
        return {(): [ses.get_tracking_errors(config, labeled_dir=args.labeled,
                                             **on)]}
    fn = {
        "pose3d": ses.summarize_pose3d,
        "pose3d-filtered": ses.summarize_pose3d_filtered,
        "pose2d": ses.summarize_pose2d,
        "pose2d-filtered": ses.summarize_pose2d_filtered,
        "angles": ses.summarize_angles,
        "errors": ses.summarize_errors,
    }[args.what]
    return {(): [fn(config)]}


if __name__ == "__main__":
    main()
