"""Top-level pipeline orchestration (the run_demo.py equivalent).

Port of ``macaque_tpu/pipeline/runner.py``: ``run_pipeline`` chains steps
1-4 + rendering with the same resumable artifact protocol as the
reference (run_demo.py:21-39), the same stage names and the same
``run_manifest.json``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from macaque_tpu_torch.cameras.rig import CameraRig
from macaque_tpu_torch.core.config import PipelineConfig
from macaque_tpu_torch.core.mesh import home_device
from macaque_tpu_torch.core.trace import StageTimes


def run_pipeline(
    config: PipelineConfig,
    rig: CameraRig,
    perception,
    render: bool = True,
    render_cams: Optional[list[int]] = None,
    redo: bool = False,
    mesh=None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> str:
    """Run detect/track/pose/ID -> cross-view -> cross-frame -> 3D ->
    render for one recording. Returns the result directory.

    ``perception`` is a backend or a per-camera factory (step 1 runs on
    whatever device it was built for). Steps 2-4 and the overlay's
    reprojection run on ``device`` (the card when None; without one the
    call raises before step 1 unless ``device="cpu"``) in ``dtype``. The
    render's drawing and encoding need cv2. ``mesh``
    (``core/mesh.py``) runs every device batch of steps 2-4 sharded over
    its devices, the cameras replicated (``device`` defaults to its first
    entry); a ``TorchPerception`` for a mesh is built with the same mesh
    (the reference's scale-out is one process per GPU,
    info_replication.md:14)."""
    from macaque_tpu_torch.pipeline.step1 import run_step1
    from macaque_tpu_torch.pipeline.step2 import run_step2
    from macaque_tpu_torch.pipeline.step3 import run_step3
    from macaque_tpu_torch.pipeline.step4 import run_step4

    dev = home_device(mesh, device)
    result_dir = os.path.join(config.results_dir, config.data_name)
    timer = StageTimes()
    on = {"device": dev, "dtype": dtype}
    steps = {**on, "mesh": mesh}

    with timer.stage("step1_2d"):
        run_step1(
            config.data_name, config.results_dir, config.raw_data_dir,
            perception, fps=config.fps, cfg=config.step1, redo=redo,
        )
    with timer.stage("step2_crossview"):
        run_step2(result_dir, rig, config.cross_view, redo=redo, **steps)
    with timer.stage("step3_crossframe"):
        run_step3(result_dir, rig, config.cross_frame, fps=config.fps,
                  redo=redo, **steps)
    with timer.stage("step4_3d"):
        run_step4(
            result_dir, rig, pipeline_cfg=config,
            filter_cfg=config.filter, tri_cfg=config.triangulation,
            redo=redo, **steps,
        )

    if render:
        from macaque_tpu_torch.tools.visualize import render_overlay

        cams = list(render_cams if render_cams is not None
                    else range(rig.n_cam))
        with timer.stage("render"):
            # per-camera renders are independent and dominated by cv2
            # drawing + video encode (GIL-releasing C calls), so threads
            # overlap them, one per core up to 4; the reference renders
            # cameras sequentially (run_demo.py:37-39)
            with ThreadPoolExecutor(max_workers=max(1, min(
                    4, len(cams), os.cpu_count() or 1))) as ex:
                list(ex.map(
                    lambda i_cam: render_overlay(
                        config.data_name, i_cam, result_dir,
                        config.raw_data_dir, rig, fps=config.fps, **on,
                    ),
                    cams,
                ))

    timer.dump(os.path.join(result_dir, "run_manifest.json"))
    return result_dir
