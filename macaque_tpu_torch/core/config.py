"""One typed configuration tree for the whole pipeline (host copy for the
PyTorch port, with the anipose ``config.toml`` writer of step 4).

The reference scatters configuration across three tiers — YAML runtime
config (calib/config.yaml), anipose TOML templates (configs/*.toml,
materialized per run by step4:101-138), and module-top Python constants
(step1:50-91, step2:21-31, step3:26-28). Here everything is one dataclass
tree with loaders for those formats, so a run is fully described by a
single object (SURVEY.md §5 'unify into one typed config tree').
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, asdict

# 17 COCO-style macaque keypoints (reference: model/pose/macaque.py:15-130,
# step4:201-204)
MACAQUE_BODYPARTS = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

# strong / weak bone-length constraints (reference: configs/config_tmpl.toml
# :66-91), as (joint_a, joint_b) name pairs
MACAQUE_CONSTRAINTS = [
    ("nose", "left_eye"), ("nose", "right_eye"), ("left_eye", "right_eye"),
    ("nose", "left_ear"), ("nose", "right_ear"),
    ("left_eye", "left_ear"), ("right_eye", "right_ear"),
    ("left_ear", "right_ear"),
    ("left_shoulder", "left_ear"), ("right_shoulder", "right_ear"),
    ("left_shoulder", "right_shoulder"), ("left_shoulder", "left_elbow"),
    ("left_elbow", "left_wrist"), ("right_shoulder", "right_elbow"),
    ("right_elbow", "right_wrist"), ("left_hip", "right_hip"),
    ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
    ("right_hip", "right_knee"), ("right_knee", "right_ankle"),
]

MACAQUE_CONSTRAINTS_WEAK = [
    ("left_shoulder", "left_hip"), ("right_shoulder", "right_hip"),
    ("left_shoulder", "right_hip"), ("right_shoulder", "left_hip"),
    ("left_shoulder", "right_shoulder"), ("left_hip", "right_hip"),
    ("left_eye", "nose"), ("right_eye", "nose"), ("left_eye", "left_ear"),
    ("right_eye", "right_ear"), ("left_ear", "right_ear"),
]

# collar classifier classes (reference: model/id/sn_resnet152_*.py:2-9);
# tracked collar colours map classes {0,2,3,5} = b,g,r,w -> animals 0..3
# (reference: step2:735, step3:841-867)
ID_CLASSES = ["b", "d", "g", "r", "unknown", "w"]
VALID_COLLAR_CLASSES = (0, 2, 3, 5)


def constraint_indices(names, bodyparts=MACAQUE_BODYPARTS):
    """Name pairs -> index pairs (reference step4 ``load_constraints``
    :32-41)."""
    idx = {b: i for i, b in enumerate(bodyparts)}
    return [[idx[a], idx[b]] for a, b in names]


@dataclass(frozen=True)
class TrackerConfig:
    """BoTSORT-equivalent tracking (reference step1:77-89)."""

    track_high_thresh: float = 0.85
    track_low_thresh: float = 0.10
    new_track_thresh: float = 0.85
    track_buffer: int = 72
    match_thresh: float = 0.80
    frame_rate: float = 24.0
    proximity_thresh: float = 0.5
    max_tracks: int = 16  # static track-table capacity on device


@dataclass(frozen=True)
class Step1Config:
    """Per-camera 2D stage (reference step1:67-91)."""

    score_thr: float = 0.85
    kp_thr: float = 0.30
    ema_alpha: float = 0.50
    disp_thr: float = 20.0
    min_margin: float = 0.20
    max_margin: float = 0.50
    desired_ar: float = 192.0 / 256.0
    id_conf_thr: float = 0.80
    max_detections: int = 8   # static per-frame detection capacity
    tracker: TrackerConfig = field(default_factory=TrackerConfig)


@dataclass(frozen=True)
class CrossViewConfig:
    """Keyframe cross-view matching (reference step2:21-31)."""

    keyframe_stride: int = 12
    thr_kp: float = 0.1
    alpha_id: float = 0.2
    cid_thr: float = 0.8
    p_thr_2dt: float = 0.8
    n_joint: int = 17
    alpha_svt: float = 0.5
    lambda_svt: float = 50.0
    dual_stochastic_svt: bool = False
    max_people: int = 4
    dist_cutoff_mm: float = 150.0
    id_vote_window: int = 24 * 5


@dataclass(frozen=True)
class CrossFrameConfig:
    """Tracklet graph stage (reference step3:26-28,41-42 + in-function
    constants)."""

    n_animal: int = 4
    vote_window: int = 120
    min_detections: int = 12
    trim_rmse_mm: float = 150.0
    stitch_window: int = 120
    id_match_cost_scale: float = 0.01
    min_tracklet_len: int = 24


@dataclass(frozen=True)
class FilterConfig:
    """2D Viterbi filter (reference step4:146-150, config_tmpl.toml:56-58)."""

    enabled: bool = True
    type: str = "viterbi"
    score_threshold: float = 0.3
    n_back: int = 3
    offset_threshold: float = 25.0


@dataclass(frozen=True)
class TriangulationConfig:
    """3D reconstruction stage (reference config_tmpl.toml:60-97)."""

    ransac: bool = False
    optim: bool = True
    scale_smooth: float = 3.0
    scale_length: float = 5.0
    scale_length_weak: float = 2.0
    reproj_error_threshold: float = 3.0
    score_threshold: float = 0.5
    n_deriv_smooth: int = 2


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level run description (replaces run_demo.py:21-39 args +
    calib/config.yaml)."""

    data_name: str = "example"
    fps: float = 24.0
    n_kp: int = 17
    results_dir: str = "./results3D"
    raw_data_dir: str = "./videos"
    calib_config: str = "./calib/config.yaml"
    camera_ids: tuple = ()
    img_size: tuple = (2048, 1536)
    step1: Step1Config = field(default_factory=Step1Config)
    cross_view: CrossViewConfig = field(default_factory=CrossViewConfig)
    cross_frame: CrossFrameConfig = field(default_factory=CrossFrameConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)

    @staticmethod
    def from_yaml(calib_config_path: str, **overrides) -> "PipelineConfig":
        import yaml

        with open(calib_config_path) as f:
            cfg = yaml.safe_load(f)
        kw = dict(
            calib_config=calib_config_path,
            camera_ids=tuple(str(c) for c in cfg.get("camera_id", ())),
        )
        if "img_size" in cfg:
            kw["img_size"] = tuple(int(v) for v in cfg["img_size"])
        kw.update(overrides)
        return PipelineConfig(**kw)

    def constraints(self):
        return constraint_indices(MACAQUE_CONSTRAINTS)

    def constraints_weak(self):
        return constraint_indices(MACAQUE_CONSTRAINTS_WEAK)

    def to_anipose_config_toml(self, path: str) -> None:
        """Materialize an anipose-compatible config.toml (what step4 writes
        from configs/config_tmpl.toml; reference step4:101-104)."""
        from macaque_tpu_torch.utils.tomlwriter import dump_toml

        doc = {
            "project": self.data_name,
            "model_folder": os.path.abspath(self.results_dir),
            "nesting": 1,
            "video_extension": "mp4",
            "filter": {
                "enabled": self.filter.enabled,
                "type": self.filter.type,
                "score_threshold": self.filter.score_threshold,
                "n_back": self.filter.n_back,
                "offset_threshold": self.filter.offset_threshold,
                "multiprocessing": False,
            },
            "triangulation": {
                "triangulate": True,
                "ransac": self.triangulation.ransac,
                "optim": self.triangulation.optim,
                "constraints": [list(c) for c in MACAQUE_CONSTRAINTS],
                "constraints_weak": [list(c) for c in MACAQUE_CONSTRAINTS_WEAK],
                "scale_smooth": self.triangulation.scale_smooth,
                "scale_length": self.triangulation.scale_length,
                "scale_length_weak": self.triangulation.scale_length_weak,
                "reproj_error_threshold": self.triangulation.reproj_error_threshold,
                "score_threshold": self.triangulation.score_threshold,
                "n_deriv_smooth": self.triangulation.n_deriv_smooth,
            },
        }
        dump_toml(doc, path)

    def asdict(self) -> dict:
        return asdict(self)
