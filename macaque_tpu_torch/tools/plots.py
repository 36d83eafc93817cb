"""Analysis plots from kp3d results (the reference's
notebooks/analysis_plots.ipynb as library functions producing PNGs):
trajectories (top-down), inter-animal proximity over time, speed
histograms, joint-length distributions.

Port of ``macaque_tpu/tools/plots.py``, the same host code; matplotlib is
imported by the functions that draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from macaque_tpu_torch.tools.analysis import (
    trajectories, pairwise_proximity, speed,
)

ANIMAL_COLORS = ["tab:blue", "tab:green", "tab:red", "tab:orange"]


def plot_trajectories(kp3d: np.ndarray, out_path: str,
                      labels: Optional[Sequence[str]] = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = trajectories(kp3d)
    fig, ax = plt.subplots(figsize=(6, 6))
    for a in range(c.shape[0]):
        if np.isfinite(c[a, :, 0]).sum() == 0:
            continue
        ax.plot(c[a, :, 0], c[a, :, 1],
                color=ANIMAL_COLORS[a % 4], lw=1,
                label=(labels[a] if labels else f"animal {a}"))
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_title("top-down trajectories")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_proximity(kp3d: np.ndarray, out_path: str, fps: float = 24.0) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = pairwise_proximity(kp3d)
    A, _, T = d.shape
    t = np.arange(T) / fps
    fig, ax = plt.subplots(figsize=(8, 4))
    for a in range(A):
        for b in range(a + 1, A):
            if np.isfinite(d[a, b]).sum() == 0:
                continue
            ax.plot(t, d[a, b], lw=0.8, label=f"{a}-{b}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("distance (mm)")
    ax.set_title("inter-animal proximity")
    ax.legend(ncol=3, fontsize=8)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_speed_hist(kp3d: np.ndarray, out_path: str,
                    fps: float = 24.0) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = speed(kp3d, fps)
    fig, ax = plt.subplots(figsize=(6, 4))
    for a in range(s.shape[0]):
        vals = s[a][np.isfinite(s[a])]
        if vals.size == 0:
            continue
        ax.hist(vals, bins=50, histtype="step",
                color=ANIMAL_COLORS[a % 4], label=f"animal {a}")
    ax.set_xlabel("speed (mm/s)")
    ax.set_ylabel("frames")
    ax.set_title("speed distribution")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_all(kp3d_pickle: str, out_dir: str, fps: float = 24.0) -> list:
    import os

    from macaque_tpu_torch.pipeline.artifacts import read_pickle

    os.makedirs(out_dir, exist_ok=True)
    kp3d = np.asarray(read_pickle(kp3d_pickle)["kp3d"])
    return [
        plot_trajectories(kp3d, os.path.join(out_dir, "trajectories.png")),
        plot_proximity(kp3d, os.path.join(out_dir, "proximity.png"), fps),
        plot_speed_hist(kp3d, os.path.join(out_dir, "speed.png"), fps),
    ]
