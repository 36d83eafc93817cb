"""NaN-aware temporal smoothing primitives on tensors.

Port of ``macaque_tpu/filters/smoothing.py``: replacements for
``interpolate_data`` / ``medfilt_data`` (reference:
src/third_party/aniposelib/cameras.py:129-145) and the per-track EMA
keypoint smoothing of step1 (reference: src/pipeline/step1_proc2d.py:
319-342). Each works along one time axis and batches over the others.
"""

from __future__ import annotations

import numpy as np
import torch


def median(x: torch.Tensor, dim: int = -1, ignore_nan: bool = False):
    """``jnp.median`` / ``jnp.nanmedian`` along ``dim``: the mean of the two
    middle values for an even count (``torch.median`` takes the lower one).
    Without ``ignore_nan`` a NaN anywhere gives NaN; with it, NaNs are
    left out and an all-NaN slice gives NaN."""
    x = x.movedim(dim, -1)
    s = torch.sort(x, dim=-1).values  # NaN sorts last
    nan = torch.isnan(x)
    n = (~nan).sum(-1) if ignore_nan else torch.full(
        x.shape[:-1], x.shape[-1], device=x.device)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    a = s.gather(-1, lo[..., None])[..., 0]
    b = s.gather(-1, hi[..., None])[..., 0]
    out = (a + b) / 2
    bad = (n == 0) if ignore_nan else nan.any(-1)
    return torch.where(bad, torch.nan, out)


def interpolate_nan(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Linearly interpolate NaN runs along ``dim`` (np.interp semantics:
    ends are extended with the nearest valid value); an all-NaN series
    gives zeros (reference: cameras.py:138-145). The JAX package's forward
    and backward scans (last / next valid value and index) are a running
    max / min of the valid indices here."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    idx = torch.arange(n, device=x.device).reshape(-1, *[1] * (x.dim() - 1))
    valid = ~torch.isnan(x)
    fi = torch.cummax(torch.where(valid, idx, -1), dim=0).values
    bi = torch.flip(torch.cummin(torch.flip(
        torch.where(valid, idx, n), [0]), dim=0).values, [0])
    has_prev = fi >= 0
    has_next = bi < n
    fv = torch.where(has_prev, x.gather(0, torch.clamp(fi, min=0)), torch.nan)
    bv = torch.where(has_next, x.gather(0, torch.clamp(bi, max=n - 1)),
                     torch.nan)
    span = bi - fi
    t = torch.where(span > 0, (idx - fi).to(x.dtype)
                    / torch.clamp(span, min=1).to(x.dtype), 0.0)
    interp = fv + t * (bv - fv)
    out = torch.where(valid, x, torch.where(
        has_prev & has_next, interp,
        torch.where(has_prev, fv, torch.where(has_next, bv, 0.0))))
    out = torch.where(valid.any(0, keepdim=True), out, torch.zeros_like(x))
    return out.movedim(0, dim)


def median_filter_1d(x: torch.Tensor, size: int = 7, dim: int = 0):
    """Median filter along ``dim`` with reflect padding (reference:
    cameras.py:129-133 semantics within the cropped region)."""
    x = x.movedim(dim, 0)
    n, half = x.shape[0], size // 2
    src = np.pad(np.arange(n), (half, half), mode="reflect")
    win = np.arange(n)[:, None] + np.arange(size)[None, :]
    idx = torch.as_tensor(src[win].reshape(-1), device=x.device)
    windows = x[idx].reshape(n, size, *x.shape[1:])
    return median(windows, dim=1).movedim(0, dim)


def filter_pose_medfilt_2d(
    points,
    kernel_size: int = 13,
    offset_threshold: float = 25.0,
    score_threshold: float = 0.05,
    spline: bool = True,
):
    """anipose's medfilt 2D pose filter (reference:
    src/third_party/anipose/filter_pose.py:213-261), assembled from the
    same steps: per-joint median filter of candidate 0, outlier removal
    by median-offset and score thresholds, then gap interpolation
    (cubic interpolating spline, or linear when ``spline=False``) for
    joints missing in <50% of frames with >5 valid samples.

    A host-side data-cleaning utility (the pipeline filters with the
    Viterbi pass in filters/viterbi.py); it runs once per session on
    small arrays, so it is plain NumPy.

    points: (F, J, P, 3) [x, y, score] candidate array.
    Returns (points (F, J, 2) — NaN where removed and not interpolable,
    scores (F, J)).
    """
    points = np.asarray(points, float)
    F, J, P, _ = points.shape
    out = np.full((F, J, 2), np.nan)
    half = kernel_size // 2

    def medfilt_zero(x):
        # scipy.signal.medfilt semantics: ZERO padding at the edges
        xp = np.concatenate([np.zeros(half), x, np.zeros(half)])
        win = np.lib.stride_tricks.sliding_window_view(xp, kernel_size)
        return np.median(win, axis=-1)

    for j in range(J):
        x = points[:, j, 0, 0]
        y = points[:, j, 0, 1]
        score = points[:, j, 0, 2]
        err = np.abs(x - medfilt_zero(x)) + np.abs(y - medfilt_zero(y))
        bad = (err >= offset_threshold) | (score < score_threshold)
        Xf = np.stack([x, y], axis=1)
        Xf[bad] = np.nan
        for i in range(2):
            vals = Xf[:, i].copy()
            nans = np.isnan(vals)
            ix = np.flatnonzero(~nans)
            if nans.sum() > 0 and (~nans).mean() > 0.5 and len(ix) > 5:
                if spline:
                    from scipy.interpolate import splev, splrep

                    tck = splrep(ix, vals[ix], k=3, s=0)
                    vals[nans] = splev(np.flatnonzero(nans), tck)
                else:
                    vals[nans] = np.interp(
                        np.flatnonzero(nans), ix, vals[ix])
            out[:, j, i] = vals
    return out, points[:, :, 0, 2]


def ema_smooth(
    kp: torch.Tensor,
    alpha: float = 0.5,
    disp_thr: float = 20.0,
) -> torch.Tensor:
    """Per-joint EMA over time with a displacement gate.

    kp: (T, J, 3) [x, y, score] (more leading joint axes batch too); NaN
    x/y marks missing joints. Where both previous (smoothed) and current
    are valid and the raw displacement is under ``disp_thr``, blend
    ``alpha * prev + (1 - alpha) * current``; otherwise pass through
    (reference step1_proc2d.py:319-342: the "previous" frame is the
    previous *smoothed* output). A loop over frames.
    """
    xy = kp[..., :2]
    out = [xy[0]]
    for t in range(1, xy.shape[0]):
        prev, cur = out[-1], xy[t]
        valid_both = ~(torch.isnan(prev[..., 0]) | torch.isnan(cur[..., 0]))
        disp = torch.linalg.vector_norm(torch.nan_to_num(cur - prev), dim=-1)
        blend = valid_both & (disp < disp_thr)
        out.append(torch.where(blend[..., None],
                               alpha * prev + (1 - alpha) * cur, cur))
    return torch.cat([torch.stack(out), kp[..., 2:]], dim=-1)
