"""IBL session ETL: spike binning, behavior interpolation, trial alignment,
whisker-pad ROI geometry.

The port's own copy of ``video_spike_tpu/data/ibl.py`` (numpy on the
host, as there). Algorithmic parity with
``reference:src/utils/ibl_data_utils.py``:

- ``create_intervals`` (``:246-254``): contiguous fixed-length intervals;
- ``bin_spikes`` (``get_spike_data_per_interval`` ``:256-322``): per-interval
  (n_clusters, n_bins) spike-count rasters at ``binsize`` (20 ms), with the
  bin edges [t_beg, t_beg+binsize, ...) — vectorized with a single
  ``np.add.at`` scatter instead of the reference's multiprocessing pool;
- ``interp_behavior`` (``get_behavior_per_interval`` ``:606-742``): linear
  interpolation of a session-wide signal onto ``freq * interval_len`` points
  ``linspace(t_beg + binsize, t_end, n_bins)``, with the reference's
  good-interval criteria (no NaNs, data covers the interval within one bin);
- ``align_spike_behavior`` (``:903-932``): drop trials missing any behavior
  (the reference's ``and`` of list masks keeps only the last mask — a Python
  truthiness bug; here the masks are AND-ed elementwise, strictly stricter);
  min-max normalize wheel-speed / whisker-motion-energy across the session;
- ``get_dlc_midpoint`` / ``whisker_pad_roi`` (``:1003-1047``): likelihood
  thresholding at 0.9 and the nose/pupil anchor geometry (w=d/2, h=d/3,
  x=anchor_x-d/4, y=anchor_y);
- ``active_neuron_mask``: avg firing rate > threshold filter
  (``reference:src/prepare_data.py:107-110``).

The ONE-api network loaders live behind :func:`load_one_session`; everything
else is pure so the ETL runs end-to-end on synthetic raw sessions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def create_intervals(start_time: float, end_time: float,
                     interval_len: float) -> np.ndarray:
    begs = np.arange(start_time, end_time - interval_len, interval_len)
    ends = np.arange(start_time + interval_len, end_time, interval_len)
    return np.c_[begs, ends]


def bin_spikes(times: np.ndarray, clusters: np.ndarray,
               intervals: np.ndarray, binsize: float = 0.02,
               interval_len: Optional[float] = None,
               n_clusters: Optional[int] = None) -> np.ndarray:
    """(n_intervals, n_clusters, n_bins) spike counts.

    `clusters` must already be dense indices in [0, n_clusters); remap with
    ``np.unique(..., return_inverse=True)`` first if they are raw ids.
    """
    times = np.asarray(times)
    clusters = np.asarray(clusters)
    begs, ends = intervals[:, 0], intervals[:, 1]
    if interval_len is None:
        interval_len = float(ends[0] - begs[0])
    n_bins = int(np.ceil(interval_len / binsize))
    if n_clusters is None:
        n_clusters = int(clusters.max()) + 1
    n_intervals = len(begs)

    out = np.zeros((n_intervals, n_clusters, n_bins), dtype=np.float32)
    order = np.argsort(times)
    times, clusters = times[order], clusters[order]
    i0 = np.searchsorted(times, begs, side="left")
    i1 = np.searchsorted(times, ends, side="left")
    for k in range(n_intervals):
        t = times[i0[k]:i1[k]]
        c = clusters[i0[k]:i1[k]]
        if len(t) == 0:
            continue
        b = np.minimum(((t - begs[k]) / binsize).astype(np.int64), n_bins - 1)
        np.add.at(out[k], (c, b), 1.0)
    return out


def _interp_extrap(x: np.ndarray, xp: np.ndarray, fp: np.ndarray
                   ) -> np.ndarray:
    """Linear interpolation with linear edge extrapolation (scipy
    ``interp1d(fill_value='extrapolate')`` semantics, used by the reference)."""
    y = np.interp(x, xp, fp)
    if len(xp) >= 2:
        lo = x < xp[0]
        hi = x > xp[-1]
        if lo.any():
            slope = (fp[1] - fp[0]) / (xp[1] - xp[0])
            y[lo] = fp[0] + slope * (x[lo] - xp[0])
        if hi.any():
            slope = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
            y[hi] = fp[-1] + slope * (x[hi] - xp[-1])
    return y


def interp_behavior(target_times: np.ndarray, target_vals: np.ndarray,
                    intervals: np.ndarray, freq: int = 60,
                    allow_nans: bool = False
                    ) -> Tuple[List, List, np.ndarray]:
    """Resample a session-wide behavior signal into per-interval arrays.

    Returns (times_list, vals_list, good_mask); bad intervals get None
    entries, matching the reference's contract.
    """
    target_times = np.asarray(target_times)
    target_vals = np.asarray(target_vals)
    begs, ends = intervals[:, 0], intervals[:, 1]
    interval_len = float(ends[0] - begs[0])
    n_bins = int(freq * interval_len)
    binsize = interval_len / n_bins

    idxs_beg = np.searchsorted(target_times, begs, side="right")
    idxs_end = np.searchsorted(target_times, ends, side="left")

    times_list: List = [None] * len(begs)
    vals_list: List = [None] * len(begs)
    good = np.zeros(len(begs), dtype=bool)
    for k in range(len(begs)):
        t = target_times[idxs_beg[k]:idxs_end[k]]
        v = target_vals[idxs_beg[k]:idxs_end[k]]
        if len(v) == 0:
            continue
        if not allow_nans and np.sum(np.isnan(v)) > 0:
            continue
        if np.isnan(begs[k]) or np.isnan(ends[k]):
            continue
        # coverage criterion (one-bin tolerance, with a float-noise epsilon:
        # a signal sampled exactly at bin edges sits exactly at `binsize`)
        if (abs(begs[k] - t[0]) > binsize + 1e-9
                or abs(ends[k] - t[-1]) > binsize + 1e-9):
            continue
        x_interp = np.linspace(begs[k] + binsize, ends[k], n_bins)
        y_interp = (_interp_extrap(x_interp, t, v) if v.ndim == 1
                    else np.stack([_interp_extrap(x_interp, t, v[:, d])
                                   for d in range(v.shape[1])], axis=1))
        times_list[k] = x_interp
        vals_list[k] = y_interp
        good[k] = True
    return times_list, vals_list, good


def align_spike_behavior(binned_spikes: np.ndarray,
                         binned_behaviors: Dict[str, list],
                         beh_names: Sequence[str],
                         trials_mask: Optional[np.ndarray] = None):
    """Drop trials missing any behavior; min-max normalize the continuous
    signals; return (spikes, behaviors, keep_mask, deleted_idxs)."""
    keep = np.ones(len(binned_spikes), dtype=bool)
    for name in beh_names:
        keep &= np.array([t is not None for t in binned_behaviors[name]])
    if trials_mask is not None:
        keep &= np.asarray(trials_mask, dtype=bool)

    del_idxs = np.where(~keep)[0]
    spikes = np.delete(binned_spikes, del_idxs, axis=0)
    behaviors = {}
    for name in beh_names:
        vals = [binned_behaviors[name][i] for i in range(len(keep)) if keep[i]]
        arr = np.array(vals, dtype=float).reshape(len(spikes), -1)
        if name in ("wheel-speed", "whisker-motion-energy"):
            lo, hi = arr.min(), arr.max()
            arr = (arr - lo) / (hi - lo) if hi > lo else arr * 0
        behaviors[name] = arr
        assert len(spikes) == len(arr), (name, len(spikes), len(arr))
    return spikes, behaviors, keep, del_idxs


def active_neuron_mask(binned_spikes: np.ndarray, interval_len: float = 2.0,
                       min_rate_hz: float = 2.0) -> np.ndarray:
    """Keep neurons with mean rate above threshold
    (``reference:src/prepare_data.py:107-110``).
    binned_spikes: (K, N, T_bins) or (K, T_bins, N) with neurons on axis 1."""
    mean_counts = binned_spikes.sum(axis=-1).mean(axis=0)
    return mean_counts / interval_len > min_rate_hz


def get_dlc_midpoint(dlc: Dict[str, np.ndarray], target: str,
                     likelihood_threshold: float = 0.9) -> Tuple[int, int]:
    """Mean (x, y) of a DLC point over frames with likelihood >= 0.9."""
    x = np.asarray(dlc[f"{target}_x"], dtype=float)
    y = np.asarray(dlc[f"{target}_y"], dtype=float)
    lik = np.asarray(dlc[f"{target}_likelihood"], dtype=float)
    bad = lik < likelihood_threshold
    x, y = x.copy(), y.copy()
    x[bad] = np.nan
    y[bad] = np.nan
    if np.all(np.isnan(x)) or np.all(np.isnan(y)):
        raise ValueError(f"{target} all NaN in DLC data")
    return int(np.nanmean(x)), int(np.nanmean(y))


def whisker_pad_roi(nose_mid: Sequence[int], pupil_mid: Sequence[int]
                    ) -> Tuple[np.ndarray, tuple]:
    """ROI geometry from nose/pupil midpoints; returns (roi[w,h,x,y], mask
    slice) — the reference's anchor construction."""
    anchor = np.mean([nose_mid, pupil_mid], axis=0)
    dist = float(np.sqrt(np.sum((np.asarray(nose_mid)
                                 - np.asarray(pupil_mid)) ** 2)))
    w, h = int(dist / 2), int(dist / 3)
    x, y = int(anchor[0] - dist / 4), int(anchor[1])
    if any(i < 0 for i in (x, y, w, h)):
        raise ValueError("whisker-pad ROI could not be computed")
    return np.asarray([w, h, x, y]), np.s_[y:y + h, x:x + w]


PUPIL_TARGETS = ("pupil_top_r", "pupil_left_r", "pupil_right_r",
                 "pupil_bottom_r")

#: IBL camera frame rates / resolution divisors (brainbox.behavior.dlc
#: constants: the left camera records FULL-resolution frames at 60 Hz, the
#: right HALF-resolution at 150 Hz, the body camera at 30 Hz; the divisor
#: rescales each camera's pixels onto the common half-resolution scale,
#: which is why 'left' divides by 2).
DLC_CAMERA_SAMPLING = {"left": 60, "right": 150, "body": 30}
DLC_CAMERA_RESOLUTION = {"left": 2, "right": 1, "body": 1}


def dlc_speed(dlc: Dict[str, np.ndarray], times: np.ndarray, camera: str,
              feature: str = "paw_r") -> np.ndarray:
    """Instantaneous speed of a tracked DLC point, in px/s at half
    resolution — first-party equivalent of ``brainbox.behavior.dlc
    .get_speed`` as consumed by the reference's paw/nose-speed targets
    (``reference:src/utils/ibl_data_utils.py:560-595``).

    Positions are rescaled by the camera's resolution divisor, the speed is
    the per-frame displacement norm times the camera frame rate (defined at
    frame midpoints), then linearly interpolated (with edge extrapolation,
    matching scipy ``interp1d(fill_value='extrapolate')``) back onto the
    original camera timestamps so the output aligns 1:1 with ``times``.
    """
    times = np.asarray(times, dtype=np.float64)
    res = DLC_CAMERA_RESOLUTION[camera]
    x = np.asarray(dlc[f"{feature}_x"], dtype=np.float64) / res
    y = np.asarray(dlc[f"{feature}_y"], dtype=np.float64) / res
    if len(x) != len(times):
        raise ValueError(
            f"{feature} trace length {len(x)} != camera times {len(times)}")
    speed = (np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2)
             * DLC_CAMERA_SAMPLING[camera])
    midpoints = times[:-1] + np.diff(times) / 2
    if midpoints.size < 2:
        raise ValueError("need at least 3 camera timestamps for speed")
    return _interp_extrap(times, midpoints, speed)


def whisker_pad_roi_from_dlc(dlc: Dict[str, np.ndarray]):
    """Nose + first-available pupil point -> ROI (reference fallback chain)."""
    nose = get_dlc_midpoint(dlc, "nose_tip")
    pupil = None
    for target in PUPIL_TARGETS:
        try:
            pupil = get_dlc_midpoint(dlc, target)
            break
        except (ValueError, KeyError):
            continue
    assert pupil is not None, "Pupil midpoint is None"
    return whisker_pad_roi(nose, pupil)


def merge_probes(spikes_list, clusters_meta_list):
    """Merge spikes from several probes into one session-wide stream with
    globally re-indexed cluster ids (``reference:src/utils/
    ibl_data_utils.py:83`` capability).

    `spikes_list`: per-probe dicts with 'times' (S,) and 'clusters' (S,);
    `clusters_meta_list`: per-probe dicts of per-cluster arrays (must share
    keys). Returns (merged_spikes, merged_cluster_meta).
    """
    times, clusters = [], []
    meta_out: Dict[str, list] = {}
    offset = 0
    for spikes, meta in zip(spikes_list, clusters_meta_list):
        c = np.asarray(spikes["clusters"])
        uniq, dense = np.unique(c, return_inverse=True)
        times.append(np.asarray(spikes["times"]))
        clusters.append(dense + offset)
        for k, v in meta.items():
            v = np.asarray(v)
            # per-cluster metadata indexed by raw id -> select merged order
            sel = v[uniq] if len(v) > uniq.max() else v
            meta_out.setdefault(k, []).append(sel)
        offset += len(uniq)
    all_times = np.concatenate(times)
    all_clusters = np.concatenate(clusters)
    order = np.argsort(all_times, kind="stable")
    merged = {"times": all_times[order], "clusters": all_clusters[order]}
    return merged, {k: np.concatenate(v) for k, v in meta_out.items()}


# ---------------------------------------------------------------------------
# network loaders (require ibllib/ONE; import is deferred and gated)
# ---------------------------------------------------------------------------

def load_one_session(eid: str, base_url: str = "https://openalyx.internationalbrainlab.org"):
    """ONE handle for :mod:`video_spike_torch.data.one_ingest` (the full
    orchestration lives there, mock-tested). Raises a clear error when
    ibllib is unavailable (the port does not depend on it)."""
    try:
        from one.api import ONE  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "ONE api (ibllib) is not installed; use the local/synthetic "
            "prepare_data path or install ibllib for real IBL sessions"
        ) from e
    one = ONE(base_url=base_url)  # pragma: no cover
    return one  # pragma: no cover
