"""ONE-api ingestion orchestration: real IBL sessions -> trial tar shards.

The port's own copy of ``video_spike_tpu/data/one_ingest.py``; its optical
flow runs on the card unless the caller asks for the CPU.

Behavior parity with ``reference:src/utils/ibl_data_utils.py:35-998``
and the ``--source one`` flow of ``reference:src/prepare_data.py:84-237``:

- :func:`load_spiking_data` (``:35-81``): SpikeSortingLoader spikes +
  merged cluster table, optional label>=qc filter;
- :func:`merge_probe_dataframes` (``merge_probes`` ``:83-132``): pandas
  variant used on the ONE path (the array variant lives in ``data/ibl.py``);
- :func:`load_trials_and_mask` (``:134-229``): trials table + quality mask
  (reaction-time window, trial-length cap, NaN events, no-choice);
- :func:`load_target_behavior` (``:425-599``) /
  :func:`load_anytime_behaviors` (``:745-772``): the FULL reference target
  surface — wheel position/velocity/speed and whisker motion energy via
  SessionLoader, pupil diameter (DLC-smoothed + lightning-pose), raw pupil
  point traces, paw and nose-tip speeds (via the first-party
  :func:`video_spike_torch.data.ibl.dlc_speed`, the brainbox ``get_speed``
  equivalent); fetches run in a thread pool (IO-bound — the reference's
  multiprocessing pool is a CUDA-era artifact);
- :func:`bin_spiking_data` (``:325-398``): stimOn-aligned intervals
  (``align_time + time_window``), delegating the binning to the vectorized
  :func:`video_spike_torch.data.ibl.bin_spikes`;
- :func:`bin_behaviors` (``:775-841``): trial events (choice/block/reward/
  contrast) + 60 Hz interval resampling with the left->right whisker-ME
  fallback;
- :func:`load_video_index` / :func:`load_video` / :func:`load_whisker_video`
  (``:934-1001``): per-trial frame index lists (10-frame tolerance) and
  streamed frame loading through ``ibllib.io.video``;
- :func:`get_whisker_pad_roi` (``:1015-1047``): DLC nose/pupil ROI via the
  shared geometry in ``data/ibl.py``;
- :func:`prepare_session` (``prepare_data`` ``:843-902``) and
  :func:`ingest_one_session` (``src/prepare_data.py:84-237``): the full
  session -> tar pipeline, writing the same shard schema as the local ETL.

ibllib/ONE are optional (the port does not depend on them), so every
network-adjacent dependency is injected through :class:`Providers`;
``Providers.default()`` imports the real stack and is the only place that
touches ibllib. Tests run the entire orchestration against the strict mocks
of :mod:`video_spike_torch.data.one_contract`
(``tests/test_torch_one_ingest.py``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from video_spike_torch.data.ibl import (
    active_neuron_mask,
    align_spike_behavior,
    bin_spikes,
    dlc_speed,
    interp_behavior,
    whisker_pad_roi_from_dlc,
)

DEFAULT_NAN_EXCLUDE = (
    "stimOn_times", "choice", "feedback_times", "probabilityLeft",
    "firstMovement_times", "feedbackType",
)

DEFAULT_PARAMS = {
    "interval_len": 2,
    "binsize": 0.02,
    "single_region": False,
    "align_time": "stimOn_times",
    "time_window": (-0.5, 1.5),
    "fr_thresh": 0.5,
}

BEH_NAMES = ("choice", "reward", "block",
             "wheel-speed", "whisker-motion-energy")


@dataclass
class Providers:
    """Injection point for everything that would touch ibllib/brainbox.

    - ``spike_loader(one, pid, eid, pname)`` -> object with
      ``raw_electrophysiology(band, stream).fs`` and ``load_spike_sorting()``;
    - ``merge_clusters(spikes, clusters, channels)`` -> cluster DataFrame;
    - ``sess_loader(one, eid)`` -> object with ``trials`` / ``load_trials()``
      / ``load_wheel()`` / ``wheel`` / ``load_motion_energy(views)`` /
      ``motion_energy``;
    - ``vidio``: module-like with ``url_from_eid`` / ``label_from_path`` /
      ``get_video_meta`` / ``get_video_frames_preload``.
    """

    spike_loader: Any
    merge_clusters: Any
    sess_loader: Any
    vidio: Any

    @classmethod
    def default(cls) -> "Providers":  # pragma: no cover - needs ibllib
        try:
            import ibllib.io.video as vidio
            from brainbox.io.one import SessionLoader, SpikeSortingLoader
        except ImportError as e:
            raise RuntimeError(
                "ONE-api ingestion needs ibllib/brainbox (not bundled in "
                "the port); install them or use the local/synthetic "
                "prepare_data path") from e

        def spike_loader(one, pid, eid, pname):
            return SpikeSortingLoader(pid=pid, one=one, eid=eid, pname=pname)

        def merge_clusters(spikes, clusters, channels):
            return SpikeSortingLoader.merge_clusters(
                spikes, clusters, channels).to_df()

        def sess_loader(one, eid):
            return SessionLoader(one, eid=eid)

        return cls(spike_loader=spike_loader, merge_clusters=merge_clusters,
                   sess_loader=sess_loader, vidio=vidio)


# ---------------------------------------------------------------------------
# spikes
# ---------------------------------------------------------------------------

def load_spiking_data(one, pid: str, providers: Providers,
                      qc: Optional[float] = None, eid: str = "",
                      pname: str = ""):
    """(spikes dict, cluster DataFrame, sampling_freq); optional label>=qc
    cluster filter with dense re-indexing (``ibl_data_utils.py:35-81``)."""
    loader = providers.spike_loader(one, pid, eid=eid, pname=pname)
    sampling_freq = loader.raw_electrophysiology(band="ap", stream=True).fs
    spikes, clusters, channels = loader.load_spike_sorting()
    labeled = providers.merge_clusters(spikes, clusters, channels)
    if qc is None:
        return spikes, labeled, sampling_freq
    ok = labeled["label"].to_numpy() >= qc
    selected = labeled[ok].reset_index(drop=True)
    ok_ids = np.where(ok)[0]
    remap = -np.ones(int(labeled.index.max()) + 1, dtype=np.int64)
    remap[ok_ids] = np.arange(len(ok_ids))
    keep = np.isin(spikes["clusters"], ok_ids)
    out = {k: np.asarray(v)[keep] for k, v in spikes.items()}
    out["clusters"] = remap[out["clusters"]].astype(np.int32)
    return out, selected, sampling_freq


def merge_probe_dataframes(spikes_list, clusters_list):
    """Merge per-probe spikes/cluster-tables into one time-sorted stream
    (pandas variant of ``merge_probes``, ``ibl_data_utils.py:83-132``)."""
    import pandas as pd

    merged_spikes = []
    merged_clusters = []
    cluster_max = 0
    for spikes, clusters in zip(spikes_list, clusters_list):
        s = {k: np.asarray(v) for k, v in spikes.items()}
        s["clusters"] = s["clusters"] + cluster_max
        cluster_max += int(clusters.index.max()) + 1
        merged_spikes.append(s)
        merged_clusters.append(clusters)
    clusters = pd.concat(merged_clusters, ignore_index=True)
    spikes = {k: np.concatenate([s[k] for s in merged_spikes])
              for k in merged_spikes[0]}
    order = np.argsort(spikes["times"], kind="stable")
    return {k: v[order] for k, v in spikes.items()}, clusters


def list_brain_regions(neural_dict: Dict, single_region: bool = False,
                       acronym2acronym=None, **_):
    """Beryl-mapped region sets present in the recording
    (``ibl_data_utils.py:230-237``). ``acronym2acronym`` injects the
    iblatlas mapping; identity (raw acronyms) when absent so the
    select-all path works without iblatlas."""
    regions_raw = np.asarray(neural_dict["cluster_regions"])
    if acronym2acronym is None:
        try:  # pragma: no cover - needs iblatlas
            from iblatlas.regions import BrainRegions
            acronym2acronym = lambda a: BrainRegions().acronym2acronym(
                a, mapping="Beryl")
        except ImportError:
            acronym2acronym = lambda a: a
    beryl = np.asarray(acronym2acronym(regions_raw))
    uniq = np.unique(beryl)
    regions = [[r] for r in uniq] if single_region else [uniq]
    return regions, beryl


def select_brain_regions(beryl_reg, region, **_) -> np.ndarray:
    """Cluster indices whose Beryl region is in ``region``
    (``ibl_data_utils.py:239-244``)."""
    return np.argwhere(np.isin(beryl_reg, region)).flatten()


# ---------------------------------------------------------------------------
# trials
# ---------------------------------------------------------------------------

def load_trials_and_mask(one, eid: str, providers: Providers,
                         min_rt: Optional[float] = 0.08,
                         max_rt: Optional[float] = 2.0,
                         nan_exclude="default",
                         min_trial_len: Optional[float] = None,
                         max_trial_len: Optional[float] = 10,
                         exclude_unbiased: bool = False,
                         exclude_nochoice: bool = True,
                         sess_loader=None):
    """Trials table + inclusion mask (``ibl_data_utils.py:134-229``).

    The reference builds a pandas ``eval`` query string; the same predicate
    is computed here with plain column arithmetic (NaN comparisons are False,
    matching ``eval`` semantics, while explicit isnull terms catch them).
    """
    if nan_exclude == "default":
        nan_exclude = list(DEFAULT_NAN_EXCLUDE)
    if sess_loader is None:
        sess_loader = providers.sess_loader(one, eid)
    if sess_loader.trials is None or len(sess_loader.trials) == 0:
        sess_loader.load_trials()
    trials = sess_loader.trials

    rt = (trials["firstMovement_times"] - trials["stimOn_times"]).to_numpy()
    tlen = (trials["feedback_times"] - trials["goCue_times"]).to_numpy()
    exclude = np.zeros(len(trials), dtype=bool)
    if min_rt is not None:
        exclude |= rt < min_rt
    if max_rt is not None:
        exclude |= rt > max_rt
    if min_trial_len is not None:
        exclude |= tlen < min_trial_len
    if max_trial_len is not None:
        exclude |= tlen > max_trial_len
    for event in nan_exclude:
        exclude |= trials[event].isnull().to_numpy()
    if exclude_unbiased:
        exclude |= trials["probabilityLeft"].to_numpy() == 0.5
    if exclude_nochoice:
        exclude |= trials["choice"].to_numpy() == 0
    return trials, ~exclude


# ---------------------------------------------------------------------------
# behaviors
# ---------------------------------------------------------------------------

def _obj_field(obj, key):
    """ibllib returns Bunch objects (dict + attribute access); mocks return
    plain dicts. Normalize the field lookup across both."""
    if isinstance(obj, dict):
        return obj[key]
    return getattr(obj, key)


def _load_dlc_object(one, eid: str, camera: str):
    """alf-collection DLC object for one camera: the
    (dlc, features, times) load shape shared by every DLC-derived target
    (``ibl_data_utils.py:494-595``)."""
    return one.load_object(eid, f"{camera}Camera",
                           attribute=["dlc", "features", "times"],
                           collection="alf")


#: dlc-pupil-<point> targets read raw rightCamera pupil traces
#: (``ibl_data_utils.py:506-529``); target suffix -> dlc column.
_DLC_PUPIL_COLUMNS = {
    "dlc-pupil-bottom-r-y": "pupil_bottom_r_y",
    "dlc-pupil-top-r-y": "pupil_top_r_y",
    "dlc-pupil-left-r-x": "pupil_left_r_x",
    "dlc-pupil-right-r-x": "pupil_right_r_x",
}


def _lightning_pose_pupil_diameter(one, eid: str, camera: str) -> Dict:
    """Pupil diameter from lightning-pose traces: |right_x - left_x|
    cross-checked against |top_y - bottom_y| (``ibl_data_utils.py:530-558``)."""
    obj = one.load_object(eid, f"{camera}Camera",
                          attribute=["lightningPose", "times"])
    lp = _obj_field(obj, "lightningPose")
    dm1 = np.fabs(np.asarray(lp["pupil_right_r_x"])
                  - np.asarray(lp["pupil_left_r_x"]))
    dm2 = np.fabs(np.asarray(lp["pupil_top_r_y"])
                  - np.asarray(lp["pupil_bottom_r_y"]))
    assert np.allclose(dm1, dm2)
    return {"times": np.asarray(_obj_field(obj, "times")), "values": dm1}


def load_target_behavior(one, eid: str, target: str, providers: Providers,
                         sess_loader=None) -> Dict:
    """{'times', 'values'} for one behavior signal; {'skip': True} on any
    loading error (``ibl_data_utils.py:425-599``).

    Full reference target surface: wheel position/velocity/speed, left/right
    whisker motion energy, left/right pupil diameter (DLC-smoothed and
    lightning-pose variants), the four raw rightCamera pupil point traces,
    the four <camera>-camera-<side>-paw-speed combinations, and left/right
    nose-tip speed (speeds via the first-party
    :func:`video_spike_torch.data.ibl.dlc_speed`).
    """
    try:
        if sess_loader is None:
            sess_loader = providers.sess_loader(one, eid)
        if target in ("wheel-position", "wheel-velocity", "wheel-speed"):
            sess_loader.load_wheel()
            col = "position" if target == "wheel-position" else "velocity"
            values = sess_loader.wheel[col].to_numpy()
            if target == "wheel-speed":
                values = np.abs(values)
            return {"times": sess_loader.wheel["times"].to_numpy(),
                    "values": values}
        if target.endswith("whisker-motion-energy"):
            view = target.split("-")[0]
            sess_loader.load_motion_energy(views=[view])
            me = sess_loader.motion_energy[f"{view}Camera"]
            return {"times": me["times"].to_numpy(),
                    "values": me["whiskerMotionEnergy"].to_numpy()}
        if target in ("left-pupil-diameter", "right-pupil-diameter"):
            camera = target.split("-")[0]
            obj = _load_dlc_object(one, eid, camera)
            features = _obj_field(obj, "features")
            return {"times": np.asarray(_obj_field(obj, "times")),
                    "values": np.asarray(features["pupilDiameter_smooth"])}
        if target in _DLC_PUPIL_COLUMNS:
            # the reference reads these raw traces from the right camera
            obj = one.load_object(eid, "rightCamera", collection="alf")
            dlc_table = _obj_field(obj, "dlc")
            return {"times": np.asarray(_obj_field(obj, "times")),
                    "values": np.asarray(dlc_table[_DLC_PUPIL_COLUMNS[target]])}
        if target in ("lightning-pose-left-pupil-diameter",
                      "lightning-pose-right-pupil-diameter"):
            return _lightning_pose_pupil_diameter(one, eid,
                                                  camera=target.split("-")[2])
        if target.endswith("-paw-speed") or target.endswith("-nose-speed"):
            # '<camera>-camera-<side>-paw-speed' | '<camera>-nose-speed'
            parts = target.split("-")
            camera = parts[0]
            feature = ("nose_tip" if parts[1] == "nose"
                       else {"left": "paw_l", "right": "paw_r"}[parts[2]])
            obj = _load_dlc_object(one, eid, camera)
            times = np.asarray(_obj_field(obj, "times"))
            return {"times": times,
                    "values": dlc_speed(_obj_field(obj, "dlc"), times,
                                        camera=camera, feature=feature)}
        raise NotImplementedError(target)
    except Exception as e:  # mirror the reference's skip contract
        print(f"Error loading {target} data: {e}")
        return {"times": None, "values": None, "skip": True}


def load_anytime_behaviors(one, eid: str, providers: Providers,
                           behaviors: Sequence[str] = (
                               "wheel-speed",
                               "left-whisker-motion-energy",
                               "right-whisker-motion-energy"),
                           n_workers: int = 3) -> Dict[str, Dict]:
    """Concurrent fetch of the session-wide behavior signals
    (``ibl_data_utils.py:745-772``; threads, not processes — pure IO)."""
    def load(beh):
        return beh, load_target_behavior(one, eid, beh, providers)

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        return dict(pool.map(load, behaviors))


def trial_intervals(trials_df, align_time: str = "stimOn_times",
                    time_window: Tuple[float, float] = (-0.5, 1.5)
                    ) -> np.ndarray:
    """Per-trial (start, end) aligned to a trial event
    (``bin_spiking_data``, ``ibl_data_utils.py:360-365``)."""
    t = trials_df[align_time].to_numpy()
    return np.vstack([t + time_window[0], t + time_window[1]]).T


def bin_spiking_data(reg_clu_ids, neural_dict: Dict, trials_df=None,
                     intervals: Optional[np.ndarray] = None,
                     align_time: str = "stimOn_times",
                     time_window: Tuple[float, float] = (-0.5, 1.5),
                     binsize: float = 0.02, **_):
    """(K, T_bins, N) spike rasters + cluster ids used + intervals
    (``ibl_data_utils.py:325-398``), via the vectorized binner."""
    if trials_df is not None:
        intervals = trial_intervals(trials_df, align_time, time_window)
    assert intervals is not None, "need trials_df or intervals"
    interval_len = float(time_window[1] - time_window[0]) if trials_df is not None \
        else float(intervals[0, 1] - intervals[0, 0])

    spikemask = np.isin(neural_dict["spike_clusters"], reg_clu_ids)
    regspikes = np.asarray(neural_dict["spike_times"])[spikemask]
    regclu = np.asarray(neural_dict["spike_clusters"])[spikemask]
    clusters_used, dense = np.unique(regclu, return_inverse=True)
    binned = bin_spikes(regspikes, dense, intervals, binsize=binsize,
                        interval_len=interval_len,
                        n_clusters=len(clusters_used))    # (K, N, T)
    return np.transpose(binned, (0, 2, 1)), clusters_used, intervals


def bin_behaviors(one, eid: str, providers: Providers,
                  behaviors: Sequence[str], trials_df=None,
                  intervals: Optional[np.ndarray] = None, mask=None,
                  allow_nans: bool = True, freq: int = 60,
                  align_time: str = "stimOn_times",
                  time_window: Tuple[float, float] = (-0.5, 1.5),
                  behave_dict_cache: Optional[Dict] = None, **_):
    """Trial events + 60 Hz interval resampling
    (``ibl_data_utils.py:775-841``). ``behave_dict_cache`` lets the caller
    reuse the signals already fetched by :func:`load_anytime_behaviors`."""
    behave_dict: Dict[str, Any] = {}
    mask_dict: Dict[str, np.ndarray] = {}
    if mask is not None and trials_df is not None:
        trials_df = trials_df[mask]
    if trials_df is not None:
        choice = trials_df["choice"].to_numpy()
        block = trials_df["probabilityLeft"].to_numpy()
        reward = (trials_df["rewardVolume"].to_numpy() > 1).astype(int)
        contrast = np.c_[trials_df["contrastLeft"].to_numpy(),
                         trials_df["contrastRight"].to_numpy()]
        contrast = (-1 * np.nan_to_num(contrast, nan=0.0)).sum(1)
        behave_dict.update(choice=choice, block=block, reward=reward,
                           contrast=contrast)
        intervals = trial_intervals(trials_df, align_time, time_window)
    assert intervals is not None, "need trials_df or intervals"

    for beh in behaviors:
        if behave_dict_cache is not None and beh in behave_dict_cache \
                and not behave_dict_cache[beh].get("skip"):
            target = behave_dict_cache[beh]
        elif beh == "whisker-motion-energy":
            cache = behave_dict_cache or {}
            target = cache.get("left-whisker-motion-energy") or \
                load_target_behavior(one, eid, "left-whisker-motion-energy",
                                     providers)
            if target.get("skip"):
                target = cache.get("right-whisker-motion-energy") or \
                    load_target_behavior(one, eid,
                                         "right-whisker-motion-energy",
                                         providers)
        else:
            target = load_target_behavior(one, eid, beh, providers)
        _, vals_list, good = interp_behavior(
            target["times"], target["values"], intervals, freq=freq,
            allow_nans=allow_nans)
        behave_dict[beh] = np.array(vals_list, dtype=object)
        mask_dict[beh] = good
    return behave_dict, mask_dict


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------

def load_video_index(one, eid: str, camera: str, intervals: np.ndarray,
                     providers: Providers, tolerance: int = 10):
    """Per-trial frame index arrays + the camera URL
    (``ibl_data_utils.py:934-975``): fps * interval_len consecutive frames
    from the first timestamp inside each interval, rejecting trials whose
    in-interval frame count deviates by more than ``tolerance``."""
    vidio = providers.vidio
    urls = vidio.url_from_eid(eid, one=one)
    url = urls[camera]
    label = vidio.label_from_path(url)
    meta = vidio.get_video_meta(url, one=one)
    fps = meta["fps"]
    ts = one.load_dataset(eid, f"_ibl_{label}Camera.times.npy",
                          collection="alf")
    finite = np.isfinite(intervals).all(axis=1)
    interval_len = (intervals[finite][0, 1] - intervals[finite][0, 0])
    n_frames = int(fps * interval_len)
    index_list = []
    for (t0, t1), ok in zip(intervals, finite):
        if not ok:
            # NaN-event trials are excluded by the trials mask downstream;
            # emit a placeholder so indexing stays aligned with the trial
            # axis (the reference would crash here, but its real sessions
            # never carry NaN stimOn into this loop)
            index_list.append(np.zeros(n_frames, dtype=np.int64))
            continue
        in_trial = np.sum((ts > t0) & (ts < t1))
        if abs(int(in_trial) - n_frames) > tolerance:
            raise ValueError(
                f"video frames in [{t0}, {t1}] deviate from expected "
                f"{n_frames} by {abs(int(in_trial) - n_frames)} > {tolerance}")
        start = int(np.searchsorted(ts, t0))
        index_list.append(np.arange(start, start + n_frames))
    return np.asarray(index_list), url


def load_video(index: np.ndarray, url: str, providers: Providers,
               quiet: bool = True) -> np.ndarray:
    """Grayscale (F, H, W) frames for one trial (``:977-984``)."""
    return providers.vidio.get_video_frames_preload(
        url, index, mask=np.s_[:, :, 0], quiet=quiet)


def load_whisker_video(index: np.ndarray, url: str, mask,
                       providers: Providers, quiet: bool = True) -> np.ndarray:
    """ROI-cropped grayscale frames (``:986-998``); the crop happens inside
    the frame loader so full frames never hit memory."""
    vidio = providers.vidio

    def grayscale(x):
        return x[..., 0] if x.ndim == 3 else x

    return vidio.get_video_frames_preload(url, index, mask=mask, quiet=quiet,
                                          func=grayscale)


def get_whisker_pad_roi(one, eid: str, camera: str):
    """DLC nose/pupil ROI (``:1015-1047``) via the shared geometry."""
    obj = one.load_object(eid, f"{camera}Camera",
                          attribute=["dlc", "features", "times"],
                          collection="alf")
    dlc = obj["dlc"] if isinstance(obj, dict) else obj.dlc
    cols = (dlc.columns if hasattr(dlc, "columns") else dlc.keys())
    dlc_dict = {c: np.asarray(dlc[c]) for c in cols}
    return whisker_pad_roi_from_dlc(dlc_dict)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def prepare_session(one, eid: str, providers: Providers,
                    n_workers: int = 3):
    """Probe-merged spikes + behaviors + trials for one session
    (``prepare_data``, ``ibl_data_utils.py:843-902``)."""
    pids, probe_names = one.eid2pid(eid)
    clusters_list, spikes_list = [], []
    sampling_freq = None
    for pid, pname in zip(pids, probe_names):
        spikes, clusters, sampling_freq = load_spiking_data(
            one, pid, providers, eid=eid, pname=pname)
        clusters = clusters.copy()
        clusters["pid"] = pid
        spikes_list.append(spikes)
        clusters_list.append(clusters)
    spikes, clusters = merge_probe_dataframes(spikes_list, clusters_list)

    trials_df, trials_mask = load_trials_and_mask(
        one, eid, providers, min_rt=None, max_rt=None, max_trial_len=None)
    behave_dict = load_anytime_behaviors(one, eid, providers,
                                         n_workers=n_workers)

    neural_dict = {
        "spike_times": spikes["times"],
        "spike_clusters": spikes["clusters"],
        "cluster_regions": clusters["acronym"].to_numpy(),
    }
    meta_data = {
        "eid": eid,
        "sampling_freq": sampling_freq,
        "cluster_channels": list(clusters["channels"]),
        "cluster_regions": list(clusters["acronym"]),
        "good_clusters": list((clusters["label"] >= 1).astype(int)),
        "cluster_depths": list(clusters["depths"]),
        "uuids": list(clusters["uuids"]),
    }
    trials_data = {"trials_df": trials_df, "trials_mask": trials_mask}
    return neural_dict, behave_dict, meta_data, trials_data


def ingest_one_session(one, eid: str, base_path: str | Path,
                       providers: Optional[Providers] = None,
                       params: Optional[Dict] = None, camera: str = "left",
                       store_video_as: str = "mp4",
                       flow_backend: str = "torch",
                       resize_to: Tuple[int, int] = (128, 128),
                       n_workers: int = 3, device=None) -> list:
    """Full ``--source one`` branch (``src/prepare_data.py:84-237``):
    session fetch -> binning -> video index/ROI -> active-neuron filter ->
    behavior binning -> alignment -> per-trial video + optical flow -> one
    tar shard per trial with the local-ETL schema. The flow runs on
    ``device`` (the card unless the caller asks for the CPU) with
    ``flow_backend='torch'``, or through OpenCV with ``'cv2'``."""
    from video_spike_torch.data.tar_io import write_trial_tar
    from video_spike_torch.ops.flow import get_optic_flow

    providers = providers or Providers.default()
    params = {**DEFAULT_PARAMS, **(params or {})}
    out_dir = Path(base_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    neural_dict, behave_dict, meta_data, trials_data = prepare_session(
        one, eid, providers, n_workers=n_workers)

    regions, beryl = list_brain_regions(
        neural_dict, single_region=params.get("single_region", False))
    reg_clu_ids = select_brain_regions(beryl, regions[0])
    binned_spikes, clusters_used, intervals = bin_spiking_data(
        reg_clu_ids, neural_dict, trials_df=trials_data["trials_df"],
        align_time=params["align_time"], time_window=params["time_window"],
        binsize=params["binsize"])

    video_index_list, url = load_video_index(one, eid, camera, intervals,
                                             providers)
    roi, mask = get_whisker_pad_roi(one, eid, camera)

    # active-neuron filter (prepare_data.py:107-110: avg_fr > 1/fr_thresh)
    keep = active_neuron_mask(np.transpose(binned_spikes, (0, 2, 1)),
                              interval_len=params["interval_len"],
                              min_rate_hz=1.0 / params["fr_thresh"])
    binned_spikes = binned_spikes[:, :, keep]
    print(f"# of neurons after filtering inactive: "
          f"{binned_spikes.shape[-1]}/{len(keep)}")

    binned_behaviors, _ = bin_behaviors(
        one, eid, providers, behaviors=BEH_NAMES[3:],
        trials_df=trials_data["trials_df"], allow_nans=True, freq=60,
        align_time=params["align_time"], time_window=params["time_window"],
        behave_dict_cache=behave_dict)

    # align_spike_behavior works on (K, N, T); events stay per-trial scalars
    events = {k: binned_behaviors.pop(k)
              for k in ("choice", "block", "reward", "contrast")}
    spikes_nt = np.transpose(binned_spikes, (0, 2, 1))
    aligned_spikes, aligned_behaviors, keep_trials, _ = align_spike_behavior(
        spikes_nt, binned_behaviors, list(binned_behaviors.keys()),
        trials_mask=np.asarray(trials_data["trials_mask"]))
    kept_idx = np.where(keep_trials)[0]

    files = []
    for out_k, k in enumerate(kept_idx):
        trial_video = load_video(video_index_list[k], url, providers)
        whisker_video = load_whisker_video(video_index_list[k], url, mask,
                                           providers)
        if trial_video.shape[1:] != tuple(resize_to):
            import cv2
            trial_video = np.stack([cv2.resize(f, resize_to)
                                    for f in trial_video])
        flow = get_optic_flow(whisker_video.astype(np.float32),
                              backend=flow_backend, device=device)
        t0, t1 = intervals[k]
        timestamp = np.linspace(t0, t1, whisker_video.shape[0])
        of_summary = np.stack([flow["of"], flow["of-2d"][:, 0],
                               flow["of-2d"][:, 1]], axis=1)
        key = f"{eid}_{out_k}"
        path = out_dir / f"{key}.tar"
        write_trial_tar(
            path, key,
            arrays={
                "ap": aligned_spikes[out_k].T.astype(np.float32),
                "choice": np.asarray([events["choice"][k]], np.float32),
                "block": np.asarray([events["block"][k]], np.float32),
                "wheel-speed": aligned_behaviors["wheel-speed"][out_k]
                    .astype(np.float32),
                "whisker-motion-energy":
                    aligned_behaviors["whisker-motion-energy"][out_k]
                    .astype(np.float32),
                "whisker-of": of_summary.astype(np.float32),
                "whisker-of-2d": flow["of-2d"].astype(np.float32),
                "whisker-of-video": flow["of-video"].astype(np.float32),
                "timestamp": timestamp.astype(np.float64),
            },
            videos={"video": trial_video.astype(np.uint8),
                    "whisker-video": whisker_video.astype(np.uint8)},
            meta={"eid": eid, "trial": int(k),
                  "n_neurons": int(aligned_spikes.shape[1]),
                  "sample_freq": meta_data["sampling_freq"],
                  "whisker_roi": roi.tolist(),
                  "interval": intervals[k].tolist(),
                  **{p: (list(v) if isinstance(v, tuple) else v)
                     for p, v in params.items()}},
            store_video_as=store_video_as,
        )
        files.append(str(path))
    return files
