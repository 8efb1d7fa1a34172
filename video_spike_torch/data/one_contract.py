"""Recorded contract of the ibllib/ONE API surface the ingestion consumes.

The port's own copy of ``video_spike_tpu/data/one_contract.py``.

The ONE ingestion (:mod:`video_spike_torch.data.one_ingest`) cannot run its
real dependency without ibllib, so this module pins the *schema* of every
object that crosses the ``Providers`` boundary — transcribed from the
actual ibllib/brainbox return types as exercised by the reference
(``reference:src/utils/ibl_data_utils.py:35-98,196-226,425-599,
934-998,1015-1047``):

- ``SpikeSortingLoader.load_spike_sorting()`` -> ``(spikes, clusters,
  channels)`` where ``spikes`` is a dict of per-spike arrays;
  ``SpikeSortingLoader.merge_clusters(...)`` -> a cluster table whose
  columns are a superset of :data:`CLUSTER_TABLE_COLUMNS`;
- ``SessionLoader.trials`` -> DataFrame with :data:`TRIALS_COLUMNS`;
  ``.wheel`` (after ``load_wheel()``) -> :data:`WHEEL_COLUMNS`;
  ``.motion_energy['<view>Camera']`` (after ``load_motion_energy``) ->
  :data:`MOTION_ENERGY_COLUMNS`;
- ``ibllib.io.video``: ``url_from_eid`` -> camera->url dict,
  ``get_video_meta`` -> :data:`VIDEO_META_KEYS`,
  ``get_video_frames_preload(url, index, mask=, quiet=, func=)``;
- ``one.load_dataset(eid, '_ibl_<label>Camera.times.npy',
  collection='alf')``; ``one.load_object(eid, '<camera>Camera',
  attribute=['dlc','features','times'], collection='alf')`` with a ``dlc``
  DataFrame of ``<point>_x/_y/_likelihood`` columns, a ``features``
  DataFrame carrying :data:`DLC_FEATURES_COLUMNS` (pupil-diameter targets),
  and ``times``; ``one.load_object(eid, '<camera>Camera',
  attribute=['lightningPose','times'])`` (no collection) with the pupil
  point columns in :data:`LP_COLUMNS`;
- ``one.eid2pid(eid)`` -> (pids, probe names).

:func:`build_contract_mocks` turns the recorded schema into STRICT mocks:
every DataFrame carries exactly the recorded columns and every fake loader
exposes only the recorded methods/kwargs, so any field-name drift between
the ingestion code and this contract fails loudly
(``tests/test_torch_one_ingest.py``). When ibllib IS importable, the
import-gated half of that test verifies this contract against the real
modules (method presence + call signatures), so drift between the contract
and ibllib itself is caught on any machine that has the dependency.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

# --- spike sorting ---------------------------------------------------------

#: per-spike arrays returned by SpikeSortingLoader.load_spike_sorting()[0]
SPIKES_KEYS = ("times", "clusters", "amps", "depths")
SPIKES_DTYPES = {"times": "f", "clusters": "i", "amps": "f", "depths": "f"}

#: columns of the merged cluster table the pipeline consumes. The real
#: SpikeSortingLoader.merge_clusters output is wider (qc metrics columns);
#: the contract records the consumed subset — mocks expose EXACTLY these
#: so new consumption shows up as a KeyError in the contract test.
CLUSTER_TABLE_COLUMNS = ("label", "acronym", "channels", "depths", "uuids")

#: raw_electrophysiology(band="ap", stream=True) returns a reader with .fs
RAW_EPHYS_ATTRS = ("fs",)

# --- trials ----------------------------------------------------------------

#: _ibl_trials columns the reference's mask query + event binning touch
#: (ibl_data_utils.py:196-226; bin_behaviors trial events)
TRIALS_COLUMNS = (
    "stimOn_times", "goCue_times", "feedback_times", "firstMovement_times",
    "choice", "feedbackType", "probabilityLeft", "rewardVolume",
    "contrastLeft", "contrastRight",
)

# --- behaviors -------------------------------------------------------------

WHEEL_COLUMNS = ("times", "position", "velocity")
MOTION_ENERGY_COLUMNS = ("times", "whiskerMotionEnergy")
#: sess_loader.motion_energy keys are '<view>Camera'
MOTION_ENERGY_KEY_FMT = "{view}Camera"
SESSION_LOADER_METHODS = ("load_trials", "load_wheel", "load_motion_energy")

# --- video -----------------------------------------------------------------

#: ibllib.io.video.get_video_meta returns a Bunch with these keys
VIDEO_META_KEYS = ("length", "fps", "width", "height", "duration", "size")
CAMERA_LABELS = ("left", "right", "body")
CAMERA_TIMES_DATASET = "_ibl_{label}Camera.times.npy"
CAMERA_TIMES_COLLECTION = "alf"
VIDIO_FUNCTIONS = ("url_from_eid", "label_from_path", "get_video_meta",
                   "get_video_frames_preload")

# --- DLC -------------------------------------------------------------------

DLC_OBJECT_FMT = "{camera}Camera"
DLC_ATTRIBUTES = ("dlc", "features", "times")
DLC_COLLECTION = "alf"
DLC_POINT_SUFFIXES = ("_x", "_y", "_likelihood")
#: pupil fallback chain of get_whisker_pad_roi (ibl_data_utils.py:1019-1031)
DLC_POINTS = ("nose_tip", "pupil_top_r", "pupil_left_r", "pupil_right_r",
              "pupil_bottom_r")
#: points whose traces feed dlc_speed (paw/nose-speed targets,
#: ibl_data_utils.py:560-595)
DLC_SPEED_FEATURES = ("paw_l", "paw_r", "nose_tip")
#: '<camera>Camera.features' columns (pupil targets read the smooth one,
#: ibl_data_utils.py:496-505)
DLC_FEATURES_COLUMNS = ("pupilDiameter_raw", "pupilDiameter_smooth")
#: lightning-pose pupil load shape: load_object(eid, '<camera>Camera',
#: attribute=['lightningPose','times']) with NO collection kwarg
#: (ibl_data_utils.py:530-558); columns the diameter derivation consumes
LP_OBJECT_ATTRIBUTES = ("lightningPose", "times")
LP_COLUMNS = ("pupil_left_r_x", "pupil_right_r_x",
              "pupil_top_r_y", "pupil_bottom_r_y")


# ---------------------------------------------------------------------------
# strict mocks generated from the recorded schema
# ---------------------------------------------------------------------------

class ContractError(AssertionError):
    """A call crossed the Providers boundary outside the recorded contract."""


@dataclass
class ContractSession:
    """Synthetic session realized with exactly the contract schemas."""

    n_trials: int = 8
    fps: int = 60
    n_neurons_per_probe: int = 6
    seed: int = 7
    height: int = 64
    width: int = 64
    missing_views: tuple = ("right",)
    data: Dict = field(default_factory=dict)

    def __post_init__(self):
        import pandas as pd

        rng = np.random.default_rng(self.seed)
        trial_len, gap = 2.0, 1.0
        session_len = self.n_trials * (trial_len + gap) + gap
        starts = gap + np.arange(self.n_trials) * (trial_len + gap)
        n_cam = int(session_len * self.fps)
        cam_times = np.arange(n_cam) / self.fps
        video = rng.integers(0, 255, (n_cam, self.height, self.width, 3),
                             dtype=np.uint8)
        video[..., 1] = video[..., 0]   # IBL cameras are gray-as-rgb
        video[..., 2] = video[..., 0]

        stim_on = starts + 0.5
        trials_values = {
            "stimOn_times": stim_on,
            "goCue_times": stim_on - 0.02,
            "feedback_times": stim_on + 1.0,
            "firstMovement_times": stim_on + 0.3,
            "choice": rng.choice([-1.0, 1.0], self.n_trials),
            "feedbackType": np.ones(self.n_trials),
            "probabilityLeft": rng.choice([0.2, 0.5, 0.8], self.n_trials),
            "rewardVolume": np.full(self.n_trials, 1.5),
            "contrastLeft": rng.choice([0.0, 0.25, np.nan], self.n_trials),
            "contrastRight": rng.choice([0.0, 0.25, np.nan], self.n_trials),
        }
        assert set(trials_values) == set(TRIALS_COLUMNS)
        trials = pd.DataFrame({c: trials_values[c] for c in TRIALS_COLUMNS})

        wheel_values = {
            "times": cam_times,
            "position": np.cumsum(rng.normal(size=n_cam)) / self.fps,
            "velocity": rng.normal(size=n_cam),
        }
        wheel = pd.DataFrame({c: wheel_values[c] for c in WHEEL_COLUMNS})
        me = pd.DataFrame({
            "times": cam_times,
            "whiskerMotionEnergy": np.abs(rng.normal(size=n_cam)),
        })[list(MOTION_ENERGY_COLUMNS)]

        dlc_cols = {}
        anchors = {"nose_tip": (14, 30), "pupil_top_r": (38, 14),
                   "pupil_bottom_r": (38, 20), "pupil_left_r": (35, 17),
                   "pupil_right_r": (41, 17), "paw_l": (20, 44),
                   "paw_r": (44, 44)}
        for point in dict.fromkeys(DLC_POINTS + DLC_SPEED_FEATURES):
            ax, ay = anchors[point]
            vals = {"_x": ax + rng.normal(0, 0.3, n_cam),
                    "_y": ay + rng.normal(0, 0.3, n_cam),
                    "_likelihood": np.full(n_cam, 0.99)}
            for sfx in DLC_POINT_SUFFIXES:
                dlc_cols[f"{point}{sfx}"] = vals[sfx]
        dlc = pd.DataFrame(dlc_cols)

        # pupil diameter traces: the smooth feature column and a
        # lightning-pose table whose |right_x-left_x| == |top_y-bottom_y|
        # exactly (the reference asserts allclose between the two)
        diameter = 6.0 + 0.5 * np.sin(cam_times)
        features_values = {
            "pupilDiameter_raw": diameter + rng.normal(0, 0.05, n_cam),
            "pupilDiameter_smooth": diameter,
        }
        assert set(features_values) == set(DLC_FEATURES_COLUMNS)
        features = pd.DataFrame(
            {c: features_values[c] for c in DLC_FEATURES_COLUMNS})
        lp_values = {
            "pupil_left_r_x": 38.0 - diameter / 2,
            "pupil_right_r_x": 38.0 + diameter / 2,
            "pupil_top_r_y": 17.0 - diameter / 2,
            "pupil_bottom_r_y": 17.0 + diameter / 2,
        }
        assert set(lp_values) == set(LP_COLUMNS)
        lp = pd.DataFrame({c: lp_values[c] for c in LP_COLUMNS})

        n_total = 2 * self.n_neurons_per_probe
        spike_times = np.sort(rng.uniform(0, session_len, 6000))
        spike_clusters = rng.integers(0, n_total, 6000)

        self.data = dict(cam_times=cam_times, video=video, trials=trials,
                         wheel=wheel, me=me, dlc=dlc, features=features,
                         lp=lp, spike_times=spike_times,
                         spike_clusters=spike_clusters)


class _RawEphys:
    fs = 30000.0


class StrictSpikeLoader:
    def __init__(self, session: ContractSession, probe: int):
        self._s = session
        self._probe = probe

    def raw_electrophysiology(self, band, stream):
        if band != "ap" or stream is not True:
            raise ContractError(f"raw_electrophysiology({band=}, {stream=})")
        return _RawEphys()

    def load_spike_sorting(self):
        import pandas as pd

        s, n = self._s, self._s.n_neurons_per_probe
        lo = self._probe * n
        sel = ((s.data["spike_clusters"] >= lo)
               & (s.data["spike_clusters"] < lo + n))
        spikes = {
            "times": s.data["spike_times"][sel].astype(np.float64),
            "clusters": (s.data["spike_clusters"][sel] - lo).astype(np.int32),
            "amps": np.ones(int(sel.sum()), np.float64),
            "depths": np.zeros(int(sel.sum()), np.float64),
        }
        assert set(spikes) == set(SPIKES_KEYS)
        clusters = {"probe": self._probe, "n": n}
        channels = {}
        return spikes, clusters, channels


def strict_merge_clusters(spikes, clusters, channels):
    import pandas as pd

    probe, n = clusters["probe"], clusters["n"]
    values = {
        "label": np.where(np.arange(n) % 3 == 0, 0.5, 1.0),
        "acronym": [f"REG{probe}"] * n,
        "channels": np.arange(n),
        "depths": np.linspace(0, 1000, n),
        "uuids": [f"p{probe}c{i}" for i in range(n)],
    }
    assert set(values) == set(CLUSTER_TABLE_COLUMNS)
    return pd.DataFrame({c: values[c] for c in CLUSTER_TABLE_COLUMNS})


class StrictSessionLoader:
    """Exposes exactly the contract surface; anything else raises."""

    def __init__(self, session: ContractSession):
        self._s = session
        self.trials = session.data["trials"]
        self.wheel = None
        self.motion_energy = {}

    def load_trials(self):
        pass

    def load_wheel(self):
        self.wheel = self._s.data["wheel"]

    def load_motion_energy(self, views):
        for v in views:
            if v not in [l for l in CAMERA_LABELS]:
                raise ContractError(f"unknown camera view {v!r}")
            if v in self._s.missing_views:
                raise FileNotFoundError(f"no {v} camera in this session")
            key = MOTION_ENERGY_KEY_FMT.format(view=v)
            self.motion_energy[key] = self._s.data["me"]


class StrictVidio:
    def __init__(self, session: ContractSession):
        self._s = session

    def url_from_eid(self, eid, one=None):
        return {label: f"fake://{label}-camera"
                for label in CAMERA_LABELS
                if label not in self._s.missing_views}

    def label_from_path(self, url):
        m = re.match(r"fake://(\w+)-camera", url)
        if not m:
            raise ContractError(f"unknown url {url!r}")
        return m.group(1)

    def get_video_meta(self, url, one=None):
        s = self._s
        n = len(s.data["video"])
        meta = {"length": n, "fps": s.fps, "width": s.width,
                "height": s.height, "duration": n / s.fps,
                "size": n * s.width * s.height * 3}
        assert set(meta) == set(VIDEO_META_KEYS)
        return meta

    def get_video_frames_preload(self, url, index, mask=None, quiet=True,
                                 func=None):
        frames = self._s.data["video"][np.asarray(index)]
        out = [f[mask] if mask is not None else f for f in frames]
        if func is not None:
            out = [func(f) for f in out]
        return np.stack(out)


class StrictONE:
    def __init__(self, session: ContractSession):
        self._s = session

    def eid2pid(self, eid):
        return ["pid-a", "pid-b"], ["probe00", "probe01"]

    def load_dataset(self, eid, name, collection=None):
        for label in CAMERA_LABELS:
            if name == CAMERA_TIMES_DATASET.format(label=label):
                if collection != CAMERA_TIMES_COLLECTION:
                    raise ContractError(
                        f"camera times collection {collection!r}")
                return self._s.data["cam_times"]
        raise ContractError(f"load_dataset({name!r}) outside the contract")

    def load_object(self, eid, obj, attribute=None, collection=None):
        cams = [DLC_OBJECT_FMT.format(camera=c) for c in CAMERA_LABELS]
        if obj not in cams:
            raise ContractError(f"load_object({obj!r}) outside the contract")
        # lightning-pose shape: attribute=['lightningPose','times'], no
        # collection (ibl_data_utils.py:530-535)
        if attribute is not None and set(attribute) == set(LP_OBJECT_ATTRIBUTES):
            if collection is not None:
                raise ContractError(
                    f"lightningPose load carries no collection, "
                    f"got {collection!r}")
            return {"lightningPose": self._s.data["lp"],
                    "times": self._s.data["cam_times"]}
        if collection != DLC_COLLECTION:
            raise ContractError(f"dlc collection {collection!r}")
        if attribute is not None and not set(attribute) <= set(DLC_ATTRIBUTES):
            raise ContractError(f"dlc attributes {attribute!r}")
        return {"dlc": self._s.data["dlc"],
                "features": self._s.data["features"],
                "times": self._s.data["cam_times"]}


def build_contract_mocks(**session_kwargs):
    """(one, providers, session) built strictly from the recorded schema."""
    from video_spike_torch.data.one_ingest import Providers

    session = ContractSession(**session_kwargs)
    providers = Providers(
        spike_loader=lambda one, pid, eid, pname: StrictSpikeLoader(
            session, probe=0 if pid.endswith("a") else 1),
        merge_clusters=strict_merge_clusters,
        sess_loader=lambda one, eid: StrictSessionLoader(session),
        vidio=StrictVidio(session),
    )
    return StrictONE(session), providers, session
