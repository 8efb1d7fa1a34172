"""PyTorch port of the ONE-api ingestion (``data/one_ingest.py``,
``data/one_contract.py``) against the JAX package.

Each package runs against its own copy of the strict contract mocks
(``one_contract.build_contract_mocks``), built from the same seed; no test
touches ibllib or the network. Tolerances are ``tests/test_torch_etl.py``'s:
loaders and binning equal, shards equal but for the float32 flow
(``whisker-of``/``-2d`` atol 1e-4, the field 1e-3 of its largest value),
at 1 pyramid level (the contract's 9x14 ROI) and at 3 (a 40x60 ROI).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_etl import assert_same_shards
from video_spike_tpu.data import one_contract as joc
from video_spike_tpu.data import one_ingest as joi
from video_spike_torch.data import one_contract as toc
from video_spike_torch.data import one_ingest as toi
from video_spike_torch.data.tar_io import read_trial_tar

torch.set_num_threads(1)

EID = "contract-eid"


def _mask_two_trials(session):
    """tests/test_one_ingest.py's session: trial 1 without a choice, trial
    3 without a stimulus onset; both must be dropped."""
    trials = session.data["trials"].copy()
    trials.loc[1, "choice"] = 0.0
    trials.loc[3, "stimOn_times"] = np.nan
    session.data["trials"] = trials


def _wide_roi(session):
    """Nose tip and top pupil point 120 px apart: a 40x60 ROI, 3 pyramid
    levels. The camera shows a smooth texture moving along a sine (gray as
    RGB) in place of the contract's uniform noise. On noise-dominated
    frames the two float32 flows can part beyond the tolerances: every
    frame's mean flow is alike, so the min-max normalization of ``of``
    divides by a small range, and single field pixels sit on an
    ill-conditioned 2x2 solve."""
    from scipy import ndimage

    dlc = session.data["dlc"].copy()
    for point, (x, y) in (("nose_tip", (2, 10)), ("pupil_top_r", (122, 10))):
        dlc[f"{point}_x"] = float(x)
        dlc[f"{point}_y"] = float(y)
    session.data["dlc"] = dlc
    n, h, w = session.data["video"].shape[:3]
    rng = np.random.default_rng(session.seed)
    base = ndimage.gaussian_filter(rng.normal(size=(h, w)), 3)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    pos = 3 * np.sin(np.arange(n) / 10)
    gray = np.stack([ndimage.shift(base, (0.5 * p, p), order=1,
                                   mode="reflect") for p in pos])
    session.data["video"] = np.repeat(gray.astype(np.uint8)[..., None], 3,
                                      axis=-1)


@pytest.fixture(scope="module")
def mocks():
    """(port's (one, providers, session), JAX's) on the masked session."""
    out = []
    for oc in (toc, joc):
        one, providers, session = oc.build_contract_mocks()
        _mask_two_trials(session)
        out.append((one, providers, session))
    return out


def test_contract_sessions_equal(mocks):
    (_, _, t), (_, _, j) = mocks
    assert t.data.keys() == j.data.keys()
    for k, v in t.data.items():
        if isinstance(v, pd.DataFrame):
            pd.testing.assert_frame_equal(v, j.data[k])
        else:
            np.testing.assert_array_equal(v, j.data[k], err_msg=k)
    for name in ("TRIALS_COLUMNS", "CLUSTER_TABLE_COLUMNS", "WHEEL_COLUMNS",
                 "DLC_POINTS", "DLC_SPEED_FEATURES", "LP_COLUMNS",
                 "VIDEO_META_KEYS", "VIDIO_FUNCTIONS"):
        assert getattr(toc, name) == getattr(joc, name), name
    assert set(toi.DEFAULT_NAN_EXCLUDE) <= set(toc.TRIALS_COLUMNS)
    assert toi.DEFAULT_PARAMS == joi.DEFAULT_PARAMS
    assert toi.BEH_NAMES == joi.BEH_NAMES


@pytest.mark.parametrize("levels", [1, 3])
def test_ingest_matches_jax(tmp_path, levels):
    """Both packages' ingest_one_session from the same contract mocks."""
    pytest.importorskip("cv2")       # the 128x128 whole-frame resize
    files = {}
    for name, oc, oi, kw in (("jax", joc, joi, {"flow_backend": "jax"}),
                             ("torch", toc, toi, {"device": "cpu"})):
        size = {"height": 64, "width": 96} if levels == 3 else {}
        one, providers, session = oc.build_contract_mocks(n_trials=4, **size)
        if levels == 3:
            _wide_roi(session)
        files[name] = oi.ingest_one_session(
            one, EID, tmp_path / name, providers=providers,
            store_video_as="npy", **kw)
    assert len(files["torch"]) == 4
    assert_same_shards(files["torch"], files["jax"])
    sample = read_trial_tar(files["torch"][0])
    roi = [60, 40, 32, 10] if levels == 3 else [14, 9, 18, 21]
    assert sample["meta"]["whisker_roi"] == roi
    assert sample["meta"]["sample_freq"] == 30000.0
    assert sample["ap"].shape[0] == 100
    assert sample["video"].shape == (120, 1, 128, 128)
    assert sample["whisker-of-video"].shape == (119, roi[1], roi[0], 2)


def test_ingest_drops_masked_trials(mocks, tmp_path):
    pytest.importorskip("cv2")
    (one, providers, _), _ = mocks
    files = toi.ingest_one_session(one, EID, tmp_path, providers=providers,
                                   store_video_as="npy", device="cpu")
    assert len(files) == 8 - 2
    sample = read_trial_tar(files[0])
    assert sample["meta"]["eid"] == EID
    assert 0.0 <= sample["whisker-motion-energy"].min() <= 1.0
    assert sample["whisker-of-2d"].shape == (120, 2)


def _both(mocks, fn):
    """fn(one_ingest module, one, providers, session) through each
    package."""
    return [fn(oi, *m) for oi, m in zip((toi, joi), mocks)]


def test_load_spiking_data_qc_filter(mocks):
    got, ref = _both(mocks, lambda oi, one, p, s: oi.load_spiking_data(
        one, "pid-a", p, qc=1.0))
    assert got[2] == ref[2] == 30000.0
    pd.testing.assert_frame_equal(got[1], ref[1])
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k])
    assert len(got[1]) == 4 and got[0]["clusters"].max() == 3


def test_merge_probe_dataframes(mocks):
    def merge(oi, one, p, s):
        parts = [oi.load_spiking_data(one, pid, p)[:2]
                 for pid in ("pid-a", "pid-b")]
        return oi.merge_probe_dataframes([q[0] for q in parts],
                                         [q[1] for q in parts])

    (spikes, clusters), (jspikes, jclusters) = _both(mocks, merge)
    pd.testing.assert_frame_equal(clusters, jclusters)
    for k in spikes:
        np.testing.assert_array_equal(spikes[k], jspikes[k])
    assert len(clusters) == 12 and np.all(np.diff(spikes["times"]) >= 0)


def test_load_trials_and_mask(mocks):
    got, ref = _both(mocks, lambda oi, one, p, s: oi.load_trials_and_mask(
        one, EID, p))
    np.testing.assert_array_equal(got[1], ref[1])
    assert not got[1][1] and not got[1][3] and got[1].sum() == 6


#: tests/test_one_contract.py's targets: every reference behavior target
ALL_BEHAVIOR_TARGETS = (
    "wheel-position", "wheel-velocity", "wheel-speed",
    "left-whisker-motion-energy",
    "left-pupil-diameter", "right-pupil-diameter",
    "dlc-pupil-bottom-r-y", "dlc-pupil-top-r-y",
    "dlc-pupil-left-r-x", "dlc-pupil-right-r-x",
    "lightning-pose-left-pupil-diameter",
    "lightning-pose-right-pupil-diameter",
    "left-camera-left-paw-speed", "left-camera-right-paw-speed",
    "right-camera-left-paw-speed", "right-camera-right-paw-speed",
    "left-nose-speed", "right-nose-speed",
)


@pytest.mark.parametrize("target", ALL_BEHAVIOR_TARGETS)
def test_behavior_target_matches_jax(mocks, target):
    got, ref = _both(mocks, lambda oi, one, p, s: oi.load_target_behavior(
        one, EID, target, p))
    assert not got.get("skip") and not ref.get("skip"), target
    np.testing.assert_array_equal(got["times"], ref["times"])
    np.testing.assert_array_equal(got["values"], ref["values"])
    assert len(got["times"]) == len(got["values"])


@pytest.mark.parametrize("target", ["right-whisker-motion-energy",
                                    "no-such-target"])
def test_behavior_skip_contract(mocks, target):
    got, ref = _both(mocks, lambda oi, one, p, s: oi.load_target_behavior(
        one, EID, target, p))
    assert got.get("skip") and ref.get("skip")


def test_lightning_pose_mismatch_skips(mocks):
    (one, providers, session), _ = mocks

    class BadLpONE(type(one)):
        def load_object(self, eid, obj, attribute=None, collection=None):
            out = super().load_object(eid, obj, attribute, collection)
            if attribute is not None and "lightningPose" in attribute:
                lp = out["lightningPose"].copy()
                lp["pupil_top_r_y"] = lp["pupil_top_r_y"] + 1.0
                out = {**out, "lightningPose": lp}
            return out

    assert toi.load_target_behavior(BadLpONE(session), EID,
                                    "lightning-pose-left-pupil-diameter",
                                    providers).get("skip")


def test_bin_spiking_and_behaviors(mocks):
    def run(oi, one, p, s):
        trials = s.data["trials"]
        neural = {"spike_times": s.data["spike_times"],
                  "spike_clusters": s.data["spike_clusters"]}
        binned, used, intervals = oi.bin_spiking_data(
            np.unique(s.data["spike_clusters"]), neural, trials_df=trials)
        beh, masks = oi.bin_behaviors(
            one, EID, p, behaviors=("wheel-speed", "whisker-motion-energy",
                                    "left-pupil-diameter", "left-nose-speed"),
            trials_df=trials, allow_nans=True)
        return binned, used, intervals, beh, masks

    got, ref = _both(mocks, run)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (8, 100, 12)
    assert np.isnan(got[2][3]).all()          # the NaN-stimOn trial
    assert got[3].keys() == ref[3].keys() >= {"choice", "block", "reward",
                                              "contrast"}
    for k, m in got[4].items():
        np.testing.assert_array_equal(m, ref[4][k])
        good = np.where(m)[0]
        assert len(good) and got[3][k][good[0]].shape == (120,)
        for i in good:
            np.testing.assert_array_equal(got[3][k][i], ref[3][k][i])


def test_video_index_and_loading(mocks):
    def run(oi, one, p, s):
        trials, _ = oi.load_trials_and_mask(one, EID, p)
        intervals = oi.trial_intervals(trials[trials["stimOn_times"].notna()])
        index_list, url = oi.load_video_index(one, EID, "left", intervals, p)
        roi, mask = oi.get_whisker_pad_roi(one, EID, "left")
        return (index_list, oi.load_video(index_list[0], url, p), roi,
                oi.load_whisker_video(index_list[0], url, mask, p))

    got, ref = _both(mocks, run)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    index_list, frames, roi, whisker = got
    assert index_list.shape == (7, 120) and frames.shape == (120, 64, 64)
    assert whisker.shape == (120, roi[1], roi[0])


def test_brain_region_selection(mocks):
    def run(oi, one, p, s):
        parts = [oi.load_spiking_data(one, pid, p)[:2]
                 for pid in ("pid-a", "pid-b")]
        spikes, clusters = oi.merge_probe_dataframes(
            [q[0] for q in parts], [q[1] for q in parts])
        neural = {"spike_times": spikes["times"],
                  "spike_clusters": spikes["clusters"],
                  "cluster_regions": clusters["acronym"].to_numpy()}
        regions, beryl = oi.list_brain_regions(neural, single_region=True,
                                               acronym2acronym=lambda a: a)
        reg0 = oi.select_brain_regions(beryl, ["REG0"])
        return regions, reg0, oi.bin_spiking_data(
            reg0, neural, trials_df=s.data["trials"])[0]

    got, ref = _both(mocks, run)
    assert [list(r) for r in got[0]] == [list(r) for r in ref[0]] \
        == [["REG0"], ["REG1"]]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2].shape[-1] == 6


def test_mocks_are_strict():
    """The port's copy of the strict mocks bites as the JAX copy does."""
    one, providers, _ = toc.build_contract_mocks()
    with pytest.raises(toc.ContractError):
        one.load_dataset("eid", "_ibl_trials.table.pqt", collection="alf")
    with pytest.raises(toc.ContractError):
        one.load_object("eid", "wheel", collection="alf")
    sl = providers.sess_loader(one, "eid")
    with pytest.raises(KeyError):
        sl.trials["intervals_0"]
    with pytest.raises(AttributeError):
        sl.load_pose()
    with pytest.raises(FileNotFoundError):
        sl.load_motion_energy(views=["right"])
    with pytest.raises(toc.ContractError):
        sl.load_motion_energy(views=["topdown"])
    assert set(providers.vidio.get_video_meta("fake://left-camera")) \
        == set(toc.VIDEO_META_KEYS)
    assert isinstance(providers, toi.Providers)


def test_providers_default_needs_ibllib():
    try:
        import ibllib.io.video  # noqa: F401
        pytest.skip("ibllib is installed here")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="ibllib"):
        toi.Providers.default()
