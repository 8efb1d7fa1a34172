"""PyTorch port of the offline ETL (``data/ibl.py``, ``cli/prepare_data.py``,
``cli/cal_of.py``) against the JAX package, and ``cli.test``'s argv.

The same numpy inputs, made from a seed, go through both packages on the
CPU (JAX at ``jax_default_matmul_precision`` "highest"). Tolerances:

- ``data/ibl.py`` is numpy in both: equal outputs, and
  ``tests/test_ibl_etl.py``'s checks on the port's;
- ``etl_session`` and ``prepare_data.main`` on one
  ``make_raw_session`` npz (at its small default ROI, 1 pyramid level, and
  at a 40×60 ROI, 3 levels): the same shard names, members, keys, ``meta``
  and dtypes; ``ap``, ``choice``, ``block``, ``wheel-speed``,
  ``whisker-motion-energy``, ``timestamp`` and both videos equal;
  ``whisker-of`` and ``whisker-of-2d`` within atol 1e-4;
  ``whisker-of-video`` within 1e-3 of its largest value (float32 flow);
- ``cal_of``: a GIF each, the ``of`` features within atol 1e-4.
"""

import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from video_spike_tpu.cli import prepare_data as jprep
from video_spike_tpu.data import ibl as jibl
from video_spike_torch.cli import prepare_data as tprep
from video_spike_torch.data import ibl as tibl
from video_spike_torch.data.synthetic import make_raw_session
from video_spike_torch.data.tar_io import read_trial_tar

torch.set_num_threads(1)

EXACT = ("ap", "choice", "block", "wheel-speed", "whisker-motion-energy",
         "timestamp", "video", "whisker-video")
OF_ATOL = 1e-4
FIELD_REL = 1e-3
# DLC anchors for a 40x60 whisker ROI at (32, 10) in a 64x96 frame: d = 120
WIDE_ROI = dict(height=64, width=96, nose_xy=(2.5, 10.5),
                pupil_xy=(122.5, 10.5))


def assert_same_shards(got_files, ref_files) -> dict:
    """The port's shards against JAX's, to the module's tolerances; returns
    the largest differences of the flow features."""
    assert [Path(f).name for f in got_files] == \
        [Path(f).name for f in ref_files]
    assert got_files, "no shards written"
    worst = {"of": 0.0, "field_rel": 0.0}
    for g, r in zip(got_files, ref_files):
        with tarfile.open(g) as tg, tarfile.open(r) as tr:
            assert tg.getnames() == tr.getnames()
        got, ref = read_trial_tar(g), read_trial_tar(r)
        assert got.keys() == ref.keys()
        assert got["meta"] == ref["meta"]
        assert got["__key__"] == ref["__key__"]
        for k in got.keys() - {"meta", "__key__", "eid"}:
            assert got[k].dtype == ref[k].dtype, k
            assert got[k].shape == ref[k].shape, k
        for k in EXACT:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        for k in ("whisker-of", "whisker-of-2d"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=OF_ATOL,
                                       err_msg=k)
            worst["of"] = max(worst["of"],
                              float(np.abs(got[k] - ref[k]).max()))
        f_got, f_ref = got["whisker-of-video"], ref["whisker-of-video"]
        rel = float(np.abs(f_got - f_ref).max() / np.abs(f_ref).max())
        assert rel <= FIELD_REL, rel
        worst["field_rel"] = max(worst["field_rel"], rel)
    return worst


# ---------------------------------------------------------------------------
# data/ibl.py: tests/test_ibl_etl.py's cases, through both packages
# ---------------------------------------------------------------------------

def test_dlc_speed_golden():
    times = np.array([0.0, 1.0, 2.0])
    dlc = {"paw_l_x": np.array([0.0, 3.0, 3.0]),
           "paw_l_y": np.array([0.0, 4.0, 4.0])}
    for cam in ("right", "left"):
        out = tibl.dlc_speed(dlc, times, camera=cam, feature="paw_l")
        np.testing.assert_array_equal(
            out, jibl.dlc_speed(dlc, times, camera=cam, feature="paw_l"))
    out = tibl.dlc_speed(dlc, times, camera="right", feature="paw_l")
    np.testing.assert_allclose(out, [1125.0, 375.0, -375.0])


def test_dlc_speed_matches_scipy_interp1d():
    from scipy.interpolate import interp1d

    rng = np.random.default_rng(3)
    times = np.sort(rng.uniform(0.0, 5.0, 50))
    dlc = {"nose_tip_x": rng.normal(size=50), "nose_tip_y": rng.normal(size=50)}
    out = tibl.dlc_speed(dlc, times, camera="body", feature="nose_tip")
    np.testing.assert_array_equal(
        out, jibl.dlc_speed(dlc, times, camera="body", feature="nose_tip"))
    s = np.sqrt(np.diff(dlc["nose_tip_x"]) ** 2
                + np.diff(dlc["nose_tip_y"]) ** 2) * 30
    tv = times[:-1] + np.diff(times) / 2
    np.testing.assert_allclose(out, interp1d(tv, s, fill_value="extrapolate")
                               (times), rtol=1e-9)


@pytest.mark.parametrize("n_times,n_trace,match", [(4, 3, "length"),
                                                   (2, 2, "at least 3")])
def test_dlc_speed_validates_inputs(n_times, n_trace, match):
    dlc = {"paw_r_x": np.zeros(n_trace), "paw_r_y": np.zeros(n_trace)}
    for mod in (tibl, jibl):
        with pytest.raises(ValueError, match=match):
            mod.dlc_speed(dlc, np.arange(float(n_times)), camera="left")


def test_create_intervals():
    iv = tibl.create_intervals(0.0, 10.0, 2.0)
    np.testing.assert_array_equal(iv, jibl.create_intervals(0.0, 10.0, 2.0))
    assert iv.shape == (4, 2)


def test_bin_spikes_counts_and_histogram(rng):
    times = np.array([0.01, 0.05, 0.05, 1.99, 2.5, 3.999])
    clusters = np.array([0, 1, 1, 0, 0, 1])
    iv = np.array([[0.0, 2.0], [2.0, 4.0]])
    out = tibl.bin_spikes(times, clusters, iv, binsize=0.02, n_clusters=2)
    np.testing.assert_array_equal(
        out, jibl.bin_spikes(times, clusters, iv, binsize=0.02, n_clusters=2))
    assert out.shape == (2, 2, 100) and out.sum() == 6
    assert out[0, 1, 2] == 2 and out[0, 0, 99] == 1 and out[1, 1, 99] == 1

    times = np.sort(rng.uniform(0, 20, 5000))
    clusters = rng.integers(0, 7, 5000)
    iv = tibl.create_intervals(0.0, 20.0, 2.0)
    out = tibl.bin_spikes(times, clusters, iv, binsize=0.02, n_clusters=7)
    np.testing.assert_array_equal(
        out, jibl.bin_spikes(times, clusters, iv, binsize=0.02, n_clusters=7))
    for k in [0, 3, len(iv) - 1]:
        m = (times >= iv[k, 0]) & (times < iv[k, 1])
        ref, _, _ = np.histogram2d(
            clusters[m], times[m],
            bins=[np.arange(8) - 0.5,
                  np.arange(iv[k, 0], iv[k, 1] + 1e-9, 0.02)])
        np.testing.assert_array_equal(out[k], ref)


@pytest.mark.parametrize("case", ["good_and_bad", "nan_skip"])
def test_interp_behavior(case):
    if case == "good_and_bad":
        t = np.arange(0, 10, 1 / 100)
        v = np.sin(t)
        iv = np.array([[1.0, 3.0], [8.5, 10.5]])  # 2nd runs past the data
    else:
        t = np.arange(0, 4, 0.01)
        v = np.ones_like(t)
        v[150] = np.nan
        iv = np.array([[0.5, 2.5], [2.99, 3.99]])  # 1st holds the NaN
    times, vals, good = tibl.interp_behavior(t, v, iv, freq=60)
    jtimes, jvals, jgood = jibl.interp_behavior(t, v, iv, freq=60)
    assert list(good) == list(jgood)
    assert not good[1 if case == "good_and_bad" else 0]
    for a, b in zip(vals + times, jvals + jtimes):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    if case == "good_and_bad":
        assert good[0] and vals[0].shape == (120,)
        np.testing.assert_allclose(vals[0], np.sin(times[0]), atol=2e-3)


def test_align_spike_behavior():
    spikes = np.ones((4, 3, 10))
    behaviors = {
        "wheel-speed": [np.arange(5.0), None, np.arange(5.0), np.arange(5.0)],
        "whisker-motion-energy": [np.ones(5), np.ones(5), None, np.ones(5)],
    }
    out = tibl.align_spike_behavior(spikes, behaviors, list(behaviors))
    ref = jibl.align_spike_behavior(spikes, behaviors, list(behaviors))
    for a, b in ((out[0], ref[0]), (out[2], ref[2]), (out[3], ref[3])):
        np.testing.assert_array_equal(a, b)
    for k in behaviors:
        np.testing.assert_array_equal(out[1][k], ref[1][k])
    assert list(out[2]) == [True, False, False, True]
    assert out[1]["wheel-speed"].max() == 1.0


def test_active_neuron_mask():
    spikes = np.zeros((5, 3, 100))
    spikes[:, 0] = 1.0
    spikes[:, 1, :3] = 1.0
    mask = tibl.active_neuron_mask(spikes, interval_len=2.0, min_rate_hz=2.0)
    assert list(mask) == list(jibl.active_neuron_mask(spikes, 2.0, 2.0)) \
        == [True, False, False]


def test_dlc_midpoint_and_roi():
    n = 100
    dlc = {
        "nose_tip_x": np.full(n, 20.0), "nose_tip_y": np.full(n, 40.0),
        "nose_tip_likelihood": np.full(n, 0.99),
        "pupil_top_r_x": np.full(n, 44.0), "pupil_top_r_y": np.full(n, 22.0),
        "pupil_top_r_likelihood": np.full(n, 0.99),
    }
    assert tibl.get_dlc_midpoint(dlc, "nose_tip") == (20, 40)
    roi, mask = tibl.whisker_pad_roi_from_dlc(dlc)
    jroi, jmask = jibl.whisker_pad_roi_from_dlc(dlc)
    np.testing.assert_array_equal(roi, jroi)
    assert mask == jmask
    dist = np.sqrt(24 ** 2 + 18 ** 2)
    assert roi[0] == int(dist / 2) and roi[1] == int(dist / 3)
    dlc_bad = dict(dlc, nose_tip_likelihood=np.zeros(n))
    with pytest.raises(ValueError):
        tibl.get_dlc_midpoint(dlc_bad, "nose_tip")
    with pytest.raises(ValueError):
        tibl.whisker_pad_roi((0, 0), (2, 40))


def test_merge_probes(rng):
    spikes_list = [{"times": np.sort(rng.uniform(0, 5, 50)),
                    "clusters": rng.choice([3, 7, 9], 50)},
                   {"times": np.sort(rng.uniform(0, 5, 40)),
                    "clusters": rng.choice([0, 2], 40)}]
    meta_list = [{"depth": np.arange(10.0)}, {"depth": np.arange(3.0) + 100}]
    merged, meta = tibl.merge_probes(spikes_list, meta_list)
    jmerged, jmeta = jibl.merge_probes(spikes_list, meta_list)
    for k in merged:
        np.testing.assert_array_equal(merged[k], jmerged[k])
    np.testing.assert_array_equal(meta["depth"], jmeta["depth"])
    assert merged["clusters"].max() == 4
    assert np.all(np.diff(merged["times"]) >= 0)


def test_load_one_session_needs_ibllib():
    try:
        import one.api  # noqa: F401
        pytest.skip("the ONE api is installed here")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="ibllib"):
        tibl.load_one_session("eid")


# ---------------------------------------------------------------------------
# etl_session and prepare_data.main: both packages on one raw npz
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_npz(tmp_path_factory):
    """{placement: npz path}: the default (10x15 ROI, 1 pyramid level) and
    WIDE_ROI (40x60, 3 levels), 4 trials of 12 neurons each."""
    d = tmp_path_factory.mktemp("raw")
    return {"default": make_raw_session(d / "default.npz", eid="etlsess000",
                                        n_trials=4, n_neurons=12, seed=11),
            "wide": make_raw_session(d / "wide.npz", eid="etlsess000",
                                     n_trials=4, n_neurons=12, seed=11,
                                     **WIDE_ROI)}


def test_raw_session_equals_jax(tmp_path):
    """At its defaults the port's make_raw_session writes JAX's npz."""
    from video_spike_tpu.data.synthetic import make_raw_session as jmake

    got = np.load(make_raw_session(tmp_path / "a.npz", n_trials=3,
                                   n_neurons=9, seed=4))
    ref = np.load(jmake(tmp_path / "b.npz", n_trials=3, n_neurons=9, seed=4))
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("placement,levels,roi", [
    ("default", 1, [15, 10, 23, 30]),
    ("wide", 3, [60, 40, 32, 10])])
def test_etl_session_matches_jax(raw_npz, tmp_path, placement, levels, roi):
    raw = dict(np.load(raw_npz[placement], allow_pickle=True))
    ref = jprep.etl_session(raw, tmp_path / "jax", "etlsess000")
    got = tprep.etl_session(raw, tmp_path / "torch", "etlsess000",
                            device="cpu")
    assert len(got) == 4
    assert_same_shards(got, ref)
    sample = read_trial_tar(got[0])
    assert sample["meta"]["whisker_roi"] == roi
    h, w = sample["whisker-video"].shape[-2:]
    n_levels = 1
    while n_levels < 3 and min(h, w) * 0.5 >= 10:
        h, w = round(h * 0.5), round(w * 0.5)
        n_levels += 1
    assert n_levels == levels
    assert sample["ap"].shape[0] == 100
    assert sample["whisker-of-video"].shape == (119, roi[1], roi[0], 2)


@pytest.mark.parametrize("backend", ["jax", "cv2"])
def test_prepare_data_main_same_argv(raw_npz, tmp_path, backend):
    """One argv through both CLIs (the port's adds --device cpu): the
    reference's --flow_backend jax runs the port's torch flow; cv2 is the
    same OpenCV call in both, so its shards are equal."""
    if backend == "cv2":
        pytest.importorskip("cv2")
    argv = ["--eid", "etlsess000", "--raw_npz", raw_npz["default"],
            "--flow_backend", backend, "--min_rate_hz", "1.0"]
    ref = jprep.main(argv + ["--base_path", str(tmp_path / "jax")])
    got = tprep.main(argv + ["--base_path", str(tmp_path / "torch"),
                             "--device", "cpu"])
    worst = assert_same_shards(got, ref)
    if backend == "cv2":
        assert worst == {"of": 0.0, "field_rel": 0.0}


def test_prepare_data_cli_errors(tmp_path):
    with pytest.raises(SystemExit) as e:
        tprep.main(["--eid", "x", "--base_path", str(tmp_path),
                    "--device", "cpu"])
    assert e.value.code == 2
    # --source one fails only at the network edge, naming ibllib
    with pytest.raises(RuntimeError, match="ibllib"):
        tprep.main(["--eid", "x", "--base_path", str(tmp_path),
                    "--source", "one", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tprep.main(["--eid", "x", "--base_path", str(tmp_path)])


def test_select_eids(tmp_path, monkeypatch):
    """The BWM manifest draw and data/eid.txt, as the JAX CLI selects."""
    eids = tprep.select_bwm_eids("data/bwm_release.csv", n_sessions=6,
                                 seed=42)
    assert eids == jprep.select_bwm_eids("data/bwm_release.csv", 6, seed=42)
    assert len(set(eids)) == 6 and all(len(e) == 36 for e in eids)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    (tmp_path / "data/eid.txt").write_text("a\nb\n\nc\n")
    import argparse
    args = argparse.Namespace(eid=None, datasets="reproducible-ephys",
                              n_sessions=2, seed=42)
    assert tprep.select_eids(args) == jprep.select_eids(args) == ["a", "b"]
    args.eid = "z"
    assert tprep.select_eids(args) == ["z"]


# ---------------------------------------------------------------------------
# cal_of, and cli.test's --plot_dir
# ---------------------------------------------------------------------------

def test_cal_of_matches_jax(tmp_path):
    pytest.importorskip("imageio")
    from video_spike_tpu.cli import cal_of as jcal
    from video_spike_torch.cli import cal_of as tcal
    from video_spike_torch.data.synthetic import make_synthetic_session

    make_synthetic_session(tmp_path / "fx", eid="calofsess0", n_trials=3,
                           n_neurons=5, height=24, width=24)
    argv = ["--data_dir", str(tmp_path / "fx"), "--eid", "calofsess0",
            "--modality", "video", "--trial", "1"]
    ref = jcal.main(argv + ["--out", str(tmp_path / "jax.gif")])
    got = tcal.main(argv + ["--out", str(tmp_path / "torch.gif"),
                            "--device", "cpu"])
    for name in ("jax.gif", "torch.gif"):
        assert (tmp_path / name).stat().st_size > 0
    for k in ("of", "of-2d", "me"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=OF_ATOL,
                                   err_msg=k)
    assert got["of-video"].shape == (119, 24, 24, 2)


class _Parsed(Exception):
    """Raised by a stub just after a CLI has parsed its argv."""


@pytest.mark.parametrize("argv,code", [
    (["--plot_dir", "x"], None),
    (["--plot_dir", "x", "--h5_path", "y.h5", "--model", "cm"], None),
    (["--no_such_flag", "x"], 2)])
def test_cli_test_argv(monkeypatch, argv, code):
    """The port's and the JAX cli.test accept the same argv (--plot_dir
    without --save_plot) and reject the same unknown flag."""
    from video_spike_tpu.cli import test as jtest
    from video_spike_torch.cli import test as ttest

    def parsed(*a, **k):
        raise _Parsed

    monkeypatch.setattr(jtest, "config_from_kwargs", parsed)
    monkeypatch.setattr(ttest, "resolve_device", parsed)
    for mod in (jtest, ttest):
        if code is None:
            with pytest.raises(_Parsed):
                mod.main(argv)
        else:
            with pytest.raises(SystemExit) as e:
                mod.main(argv)
            assert e.value.code == code


def test_cli_test_save_plot_raises(monkeypatch):
    """--save_plot on a machine without matplotlib (the card's) raises an
    ImportError naming it before any work."""
    from video_spike_torch.cli import test as ttest

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        ttest.main(["--plot_dir", "x", "--save_plot"])
