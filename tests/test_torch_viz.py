"""PyTorch port of the figures and the results CLIs against the JAX package:
``viz/plots.py``, ``viz/raster.py``, ``viz/embeddings.plot_embeddings_anim``,
``cli/visualize_result.py`` (``get_log``), ``cli/plot_raster.py`` and
``cli/plot_scatter.py`` against the repo-root scripts, the trainer's
``save_plot`` figures and ``cli.test --save_plot``.

The same numpy arrays, made from a seed, go to both packages. Tolerances:
figures have the same axes, titles, labels, texts and tick labels, and
their line, scatter and image data agree at rtol 1e-6; ``neuronwise_r2``
and ``population_bps`` at rtol 1e-12 (both numpy float64); ``get_log``
frames equal; the CLIs write the same file names, and the same pixels;
the trainers write the same PNG names and figure records.
``cli.test --save_plot`` runs with ``plot_embeddings_anim`` replaced in both
packages by a stub that writes an empty file (the real one renders 120
matplotlib frames a trial, ~15 s here; it is compared on its own on a short
trajectory), so that run holds the CLI's file names.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from video_spike_tpu.viz import embeddings as jemb
from video_spike_tpu.viz import plots as jplots
from video_spike_tpu.viz import raster as jraster
from video_spike_torch.viz import embeddings as temb
from video_spike_torch.viz import plots as tplots
from video_spike_torch.viz import pyplot
from video_spike_torch.viz import raster as traster

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(fig):
    """What a figure shows: per axes its titles, labels, texts, tick labels
    and the data of its lines, scatters and images."""
    out = {"suptitle": fig._suptitle.get_text() if fig._suptitle else None,
           "axes": []}
    for ax in fig.axes:
        out["axes"].append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "texts": [t.get_text() for t in ax.texts],
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "lines": [np.column_stack([np.asarray(l.get_xdata(), float),
                                       np.asarray(l.get_ydata(), float)])
                      for l in ax.get_lines()],
            "offsets": [np.asarray(c.get_offsets(), float)
                        for c in ax.collections],
            "images": [np.asarray(im.get_array(), float)
                       for im in ax.get_images()]})
    return out


def _assert_same(got, ref, what=""):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), what
        for k in ref:
            _assert_same(got[k], ref[k], f"{what}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{what}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape, what
        np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=what)
    else:
        assert got == ref, what


def _compare(fig_t, fig_j):
    _assert_same(_summary(fig_t), _summary(fig_j))
    plt = pyplot()
    plt.close(fig_t)
    plt.close(fig_j)


@pytest.fixture
def results():
    """Two modalities' RRR-style results on one session: gt and preds
    (K trials, T bins, N neurons) and per-neuron co-bps."""
    rng = np.random.default_rng(0)
    gt = rng.poisson(1.0, (12, 20, 7)).astype(np.float64)
    out = {}
    for name in ("me", "of-2d"):
        pred = np.clip(gt + rng.normal(0, 0.8, gt.shape), 1e-3, None)
        out[name] = {"gt": gt, "pred": pred,
                     "co_bps": rng.normal(0.1, 0.05, 7)}
    return out


def test_plot_gt_pred_and_neurons_r2():
    rng = np.random.default_rng(1)
    gt = rng.poisson(1.0, (30, 6)).astype(float)
    pred = gt + rng.normal(0, 0.5, gt.shape)
    _compare(tplots.plot_gt_pred(gt.T, pred.T, epoch="3", modality="ap"),
             jplots.plot_gt_pred(gt.T, pred.T, epoch="3", modality="ap"))
    for idx in (range(3), [4]):
        _compare(tplots.plot_neurons_r2(gt, pred, neuron_idx=idx, epoch=2),
                 jplots.plot_neurons_r2(gt, pred, neuron_idx=idx, epoch=2))


def test_draw_results_boxplot():
    import pandas as pd

    rng = np.random.default_rng(2)
    df = pd.DataFrame({"test_bps": rng.normal(0.2, 0.1, 8),
                       "eid": [f"e{i}" for i in range(8)],
                       "mod": ["me", "of", "me", "video"] * 2})
    _compare(tplots.draw_results_boxplot(df),
             jplots.draw_results_boxplot(df))


def test_scatter_and_raster_figures(results):
    ref, mod = results["me"], results["of-2d"]
    _compare(traster.scatter_compare(ref, mod, "me", "of-2d", "abcdef"),
             jraster.scatter_compare(ref, mod, "me", "of-2d", "abcdef"))
    rng = np.random.default_rng(3)
    choice = rng.integers(0, 2, 12).astype(float)
    block = rng.choice([0.2, 0.8], 12)
    preds = {"me": ref["pred"], "of-2d": mod["pred"]}
    for kw in (dict(choice=choice, block=block), {}):
        _compare(traster.raster_grid(ref["gt"], preds, n_neurons=4,
                                     eid="abcdef", **kw),
                 jraster.raster_grid(ref["gt"], preds, n_neurons=4,
                                     eid="abcdef", **kw))


def test_neuronwise_r2_and_population_bps(results):
    for res in results.values():
        np.testing.assert_allclose(
            traster.neuronwise_r2(res["gt"], res["pred"]),
            jraster.neuronwise_r2(res["gt"], res["pred"]), rtol=1e-12)
        assert traster.population_bps(res) == pytest.approx(
            jraster.population_bps(res), rel=1e-12)


def test_embedding_figures(tmp_path):
    import imageio.v2 as imageio

    rng = np.random.default_rng(4)
    emb = rng.normal(size=(40, 3))
    _compare(temb.plot_embeddings(emb, title="t"),
             jemb.plot_embeddings(emb, title="t"))
    for d in (3, 2):
        paths = [str(tmp_path / f"{pkg}_{d}.gif") for pkg in ("t", "j")]
        temb.plot_embeddings_anim(emb[:8, :d], paths[0], fps=10, trail=4)
        jemb.plot_embeddings_anim(emb[:8, :d], paths[1], fps=10, trail=4)
        got, ref = (np.stack(imageio.mimread(p)) for p in paths)
        assert got.shape == ref.shape and got.shape[0] == 8
        np.testing.assert_array_equal(got, ref)


def test_get_log_frames_equal(tmp_path):
    import pandas as pd

    from video_spike_tpu.cli.visualize_result import get_log as j_get_log
    from video_spike_torch.cli.visualize_result import get_log as t_get_log

    rng = np.random.default_rng(5)
    for eid in ("aaaaa", "bbbbb"):
        for mod in ("video", "whisker-motion-energy"):
            d = tmp_path / eid / mod / "LinearModel"
            d.mkdir(parents=True)
            np.save(d / "test_results.npy", {"test_res": {
                "test_bps": float(rng.normal()),
                "test_rsquared": float(rng.normal())}})
    np.save(tmp_path / "other.npy", {"not": "a result"})
    got, ref = t_get_log(str(tmp_path)), j_get_log(str(tmp_path))
    assert len(got) == 4
    pd.testing.assert_frame_equal(got, ref)


def _run_in(directory, fn, argv):
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        fn(argv)
    finally:
        os.chdir(cwd)
    return sorted(os.listdir(directory))


def _pixels(path):
    import imageio.v2 as imageio

    return imageio.imread(path)


def _same_outputs(tmp_path, setup, t_main, j_main, argv):
    dirs = []
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        setup(d)
        dirs.append(d)
    before = sorted(os.listdir(dirs[0]))
    files_t = _run_in(dirs[0], t_main, argv)
    files_j = _run_in(dirs[1], j_main, argv)
    assert files_t == files_j and len(files_t) > len(before)
    for name in set(files_t) - set(before):
        np.testing.assert_array_equal(_pixels(dirs[0] / name),
                                      _pixels(dirs[1] / name))
    return set(files_t) - set(before)


def test_plot_raster_cli(tmp_path, results):
    import plot_raster as j_cli
    from video_spike_torch.cli import plot_raster as t_cli

    def setup(d):
        rng = np.random.default_rng(6)
        for mod in ("me", "of-2d"):
            np.save(d / f"{mod}_result.npy",
                    {"abcdef123": results[mod], "bcdefa123": results[mod]})
        (d / "data").mkdir()
        x = np.zeros((12, 20, 5))
        x[:, :, -2] = rng.integers(0, 2, (12, 1))
        x[:, :, -1] = 0.8
        np.save(d / "data" / "data_rrr_all.npy",
                {"abcdef123": {"X": [x, x]}})

    made = _same_outputs(tmp_path, setup, t_cli.main, j_cli.main,
                         ["--ref_mod", "me", "--input_mod", "of-2d"])
    assert made == {"abcde_scatter.png", "abcde_raster_plot.png",
                    "bcdef_scatter.png", "bcdef_raster_plot.png"}


def test_plot_scatter_cli(tmp_path, results):
    import plot_scatter as j_cli
    from video_spike_torch.cli import plot_scatter as t_cli

    def setup(d):
        (d / "eids.txt").write_text("abcdef123\nbcdefa123\n")
        for eid in ("abcde", "bcdef"):
            for mod in ("me", "of-2d"):
                np.save(d / f"{eid}_{mod}_result.npy", results[mod])

    made = _same_outputs(tmp_path, setup, t_cli.main, j_cli.main,
                         ["--ref_mod", "me", "--input_mod", "of-2d",
                          "--eid_file", "eids.txt"])
    assert made == {"scatter_r2_sessions.png", "scatter_bps_sessions.png"}


def test_visualize_result_cli(tmp_path):
    from video_spike_tpu.cli import visualize_result as j_cli
    from video_spike_torch.cli import visualize_result as t_cli

    def setup(d):
        rng = np.random.default_rng(7)
        for eid in ("aaaaa", "bbbbb", "ccccc"):
            for mod in ("video", "me"):
                r = d / "logs" / eid / mod / "LinearModel"
                r.mkdir(parents=True)
                np.save(r / "test_results.npy", {"test_res": {
                    "test_bps": float(rng.normal(0.2, 0.1))}})

    made = _same_outputs(tmp_path, setup, t_cli.main, j_cli.main,
                         ["--log_dir", "logs"])
    assert made == {"bps.png"}


def test_trainer_save_plot_writes_jax_figures(tmp_path):
    """Both BaseTrainers with save_plot from the same parameters: the same
    best_{trial,neuron}_<tag>.png files and figure records."""
    import json

    from test_torch_optim_variants import both_linear_trainers
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path / "fx"
    make_synthetic_session(d / "data", eid="optvr0000", n_trials=20,
                           n_neurons=6, seed=3, height=32, width=32)
    model = yaml.safe_load(open(os.path.join(
        REPO, "configs/model/linear_video.yaml")))
    model["encoder"].update(hidden_dims=[32, 16], output_dim=16)
    model["decoder"]["hidden_dims"] = [16, 256]
    (d / "model.yaml").write_text(yaml.safe_dump(model))
    jt, tt = both_linear_trainers(d, tmp_path, {"name": "adamw"}, epochs=2,
                                  extra={"save_plot": True})
    jt.train()
    tt.train()

    def pngs(log_dir):
        return sorted(f for f in os.listdir(log_dir) if f.endswith(".png"))

    def figures(log_dir):
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return [(r["figure"], os.path.basename(r["path"]), r["step"])
                for r in recs if "figure" in r]

    assert pngs(tt.log_dir) == pngs(jt.log_dir)
    assert {"best_trial_test.png", "best_neuron_test.png",
            "best_trial_0.png", "best_neuron_0.png"} <= set(pngs(tt.log_dir))
    assert figures(tt.log_dir) == figures(jt.log_dir)


def _stub_anim(embeddings, save_path, fps=20, trail=30):
    open(save_path, "wb").close()
    return save_path


def test_cli_test_save_plot_writes_jax_files(tmp_path, monkeypatch):
    """cli.test --save_plot after a tiny ContrastViT pretraining in each
    package: the same PNGs and GIFs under --plot_dir."""
    from test_torch_contrast import CREATE_ARGS, EID, TINY
    from video_spike_tpu.cli import pretrain as j_pretrain
    from video_spike_tpu.cli import test as j_test
    from video_spike_tpu.cli.create_eid_data import main as j_create
    from video_spike_torch.cli import pretrain as t_pretrain
    from video_spike_torch.cli import test as t_test
    from video_spike_torch.data.synthetic import make_synthetic_session

    fx = tmp_path / "fx"
    make_synthetic_session(fx, eid=EID, n_trials=12, n_neurons=8, seed=7,
                           height=32, width=32)
    monkeypatch.chdir(tmp_path)
    os.makedirs("data")
    (tmp_path / "data" / "eid.txt").write_text(f"{EID}\n")
    j_create(CREATE_ARGS + ["--data_dir", str(fx)])
    os.remove(tmp_path / "data" / "eid.txt")
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    monkeypatch.setattr(jemb, "plot_embeddings_anim", _stub_anim)
    monkeypatch.setattr(temb, "plot_embeddings_anim", _stub_anim)
    made = []
    for pkg, pretrain, test, extra in (
            ("jax", j_pretrain.main, j_test.main, []),
            ("torch", t_pretrain.main, t_test.main, ["--device", "cpu"])):
        common = ["--model_config", "tiny.yaml",
                  "--train_config",
                  os.path.join(REPO, "configs/train/vmae_video.yaml"),
                  "--eid", EID, "--model", "c", "--log_dir", f"{pkg}_logs",
                  "--h5_path", "data/data_rrr_whisker-video.h5", *extra]
        pretrain(common + ["--max_steps", "2", "--batch_size", "8"])
        os.symlink(tmp_path / f"{pkg}_logs" / EID / "ContrastViT" / "2",
                   tmp_path / f"{pkg}_logs" / EID / "ContrastViT" / "40000")
        bps = test(common + ["--save_plot", "--plot_dir", f"{pkg}_plots"])
        assert len(bps) == 1 and np.isfinite(bps[0])
        made.append(sorted(os.listdir(f"{pkg}_plots")))
    assert made[1] == made[0]
    assert {"c_cafe0_embed.png", "test_embed_c_cafe0.png",
            "test_c_cafe0_0.gif", "test_embed_c_cafe0_0.gif"} <= set(made[1])
