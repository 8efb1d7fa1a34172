"""PyTorch port of run tracking and the profiler hook against the JAX package:
``core/tracking.Tracker`` (``metrics.jsonl`` records, the wandb mirror
through a recording stand-in module, as ``tests/test_tracking_wandb.py``
does, since wandb is not installed), both packages' ``BaseTrainer`` writing
``metrics.jsonl``, and the port's ``profiling.*`` hook on the streaming and
the cached epoch.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: tracker records equal but for ``t`` (the clock) and the log
directory in a figure's path; trainer records from the same initial
parameters: the same keys, steps and epochs, train loss rtol 1e-4, eval
loss rtol 1e-4, eval bps and R² within 1e-3, lr rtol 1e-6 (``PERF.md``
§2).
"""

import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_spike_tpu.core.tracking import Tracker as JTracker
from video_spike_torch.core.tracking import Tracker as TTracker
from video_spike_torch.viz import pyplot

# the module-scoped fixture and the trainer pair of the optimizer tests
from test_torch_optim_variants import (REPO, both_linear_trainers,  # noqa
                                       session)

torch.set_num_threads(1)


def _records(path, drop=("t",)):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


def _figure():
    plt = pyplot()
    fig, ax = plt.subplots()
    ax.plot([0, 1, 2], [1, 0, 2])
    return fig


def _drive(tracker, tensor):
    tracker.log({"epoch": 0, "train_loss": tensor(0.5), "lr": 1e-3,
                 "eval_bps": np.float32(0.25), "note": "x"}, step=3)
    tracker.log({"loss": tensor(2.0)})
    fig = _figure()
    tracker.log_figure("saved_here", fig, step=4)
    tracker.log_figure("saved_there", fig, step=5, path="/elsewhere/a.png")
    pyplot().close(fig)
    tracker.close()


def test_trackers_write_the_same_records(tmp_path):
    _drive(JTracker(str(tmp_path / "jax")), jnp.float32)
    _drive(TTracker(str(tmp_path / "torch")),
           lambda v: torch.tensor(v, dtype=torch.float32))
    rec_j = _records(tmp_path / "jax" / "metrics.jsonl")
    rec_t = _records(tmp_path / "torch" / "metrics.jsonl")
    for r in rec_j + rec_t:
        if "path" in r and "saved_here" in r["path"]:
            assert os.path.isfile(r["path"])
            r["path"] = os.path.basename(r["path"])
    assert rec_t == rec_j
    assert rec_t[0] == {"step": 3, "epoch": 0.0, "train_loss": 0.5,
                        "lr": 1e-3, "eval_bps": 0.25, "note": "x"}
    # append mode: a resumed run adds to the same file
    TTracker(str(tmp_path / "torch")).log({"epoch": 1}, step=9)
    assert len(_records(tmp_path / "torch" / "metrics.jsonl")) == 5


class _Recorder:
    """Stand-in wandb module that records every call."""

    def __init__(self):
        self.calls = []

    def module(self):
        mod = types.ModuleType("wandb")
        rec = self

        class Image:
            def __init__(self, fig):
                rec.calls.append(("Image", type(fig).__name__))

        def value(v):
            if isinstance(v, Image):
                return "Image"
            return float(v) if hasattr(v, "__float__") else v

        mod.init = lambda **kw: rec.calls.append(("init", kw))
        mod.log = lambda metrics, step=None: rec.calls.append(
            ("log", {k: value(v) for k, v in metrics.items()}, step))
        mod.finish = lambda: rec.calls.append(("finish",))
        mod.Image = Image
        return mod


@pytest.mark.parametrize("use", [True, False])
def test_wandb_mirror_sees_the_same_calls(tmp_path, monkeypatch, use):
    calls = []
    for name, cls, tensor in (
            ("jax", JTracker, jnp.float32),
            ("torch", TTracker,
             lambda v: torch.tensor(v, dtype=torch.float32))):
        rec = _Recorder()
        monkeypatch.setitem(sys.modules, "wandb", rec.module())
        _drive(cls(str(tmp_path / name), project="p", name="run",
                   use_wandb=use, config={"a": 1}), tensor)
        calls.append(rec.calls)
    assert calls[1] == calls[0]
    if use:
        assert [c[0] for c in calls[1]] == ["init", "log", "log", "Image",
                                            "log", "Image", "log", "finish"]
        assert calls[1][0] == ("init", {"project": "p", "name": "run",
                                        "config": {"a": 1}})
    else:
        assert calls[1] == []


def test_tracker_without_wandb_still_writes_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    tracker = TTracker(str(tmp_path), use_wandb=True)
    tracker.log({"x": 1.0}, step=0)
    tracker.close()
    assert _records(tmp_path / "metrics.jsonl") == [{"step": 0, "x": 1.0}]


def test_trainers_write_the_same_metrics(session, tmp_path):  # noqa: F811
    """Both BaseTrainers' train() from the same parameters (AdamW, f32):
    one metrics.jsonl record per epoch with the same keys and steps."""
    jt, tt = both_linear_trainers(session, tmp_path, {"name": "adamw"},
                                  epochs=2)
    jt.train()
    tt.train()
    rec_j = _records(os.path.join(jt.log_dir, "metrics.jsonl"))
    rec_t = _records(os.path.join(tt.log_dir, "metrics.jsonl"))
    assert len(rec_t) == len(rec_j) == 2
    for r_t, r_j in zip(rec_t, rec_j):
        assert r_t.keys() == r_j.keys() == {
            "step", "epoch", "train_loss", "lr", "eval_loss", "eval_bps",
            "eval_rsquared"}
        assert (r_t["step"], r_t["epoch"]) == (r_j["step"], r_j["epoch"])
        for k in ("train_loss", "eval_loss"):
            assert r_t[k] == pytest.approx(r_j[k], rel=1e-4), k
        assert r_t["lr"] == pytest.approx(r_j["lr"], rel=1e-6)
        for k in ("eval_bps", "eval_rsquared"):
            assert abs(r_t[k] - r_j[k]) <= 1e-3, k


@pytest.mark.parametrize("cached", [False, True])
def test_profiler_hook_traces_the_streaming_epoch(session, tmp_path,  # noqa
                                                  cached):
    """profiling: {enable, dir, steps} traces `steps` steps once
    global_step > 2 on the streaming epoch and on the cached one alike (one
    trace for the run), and the trace holds a `vs.step` range a step."""
    from video_spike_torch.core import config as tconfig
    from video_spike_torch.data import dataset as tdata
    from video_spike_torch.models.linear import LinearModel as TLinear
    from video_spike_torch.train.base import BaseTrainer

    trace_dir = tmp_path / "trace"
    config = tconfig.config_from_kwargs(
        {"model": f"include:{session / 'model.yaml'}"})
    config = tconfig.update_config(
        str(REPO / "configs/train/linear_video.yaml"), config)
    config["dirs"]["data_dir"] = str(session / "data")
    config["training"].update(num_epochs=3, train_batch_size=8,
                              device_cache=cached)
    config["profiling"] = {"enable": True, "dir": str(trace_dir),
                           "steps": 2}
    split = tdata.split_dataset(str(session / "data"), "optvr0000",
                                seed=config.seed)
    loaders = tdata.make_loader(config, split)
    meta = tdata.get_metadata_from_loader(loaders[0], config)
    config["model"]["encoder"]["input_dim"] = meta["input_dim"]
    config["model"]["decoder"]["output_dim"] = meta["output_dim"]
    trainer = BaseTrainer(
        TLinear.from_config(config.model, compute_dtype=torch.float32),
        *loaders, config, eid="optvr0000", dataset_split_dict=split,
        log_dir=str(tmp_path / "logs"), device="cpu")
    # 2 steps an epoch: tracing starts before step 3 (global_step > 2) and
    # stops with that epoch, short of the 2-step window; once per run
    for _ in range(3):
        trainer.train_epoch()
    assert trainer.global_step == 6
    assert (trainer._dev_data is not None) == cached
    assert trainer.trace_paths == [str(trace_dir / "trace_steps3-4.json")]
    trace = json.loads((trace_dir / "trace_steps3-4.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert any("addmm" in n or "mm" in n for n in names)
    assert names.count("vs.step") == 1            # global steps 3 to 4
    assert os.listdir(trace_dir) == ["trace_steps3-4.json"]
