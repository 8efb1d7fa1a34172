"""The port's background checkpoint flushes (``train/checkpoint.py``) and
the trainers that use them, against the JAX package, on the CPU.

- ``save_checkpoint_async`` / ``wait_for_checkpoints`` / the save lock /
  ``parallel_device_get``: the cases of ``tests/test_resume_tracking.py``
  (an async save equals the synchronous one, a second save to the same
  path joins the first, a failure surfaces at the join, ``after`` runs only
  once the file landed, the fetch equals a plain copy): exact equality.
- The streamed Linear trainer (``device_cache: false``, ``save_every: 1``,
  32x32 fixture, prefetch + native reader): per-epoch train loss rtol 1e-4
  and eval bps / R² within 1e-3 of the JAX trainer from the same initial
  parameters; ``model_best.pt`` and ``model_last.pt`` bitwise equal to the
  tensors they snapshot; the preemption path.
- The VTT's ``_flush_best`` / ``_save_last(block=False)`` and the SSL
  trainer's periodic flush with a mid-epoch resume: bitwise equal to what
  they snapshot, and to an uninterrupted run.
"""

import contextlib
import json
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_spike_tpu.train import checkpoint as jck
from video_spike_torch.train import checkpoint as ck

# fixtures and helpers of the trainer tests (imported fixtures register here)
from test_torch_contrast import _port_trainer, cache  # noqa: F401
from test_torch_multisession import _both_trainers, two_sessions  # noqa: F401
from test_torch_optim_variants import (  # noqa: F401
    LEAN_FUSED,
    both_linear_trainers,
    session,
)

torch.set_num_threads(1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {
        "big": torch.from_numpy(rng.normal(size=(512, 64)).astype(
            np.float32)).to(torch.bfloat16),
        "odd": torch.from_numpy(rng.normal(size=(100, 37)).astype(
            np.float32)),
        "small": torch.arange(7, dtype=torch.int32)},
        "opt_state": ({"count": 3, "mu": torch.ones(5)}, [torch.zeros(2)]),
        "epoch": 5}


def _assert_trees_equal(got, ref, what=""):
    if isinstance(ref, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == ref.dtype, what
        assert torch.equal(got.cpu(), ref.cpu()), what
    elif isinstance(ref, dict):
        assert got.keys() == ref.keys(), what
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_trees_equal(g, r, f"{what}/{i}")
    else:
        assert got == ref, what


# ---------------------------------------------------------------------------
# the primitives (tests/test_resume_tracking.py)
# ---------------------------------------------------------------------------

def test_async_save_equals_sync_and_same_path_joins(tmp_path):
    tree = _tree()
    ck.save_checkpoint(tmp_path / "sync", "model_best", tree)
    ck.save_checkpoint_async(tmp_path / "async", "model_best", tree)
    tree2 = {**_tree(1), "epoch": 6}
    ck.save_checkpoint_async(tmp_path / "async", "model_last", tree)
    ck.save_checkpoint_async(tmp_path / "async", "model_last", tree2)  # joins
    assert ck.wait_for_checkpoints() is True
    sync = ck.load_checkpoint(tmp_path / "sync", "model_best")
    _assert_trees_equal(ck.load_checkpoint(tmp_path / "async", "model_best"),
                        sync)
    _assert_trees_equal(sync, tree)
    _assert_trees_equal(ck.load_checkpoint(tmp_path / "async", "model_last"),
                        tree2)
    # the same order of saves in the JAX package lands the same epochs
    for name, t in (("model_best", tree), ("model_last", tree),
                    ("model_last", tree2)):
        jck.save_checkpoint_async(tmp_path / "jax", name, {
            "epoch": t["epoch"],
            "w": jnp.asarray(t["params"]["odd"].numpy())})
    jck.wait_for_checkpoints()
    assert int(jck.load_checkpoint(tmp_path / "jax", "model_last")["epoch"]) \
        == ck.load_checkpoint(tmp_path / "async", "model_last")["epoch"] == 6


def test_concurrent_saves_to_one_path_serialize(tmp_path):
    """Writers on several threads: every save completes and the artifact
    is one writer's whole tree (the save lock)."""
    errs = []

    def writer(epoch):
        try:
            ck.save_checkpoint(tmp_path, "model_best",
                               {"w": torch.full((64, 64), float(epoch)),
                                "epoch": epoch})
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    got = ck.load_checkpoint(tmp_path, "model_best")
    assert got["epoch"] in range(4)
    assert torch.all(got["w"] == got["epoch"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_best.pt"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_async_failure_raises_at_wait(tmp_path, monkeypatch, package):
    """A background save that dies surfaces at wait_for_checkpoints (and is
    returned as False, logged, under raise_errors=False); its ``after``
    never runs; the queue is drained afterwards."""
    mod = ck if package == "port" else jck

    def bad_get(tree, *a, **kw):
        raise OSError("host copy failed")

    ran = []
    monkeypatch.setattr(mod, "parallel_device_get", bad_get)
    mod.save_checkpoint_async(tmp_path, "model_best", {"epoch": 1},
                              after=lambda: ran.append(1))
    with pytest.raises(RuntimeError, match="background checkpoint"):
        mod.wait_for_checkpoints()
    mod.save_checkpoint_async(tmp_path, "model_best", {"epoch": 2})
    assert mod.wait_for_checkpoints(raise_errors=False) is False
    assert mod.wait_for_checkpoints() is True
    assert ran == [] and not list(tmp_path.iterdir())


def test_after_runs_once_the_file_landed(tmp_path):
    seen = []

    def after():
        seen.append(ck.load_checkpoint(tmp_path, "last_model")["step"])

    ck.save_checkpoint_async(tmp_path, "last_model", {"step": 7}, after=after)
    ck.wait_for_checkpoints()
    assert seen == [7]
    # an ``after`` that fails surfaces at the join like a save
    ck.save_checkpoint_async(tmp_path, "last_model", {"step": 8},
                             after=lambda: 1 / 0)
    with pytest.raises(RuntimeError) as info:
        ck.wait_for_checkpoints()
    assert isinstance(info.value.__cause__, ZeroDivisionError)


def test_device_fetch_equals_plain_copy():
    """parallel_device_get returns every tensor on the host, equal to a
    plain copy and to the JAX package's fetch of the same arrays; scalars
    and containers pass through."""
    tree = _tree(3)
    got = ck.parallel_device_get(tree)
    _assert_trees_equal(got, ck.to_cpu(tree))
    assert got["params"]["odd"].data_ptr() \
        != tree["params"]["odd"].data_ptr()            # a copy, not a view
    ref = jck.parallel_device_get(
        {"odd": jnp.asarray(tree["params"]["odd"].numpy()),
         "small": jnp.asarray(tree["params"]["small"].numpy()), "epoch": 5},
        chunk_bytes=4 << 10, workers=4)
    np.testing.assert_array_equal(got["params"]["odd"].numpy(), ref["odd"])
    np.testing.assert_array_equal(got["params"]["small"].numpy(),
                                  ref["small"])
    snap = ck.snapshot(tree)
    tree["params"]["odd"].add_(1.0)             # an in-place update later
    _assert_trees_equal(snap["params"]["odd"], got["params"]["odd"])


# ---------------------------------------------------------------------------
# the streamed Linear trainer against the JAX trainer
# ---------------------------------------------------------------------------

STREAM = {"device_cache": False, "save_every": 1}


def _record(trainer, name, out):
    fn = getattr(trainer, name)

    def wrapped(*a, **k):
        res = fn(*a, **k)
        out.append(res)
        return res

    setattr(trainer, name, wrapped)


def _spy_saves(monkeypatch, module):
    calls = {"async": [], "sync": []}
    a, s = module.save_checkpoint_async, module.save_checkpoint
    monkeypatch.setattr(module, "save_checkpoint_async",
                        lambda d, n, t, **k: (calls["async"].append(n),
                                              a(d, n, t, **k))[1])
    monkeypatch.setattr(module, "save_checkpoint",
                        lambda d, n, t: (calls["sync"].append(n),
                                         s(d, n, t))[1])
    return calls


def test_streamed_linear_trainer_matches_jax(session, tmp_path, monkeypatch):
    from video_spike_torch.train import base as tbase

    jt, tt = both_linear_trainers(session, tmp_path, LEAN_FUSED, STREAM,
                                  epochs=3)
    tr_j, tr_t, ev_j, ev_t = [], [], [], []
    _record(jt, "train_epoch", tr_j)
    _record(tt, "train_epoch", tr_t)
    _record(jt, "eval_epoch", ev_j)
    _record(tt, "eval_epoch", ev_t)
    live = {}
    test_model = tt.test_model

    def capture_then_test():
        # what model_last snapshots: the live tensors after the last step
        live["params"] = {k: v.clone() for k, v in tt.params.items()}
        live["opt_state"] = ck.snapshot(tt._opt_state_tree())
        return test_model()

    tt.test_model = capture_then_test
    calls = _spy_saves(monkeypatch, tbase)
    res_j = jt.train()
    res_t = tt.train()
    assert tt._dev_data is None and tt._fused_inner is not None
    assert len(tr_t) == len(tr_j) == 3
    for a, b in zip(tr_t, tr_j):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-4)
    for a, b in zip(ev_t, ev_j):
        for k in ("eval_bps", "eval_rsquared"):
            assert abs(a["eval_res"][k] - b["eval_res"][k]) <= 1e-3, k
    assert abs(res_t["best_eval_bps"] - res_j["best_eval_bps"]) <= 1e-3
    assert res_t["best_epoch"] == res_j["best_epoch"]
    for k in ("test_bps", "test_rsquared"):
        assert abs(res_t["test_res"][k] - res_j["test_res"][k]) <= 1e-3, k
    # every flush ran in the background; none in the loop was synchronous
    assert calls["sync"] == []
    assert calls["async"].count("model_last") == 1
    assert 1 <= calls["async"].count("model_best") <= 3
    log_dir = Path(res_t["log_dir"])
    best = ck.load_checkpoint(log_dir, "model_best")
    assert best["epoch"] == res_t["best_epoch"]
    _assert_trees_equal(best["params"], tt._best_params, "best")
    last = ck.load_checkpoint(log_dir, "model_last")
    assert last["epoch"] == 2 and last["global_step"] == tt.global_step == 6
    _assert_trees_equal(last["params"], live["params"], "last")
    _assert_trees_equal(last["opt_state"], live["opt_state"], "opt_state")
    assert last["opt_state"]["fused"]["count"] == 6
    # and the test eval ran on the best params, not on the live ones
    for k, v in tt.params.items():
        assert torch.equal(v, tt._best_params[k]), k


def test_streamed_linear_preemption(session, tmp_path, monkeypatch):
    """A stop at the end of epoch 0 while the best flush dies in the
    background: the trainer joins it without raising (the failure is
    logged), saves model_last and model_best synchronously, returns, and
    --resume continues from epoch 1."""
    from video_spike_torch.core import preempt
    from video_spike_torch.train import base as tbase

    flag_box = []

    @contextlib.contextmanager
    def stop_after_first_epoch(log=None):
        flag = preempt.StopFlag()
        flag_box.append(flag)
        yield flag

    monkeypatch.setattr(preempt, "graceful_stop", stop_after_first_epoch)
    _, tt = both_linear_trainers(session, tmp_path, LEAN_FUSED, STREAM,
                                 epochs=3)
    epoch_fn = tt.train_epoch

    def epoch_then_signal():
        out = epoch_fn()
        flag_box[0].stop = True                 # SIGTERM during epoch 0
        return out

    tt.train_epoch = epoch_then_signal
    real_get = ck.parallel_device_get

    def failing_best_fetch(tree, *a, **k):
        if "global_step" not in tree:           # model_best's tree
            raise OSError("disk full")
        return real_get(tree, *a, **k)

    monkeypatch.setattr(ck, "parallel_device_get", failing_best_fetch)
    calls = _spy_saves(monkeypatch, tbase)
    res = tt.train()
    monkeypatch.setattr(ck, "parallel_device_get", real_get)
    assert res["preempted"] and res["epoch"] == 0
    assert calls["async"] == ["model_best"]     # the cadence flush (died)
    assert calls["sync"] == ["model_last", "model_best"]
    log_dir = Path(res["log_dir"])
    last = ck.load_checkpoint(log_dir, "model_last")
    assert last["epoch"] == 0 and last["global_step"] == 2
    _assert_trees_equal(ck.load_checkpoint(log_dir, "model_best")["params"],
                        tt._best_params)
    assert ck.wait_for_checkpoints() is True      # nothing left queued
    monkeypatch.undo()
    _, t2 = both_linear_trainers(session, tmp_path, LEAN_FUSED, STREAM,
                                 epochs=3)
    assert t2.resume() and t2._start_epoch == 1 and t2.global_step == 2


# ---------------------------------------------------------------------------
# the VTT and the SSL trainer
# ---------------------------------------------------------------------------

def test_vtt_flushes_in_the_background(two_sessions, tmp_path, monkeypatch):
    from video_spike_torch.train import multisession as tms

    _, tt = _both_trainers(two_sessions, tmp_path, save_every=1)
    calls = _spy_saves(monkeypatch, tms)
    live = {}
    evaluate = tt._eval

    def capture(loaders, phase, **k):
        if phase == "test":
            # model_last was handed over before the best params came in
            live["opt_state"] = tt.opt_state
        return evaluate(loaders, phase, **k)

    tt._eval = capture
    res = tt.train()
    assert calls["sync"] == []
    assert calls["async"].count("model_last") == 1
    assert calls["async"].count("model_best") >= 1
    log_dir = Path(res["log_dir"])
    best = ck.load_checkpoint(log_dir, "model_best")
    _assert_trees_equal(best["params"], tt._best_params, "best")
    assert best["epoch"] == tt._best_epoch
    last = ck.load_checkpoint(log_dir, "model_last")
    assert last["epoch"] == 1 and last["global_step"] == tt.global_step
    _assert_trees_equal(last["opt_state"], live["opt_state"], "opt_state")
    assert last["best_bps"] == res["best_eval_bps"]
    assert (log_dir / "test_results.npy").is_file()
    # the block=False forms on their own
    tt._best_epoch += 1
    tt._flush_best(block=False)
    tt._save_last(7, block=False)
    assert ck.wait_for_checkpoints() is True
    assert ck.load_checkpoint(log_dir, "model_best")["epoch"] \
        == tt._best_epoch
    assert ck.load_checkpoint(log_dir, "model_last")["epoch"] == 7


def test_ssl_periodic_flush_and_mid_epoch_resume(cache, tmp_path,  # noqa: F811
                                                 monkeypatch):
    """The periodic last_model flush (step 5) runs in the background with
    its sidecar written after it; a crash at step 8 leaves it on disk;
    --resume from it reaches the uninterrupted run's parameters bitwise."""
    from video_spike_torch.train import contrast as tcon

    calls = _spy_saves(monkeypatch, tcon)
    h5 = str(cache[1])
    a = _port_trainer(h5, tmp_path / "ab", 10, name="ContrastViT",
                      validate_every=10**6, save_every_steps=5,
                      save_every_min=None)
    step = a._step_staged
    flushed = {}

    def crash_at_8(staged, cur_step):
        if cur_step == 5:
            # the flush was handed a device copy at step 5: the steps after
            # it must not reach the file
            flushed["params"] = {k: v.clone() for k, v in a.params.items()}
        if cur_step == 8:
            raise RuntimeError("simulated hard crash")
        return step(staged, cur_step)

    a._step_staged = crash_at_8
    with pytest.raises(RuntimeError, match="simulated hard crash"):
        a.fit()
    assert calls["async"] == ["last_model"] and calls["sync"] == []
    ck.wait_for_checkpoints()
    state = json.loads((Path(a.log_dir) / "last_model.sampler.json")
                       .read_text())
    assert state["step"] == 5 and state["consumed"] == 5
    on_disk = ck.load_checkpoint(a.log_dir, "last_model")
    assert on_disk["step"] == 5
    _assert_trees_equal(on_disk["params"], flushed["params"], "step 5")
    b = _port_trainer(h5, tmp_path / "ab", 10, name="ContrastViT",
                      validate_every=10**6)
    assert b.resume()
    assert b._start_step == 5 and b._resume_skip == 5
    b.fit()
    c = _port_trainer(h5, tmp_path / "c", 10, name="ContrastViT",
                      validate_every=10**6)
    c.fit()
    for k, v in b.params.items():
        assert torch.equal(v, c.params[k]), k
    assert b.train_losses == c.train_losses[5:]
