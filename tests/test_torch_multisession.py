"""PyTorch port of the multi-session trainer (``train/multisession.py``),
the AdamW state converter and ``cli/train.py --eid`` against the JAX
package.

Inputs are made with numpy from a seed (the loss cases) or are the same
synthetic trial tars (the trainer cases: 2 sessions of 6 and 9 neurons,
32×32 video, 12 trials each). The port starts from the JAX parameters
through ``video_spike_torch.convert``, with float32 models. Tolerances:

- ``masked_poisson_nll``: rtol 1e-6;
- converter round trips (VTT params, optax adamw state): bitwise;
- three chained adamw steps (the first taken by optax, its state converted
  into the port, as a resume from a JAX run would): parameters rtol 1e-5,
  atol 1e-6. The key third of each ``qkv.bias`` is the exception: its
  gradient is zero in exact arithmetic (softmax is invariant to shifting
  every key score of a query by the same amount), so Adam's update there is
  the sign of rounding noise, held within 2 lr a step;
- two trainer epochs, on the staged path and on the streaming path:
  per-epoch train loss rtol 1e-4, eval and test bps and R² within 1e-3.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_spike_tpu.core.config import DictConfig as JConfig
from video_spike_tpu.models.vtt import VideoTemporalTransformer as JVTT
from video_spike_tpu.parallel.mesh import make_mesh
from video_spike_tpu.train.base import make_optimizer as j_make_optimizer
from video_spike_tpu.train.multisession import MultiSessionTrainer as JTrainer
from video_spike_tpu.train.multisession import masked_poisson_nll as j_nll
from video_spike_torch.convert import (
    adamw_state_from_optax,
    adamw_state_to_optax,
    flax_to_torch,
    load_into_model,
    torch_to_flax,
)
from video_spike_torch.core.config import DictConfig as TConfig
from video_spike_torch.models.vtt import VideoTemporalTransformer as TVTT
from video_spike_torch.ops.optim import apply_updates
from video_spike_torch.ops.optim import make_optimizer as t_make_optimizer
from video_spike_torch.train.multisession import MultiSessionTrainer as TTrainer
from video_spike_torch.train.multisession import masked_poisson_nll as t_nll

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EIDS = ["sessa0000", "sessb0000"]
MODEL = dict(model_class="VideoTransformer", t_frames=120, t_bins=100,
             patch_size=8, hidden_size=32, frame_depth=1, temporal_depth=1,
             num_attention_heads=2, intermediate_size=64, frame_stride=2)
OPTIMIZER = {"lr": 1e-3, "wd": 0.01, "eps": 1e-8, "warmup_pct": 0.15,
             "div_factor": 10}


def _trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_neurons,n_rows", [(6, 4), (3, 4), (6, 2), (0, 4)])
def test_masked_poisson_nll_matches_jax(n_neurons, n_rows):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 10, 6)).astype(np.float32)
    t = rng.poisson(1.0, (4, 10, 6)).astype(np.float32)
    mask = np.zeros((4, 6), np.float32)
    mask[:, :n_neurons] = 1.0
    ref = float(j_nll(jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask),
                      jnp.float32(n_rows)))
    got = float(t_nll(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(mask), n_rows))
    assert got == pytest.approx(ref, rel=1e-6, abs=0.0)


# ---------------------------------------------------------------------------
# converter and adamw
# ---------------------------------------------------------------------------

def _tiny_params(seed=0):
    jm = JVTT.from_config(dict(MODEL, n_sessions=2, max_neurons=9)).clone(
        dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 255, (3, 120, 1, 32, 32), dtype=np.uint8)
    sids = np.array([0, 1, 1], np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(video), jnp.asarray(sids)))
    ap = rng.poisson(1.0, (3, 100, 9)).astype(np.float32)
    nmask = np.ones((3, 9), np.float32)
    nmask[0, 6:] = 0.0
    return jm, params, (video, sids, ap, nmask)


def _opt_config():
    return {"training": {"num_epochs": 2}, "optimizer": dict(OPTIMIZER)}


def test_converter_round_trips_params_and_adamw_state():
    _, params, _ = _tiny_params()
    params = jax.tree.map(np.asarray, params)
    _trees_equal(torch_to_flax(flax_to_torch(params)), params)

    tx, _ = j_make_optimizer(JConfig(_opt_config()), 12)
    state = tx.init(params)
    grads = jax.tree.map(lambda p: np.full_like(p, 0.25), params)
    _, state = tx.update(grads, state, params)
    state = jax.device_get(state)
    port = adamw_state_from_optax(state)
    assert port["count"] == 1 and port["mu"].keys() == flax_to_torch(
        params).keys()
    back = adamw_state_to_optax(port)
    rebuilt = jax.tree.unflatten(jax.tree.structure(state),
                                 jax.tree.leaves(back))
    _trees_equal(rebuilt, state)


def test_three_adamw_steps_match_optax():
    """Step 1 by optax, its state converted into the port (a resume from
    a JAX run), then steps 2 and 3 in both, on the same batch."""
    jm, params, (video, sids, ap, nmask) = _tiny_params(1)
    config = _opt_config()
    tx_j, _ = j_make_optimizer(JConfig(config), 12)
    tx_t, sched = t_make_optimizer(TConfig(config), 12)
    hidden = MODEL["hidden_size"]

    @jax.jit
    def step_j(p, s):
        loss, g = jax.value_and_grad(lambda p: j_nll(
            jm.apply(p, video, sids), ap, nmask, jnp.float32(3)))(p)
        u, s = tx_j.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    tm = TVTT.from_config(dict(MODEL, n_sessions=2, max_neurons=9),
                          dtype=torch.float32)
    p_j, s_j, _ = step_j(params, tx_j.init(params))
    load_into_model(tm, flax_to_torch(jax.device_get(p_j)))
    s_t = adamw_state_from_optax(jax.device_get(s_j))
    args = [torch.from_numpy(a) for a in (video, sids.astype(np.int64),
                                          ap, nmask)]
    for i in range(2):
        p_j, s_j, loss_j = step_j(p_j, s_j)
        named = dict(tm.named_parameters())
        loss_t = t_nll(tm(args[0], args[1]), args[2], args[3], 3)
        grads = dict(zip(named, torch.autograd.grad(
            loss_t, list(named.values()))))
        with torch.no_grad():
            p_t = {k: v.detach() for k, v in named.items()}
            upd, s_t = tx_t.update(grads, s_t, p_t)
            load_into_model(tm, apply_updates(p_t, upd))
        assert float(loss_t.detach()) == pytest.approx(float(loss_j),
                                                       rel=1e-5)
        ref = flax_to_torch(jax.device_get(p_j))
        assert s_t["count"] == int(s_j[0].count) == i + 2
        noise_atol = 2 * sum(sched(c) for c in range(1, i + 2))
        for k, p in tm.named_parameters():
            got, want = p.detach().numpy().copy(), ref[k].numpy().copy()
            if k.endswith("qkv.bias"):
                keys = slice(hidden, 2 * hidden)
                np.testing.assert_allclose(got[keys], want[keys], rtol=0,
                                           atol=noise_atol, err_msg=k)
                got[keys] = want[keys] = 0.0
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i + 2} {k}")


# ---------------------------------------------------------------------------
# trainer: both packages from the same init
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_sessions(tmp_path_factory):
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path_factory.mktemp("torch_multi")
    make_synthetic_session(d / "data", eid=EIDS[0], n_trials=12, n_neurons=6,
                           seed=20, height=32, width=32)
    make_synthetic_session(d / "data", eid=EIDS[1], n_trials=12, n_neurons=9,
                           seed=21, height=32, width=32)
    return d


def _trainer_config(**training):
    return {"training": {"num_epochs": 2, "train_batch_size": 4,
                         "test_batch_size": 4, **training},
            "optimizer": dict(OPTIMIZER)}


def _both_trainers(d, tmp_path, **training):
    cfg = _trainer_config(**training)
    jt = JTrainer(model=None, config=JConfig(cfg), eids=EIDS,
                  data_dir=str(d / "data"), log_dir=str(tmp_path / "jax"),
                  mesh=make_mesh(n_data=1))
    tt = TTrainer(model=None, config=TConfig(cfg), eids=EIDS,
                  data_dir=str(d / "data"), log_dir=str(tmp_path / "torch"),
                  device="cpu")
    assert tt.max_neurons == jt.max_neurons == 9
    sized = dict(MODEL, n_sessions=2, max_neurons=9)
    jt.model = JVTT.from_config(sized).clone(dtype=jnp.float32)
    tt.model = TVTT.from_config(sized, dtype=torch.float32)
    probe = next(iter(jt.val_loaders[EIDS[0]]))   # not shuffled
    jt._init_if_needed(np.asarray(probe["video"], np.uint8),
                       np.zeros(1, np.int32))
    tt._init_if_needed()
    load_into_model(tt.model, flax_to_torch(jax.device_get(jt.params)))
    return jt, tt


def _assert_evals_close(ev_t, ev_j):
    for eid in EIDS:
        for k in ("bps", "rsquared"):
            assert abs(ev_t["per_session"][eid][k]
                       - ev_j["per_session"][eid][k]) <= 1e-3, (eid, k)


@pytest.mark.parametrize("path", ["staged", "streaming"])
def test_trainer_epochs_match_jax(two_sessions, tmp_path, path):
    training = {} if path == "staged" else {"device_cache_gb": 0}
    jt, tt = _both_trainers(two_sessions, tmp_path, **training)
    for epoch in range(2):
        tr_j, tr_t = jt.train_epoch(), tt.train_epoch()
        assert tr_t["train_loss"] == pytest.approx(tr_j["train_loss"],
                                                   rel=1e-4), epoch
        assert tr_t["lr"] == pytest.approx(tr_j["lr"], rel=1e-6)
        _assert_evals_close(tt._eval(tt.val_loaders, "eval"),
                            jt._eval(jt.val_loaders, "eval"))
    assert (tt._dev_data is None) == (path == "streaming")
    assert tt.global_step == jt._gstep
    test_t = tt._eval(tt.test_loaders, "test")
    _assert_evals_close(test_t, jt._eval(jt.test_loaders, "test"))
    # the host path (predictions fetched, numpy metrics) agrees with the
    # light on-device path
    host = tt._eval(tt.test_loaders, "test_host", return_outputs=True)
    for eid in EIDS:
        assert host["preds"][eid].shape == host["gt"][eid].shape
        for k in ("bps", "rsquared"):
            assert host["per_session"][eid][k] == pytest.approx(
                test_t["per_session"][eid][k], abs=1e-5)


def test_eval_cache_cap_streams(two_sessions, tmp_path):
    """An eval split beyond the remaining device-cache budget streams
    instead of staying on the device, with the same result."""
    _, tt = _both_trainers(two_sessions, tmp_path, device_cache_gb=1e-9)
    ev1 = tt._eval(tt.val_loaders, "eval")
    assert tt._eval_input_cache["eval"] is None
    assert ev1 == tt._eval(tt.val_loaders, "eval")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli_args(d, log_dir, epochs, eid, *extra):
    return ["--model_config", str(d / "vtt_tiny.yaml"),
            "--train_config", str(REPO / "configs/train/vtt_video.yaml"),
            "--eid", eid, "--data_dir", str(d / "data"),
            "--log_dir", str(log_dir), "--num_epochs", str(epochs),
            "--batch_size", "4", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_runs(two_sessions):
    from video_spike_torch.cli import train as train_cli

    d = two_sessions
    (d / "vtt_tiny.yaml").write_text(yaml.safe_dump(MODEL))
    first = train_cli.main(_cli_args(d, d / "logs", 2, ",".join(EIDS)))
    last = torch.load(Path(first["log_dir"]) / "model_last.pt",
                      weights_only=True)
    resumed = train_cli.main(_cli_args(d, d / "logs", 3, ",".join(EIDS),
                                       "--resume"))
    return first, last, resumed


def test_cli_trains_sessions_end_to_end(cli_runs):
    res, last, _ = cli_runs
    assert res["global_step"] == 2 * 5     # 18 staged trials / 4, 2 epochs
    assert all(np.isfinite(res["train_losses"]))
    assert np.isfinite(res["best_eval_bps"])
    assert set(res["test"]["per_session"]) == set(EIDS)
    log_dir = Path(res["log_dir"])
    assert log_dir.name == "multi_sessa_sessb"
    for name in ("model_best.pt", "model_last.pt", "test_results.npy"):
        assert (log_dir / name).is_file(), name
    saved = np.load(log_dir / "test_results.npy", allow_pickle=True).item()
    assert set(saved["per_session"]) == set(EIDS)
    assert np.isfinite(saved["test_res"]["test_bps"])
    assert last["epoch"] == 1 and last["global_step"] == 10
    assert last["opt_state"]["count"] == 10
    assert last["params"]["session_heads"].shape == (2, 32, 9)


def test_cli_resume_continues(cli_runs):
    first, _, resumed = cli_runs
    assert resumed["start_epoch"] == 2
    assert resumed["global_step"] == first["global_step"] + 5
    assert len(resumed["train_losses"]) == 1
    assert np.isfinite(resumed["train_losses"][0])


def test_cli_eid_all_reads_eid_txt(two_sessions, tmp_path, monkeypatch):
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "eid.txt").write_text("\n".join(EIDS) + "\n\n")
    monkeypatch.chdir(tmp_path)
    trainer = train_cli.build_trainer(get_args(_cli_args(
        two_sessions, tmp_path / "logs", 1, "all")))
    assert isinstance(trainer, TTrainer) and trainer.eids == EIDS
    assert trainer.model.n_sessions == 2 and trainer.model.max_neurons == 9
    res = trainer.train()
    assert set(res["test"]["per_session"]) == set(EIDS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(_cli_args(two_sessions, tmp_path, 1, "all")[:-2]
                           + ["--device", "cuda"])
