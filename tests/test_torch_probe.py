"""PyTorch port of the VideoMAE probe's training path against the JAX
package: the frozen-path optimizer (``ops/optim.make_optimizer``), the
fused probe-head step (``ops/fused_readout.make_fused_probe_head_step``),
``BaseTrainer``'s frozen split (features staged once, head-only steps,
staged eval features), the optax state conversion, ``cli/train.py`` on the
probe from a pretrained ``backbone.pt`` with ``--resume``, and
``cli/pretrain_videomae.py``.

The same numpy inputs, made from a seed, go through both packages; the port
starts from the JAX parameters through ``video_spike_torch.convert``. The
model is ``tests/test_videomae.py``'s TINY probe with ``encoder_head``
widened to 32 outputs, so its (2048, 32) kernel reaches the 65,536-element
bf16 stochastic-rounding store, and the flax backbone computes in float32
(overridden in the test). Tolerances:

- fused head step, 3 chained steps: loss rtol 1e-5; the fused row/col
  statistics and the f32 adafactor statistics rtol 1e-5 (atol 1e-6 of the
  leaf's largest value, for elements that cancel to near zero); the bf16
  kernel >= 99.9% bitwise and every element within 1 bf16 ulp plus 2^-20 of
  its scale (``tests/test_torch_train.py``'s rule: the f32 gradients differ
  in the last bits, which can flip an SR decision); the f32 head leaves
  rtol 1e-4 with an absolute floor of 1e-2 of one step (the learning rate);
  the frozen backbone bitwise unchanged;
- frozen-path AdamW, 2 steps: the heads rtol 1e-5 with an atol of 1e-4 of
  one step (Adam's normalized update amplifies the last bits of a tiny
  gradient), the frozen backbone bitwise unchanged, no state for it;
- trainer against the JAX trainer on a 16-trial session, 3 epochs (staged
  features, streaming, and ``freeze_backbone: false``): per-epoch train
  loss rtol 1e-4, eval bps and R² within 1e-3;
- ``cli.pretrain_videomae`` against the JAX CLI, 5 steps with the same
  masking noise: per-step loss rtol 1e-4.
"""

from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_spike_tpu.core.config import DictConfig as JConfig
from video_spike_tpu.models import videomae as jvmae
from video_spike_tpu.models import vit_mae as jvit
from video_spike_tpu.ops import fused_readout as jfr
from video_spike_tpu.ops.optim import apply_updates_sr as j_apply_sr
from video_spike_tpu.ops.poisson import poisson_nll_mean as j_nll_mean
from video_spike_tpu.train.base import make_optimizer as j_make_optimizer
from video_spike_torch.convert import (
    adafactor_state_from_optax,
    adafactor_state_to_optax,
    adamw_state_from_optax,
    flax_to_torch,
    frozen_state_from_optax,
    frozen_state_to_optax,
    fused_state_from_flax,
    fused_state_to_flax,
    load_into_model,
    to_numpy,
)
from video_spike_torch.core.config import DictConfig as TConfig
from video_spike_torch.models import videomae as tvmae
from video_spike_torch.models import vit_mae as tvit
from video_spike_torch.ops import fused_readout as tfr
from video_spike_torch.ops import optim as toptim
from video_spike_torch.ops.poisson import poisson_nll_mean as t_nll_mean

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(image_size=32, patch_size=8, num_channels=3, num_frames=8,
            tubelet_size=2, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            encoder={"output_dim": 32}, decoder={"output_dim": 100 * 4})
B = 8
LR = 5e-5                     # configs/train/vmae_video.yaml
EID = "probe0000"
PRODUCTION_OPT = dict(name="adafactor", param_scale=False, clipping=None,
                      param_dtype="bfloat16_sr", fused_readout=True,
                      fused_min_kernel=1)


class _F32Tubelet(jvmae.TubeletEmbed):
    dtype: Any = jnp.float32


class _F32Encoder(jvit.Encoder):
    dtype: Any = jnp.float32


class _F32Backbone(jvmae.VideoMAEBackbone):
    dtype: Any = jnp.float32


@pytest.fixture
def f32_jax(monkeypatch):
    monkeypatch.setattr(jvmae, "TubeletEmbed", _F32Tubelet)
    monkeypatch.setattr(jvmae, "Encoder", _F32Encoder)
    monkeypatch.setattr(jvmae, "VideoMAEBackbone", _F32Backbone)


def _within(a, b, rel_scale):
    """|a - b| <= 1 bf16 ulp at max(|a|, |b|) + rel_scale * max|b|."""
    a32 = np.asarray(a, np.float32)
    b32 = np.asarray(b, np.float32)
    big = np.maximum(np.abs(a32), np.abs(b32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-38))) - 7)
    return np.abs(a32 - b32) <= ulp + rel_scale * np.abs(b32).max()


def _probe_params(cfg=TINY):
    """The flax init of the probe, leaves >= 65,536 elements in bf16."""
    jm = jvmae.VideoMAEProbe(config=cfg)
    video = np.zeros((1, 120, 1, 32, 32), np.uint8)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(video)))
    return jm, jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                            if p.size >= 1 << 16 else p, params)


def _opt_config(**opt):
    return {"optimizer": {"lr": LR, "warmup_pct": 0.15, "div_factor": 10,
                          **opt}}


# ---------------------------------------------------------------------------
# the optimizer and the fused head step
# ---------------------------------------------------------------------------

def test_fused_probe_head_step_matches_jax():
    jm, params = _probe_params()
    assert params["params"]["encoder_head"]["kernel"].dtype == jnp.bfloat16
    cfg = _opt_config(**PRODUCTION_OPT)
    frozen = ("video_mae",)
    tx_j, sched_j = j_make_optimizer(JConfig(cfg), 16, frozen_paths=frozen)
    tx_t, sched_t = toptim.make_optimizer(TConfig(cfg), 16,
                                          frozen_paths=frozen)
    assert isinstance(tx_t, toptim.Frozen)
    step_j = jax.jit(jfr.make_fused_probe_head_step(
        jm, tx_j, sched_j, lambda o, a, nv: j_nll_mean(o, a, nv), j_apply_sr))
    opt_j = jfr.init_fused_opt_state(params, tx_j, split=jfr.split_head_kernel)
    tm = tvmae.VideoMAEProbe(TINY)
    p_t = flax_to_torch(params)
    step_t = tfr.make_fused_probe_head_step(tm, tx_t, sched_t, t_nll_mean,
                                            toptim.apply_updates_sr)
    opt_t = tfr.init_fused_opt_state(p_t, tx_t, split=tfr.split_head_kernel)
    assert set(opt_t[1]["v"]) == {"encoder_head.bias", "decoder_head.kernel",
                                  "decoder_head.bias"}
    backbone = {k: v.clone() for k, v in p_t.items()
                if k.startswith("video_mae.")}

    rng = np.random.default_rng(0)
    p_j = params
    for i in range(3):
        hidden = rng.normal(size=(B, 64, 32)).astype(np.float32)
        ap = rng.poisson(1.0, (B, 100, 4)).astype(np.float32)
        p_j, opt_j, loss_j = step_j(p_j, opt_j, jnp.asarray(hidden),
                                    jnp.asarray(ap), jnp.float32(B),
                                    jnp.uint32(i))
        p_t, opt_t, loss_t = step_t(p_t, opt_t, torch.from_numpy(hidden),
                                    torch.from_numpy(ap), B, i)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
        ref = flax_to_torch(jax.device_get(p_j))
        for k, got in p_t.items():
            if k.startswith("video_mae."):
                assert torch.equal(got, backbone[k]), k
                assert torch.equal(ref[k], backbone[k]), k
            elif got.dtype == torch.bfloat16:
                g, r = to_numpy(got), to_numpy(ref[k])
                assert (g.view(np.uint16) == r.view(np.uint16)).mean() \
                    >= 0.999, (i, k)
                assert _within(g, r, 2.0**-20).all(), (i, k)
            else:
                np.testing.assert_allclose(got.numpy(), ref[k].numpy(),
                                           rtol=1e-4, atol=1e-2 * LR,
                                           err_msg=f"{i} {k}")
        f_j, rest_j = jax.device_get(opt_j)
        f_t, rest_t = opt_t
        f_ref = fused_state_from_flax(f_j)
        assert f_t.count == f_ref.count == i + 1
        for got, r in ((f_t.row, f_ref.row), (f_t.col, f_ref.col)):
            np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-5)
        rest_ref = frozen_state_from_optax(rest_j, adafactor_state_from_optax)
        assert rest_t["count"] == rest_ref["count"] == i + 1
        for part in ("v_row", "v_col", "v"):
            assert rest_t[part].keys() == rest_ref[part].keys()
            for k, got in rest_t[part].items():
                r = rest_ref[part][k]
                np.testing.assert_allclose(
                    got.numpy(), r.numpy(), rtol=1e-5,
                    atol=1e-6 * float(r.abs().max()), err_msg=f"{part} {k}")
    # the port's state converts back into the JAX trainer's structure
    back = (fused_state_to_flax(opt_t[0]),
            frozen_state_to_optax(adafactor_state_to_optax(opt_t[1])))
    rebuilt = jax.tree.unflatten(jax.tree.structure(opt_j),
                                 jax.tree.leaves(back))
    for a, b in zip(jax.tree.leaves(rebuilt),
                    jax.tree.leaves(jax.device_get(opt_j))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))


def test_frozen_adamw_matches_jax(f32_jax):
    """Decoupled weight decay must not reach the frozen backbone (the
    reference's requires_grad=False contract): two AdamW steps at wd 0.5
    leave it bitwise as it was, keep no state for it, and move the heads as
    optax does."""
    jm, params = _probe_params(dict(TINY, encoder={"output_dim": 16}))
    cfg = _opt_config(lr=1e-2, wd=0.5)
    frozen = jm.frozen_param_paths()
    tx_j, _ = j_make_optimizer(JConfig(cfg), 100, frozen_paths=frozen)
    tx_t, _ = toptim.make_optimizer(TConfig(cfg), 100, frozen_paths=frozen)
    rng = np.random.default_rng(1)
    video = rng.integers(0, 255, (2, 120, 1, 32, 32), dtype=np.uint8)
    ap = rng.poisson(1.0, (2, 100, 4)).astype(np.float32)
    tm = tvmae.VideoMAEProbe(dict(TINY, encoder={"output_dim": 16}),
                             dtype=torch.float32)
    load_into_model(tm, flax_to_torch(params))
    p_t = {k: v.detach() for k, v in tm.named_parameters()}
    before = {k: v.clone() for k, v in p_t.items()}
    opt_j, opt_t = tx_j.init(params), tx_t.init(p_t)
    assert not any(k.startswith("video_mae.") for k in opt_t["mu"])

    def loss_j(p):
        return j_nll_mean(jm.apply(p, jnp.asarray(video)), jnp.asarray(ap))

    p_j = params
    for _ in range(2):
        grads = jax.grad(loss_j)(p_j)
        upd, opt_j = tx_j.update(grads, opt_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        leaves = {k: v.requires_grad_(True) for k, v in
                  tx_t.trainable({k: v.detach() for k, v in p_t.items()})
                  .items()}
        out = torch.func.functional_call(tm, {**p_t, **leaves},
                                         (torch.from_numpy(video),))
        g = torch.autograd.grad(t_nll_mean(out, torch.from_numpy(ap)),
                                list(leaves.values()))
        with torch.no_grad():
            upd_t, opt_t = tx_t.update(dict(zip(leaves, g)), opt_t, p_t)
            p_t = toptim.apply_updates(p_t, upd_t)
    ref = flax_to_torch(jax.device_get(p_j))
    for k, got in p_t.items():
        if k.startswith("video_mae."):
            assert torch.equal(got, before[k]) and torch.equal(ref[k],
                                                               before[k]), k
        else:
            assert not torch.equal(got, before[k]), k
            np.testing.assert_allclose(got.numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-4 * 1e-2,
                                       err_msg=k)
    state = frozen_state_from_optax(jax.device_get(opt_j),
                                    adamw_state_from_optax)
    assert state["count"] == opt_t["count"] == 2
    assert state["mu"].keys() == opt_t["mu"].keys()


# ---------------------------------------------------------------------------
# trainer: both packages from the same init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A 16-trial 32x32 synthetic session and the probe's yaml configs with
    TINY widths and the production optimizer."""
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path_factory.mktemp("torch_probe")
    make_synthetic_session(d / "data", eid=EID, n_trials=16, n_neurons=4,
                           seed=3, height=32, width=32)
    model = yaml.safe_load((REPO / "configs/model/videomae/videomae.yaml")
                           .read_text())
    model.update(TINY, hf_compat=False)
    (d / "model.yaml").write_text(yaml.safe_dump(model))
    train = yaml.safe_load((REPO / "configs/train/vmae_video.yaml")
                           .read_text())
    train["optimizer"].update(PRODUCTION_OPT)
    (d / "train.yaml").write_text(yaml.safe_dump(train))
    return d


def _both_trainers(d, tmp_path, model_over=None, training=None,
                   optimizer=None):
    from video_spike_tpu.core import config as jconfig
    from video_spike_tpu.data import dataset as jdata
    from video_spike_tpu.parallel.mesh import make_mesh
    from video_spike_tpu.train.base import BaseTrainer as JTrainer
    from video_spike_torch.core import config as tconfig
    from video_spike_torch.data import dataset as tdata
    from video_spike_torch.train.base import BaseTrainer as TTrainer

    trainers = []
    for cfgmod, data, make in (
            (jconfig, jdata, lambda c, *a, **k: JTrainer(
                jvmae.VideoMAEProbe.from_config(c.model), *a,
                mesh=make_mesh(n_data=1), **k)),
            (tconfig, tdata, lambda c, *a, **k: TTrainer(
                tvmae.VideoMAEProbe.from_config(c.model, dtype=torch.float32),
                *a, device="cpu", **k))):
        config = cfgmod.config_from_kwargs(
            {"model": f"include:{d / 'model.yaml'}"})
        config = cfgmod.update_config(str(d / "train.yaml"), config)
        config["dirs"]["data_dir"] = str(d / "data")
        config["training"].update(num_epochs=3, train_batch_size=B,
                                  **(training or {}))
        config["optimizer"].update(optimizer or {})
        config["model"]["decoder"]["output_dim"] = 100 * 4
        for k, v in (model_over or {}).items():
            config["model"][k] = v
        split = data.split_dataset(str(d / "data"), EID, seed=config.seed)
        loaders = data.make_loader(config, split)
        trainers.append((make(config, *loaders, config, eid=EID,
                              dataset_split_dict=split,
                              log_dir=str(tmp_path / cfgmod.__name__)),
                         loaders[1]))
    (jt, jval), (tt, _) = trainers
    jt._init_if_needed(np.asarray(next(iter(jval))["video"]))  # not shuffled
    tt._init_if_needed()
    load_into_model(tt.model, flax_to_torch(jax.device_get(jt.params)))
    return jt, tt


@pytest.mark.parametrize("path", ["staged", "streaming", "unfrozen",
                                  "unfused"])
def test_trainer_epochs_match_jax(session, tmp_path, f32_jax, path):
    """Staged features with the fused head step; raw video streamed,
    encoded, then the fused step; the whole model trained
    (``freeze_backbone: false``, the standard step); staged features with
    the standard head-only step (``fused_readout: false``)."""
    training = {"device_cache": False} if path == "streaming" else None
    model_over = {"freeze_backbone": False} if path == "unfrozen" else None
    optimizer = {"fused_readout": False} if path == "unfused" else None
    jt, tt = _both_trainers(session, tmp_path, model_over, training,
                            optimizer)
    assert tt._frozen_split == jt._frozen_split == (path != "unfrozen")
    assert (tt._fused_inner is not None) == (jt._fused_inner is not None) \
        == (path in ("staged", "streaming"))
    assert tt.params["encoder_head.kernel"].dtype == torch.bfloat16
    backbone = {k: v.clone() for k, v in tt.params.items()
                if k.startswith("video_mae.")}
    for epoch in range(3):
        tr_j, tr_t = jt.train_epoch(), tt.train_epoch()
        assert tr_t["train_loss"] == pytest.approx(tr_j["train_loss"],
                                                   rel=1e-4), epoch
        ev_j = jt.eval_epoch()["eval_res"]
        ev_t = tt.eval_epoch()["eval_res"]
        for k in ("eval_bps", "eval_rsquared"):
            assert abs(ev_t[k] - ev_j[k]) <= 1e-3, (epoch, k)
    moved = [not torch.equal(tt.params[k], v) for k, v in backbone.items()]
    assert not any(moved) if path != "unfrozen" else all(
        m for k, m in zip(backbone, moved) if "kernel" in k)
    if path in ("staged", "unfused"):
        assert tt._features_staged
        assert tuple(tt._dev_data[0].shape) == (tt._n_train, 64, 32)
        assert tt._eval_input_cache["eval"][0][0].ndim == 3
    else:
        assert not tt._features_staged


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _noise(b: int, length: int) -> np.ndarray:
    return np.random.default_rng(b * 1009 + length).random(
        (b, length), dtype=np.float32)


def _jax_masking(x, mask_ratio, rng):
    B_, L_, _ = x.shape
    len_keep = int(L_ * (1 - mask_ratio))
    ids_shuffle = jnp.argsort(jnp.asarray(_noise(B_, L_)), axis=1)
    ids_restore = jnp.argsort(ids_shuffle, axis=1)
    x_masked = jnp.take_along_axis(x, ids_shuffle[:, :len_keep, None], axis=1)
    mask = jnp.ones((B_, L_)).at[:, :len_keep].set(0.0)
    return x_masked, jnp.take_along_axis(mask, ids_restore, axis=1), \
        ids_restore


_port_masking = tvit.random_masking


def _torch_masking(x, mask_ratio, generator=None, noise=None):
    noise = torch.from_numpy(_noise(x.shape[0], x.shape[1]))
    return _port_masking(x, mask_ratio, noise=noise.to(x.device))


class _NpSpy:
    """numpy, recording what ``mean`` is given (the JAX CLI's final
    ``np.mean`` over its per-step losses)."""

    def __init__(self):
        self.means = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, xs, *args, **kwargs):
        self.means.append(list(xs))
        return np.mean(xs, *args, **kwargs)


def _pretrain_args(d, log_dir, steps):
    return ["--model_config", str(d / "model.yaml"),
            "--train_config", str(d / "train.yaml"), "--eid", EID,
            "--data_dir", str(d / "data"), "--log_dir", str(log_dir),
            "--max_steps", str(steps), "--batch_size", str(B)]


def test_pretrain_cli_matches_jax(session, tmp_path, monkeypatch, f32_jax):
    from video_spike_tpu.cli import pretrain_videomae as jcli
    from video_spike_torch.cli import pretrain_videomae as tcli
    from video_spike_torch.models.hf_convert import load_pretrained_into_probe

    monkeypatch.setattr(jvmae, "random_masking", _jax_masking)
    monkeypatch.setattr(tvmae, "random_masking", _torch_masking)
    backbone_cfg = {k: v for k, v in TINY.items()
                    if k not in ("encoder", "decoder")}
    key = jax.random.PRNGKey(42)                     # the CLI's --seed
    init = jax.device_get(jvmae.VideoMAEForPreTraining(
        config=backbone_cfg).init({"params": key, "masking": key},
                                  jnp.zeros((1, 8, 3, 32, 32))))

    class FromJax(tvmae.VideoMAEForPreTraining):
        """The port's model in f32, started from the JAX CLI's init."""

        def __init__(self, config, device=None, dtype=None):
            super().__init__(config, device=device, dtype=torch.float32)

        def reset_parameters(self, generator):
            load_into_model(self, flax_to_torch(init))

    monkeypatch.setattr(tcli, "VideoMAEForPreTraining", FromJax)
    spy, saved = _NpSpy(), {}
    monkeypatch.setattr(jcli, "np", spy)
    monkeypatch.setattr(jcli, "save_checkpoint",
                        lambda d, name, tree: saved.update(tree))
    jcli.main(_pretrain_args(session, tmp_path / "jax", 5))
    res = tcli.main(_pretrain_args(session, tmp_path / "torch", 5)
                    + ["--device", "cpu"])
    (losses_j,) = spy.means
    assert len(res["losses"]) == len(losses_j) == 5
    np.testing.assert_allclose(res["losses"], losses_j, rtol=1e-4)
    assert res["path"] == str(tmp_path / "torch" / EID[:5]
                              / "VideoMAEPretrain" / "backbone.pt")
    ckpt = torch.load(res["path"], weights_only=True)["params"]
    assert ckpt.keys() == flax_to_torch(saved["params"]).keys()
    # the checkpoint fills the probe's (hf_compat: false) backbone
    probe = {k: v.detach() for k, v in tvmae.VideoMAEProbe(
        dict(TINY, hf_compat=False)).named_parameters()}
    out = load_pretrained_into_probe(probe, res["path"])
    for k, v in out.items():
        if k.startswith("video_mae."):
            assert torch.equal(v, ckpt[k[len("video_mae."):]]), k


def _train_args(d, log_dir, epochs, *extra):
    return ["--model_config", str(d / "probe_model.yaml"),
            "--train_config", str(d / "train.yaml"), "--eid", EID,
            "--data_dir", str(d / "data"), "--log_dir", str(log_dir),
            "--num_epochs", str(epochs), "--batch_size", str(B),
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_runs(session):
    """cli.pretrain_videomae (3 steps), then cli.train on the probe from
    its backbone.pt for 2 epochs, then --resume for a third."""
    from video_spike_torch.cli import pretrain_videomae
    from video_spike_torch.cli import train as train_cli

    pre = pretrain_videomae.main(_pretrain_args(session, session / "pre", 3)
                                 + ["--device", "cpu"])
    model = yaml.safe_load((session / "model.yaml").read_text())
    model["pretrained_backbone"] = pre["path"]
    (session / "probe_model.yaml").write_text(yaml.safe_dump(model))
    logs = session / "logs"
    first = train_cli.main(_train_args(session, logs, 2))
    last = torch.load(Path(first["log_dir"]) / "model_last.pt",
                      weights_only=True)
    resumed = train_cli.main(_train_args(session, logs, 3, "--resume"))
    return pre, first, last, resumed


def test_cli_trains_probe_from_pretrained_backbone(cli_runs):
    pre, res, last, _ = cli_runs
    assert all(np.isfinite(pre["losses"])) and len(pre["losses"]) == 3
    assert res["fused_readout"] and res["features_staged"]
    assert res["global_step"] == 4             # 12 train trials / 8, 2 epochs
    ckpt = torch.load(pre["path"], weights_only=True)["params"]
    backbone = {k: v for k, v in last["params"].items()
                if k.startswith("video_mae.")}
    assert backbone and all(torch.equal(v, ckpt[k[len("video_mae."):]])
                            for k, v in backbone.items())
    assert last["params"]["encoder_head.kernel"].dtype == torch.bfloat16
    assert last["opt_state"]["fused"]["count"] == 4
    assert not any(k.startswith("video_mae.")
                   for k in last["opt_state"]["rest"]["v"])
    for k in ("test_loss", "test_bps", "test_rsquared"):
        assert np.isfinite(res["test_res"][k]), k
    log_dir = Path(res["log_dir"])
    for name in ("model_best.pt", "model_last.pt", "test_results.npy"):
        assert (log_dir / name).is_file(), name
    preds = np.load(log_dir / "test_results.npy",
                    allow_pickle=True).item()["test_preds"][0]
    assert preds.shape[1:] == (100, 4) and np.isfinite(preds).all()


def test_cli_probe_resume_continues(cli_runs):
    _, first, _, resumed = cli_runs
    assert resumed["start_epoch"] == 2 and resumed["fused_readout"]
    assert resumed["global_step"] == first["global_step"] + 2
    assert np.isfinite(resumed["train_losses"]).all()


def test_cli_probe_needs_a_card_unless_cpu(session, tmp_path):
    from video_spike_torch.cli import pretrain_videomae
    from video_spike_torch.cli import train as train_cli

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(_train_args(session, tmp_path, 1)[:-2])
        with pytest.raises(RuntimeError, match="cuda"):
            pretrain_videomae.main(_pretrain_args(session, tmp_path, 1))
