"""``scripts/convert_jax_checkpoint.py``: the JAX package's orbax
checkpoints restored in the PyTorch port.

Each optimizer state the JAX trainers write (every optax chain of the
Linear trainer's options, ``MultiSteps`` alone and around the frozen mask,
the fused readout's) is saved by the JAX package's ``save_checkpoint``,
converted by the script, and compared with ``video_spike_torch.convert``
applied to the live optax object. Then, for each model class, a tiny JAX
run's checkpoints are converted and used by the port:

- the Linear (``BaseTrainer``: the default AdamW, ``adafactor_lean`` with
  the fused readout on a bf16 SR store, ``adamw_sr_bf16`` under
  accumulation) and the VTT (``MultiSessionTrainer``): the port's
  ``InferenceSession.from_checkpoint`` on ``model_best`` against the JAX
  session's ``predict``, and a port ``resume`` from ``model_last`` whose
  next epoch matches the JAX trainer's resumed epoch;
- the SSL ``ContrastTrainer``: ``last_model`` with its sampler sidecar,
  resumed mid-epoch in both packages;
- a ``pretrain_videomae`` backbone, read by ``load_pretrained_into_probe``.

Tolerances: converted states and params bitwise equal, dtypes included;
the resumed epochs as ``tests/test_torch_optim_variants.py`` and
``tests/test_torch_multisession.py`` hold the trainers (train loss rtol
1e-4, eval bps within 1e-3) and the SSL steps as
``tests/test_torch_contrast.py`` (loss rtol 1e-4); the sessions, whose
registry models compute in bf16 in both packages, within 1e-2 of the
output's largest value (``chip_smoke.py``'s bound for a bf16 session;
bf16 roundings of XLA's and torch's GEMMs differ: 1.7e-5 to 8.9e-5 here
for the Linear and 2.9e-3 for the VTT), and the restored params bitwise
equal to the JAX checkpoint's.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_spike_torch import convert as cv
from video_spike_torch.convert import flax_to_torch
from video_spike_torch.serve import InferenceSession
from video_spike_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SERVE_ATOL_REL = 1e-2


def _script():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", REPO / "scripts/convert_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


convert = _script()


def _same(got, want, where="state"):
    """Equal trees: the same containers and keys, ints, and tensors of the
    same dtype and shape, bit for bit."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got.view(torch.uint8) if got.dtype
                           == torch.bfloat16 else got,
                           want.view(torch.uint8) if want.dtype
                           == torch.bfloat16 else want), where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            where, sorted(got) if isinstance(got, dict) else got,
            sorted(want))
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _bf16(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


# ---------------------------------------------------------------------------
# every optimizer state, through the JAX package's save_checkpoint
# ---------------------------------------------------------------------------

def _state_cases():
    """name -> (make the JAX state from params and grads, the converter
    of the live state to the port's)."""
    from video_spike_tpu.train.base import make_optimizer as j_make
    from video_spike_tpu.core.config import DictConfig as JConfig
    from test_torch_optim_variants import (
        TRANSFORMS,
        _frozen_inner_from,
        _sched,
    )

    cases = {}
    for name, (make, _, state_from, _) in TRANSFORMS.items():
        cases[name] = (lambda m=make: m(_sched()[0]), state_from, False)
    cases["adamw"] = (lambda: optax.adamw(_sched()[0], weight_decay=0.01),
                      cv.adamw_state_from_optax, False)
    for frozen in (False, True):
        def accum(frozen=frozen):
            opt = {"lr": 1e-3, "warmup_pct": 0.15, "div_factor": 10,
                   "gradient_accumulation_steps": 2}
            return j_make(JConfig({"optimizer": opt}), 64, frozen_paths=(
                ("backbone",) if frozen else ()))[0]
        inner = _frozen_inner_from if frozen else cv.adamw_state_from_optax
        cases[f"multisteps{'_frozen' if frozen else ''}"] = (
            accum, lambda s, d=None, f=inner:
            cv.multisteps_state_from_optax(s, f), True)

    def frozen_only():
        opt = {"lr": 1e-3, "warmup_pct": 0.15, "div_factor": 10}
        return j_make(JConfig({"optimizer": opt}), 64,
                      frozen_paths=("backbone",))[0]
    cases["frozen"] = (frozen_only, _frozen_inner_from, True)
    return cases


STATE_CASES = sorted(["adafactor_lean", "adamw_lowmem", "adamw_mu_bf16",
                      "adafactor_param_scale", "adafactor_clipping",
                      "adafactor_momentum", "adafactor_wd", "adafactor_all",
                      "adamw", "multisteps", "multisteps_frozen", "frozen"])


@pytest.mark.parametrize("name", STATE_CASES)
def test_optimizer_state_converts_as_the_live_state(name, tmp_path):
    """model_last of ``BaseTrainer``'s layout, two updates in: the script's
    ``opt_state["tx"]`` equals the converter on the live optax state."""
    from test_torch_optim_variants import _frozen_tree, _trees
    from video_spike_tpu.train.checkpoint import save_checkpoint

    make, state_from, tree_of_params = _state_cases()[name]
    tx = make()
    if tree_of_params:
        jp, jg = _frozen_tree(2)
    else:
        jp, jg = _trees("float32" if name in ("adamw", "adamw_mu_bf16")
                        else "bfloat16", seed=4)
    js = tx.init(jp)
    for g in jg[:2]:
        _, js = tx.update(g, js, jp)
    save_checkpoint(tmp_path / "jax", "model_last", {
        "params": jp, "epoch": 3, "opt_state": js, "global_step": 2})
    written = convert.convert_path(tmp_path / "jax", tmp_path / "port")
    assert written == [str(tmp_path / "port" / "model_last.pt")]
    got = load_checkpoint(tmp_path / "port", "model_last")
    assert got["epoch"] == 3 and got["global_step"] == 2
    _same(got["params"], flax_to_torch(jax.device_get(jp)), "params")
    _same(got["opt_state"], {"tx": state_from(jax.device_get(js))})


def test_fused_readout_state_and_refusals(tmp_path):
    """The fused readout's ``(FusedReadoutState, lean state)`` becomes
    ``{"fused", "rest"}``; a state, a top-level leaf or a sidecar field the
    port has no place for is refused by name, and nothing is written."""
    from test_torch_optim_variants import _sched, _trees
    from video_spike_tpu.ops import fused_readout as jfr
    from video_spike_tpu.ops import optim as joptim
    from video_spike_tpu.train.checkpoint import save_checkpoint

    jp, _ = _trees("bfloat16", seed=5)
    rest = joptim.adafactor_lean(_sched()[0]).init(jp)
    fused = jfr.FusedReadoutState(jnp.asarray(7, jnp.int32),
                                  jnp.arange(300.0), jnp.arange(200.0))
    save_checkpoint(tmp_path / "a", "model_last", {
        "params": jp, "epoch": 0, "opt_state": (fused, rest),
        "global_step": 7})
    convert.convert_path(tmp_path / "a")
    got = load_checkpoint(tmp_path / "a", "model_last")["opt_state"]
    _same(got, {"fused": cv.fused_state_from_flax(
        jax.device_get(fused))._asdict(),
        "rest": cv.lean_state_from_flax(jax.device_get(rest))})

    save_checkpoint(tmp_path / "b", "model_last", {
        "params": jp, "epoch": 0, "global_step": 1,
        "opt_state": optax.sgd(0.1, momentum=0.9).init(jp)})
    with pytest.raises(convert.Unmapped, match="opt_state"):
        convert.convert_path(tmp_path / "b")
    save_checkpoint(tmp_path / "c", "model_best",
                    {"params": jp, "epoch": 0, "ema": jp})
    with pytest.raises(convert.Unmapped, match="ema"):
        convert.convert_path(tmp_path / "c")
    save_checkpoint(tmp_path / "d", "last_model",
                    {"params": jp, "step": 3, "best_bps": 0.1})
    (tmp_path / "d" / "last_model.sampler.json").write_text(
        json.dumps({"rng": 1, "consumed": 3, "step": 3}))
    with pytest.raises(convert.Unmapped, match="sampler"):
        convert.convert_path(tmp_path / "d")
    assert not any(p.suffix == ".pt" for d in "bcd"
                   for p in (tmp_path / d).iterdir())
    with pytest.raises(FileNotFoundError, match="no JAX checkpoint"):
        convert.convert_path(tmp_path / "e")


# ---------------------------------------------------------------------------
# the Linear: BaseTrainer
# ---------------------------------------------------------------------------

LINEAR_EID = "optvr0000"        # test_torch_optim_variants's fixture eid


@pytest.fixture(scope="module")
def linear_session(tmp_path_factory):
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path_factory.mktemp("migrate_linear")
    make_synthetic_session(d / "data", eid=LINEAR_EID, n_trials=20,
                           n_neurons=6, seed=3, height=32, width=32)
    model = yaml.safe_load((REPO / "configs/model/linear_video.yaml")
                           .read_text())
    model["encoder"].update(hidden_dims=[32, 16], output_dim=16)
    model["decoder"]["hidden_dims"] = [16, 256]
    (d / "model.yaml").write_text(yaml.safe_dump(model))
    return d


LINEAR_CASES = {
    "adamw": {},
    "lean_fused": dict(name="adafactor_lean", param_dtype="bfloat16_sr",
                       fused_readout=True, fused_min_kernel=1),
    "adamw_sr_accum": dict(name="adamw", param_dtype="bfloat16_sr",
                           gradient_accumulation_steps=2,
                           fused_readout=True)}


def _sessions_agree(port, jax_session, x, sids=None):
    got = port.predict(x, sids)
    want = jax_session.predict(x, sids) if sids is not None \
        else jax_session.predict(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SERVE_ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_linear_checkpoints_serve_and_resume(linear_session, tmp_path,
                                             case):
    """One JAX epoch, ``model_best`` and ``model_last`` converted into the
    port trainer's log dir; the port serves ``model_best`` and resumes
    ``model_last`` for a second epoch, against the JAX trainer resumed
    from its own ``model_last``."""
    from test_torch_optim_variants import both_linear_trainers
    from video_spike_tpu.serve.session import InferenceSession as JSession
    from video_spike_tpu.train.checkpoint import load_checkpoint as j_load

    jt, tt = both_linear_trainers(linear_session, tmp_path,
                                  LINEAR_CASES[case], epochs=2)
    jt.train_epoch()
    jt.save_model("best", 0)
    jt.save_model("last", 0)
    written = convert.convert_path(jt.log_dir, tt.log_dir)
    assert sorted(Path(p).name for p in written) == ["model_best.pt",
                                                     "model_last.pt"]

    cfg = json.loads(json.dumps(jt.config.model))
    port = InferenceSession.from_checkpoint(cfg, tt.log_dir, device="cpu",
                                            bucket_sizes=(1, 4))
    stored = flax_to_torch(jax.device_get(
        j_load(jt.log_dir, "model_best")["params"]))
    for k, v in stored.items():
        assert torch.equal(_bf16(port.params[k]), _bf16(v)), k
    js = JSession.from_checkpoint(cfg, jt.log_dir, bucket_sizes=(1, 4))
    x = np.random.default_rng(0).integers(
        0, 255, (3, port.params["encoder.Dense_0.kernel"].shape[0]),
        dtype=np.uint8)
    _sessions_agree(port, js, x)

    # both resumed in fresh trainers, as a new process would
    jt, tt = both_linear_trainers(linear_session, tmp_path,
                                  LINEAR_CASES[case], epochs=2)
    assert tt.resume()
    assert jt.resume()
    assert tt.global_step == jt._global_step and tt._start_epoch == 1
    js = jax.device_get(jt.opt_state)
    _same(tt._opt_state_tree(), {
        "adamw": lambda: {"tx": cv.adamw_state_from_optax(js)},
        "lean_fused": lambda: {
            "fused": cv.fused_state_from_flax(js[0])._asdict(),
            "rest": cv.lean_state_from_flax(js[1])},
        "adamw_sr_accum": lambda: {"tx": cv.multisteps_state_from_optax(
            js, cv.adamw_state_from_optax)}}[case]())
    tr_j, tr_t = jt.train_epoch(), tt.train_epoch()
    assert tr_t["train_loss"] == pytest.approx(tr_j["train_loss"], rel=1e-4)
    ev_j, ev_t = jt.eval_epoch()["eval_res"], tt.eval_epoch()["eval_res"]
    for k in ("eval_bps", "eval_rsquared"):
        assert abs(ev_t[k] - ev_j[k]) <= 1e-3, k


# ---------------------------------------------------------------------------
# the VTT: MultiSessionTrainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vtt_sessions(tmp_path_factory):
    from test_torch_multisession import EIDS
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path_factory.mktemp("migrate_vtt")
    make_synthetic_session(d / "data", eid=EIDS[0], n_trials=12,
                           n_neurons=6, seed=20, height=32, width=32)
    make_synthetic_session(d / "data", eid=EIDS[1], n_trials=12,
                           n_neurons=9, seed=21, height=32, width=32)
    return d


def test_vtt_checkpoints_serve_and_resume(vtt_sessions, tmp_path):
    from test_torch_multisession import (
        EIDS,
        MODEL,
        _assert_evals_close,
        _both_trainers,
    )
    from video_spike_tpu.serve.session import InferenceSession as JSession

    jt, tt = _both_trainers(vtt_sessions, tmp_path)
    jt.train_epoch()
    jt._best_params, jt._best_epoch = jt.params, 0
    jt._flush_best()
    jt._best_bps = 0.25
    jt._save_last(0)
    convert.convert_path(jt.log_dir, tt.log_dir)
    best = load_checkpoint(tt.log_dir, "model_best")
    assert best["epoch"] == 0

    cfg = dict(MODEL, n_sessions=None, max_neurons=None)
    port = InferenceSession.from_checkpoint(cfg, tt.log_dir, device="cpu",
                                            bucket_sizes=(4,))
    js = JSession.from_checkpoint(dict(MODEL, n_sessions=2, max_neurons=9),
                                  jt.log_dir, bucket_sizes=(4,))
    rng = np.random.default_rng(1)
    video = rng.integers(0, 255, (3, 120, 1, 32, 32), dtype=np.uint8)
    _sessions_agree(port, js, video, np.asarray([1, 0, 1], np.int32))

    jt, tt = _both_trainers(vtt_sessions, tmp_path)     # fresh, resumed
    assert tt.resume()
    assert jt.resume()
    assert tt._best_bps == jt._best_bps == 0.25
    assert tt.global_step == jt._gstep and tt._start_epoch == 1
    _same(tt.opt_state, cv.adamw_state_from_optax(
        jax.device_get(jt.opt_state)))
    tr_j, tr_t = jt.train_epoch(), tt.train_epoch()
    assert tr_t["train_loss"] == pytest.approx(tr_j["train_loss"], rel=1e-4)
    _assert_evals_close(tt._eval(tt.val_loaders, "eval"),
                        jt._eval(jt.val_loaders, "eval"))
    assert set(EIDS) == set(tt.eids)


# ---------------------------------------------------------------------------
# the SSL trainer and the VideoMAE backbone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssl_cache(tmp_path_factory):
    """The whisker-video h5 of ``tests/test_torch_contrast.py``'s session,
    written by the JAX package's ``create_eid_data``."""
    from test_torch_contrast import CREATE_ARGS, EID
    from video_spike_tpu.cli.create_eid_data import main as j_create
    from video_spike_torch.data.synthetic import make_synthetic_session

    fx = tmp_path_factory.mktemp("migrate_ssl_fx")
    work = tmp_path_factory.mktemp("migrate_ssl_work")
    make_synthetic_session(fx, eid=EID, n_trials=20, n_neurons=8, seed=7,
                           height=32, width=32)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        os.makedirs("data")
        Path("data/eid.txt").write_text(f"{EID}\n")
        j_create(CREATE_ARGS + ["--data_dir", str(fx)])
    finally:
        os.chdir(cwd)
    return str(work / "data" / "data_rrr_whisker-video.h5")


def test_ssl_last_model_resumes_mid_epoch(ssl_cache, tmp_path, monkeypatch):
    """The JAX trainer stops at step 3 of its epoch; its ``last_model``
    (AdamW state, step, best) and sampler sidecar, converted, resume the
    port mid-epoch to step 6, step for step with the JAX trainer resumed
    from its own."""
    from test_torch_contrast import EID, _loaders, _port_trainer
    from test_torch_ssl import (
        TINY,
        _F32Backbone,
        _jax_masking,
        _torch_masking,
    )
    from video_spike_tpu.data.contrast import make_contrast_loader as j_loader
    from video_spike_tpu.models import vit_mae as jvit
    from video_spike_tpu.parallel.mesh import make_mesh
    from video_spike_tpu.train.contrast import ContrastTrainer as JTrainer
    from video_spike_torch.models import vit_mae as tvit

    monkeypatch.setattr(jvit, "ViTMAEBackbone", _F32Backbone)
    monkeypatch.setattr(jvit, "random_masking", _jax_masking)
    monkeypatch.setattr(tvit, "random_masking", _torch_masking)

    def jax_trainer():
        dl, train_dl, val_dl = _loaders(ssl_cache, j_loader)
        return JTrainer(jvit.ContrastViTMAE.from_config(TINY), dl,
                        {"lr": 1e-3}, val_data_loader=val_dl,
                        train_data_loader=train_dl, max_steps=6,
                        eid=EID, log_dir=str(tmp_path / "jax"),
                        image_size=32, seed=0, validate_every=10**6,
                        mesh=make_mesh(devices=jax.devices()[:1]))

    first = jax_trainer()
    first.max_steps = 3             # stopped early: the 6-step run's dir
    first.fit()
    tt = _port_trainer(ssl_cache, tmp_path / "port", 6,
                       validate_every=10**6)
    written = convert.convert_path(first.log_dir, tt.log_dir)
    names = sorted(Path(p).name for p in written)
    assert names == ["best_model.meta.json", "best_model.pt",
                     "last_model.pt", "last_model.sampler.json"], names
    last = load_checkpoint(tt.log_dir, "last_model")
    assert last["step"] == 3 and set(last) == {"params", "opt_state",
                                               "step", "best_bps"}

    jt = jax_trainer()
    assert jt.resume()
    losses_j, step = [], jt._step_staged

    def record_step(staged, cur_step):
        out = step(staged, cur_step)
        losses_j.append(float(out["loss"]))
        return out

    jt._step_staged = record_step
    jt.fit()
    assert tt.resume()
    assert tt._start_step == 3 and tt._resume_skip == 3
    _same(tt.opt_state, cv.adamw_state_from_optax(
        jax.device_get(first.opt_state)))
    tt.fit()
    assert len(tt.train_losses) == len(losses_j) == 3
    np.testing.assert_allclose(tt.train_losses, losses_j, rtol=1e-4)


def test_pretrained_backbone_fills_the_probe(tmp_path):
    """The JAX ``cli.pretrain_videomae`` (2 steps) writes an orbax
    ``backbone``; converted, ``load_pretrained_into_probe`` reads it into
    the probe's backbone bit for bit, and reading the directory itself
    raises naming the script."""
    from test_torch_probe import B, EID, PRODUCTION_OPT, TINY
    from video_spike_tpu.cli import pretrain_videomae as jcli
    from video_spike_tpu.train.checkpoint import load_checkpoint as j_load
    from video_spike_torch.data.synthetic import make_synthetic_session
    from video_spike_torch.models import videomae as tvmae
    from video_spike_torch.models.hf_convert import load_pretrained_into_probe

    make_synthetic_session(tmp_path / "data", eid=EID, n_trials=16,
                           n_neurons=4, seed=3, height=32, width=32)
    model = yaml.safe_load((REPO / "configs/model/videomae/videomae.yaml")
                           .read_text())
    model.update(TINY, hf_compat=False)
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(model))
    train = yaml.safe_load((REPO / "configs/train/vmae_video.yaml")
                           .read_text())
    train["optimizer"].update(PRODUCTION_OPT)
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(train))
    path = jcli.main(["--model_config", str(tmp_path / "model.yaml"),
                      "--train_config", str(tmp_path / "train.yaml"),
                      "--eid", EID, "--data_dir", str(tmp_path / "data"),
                      "--log_dir", str(tmp_path / "logs"),
                      "--max_steps", "2", "--batch_size", str(B)])
    probe = {k: v.detach() for k, v in tvmae.VideoMAEProbe(
        dict(TINY, hf_compat=False)).named_parameters()}
    with pytest.raises(ValueError, match="convert_jax_checkpoint.py"):
        load_pretrained_into_probe(probe, path)
    assert [Path(p).resolve() for p in convert.main([path])] == [
        Path(path + ".pt").resolve()]
    want = flax_to_torch(jax.device_get(
        j_load(Path(path).parent, "backbone")["params"]))
    out = load_pretrained_into_probe(probe, path + ".pt")
    grafted = [k for k in out if k.startswith("video_mae.")]
    assert grafted
    for k in grafted:
        assert torch.equal(out[k], want[k[len("video_mae."):]].to(
            out[k].dtype)), k
