"""PyTorch port of the fused train step, trainer and CLI against the JAX
package, plus the port's import guard.

Inputs are made with numpy from a seed and fed to both packages; the port
starts from the JAX parameters through ``video_spike_torch.convert``. The
model computes in f32 here (the point is the algorithm; bf16 rounds at other
places in the two frameworks) and stores the big leaves in bf16 with
stochastic rounding, as the production configuration does, at the
production peak learning rate. Tolerances for the 3 chained fused steps:

- loss: rtol 1e-5 (f32 forward; matmul summation order);
- f32 rest params: rtol 1e-4 with an absolute floor of 1e-2 of one step
  (the learning rate), for elements that moved from zero;
- bf16 leaves (the first kernel and the decoder head): >= 99.9% bitwise and
  within 1 bf16 ulp plus 2^-20 of the leaf's scale (the f32 gradients differ
  in the last bits, which can flip an SR decision; where a sum cancels to
  near zero the bf16 ulp is finer than that f32 error);
- the fused row/col statistics: rtol 1e-4; the f32 adafactor statistics:
  rtol 1e-4 with a floor of 1e-4 of the leaf's largest value (a gradient
  that cancels to near zero has a larger relative error); the bf16
  statistics of the decoder head: within 1 bf16 ulp.

The trainer-level comparison is on quality: best eval bits/spike within 0.2
of the JAX trainer's on the same fixture and batch (the initial weights come
from different generators).
"""

import ast
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_spike_tpu.models.linear import LinearModel as JLinear
from video_spike_tpu.ops import fused_readout as jfr
from video_spike_tpu.ops.optim import apply_updates_sr as j_apply_sr
from video_spike_tpu.ops.poisson import poisson_nll_mean as j_nll_mean
from video_spike_torch.convert import (
    adafactor_state_from_optax,
    flax_to_torch,
    load_into_model,
    to_numpy,
)
from video_spike_torch.models.linear import LinearModel as TLinear
from video_spike_torch.ops import fused_readout as tfr
from video_spike_torch.ops import optim as toptim
from video_spike_torch.ops.poisson import poisson_nll_mean as t_nll_mean

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
B = 8
IN_SHAPE = (B, 5, 1, 16, 16)
WIDTHS = dict(encoder_hidden=(128, 32), encoder_out=16,
              decoder_hidden=(32, 256), output_dim=100 * 6)
EID = "trnee0000"
LR = 5e-5          # the peak lr of configs/train/linear_video.yaml


def _within(a, b, rel_scale):
    """|a - b| <= 1 bf16 ulp at max(|a|, |b|) + rel_scale * max|b|."""
    a32 = np.asarray(a, np.float32)
    b32 = np.asarray(b, np.float32)
    big = np.maximum(np.abs(a32), np.abs(b32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-38))) - 7)
    return np.abs(a32 - b32) <= ulp + rel_scale * np.abs(b32).max()


def _assert_bf16_close(got, ref, what):
    g, r = to_numpy(got), np.asarray(ref)
    assert g.dtype == r.dtype, what
    assert (g.view(np.uint16) == r.view(np.uint16)).mean() >= 0.999, what
    assert _within(g, r, 2.0**-20).all(), what


def test_fused_linear_step_matches_jax():
    jm = JLinear(**WIDTHS, compute_dtype=jnp.float32)
    tm = TLinear(input_dim=int(np.prod(IN_SHAPE[1:])), **WIDTHS,
                 compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 255, IN_SHAPE, dtype=np.uint8).reshape(B, -1)
          for _ in range(3)]
    aps = [rng.poisson(1.0, (B, 100, 6)).astype(np.float32)
           for _ in range(3)]
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jnp.float32))
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                          if p.size >= 1 << 16 else p, params)
    assert params["params"]["decoder"]["Dense_2"]["kernel"].dtype \
        == jnp.bfloat16

    sched_j = optax.cosine_onecycle_schedule(16, LR, 0.15, 10, 1e4)
    sched_t = toptim.cosine_onecycle_schedule(16, LR, 0.15, 10, 1e4)
    tx_j = optax.adafactor(sched_j, multiply_by_parameter_scale=False,
                           clipping_threshold=None)
    step_j = jax.jit(jfr.make_fused_linear_step(
        jm, tx_j, sched_j, lambda o, a, nv: j_nll_mean(o, a, nv),
        j_apply_sr))
    opt_j = jfr.init_fused_opt_state(params, tx_j)

    load_into_model(tm, flax_to_torch(jax.device_get(params)))
    tx_t = toptim.Adafactor(sched_t)
    step_t = tfr.make_fused_linear_step(tm, tx_t, sched_t, t_nll_mean,
                                        toptim.apply_updates_sr)
    p_t = {k: v.detach() for k, v in tm.named_parameters()}
    opt_t = tfr.init_fused_opt_state(p_t, tx_t)

    p_j = params
    for i in range(3):
        p_j, opt_j, loss_j = step_j(p_j, opt_j, jnp.asarray(xs[i]),
                                    jnp.asarray(aps[i]), jnp.float32(B),
                                    jnp.uint32(i))
        p_t, opt_t, loss_t = step_t(p_t, opt_t, torch.from_numpy(xs[i]),
                                    torch.from_numpy(aps[i]), B, i)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
        ref = flax_to_torch(jax.device_get(p_j))
        for k, got in p_t.items():
            if got.dtype == torch.bfloat16:
                _assert_bf16_close(got, to_numpy(ref[k]), (i, k))
            else:
                np.testing.assert_allclose(got.numpy(), ref[k].numpy(),
                                           rtol=1e-4, atol=1e-2 * LR,
                                           err_msg=f"{i} {k}")
        f_j, rest_j = jax.device_get(opt_j)
        f_t, rest_t = opt_t
        assert f_t.count == int(f_j.count) == i + 1
        np.testing.assert_allclose(f_t.row.numpy(), f_j.row, rtol=1e-4)
        np.testing.assert_allclose(f_t.col.numpy(), f_j.col, rtol=1e-4)
        rest_ref = adafactor_state_from_optax(rest_j)
        assert rest_t["count"] == rest_ref["count"]
        for part in ("v_row", "v_col", "v"):
            for k, got in rest_t[part].items():
                r = rest_ref[part][k]
                assert got.dtype == r.dtype and got.shape == r.shape
                if got.dtype == torch.bfloat16:
                    assert _within(to_numpy(got), to_numpy(r), 0.0).all()
                else:
                    np.testing.assert_allclose(
                        got.numpy(), r.numpy(), rtol=1e-4,
                        atol=1e-4 * float(r.abs().max()))


def test_forward_split_matches_model_forward():
    """preprocess_flat + first Dense + tail_apply is the model's forward,
    bit for bit, and split/merge round-trips the params."""
    tm = TLinear(input_dim=int(np.prod(IN_SHAPE[1:])), **WIDTHS)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, IN_SHAPE, dtype=np.uint8).reshape(B, -1))
    params = {k: v.detach() for k, v in tm.named_parameters()}
    kernel, rest = tfr.split_first_kernel(params)
    assert tfr.FIRST_KERNEL not in rest
    with torch.no_grad():
        ref = tm(x)
        flat = tfr.preprocess_flat(tm, x)
        z1 = flat @ kernel.to(tm.compute_dtype) \
            + rest[tfr.FIRST_BIAS].to(tm.compute_dtype)
        out = tfr.tail_apply(tm, rest, z1)
    assert torch.equal(ref, out)
    assert tfr.merge_first_kernel(rest, kernel).keys() == params.keys()


# ---------------------------------------------------------------------------
# trainer and CLI on a tiny fixture
# ---------------------------------------------------------------------------

PRODUCTION_OPT = dict(name="adafactor", param_scale=False, clipping=None,
                      param_dtype="bfloat16_sr", fused_readout=True,
                      fused_min_kernel=1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 32x32 synthetic session and yaml configs: linear_video with narrow
    widths and the production optimizer overrides."""
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path_factory.mktemp("torch_train")
    make_synthetic_session(d / "data", eid=EID, n_trials=20, n_neurons=6,
                           seed=3, height=32, width=32)
    model = yaml.safe_load((REPO / "configs/model/linear_video.yaml")
                           .read_text())
    model["encoder"].update(hidden_dims=[32, 16], output_dim=16)
    model["decoder"]["hidden_dims"] = [16, 256]
    (d / "model.yaml").write_text(yaml.safe_dump(model))
    train = yaml.safe_load((REPO / "configs/train/linear_video.yaml")
                           .read_text())
    train["optimizer"].update(PRODUCTION_OPT)
    (d / "train.yaml").write_text(yaml.safe_dump(train))
    return d


def _cli_args(d, log_dir, epochs, *extra):
    return ["--model_config", str(d / "model.yaml"),
            "--train_config", str(d / "train.yaml"), "--eid", EID,
            "--data_dir", str(d / "data"), "--log_dir", str(log_dir),
            "--num_epochs", str(epochs), "--batch_size", "8",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_run(tiny):
    from video_spike_torch.cli import train as train_cli

    log_dir = tiny / "logs"
    first = train_cli.main(_cli_args(tiny, log_dir, 2))
    last = torch.load(Path(first["log_dir"]) / "model_last.pt",
                      weights_only=True)
    resumed = train_cli.main(_cli_args(tiny, log_dir, 3, "--resume"))
    return first, last, resumed


def test_cli_trains_fixture_end_to_end(cli_run):
    res, last, _ = cli_run
    assert res["fused_readout"], "the fused step was not engaged"
    assert res["global_step"] == 4           # 16 train trials / 8, 2 epochs
    assert all(np.isfinite(res["train_losses"]))
    assert np.isfinite(res["best_eval_bps"])
    for k in ("test_loss", "test_bps", "test_rsquared"):
        assert np.isfinite(res["test_res"][k]), k
    log_dir = Path(res["log_dir"])
    for name in ("model_best.pt", "model_last.pt", "test_results.npy"):
        assert (log_dir / name).is_file(), name
    saved = np.load(log_dir / "test_results.npy", allow_pickle=True).item()
    preds = saved["test_preds"][0]
    assert preds.shape[1:] == (100, 6) and np.isfinite(preds).all()
    assert last["global_step"] == 4 and last["epoch"] == 1
    assert last["params"]["encoder.Dense_0.kernel"].dtype == torch.bfloat16
    assert last["opt_state"]["fused"]["count"] == 4


def test_cli_resume_continues(cli_run):
    first, _, resumed = cli_run
    assert resumed["start_epoch"] == 2
    assert resumed["global_step"] == first["global_step"] + 2
    assert len(resumed["train_losses"]) == 1
    assert np.isfinite(resumed["train_losses"][0])


def test_cli_rejects_what_this_slice_leaves_out(tiny, tmp_path,
                                               monkeypatch):
    """--save_plot where matplotlib is missing (the card's machine) raises
    an ImportError naming it when the trainer is built, for one session
    and for a session list; cuda without a card raises."""
    from video_spike_torch.cli import train as train_cli

    args = _cli_args(tiny, tmp_path, 1)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        for eid in (EID, f"{EID},{EID}"):   # one session, a session list
            with pytest.raises(ImportError, match="matplotlib"):
                train_cli.main([a if a != EID else eid for a in args]
                               + ["--save_plot"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(args[:-2] + ["--device", "cuda"])


def test_streaming_path_over_the_cache_cap(tiny, tmp_path):
    """A dataset over training.device_cache_gb streams batch by batch (and
    the standard, non-fused step runs when fused_readout is off)."""
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    cfg = yaml.safe_load((tiny / "train.yaml").read_text())
    cfg["training"]["device_cache_gb"] = 1e-6
    cfg["optimizer"]["fused_readout"] = False
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    args = _cli_args(tiny, tmp_path / "logs", 1)
    args[args.index("--train_config") + 1] = str(tmp_path / "train.yaml")
    trainer = train_cli.build_trainer(get_args(args))
    res = trainer.train_epoch()
    assert trainer._dev_data is None and trainer._fused_inner is None
    assert trainer.global_step == 2 and np.isfinite(res["train_loss"])
    ev = trainer.eval_epoch()["eval_res"]
    assert all(np.isfinite(v) for v in ev.values())


def test_trainer_quality_matches_jax_trainer(tiny, cli_run):
    """Best eval bps of the port within 0.2 of the JAX trainer's, same
    fixture, config and batch of 8 (the JAX trainer rounds the batch up to
    its 8-device test mesh, so 8 keeps the two runs alike)."""
    from video_spike_tpu.core.config import config_from_kwargs, update_config
    from video_spike_tpu.core.registry import NAME2MODEL
    from video_spike_tpu.data.dataset import (
        get_metadata_from_loader, make_loader, split_dataset)
    from video_spike_tpu.train.base import BaseTrainer

    config = config_from_kwargs({"model": f"include:{tiny / 'model.yaml'}"})
    config = update_config(str(tiny / "train.yaml"), config)
    config["dirs"]["data_dir"] = str(tiny / "data")
    config["training"]["num_epochs"] = 2
    config["training"]["train_batch_size"] = 8
    split = split_dataset(str(tiny / "data"), EID, seed=config.seed)
    train_dl, val_dl, test_dl = make_loader(config, split)
    meta = get_metadata_from_loader(train_dl, config)
    config["model"]["encoder"]["input_dim"] = meta["input_dim"]
    config["model"]["decoder"]["output_dim"] = meta["output_dim"]
    model = NAME2MODEL[config.model.model_class].from_config(config.model)
    trainer = BaseTrainer(model, train_dl, val_dl, test_dl, config, eid=EID,
                          dataset_split_dict=split,
                          log_dir=str(tiny / "jax_logs"))
    res_j = trainer.train()
    assert trainer._fused_inner is not None
    res_t = cli_run[0]
    assert abs(res_t["best_eval_bps"] - res_j["best_eval_bps"]) < 0.2, (
        res_t["best_eval_bps"], res_j["best_eval_bps"])


# ---------------------------------------------------------------------------
# import guard
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "video_spike_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "video_spike_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts/profile_torch_step.py"]
    assert len(files) > 15
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"video_spike_torch/models/videomae.py",
            "video_spike_torch/models/hf_convert.py",
            "video_spike_torch/cli/pretrain_videomae.py",
            "video_spike_torch/serve/session.py",
            "video_spike_torch/serve/batcher.py",
            "video_spike_torch/serve/http.py",
            "video_spike_torch/serve/export.py",
            "video_spike_torch/cli/serve.py",
            "video_spike_torch/cli/export_model.py",
            "video_spike_torch/models/cebra.py",
            "video_spike_torch/viz/embeddings.py",
            "video_spike_torch/cli/use_cebra.py",
            "video_spike_torch/cli/unify_cebra.py",
            "video_spike_torch/core/tracking.py",
            "video_spike_torch/viz/plots.py",
            "video_spike_torch/viz/raster.py",
            "video_spike_torch/cli/visualize_result.py",
            "video_spike_torch/cli/plot_raster.py",
            "video_spike_torch/cli/plot_scatter.py",
            "video_spike_torch/data/native_io.py",
            "video_spike_torch/data/prefetch.py",
            "video_spike_torch/data/dataset.py",
            "video_spike_torch/train/checkpoint.py",
            "video_spike_torch/core/runtime.py",
            "video_spike_torch/parallel/__init__.py",
            "video_spike_torch/parallel/mesh.py",
            "video_spike_torch/parallel/multihost.py",
            "video_spike_torch/parallel/shard_map_step.py",
            "video_spike_torch/parallel/dcn_smoke.py",
            "video_spike_torch/parallel/dcn_trainer_smoke.py",
            "video_spike_torch/core/spans.py"} <= names
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
