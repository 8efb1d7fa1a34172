"""The port's trainers across processes against the JAX package's.

Two gloo ranks on the CPU (``torch.distributed.run --standalone``, one
process each) run ``video_spike_torch.parallel.dcn_trainer_smoke``; two JAX
processes (``jax.distributed`` over ``JAX_COORDINATOR_ADDRESS``, one CPU
device each, so both packages shard the same global batch the same way)
run ``video_spike_tpu.parallel.dcn_trainer_smoke`` on the same fixture.
The port's ranks start from the JAX run's initial weights (``DCN_INIT``,
converted with ``video_spike_torch.convert``). The Linear and SSL cases run
both packages' models in float32 (the smokes' models compute in bf16, whose
rounding differs between XLA and torch by more than the tolerances below):
each launch goes through a ``-c`` wrapper that sets the compute dtype and
then calls the smoke's ``main()``. Every launch has its own timeout, so a
hung rank fails its test.

Tolerances: ``best_eval_bps`` and ``test_bps`` within 1e-3, ``test_loss``
rtol 1e-4 (Linear, float32); multisession (bf16) bps within 1e-3; SSL
(float32) ``best_bps`` within 1e-3 and the embedding sum rtol 1e-3; the
numbers of both ranks equal; artifacts written by rank 0 only (one file
each); the SSL mid-epoch resume bitwise equal to an uninterrupted run on
every rank.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
LAUNCH_TIMEOUT = 240


def _env(**extra):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.update({"DCN_SMOKE_FORCE_CPU": "1", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": os.pathsep.join(
                    [str(REPO), env.get("PYTHONPATH", "")])})
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _wait(procs, timeout=LAUNCH_TIMEOUT):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
            pytest.fail(f"a rank hung past {timeout} s:\n"
                        + p.communicate()[0][-4000:])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def _spawn(cmd, env):
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


_LAUNCH = [sys.executable, "-m", "torch.distributed.run", "--standalone"]


def torch_code(code, env, world=2, args=()):
    """Start `world` port ranks running `code` (``sys.argv[1:]`` = `args`)
    under torch.distributed.run."""
    return [_spawn(_LAUNCH + [f"--nproc_per_node={world}", "--no-python",
                              sys.executable, "-c", code,
                              *map(str, args)], env)]


def torch_ranks(module, env, world=2, prelude=""):
    """Start `world` port ranks under torch.distributed.run; a `prelude`
    runs in each rank before the module's ``main()``."""
    if prelude:
        return torch_code(
            f"{prelude}\nfrom video_spike_torch.core.runtime import run_rank"
            f"\nfrom {module} import main\nrun_rank(main)\n", env, world)
    return [_spawn(_LAUNCH + [f"--nproc_per_node={world}", "-m", module],
                   env)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_processes(module, env, world=2, prelude=""):
    """Start `world` JAX processes, one CPU device each."""
    base = dict(env, JAX_COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
                JAX_NUM_PROCESSES=str(world),
                XLA_FLAGS="--xla_force_host_platform_device_count=1")
    cmd = ([sys.executable, "-c",
            f"{prelude}\nfrom {module} import main\nmain()\n"]
           if prelude else [sys.executable, "-m", module])
    return [_spawn(cmd, dict(base, JAX_PROCESS_ID=str(pid)))
            for pid in range(world)]


def results(outs, world=2):
    """Each rank's ``pid=<rank> result={...}`` object (the ranks of one
    launch share a pipe, so a line may run on into another rank's)."""
    text = "\n".join(outs)
    found = []
    for pid in range(world):
        m = re.search(rf"pid={pid} result=\{{", text)
        assert m, text[-6000:]
        found.append(json.JSONDecoder().raw_decode(text, m.end() - 1)[0])
    return found


# float32 compute in both packages' smoke models
F32 = {
    "linear": (
        "import jax.numpy as jnp\n"
        "from video_spike_tpu.models import linear as L\n"
        "f = L.LinearModel.from_config.__func__\n"
        "L.LinearModel.from_config = classmethod(\n"
        "    lambda cls, c: f(cls, c).clone(compute_dtype=jnp.float32))",
        "import torch\n"
        "from video_spike_torch.models import linear as L\n"
        "f = L.LinearModel.from_config.__func__\n"
        "L.LinearModel.from_config = classmethod(\n"
        "    lambda cls, c, device=None, compute_dtype=None:\n"
        "    f(cls, c, device=device, compute_dtype=torch.float32))"),
    "ssl": (
        "from typing import Any\n"
        "import jax.numpy as jnp\n"
        "from video_spike_tpu.models import vit_mae as V\n"
        "class F32(V.ViTMAEBackbone):\n"
        "    dtype: Any = jnp.float32\n"
        "V.ViTMAEBackbone = F32",
        "import torch\n"
        "from video_spike_torch.models import vit_mae as V\n"
        "f = V.ContrastViT.from_config.__func__\n"
        "V.ContrastViT.from_config = classmethod(\n"
        "    lambda cls, c, device=None, dtype=None:\n"
        "    f(cls, c, device=device, dtype=torch.float32))"),
}


def run_both(port_env, jax_env, f32=None, mode_module="dcn_trainer_smoke"):
    """The JAX pair and the port pair, started together; `f32` names the
    float32 preludes of :data:`F32` to run first."""
    jax_pre, torch_pre = F32[f32] if f32 else ("", "")
    jp = jax_processes(f"video_spike_tpu.parallel.{mode_module}", jax_env,
                       prelude=jax_pre)
    tp = torch_ranks(f"video_spike_torch.parallel.{mode_module}", port_env,
                     prelude=torch_pre)
    return results(_wait(tp)), results(_wait(jp))


def save_init(model, jax_params, path):
    """Convert JAX params into a port model and save them as DCN_INIT."""
    import jax

    from video_spike_torch.convert import flax_to_torch, load_into_model

    load_into_model(model, flax_to_torch(jax.device_get(jax_params)))
    torch.save({k: p.detach().clone() for k, p in model.named_parameters()},
               path)
    return str(path)


# ---------------------------------------------------------------------------
# Linear BaseTrainer
# ---------------------------------------------------------------------------

LINEAR_EID = "dcnlin0000"


@pytest.fixture(scope="module")
def linear_fixture(tmp_path_factory):
    """The fixture and the JAX trainer's initial weights as DCN_INIT."""
    from video_spike_tpu.core.config import config_from_kwargs, update_config
    from video_spike_tpu.core.registry import NAME2MODEL
    from video_spike_tpu.data.dataset import (
        get_metadata_from_loader, make_loader, split_dataset)
    from video_spike_tpu.train.base import BaseTrainer
    from video_spike_torch.data.synthetic import make_synthetic_session
    from video_spike_torch.models.linear import LinearModel

    d = tmp_path_factory.mktemp("dist_linear")
    make_synthetic_session(d / "fix", eid=LINEAR_EID, n_trials=16,
                           n_neurons=5, seed=31, height=32, width=32)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        config = config_from_kwargs(
            {"model": "include:configs/model/linear_me.yaml"})
        config = update_config("configs/train/linear_me.yaml", config)
    finally:
        os.chdir(cwd)
    config["dirs"]["data_dir"] = str(d / "fix")
    config["training"]["train_batch_size"] = 2
    split = split_dataset(str(d / "fix"), LINEAR_EID, seed=42)
    train_dl, val_dl, test_dl = make_loader(config, split)
    meta = get_metadata_from_loader(train_dl, config)
    config["model"]["encoder"]["input_dim"] = meta["input_dim"]
    config["model"]["decoder"]["output_dim"] = meta["output_dim"]
    jmodel = NAME2MODEL["Linear"].from_config(config.model)
    jt = BaseTrainer(jmodel, train_dl, val_dl, test_dl, config,
                     eid=LINEAR_EID, dataset_split_dict=split,
                     log_dir=str(d / "probe"), seed=42)
    batch = next(iter(train_dl))
    jt._init_if_needed(jt._assemble_inputs(batch))
    tmodel = LinearModel.from_config(config.model, device="cpu")
    init = save_init(tmodel, jt.params, d / "init_linear.pt")
    return d, init


@pytest.mark.parametrize("cache", ["cached", "streaming"])
def test_linear_trainer_two_ranks_match_jax(linear_fixture, tmp_path, cache):
    d, init = linear_fixture
    common = dict(DCN_FIXTURE_DIR=d / "fix", DCN_EID=LINEAR_EID,
                  DCN_DEVICE_CACHE="1" if cache == "cached" else "0")
    port, ref = run_both(
        _env(DCN_LOG_DIR=tmp_path / "torch", DCN_INIT=init, **common),
        _env(DCN_LOG_DIR=tmp_path / "jax", **common), f32="linear")
    assert port[0] == port[1], port
    assert port[0]["cached"] == ref[0]["cached"] == (cache == "cached")
    if cache == "cached":   # per-step H2D is the int32 index only
        assert port[0]["h2d_bytes"] == ref[0]["h2d_bytes"] > 0
    for k in ("best_eval_bps", "test_bps"):
        assert abs(port[0][k] - ref[0][k]) <= 1e-3, (k, port[0], ref[0])
    assert port[0]["test_loss"] == pytest.approx(ref[0]["test_loss"],
                                                 rel=1e-4)
    # rank 0 alone wrote the artifacts, once each
    run_dir = next((tmp_path / "torch").glob("dcnli/*/LinearModel"))
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "metrics.jsonl", "model_best.pt", "model_last.pt",
        "test_results.npy"]
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all("replica_checksum" in ln for ln in lines)


# ---------------------------------------------------------------------------
# MultiSessionTrainer
# ---------------------------------------------------------------------------

MS_EIDS = ("dcnms00000", "dcnms11111")


def test_multisession_two_ranks_match_jax(tmp_path):
    import jax

    from video_spike_tpu.core.config import DictConfig as JConfig
    from video_spike_tpu.models.vtt import VideoTemporalTransformer as JVTT
    from video_spike_tpu.parallel.mesh import make_mesh
    from video_spike_tpu.train.multisession import (
        MultiSessionTrainer as JTrainer)
    from video_spike_torch.data.synthetic import make_synthetic_session
    from video_spike_torch.models.vtt import VideoTemporalTransformer as TVTT

    fixture = tmp_path / "fix"
    for i, eid in enumerate(MS_EIDS):
        make_synthetic_session(fixture, eid=eid, n_trials=12,
                               n_neurons=4 + i, seed=77 + i,
                               height=32, width=32)
    model_cfg = {"n_sessions": 2, "max_neurons": 5, "t_frames": 120,
                 "t_bins": 100, "patch_size": 16, "hidden_size": 32,
                 "frame_depth": 1, "temporal_depth": 1,
                 "num_attention_heads": 2, "intermediate_size": 64,
                 "frame_stride": 4}
    jt = JTrainer(model=None, config=JConfig({
        "training": {"num_epochs": 2, "train_batch_size": 2,
                     "test_batch_size": 2},
        "optimizer": {"lr": 1e-3}}), eids=list(MS_EIDS),
        data_dir=str(fixture), log_dir=str(tmp_path / "probe"), seed=42,
        mesh=make_mesh(n_data=1))
    jt.model = JVTT.from_config(model_cfg)
    probe = next(iter(jt.val_loaders[MS_EIDS[0]]))
    jt._init_if_needed(np.asarray(probe["video"], np.uint8),
                       np.zeros(1, np.int32))
    init = save_init(TVTT.from_config(model_cfg, device="cpu"), jt.params,
                     tmp_path / "init_ms.pt")
    del jax
    common = dict(DCN_MODE="multisession", DCN_EID=",".join(MS_EIDS),
                  DCN_FIXTURE_DIR=fixture)
    port, ref = run_both(
        _env(DCN_LOG_DIR=tmp_path / "torch", DCN_INIT=init, **common),
        _env(DCN_LOG_DIR=tmp_path / "jax", **common))
    assert port[0] == port[1], port
    for k in ("best_eval_bps", "test_bps"):
        assert abs(port[0][k] - ref[0][k]) <= 1e-3, (k, port[0], ref[0])
    run_dir = tmp_path / "torch" / "multi_dcnms_dcnms"
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "metrics.jsonl", "model_best.pt", "model_last.pt",
        "test_results.npy"]


# ---------------------------------------------------------------------------
# ContrastTrainer
# ---------------------------------------------------------------------------

SSL_EID = "dcnssl0000"


@pytest.fixture(scope="module")
def ssl_fixture(tmp_path_factory):
    """A 144-frame h5 (12 trials x 12 frames) and the JAX init."""
    import h5py

    from video_spike_tpu.core.registry import NAME2MODEL as JREG
    from video_spike_tpu.data.contrast import make_contrast_loader
    from video_spike_tpu.train.contrast import ContrastTrainer as JTrainer
    from video_spike_torch.core.registry import NAME2MODEL as TREG
    from video_spike_torch.parallel.dcn_trainer_smoke import _SSL_CFG

    d = tmp_path_factory.mktemp("dist_ssl")
    path = d / "frames.h5"
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        grp = f.create_group(SSL_EID)
        t0 = 0.0
        for split, trials in {"train": 8, "val": 2, "test": 2}.items():
            X = rng.integers(0, 255, (trials, 12, 1, 16, 16), dtype=np.uint8)
            y = rng.poisson(1.0, (trials, 10, 5)).astype(np.float32)
            ts = (t0 + np.arange(trials * 12) / 60.0).reshape(trials, 12)
            t0 = ts[-1, -1] + 1.0
            grp.create_dataset(f"X_{split}", data=X)
            grp.create_dataset(f"y_{split}", data=y)
            grp.create_dataset(f"timestamp_{split}", data=ts)
    dl, _ = make_contrast_loader(str(path), mode="pretrain", batch_size=4,
                                 eid=SSL_EID, idx_offset=3, image_size=16,
                                 seed=0)
    jt = JTrainer(JREG["ContrastViT"].from_config(_SSL_CFG), dl,
                  {"lr": 1e-3}, max_steps=6, eid=SSL_EID,
                  log_dir=str(d / "probe"), image_size=16, seed=42)
    jt._init_if_needed(next(iter(dl))["ref"])
    init = save_init(TREG["ContrastViT"].from_config(_SSL_CFG, device="cpu"),
                     jt.params, d / "init_ssl.pt")
    return path, init


def test_ssl_two_ranks_match_jax(ssl_fixture, tmp_path):
    h5, init = ssl_fixture
    common = dict(DCN_MODE="ssl", DCN_EID=SSL_EID, DCN_H5=h5)
    port, ref = run_both(
        _env(DCN_LOG_DIR=tmp_path / "torch", DCN_INIT=init, **common),
        _env(DCN_LOG_DIR=tmp_path / "jax", **common), f32="ssl")
    assert port[0] == port[1], port
    assert abs(port[0]["best_bps"] - ref[0]["best_bps"]) <= 1e-3, (port, ref)
    assert port[0]["emb_rows"] == ref[0]["emb_rows"]
    assert port[0]["emb_sum"] == pytest.approx(ref[0]["emb_sum"], rel=1e-3)
    run_dir = tmp_path / "torch" / SSL_EID / "ContrastViT" / "6"
    assert {"best_model.pt", "last_model.pt",
            "metrics.jsonl"} <= {p.name for p in run_dir.iterdir()}


def test_ssl_mid_epoch_resume_two_ranks_is_bitwise(ssl_fixture, tmp_path):
    h5, _ = ssl_fixture
    outs = _wait(torch_ranks(
        "video_spike_torch.parallel.dcn_trainer_smoke",
        _env(DCN_MODE="ssl_resume", DCN_EID=SSL_EID, DCN_H5=h5,
             DCN_LOG_DIR=tmp_path)))
    res = results(outs)
    assert res[0] == res[1], res
    assert res[0]["resumed"] == res[0]["control"], res


def test_cli_train_two_ranks(linear_fixture, tmp_path):
    """``torchrun -m video_spike_torch.cli.train``: ``setup_runtime``
    joins the ranks, each reads its shard of the training trials, rank 0
    alone logs and writes."""
    d, _ = linear_fixture
    outs = _wait([_spawn(
        _LAUNCH + ["--nproc_per_node=2", "-m", "video_spike_torch.cli.train",
                   "--model_config", str(REPO / "configs/model/linear_me.yaml"),
                   "--train_config", str(REPO / "configs/train/linear_me.yaml"),
                   "--eid", LINEAR_EID, "--data_dir", str(d / "fix"),
                   "--num_epochs", "2", "--batch_size", "2",
                   "--log_dir", str(tmp_path), "--device", "cpu"], _env())])
    text = outs[0]
    # 12 train trials: 6 a rank, 3 steps an epoch at 2 rows
    assert "1 block x 6 rows; 3 steps/epoch" in text, text[-4000:]
    assert text.count("[train] {'epoch': 0") == 1, text[-4000:]
    run_dir = next(tmp_path.glob("dcnli/*/LinearModel"))
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "metrics.jsonl", "model_best.pt", "model_last.pt",
        "test_results.npy"]
    records = [json.loads(ln) for ln in
               (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [3, 6]
    assert all("replica_checksum" in r for r in records)


PRETRAIN_RANK = r"""
import json, os, pickle, sys
import numpy as np
import torch
from video_spike_torch.cli import pretrain
from video_spike_torch.core.runtime import exit_rank
from video_spike_torch.parallel import multihost as mh

torch.set_num_threads(1)
os.chdir(sys.argv[1])
writes, _save = [], np.save


def save(path, *args, **kwargs):
    writes.append(str(path))
    return _save(path, *args, **kwargs)


np.save = save
with open("data.pkl", "rb") as f:
    data = pickle.load(f)
res = pretrain.main(sys.argv[2:], data=data)
print(f"pid={mh.process_index()} result="
      f"{json.dumps({'writes': writes, 'path': res['path']})}", flush=True)
exit_rank()
"""
PRETRAIN_EID = "dcnpre000"


def test_pretrain_cli_two_ranks_rank0_alone_writes_embeddings(tmp_path):
    """``cli.pretrain`` on 2 gloo ranks writes
    ``data/data_rrr_<model>_<eid5>.npy`` from rank 0 alone, as the JAX CLI
    does (``video_spike_tpu/cli/pretrain.py:113``): every rank embeds, one
    writes. Before, both ranks wrote the same file (2 writes a launch)."""
    import pickle

    import yaml

    from video_spike_torch.cli import create_eid_data
    from video_spike_torch.data.synthetic import make_synthetic_session

    make_synthetic_session(tmp_path / "fx", eid=PRETRAIN_EID, n_trials=12,
                           n_neurons=6, seed=3, height=32, width=32)
    (tmp_path / "data").mkdir()
    (tmp_path / "data/eid.txt").write_text(f"{PRETRAIN_EID}\n")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        _, raw = create_eid_data.build([
            "--model_config", str(REPO / "configs/model/linear_me.yaml"),
            "--train_config", str(REPO / "configs/train/rrr.yaml"),
            "--input_mod", "whisker-video", "--data_dir",
            str(tmp_path / "fx")])
    finally:
        os.chdir(cwd)
    with open(tmp_path / "data.pkl", "wb") as f:
        pickle.dump(create_eid_data.split_dict(raw), f)
    tiny = dict(model_class="ViT_MAE", image_size=32, patch_size=8,
                num_channels=1, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=64,
                decoder_hidden_size=32, decoder_num_hidden_layers=1,
                decoder_num_attention_heads=4, decoder_intermediate_size=64,
                mask_ratio=0.75, norm_pix_loss=False, embed_size=3)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(tiny))
    outs = _wait(torch_code(PRETRAIN_RANK, _env(), args=(
        tmp_path, "--model_config", tmp_path / "tiny.yaml",
        "--train_config", REPO / "configs/train/vmae_video.yaml",
        "--eid", PRETRAIN_EID, "--model", "cm", "--max_steps", "2",
        "--batch_size", "4", "--log_dir", "logs", "--device", "cpu")))
    r0, r1 = results(outs)
    path = f"data/data_rrr_cm_{PRETRAIN_EID[:5]}.npy"
    assert (r0["writes"], r1["writes"]) == ([path], []), (r0, r1)
    saved = np.load(tmp_path / path, allow_pickle=True).item()
    assert saved[PRETRAIN_EID]["X"][0].shape[-1] == tiny["embed_size"]
