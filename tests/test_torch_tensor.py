"""The port's ``model`` axis against the JAX package: the production
sharding rules, the tensor-parallel layers, the tensor-sharded VTT step
(``DCN_MODE=tensor``), the trainers under {data: 2, model: 2} and the VTT
session split over the model axis.

Multi-rank cases run gloo ranks on the CPU under ``torch.distributed.run
--standalone`` (one process a rank, ``torch.set_num_threads(1)``); the JAX
side runs in this process on the conftest's virtual CPU devices, or as two
JAX processes of two CPU devices each, whose mesh {data: 2, model: 2} puts
a data row in each process: the JAX layout whose data rows hold the rows
the port's ranks of a data row share (files[d::2], 2 rows a device).
Every launch has its own timeout.

Tolerances: the rules' split leaves and dimensions equal; the column-split
layer's forward and gradients within 1e-6 of the unsplit layer's largest
value (float32), a split VTT's output and every gradient within 1e-5 of
its largest value; the ``tensor`` smoke's 3 losses rtol 1e-4 of JAX's step (float32)
and equal on every rank; the Linear trainer's eval and test bps within
1e-3 and ``test_loss`` rtol 1e-4 (float32), the multi-session trainer's
bps within 1e-3 (bf16), as ``tests/test_torch_dist_train.py``; the split
VTT session rtol 1e-5 (atol 1e-6) of the one-rank session (float32).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from test_torch_dist_train import (
    F32,
    LINEAR_EID,
    MS_EIDS,
    _env,
    _free_port,
    _spawn,
    _wait,
    linear_fixture,  # noqa: F401  (a fixture)
    results,
    save_init,
    torch_code,
    torch_ranks,
)
from video_spike_torch.parallel.mesh import Mesh, Placement

SMOKE = "video_spike_torch.parallel.dcn_trainer_smoke"

torch.set_num_threads(1)


def _port_mesh(n_model: int) -> Mesh:
    """A {data: 2, model: n_model} grid seen from rank 0, without groups
    (the rules read only the shape)."""
    return Mesh({"data": 2, "model": n_model}, {"data": 0, "model": 0},
                {"data": None, "model": None})


def _jax_mesh(n_model: int):
    from jax.sharding import Mesh as JMesh

    devices = np.array(jax.devices("cpu")[:2 * n_model])
    return JMesh(devices.reshape(2, n_model), ("data", "model"))


def _flax_names(tree) -> dict:
    """{flat port name: leaf} of a flax tree without its ``params`` level."""
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    return {".".join(str(k.key) for k in path): leaf for path, leaf in flat}


# ---------------------------------------------------------------------------
# (1) the production rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [128, 512])
@pytest.mark.parametrize("n_model", [2, 4])
def test_vtt_sharding_rules_match_jax(hidden, n_model):
    """The same leaves split on the same dims as
    ``__graft_entry__._vtt_sharding_rules`` on the flagship's tree (5
    sessions × 668 neurons at hidden 512, the smoke's 3 × 32 at 128)."""
    from video_spike_torch.models.vtt import vtt_sharding_rules
    from video_spike_torch.parallel.dcn_trainer_smoke import _flagship

    sessions, neurons = (5, 668) if hidden == 512 else (3, 32)
    t_frames = 120 if hidden == 512 else 12
    jmodel = graft._flagship(n_sessions=sessions, max_neurons=neurons,
                             t_frames=t_frames, hidden=hidden)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, t_frames, 1, 32, 32), jnp.uint8),
        jnp.zeros((1,), jnp.int32))
    jrules = _flax_names(graft._vtt_sharding_rules(shapes, _jax_mesh(n_model)))
    want = {}
    for k, sharding in jrules.items():
        spec = tuple(sharding.spec)
        want[k] = spec.index("model") if "model" in spec else None

    tmodel = _flagship(n_sessions=sessions, max_neurons=neurons,
                       t_frames=t_frames, hidden=hidden, device="meta")
    params = {k: p for k, p in tmodel.named_parameters()}
    rules = vtt_sharding_rules(params, _port_mesh(n_model))
    got = {k: (None if r.axis is None else r.split_dim(params[k].ndim))
           for k, r in rules.items()}
    assert got == want
    split = sorted(k for k, d in got.items() if d is not None)
    if hidden == 512:   # 4 kernels in each of 4 blocks, and the heads
        assert len(split) == 18 and neurons % n_model == 0
    else:               # qkv (128, 384) and Dense_0 (128, 256) only
        assert len(split) == 10
        assert not any(k.endswith(("proj.kernel", "Dense_1.kernel"))
                       for k in split)
    assert got["session_heads"] == 2 and got["session_bias"] == 1
    assert got["frame_encoder.Conv_0.kernel"] is None
    assert got["time_resample"] is None


def test_head_split_that_does_not_divide_raises_as_jax():
    """Heads of 7 neurons on a model axis of 2: ``jax.device_put`` refuses
    the placement, and so does ``put_tree``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from video_spike_torch.parallel.multihost import put_tree

    heads = np.zeros((3, 8, 7), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(heads, NamedSharding(_jax_mesh(2),
                                            P(None, None, "model")))
    with pytest.raises(ValueError, match="does not divide"):
        put_tree({"session_heads": torch.from_numpy(heads)},
                 {"session_heads": Placement(_port_mesh(2), "model", 3, 2)})


# ---------------------------------------------------------------------------
# (2) gather_last / copy_to_model, and a split VTT, on 2 ranks
# ---------------------------------------------------------------------------

TP_LAYERS = r"""
import json
import numpy as np
import torch
from video_spike_torch.core.runtime import setup_runtime
from video_spike_torch.models.vtt import (
    VideoTemporalTransformer, split_over_model, vtt_sharding_rules)
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.parallel.tensor import column_dense

assert setup_runtime("cpu")
torch.set_num_threads(1)
mesh = make_mesh(n_data=1, n_model=2)
group, r = mesh.group("model"), mesh.coords["model"]
rng = np.random.default_rng(0)
f32 = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
x, k, b, gy = f32(3, 5, 8), f32(8, 6), f32(6), f32(3, 5, 6)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def dense_grads(split):
    xi, bi = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ki = (k[:, 3 * r:3 * r + 3] if split else k).clone().requires_grad_(True)
    y = column_dense(xi, ki, bi, torch.float32, group if split else None)
    (y * gy).sum().backward()
    return y.detach(), xi.grad, ki.grad, bi.grad


y1, gx1, gk1, gb1 = dense_grads(False)
y2, gx2, gk2, gb2 = dense_grads(True)
out = {"dense": {"y": rel(y2, y1), "dx": rel(gx2, gx1),
                 "dk": rel(gk2, gk1[:, 3 * r:3 * r + 3]), "db": rel(gb2, gb1)}}

kw = dict(n_sessions=2, max_neurons=8, t_frames=4, t_bins=10, patch_size=16,
          hidden=128, frame_depth=1, temporal_depth=1, heads=2, mlp_dim=256,
          frame_stride=2, dtype=torch.float32)
video = torch.from_numpy(rng.integers(0, 255, (3, 4, 1, 32, 32),
                                      dtype=np.uint8))
sids = torch.tensor([0, 1, 1])
target = f32(3, 10, 8)


def vtt_grads(split):
    model = VideoTemporalTransformer(**kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    rules = vtt_sharding_rules(params, mesh)
    if split:
        params = mh.put_tree(params, rules)
        split_over_model(model, rules)
    leaves = {n: v.clone().requires_grad_(True) for n, v in params.items()}
    y = torch.func.functional_call(model, leaves, (video, sids))
    (y * target).sum().backward()
    grads = {n: v.grad for n, v in leaves.items()}
    if split:
        grads = mh.gather_tree(grads, rules)
    return y.detach(), grads, sorted(n for n, p in rules.items() if p.axis)


y1, g1, _ = vtt_grads(False)
y2, g2, names = vtt_grads(True)
out["vtt"] = {"y": rel(y2, y1), "split": names,
              "grads": max(rel(g2[n], g1[n]) for n in g1
                           if g1[n].abs().max() > 0)}
print(f"pid={r} result={json.dumps(out)}", flush=True)
"""


def test_column_split_layers_two_ranks():
    """A column-split Dense (``copy_to_model``, the block's product,
    ``gather_last``, the replicated bias) against the unsplit layer, and a
    VTT split by the rules (qkv, Dense_0, the heads) against the unsplit
    model: forward and every gradient, on both ranks."""
    res = results(_wait(torch_code(TP_LAYERS, _env())))
    for out in res:
        assert max(out["dense"].values()) <= 1e-6, out["dense"]
        assert out["vtt"]["y"] <= 1e-5 and out["vtt"]["grads"] <= 1e-5, out
        assert out["vtt"]["split"] == [
            "Block_0.Dense_0.kernel", "Block_0.SelfAttention_0.qkv.kernel",
            "frame_encoder.Block_0.Dense_0.kernel",
            "frame_encoder.Block_0.SelfAttention_0.qkv.kernel",
            "session_bias", "session_heads"]


# ---------------------------------------------------------------------------
# (3) DCN_MODE=tensor against JAX's step on a {data: 2, model: 2} mesh
# ---------------------------------------------------------------------------

def _jax_tensor_losses(jmodel, params, n_model: int) -> list:
    """``_dryrun_body``'s step on a {data: 2, model: n_model} mesh of this
    process's virtual devices, with ``_tensor_sharded``'s batch."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from video_spike_tpu.train.multisession import masked_poisson_nll

    mesh = _jax_mesh(n_model)
    rng = np.random.default_rng(7)
    batch = 4
    video = rng.integers(0, 255, (batch, 12, 1, 32, 32), dtype=np.uint8)
    ap = rng.poisson(1.0, (batch, 100, 32)).astype(np.float32)
    sids = rng.integers(0, 3, (batch,)).astype(np.int32)
    nmask = np.ones((batch, 32), np.float32)
    params = jax.device_put(params, graft._vtt_sharding_rules(params, mesh))
    tx = optax.adamw(optax.cosine_onecycle_schedule(100, 5e-5),
                     weight_decay=0.01)
    opt_state = tx.init(params)

    def train_step(params, opt_state, video, ap, sids, nmask, n_valid):
        def loss_fn(p):
            return masked_poisson_nll(jmodel.apply(p, video, sids), ap,
                                      nmask, n_valid)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    step = jax.jit(train_step)
    shard = lambda a: jax.device_put(a, NamedSharding(
        mesh, P("data", *([None] * (a.ndim - 1)))))
    args = [shard(a) for a in (video, ap, sids, nmask)]
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, *args,
                                       jnp.float32(batch))
        losses.append(float(loss))
    return losses


def test_tensor_smoke_four_ranks_matches_jax(tmp_path):
    from video_spike_torch.parallel.dcn_trainer_smoke import _flagship

    jmodel = graft._flagship(n_sessions=3, max_neurons=32, t_frames=12,
                             hidden=128).clone(dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 12, 1, 32, 32), jnp.uint8),
                          jnp.zeros((1,), jnp.int32))
    init = save_init(_flagship(n_sessions=3, max_neurons=32, t_frames=12,
                               hidden=128, device="cpu"), jparams,
                     tmp_path / "init.pt")
    prelude = ("import torch\n"
               "from video_spike_torch.parallel import dcn_trainer_smoke as S\n"
               "f = S._flagship\n"
               "S._flagship = lambda **kw: f(dtype=torch.float32, **kw)")
    procs = torch_ranks(SMOKE, _env(DCN_MODE="tensor", DCN_MODEL_AXIS=2,
                                    DCN_INIT=init, DCN_LOG_DIR=tmp_path),
                        world=4, prelude=prelude)
    want = _jax_tensor_losses(jmodel, jparams, 2)
    res = results(_wait(procs), world=4)
    assert all(r == res[0] for r in res), res
    out = res[0]
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert out["losses"][2] != out["losses"][0]
    assert out["head_split"] == {"shape": [3, 128, 16], "dim": 2}
    assert out["mlp_split"] == {"shape": [128, 128], "dim": 1}
    assert out["n_split"] == 10
    # the split blocks: one value per model index, shared by its data group
    sums = out["split_checksums"]
    assert sums[0] == sums[2] and sums[1] == sums[3] and sums[0] != sums[1]


# ---------------------------------------------------------------------------
# (4) the trainers on {data: 2, model: 2}
# ---------------------------------------------------------------------------

def _jax_mesh_prelude(module: str) -> str:
    """Every JAX trainer of `module` on a {data: 2, model: 2} mesh."""
    return ("from video_spike_tpu.parallel import mesh as M\n"
            f"import {module} as T\n"
            "T.make_mesh = lambda n_data=None, n_model=1, **kw: "
            "M.make_mesh(n_data=2, n_model=2, **kw)")


def _jax_pair(env, prelude: str):
    """Two JAX processes of two CPU devices each running the JAX smoke."""
    base = dict(env, JAX_COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
                JAX_NUM_PROCESSES="2",
                XLA_FLAGS="--xla_force_host_platform_device_count=2")
    code = (f"{prelude}\nfrom video_spike_tpu.parallel.dcn_trainer_smoke "
            f"import main\nmain()\n")
    return [_spawn([sys.executable, "-c", code], dict(base, JAX_PROCESS_ID=str(p)))
            for p in range(2)]


def _rank0_artifacts(run_dir):
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "metrics.jsonl", "model_best.pt", "model_last.pt",
        "test_results.npy"]
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all("replica_checksum" in ln for ln in lines)


def test_linear_trainer_model_axis_matches_jax(linear_fixture, tmp_path):
    """The Linear ``BaseTrainer`` on 4 ranks, {data: 2, model: 2}: the
    ranks of a data row read its shard and run its rows; the rank-local
    cache is refused (a block spans 2 ranks) and the epoch streams. JAX
    streams the same rows on its {data: 2, model: 2} mesh."""
    d, init = linear_fixture
    common = dict(DCN_FIXTURE_DIR=d / "fix", DCN_EID=LINEAR_EID)
    jax_pre, torch_pre = F32["linear"]
    jp = _jax_pair(_env(DCN_LOG_DIR=tmp_path / "jax", DCN_DEVICE_CACHE="0",
                        **common),
                   jax_pre + "\n"
                   + _jax_mesh_prelude("video_spike_tpu.train.base"))
    tp = torch_ranks(SMOKE, _env(DCN_LOG_DIR=tmp_path / "torch",
                                 DCN_INIT=init, DCN_MODEL_AXIS=2, **common),
                     world=4, prelude=torch_pre)
    outs = _wait(tp)
    port, ref = results(outs, world=4), results(_wait(jp))
    assert all(p == port[0] for p in port), port
    assert "blocks private: False" in outs[0], outs[0][-4000:]
    assert port[0]["cached"] is False and ref[0]["cached"] is False
    for k in ("best_eval_bps", "test_bps"):
        assert abs(port[0][k] - ref[0][k]) <= 1e-3, (k, port[0], ref[0])
    assert port[0]["test_loss"] == pytest.approx(ref[0]["test_loss"],
                                                 rel=1e-4)
    _rank0_artifacts(next((tmp_path / "torch").glob("dcnli/*/LinearModel")))


def test_multisession_trainer_model_axis_matches_jax(tmp_path):
    """The ``MultiSessionTrainer`` on 4 ranks, {data: 2, model: 2},
    against JAX's 2 processes on the same mesh, from the same init."""
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
    common = dict(DCN_MODE="multisession", DCN_EID=",".join(MS_EIDS),
                  DCN_FIXTURE_DIR=fixture)
    jp = _jax_pair(_env(DCN_LOG_DIR=tmp_path / "jax", **common),
                   _jax_mesh_prelude("video_spike_tpu.train.multisession"))
    tp = torch_ranks(SMOKE, _env(DCN_LOG_DIR=tmp_path / "torch",
                                 DCN_INIT=init, DCN_MODEL_AXIS=2, **common),
                     world=4)
    port, ref = results(_wait(tp), world=4), results(_wait(jp))
    assert all(p == port[0] for p in port), port
    for k in ("best_eval_bps", "test_bps"):
        assert abs(port[0][k] - ref[0][k]) <= 1e-3, (k, port[0], ref[0])
    _rank0_artifacts(tmp_path / "torch" / "multi_dcnms_dcnms")


# ---------------------------------------------------------------------------
# (5) the VTT session split over the model axis
# ---------------------------------------------------------------------------

VTT_KW = dict(n_sessions=3, max_neurons=8, t_frames=4, t_bins=10,
              patch_size=16, hidden=128, frame_depth=1, temporal_depth=1,
              heads=2, mlp_dim=256, frame_stride=2)

SPLIT_SESSION = r"""
import json, sys
import numpy as np
import torch
from video_spike_torch.core.runtime import setup_runtime
from video_spike_torch.models.vtt import (
    VideoTemporalTransformer, vtt_sharding_rules)
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.serve.session import InferenceSession

assert setup_runtime("cpu")
torch.set_num_threads(1)
inp = torch.load(sys.argv[1], weights_only=False)
session = InferenceSession(
    VideoTemporalTransformer(**inp["kw"], dtype=torch.float32),
    inp["params"], bucket_sizes=(2, 4), needs_session_ids=True,
    device="cpu", mesh=make_mesh(n_data=1, n_model=2),
    sharding_rules=vtt_sharding_rules)
outs = {str(n): session.predict(inp["video"][:n], inp["sids"][:n]).tolist()
        for n in (3, 4)}
shapes = {k: list(v.shape) for k, v in session.params.items()
          if k in ("session_heads", "Block_0.Dense_0.kernel")}
print(f"pid={mh.process_index()} result="
      f"{json.dumps({'outs': outs, 'shapes': shapes})}", flush=True)
"""


def test_vtt_session_split_two_ranks_matches_one_rank(tmp_path):
    from video_spike_torch.models.vtt import VideoTemporalTransformer
    from video_spike_torch.serve.session import InferenceSession

    model = VideoTemporalTransformer(**VTT_KW, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(3))
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(5)
    video = rng.integers(0, 255, (4, 4, 1, 32, 32), dtype=np.uint8)
    sids = np.asarray([2, 0, 1, 1], np.int64)
    torch.save({"kw": VTT_KW, "params": params, "video": video,
                "sids": sids}, tmp_path / "inp.pt")
    procs = torch_code(SPLIT_SESSION, _env(), args=[tmp_path / "inp.pt"])
    one = InferenceSession(
        VideoTemporalTransformer(**VTT_KW, dtype=torch.float32), params,
        bucket_sizes=(2, 4), needs_session_ids=True, device="cpu")
    want = {n: one.predict(video[:n], sids[:n]) for n in (3, 4)}
    res = results(_wait(procs))
    assert res[0] == res[1]
    assert res[0]["shapes"] == {"session_heads": [3, 128, 4],
                                "Block_0.Dense_0.kernel": [128, 128]}
    for n, ref in want.items():
        np.testing.assert_allclose(np.asarray(res[0]["outs"][str(n)]), ref,
                                   rtol=1e-5, atol=1e-6)
