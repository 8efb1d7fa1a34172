"""The port's ``parallel/`` package, ``core/runtime``, the data-parallel
fused readout step, the rank-strided sampler and the model-sharded serving
session against the JAX package.

Multi-rank cases run two gloo ranks on the CPU under
``torch.distributed.run --standalone`` (a ``-c`` program per case, inputs
and outputs through files); the JAX side runs in this process on a
2-device slice of the virtual CPU mesh, or as two JAX processes for
``dcn_smoke``. Every launch has its own timeout.

Tolerances: mesh shapes, ``pad_batch_to_multiple``, the helpers' values and
the sampler's draws equal; the explicit DP step's loss and params after 2
steps rtol 1e-5; the fused Linear step's losses rtol 1e-4, the bf16 kernel
>= 99.9% bitwise and the rest within 1 bf16 ulp (plus the optimizer's
2^-20 of the leaf's scale for the other bf16 leaves, as the one-process
test), W bitwise equal on both ranks; ``dcn_smoke``'s global loss rtol
1e-6; the model-sharded session rtol 1e-5 (atol 1e-6).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_dist_train import (
    _env,
    _wait,
    jax_processes,
    results,
    torch_code,
    torch_ranks,
)
from video_spike_tpu.models.linear import LinearModel as JLinear
from video_spike_tpu.ops.poisson import poisson_nll_mean as j_nll_mean
from video_spike_torch.convert import flax_to_torch, load_into_model, to_numpy
from video_spike_torch.models.linear import LinearModel as TLinear

WIDTHS = dict(encoder_hidden=(64, 32), encoder_out=16,
              decoder_hidden=(32,), output_dim=100 * 4)


def _jax_mesh(n_data, n_model):
    from video_spike_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])


def _port_params(jparams, in_dim, **kw):
    tm = TLinear(input_dim=in_dim, **WIDTHS, compute_dtype=torch.float32)
    load_into_model(tm, flax_to_torch(jax.device_get(jparams)))
    return {k: p.detach().clone() for k, p in tm.named_parameters()}


# ---------------------------------------------------------------------------
# one process: shapes, padding, no-op helpers, runtime
# ---------------------------------------------------------------------------

def test_one_process_mesh_and_helpers_are_noops(monkeypatch):
    from video_spike_torch.core.runtime import setup_runtime
    from video_spike_torch.parallel import multihost as mh
    from video_spike_torch.parallel.mesh import make_mesh

    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert setup_runtime("cpu") is False
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("data") is None and mesh.group("model") is None
    assert not mh.is_multihost() and mh.process_count() == 1
    files = [f"f{i}" for i in range(5)]
    assert mh.shard_files_for_process(files) == files
    assert mh.global_any(True) and not mh.global_any(False)
    assert mh.global_min(7) == 7
    t = torch.arange(6.0).reshape(3, 2)
    assert mh.gather_rows(t) is t
    grads = {"a": torch.ones(2)}
    assert mh.sum_grads_and_loss(grads, torch.tensor(2.0)) == (
        grads, torch.tensor(2.0))
    assert len(mh.replica_checksums({"a": t})) == 1
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(n_data=2)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 1), (4, 2), (2, 4)])
def test_mesh_grid_matches_jax(n_data, n_model, monkeypatch):
    """The port's rank grid places rank r where the JAX mesh places device
    r: row-major over (data, model)."""
    import video_spike_torch.parallel.mesh as tmesh

    jm = _jax_mesh(n_data, n_model)
    for rank in range(n_data * n_model):
        monkeypatch.setattr(tmesh, "_world",
                            lambda r=rank: (r, n_data * n_model))
        monkeypatch.setattr(tmesh, "_axis_group", lambda *a: None)
        m = tmesh.make_mesh(n_data=n_data, n_model=n_model)
        assert m.shape == dict(jm.shape)
        d, j = np.argwhere(np.vectorize(lambda x: x.id)(jm.devices) == rank)[0]
        assert m.coords == {"data": d, "model": j}


@pytest.mark.parametrize("rows,multiple", [(5, 8), (8, 8), (3, 2), (7, 4)])
def test_pad_batch_to_multiple_matches_jax(rows, multiple):
    from video_spike_torch.parallel import pad_batch_to_multiple as tpad
    from video_spike_tpu.parallel.mesh import pad_batch_to_multiple as jpad

    rng = np.random.default_rng(rows)
    batch = {"x": rng.normal(size=(rows, 3)), "y": np.arange(rows),
             "eid": ["a"] * rows}
    got, n_t = tpad(batch, multiple)
    ref, n_j = jpad(batch, multiple)
    assert n_t == n_j == rows
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["eid"] == ref["eid"]
    got, _ = tpad(batch, multiple, array_keys=["x"])
    ref, _ = jpad(batch, multiple, array_keys=["x"])
    np.testing.assert_array_equal(got["y"], ref["y"])
    np.testing.assert_array_equal(got["x"], ref["x"])


@pytest.mark.parametrize("min_dim", [64, 1 << 18])
def test_first_layer_sharding_rules_match_jax(min_dim):
    from video_spike_tpu.models.linear import (
        first_layer_sharding_rules as jrules)
    from video_spike_torch.models.linear import (
        first_layer_sharding_rules as trules)
    from video_spike_torch.parallel.mesh import make_mesh

    jm = JLinear(**WIDTHS)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 300)))
    ref = flax_to_torch(jax.tree.map(
        lambda s: np.asarray(s.spec == jax.sharding.PartitionSpec(
            "model", None)), jrules(jp, _jax_mesh(1, 2), min_dim=min_dim)))
    got = trules(_port_params(jp, 300), make_mesh(), min_dim=min_dim)
    assert set(got) == set(ref)
    assert {k for k, r in got.items() if r.axis == "model"} == {
        k for k, v in ref.items() if bool(v)}
    assert any(bool(v) for v in ref.values()) == (min_dim == 64)


# ---------------------------------------------------------------------------
# the rank-strided sampler
# ---------------------------------------------------------------------------

def test_rank_strided_sampler_draws_equal_jax(tmp_path):
    """Per rank of world 2, three epochs of index batches (pos/neg draws
    included) and a mid-epoch skip equal the JAX dataset's, and the
    sampler state round trip restores the epoch counter."""
    from video_spike_torch.data.contrast import ContrastDataset as TDS
    from video_spike_tpu.data.contrast import ContrastDataset as JDS

    rng = np.random.default_rng(5)
    data = {}
    for split, trials in {"train": 6, "val": 2, "test": 2}.items():
        data[f"{split}_X"] = rng.integers(0, 255, (trials, 9, 1, 8, 8),
                                          dtype=np.uint8)
        data[f"{split}_y"] = rng.poisson(1.0, (trials, 10, 3)).astype(
            np.float32)
        data[f"{split}_timestamp"] = rng.random((trials, 9))
    for rank in (0, 1):
        kw = dict(mode="pretrain", image_size=8, idx_offset=3, seed=11)
        tds, jds = TDS(data, **kw), JDS(data, **kw)
        for epoch in range(3):
            skip = 2 if epoch == 1 else 0
            got = list(tds.iter_index_batches(7, rank=rank, world=2,
                                              skip=skip))
            ref = list(jds.iter_index_batches(7, rank=rank, world=2,
                                              skip=skip))
            assert len(got) == len(ref) > 0
            for g, r in zip(got, ref):
                for k in ("ref", "pos", "neg"):
                    np.testing.assert_array_equal(g[k], r[k])
        state = tds.sampler_state()
        assert state["epoch"] == jds.sampler_state()["epoch"] == 3
        fresh = TDS(data, **kw)
        fresh.set_sampler_state(state, restore_rng=False)
        assert fresh._epoch == 3


# ---------------------------------------------------------------------------
# two ranks: helpers, the explicit DP step, the fused step, serving
# ---------------------------------------------------------------------------

HELPERS = r"""
import json
import numpy as np
import torch
import torch.distributed as dist
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import Placement, make_mesh, replicated

assert setup_runtime("cpu")
torch.set_num_threads(1)
r = mh.process_index()
W = dist.group.WORLD
out = {"world": mh.process_count()}
out["files"] = mh.shard_files_for_process([f"f{i}" for i in range(5)])
out["any"] = [mh.global_any(r == 1), mh.global_any(False)]
out["min"] = mh.global_min(10 + 3 * r)
out["gather"] = mh.gather_rows(torch.full((2, 2), float(r)), W).tolist()
g, loss = mh.sum_grads_and_loss(
    {"a": torch.full((2,), r + 1.0),
     "b": torch.ones(3, dtype=torch.bfloat16)}, torch.tensor(r + 0.5), W)
out["sum"] = [g["a"].tolist(), g["b"].float().tolist(), float(loss)]
m12, m21 = make_mesh(n_data=1, n_model=2), make_mesh()
out["m12"] = [m12.shape, m12.coords, m12.group("data") is None,
              m12.group("model") is W]
out["m21"] = [m21.shape, m21.coords]
out["rows"] = mh.replicated_rows_to_global(m21, np.arange(4))[0].tolist()
out["local"] = [t.tolist() for t in mh.local_rows_to_global(
    np.full((1, 2), r))]
t = torch.full((3,), float(r))
mh.replicate_tree({"t": [t]})
out["bcast"] = t.tolist()
put = mh.put_tree({"w": torch.arange(8.0).reshape(4, 2) + r,
                   "b": torch.full((2,), float(r))},
                  {"w": Placement(m12, "model"), "b": replicated(m12)})
out["put"] = [put["w"].tolist(), put["b"].tolist()]
out["same"] = mh.check_replicas({"x": torch.ones(5)}, W)
try:
    mh.check_replicas({"x": torch.full((5,), float(r))}, W)
    out["drift"] = False
except RuntimeError:
    out["drift"] = True
take = mh.make_block_local_take()
x, a = take(torch.arange(6.0).reshape(3, 2), torch.arange(3.0),
            torch.tensor([2, 0], dtype=torch.int32))
out["take"] = [x.tolist(), a.tolist()]
out["blocks"] = list(mh.data_axis_blocks(m21))
from video_spike_torch.core.logging import logging as make_logger
log = make_logger(header="[t]")
log.info(f"info-from-rank-{r}")
log.error(f"error-from-rank-{r}")
mh.barrier()
print(f"pid={r} result={json.dumps(out)}", flush=True)
exit_rank()
"""


def test_two_rank_helpers():
    outs = _wait(torch_code(HELPERS, _env()))
    res = results(outs)
    # rank 0 alone logs; errors log on every rank
    text = "\n".join(outs)
    assert "info-from-rank-0" in text and "info-from-rank-1" not in text
    assert "error-from-rank-0" in text and "error-from-rank-1" in text
    for r, out in enumerate(res):
        assert out["world"] == 2
        assert out["files"] == [f"f{i}" for i in range(r, 5, 2)]
        assert out["any"] == [True, False]
        assert out["min"] == 10
        assert out["gather"] == [[0.0, 0.0]] * 2 + [[1.0, 1.0]] * 2
        assert out["sum"] == [[3.0, 3.0], [2.0, 2.0, 2.0], 2.0]
        assert out["m12"] == [{"data": 1, "model": 2},
                              {"data": 0, "model": r}, True, True]
        assert out["m21"] == [{"data": 2, "model": 1},
                              {"data": r, "model": 0}]
        assert out["rows"] == [2 * r, 2 * r + 1]
        assert out["local"] == [[[r, r]]]
        assert out["bcast"] == [0.0] * 3          # rank 0's value
        w = (np.arange(8.0).reshape(4, 2) + r)[2 * r:2 * r + 2]
        assert out["put"] == [w.tolist(), [0.0, 0.0]]
        assert out["drift"] is True
        assert out["take"] == [[[4.0, 5.0], [0.0, 1.0]], [2.0, 0.0]]
        assert out["blocks"] == [[r], 1, True]
    assert res[0]["same"] == res[1]["same"]


DP_STEP = r"""
import sys
import torch
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import LinearModel
from video_spike_torch.ops.optim import AdamW
from video_spike_torch.ops.poisson import poisson_nll_mean
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.parallel.shard_map_step import (
    make_shard_map_train_step)

assert setup_runtime("cpu")
torch.set_num_threads(1)
inp = torch.load(sys.argv[1], weights_only=False)
r, b = mh.process_index(), inp["x"].shape[0] // 2
model = LinearModel(**inp["widths"], compute_dtype=torch.float32)
step = make_shard_map_train_step(
    lambda p, x: torch.func.functional_call(model, p, (x,)),
    lambda o, a: poisson_nll_mean(o, a),
    AdamW(1e-3, weight_decay=0.01, eps=1e-8), make_mesh())
params = inp["params"]
opt = AdamW(1e-3, weight_decay=0.01, eps=1e-8).init(params)
losses = []
for _ in range(2):
    params, opt, loss = step(params, opt, inp["x"][r * b:(r + 1) * b],
                             inp["ap"][r * b:(r + 1) * b])
    losses.append(float(loss))
torch.save({"params": params, "losses": losses}, f"{sys.argv[2]}{r}.pt")
exit_rank()
"""


def test_dp_step_two_ranks_matches_jax_shard_map(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from video_spike_tpu.parallel.shard_map_step import (
        make_shard_map_train_step)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 40)).astype(np.float32)
    ap = rng.poisson(1.0, (8, 100, 4)).astype(np.float32)
    jm = JLinear(**WIDTHS, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    torch.save({"params": _port_params(jp, 40), "x": torch.from_numpy(x),
                "ap": torch.from_numpy(ap),
                "widths": dict(input_dim=40, **WIDTHS)}, tmp_path / "in.pt")
    procs = torch_code(DP_STEP, _env(),
                       args=(tmp_path / "in.pt", tmp_path / "out"))
    # the JAX reference meanwhile: shard_map over a 2-device slice
    mesh = _jax_mesh(2, 1)
    tx = optax.adamw(1e-3, weight_decay=0.01, eps=1e-8)
    step = make_shard_map_train_step(
        jm.apply, lambda o, a: j_nll_mean(o, a), tx, mesh)
    shd = NamedSharding(mesh, P("data"))
    p_j = jax.device_put(jp, NamedSharding(mesh, P()))
    o_j = jax.device_put(tx.init(jp), NamedSharding(mesh, P()))
    losses_j = []
    for _ in range(2):
        p_j, o_j, loss = step(p_j, o_j, jax.device_put(x, shd),
                              jax.device_put(ap, shd))
        losses_j.append(float(loss))
    ref = flax_to_torch(jax.device_get(p_j))
    _wait(procs)
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses_j, rtol=1e-5)
        for k, v in out["params"].items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for k in out["params"]:
            assert torch.equal(out["params"][k], outs[0]["params"][k]), k


FUSED_STEP = r"""
import sys
import torch
import torch.distributed as dist
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import LinearModel
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops import optim
from video_spike_torch.ops.poisson import poisson_nll_mean
from video_spike_torch.parallel import multihost as mh

assert setup_runtime("cpu")
torch.set_num_threads(1)
inp = torch.load(sys.argv[1], weights_only=False)
r = mh.process_index()
b = inp["xs"][0].shape[0] // 2
model = LinearModel(**inp["widths"], compute_dtype=torch.float32)
sched = optim.cosine_onecycle_schedule(16, inp["lr"], 0.15, 10, 1e4)
tx = optim.Adafactor(sched)
step = fr.make_fused_linear_step(model, tx, sched, poisson_nll_mean,
                                 optim.apply_updates_sr,
                                 group=dist.group.WORLD)
params = inp["params"]
opt = fr.init_fused_opt_state(params, tx)
losses = []
for i, (x, ap) in enumerate(zip(inp["xs"], inp["aps"])):
    params, opt, loss = step(params, opt, x[r * b:(r + 1) * b],
                             ap[r * b:(r + 1) * b], 2 * b, i)
    losses.append(float(loss))
torch.save({"params": params, "losses": losses,
            "launches": fr.apply_scaled_outer.launches},
           f"{sys.argv[2]}{r}.pt")
exit_rank()
"""


def _within_ulp(a, b, rel_scale):
    """|a - b| <= 1 bf16 ulp at max(|a|, |b|) + rel_scale * max|b|."""
    a32, b32 = np.asarray(a, np.float32), np.asarray(b, np.float32)
    big = np.maximum(np.abs(a32), np.abs(b32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-38))) - 7)
    return np.abs(a32 - b32) <= ulp + rel_scale * np.abs(b32).max()


def test_fused_linear_step_two_ranks_matches_jax_mesh(tmp_path):
    """Each rank gathers the rank-B factors of its 4 rows and runs the
    fused update on the 8 global rows; the JAX fused step runs on the same
    8 rows sharded over a 2-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from video_spike_tpu.ops import fused_readout as jfr
    from video_spike_tpu.ops.optim import apply_updates_sr as j_apply_sr

    lr, b, in_dim = 5e-5, 8, 5 * 16 * 16
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 255, (b, in_dim), dtype=np.uint8)
          for _ in range(3)]
    aps = [rng.poisson(1.0, (b, 100, 4)).astype(np.float32)
           for _ in range(3)]
    jm = JLinear(**WIDTHS, compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jnp.float32))
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                          if p.size >= 1 << 16 else p, params)
    tm = TLinear(input_dim=in_dim, **WIDTHS, compute_dtype=torch.float32)
    load_into_model(tm, flax_to_torch(jax.device_get(params)))
    torch.save({"params": {k: v.detach().clone()
                           for k, v in tm.named_parameters()},
                "xs": [torch.from_numpy(x) for x in xs],
                "aps": [torch.from_numpy(a) for a in aps], "lr": lr,
                "widths": dict(input_dim=in_dim, **WIDTHS)},
               tmp_path / "in.pt")
    procs = torch_code(FUSED_STEP, _env(),
                       args=(tmp_path / "in.pt", tmp_path / "out"))

    mesh = _jax_mesh(2, 1)
    shd, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    sched = optax.cosine_onecycle_schedule(16, lr, 0.15, 10, 1e4)
    tx = optax.adafactor(sched, multiply_by_parameter_scale=False,
                         clipping_threshold=None)
    step = jax.jit(jfr.make_fused_linear_step(
        jm, tx, sched, lambda o, a, nv: j_nll_mean(o, a, nv), j_apply_sr))
    p_j = jax.device_put(params, repl)
    o_j = jax.device_put(jfr.init_fused_opt_state(params, tx), repl)
    losses_j = []
    for i in range(3):
        p_j, o_j, loss = step(p_j, o_j, jax.device_put(xs[i], shd),
                              jax.device_put(aps[i], shd), jnp.float32(b),
                              jnp.uint32(i))
        losses_j.append(float(loss))
    ref = flax_to_torch(jax.device_get(p_j))
    _wait(procs)
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    kern = "encoder.Dense_0.kernel"
    for out in outs:
        assert out["launches"] == 0      # the CPU runs the plain version
        np.testing.assert_allclose(out["losses"], losses_j, rtol=1e-4)
        for k, got in out["params"].items():
            g, r = to_numpy(got), to_numpy(ref[k])
            if got.dtype == torch.bfloat16:
                if k == kern:
                    assert (g.view(np.uint16) == r.view(np.uint16)).mean() \
                        >= 0.999, k
                assert _within_ulp(g, r, 0.0 if k == kern
                                   else 2.0 ** -20).all(), k
            else:
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-2 * lr,
                                           err_msg=k)
    # the replicas of W (and of every leaf) are bitwise equal
    for k in outs[0]["params"]:
        assert torch.equal(outs[0]["params"][k].view(torch.uint8)
                           if outs[0]["params"][k].dtype == torch.bfloat16
                           else outs[0]["params"][k],
                           outs[1]["params"][k].view(torch.uint8)
                           if outs[1]["params"][k].dtype == torch.bfloat16
                           else outs[1]["params"][k]), k


SERVE = r"""
import functools
import sys
import numpy as np
import torch
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import (
    LinearModel, first_layer_sharding_rules)
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.serve.session import InferenceSession

assert setup_runtime("cpu")
torch.set_num_threads(1)
inp = torch.load(sys.argv[1], weights_only=False)
mesh = make_mesh(n_data=1, n_model=2)
session = InferenceSession(
    LinearModel(**inp["widths"], compute_dtype=torch.float32),
    inp["params"], bucket_sizes=(1, 4, 8), device="cpu", mesh=mesh,
    sharding_rules=functools.partial(first_layer_sharding_rules, min_dim=100))
outs = [session.predict(x) for x in inp["xs"]]
torch.save({"outs": outs, "rows": session.params[
    "encoder.Dense_0.kernel"].shape[0], "stats": session.stats},
    f"{sys.argv[2]}{mh.process_index()}.pt")
exit_rank()
"""


def test_model_sharded_session_two_ranks_matches_jax(tmp_path):
    """{data: 1, model: 2}: each rank holds half the first kernel's rows;
    requests of 3 and 8 rows (the first padded to its bucket)."""
    from video_spike_tpu.models.linear import (
        first_layer_sharding_rules as jrules)
    from video_spike_tpu.serve.session import InferenceSession as JSession

    rng = np.random.default_rng(4)
    in_dim = 300
    xs = [rng.normal(size=(n, in_dim)).astype(np.float32) for n in (3, 8)]
    jm = JLinear(**WIDTHS, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(xs[1]))
    torch.save({"params": _port_params(jp, in_dim), "xs": xs,
                "widths": dict(input_dim=in_dim, **WIDTHS)},
               tmp_path / "in.pt")
    procs = torch_code(SERVE, _env(),
                       args=(tmp_path / "in.pt", tmp_path / "out"))
    js = JSession(jm, jp, bucket_sizes=(1, 4, 8), mesh=_jax_mesh(1, 2),
                  sharding_rules=lambda p, m: jrules(p, m, min_dim=100))
    refs = [js.predict(x) for x in xs]
    _wait(procs)
    for r in range(2):
        out = torch.load(tmp_path / f"out{r}.pt", weights_only=False)
        assert out["rows"] == in_dim // 2
        assert out["stats"]["padded_rows"] == 1
        for got, ref in zip(out["outs"], refs):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# every split the JAX session serves, on {data: 1, model: 2}: one launch
# serves every case; each rank saves its outputs, shard shapes, gathered
# leaves and the bytes its collectives moved
SPLIT_SERVE = r"""
import functools
import sys
import torch
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import (
    LinearModel, first_layer_sharding_rules)
from video_spike_torch.models.vtt import (
    VideoTemporalTransformer, vtt_sharding_rules)
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel import tensor
from video_spike_torch.parallel.mesh import Placement, make_mesh
from video_spike_torch.serve.session import InferenceSession

assert setup_runtime("cpu")
torch.set_num_threads(1)
inp = torch.load(sys.argv[1], weights_only=False)
mesh = make_mesh(n_data=1, n_model=2)


def vtt_ln(params, m):
    rules = vtt_sharding_rules(params, m)
    rules.update({k: Placement(m, "model") for k in params
                  if k.endswith(".scale")})
    return rules


def rules(name):
    if name.startswith("first"):
        return functools.partial(first_layer_sharding_rules,
                                 min_dim=int(name[5:]))
    return vtt_sharding_rules if name == "vtt" else vtt_ln


out = {}
for name, case in inp.items():
    vtt = "video" in case
    model = (VideoTemporalTransformer(**case["kw"], dtype=torch.float32)
             if vtt else LinearModel(**case["kw"],
                                     compute_dtype=torch.float32))
    session = InferenceSession(
        model, case["params"], bucket_sizes=(1, 4, 8), device="cpu",
        needs_session_ids=vtt, mesh=mesh, sharding_rules=rules(case["rules"]))
    tensor.sum_over_model.bytes = tensor.gather_last.bytes = 0
    outs = [session.predict(case["video"][:n], case["sids"][:n])
            for n in (3, 4)] if vtt else [session.predict(x)
                                          for x in case["xs"]]
    out[name] = {"outs": outs, "gathered": session.stats["gathered_leaves"],
                 "shapes": {k: list(v.shape)
                            for k, v in session.params.items()},
                 "bytes": [tensor.sum_over_model.bytes,
                           tensor.gather_last.bytes]}
torch.save(out, f"{sys.argv[2]}{mh.process_index()}.pt")
exit_rank()
"""

VTT_KW = dict(n_sessions=3, max_neurons=8, t_frames=4, t_bins=10,
              patch_size=16, hidden=128, frame_depth=1, temporal_depth=1,
              heads=2, mlp_dim=256, frame_stride=2)
SPLIT_CASES = ("linear_first64", "linear_vtt", "vtt_first128", "vtt_ln")


def _jax_split_rules(name):
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as graft
    from video_spike_tpu.models.linear import first_layer_sharding_rules

    if name.startswith("first"):
        return lambda p, m: first_layer_sharding_rules(
            p, m, min_dim=int(name[5:]))
    if name == "vtt":
        return graft._vtt_sharding_rules

    def vtt_ln(p, m):
        ln = jax.tree_util.tree_map_with_path(
            lambda path, leaf: str(path[-1].key) == "scale", p)
        return jax.tree.map(
            lambda r, is_ln: NamedSharding(m, P("model")) if is_ln else r,
            graft._vtt_sharding_rules(p, m), ln)
    return vtt_ln


@pytest.fixture(scope="module")
def split_served(tmp_path_factory):
    """Every case's inputs, the JAX model and params, and what both ranks
    served (one launch)."""
    from video_spike_tpu.models.vtt import VideoTemporalTransformer as JVTT

    tmp = tmp_path_factory.mktemp("split_serve")
    rng = np.random.default_rng(8)
    in_dim = 300
    xs = [rng.normal(size=(n, in_dim)).astype(np.float32) for n in (3, 8)]
    jl = JLinear(**WIDTHS, compute_dtype=jnp.float32)
    jlp = jl.init(jax.random.PRNGKey(2), jnp.asarray(xs[1]))
    video = rng.integers(0, 255, (4, 4, 1, 32, 32), dtype=np.uint8)
    sids = np.asarray([2, 0, 1, 1], np.int32)
    jv = JVTT(**VTT_KW, dtype=jnp.float32)
    jvp = jv.init(jax.random.PRNGKey(3), jnp.asarray(video),
                  jnp.asarray(sids))
    cases, inp = {}, {}
    for name in SPLIT_CASES:
        model, rules = name.split("_")
        if model == "linear":
            cases[name] = (jl, jlp, rules)
            inp[name] = {"kw": dict(input_dim=in_dim, **WIDTHS), "xs": xs,
                         "params": _port_params(jlp, in_dim),
                         "rules": rules}
        else:
            cases[name] = (jv, jvp, rules)
            inp[name] = {"kw": VTT_KW, "video": video, "sids": sids,
                         "rules": rules,
                         "params": flax_to_torch(jax.device_get(jvp))}
    torch.save(inp, tmp / "in.pt")
    procs = torch_code(SPLIT_SERVE, _env(),
                       args=(tmp / "in.pt", tmp / "out"))
    _wait(procs)
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(2)]
    return cases, inp, ranks


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_session_two_ranks_matches_jax(split_served, name):
    """The Queue C 3 input (the Linear, 300 inputs) under
    ``first_layer_sharding_rules(min_dim=64)`` (two kernels split by rows)
    and under the production VTT rules (the head split by columns); a
    small VTT under ``first_layer_sharding_rules(min_dim=hidden)`` (every
    128-input kernel split by rows); the VTT rules plus every LayerNorm
    scale split, which the session gathers whole and lists. Both ranks
    serve the same numbers, within rtol 1e-5 of the JAX session under the
    same rules on {data: 1, model: 2}."""
    from video_spike_tpu.serve.session import InferenceSession as JSession

    from video_spike_torch.models.vtt import HEAD_LEAVES

    cases, inp, ranks = split_served
    jm, jp, rules = cases[name]
    vtt = "video" in inp[name]
    js = JSession(jm, jp, bucket_sizes=(1, 4, 8), needs_session_ids=vtt,
                  mesh=_jax_mesh(1, 2), sharding_rules=_jax_split_rules(rules))
    if vtt:
        case = inp[name]
        refs = [js.predict(case["video"][:n], case["sids"][:n])
                for n in (3, 4)]
    else:
        refs = [js.predict(x) for x in inp[name]["xs"]]
    full = {k: list(v.shape) for k, v in inp[name]["params"].items()}
    got = [r[name] for r in ranks]
    split = {k for k, v in got[0]["shapes"].items() if v != full[k]}
    want_split = {
        "linear_first64": {"encoder.Dense_0.kernel",
                           "encoder.Dense_1.kernel"},
        "linear_vtt": {"decoder.Dense_1.kernel"},
        "vtt_first128": {k for k, v in full.items() if k.endswith("kernel")
                         and len(v) == 2 and v[0] >= 128},
        "vtt_ln": {k for k, v in full.items()
                   if (k.endswith("kernel") and len(v) == 2
                       and v[1] >= 256) or k in HEAD_LEAVES}}[name]
    assert split == want_split
    for k in split:
        rows = rules.startswith("first") and k.endswith("kernel")
        dim = 0 if rows else len(full[k]) - 1
        assert got[0]["shapes"][k][dim] * 2 == full[k][dim], k
    gathered = sorted(k for k in full if k.endswith(".scale")) \
        if name == "vtt_ln" else []
    assert all(sorted(g["gathered"]) == gathered for g in got)
    assert got[0]["bytes"][0] > 0 if rules.startswith("first") else \
        got[0]["bytes"][1] > 0
    for a, b, ref in zip(got[0]["outs"], got[1]["outs"], refs):
        np.testing.assert_array_equal(a, b)
        assert a.shape == ref.shape
        np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [40, (1 << 16) + 3])
def test_row_dense_at_world_one_matches_dense(dtype, rows):
    """``row_dense`` with no group (the whole kernel as the one block)
    against the whole-kernel Dense: float32 rtol 1e-5 (atol 1e-6, the
    f32 sums in ``ROW_CHUNK`` pieces); bfloat16 within 1 bf16 ulp of the
    output's scale (both round an f32 sum once)."""
    from video_spike_torch.models.linear import Dense, layer_dense
    from video_spike_torch.parallel.tensor import row_dense

    rng = np.random.default_rng(rows)
    layer = Dense(rows, 6)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(rng.normal(size=(3, rows)).astype(np.float32))
    with torch.no_grad():
        want = layer_dense(layer, x, dtype).float()
        got = row_dense(x, layer.kernel, layer.bias, dtype, None)
    assert got.dtype == dtype and got.shape == (3, 6)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
        assert float((got.float() - want).abs().max()) <= ulp


def test_dcn_smoke_two_ranks_matches_jax_two_processes():
    """The same rows (default_rng(rank), two per device) through both
    packages' two-process smoke: one global loss, equal on every rank."""
    env = _env()
    jp = jax_processes("video_spike_tpu.parallel.dcn_smoke", env)
    tp = torch_ranks("video_spike_torch.parallel.dcn_smoke", env)
    import re

    def losses(outs):
        text = "\n".join(outs)
        for pid in range(2):
            assert f"pid={pid} process_count=2" in text, text
        return [float(re.search(rf"pid={pid} global_loss=([-\d.]+)",
                                text).group(1)) for pid in range(2)]

    got, ref = losses(_wait(tp)), losses(_wait(jp))
    assert got[0] == got[1]
    assert got[0] == pytest.approx(ref[0], rel=1e-6)
