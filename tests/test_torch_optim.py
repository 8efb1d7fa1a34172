"""PyTorch port of the optimizers and schedule against optax / the JAX package.

Inputs are made with numpy from a seed and fed to both. Tolerances:

- ``cosine_onecycle_schedule``: rtol 1e-6 (both evaluate in float32; the
  cosine may differ in the last bit);
- adafactor, f32 leaves: rtol 1e-5 on updates and statistics (f32
  reductions in another order);
- adafactor, bf16 leaves: bitwise (statistics and updates are rounded to
  bf16 at every op, as optax does; the f32 means land on the same bf16
  values here);
- ``apply_updates_sr``: bitwise on the same f32 sum;
- adamw: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_spike_tpu.ops import optim as joptim
from video_spike_torch.convert import (
    adafactor_state_from_optax,
    adafactor_state_to_optax,
    flax_to_torch,
    to_numpy,
)
from video_spike_torch.core.config import DictConfig
from video_spike_torch.ops import optim as toptim

torch.set_num_threads(1)

SHAPES = [(300, 200), (200, 300), (64, 500), (7,)]


@pytest.mark.parametrize("steps", [16, 100, 1000, 24_000])
def test_onecycle_schedule_matches_optax(steps):
    ref = optax.cosine_onecycle_schedule(transition_steps=steps,
                                         peak_value=5e-5, pct_start=0.15,
                                         div_factor=10, final_div_factor=1e4)
    got = toptim.cosine_onecycle_schedule(steps, 5e-5, 0.15, 10, 1e4)
    counts = sorted({0, 1, 2, steps // 7, int(0.15 * steps) - 1,
                     int(0.15 * steps), int(0.15 * steps) + 1, steps // 2,
                     steps - 1, steps, steps + 5})
    for c in counts:
        assert got(c) == pytest.approx(float(ref(jnp.int32(c))),
                                       rel=1e-6, abs=1e-12), c


def _trees(dtype, seed=0):
    rng = np.random.default_rng(seed)
    params = {f"l{i}": rng.normal(size=s).astype(np.float32) * 0.1
              for i, s in enumerate(SHAPES)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
              for k, v in params.items()} for _ in range(5)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    jg = [{k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
          for g in grads]
    tp = flax_to_torch({k: np.asarray(v) for k, v in jp.items()})
    tg = [flax_to_torch({k: np.asarray(v) for k, v in g.items()})
          for g in jg]
    return jp, jg, tp, tg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_matches_optax(dtype):
    """5 steps of optax.adafactor (lean: no param scale, no clipping) with a
    schedule, on f32 or bf16 leaves of shapes (300, 200), (200, 300),
    (64, 500) and (7,). The port's state is compared after converting
    optax's state, so the structure and dtypes are checked too."""
    sched_j = optax.cosine_onecycle_schedule(16, 1e-2, 0.15, 10, 1e4)
    sched_t = toptim.cosine_onecycle_schedule(16, 1e-2, 0.15, 10, 1e4)
    tx = optax.adafactor(sched_j, multiply_by_parameter_scale=False,
                         clipping_threshold=None)
    jp, jg, tp, tg = _trees(dtype)
    js = tx.init(jp)
    port = toptim.Adafactor(sched_t)
    ts = port.init(tp)
    for step in range(5):
        ju, js = tx.update(jg[step], js, jp)
        tu, ts = port.update(tg[step], ts, tp)
        ref_state = adafactor_state_from_optax(jax.device_get(js))
        assert ts["count"] == ref_state["count"] == step + 1
        for part in ("v_row", "v_col", "v"):
            for k in tp:
                got, ref = ts[part][k], ref_state[part][k]
                assert got.dtype == ref.dtype and got.shape == ref.shape
                if dtype == "float32":
                    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                               rtol=1e-5, atol=1e-30)
                else:
                    np.testing.assert_array_equal(to_numpy(got),
                                                  to_numpy(ref))
        for k in tp:
            got, ref = to_numpy(tu[k]), np.asarray(ju[k])
            assert got.dtype == ref.dtype
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
            else:
                np.testing.assert_array_equal(got, ref)
        # both sides continue from the reference params
        jp = optax.apply_updates(jp, ju)
        tp = flax_to_torch({k: np.asarray(v) for k, v in jp.items()})


@pytest.mark.parametrize("schedule", [True, False])
def test_adafactor_state_converts_both_ways(schedule):
    """optax chain state -> port -> back rebuilds the optax object exactly
    (structure, dtypes, values), with or without a learning-rate schedule."""
    lr = (optax.cosine_onecycle_schedule(16, 1e-2, 0.15, 10, 1e4)
          if schedule else 1e-2)
    tx = optax.adafactor(lr, multiply_by_parameter_scale=False,
                         clipping_threshold=None)
    jp, jg, _, _ = _trees("bfloat16", seed=3)
    _, js = tx.update(jg[0], tx.init(jp), jp)
    js = jax.device_get(js)
    back = adafactor_state_to_optax(adafactor_state_from_optax(js),
                                    schedule=schedule)
    rebuilt = jax.tree.unflatten(jax.tree.structure(js),
                                 jax.tree.leaves(back))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(js)):
        a, b = np.atleast_1d(a), np.atleast_1d(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_factored_dims_follow_optax():
    """The two largest axes, wherever they sit; factored only when the
    second largest is >= 128 (so the statistics' shapes match optax)."""
    for shape in [(300, 200), (200, 300), (64, 500), (128, 128), (127, 999),
                  (3, 200, 300), (7,)]:
        tx = optax.adafactor(1e-3, multiply_by_parameter_scale=False,
                             clipping_threshold=None)
        st = tx.init({"a": jnp.zeros(shape)})[0]
        ps = toptim.Adafactor(1e-3).init({"a": torch.zeros(shape)})
        assert tuple(ps["v_row"]["a"].shape) == st.v_row["a"].shape, shape
        assert tuple(ps["v_col"]["a"].shape) == st.v_col["a"].shape, shape
        assert tuple(ps["v"]["a"].shape) == st.v["a"].shape, shape


def test_apply_updates_sr_bitwise():
    """Same params and f32 updates -> identical bits, with leaf ids counted
    over the bf16 leaves only in JAX's sorted-key flatten order."""
    rng = np.random.default_rng(2)
    tree = {"params": {
        "decoder": {"Dense_0": {"bias": rng.normal(size=(600,)),
                                "kernel": rng.normal(size=(256, 600))}},
        "encoder": {"Dense_0": {"bias": rng.normal(size=(64,))},
                    "Dense_1": {"bias": rng.normal(size=(32,)),
                                "kernel": rng.normal(size=(400, 200))}}}}
    j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    # two bf16 leaves (>= 65536 elements), the rest f32
    j = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.size >= 1 << 16
                     else a, j)
    upd = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * 1e-3), j)
    for seed in (0, 5, 2**32 - 1):
        ref = joptim.apply_updates_sr(j, upd, jnp.uint32(seed))
        got = toptim.apply_updates_sr(flax_to_torch(jax.device_get(j)),
                                      flax_to_torch(jax.device_get(upd)),
                                      seed)
        ref_flat = flax_to_torch(jax.device_get(ref))
        assert set(got) == set(ref_flat)
        for k in got:
            assert got[k].dtype == ref_flat[k].dtype, k
            assert torch.equal(got[k].view(torch.int16)
                               if got[k].dtype == torch.bfloat16
                               else got[k],
                               ref_flat[k].view(torch.int16)
                               if ref_flat[k].dtype == torch.bfloat16
                               else ref_flat[k]), (seed, k)


def test_adamw_matches_optax():
    sched_j = optax.cosine_onecycle_schedule(16, 1e-3, 0.15, 10, 1e4)
    sched_t = toptim.cosine_onecycle_schedule(16, 1e-3, 0.15, 10, 1e4)
    tx = optax.adamw(sched_j, weight_decay=0.01, eps=1e-8)
    jp, jg, tp, tg = _trees("float32", seed=4)
    js = tx.init(jp)
    port = toptim.AdamW(sched_t, weight_decay=0.01, eps=1e-8)
    ts = port.init(tp)
    for step in range(5):
        ju, js = tx.update(jg[step], js, jp)
        tu, ts = port.update(tg[step], ts, tp)
        for k in tp:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(ts["mu"][k].numpy(),
                                       np.asarray(js[0].mu[k]), rtol=1e-6)
            np.testing.assert_allclose(ts["nu"][k].numpy(),
                                       np.asarray(js[0].nu[k]), rtol=1e-6)
        jp = optax.apply_updates(jp, ju)
        tp = flax_to_torch({k: np.asarray(v) for k, v in jp.items()})
        assert ts["count"] == int(js[0].count)


def _opt_config(**opt):
    base = {"lr": 5e-5, "wd": 0.01, "eps": 1e-8, "warmup_pct": 0.15,
            "div_factor": 10, "gradient_accumulation_steps": 1}
    return DictConfig({"optimizer": {**base, **opt}})


MAKE_CASES = [
    ({}, toptim.AdamW),
    (dict(name="adafactor", param_scale=False, clipping=None,
          param_dtype="bfloat16_sr"), toptim.Adafactor),
    (dict(name="adafactor_lean"), toptim.AdafactorLean),
    (dict(name="adafactor"), toptim.Adafactor),       # param_scale default
    (dict(param_dtype="bfloat16_sr"), toptim.AdamWLowmem),  # adamw_sr_bf16
    (dict(lowmem_state=True), toptim.AdamWLowmem),
    (dict(mu_dtype="bfloat16"), toptim.AdamW),
    (dict(gradient_accumulation_steps=4), toptim.MultiSteps),
]


@pytest.mark.parametrize("opt,cls", MAKE_CASES,
                         ids=[str(sorted(o.items())) for o, _ in MAKE_CASES])
def test_make_optimizer_names(opt, cls):
    """Each optimizer config builds the transform JAX's make_optimizer
    picks: the port's class, and the same updates over 4 steps of an f32
    tree (rtol 1e-5, atol 1e-6 of the largest update: the f32 rule above,
    with XLA's f32 sqrt not correctly rounded) and the same schedule."""
    from video_spike_tpu.core.config import DictConfig as JConfig
    from video_spike_tpu.train.base import make_optimizer as j_make

    tx_t, sched = toptim.make_optimizer(_opt_config(**opt), 1000)
    assert isinstance(tx_t, cls)
    cfg = _opt_config(**opt)
    tx_j, sched_j = j_make(JConfig({"optimizer": dict(cfg.optimizer)}), 1000)
    for c in (0, 150, 999):
        assert sched(c) == pytest.approx(float(sched_j(c)), rel=1e-6)
    jp, jg, tp, tg = _trees("float32", seed=6)
    js, ts = tx_j.init(jp), tx_t.init(tp)
    for step in range(4):
        ju, js = tx_j.update(jg[step], js, jp)
        tu, ts = tx_t.update(tg[step], ts, tp)
        for k in tp:
            ref = np.asarray(ju[k])
            np.testing.assert_allclose(
                tu[k].numpy(), ref, rtol=1e-5,
                atol=1e-6 * float(np.abs(ref).max()), err_msg=f"{step} {k}")
