"""PyTorch port of every optimizer variant of the JAX trainer against the JAX
package and optax: ``adafactor_lean``, ``adamw_lowmem`` / ``adamw_sr_bf16``
(``scale_by_adam_lowmem`` chains), ``optax.adamw(mu_dtype=bfloat16)``,
``optax.adafactor`` with each option and all of them, ``optax.MultiSteps``
alone and around the frozen mask; their optax states through
``video_spike_torch.convert`` both ways; the fused Linear step under
``adafactor_lean``; gradient accumulation; both packages' ``BaseTrainer``;
the new states through ``model_last.pt`` and ``--resume``.

Inputs are made with numpy from a seed and fed to both packages; the port
starts from the JAX parameters. Tolerances:

- transforms, 5 steps on f32 and on bf16 trees (each step from the
  reference's parameters): f32 updates and states rtol 2e-6 with an atol
  of 1e-6 of the leaf's largest value (f32 reductions in another order;
  XLA's f32 ``sqrt`` on the CPU is not correctly rounded, 0.6% of its
  results differ from torch's by an ulp; where a later add cancels, the
  difference is one of the leaf's scale, not of the element); bf16 ones
  >= 99% bitwise and each within 1 bf16 ulp of itself plus 1 bf16 ulp of
  the leaf's largest value (such an f32 difference rounds to the
  neighbouring bf16, and a weight-decay add can cancel after it); integer
  counters equal; on a bf16 tree the f32 values that momentum forms from
  bf16 updates (its EMA and the updates) by that bf16 rule too;
  ``apply_updates_sr`` params by the same bf16 rule (a flipped SR
  decision);
- state conversion: bitwise, structure and dtypes included;
- fused Linear step under ``adafactor_lean``, 3 steps:
  ``tests/test_torch_train.py``'s tolerances (loss rtol 1e-5, bf16 leaves
  >= 99.9% bitwise and within 1 ulp plus 2^-20 of their scale, f32 leaves
  rtol 1e-4 with an absolute floor of 1e-2 of the learning rate, fused
  statistics rtol 1e-4), and the lean statistics of the rest rtol 1e-4
  with a floor of 1e-4 of the leaf's largest value (a bias's bf16 ``v``
  within 1 bf16 ulp plus that floor: the gradients differ in their last
  f32 bits, relatively more where they cancel to near zero);
- accumulation: k micro-steps equal one big-batch step (rtol 1e-5, the JAX
  test's bound) and no update before k (bitwise);
- trainers from the same initial parameters on the same fixture: per-epoch
  train loss rtol 1e-4, eval bps and R² within 1e-3 (``PERF.md`` §2).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_spike_tpu.ops import optim as joptim
from video_spike_torch import convert as cv
from video_spike_torch.convert import flax_to_torch, to_numpy
from video_spike_torch.core.config import DictConfig
from video_spike_torch.ops import optim as toptim

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(300, 200), (200, 300), (64, 500), (128, 128), (7,)]
LR = 1e-2
F32_RTOL = 2e-6


def _sched():
    return (optax.cosine_onecycle_schedule(16, LR, 0.15, 10, 1e4),
            toptim.cosine_onecycle_schedule(16, LR, 0.15, 10, 1e4))


def _trees(dtype, seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    params = {f"l{i}": rng.normal(size=s).astype(np.float32) * 0.1
              for i, s in enumerate(shapes)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
              for k, v in params.items()} for _ in range(5)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    jg = [{k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
          for g in grads]
    return jp, jg


def _port(tree):
    return flax_to_torch(jax.device_get(tree))


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


def _ulp_close(got, ref):
    """|got - ref| <= 1 bf16 ulp at max(|got|, |ref|) + 1 bf16 ulp of the
    leaf's largest |ref|."""
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    floor = _bf16_ulp(np.abs(r).max()) if r.size else 0.0
    return np.abs(g - r) <= _bf16_ulp(np.maximum(np.abs(g), np.abs(r))) \
        + floor


def _assert_close(got, ref, what, bf16_rule=False):
    """A port tensor (or int) against the reference's value; with
    ``bf16_rule`` an f32 value is held to the bf16 rule (formed from bf16
    values)."""
    if isinstance(got, int):
        assert got == int(np.asarray(ref)), what
        return
    if isinstance(ref, torch.Tensor):
        ref = to_numpy(ref)
    ref = np.asarray(ref)
    g = to_numpy(got)
    assert g.dtype == ref.dtype and g.shape == ref.shape, (
        what, g.dtype, ref.dtype, g.shape, ref.shape)
    if g.dtype.name == "bfloat16":
        assert (g.view(np.uint16) == ref.view(np.uint16)).mean() >= 0.99, \
            what
        assert _ulp_close(g, ref).all(), what
    elif bf16_rule:
        assert _ulp_close(g, ref).all(), what
    else:
        np.testing.assert_allclose(
            g, ref, rtol=F32_RTOL,
            atol=1e-6 * float(np.abs(ref).max()) if ref.size else 0.0,
            err_msg=str(what))


def _assert_state(got, ref, what=(), bf16_rule=False):
    """Nested port state against the converted reference state."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (what, set(got), set(ref))
        for k in ref:
            _assert_state(got[k], ref[k], what + (k,), bf16_rule)
    elif isinstance(ref, tuple):
        assert tuple(got) == ref == (), what
    else:
        _assert_close(got, ref, what, bf16_rule)


# ---------------------------------------------------------------------------
# the transforms, each against its JAX counterpart
# ---------------------------------------------------------------------------

def _adafactor(**kw):
    jkw = dict(multiply_by_parameter_scale=kw.get("param_scale", False),
               clipping_threshold=kw.get("clipping"),
               momentum=kw.get("momentum"),
               weight_decay_rate=kw.get("wd"))
    tkw = dict(multiply_by_parameter_scale=jkw["multiply_by_parameter_scale"],
               clipping_threshold=jkw["clipping_threshold"],
               momentum=jkw["momentum"],
               weight_decay_rate=jkw["weight_decay_rate"])
    return (lambda s: optax.adafactor(s, **jkw),
            lambda s: toptim.Adafactor(s, **tkw),
            cv.adafactor_state_from_optax,
            functools.partial(cv.adafactor_state_to_optax,
                              clipping=kw.get("clipping") is not None,
                              param_scale=kw.get("param_scale", False),
                              weight_decay=kw.get("wd") is not None))


TRANSFORMS = {
    "adafactor_lean": (lambda s: joptim.adafactor_lean(s),
                       lambda s: toptim.AdafactorLean(s),
                       lambda st, d=None: cv.lean_state_from_flax(st, d),
                       cv.lean_state_to_flax),
    "adamw_lowmem": (lambda s: joptim.adamw_lowmem(s, weight_decay=0.01),
                     lambda s: toptim.AdamWLowmem(s, weight_decay=0.01),
                     cv.adamw_state_from_optax, cv.adamw_state_to_optax),
    "adamw_mu_bf16": (lambda s: optax.adamw(s, weight_decay=0.01,
                                            mu_dtype=jnp.bfloat16),
                      lambda s: toptim.AdamW(s, weight_decay=0.01,
                                             mu_dtype=torch.bfloat16),
                      cv.adamw_state_from_optax, cv.adamw_state_to_optax),
    "adafactor_param_scale": _adafactor(param_scale=True),
    "adafactor_clipping": _adafactor(clipping=1.0),
    "adafactor_momentum": _adafactor(momentum=0.9),
    "adafactor_wd": _adafactor(wd=1e-3),
    "adafactor_all": _adafactor(param_scale=True, clipping=1.0,
                                momentum=0.9, wd=1e-3),
}
# optax.adamw keeps its moments in the param dtype; the JAX trainer never
# feeds it a bf16 tree (bfloat16_sr picks adamw_sr_bf16 first)
CASES = [(name, dtype) for name in TRANSFORMS
         for dtype in ("float32", "bfloat16")
         if not (name == "adamw_mu_bf16" and dtype == "bfloat16")]


@pytest.mark.parametrize("name,dtype", CASES)
def test_transform_matches_jax(name, dtype):
    """5 updates: updates and states against JAX / optax, each step from
    the reference's parameters."""
    j_make, t_make, state_from, _ = TRANSFORMS[name]
    sched_j, sched_t = _sched()
    tx_j, tx_t = j_make(sched_j), t_make(sched_t)
    jp, jg = _trees(dtype, seed=list(TRANSFORMS).index(name))
    js, ts = tx_j.init(jp), tx_t.init(_port(jp))
    for step in range(5):
        ju, js = tx_j.update(jg[step], js, jp)
        tu, ts = tx_t.update(_port(jg[step]), ts, _port(jp))
        bf16 = dtype == "bfloat16"
        _assert_state(tu, _port(ju), (name, step, "updates"), bf16)
        _assert_state(ts, state_from(jax.device_get(js)), (name, step),
                      bf16)
        jp = optax.apply_updates(jp, ju)


def test_adamw_sr_bf16_with_sr_apply_matches_jax():
    """adamw_sr_bf16 + apply_updates_sr over a bf16 store (f32 biases),
    5 chained steps of each package on its own parameters."""
    sched_j, sched_t = _sched()
    tx_j = joptim.adamw_sr_bf16(sched_j, weight_decay=0.01)
    tx_t = toptim.AdamWLowmem(sched_t, weight_decay=0.01)
    jp, jg = _trees("bfloat16", seed=11)
    jp["l4"] = jp["l4"].astype(jnp.float32)
    jg = [{**g, "l4": g["l4"].astype(jnp.float32)} for g in jg]
    tp = _port(jp)
    js, ts = tx_j.init(jp), tx_t.init(tp)
    for step in range(5):
        ju, js = tx_j.update(jg[step], js, jp)
        jp = joptim.apply_updates_sr(jp, ju, jnp.uint32(step))
        tu, ts = tx_t.update(_port(jg[step]), ts, tp)
        tp = toptim.apply_updates_sr(tp, tu, step)
        _assert_state(tp, _port(jp), ("params", step))
        _assert_state(ts, cv.adamw_state_from_optax(jax.device_get(js)),
                      ("state", step))
    assert ts["mu"]["l0"].dtype == ts["nu"]["l4"].dtype == torch.bfloat16


FROZEN_SHAPES = {"backbone": (40, 30), "head": (30, 200), "bias": (200,)}


def _frozen_tree(seed):
    rng = np.random.default_rng(seed)
    params = {"params": {
        "backbone": {"kernel": rng.normal(size=FROZEN_SHAPES["backbone"])},
        "head": {"kernel": rng.normal(size=FROZEN_SHAPES["head"]),
                 "bias": rng.normal(size=FROZEN_SHAPES["bias"])}}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32) * 0.1,
                          params)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * 1e-2), params)
        for _ in range(6)]
    for g in grads:   # the frozen backbone's gradient is stopped
        g["params"]["backbone"]["kernel"] = jnp.zeros(
            FROZEN_SHAPES["backbone"], jnp.float32)
    return params, grads


def _frozen_inner_from(state, device=None):
    return cv.frozen_state_from_optax(state, cv.adamw_state_from_optax,
                                      device)


def _frozen_inner_to(state):
    return cv.frozen_state_to_optax(cv.adamw_state_to_optax(state))


@pytest.mark.parametrize("frozen", [False, True])
def test_multisteps_matches_optax(frozen):
    """optax.MultiSteps(k=3) around AdamW, alone and around the frozen
    mask (the JAX trainer's order: frozen first, MultiSteps outside), as
    make_optimizer builds them in both packages: 6 micro-steps, updates
    and state after each."""
    from video_spike_tpu.core.config import DictConfig as JConfig
    from video_spike_tpu.train.base import make_optimizer as j_make

    opt = {"lr": 1e-3, "wd": 0.01, "eps": 1e-8, "warmup_pct": 0.15,
           "div_factor": 10, "gradient_accumulation_steps": 3}
    paths = ("backbone",) if frozen else ()
    tx_j, _ = j_make(JConfig({"optimizer": opt}), 64, frozen_paths=paths)
    tx_t, _ = toptim.make_optimizer(DictConfig({"optimizer": opt}), 64,
                                    frozen_paths=paths)
    assert isinstance(tx_t, toptim.MultiSteps)
    assert isinstance(tx_t.inner, toptim.Frozen if frozen else toptim.AdamW)
    inner_from = _frozen_inner_from if frozen else cv.adamw_state_from_optax
    jp, jg = _frozen_tree(5)
    js, ts = tx_j.init(jp), tx_t.init(_port(jp))
    for step in range(6):
        ju, js = tx_j.update(jg[step], js, jp)
        g = _port(jg[step])
        p = _port(jp)
        if frozen:
            g = {k: v for k, v in g.items() if not k.startswith("backbone")}
            p = {k: v for k, v in p.items() if not k.startswith("backbone")}
        tu, ts = tx_t.update(g, ts, p)
        ref_u = _port(ju)
        if frozen:   # optax emits zeros for the frozen leaf; the port none
            assert not np.asarray(ref_u.pop("backbone.kernel")).any()
        _assert_state(tu, ref_u, ("updates", step))
        if step % 3 != 2:
            assert all(not v.any() for v in tu.values()), step
        _assert_state(ts, cv.multisteps_state_from_optax(
            jax.device_get(js), inner_from), ("state", step))
        jp = optax.apply_updates(jp, ju)
    assert ts["gradient_step"] == 2 and ts["mini_step"] == 0
    assert ts["inner"]["count"] == 2


# ---------------------------------------------------------------------------
# state conversion both ways
# ---------------------------------------------------------------------------

def _roundtrip(js, back):
    rebuilt = jax.tree.unflatten(jax.tree.structure(js),
                                 jax.tree.leaves(back))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(js)):
        a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_state_converts_both_ways(name):
    """optax state -> port -> back rebuilds the optax object exactly, on a
    bf16 tree (f32 for the mu_dtype AdamW) after two updates."""
    j_make, _, state_from, state_to = TRANSFORMS[name]
    tx = j_make(_sched()[0])
    jp, jg = _trees("float32" if name == "adamw_mu_bf16" else "bfloat16",
                    seed=3)
    js = tx.init(jp)
    for g in jg[:2]:
        _, js = tx.update(g, js, jp)
    js = jax.device_get(js)
    _roundtrip(js, state_to(state_from(js)))


@pytest.mark.parametrize("frozen", [False, True])
def test_multisteps_state_converts_both_ways(frozen):
    from video_spike_tpu.core.config import DictConfig as JConfig
    from video_spike_tpu.train.base import make_optimizer as j_make

    opt = {"lr": 1e-3, "warmup_pct": 0.15, "div_factor": 10,
           "gradient_accumulation_steps": 2}
    tx, _ = j_make(JConfig({"optimizer": opt}), 64,
                   frozen_paths=("backbone",) if frozen else ())
    jp, jg = _frozen_tree(1)
    js = tx.init(jp)
    for g in jg[:3]:
        _, js = tx.update(g, js, jp)
    js = jax.device_get(js)
    inner_from, inner_to = ((_frozen_inner_from, _frozen_inner_to) if frozen
                            else (cv.adamw_state_from_optax,
                                  cv.adamw_state_to_optax))
    port = cv.multisteps_state_from_optax(js, inner_from)
    assert port["mini_step"] == 1 and port["gradient_step"] == 1
    assert "backbone.kernel" in port["acc_grads"]
    _roundtrip(js, cv.multisteps_state_to_optax(port, inner_to))


# ---------------------------------------------------------------------------
# the fused Linear step under adafactor_lean
# ---------------------------------------------------------------------------

def test_fused_linear_step_under_lean_matches_jax():
    """The fused step with adafactor_lean on the rest of the tree against
    JAX's make_fused_linear_step(model, adafactor_lean(...)) (its XLA
    path), 3 chained steps from the same bf16-store parameters."""
    from test_torch_train import (B, IN_SHAPE, LR as T_LR, WIDTHS,
                                  _assert_bf16_close, _within)
    from video_spike_tpu.models.linear import LinearModel as JLinear
    from video_spike_tpu.ops import fused_readout as jfr
    from video_spike_tpu.ops.poisson import poisson_nll_mean as j_nll
    from video_spike_torch.convert import load_into_model
    from video_spike_torch.models.linear import LinearModel as TLinear
    from video_spike_torch.ops import fused_readout as tfr
    from video_spike_torch.ops.poisson import poisson_nll_mean as t_nll

    jm = JLinear(**WIDTHS, compute_dtype=jnp.float32)
    tm = TLinear(input_dim=int(np.prod(IN_SHAPE[1:])), **WIDTHS,
                 compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    xs = [rng.integers(0, 255, IN_SHAPE, dtype=np.uint8).reshape(B, -1)
          for _ in range(3)]
    aps = [rng.poisson(1.0, (B, 100, 6)).astype(np.float32)
           for _ in range(3)]
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(xs[0], jnp.float32))
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                          if p.size >= 1 << 16 else p, params)
    sched_j = optax.cosine_onecycle_schedule(16, T_LR, 0.15, 10, 1e4)
    sched_t = toptim.cosine_onecycle_schedule(16, T_LR, 0.15, 10, 1e4)
    tx_j = joptim.adafactor_lean(sched_j)
    step_j = jax.jit(jfr.make_fused_linear_step(jm, tx_j, sched_j, j_nll,
                                                joptim.apply_updates_sr))
    opt_j = jfr.init_fused_opt_state(params, tx_j)
    load_into_model(tm, _port(params))
    tx_t = toptim.AdafactorLean(sched_t)
    step_t = tfr.make_fused_linear_step(tm, tx_t, sched_t, t_nll,
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
        ref = _port(p_j)
        for k, got in p_t.items():
            if got.dtype == torch.bfloat16:
                _assert_bf16_close(got, to_numpy(ref[k]), (i, k))
            else:
                np.testing.assert_allclose(got.numpy(), ref[k].numpy(),
                                           rtol=1e-4, atol=1e-2 * T_LR,
                                           err_msg=f"{i} {k}")
        f_j, rest_j = jax.device_get(opt_j)
        f_t, rest_t = opt_t
        assert f_t.count == int(f_j.count) == i + 1
        np.testing.assert_allclose(f_t.row.numpy(), f_j.row, rtol=1e-4)
        np.testing.assert_allclose(f_t.col.numpy(), f_j.col, rtol=1e-4)
        rest_ref = cv.lean_state_from_flax(rest_j)
        assert rest_t["count"] == rest_ref["count"] == i + 1
        for part in ("row", "col"):
            for k, got in rest_t[part].items():
                r = rest_ref[part][k]
                assert got.dtype == r.dtype and got.shape == r.shape
                if got.dtype == torch.bfloat16:
                    assert _within(to_numpy(got), to_numpy(r), 1e-4).all()
                else:
                    np.testing.assert_allclose(
                        got.numpy(), r.numpy(), rtol=1e-4,
                        atol=1e-4 * float(r.abs().max()))


# ---------------------------------------------------------------------------
# gradient accumulation on the port (tests/test_grad_accum.py's pair)
# ---------------------------------------------------------------------------

def _accum_cfg(accum):
    return DictConfig({"optimizer": {
        "lr": 1e-3, "wd": 0.0, "eps": 1e-8, "warmup_pct": 0.15,
        "div_factor": 10, "gradient_accumulation_steps": accum}})


def _tiny_linear(seed=0):
    from video_spike_torch.models.linear import LinearModel as TLinear
    from video_spike_torch.ops.poisson import poisson_nll_mean as t_nll

    model = TLinear(input_dim=10, encoder_hidden=(8,), encoder_out=4,
                    decoder_hidden=(8,), output_dim=100 * 2,
                    compute_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))

    def grads(params, x, ap):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = t_nll(torch.func.functional_call(model, leaves, (x,)), ap)
        return dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))

    return {k: v.detach() for k, v in model.named_parameters()}, grads


def test_accumulated_equals_big_batch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 10)).astype(np.float32))
    ap = torch.from_numpy(rng.poisson(1.0, (8, 100, 2)).astype(np.float32))
    params0, grads = _tiny_linear()

    def run(accum, batches):
        tx, _ = toptim.make_optimizer(_accum_cfg(accum), total_steps=64)
        params, state = params0, tx.init(params0)
        for xb, ab in batches:
            upd, state = tx.update(grads(params, xb, ab), state, params)
            params = toptim.apply_updates(params, upd)
        return params

    big = run(1, [(x, ap)])
    acc = run(2, [(x[:4], ap[:4]), (x[4:], ap[4:])])
    for k in big:
        np.testing.assert_allclose(acc[k].numpy(), big[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_accum_no_update_until_k():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32))
    ap = torch.from_numpy(rng.poisson(1.0, (4, 100, 2)).astype(np.float32))
    params, grads = _tiny_linear()
    tx, _ = toptim.make_optimizer(_accum_cfg(3), total_steps=64)
    state = tx.init(params)
    for micro in range(2):     # micro-steps 1 and 2 of 3
        upd, state = tx.update(grads(params, x, ap), state, params)
        new = toptim.apply_updates(params, upd)
        for k in params:
            assert torch.equal(new[k], params[k]), (micro, k)
        assert state["inner"]["count"] == 0
    upd, state = tx.update(grads(params, x, ap), state, params)
    assert state["inner"]["count"] == 1 and state["gradient_step"] == 1
    assert any(bool(u.any()) for u in upd.values())


def test_sr_store_unchanged_by_micro_steps():
    """Under accumulation the bf16 store takes the micro-steps' zero
    updates through apply_updates_sr: SR of w + 0 is w for any seed."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(300, 256)).astype(np.float32)
                         ).to(torch.bfloat16)
    params = {"k": w, "b": torch.zeros(256)}
    tx = toptim.MultiSteps(toptim.AdamWLowmem(1e-3, weight_decay=0.01), 2)
    state = tx.init(params)
    g = {"k": torch.from_numpy(rng.normal(size=(300, 256)).astype(
        np.float32)).to(torch.bfloat16), "b": torch.ones(256)}
    upd, state = tx.update(g, state, params)
    for seed in (0, 7, (1 << 32) - 1):
        out = toptim.apply_updates_sr(params, upd, seed)
        assert torch.equal(out["k"].view(torch.int16), w.view(torch.int16))
        assert torch.equal(out["b"], params["b"])


# ---------------------------------------------------------------------------
# both packages' BaseTrainer on a tiny fixture
# ---------------------------------------------------------------------------

EID = "optvr0000"
TINY_LINEAR = dict(hidden_dims=[32, 16], output_dim=16)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    from video_spike_torch.data.synthetic import make_synthetic_session

    d = tmp_path_factory.mktemp("torch_optim_variants")
    make_synthetic_session(d / "data", eid=EID, n_trials=20, n_neurons=6,
                           seed=3, height=32, width=32)
    model = yaml.safe_load((REPO / "configs/model/linear_video.yaml")
                           .read_text())
    model["encoder"].update(TINY_LINEAR)
    model["decoder"]["hidden_dims"] = [16, 256]
    (d / "model.yaml").write_text(yaml.safe_dump(model))
    return d


def both_linear_trainers(d, tmp_path, optimizer, training=None,
                         epochs=2, extra=None):
    """The JAX and the port BaseTrainer on the fixture with f32 compute,
    the port holding the JAX trainer's initial parameters."""
    from video_spike_tpu.core import config as jconfig
    from video_spike_tpu.data import dataset as jdata
    from video_spike_tpu.models.linear import LinearModel as JLinear
    from video_spike_tpu.parallel.mesh import make_mesh
    from video_spike_tpu.train.base import BaseTrainer as JTrainer
    from video_spike_torch.convert import load_into_model
    from video_spike_torch.core import config as tconfig
    from video_spike_torch.data import dataset as tdata
    from video_spike_torch.models.linear import LinearModel as TLinear
    from video_spike_torch.train.base import BaseTrainer as TTrainer

    def jmodel(c):
        return JLinear(encoder_hidden=tuple(c.encoder.hidden_dims),
                       encoder_out=c.encoder.output_dim,
                       decoder_hidden=tuple(c.decoder.hidden_dims),
                       output_dim=c.decoder.output_dim,
                       compute_dtype=jnp.float32)

    trainers = []
    for cfgmod, data, make in (
            (jconfig, jdata, lambda c, *a, **k: JTrainer(
                jmodel(c.model), *a, mesh=make_mesh(n_data=1), **k)),
            (tconfig, tdata, lambda c, *a, **k: TTrainer(
                TLinear.from_config(c.model, compute_dtype=torch.float32),
                *a, device="cpu", **k))):
        config = cfgmod.config_from_kwargs(
            {"model": f"include:{d / 'model.yaml'}"})
        config = cfgmod.update_config(
            str(REPO / "configs/train/linear_video.yaml"), config)
        config["dirs"]["data_dir"] = str(d / "data")
        config["training"].update(num_epochs=epochs, train_batch_size=8,
                                  **(training or {}))
        config["optimizer"].update(optimizer)
        for k, v in (extra or {}).items():
            config[k] = v
        split = data.split_dataset(str(d / "data"), EID, seed=config.seed)
        loaders = data.make_loader(config, split)
        meta = data.get_metadata_from_loader(loaders[0], config)
        config["model"]["encoder"]["input_dim"] = meta["input_dim"]
        config["model"]["decoder"]["output_dim"] = meta["output_dim"]
        trainers.append((make(config, *loaders, config, eid=EID,
                              dataset_split_dict=split,
                              log_dir=str(tmp_path / cfgmod.__name__)),
                         loaders[1]))
    (jt, jval), (tt, _) = trainers
    jt._init_if_needed(jt._assemble_inputs(next(iter(jval))))
    tt._init_if_needed()
    load_into_model(tt.model, flax_to_torch(jax.device_get(jt.params)))
    return jt, tt


LEAN_FUSED = dict(name="adafactor_lean", param_dtype="bfloat16_sr",
                  fused_readout=True, fused_min_kernel=1)
ACCUM = dict(name="adamw", param_dtype="bfloat16_sr",
             gradient_accumulation_steps=2, fused_readout=True)


@pytest.mark.parametrize("case", ["lean_fused", "accum"])
def test_trainer_epochs_match_jax(session, tmp_path, case):
    """adafactor_lean with the fused readout on a bf16 SR store (the
    kernel's numerics and the rest of the tree's agree), and adamw_sr_bf16
    with accumulation 2 (the fused step turned off, as in the JAX
    trainer): 3 epochs of both trainers from the same parameters."""
    opt = LEAN_FUSED if case == "lean_fused" else ACCUM
    jt, tt = both_linear_trainers(session, tmp_path, opt, epochs=3)
    fused = case == "lean_fused"
    assert (tt._fused_inner is not None) == (jt._fused_inner is not None) \
        == fused
    assert isinstance(tt.tx, toptim.AdafactorLean if fused
                      else toptim.MultiSteps)
    assert tt.params["encoder.Dense_0.kernel"].dtype == torch.bfloat16
    for epoch in range(3):
        tr_j, tr_t = jt.train_epoch(), tt.train_epoch()
        assert tr_t["train_loss"] == pytest.approx(tr_j["train_loss"],
                                                   rel=1e-4), epoch
        assert tr_t["lr"] == pytest.approx(tr_j["lr"], rel=1e-6), epoch
        ev_j = jt.eval_epoch()["eval_res"]
        ev_t = tt.eval_epoch()["eval_res"]
        for k in ("eval_bps", "eval_rsquared"):
            assert abs(ev_t[k] - ev_j[k]) <= 1e-3, (epoch, k)
    assert tt.global_step == jt._global_step == 6
    if fused:
        assert tt.opt_state[0].count == tt.opt_state[1]["count"] == 6
    else:
        st = tt.opt_state
        assert st["gradient_step"] == 3 and st["mini_step"] == 0
        assert st["inner"]["count"] == 3
        ref = cv.multisteps_state_from_optax(
            jax.device_get(jt.opt_state), cv.adamw_state_from_optax)
        assert ref["gradient_step"] == 3 and ref["inner"]["count"] == 3


@pytest.mark.parametrize("case", ["lean_fused", "accum"])
def test_cli_checkpoint_carries_the_state(session, tmp_path, case):
    """model_last.pt holds the AdafactorLean (with the fused state) or the
    MultiSteps state as plain tensors and ints (a weights_only load), and
    --resume continues its counters."""
    from video_spike_torch.cli import train as train_cli

    train = yaml.safe_load((REPO / "configs/train/linear_video.yaml")
                           .read_text())
    train["optimizer"].update(LEAN_FUSED if case == "lean_fused" else ACCUM)
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(train))
    args = ["--model_config", str(session / "model.yaml"),
            "--train_config", str(tmp_path / "train.yaml"), "--eid", EID,
            "--data_dir", str(session / "data"), "--log_dir",
            str(tmp_path / "logs"), "--batch_size", "8", "--device", "cpu"]
    counts = []
    for epochs, extra in ((1, []), (2, ["--resume"])):
        res = train_cli.main(args + ["--num_epochs", str(epochs), *extra])
        state = torch.load(Path(res["log_dir"]) / "model_last.pt",
                           weights_only=True)["opt_state"]
        if case == "lean_fused":
            assert res["fused_readout"]
            counts.append((state["fused"]["count"], state["rest"]["count"]))
            assert state["rest"]["col"]["decoder.Dense_2.kernel"].ndim == 1
        else:
            tx = state["tx"]
            counts.append((tx["gradient_step"], tx["mini_step"],
                           tx["inner"]["count"]))
            assert tx["skip_state"] == ()
        assert res["global_step"] == 2 * epochs
    assert counts == ([(2, 2), (4, 4)] if case == "lean_fused"
                      else [(1, 0, 1), (2, 0, 2)])
