"""PyTorch port of the SSL models and losses (``models/vit_mae.py``,
``ops/contrastive.py``, ``data/contrast.device_frame_transform``, the
ViT-MAE tree in ``convert.py``) against the JAX package.

The same numpy inputs, made from a seed, go through both packages; the port
starts from the JAX parameters through ``video_spike_torch.convert``. The
small ViT is ``tests/test_contrast_stack.py``'s: image 32, patch 8, hidden
32, 2 encoder layers, 1 decoder layer, 4 heads, MLP 64, embed 3. Masking
noise is the same in both packages: drawn by ``jax.random.uniform`` and
passed to the port, or, at the wrapper level, both packages'
``random_masking`` monkeypatched here to read one fixed numpy draw per
(B, L). For float32 models the flax backbone's dtype is overridden in the
test (its wrappers build the backbone with the bf16 default). Tolerances:

- masking, ``patchify`` / ``unpatchify``, converter round trips: equal;
- float32 forward (``encode``, the three wrappers): rtol 1e-5, atol 1e-6;
- bfloat16 forward: the JAX float32 model on the same params is the truth;
  the port's max abs error against it is at most twice the JAX bf16
  model's, plus 1e-3;
- gradients of the triplet loss w.r.t. every parameter, float32: rtol
  1e-4, plus an atol of 1e-5 of the leaf's largest gradient (summation
  order where an element cancels to near zero: one LayerNorm bias element
  of 0.005 in a leaf of ~1 differed by 2.3e-6); a parameter the loss does
  not reach has a zero JAX gradient and no torch gradient;
- contrastive losses and their gradients: rtol 1e-5, atol 1e-6;
- ``device_frame_transform`` (antialiased bilinear resize to 144, then
  normalization to [-1, 1]) at 64×96, 128×128, 106×160 and 200×200: atol
  2e-5 (the JAX resize's own float32 rounding, doubled by the
  normalization);
- constant-lr adamw: one port step from a converted optax state within
  rtol 1e-5 of optax's step.
"""

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from video_spike_tpu.data.contrast import device_frame_transform as j_resize
from video_spike_tpu.models import vit_mae as jvit
from video_spike_tpu.ops import contrastive as jc
from video_spike_torch.convert import (
    adamw_state_from_optax,
    adamw_state_to_optax,
    flax_to_torch,
    load_into_model,
    torch_to_flax,
)
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.data.contrast import device_frame_transform as t_resize
from video_spike_torch.models import vit_mae as tvit
from video_spike_torch.ops import contrastive as tc
from video_spike_torch.ops.optim import AdamW, apply_updates

torch.set_num_threads(1)

TINY = dict(
    model_class="ViT_MAE", image_size=32, patch_size=8, num_channels=1,
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, decoder_hidden_size=32,
    decoder_num_hidden_layers=1, decoder_num_attention_heads=4,
    decoder_intermediate_size=64, mask_ratio=0.75, norm_pix_loss=False,
    embed_size=3)
WRAPPERS = ("ContrastViTMAE", "MAE", "ContrastViT")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _F32Backbone(jvit.ViTMAEBackbone):
    dtype: Any = jnp.float32


def _noise(b: int, length: int) -> np.ndarray:
    """The fixed masking noise of a (B, L) batch."""
    return np.random.default_rng(b * 1009 + length).random(
        (b, length), dtype=np.float32)


def _jax_masking(x, mask_ratio, rng):
    """``jvit.random_masking`` with the noise of :func:`_noise`."""
    B, L, _ = x.shape
    len_keep = int(L * (1 - mask_ratio))
    ids_shuffle = jnp.argsort(jnp.asarray(_noise(B, L)), axis=1)
    ids_restore = jnp.argsort(ids_shuffle, axis=1)
    x_masked = jnp.take_along_axis(x, ids_shuffle[:, :len_keep, None], axis=1)
    mask = jnp.ones((B, L)).at[:, :len_keep].set(0.0)
    return x_masked, jnp.take_along_axis(mask, ids_restore, axis=1), \
        ids_restore


_port_masking = tvit.random_masking


def _torch_masking(x, mask_ratio, generator=None, noise=None):
    noise = torch.from_numpy(_noise(x.shape[0], x.shape[1]))
    return _port_masking(x, mask_ratio, noise=noise.to(x.device))


@pytest.fixture
def shared_noise(monkeypatch):
    monkeypatch.setattr(jvit, "random_masking", _jax_masking)
    monkeypatch.setattr(tvit, "random_masking", _torch_masking)


def _frames(seed=0, b=6):
    return np.random.default_rng(seed).normal(
        size=(b, 1, 32, 32)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(name):
    """The flax init of a wrapper (float32 parameters whatever the compute
    dtype), made once per test process."""
    jm = getattr(jvit, name).from_config(TINY)
    return jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        jnp.asarray(_frames())))


def _pair(name, dtype, monkeypatch):
    """(JAX model, its params as numpy, the port model holding them)."""
    if dtype == "float32":
        monkeypatch.setattr(jvit, "ViTMAEBackbone", _F32Backbone)
    jm = getattr(jvit, name).from_config(TINY)
    params = _params(name)
    tm = NAME2MODEL[name].from_config(TINY, dtype=DTYPES[dtype])
    load_into_model(tm, flax_to_torch(params))
    return jm, params, tm


def _japply(jm, params, x, mask_ratio=None):
    return jax.jit(lambda p, x: jm.apply(
        p, x, mask_ratio, rngs={"masking": jax.random.PRNGKey(2)}))(
            params, jnp.asarray(x))


def _port_out(tm, x):
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    return {k: v.float().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# masking, patchify, trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.75, 0.5, 0.9])
def test_random_masking_with_jax_noise(ratio):
    x = np.random.default_rng(0).normal(size=(4, 16, 8)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    ref = jvit.random_masking(jnp.asarray(x), ratio, rng)
    noise = torch.tensor(np.asarray(jax.random.uniform(rng, (4, 16))))
    got = tvit.random_masking(torch.from_numpy(x), ratio, noise=noise)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # drawn from a generator: the kept share and the restore permutation
    x_m, mask, ids = tvit.random_masking(
        torch.from_numpy(x), ratio, torch.Generator().manual_seed(0))
    assert x_m.shape[1] == int(16 * (1 - ratio))
    assert int(mask.sum()) == 4 * (16 - x_m.shape[1])
    assert torch.equal(ids.sort(dim=1).values, torch.arange(16).expand(4, 16))


def test_patchify_round_trip_equals_jax():
    imgs = _frames(1, 3)
    ref = np.asarray(jvit.patchify(jnp.asarray(imgs), 8))
    got = tvit.patchify(torch.from_numpy(imgs), 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tvit.unpatchify(got, 8, 1).numpy(),
                                  np.asarray(jvit.unpatchify(ref, 8, 1)))
    np.testing.assert_array_equal(tvit.unpatchify(got, 8, 1).numpy(), imgs)


def test_production_trees_match_jax():
    """At ``configs/model/vit_mae/vit_mae.yaml`` the port holds the flax
    trees' names and shapes: ContrastViTMAE 255 leaves, 111,002,116
    parameters."""
    from pathlib import Path

    cfg = yaml.safe_load((Path(__file__).resolve().parent.parent /
                          "configs/model/vit_mae/vit_mae.yaml").read_text())
    counts = {}
    for name in WRAPPERS:
        jm = getattr(jvit, name).from_config(cfg)
        shapes = jax.eval_shape(
            lambda m=jm: m.init({"params": jax.random.PRNGKey(0),
                                 "masking": jax.random.PRNGKey(1)},
                                jnp.zeros((1, 1, 144, 144))))
        ref = {".".join(p.key for p in path[1:]): tuple(v.shape)
               for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        with torch.device("meta"):
            tm = NAME2MODEL[name].from_config(cfg)
        got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
        assert got == ref, name
        counts[name] = (len(got), sum(p.numel() for p in tm.parameters()))
    assert counts["ContrastViTMAE"] == (255, 111_002_116)
    assert counts["MAE"] == (252, 110_999_808)
    assert counts["ContrastViT"] == (153, 85_256_964)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.75, 0.0])
def test_encode_matches_jax_with_explicit_rng(ratio):
    bb = _F32Backbone(**tvit._backbone_kwargs(TINY))
    x = _frames(2)
    rng = jax.random.PRNGKey(7)
    params = jax.device_get(jax.jit(bb.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(x), rng=rng))
    ref = jax.jit(lambda p, x: bb.apply(p, x, ratio, rng, method=bb.encode))(
        params, jnp.asarray(x))
    tb = tvit.ViTMAEBackbone(**tvit._backbone_kwargs(TINY),
                             dtype=torch.float32)
    load_into_model(tb, flax_to_torch(params))
    noise = torch.tensor(np.asarray(jax.random.uniform(rng, (6, 16))))
    with torch.no_grad():
        got = tb.encode(torch.from_numpy(x), ratio, noise=noise)
    assert got[0].dtype == torch.float32          # the final LN is f32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_forward_f32_matches_jax(name, monkeypatch, shared_noise):
    jm, params, tm = _pair(name, "float32", monkeypatch)
    x = _frames(3)
    ref = _japply(jm, params, x)
    got = _port_out(tm, x)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the embed path (mask ratio 0)
    ref0 = _japply(jm, params, x, mask_ratio=0.0)
    with torch.no_grad():
        got0 = tm(torch.from_numpy(x), mask_ratio=0.0)
    np.testing.assert_allclose(got0["z"].numpy(), np.asarray(ref0["z"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_bf16_error_within_twice_jax(name, monkeypatch,
                                             shared_noise):
    jm, params, tm = _pair(name, "bfloat16", monkeypatch)
    x = _frames(4)
    ref = _japply(jm, params, x)
    monkeypatch.setattr(jvit, "ViTMAEBackbone", _F32Backbone)
    truth = _japply(getattr(jvit, name).from_config(TINY), params, x)
    got = _port_out(tm, x)
    for k in ("z", "recon_loss"):
        if k not in truth:
            continue
        t = np.asarray(truth[k], np.float32)
        err_jax = np.abs(np.asarray(ref[k], np.float32) - t).max()
        err_port = np.abs(got[k] - t).max()
        assert err_port <= 2 * err_jax + 1e-3, (k, err_port, err_jax)


@pytest.mark.parametrize("name", WRAPPERS)
def test_triplet_gradients_match_jax(name, monkeypatch, shared_noise):
    """The trainer's loss on a (3B) stacked forward split into ref / pos /
    neg, differentiated w.r.t. every parameter."""
    jm, params, tm = _pair(name, "float32", monkeypatch)
    x = _frames(5, 6)
    b = 2

    def split(out):
        return [{k: v[i * b:(i + 1) * b] if v.ndim > 0 else v
                 for k, v in out.items()} for i in range(3)]

    def loss_j(p):
        out = _japply(jm, p, x)
        if name == "MAE":
            return jc.loss_fn_(out, None, None)["loss"]
        return jc.loss_fn_(*split(out))["loss"]

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(params)
    gj = flax_to_torch(jax.device_get(gj))
    named = dict(tm.named_parameters())
    out = tm(torch.from_numpy(x))
    loss_t = (tc.loss_fn_(out, None, None) if name == "MAE"
              else tc.loss_fn_(*split(out)))["loss"]
    grads = torch.autograd.grad(loss_t, list(named.values()),
                                allow_unused=True)
    assert float(loss_t.detach()) == pytest.approx(float(lj), rel=1e-5)
    for (k, p), g in zip(named.items(), grads):
        ref = gj[k].numpy()
        if g is None:                 # not reached by the loss
            assert not ref.any(), k
            continue
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max() + 1e-7,
                                   err_msg=k)


def test_remat_is_identical(monkeypatch, shared_noise):
    _, params, plain = _pair("ContrastViTMAE", "float32", monkeypatch)
    remat = NAME2MODEL["ContrastViTMAE"].from_config(dict(TINY, remat=True),
                                                     dtype=torch.float32)
    load_into_model(remat, flax_to_torch(params))
    x = torch.from_numpy(_frames(6))
    outs = []
    for m in (plain, remat):
        out = m(x)
        loss = out["recon_loss"] + out["z"].sum()
        outs.append((loss, torch.autograd.grad(loss, list(m.parameters()),
                                               allow_unused=True)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# contrastive losses
# ---------------------------------------------------------------------------

def _embeddings(seed=0, n=8, d=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for _ in range(3)]


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["dot_similarity", "euclidean_similarity"])
def test_similarities_match_jax(fn):
    arrs = _embeddings(1)
    ref = getattr(jc, fn)(*map(jnp.asarray, arrs))
    got = getattr(tc, fn)(*map(torch.from_numpy, arrs))
    for a, b in zip(got, ref):
        _close(a, b)
    pos, neg = getattr(tc, fn)(*map(torch.from_numpy, arrs))
    for a, b in zip(tc.infonce_from_dists(pos, neg),
                    jc.infonce_from_dists(*ref)):
        _close(a, b)


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_info_nce_and_gradients_match_jax(tau):
    ref_, pos_, neg_ = _embeddings(2)

    def lj(r, t):
        return jc.info_nce(r, jnp.asarray(pos_), jnp.asarray(neg_), t)

    out_j = lj(jnp.asarray(ref_), jnp.float32(tau))
    g_j = jax.grad(lambda r, t: lj(r, t)["loss"], argnums=(0, 1))(
        jnp.asarray(ref_), jnp.float32(tau))
    r = torch.from_numpy(ref_).requires_grad_(True)
    t = torch.tensor(tau, requires_grad=True)
    out_t = tc.info_nce(r, torch.from_numpy(pos_), torch.from_numpy(neg_), t)
    for k in out_j:
        _close(out_t[k], out_j[k])
    g_t = torch.autograd.grad(out_t["loss"], [r, t])
    for a, b in zip(g_t, g_j):
        _close(a, b)


@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_nce_loss_matches_jax(reduce):
    arrs = _embeddings(3)
    ref = jc.nce_loss(*map(jnp.asarray, arrs), temperature=0.7,
                      negative_weight=0.5, reduce=reduce)
    got = tc.nce_loss(*map(torch.from_numpy, arrs), temperature=0.7,
                      negative_weight=0.5, reduce=reduce)
    for a, b in zip(got, ref):
        _close(a, b)


def test_clip_loss_matches_jax():
    sim = np.random.default_rng(4).normal(size=(6, 6)).astype(np.float32)
    for a, b in zip(tc.clip_contrastive_loss(torch.from_numpy(sim)),
                    jc.clip_contrastive_loss(jnp.asarray(sim))):
        _close(a, b)


@pytest.mark.parametrize("kind", ["mae", "contrast_mae", "contrast",
                                  "recon_only"])
@pytest.mark.parametrize("fix_temp", [True, False])
def test_loss_dispatch_matches_jax(kind, fix_temp):
    z = _embeddings(5)
    recon = [np.float32(v) for v in (0.7, 0.9, 1.1)]
    keys = {"mae": ("z", "recon_loss"), "contrast_mae": ("z", "recon_loss",
                                                          "temp"),
            "contrast": ("z", "temp"), "recon_only": ("z", "recon_loss")}[kind]

    def outs(conv):
        return [{k: conv({"z": z[i], "recon_loss": recon[i],
                          "temp": np.float32(2.0)}[k]) for k in keys}
                for i in range(3)]

    jo = outs(jnp.asarray)
    to = outs(lambda a: torch.as_tensor(np.asarray(a)))
    if kind == "mae":
        ref = jc.loss_fn_(jo[0], None, None, fix_temp)
        got = tc.loss_fn_(to[0], None, None, fix_temp)
    else:
        ref = jc.loss_fn_(*jo, fix_temp=fix_temp)
        got = tc.loss_fn_(*to, fix_temp=fix_temp)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k])


# ---------------------------------------------------------------------------
# frame transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(64, 96), (128, 128), (106, 160),
                                 (200, 200)])
def test_frame_transform_matches_jax(h, w):
    frames = np.random.default_rng(h * w).integers(
        0, 256, (3, 1, h, w), dtype=np.uint8)
    ref = np.asarray(j_resize(jnp.asarray(frames), 144))
    got = t_resize(torch.from_numpy(frames), 144).numpy()
    assert got.shape == ref.shape == (3, 1, 144, 144)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    same = t_resize(torch.from_numpy(frames[..., :144, :144]), 144,
                    normalize=False)
    if h >= 144 and w >= 144:                     # no resize at 144
        np.testing.assert_array_equal(
            same.numpy(), frames[..., :144, :144].astype(np.float32) / 255.0)


# ---------------------------------------------------------------------------
# converter and the constant-lr adamw
# ---------------------------------------------------------------------------

def test_converter_round_trips_vit_mae_and_constant_lr_adamw(monkeypatch):
    _, params, tm = _pair("ContrastViTMAE", "float32", monkeypatch)
    params = jax.tree.map(np.asarray, params)
    back = torch_to_flax(flax_to_torch(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert flax_to_torch(params)["temperature"].shape == ()

    tx = optax.adamw(1e-3, weight_decay=0.01, eps=1e-8)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), params) for _ in range(2)]
    state = tx.init(params)
    u, state = tx.update(grads[0], state, params)
    p1 = optax.apply_updates(params, u)
    state = jax.device_get(state)
    port = adamw_state_from_optax(state)
    assert port["count"] == 1
    rebuilt = jax.tree.unflatten(
        jax.tree.structure(state),
        jax.tree.leaves(adamw_state_to_optax(port, schedule=False)))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(state)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    # the next step, taken by optax and by the port from the converted state
    u2, _ = tx.update(grads[1], state, p1)
    ref = flax_to_torch(jax.device_get(optax.apply_updates(p1, u2)))
    p1_t = flax_to_torch(jax.device_get(p1))
    upd, _ = AdamW(1e-3, weight_decay=0.01, eps=1e-8).update(
        flax_to_torch(grads[1]), port, p1_t)
    got = apply_updates(p1_t, upd)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_fixed_temperature_stays_zero_under_adamw():
    """A zero gradient on a zero parameter: AdamW's update and its weight
    decay are both zero, so the fixed temperature stays 0."""
    p = {"temperature": torch.zeros(())}
    tx = AdamW(5e-5, weight_decay=0.01)
    state = tx.init(p)
    for _ in range(3):
        upd, state = tx.update({"temperature": torch.zeros(())}, state, p)
        p = apply_updates(p, upd)
    assert float(p["temperature"]) == 0.0
