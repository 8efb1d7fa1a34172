"""PyTorch port of the VideoMAE models (``models/videomae.py``,
``models/hf_convert.py``, the ``vit_mae`` options they need) against the
JAX package.

The same numpy inputs, made from a seed, go through both packages; the port
starts from the JAX parameters through ``video_spike_torch.convert``. The
shape is ``tests/test_videomae.py``'s TINY: image 32, patch 8, 8 frames,
tubelet 2 (64 tokens), hidden 32, 2 layers, 4 heads, MLP 64. Masking noise
is one numpy draw per (B, L), read by both packages' ``random_masking``
(monkeypatched here). For float32 models the flax modules' bf16 default
dtype is overridden in the test. Tolerances:

- the interleaved sin-cos table, ``tubelet_patchify``, the parameter trees,
  ``convert_hf_videomae`` on a synthetic HF-named state dict, the masks:
  equal (bitwise);
- ``preprocess_frames``: atol 1e-6 shrinking (64 -> 48, 40 -> 32), at the
  probe's 128 -> 224 and without a resize; 3e-6 for the 32 -> 48
  enlargement (the two resizes form their float32 weights by different
  formulas: 6e-7 apart in [0, 1] units, amplified ~4.4x by the ImageNet
  normalization);
- float32 forwards (``VideoMAEBackbone`` with ``hf_compat`` on and off,
  ``VideoMAEForPreTraining``, the probe): rtol 1e-5, plus an atol of 1e-6
  of the output's largest magnitude (the tubelet matmul sums 384 products
  in another order than XLA's conv; a few elements near zero differ by
  ~2e-6 at a scale of ~3);
- gradients of the pretraining loss, float32: rtol 1e-4 plus an atol of
  1e-5 of the leaf's largest gradient (summation order where an element
  cancels to near zero);
- bfloat16 forwards: the JAX float32 model on the same parameters is the
  truth; the port's max abs error against it is at most twice the JAX bf16
  model's, plus 1e-3.
"""

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from video_spike_tpu.models import hf_convert as jhf
from video_spike_tpu.models import videomae as jvmae
from video_spike_tpu.models import vit_mae as jvit
from video_spike_torch.convert import (
    flax_to_torch,
    load_into_model,
    torch_to_flax,
)
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.models import hf_convert as thf
from video_spike_torch.models import videomae as tvmae
from video_spike_torch.models import vit_mae as tvit

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=8, num_channels=3, num_frames=8,
            tubelet_size=2, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            encoder={"output_dim": 16}, decoder={"output_dim": 100 * 4})
BACKBONE = {k: v for k, v in TINY.items() if k not in ("encoder", "decoder")}
L = 64                                   # (8 / 2) * (32 / 8) ** 2 tokens
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _F32Tubelet(jvmae.TubeletEmbed):
    dtype: Any = jnp.float32


class _F32Encoder(jvit.Encoder):
    dtype: Any = jnp.float32


class _F32Backbone(jvmae.VideoMAEBackbone):
    dtype: Any = jnp.float32


def _f32_jax(monkeypatch):
    """The flax VideoMAE modules in float32 (their default is bf16)."""
    monkeypatch.setattr(jvmae, "TubeletEmbed", _F32Tubelet)
    monkeypatch.setattr(jvmae, "Encoder", _F32Encoder)
    monkeypatch.setattr(jvmae, "VideoMAEBackbone", _F32Backbone)


def _noise(b: int, length: int) -> np.ndarray:
    return np.random.default_rng(b * 1009 + length).random(
        (b, length), dtype=np.float32)


def _jax_masking(x, mask_ratio, rng):
    B, L_, _ = x.shape
    len_keep = int(L_ * (1 - mask_ratio))
    ids_shuffle = jnp.argsort(jnp.asarray(_noise(B, L_)), axis=1)
    ids_restore = jnp.argsort(ids_shuffle, axis=1)
    x_masked = jnp.take_along_axis(x, ids_shuffle[:, :len_keep, None], axis=1)
    mask = jnp.ones((B, L_)).at[:, :len_keep].set(0.0)
    return x_masked, jnp.take_along_axis(mask, ids_restore, axis=1), \
        ids_restore


_port_masking = tvit.random_masking


def _torch_masking(x, mask_ratio, generator=None, noise=None):
    noise = torch.from_numpy(_noise(x.shape[0], x.shape[1]))
    return _port_masking(x, mask_ratio, noise=noise.to(x.device))


@pytest.fixture
def shared_noise(monkeypatch):
    monkeypatch.setattr(jvmae, "random_masking", _jax_masking)
    monkeypatch.setattr(tvmae, "random_masking", _torch_masking)


def _clip(seed=0, b=2):
    """Normalized frames (B, 8, 3, 32, 32), as preprocess_frames gives."""
    return np.random.default_rng(seed).normal(
        size=(b, 8, 3, 32, 32)).astype(np.float32)


def _trial_video(seed=0, b=2, hw=32):
    return np.random.default_rng(seed).integers(
        0, 256, (b, 120, 1, hw, hw), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _params(kind: str, hf_compat: bool = False):
    """The flax init of a TINY module (float32 parameters), once a process."""
    key = jax.random.PRNGKey(0)
    if kind == "backbone":
        m = jvmae.VideoMAEBackbone(**BACKBONE, hf_compat=hf_compat)
        return jax.device_get(jax.jit(m.init)(key, jnp.asarray(_clip())))
    if kind == "pretrain":
        m = jvmae.VideoMAEForPreTraining(config=BACKBONE)
        return jax.device_get(jax.jit(m.init)(
            {"params": key, "masking": jax.random.PRNGKey(1)},
            jnp.asarray(_clip())))
    m = jvmae.VideoMAEProbe(config=dict(TINY, hf_compat=hf_compat))
    return jax.device_get(jax.jit(m.init)(key, jnp.asarray(_trial_video())))


def _assert_f32_close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _backbone_pair(hf_compat, dtype):
    jm = jvmae.VideoMAEBackbone(**BACKBONE, hf_compat=hf_compat,
                                dtype=getattr(jnp, dtype))
    tm = tvmae.VideoMAEBackbone(**BACKBONE, hf_compat=hf_compat,
                                dtype=DTYPES[dtype])
    load_into_model(tm, flax_to_torch(_params("backbone", hf_compat)))
    return jm, tm


# ---------------------------------------------------------------------------
# tables, patchify, frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,length", [(32, 64), (768, 1568), (24, 7)])
def test_sincos_tables_equal(dim, length):
    for interleaved in (True, False):
        np.testing.assert_array_equal(
            tvit.sincos_pos_embed_1d(dim, length, interleaved=interleaved),
            jvit.sincos_pos_embed_1d(dim, length, interleaved=interleaved))


def test_tubelet_patchify_equals_jax():
    video = _clip(1)
    ref = np.asarray(jvmae.tubelet_patchify(jnp.asarray(video), 2, 8))
    got = tvmae.tubelet_patchify(torch.from_numpy(video), 2, 8)
    assert got.shape == (2, L, 2 * 8 * 8 * 3)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw,size,frames,atol", [
    (32, 48, 120, 3e-6), (64, 48, 120, 1e-6), (48, 48, 16, 1e-6),
    (40, 32, 16, 1e-6), (128, 224, 120, 1e-6)])
def test_preprocess_frames_matches_jax(hw, size, frames, atol):
    """Both resize directions and none; 128 -> 224 is the probe's. The
    32 -> 48 enlargement differs by up to 6e-7 before the normalization
    (jax.image.resize forms its float32 weights by another formula), 2.6e-6
    after it."""
    video = _trial_video(2, 2, hw)[:, :frames]
    ref = np.asarray(jvmae.preprocess_frames(
        jnp.asarray(video), num_frames=8, image_size=size,
        source_frames=frames))
    got = tvmae.preprocess_frames(torch.from_numpy(video), num_frames=8,
                                  image_size=size, source_frames=frames)
    assert got.shape == (2, 8, 3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


def _flax_shapes(tree):
    return {".".join(p.key for p in path[1:]): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("hf_compat", [True, False])
def test_tiny_trees_match_jax(hf_compat):
    probe = tvmae.VideoMAEProbe(dict(TINY, hf_compat=hf_compat))
    assert ({k: tuple(p.shape) for k, p in probe.named_parameters()}
            == _flax_shapes(_params("probe", hf_compat)))
    pre = tvmae.VideoMAEForPreTraining(BACKBONE)
    assert ({k: tuple(p.shape) for k, p in pre.named_parameters()}
            == _flax_shapes(_params("pretrain")))
    assert ("video_mae.encoder.LayerNorm_0.scale"
            in dict(probe.named_parameters())) != hf_compat


def test_production_trees_match_jax():
    """At ``configs/model/videomae/videomae.yaml`` with N = 436 neurons:
    the probe has 405,721,680 parameters, 86,234,880 of them the frozen
    backbone, and ``encoder_head`` is (1,204,224, 256); the pretraining
    model has 94,222,080."""
    from pathlib import Path

    cfg = yaml.safe_load((Path(__file__).resolve().parent.parent /
                          "configs/model/videomae/videomae.yaml").read_text())
    cfg["decoder"]["output_dim"] = 100 * 436
    shapes = {}
    for name, jcls, x in (
            ("VideoMAE", jvmae.VideoMAEProbe,
             jnp.zeros((1, 120, 1, 8, 8), jnp.uint8)),
            ("VideoMAEForPreTraining", jvmae.VideoMAEForPreTraining,
             jnp.zeros((1, 16, 3, 224, 224)))):
        jm = jcls(config=cfg if name == "VideoMAE" else {
            k: v for k, v in cfg.items() if k not in ("encoder", "decoder")})
        ref = _flax_shapes(jax.eval_shape(
            lambda m=jm, x=x: m.init({"params": jax.random.PRNGKey(0),
                                      "masking": jax.random.PRNGKey(1)}, x)))
        with torch.device("meta"):
            tm = NAME2MODEL[name].from_config(cfg)
        got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
        assert got == ref, name
        shapes[name] = got
    probe = shapes["VideoMAE"]
    total = sum(int(np.prod(s)) for s in probe.values())
    frozen = sum(int(np.prod(s)) for k, s in probe.items()
                 if k.startswith("video_mae."))
    assert (total, frozen) == (405_721_680, 86_234_880)
    assert probe["encoder_head.kernel"] == (1_204_224, 256)
    assert sum(int(np.prod(s)) for s in
               shapes["VideoMAEForPreTraining"].values()) == 94_222_080


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hf_compat", [True, False])
def test_backbone_f32_matches_jax(hf_compat):
    jm, tm = _backbone_pair(hf_compat, "float32")
    x = _clip(3)
    ref = np.asarray(jax.jit(jm.apply)(_params("backbone", hf_compat),
                                       jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, L, 32)
    _assert_f32_close(got.numpy(), ref)


@pytest.mark.parametrize("hf_compat", [True, False])
def test_backbone_bf16_error_within_twice_jax(hf_compat):
    jm, tm = _backbone_pair(hf_compat, "bfloat16")
    params = _params("backbone", hf_compat)
    x = jnp.asarray(_clip(4))
    ref = np.asarray(jax.jit(jm.apply)(params, x), np.float32)
    truth = np.asarray(jax.jit(jm.clone(dtype=jnp.float32).apply)(params, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(_clip(4)))
    # hf_compat: bf16 residual stream, no final norm; else the f32 final LN
    assert got.dtype == (torch.bfloat16 if hf_compat else torch.float32)
    err_jax = np.abs(ref - truth).max()
    err_port = np.abs(got.float().numpy() - truth).max()
    assert err_port <= 2 * err_jax + 1e-3, (err_port, err_jax)


def _pretrain_pair(dtype, monkeypatch):
    if dtype == "float32":
        _f32_jax(monkeypatch)
    jm = jvmae.VideoMAEForPreTraining(config=BACKBONE)
    tm = NAME2MODEL["VideoMAEForPreTraining"].from_config(
        BACKBONE, dtype=DTYPES[dtype])
    load_into_model(tm, flax_to_torch(_params("pretrain")))
    return jm, tm


def _jax_pretrain(jm, params, x, ratio):
    return jax.jit(lambda p, x: jm.apply(
        p, x, mask_ratio=ratio, rngs={"masking": jax.random.PRNGKey(2)}))(
            params, jnp.asarray(x))


@pytest.mark.parametrize("ratio", [0.9, 0.5])
def test_pretraining_f32_matches_jax(ratio, monkeypatch, shared_noise):
    jm, tm = _pretrain_pair("float32", monkeypatch)
    x = _clip(5)
    ref = _jax_pretrain(jm, _params("pretrain"), x, ratio)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mask_ratio=ratio)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    assert int(got["mask"].sum()) == 2 * (L - int(L * (1 - ratio)))
    for k in ("recon_loss", "logits"):
        _assert_f32_close(got[k].numpy(), ref[k], k)


def test_pretraining_bf16_error_within_twice_jax(monkeypatch, shared_noise):
    jm, tm = _pretrain_pair("bfloat16", monkeypatch)
    x = _clip(6)
    params = _params("pretrain")
    ref = _jax_pretrain(jm, params, x, 0.9)
    _f32_jax(monkeypatch)
    truth = _jax_pretrain(jvmae.VideoMAEForPreTraining(config=BACKBONE),
                          params, x, 0.9)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mask_ratio=0.9)
    for k in ("recon_loss", "logits"):
        t = np.asarray(truth[k], np.float32)
        err_jax = np.abs(np.asarray(ref[k], np.float32) - t).max()
        err_port = np.abs(got[k].float().numpy() - t).max()
        assert err_port <= 2 * err_jax + 1e-3, (k, err_port, err_jax)


def test_pretraining_gradients_match_jax(monkeypatch, shared_noise):
    jm, tm = _pretrain_pair("float32", monkeypatch)
    x = _clip(7)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: _jax_pretrain(jm, p, x, 0.75)["recon_loss"]))(
            _params("pretrain"))
    gj = flax_to_torch(jax.device_get(gj))
    named = dict(tm.named_parameters())
    loss = tm(torch.from_numpy(x), mask_ratio=0.75)["recon_loss"]
    grads = torch.autograd.grad(loss, list(named.values()))
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-5)
    for (k, _), g in zip(named.items(), grads):
        ref = gj[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max() + 1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("hf_compat", [True, False])
def test_probe_f32_matches_jax(hf_compat, monkeypatch):
    """Trial video -> preprocess -> backbone -> head, both packages."""
    _f32_jax(monkeypatch)
    cfg = dict(TINY, hf_compat=hf_compat)
    jm = jvmae.VideoMAEProbe(config=cfg)
    params = _params("probe", hf_compat)
    tm = NAME2MODEL["VideoMAE"].from_config(cfg, dtype=torch.float32)
    load_into_model(tm, flax_to_torch(params))
    video = _trial_video(8)
    ref = jax.jit(jm.apply)(params, jnp.asarray(video))
    feats = jax.jit(lambda p, v: jm.apply(p, v, method="encode"))(
        params, jnp.asarray(video))
    with torch.no_grad():
        got = tm(torch.from_numpy(video))
        got_feats = tm.encode(torch.from_numpy(video))
    assert got.shape == (2, 100, 4)
    _assert_f32_close(got_feats.numpy(), feats)
    _assert_f32_close(got.numpy(), ref)


@pytest.mark.parametrize("freeze", [True, False])
def test_probe_backbone_gradient_only_when_unfrozen(freeze):
    """A frozen backbone is encoded without autograd (stop_gradient): no
    backbone leaf is reached and the features carry no graph; unfrozen,
    every leaf gets a gradient."""
    tm = tvmae.VideoMAEProbe(dict(TINY, freeze_backbone=freeze))
    tm.reset_parameters(torch.Generator().manual_seed(0))
    assert tm.frozen_param_paths() == (("video_mae",) if freeze else ())
    video = torch.from_numpy(_trial_video(9))
    assert tm.encode(video).requires_grad != freeze
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((tm(video) ** 2).sum(), list(named.values()),
                                allow_unused=True)
    for k, g in zip(named, grads):
        assert (g is None) == (freeze and k.startswith("video_mae.")), k


def test_remat_is_identical(monkeypatch, shared_noise):
    _, plain = _pretrain_pair("float32", monkeypatch)
    remat = tvmae.VideoMAEForPreTraining(dict(BACKBONE, remat=True),
                                         dtype=torch.float32)
    load_into_model(remat, flax_to_torch(_params("pretrain")))
    x = torch.from_numpy(_clip(10))
    a, b = plain(x)["recon_loss"], remat(x)["recon_loss"]
    assert torch.equal(a, b)
    ga = torch.autograd.grad(a, list(plain.parameters()))
    gb = torch.autograd.grad(b, list(remat.parameters()))
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.parametrize("kind", ["probe", "pretrain"])
def test_converter_round_trips_trees(kind):
    """flax tree -> the port's flat dict -> flax tree, bitwise, with a bf16
    leaf kept bf16 (the SR store)."""
    params = jax.tree.map(np.asarray, _params(kind))
    if kind == "probe":
        params["params"]["encoder_head"]["kernel"] = params["params"][
            "encoder_head"]["kernel"].astype(jnp.bfloat16)
    back = torch_to_flax(flax_to_torch(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# HF weight import and the graft
# ---------------------------------------------------------------------------

def _hf_state_dict(hidden=32, layers=2, mlp=64, prefix="", seed=11):
    """An HF VideoMAE state dict (names, (out, in) layouts) from numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {"embeddings.patch_embeddings.projection.weight": w(hidden, 3, 2, 8, 8),
          "embeddings.patch_embeddings.projection.bias": w(hidden)}
    for i in range(layers):
        b = f"encoder.layer.{i}."
        sd.update({
            b + "attention.attention.query.weight": w(hidden, hidden),
            b + "attention.attention.key.weight": w(hidden, hidden),
            b + "attention.attention.value.weight": w(hidden, hidden),
            b + "attention.attention.q_bias": w(hidden),
            b + "attention.attention.v_bias": w(hidden),
            b + "attention.output.dense.weight": w(hidden, hidden),
            b + "attention.output.dense.bias": w(hidden),
            b + "layernorm_before.weight": w(hidden),
            b + "layernorm_before.bias": w(hidden),
            b + "layernorm_after.weight": w(hidden),
            b + "layernorm_after.bias": w(hidden),
            b + "intermediate.dense.weight": w(mlp, hidden),
            b + "intermediate.dense.bias": w(mlp),
            b + "output.dense.weight": w(hidden, mlp),
            b + "output.dense.bias": w(hidden)})
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["", "videomae."])
def test_convert_hf_equals_jax(prefix):
    sd = _hf_state_dict(prefix=prefix)
    ref = jhf.convert_hf_videomae(sd, num_layers=2, prefix=prefix)
    ref = {".".join(p.key for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = thf.convert_hf_videomae(torch_sd, num_layers=2, prefix=prefix)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the key bias is pinned to zero
    qkv_b = got["encoder.Block_0.SelfAttention_0.qkv.bias"]
    assert not qkv_b[32:64].any() and qkv_b[:32].any()


def _probe_params(hf_compat=True):
    return {k: v.detach() for k, v in tvmae.VideoMAEProbe(
        dict(TINY, hf_compat=hf_compat)).named_parameters()}


def test_graft_rejects_mismatched_trees():
    with pytest.raises(KeyError):
        thf.convert_hf_videomae({"bogus": np.zeros(3)}, num_layers=1)
    backbone = thf.convert_hf_videomae(_hf_state_dict(), num_layers=2)
    with pytest.raises(ValueError, match="does not match"):
        thf.graft_backbone_into_probe(_probe_params(), {"patch_embed": {}})
    with pytest.raises(ValueError, match="does not match"):   # final LN
        thf.graft_backbone_into_probe(_probe_params(hf_compat=False),
                                      backbone)
    bad = dict(backbone, **{"patch_embed.Conv_0.bias": np.zeros(31)})
    with pytest.raises(ValueError, match="shape mismatch"):
        thf.graft_backbone_into_probe(_probe_params(), bad)


def test_load_pretrained_file_kinds(tmp_path):
    """An HF state dict as .pt and as .npz fills the probe backbone with the
    converted weights (cast to the probe leaf's dtype); a directory raises
    and names the route through convert.py."""
    sd = _hf_state_dict(prefix="videomae.")
    want = thf.convert_hf_videomae(sd, num_layers=2, prefix="videomae.")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "hf.bin")
    np.savez(tmp_path / "hf.npz", **sd)
    params = _probe_params()
    params["video_mae.encoder.Block_1.Dense_0.kernel"] = params[
        "video_mae.encoder.Block_1.Dense_0.kernel"].to(torch.bfloat16)
    for name in ("hf.bin", "hf.npz"):
        out = thf.load_pretrained_into_probe(params, str(tmp_path / name))
        assert out.keys() == params.keys()
        for k, v in want.items():
            got = out["video_mae." + k]
            assert got.dtype == params["video_mae." + k].dtype, k
            assert torch.equal(got, torch.from_numpy(v).to(got.dtype)), k
        assert out["encoder_head.kernel"] is params["encoder_head.kernel"]
    with pytest.raises(ValueError, match="convert.py"):
        thf.load_pretrained_into_probe(params, str(tmp_path))
