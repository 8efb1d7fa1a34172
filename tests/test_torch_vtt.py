"""PyTorch port of the VTT flagship (``models/vtt.py``, the ``vit_mae``
blocks it uses) against the JAX package.

The same numpy inputs, made from a seed, go through both models; the port
starts from the JAX parameters through ``video_spike_torch.convert``. The
small shape is ``tests/test_multisession.py``'s: patch 8, hidden 32, 2
heads, MLP 64, depth 1/1 (and one case at 2/2), 32×32 video, T = 12,
stride 2, 2 sessions of up to 9 neurons. Tolerances:

- position tables and the resample init: exactly equal;
- model dtype float32: rtol 1e-5, atol 1e-6 (matmul summation order);
- model dtype bfloat16: the JAX float32 model on the same params is the
  truth; the port's max abs error against it is at most twice the JAX
  bf16 model's, plus 1e-3;
- gradients of ``masked_poisson_nll`` w.r.t. every parameter, float32:
  rtol 1e-4, atol 1e-6;
- ``remat`` against no remat, and the matmul patchify against the conv
  path in float32: identical outputs and gradients / rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_spike_tpu.models import vit_mae as jvit
from video_spike_tpu.models import vtt as jvtt
from video_spike_tpu.train.multisession import masked_poisson_nll as j_nll
from video_spike_torch.convert import flax_to_torch, load_into_model
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.models import vit_mae as tvit
from video_spike_torch.models import vtt as tvtt
from video_spike_torch.train.multisession import masked_poisson_nll as t_nll

torch.set_num_threads(1)

TINY = dict(n_sessions=2, max_neurons=9, t_frames=12, t_bins=10,
            patch_size=8, hidden_size=32, frame_depth=1, temporal_depth=1,
            num_attention_heads=2, intermediate_size=64, frame_stride=2)
PRODUCTION = dict(n_sessions=5, max_neurons=668, t_frames=120, t_bins=100,
                  patch_size=16, hidden_size=512, frame_depth=2,
                  temporal_depth=2, num_attention_heads=2,
                  intermediate_size=1024, frame_stride=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {
    "base": {},
    "depth2": dict(frame_depth=2, temporal_depth=2),
    "stride1": dict(frame_stride=1),
    "pool_before_norm": dict(pool_before_norm=True),
    "conv_patchify": dict(matmul_patchify=False),
}


def _inputs(seed=0, b=3, t=12):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 255, (b, t, 1, 32, 32), dtype=np.uint8)
    sids = np.array([0, 1, 0][:b], np.int32)
    return video, sids


def _pair(cfg, dtype):
    """(JAX model, its params as numpy, the port model holding them)."""
    jd, td = DTYPES[dtype]
    jm = jvtt.VideoTemporalTransformer.from_config(cfg).clone(dtype=jd)
    video, sids = _inputs()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(video), jnp.asarray(sids)))
    tm = tvtt.VideoTemporalTransformer.from_config(cfg, dtype=td)
    load_into_model(tm, flax_to_torch(params))
    return jm, params, tm


def _port_out(tm, video, sids):
    with torch.no_grad():
        return tm(torch.from_numpy(video),
                  torch.from_numpy(sids.astype(np.int64))).numpy()


# ---------------------------------------------------------------------------
# tables, init, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,grid", [(32, 4), (512, 8), (64, 7)])
def test_sincos_tables_equal(dim, grid):
    for cls in (True, False):
        np.testing.assert_array_equal(
            tvit.sincos_pos_embed_2d(dim, grid, cls),
            jvit.sincos_pos_embed_2d(dim, grid, cls))
    np.testing.assert_array_equal(tvit.sincos_pos_embed_1d(dim, 60),
                                  jvit.sincos_pos_embed_1d(dim, 60))


@pytest.mark.parametrize("frames,bins", [(60, 100), (6, 10), (120, 100)])
def test_time_resample_init_equal(frames, bins):
    np.testing.assert_array_equal(tvtt.time_resample_init(frames, bins),
                                  jvtt.time_resample_init(frames, bins))


def test_production_tree_matches_jax():
    """At the production width (5 sessions x 668 neurons) the port holds
    the flax tree's names and shapes: 10,264,188 parameters."""
    jm = jvtt.VideoTemporalTransformer.from_config(PRODUCTION)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 120, 1, 128, 128), jnp.uint8),
        jax.ShapeDtypeStruct((1,), jnp.int32))
    ref = {".".join(p.key for p in path[1:]): tuple(v.shape)
           for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tm = NAME2MODEL["VideoTransformer"].from_config(PRODUCTION)
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == ref
    assert sum(p.numel() for p in tm.parameters()) == 10_264_188


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def test_patchify_matmul_equals_conv():
    """The matmul patchify and the conv path read the same Conv_0 kernel
    and agree (float32: rtol 1e-5; bfloat16: within 2e-3, as the JAX
    package's test holds its two paths)."""
    video, sids = _inputs(1)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-3)):
        td = DTYPES[dtype][1]
        mm = tvtt.VideoTemporalTransformer.from_config(TINY, dtype=td)
        mm.reset_parameters(torch.Generator().manual_seed(0))
        conv = tvtt.VideoTemporalTransformer.from_config(
            dict(TINY, matmul_patchify=False), dtype=td)
        load_into_model(conv, dict(mm.named_parameters()))
        np.testing.assert_allclose(_port_out(conv, video, sids),
                                   _port_out(mm, video, sids),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_block_matches_jax(dtype, in_dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x32 = rng.normal(size=(3, 16, 32)).astype(np.float32)
    jb = jvit.Block(32, 2, 64, jd)
    xj = jnp.asarray(x32).astype(DTYPES[in_dtype][0])
    params = jax.device_get(jb.init(jax.random.PRNGKey(1), xj))
    tb = tvit.Block(32, 2, 64, td)
    load_into_model(tb, flax_to_torch(params))
    with torch.no_grad():
        got = tb(torch.from_numpy(x32).to(DTYPES[in_dtype][1]))
    ref = jb.apply(params, xj)
    assert got.dtype == DTYPES[str(ref.dtype)][1]
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
        return
    truth = np.asarray(jvit.Block(32, 2, 64, jnp.float32).apply(params, xj))
    err_jax = np.abs(np.asarray(ref, np.float32) - truth).max()
    err_port = np.abs(got - truth).max()
    assert err_port <= 2 * err_jax + 1e-3, (err_port, err_jax)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_vtt_forward_f32_matches_jax(variant):
    cfg = dict(TINY, **VARIANTS[variant])
    jm, params, tm = _pair(cfg, "float32")
    video, sids = _inputs(3)
    ref = np.asarray(jm.apply(params, jnp.asarray(video), jnp.asarray(sids)))
    got = _port_out(tm, video, sids)
    assert got.shape == ref.shape == (3, 10, 9)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["base", "depth2", "pool_before_norm"])
def test_vtt_forward_bf16_error_within_twice_jax(variant):
    cfg = dict(TINY, **VARIANTS[variant])
    jm, params, tm = _pair(cfg, "bfloat16")
    video, sids = _inputs(4)
    args = (jnp.asarray(video), jnp.asarray(sids))
    truth = np.asarray(jm.clone(dtype=jnp.float32).apply(params, *args))
    err_jax = np.abs(np.asarray(jm.apply(params, *args)) - truth).max()
    err_port = np.abs(_port_out(tm, video, sids) - truth).max()
    assert err_port <= 2 * err_jax + 1e-3, (err_port, err_jax)


# ---------------------------------------------------------------------------
# gradients and remat
# ---------------------------------------------------------------------------

def _targets(seed=5, b=3):
    rng = np.random.default_rng(seed)
    ap = rng.poisson(1.0, (b, 10, 9)).astype(np.float32)
    nmask = np.ones((b, 9), np.float32)
    nmask[1, 6:] = 0.0                  # the 6-neuron session's padding
    return ap, nmask


def _port_grads(tm, video, sids, ap, nmask, n_valid):
    named = dict(tm.named_parameters())
    out = tm(torch.from_numpy(video), torch.from_numpy(sids.astype(np.int64)))
    loss = t_nll(out, torch.from_numpy(ap), torch.from_numpy(nmask), n_valid)
    return loss, dict(zip(named, torch.autograd.grad(loss,
                                                     list(named.values()))))


@pytest.mark.parametrize("variant", ["base", "depth2"])
def test_gradients_match_jax(variant):
    cfg = dict(TINY, **VARIANTS[variant])
    jm, params, tm = _pair(cfg, "float32")
    video, sids = _inputs(6)
    ap, nmask = _targets()

    def loss_fn(p):
        return j_nll(jm.apply(p, jnp.asarray(video), jnp.asarray(sids)),
                     jnp.asarray(ap), jnp.asarray(nmask), jnp.float32(2))

    loss_j, g_j = jax.value_and_grad(loss_fn)(params)
    g_j = flax_to_torch(jax.device_get(g_j))
    loss_t, g_t = _port_grads(tm, video, sids, ap, nmask, 2)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert g_t.keys() == g_j.keys()
    for k, g in g_t.items():
        np.testing.assert_allclose(g.numpy(), g_j[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_remat_is_identical():
    _, params, plain = _pair(TINY, "float32")
    remat = tvtt.VideoTemporalTransformer.from_config(
        dict(TINY, remat=True), dtype=torch.float32)
    load_into_model(remat, flax_to_torch(params))
    video, sids = _inputs(7)
    ap, nmask = _targets(8)
    loss_a, g_a = _port_grads(plain, video, sids, ap, nmask, 3)
    loss_b, g_b = _port_grads(remat, video, sids, ap, nmask, 3)
    assert torch.equal(loss_a, loss_b)
    for k in g_a:
        assert torch.equal(g_a[k], g_b[k]), k


def test_sessions_use_their_own_heads():
    _, _, tm = _pair(TINY, "float32")
    video, _ = _inputs(9)
    out0 = _port_out(tm, video, np.zeros(3, np.int32))
    out1 = _port_out(tm, video, np.ones(3, np.int32))
    assert not np.allclose(out0, out1)
    with pytest.raises(ValueError, match="frames"):
        _port_out(tm, video[:, :10], np.zeros(3, np.int32))
