"""PyTorch port of ``ops/attention.attention_bshd`` against the JAX package.

The same numpy inputs, made from a seed, go through both functions.
Tolerances:

- f32 inputs: rtol 1e-5, atol 1e-6 (summation order of the two matmuls);
- bf16 inputs: the JAX function on the f32 upcast of the same bf16 values
  is the truth; the port's max abs error against it is at most twice the
  JAX bf16 function's, plus 1e-3.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from video_spike_tpu.ops.attention import attention_bshd as j_attention
from video_spike_torch.convert import to_torch
from video_spike_torch.ops.attention import attention_bshd as t_attention

torch.set_num_threads(1)

# (B, S, H, D): the small VTT frame encoder, its temporal stage, a
# 256-wide head as in the production shape, a ragged sequence
SHAPES = [(6, 16, 2, 16), (3, 6, 2, 16), (2, 8, 2, 256), (2, 13, 4, 8)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_f32_matches_jax(shape):
    q, k, v = _qkv(shape, 0)
    ref = np.asarray(j_attention(*map(jnp.asarray, (q, k, v))))
    got = t_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_bf16_error_within_twice_jax(shape):
    q, k, v = (x.astype(ml_dtypes.bfloat16) for x in _qkv(shape, 1))
    truth = np.asarray(j_attention(*(jnp.asarray(x.astype(np.float32))
                                     for x in (q, k, v))))
    ref = np.asarray(j_attention(*map(jnp.asarray, (q, k, v))))
    got = t_attention(*map(to_torch, (q, k, v)))
    assert got.dtype == torch.float32          # f32 out, as in JAX
    err_jax = np.abs(ref - truth).max()
    err_port = np.abs(got.numpy() - truth).max()
    assert err_port <= 2 * err_jax + 1e-3, (err_port, err_jax)


def test_attention_gradients_match_jax():
    """Gradients of a scalar of the output w.r.t. q, k and v (f32)."""
    import jax

    q, k, v = _qkv((2, 8, 2, 16), 2)
    w = np.random.default_rng(3).normal(size=(2, 8, 2, 16)).astype(np.float32)
    gj = jax.grad(lambda q, k, v: jnp.sum(j_attention(q, k, v) * w),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (t_attention(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    for a, b in zip((qt.grad, kt.grad, vt.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
