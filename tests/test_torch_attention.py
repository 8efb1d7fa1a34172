"""PyTorch port of ``ops/attention.attention_bshd`` against the JAX package.

The same numpy inputs, made from a seed, go through both functions.
Tolerances:

- f32 inputs: rtol 1e-5, atol 1e-6 (summation order of the two matmuls);
- bf16 inputs: the JAX function on the f32 upcast of the same bf16 values
  is the truth; the port's max abs error against it is at most twice the
  JAX bf16 function's, plus 1e-3.

On the CPU ``attention_bshd`` is the torch expression; the fused CUDA
kernels' arithmetic is held here through its plain version (below), and
the kernels themselves in ``tests/test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from video_spike_tpu.ops.attention import attention_bshd as j_attention
from video_spike_torch.convert import to_torch
from video_spike_torch.ops import attention as tatt
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


# ---------------------------------------------------------------------------
# the plain version of the fused kernels' arithmetic, and the routing
#
# ``flash_attention_plain`` / ``flash_attention_plain_backward`` against the
# f32 truth (the torch expression and its autograd gradients on the f32
# upcast of the same bf16 values). Error: max |d| over max |truth|, for the
# output and each gradient. Tolerance: at most twice the torch expression's
# own error on the bf16 inputs (it rounds P, and its gradients come out in
# bf16) plus 2^-8: the kernels round P at another point and dS to bf16 as
# well, each a rounding of the same size as the expression's.
# ---------------------------------------------------------------------------

TWIN_TOL = 2.0**-8


def _bf16_case(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (torch.from_numpy(rng.normal(size=(b, s, h, d))
                                   .astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    return q, k, v, w.float()


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _expression_and_grads(q, k, v, w):
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = tatt.attention_torch(qs, ks, vs)
    (out * w).sum().backward()
    return out.detach(), qs.grad, ks.grad, vs.grad


def _twin_against_truth(b, s, h, d, seed):
    q, k, v, w = _bf16_case(b, s, h, d, seed)
    truth = _expression_and_grads(q.float(), k.float(), v.float(), w)
    expr = _expression_and_grads(q, k, v, w)
    out, lse = tatt.flash_attention_plain(q, k, v)
    grads = tatt.flash_attention_plain_backward(q, k, v, out, lse, w)
    twin = (out, *grads)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, s, h, d)
    assert all(g.dtype == torch.bfloat16 and g.shape == q.shape
               for g in grads)
    for name, got, ex, ref in zip(("out", "dq", "dk", "dv"), twin, expr,
                                  truth):
        err, err_expr = _rel_err(got, ref), _rel_err(ex, ref)
        assert err <= 2 * err_expr + TWIN_TOL, (name, err, err_expr)
    # the rows' log-sum-exp, f32 against the f32 scores'
    qh, kh = (x.permute(0, 2, 1, 3).float() for x in (q, k))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * tatt._scale(d)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(scores, -1).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", tatt.HEAD_DIMS)
@pytest.mark.parametrize("s", [21, 64, 82, 160])
def test_plain_twin_matches_the_f32_expression(s, d):
    _twin_against_truth(2, s, 2, d, seed=10 * s + d)


@pytest.mark.parametrize("d", [32, 64])
def test_plain_twin_matches_the_f32_expression_at_1568_tokens(d):
    """VideoMAE's decoder sequence at a small B·H: 25 key blocks of 64, the
    last one ragged (1,568 = 24.5 blocks)."""
    _twin_against_truth(1, 1568, 1, d, seed=d)


@pytest.mark.parametrize("block", [16, 48, 200])
def test_plain_twin_is_the_same_softmax_at_any_block(block):
    """The online softmax's blocks only move its rounding: a ragged block,
    one wider than the sequence."""
    q, k, v, _ = _bf16_case(2, 82, 2, 32, 5)
    ref, ref_lse = tatt.flash_attention_plain(q, k, v)
    out, lse = tatt.flash_attention_plain(q, k, v, block=block)
    assert _rel_err(out, ref) <= TWIN_TOL
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_inputs_take_the_torch_expression(monkeypatch, dtype):
    q, k, v, _ = _bf16_case(2, 21, 2, 64, 3)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    calls, expression = [], tatt.attention_torch

    def spy(*args):
        calls.append(args)
        return expression(*args)

    monkeypatch.setattr(tatt, "attention_torch", spy)
    before = (tatt.attention_bshd.launches,
              tatt.attention_bshd.backward_launches)
    out = tatt.attention_bshd(q, k, v)
    assert len(calls) == 1 and out.dtype == torch.float32
    assert not tatt._takes_kernel(q, k, v)
    assert (tatt.attention_bshd.launches,
            tatt.attention_bshd.backward_launches) == before


def _traced_targets(dtype, d):
    """The ops ``make_fx`` records when ``attention_bshd`` is traced on fake
    CUDA tensors of ``dtype`` and head dim ``d``, as ``torch.export``
    traces them."""
    with FakeTensorMode():
        q, k, v = (torch.empty((2, 21, 2, d), dtype=dtype, device="cuda")
                   for _ in range(3))
        gm = make_fx(tatt.attention_bshd)(q, k, v)
        out = gm(q, k, v)
    assert out.dtype == torch.float32 and out.shape == q.shape
    return {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_traced_and_f32_cuda_inputs_take_the_torch_expression(dtype):
    """A trace of f32 CUDA inputs holds the exact-f32 expression; a trace
    of bf16 CUDA inputs, as ``torch.export`` makes it, holds the kernel op
    ``vst::flash_attention`` and none of the expression, and raises at an
    uninstantiated head dim as the eager call does."""
    targets = _traced_targets(dtype, 64)
    kernel_op = "vst.flash_attention.default"
    if dtype == torch.float32:
        assert kernel_op not in targets
        assert any("softmax" in t for t in targets)
    else:
        assert kernel_op in targets
        assert not any("softmax" in t or "matmul" in t or "bmm" in t
                       for t in targets)
        with pytest.raises(ValueError, match="head dim 48"):
            _traced_targets(dtype, 48)


def test_an_exported_program_keeps_the_kernel_op(tmp_path):
    """``torch.export`` of the op with a symbolic batch saves and loads back
    with ``vst::flash_attention`` in its graph (the trace runs the op's
    fake implementation only, so this holds on the CPU)."""

    class Heads(torch.nn.Module):
        def forward(self, qkv):
            return tatt.flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                        qkv[:, :, 2])[0]

    qkv = torch.zeros((4, 21, 3, 2, 64), dtype=torch.bfloat16)
    program = torch.export.export(
        Heads(), (qkv,), dynamic_shapes=({0: torch.export.Dim("batch")},))
    torch.export.save(program, str(tmp_path / "heads.pt2"))
    loaded = torch.export.load(str(tmp_path / "heads.pt2"))
    calls = [n for n in loaded.graph.nodes if n.op == "call_function"
             and str(n.target) == "vst.flash_attention.default"]
    assert len(calls) == 1
    out, lse = calls[0].meta["val"]
    assert out.dtype == lse.dtype == torch.float32
    assert tuple(lse.shape[1:]) == (2, 21)


def test_the_kernel_op_differentiates_through_its_backward_op():
    """Autograd of ``vst::flash_attention`` calls
    ``vst::flash_attention_backward`` with the saved q, k, v, output and
    log-sum-exp; the log-sum-exp takes no gradient, and the backward makes
    no (B, H, S) tensor of zeros for it. Run on meta tensors, where both
    ops are their fake implementations."""

    class Shapes(TorchDispatchMode):
        made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.made += [tuple(t.shape) for t in (
                out if isinstance(out, (tuple, list)) else [out])
                if isinstance(t, torch.Tensor)]
            return out

    q, k, v = (torch.empty((2, 82, 4, 32), dtype=torch.bfloat16,
                           device="meta", requires_grad=True)
               for _ in range(3))
    out, lse = tatt.flash_attention(q, k, v)
    assert out.requires_grad and not lse.requires_grad
    assert out.grad_fn is not None
    with Shapes() as seen:
        out.sum().backward()
    assert tuple(lse.shape) == (2, 4, 82) and (2, 4, 82) not in seen.made
    for x in (q, k, v):
        assert x.grad.dtype == torch.bfloat16 and x.grad.shape == q.shape


@pytest.mark.parametrize("d", [16, 48, 128])
def test_an_uninstantiated_head_dim_raises(d):
    shape = (2, 82, 4, d)
    with pytest.raises(ValueError, match=f"head dim {d} has no instantiation"):
        tatt.check_kernel_shapes(shape, shape, shape)


def test_kernel_shapes_must_agree():
    for d in tatt.HEAD_DIMS:
        tatt.check_kernel_shapes(*[(2, 82, 4, d)] * 3)
    with pytest.raises(ValueError, match="share one"):
        tatt.check_kernel_shapes((2, 82, 4, 64), (2, 81, 4, 64),
                                 (2, 82, 4, 64))
    with pytest.raises(ValueError, match="share one"):
        tatt.check_kernel_shapes((82, 4, 64), (82, 4, 64), (82, 4, 64))
