"""Multi-head self-attention over (B, S, H, D) inputs.

Counterpart of ``video_spike_tpu/ops/attention.py:attention_bshd``.
``attention_bshd`` routes by what it is given:

- CUDA bf16 inputs: the hand-written fused kernels
  ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``, as
  the operator ``vst::flash_attention`` (its backward is
  ``vst::flash_attention_backward``), for the head dims in ``HEAD_DIMS``;
  any other head dim, or k and v that do not match q, raises. There is no
  fallback. ``torch.export`` keeps the op (its fake implementation gives
  the shapes), so an exported program launches the kernels too, once this
  module is imported to register the op. Each forward adds one to
  ``attention_bshd.launches``, each backward one to
  ``attention_bshd.backward_launches``.
- everything else, CPU tensors and f32 inputs: ``attention_torch``, the
  torch expression, which is the JAX-parity and exact-f32 path.

``attention_torch`` computes as the JAX function does. JAX asks XLA for f32
scores from bf16 inputs (``preferred_element_type=float32``); a torch bf16
matmul would round the scores to bf16 first, so q and k are upcast instead
(each bf16×bf16 product is exact in f32, and the sum accumulates in f32).
The probabilities are cast to v's dtype, and P·V is again formed from the
upcast operands with f32 accumulation, so the result is f32 whatever the
input dtype, as in JAX. ``F.scaled_dot_product_attention`` is deliberately
not used: its score precision and its choice of kernel are not the JAX
function's.

The kernels keep that contract, bf16 operands with f32 accumulation, f32
scale, softmax and output, and round at two points of their own:

- forward: P is rounded to bf16 before P·V as the online softmax's
  unnormalised ``exp(s - m)``, and the f32 sum divides at the end (the
  expression rounds the normalised P: the same precision, another point);
- backward: dS = P ∘ (dP - Δ), Δ = rowsum(dO ∘ O), is rounded to bf16 before
  the dQ and dK products (the expression keeps it f32); dO is taken in bf16
  (the port's dO arrives bf16-valued through the output projection's cast).

``flash_attention_plain`` and ``flash_attention_plain_backward`` repeat the
kernels' arithmetic in plain torch, blocked online softmax included; only
the tests and ``chip_smoke.py`` call them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# head dims the kernels are instantiated for (csrc/flash_attention.cuh:
# Tiles): ViT-MAE's encoder, VideoMAE and the probe's backbone (64), the
# ViT-MAE decoder of the SSL recipe (512 / 16 = 32), the VTT (256)
HEAD_DIMS = (32, 64, 256)
# key rows a block of the plain version's online softmax
PLAIN_BLOCK = 64

_P = ctypes.c_void_p


def _scale(d: int) -> float:
    """1 / sqrt(D) rounded as JAX forms it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def attention_torch(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The torch expression: softmax(q kᵀ / sqrt(D)) v over (B, S, H, D)
    inputs -> (B, S, H, D) float32; the softmax is in f32."""
    scale = _scale(q.shape[-1])
    qh = q.permute(0, 2, 1, 3).float()                 # (B, H, S, D)
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), vh.float())
    return out.permute(0, 2, 1, 3)


def check_kernel_shapes(q_shape, k_shape, v_shape) -> None:
    """Raise ``ValueError`` unless the kernels take these (B, S, H, D)
    shapes: one shape for q, k and v, and a head dim in ``HEAD_DIMS``."""
    shapes = tuple(tuple(s) for s in (q_shape, k_shape, v_shape))
    if len(shapes[0]) != 4 or any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(f"attention_bshd kernel: q, k, v must share one "
                         f"(B, S, H, D) shape, got {shapes}")
    if shapes[0][-1] not in HEAD_DIMS:
        raise ValueError(f"attention_bshd kernel: head dim {shapes[0][-1]} "
                         f"has no instantiation (head dims {HEAD_DIMS})")


def _takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True for CUDA bf16 inputs the kernels take; False for the torch
    expression's inputs; raises for CUDA bf16 inputs they do not take."""
    if not (q.is_cuda and q.dtype == torch.bfloat16):
        return False
    check_kernel_shapes(q.shape, k.shape, v.shape)
    if (k.dtype, v.dtype) != (q.dtype, q.dtype) or not (
            k.device == v.device == q.device):
        raise ValueError(f"attention_bshd kernel: q, k, v must be bf16 on "
                         f"one card, got {q.dtype}/{k.dtype}/{v.dtype} on "
                         f"{q.device}/{k.device}/{v.device}")
    return True


def attention_bshd(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over (B, S, H, D) inputs -> (B, S, H, D)
    float32; the softmax is in f32. Routed as the module's docstring says."""
    if _takes_kernel(q, k, v):
        return flash_attention(q, k, v)[0]
    return attention_torch(q, k, v)


attention_bshd.launches = 0
attention_bshd.backward_launches = 0


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# (source, entry point, its argtypes) of each kernel's C interface
_KERNELS = {
    "forward": ("flash_attention_fwd.cu", "vst_flash_attention_fwd",
                [ctypes.c_int, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                 _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, _P]),
    "backward": ("flash_attention_bwd.cu", "vst_flash_attention_bwd",
                 [ctypes.c_int, _P, _P, _P,
                  ctypes.POINTER(ctypes.c_longlong), *[_P] * 9, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_float, _P]),
}


def _entry_points(which: str) -> tuple:
    """(the launch function, the attributes function) of the ``forward``
    or ``backward`` kernel, built and loaded at first use."""
    from video_spike_torch.ops import cuda_lib

    source, symbol, args = _KERNELS[which]
    lib = cuda_lib.load(source)
    fn, attrs = getattr(lib, symbol), getattr(lib, f"{symbol}_attrs")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = args, ctypes.c_int
        attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        attrs.restype = ctypes.c_int
    return fn, attrs


def kernel_attributes(d: int) -> dict:
    """Registers, spill (local) bytes a thread, dynamic shared bytes and
    threads a block of the forward and the backward kernel at head dim
    ``d``, as the card's runtime reports them."""
    out = {}
    for name in _KERNELS:
        vals = (ctypes.c_int * 4)()
        err = _entry_points(name)[1](d, vals)
        if err:
            raise RuntimeError(f"flash attention {name} attributes at head "
                               f"dim {d}: cudaError {err}")
        out[name] = dict(zip(("registers", "spill_bytes", "smem_bytes",
                              "threads"), vals))
    return out


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernels read it in place (a contiguous last
    dim, 16-byte aligned, strides a multiple of 8 elements, as the packed
    qkv projection's views are), else a contiguous copy."""
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(s % 8 for s in x.stride()[:3])):
        return x.contiguous()
    return x


def _strides(*xs):
    return (ctypes.c_longlong * 9)(*(s for x in xs for s in x.stride()[:3]))


# The kernels as operators of their own, so that ``torch.export`` keeps
# them: declared through ``torch.library.Library``, whose kernels are called
# as they are (``torch.library.custom_op`` wraps each call in a guard that
# imports ``torch._dynamo`` at the first one, seconds of set-up a process)
_LIB = torch.library.Library("vst", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v) -> "
            "(Tensor, Tensor)")
_LIB.define("flash_attention_backward(Tensor q, Tensor k, Tensor v, "
            "Tensor out, Tensor lse, Tensor dout) -> (Tensor, Tensor, Tensor)")


def _forward(q, k, v):
    """The forward kernel on CUDA bf16 (B, S, H, D) inputs: ``(out, lse)``,
    out (B, S, H, D) f32 and the rows' log-sum-exp (B, H, S) f32."""
    q, k, v = map(_kernel_view, (q, k, v))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel():
        launch = _entry_points("forward")[0]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = launch(
                d, q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
                out.data_ptr(), lse.data_ptr(), b, s, h, _scale(d), stream)
        if err:
            raise RuntimeError(f"flash attention forward launch failed: "
                               f"cudaError {err} (shape {tuple(q.shape)})")
        attention_bshd.launches += 1
    return out, lse


@torch.library.register_fake("vst::flash_attention")
def _(q, k, v):
    check_kernel_shapes(q.shape, k.shape, v.shape)
    b, s, h, d = q.shape
    return (q.new_empty((b, s, h, d), dtype=torch.float32),
            q.new_empty((b, h, s), dtype=torch.float32))


def _backward(q, k, v, out, lse, dout):
    """The backward kernels: ``(dq, dk, dv)`` in bf16, (B, S, H, D)."""
    q, k, v = map(_kernel_view, (q, k, v))
    dout = dout.to(torch.float32).contiguous()
    b, s, h, d = q.shape
    dq, dk, dv, dob = (torch.empty((b, s, h, d), dtype=torch.bfloat16,
                                   device=q.device) for _ in range(4))
    if dq.numel():
        dq_sum = torch.empty((b, s, h, d), dtype=torch.float32,
                             device=q.device)
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        launch = _entry_points("backward")[0]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = launch(
                d, q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
                out.data_ptr(), dout.data_ptr(), dob.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq_sum.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h,
                _scale(d), stream)
        if err:
            raise RuntimeError(f"flash attention backward launch failed: "
                               f"cudaError {err} (shape {tuple(q.shape)})")
        attention_bshd.backward_launches += 1
    return dq, dk, dv


@torch.library.register_fake("vst::flash_attention_backward")
def _(q, k, v, out, lse, dout):
    return tuple(q.new_empty(q.shape) for _ in range(3))


def _save(ctx, inputs, output):
    """Saves q, k, v, the f32 output and the per-row log-sum-exp (f32,
    B·H·S), never an S×S tensor. The log-sum-exp takes no gradient, and
    none is made up for it (no zero fill a backward)."""
    ctx.save_for_backward(*inputs, *output)
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)


def _differentiate(ctx, dout, _dlse):
    return flash_attention_backward(*ctx.saved_tensors, dout)


_LIB.impl("flash_attention", _forward, "CUDA")
_LIB.impl("flash_attention_backward", _backward, "CUDA")
torch.library.register_autograd("vst::flash_attention", _differentiate,
                                setup_context=_save)
flash_attention = torch.ops.vst.flash_attention.default
flash_attention_backward = torch.ops.vst.flash_attention_backward.default


# ---------------------------------------------------------------------------
# the plain version of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D) float32."""
    return x.permute(0, 2, 1, 3).float()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block: int = PLAIN_BLOCK) -> tuple:
    """The forward kernel's arithmetic: ``(out, lse)``, out (B, S, H, D)
    f32 and the rows' log-sum-exp (B, H, S) f32, from the online softmax
    over key blocks of ``block`` with the unnormalised P in bf16."""
    scale = _scale(q.shape[-1])
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    row_max = torch.full(qh.shape[:-1] + (1,), -torch.inf, device=qh.device)
    row_sum = torch.zeros_like(row_max)
    acc = torch.zeros_like(qh)
    for j in range(0, kh.shape[2], block):
        s = torch.matmul(qh, kh[:, :, j:j + block].transpose(-1, -2)) * scale
        new_max = torch.maximum(row_max, s.amax(-1, keepdim=True))
        alpha = torch.exp(row_max - new_max)
        p = torch.exp(s - new_max)
        row_sum = row_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                         vh[:, :, j:j + block])
        row_max = new_max
    out = acc / row_sum
    lse = (row_max + torch.log(row_sum)).squeeze(-1)
    return out.permute(0, 2, 1, 3), lse


def flash_attention_plain_backward(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor,
                                   dout: torch.Tensor) -> tuple:
    """The backward kernels' arithmetic: ``(dq, dk, dv)`` in bf16, (B, S,
    H, D), from the forward's f32 ``out`` and ``lse`` and the f32 ``dout``:
    P recomputed from the scores and lse, dO and P in bf16 for dV and dP,
    Δ = rowsum(dO ∘ O) and dS = P ∘ (dP - Δ) in f32, dS in bf16 for dQ and
    dK, each product summed in f32."""
    scale = _scale(q.shape[-1])
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    doh, oh = _heads(dout), _heads(out)
    delta = (doh * oh).sum(-1, keepdim=True)
    do16 = doh.to(torch.bfloat16).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), do16)
    dp = torch.matmul(do16, vh.transpose(-1, -2))
    ds = (p * (dp - delta)).to(torch.bfloat16).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for x in (dq, dk, dv))
