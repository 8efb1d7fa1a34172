"""Multi-head self-attention over (B, S, H, D) inputs.

Counterpart of ``video_spike_tpu/ops/attention.py:attention_bshd``, as plain
torch ops. The JAX function asks XLA for f32 scores from bf16 inputs
(``preferred_element_type=float32``); a torch bf16 matmul would round the
scores to bf16 first, so q and k are upcast instead (each bf16×bf16 product
is exact in f32, and the sum accumulates in f32). The probabilities are cast
to v's dtype, and P·V is again formed from the upcast operands with f32
accumulation, so the result is f32 whatever the input dtype, as in JAX.

``F.scaled_dot_product_attention`` is deliberately not used: its score
precision and its choice of kernel are not the JAX function's.
"""

from __future__ import annotations

import numpy as np
import torch


def attention_bshd(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D)) v over (B, S, H, D) inputs -> (B, S, H, D)
    float32; the softmax is in f32."""
    # 1 / sqrt(D) rounded as JAX forms it, in float32
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    qh = q.permute(0, 2, 1, 3).float()                 # (B, H, S, D)
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), vh.float())
    return out.permute(0, 2, 1, 3)
