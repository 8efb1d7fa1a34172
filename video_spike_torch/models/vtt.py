"""Video Temporal Transformer (VTT): video (B, T, 1, H, W) -> per-session
log-rates (B, T_bins, N_max), the multi-session flagship.

Counterpart of ``video_spike_tpu/models/vtt.py``:

- a shared per-frame ViT (``FrameEncoder``): stride-P patchify, a 2-D sin-cos
  table, spatial blocks over the (B·T, tokens, D) frame batch, an f32
  LayerNorm (eps 1e-6) and a mean over tokens (``pool_before_norm`` swaps
  the last two, an architectural variant);
- a temporal transformer over the (B, T, D) frame embeddings with a 1-D
  sin-cos table and an f32 ``temporal_norm``;
- a learned f32 time resampling from the T encoded frames (``frame_stride``
  keeps every k-th) to the spike bins, initialised to linear interpolation;
- per-session heads stacked as (S, D, N_max) + (S, N_max), gathered by each
  trial's session id, applied as an f32 batched matmul.

The patchify keeps flax's ``Conv_0`` (P, P, C, D) kernel and reads it as a
(P²C, D) matrix, patch pixels flattened in (h, w, c) order after the
NCHW -> NHWC transpose (``matmul_patchify``, the default); with
``matmul_patchify=False`` the same kernel goes through ``F.conv2d``. Input
pixels go uint8 -> f32 / 255 -> the compute dtype, in that order.

``remat`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``, non-reentrant); numerics and parameters are the
same either way. Parameters are f32; init draws from the caller's
``torch.Generator`` (the values differ from flax's init, the distributions
do not).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_spike_torch.models.linear import lecun_normal_
from video_spike_torch.models.vit_mae import (
    Block,
    LayerNorm,
    PosTable,
    sincos_pos_embed_1d,
    sincos_pos_embed_2d,
)


def time_resample_init(t_frames: int, t_bins: int) -> np.ndarray:
    """(T_frames, T_bins) linear-interpolation matrix (learned from there)."""
    M = np.zeros((t_frames, t_bins), dtype=np.float32)
    src = np.linspace(0, t_frames - 1, t_bins)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, t_frames - 1)
    frac = src - lo
    for j in range(t_bins):
        M[lo[j], j] += 1 - frac[j]
        M[hi[j], j] += frac[j]
    return M


def _run_blocks(blocks, x: torch.Tensor, remat: bool) -> torch.Tensor:
    for blk in blocks:
        x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
    return x


class Patchify(nn.Module):
    """Stride-P patch embedding on an NHWC input -> (N, tokens, D) in the
    compute dtype; parameters ``kernel`` (P, P, C, D) and ``bias`` (D,)."""

    def __init__(self, features: int, patch: int, channels: int = 1,
                 dtype=torch.bfloat16, matmul: bool = True, device=None):
        super().__init__()
        self.features, self.patch, self.dtype = features, patch, dtype
        self.matmul = matmul
        self.kernel = nn.Parameter(torch.empty(
            patch, patch, channels, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        p, _, c, _ = self.kernel.shape
        lecun_normal_(self.kernel, p * p * c, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, H, W, c = x.shape
        p, d = self.patch, self.features
        kernel = self.kernel.to(self.dtype)
        if self.matmul:
            patches = x.reshape(n, H // p, p, W // p, p, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, (H // p) * (W // p), p * p * c)
            y = patches @ kernel.reshape(p * p * c, d)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                         stride=p)                       # (N, D, h, w)
            y = y.permute(0, 2, 3, 1).reshape(n, -1, d)
        return y + self.bias.to(self.dtype)


class FrameEncoder(nn.Module):
    """Shared per-frame ViT: patchify -> spatial blocks -> (N, D) f32."""

    def __init__(self, patch_size: int = 16, hidden: int = 256,
                 depth: int = 4, heads: int = 4, mlp_dim: int = 512,
                 dtype=torch.bfloat16, remat: bool = False,
                 matmul_patchify: bool = True,
                 pool_before_norm: bool = False, channels: int = 1,
                 device=None):
        super().__init__()
        self.hidden, self.dtype, self.depth = hidden, dtype, depth
        self.remat = remat
        self.pool_before_norm = pool_before_norm
        self.Conv_0 = Patchify(hidden, patch_size, channels, dtype,
                               matmul_patchify, device)
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(hidden, heads, mlp_dim,
                                                dtype, device=device))
        self.LayerNorm_0 = LayerNorm(hidden, 1e-6, torch.float32, device)
        self._pos = PosTable(partial(self._table, hidden))

    @staticmethod
    def _table(hidden: int, grid: int) -> np.ndarray:
        return sincos_pos_embed_2d(hidden, grid, cls_token=False)

    def blocks(self):
        return [getattr(self, f"Block_{i}") for i in range(self.depth)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.Conv_0.reset_parameters(generator)
        for blk in self.blocks():
            blk.reset_parameters(generator)
        self.LayerNorm_0.reset_parameters()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        # frames: (N, C, H, W) -> (N, D)
        x = self.Conv_0(frames.permute(0, 2, 3, 1).to(self.dtype))
        grid = int(np.sqrt(x.shape[1]))
        x = x + self._pos.get(grid, x.device).to(x.dtype)
        x = _run_blocks(self.blocks(), x, self.remat)
        if self.pool_before_norm:
            return self.LayerNorm_0(x.float().mean(dim=1))
        return self.LayerNorm_0(x).mean(dim=1)


class VideoTemporalTransformer(nn.Module):
    """Video (B, T, 1, H, W) -> per-session log-rates (B, T_bins, N_max)."""

    def __init__(self, n_sessions: int, max_neurons: int,
                 t_frames: int = 120, t_bins: int = 100,
                 patch_size: int = 16, hidden: int = 256,
                 frame_depth: int = 4, temporal_depth: int = 4,
                 heads: int = 4, mlp_dim: int = 512, dtype=torch.bfloat16,
                 frame_stride: int = 1, remat: bool = False,
                 matmul_patchify: bool = True,
                 pool_before_norm: bool = False, device=None):
        super().__init__()
        self.n_sessions, self.max_neurons = n_sessions, max_neurons
        self.t_frames, self.t_bins = t_frames, t_bins
        self.hidden, self.dtype = hidden, dtype
        self.temporal_depth = temporal_depth
        self.frame_stride, self.remat = frame_stride, remat
        # encoded frames per trial after the stride (the resample's rows)
        self.t_encoded = len(range(0, t_frames, frame_stride))
        self.frame_encoder = FrameEncoder(
            patch_size, hidden, frame_depth, heads, mlp_dim, dtype,
            remat=remat, matmul_patchify=matmul_patchify,
            pool_before_norm=pool_before_norm, device=device)
        for i in range(temporal_depth):
            self.add_module(f"Block_{i}", Block(hidden, heads, mlp_dim,
                                                dtype, device=device))
        self.temporal_norm = LayerNorm(hidden, 1e-6, torch.float32, device)
        self.time_resample = nn.Parameter(torch.empty(
            self.t_encoded, t_bins, device=device))
        self.session_heads = nn.Parameter(torch.empty(
            n_sessions, hidden, max_neurons, device=device))
        self.session_bias = nn.Parameter(torch.empty(
            n_sessions, max_neurons, device=device))
        self._pos = PosTable(partial(sincos_pos_embed_1d, hidden))

    @classmethod
    def from_config(cls, config, device=None,
                    dtype=torch.bfloat16) -> "VideoTemporalTransformer":
        return cls(
            n_sessions=config["n_sessions"],
            max_neurons=config["max_neurons"],
            t_frames=config.get("t_frames", 120),
            t_bins=config.get("t_bins", 100),
            patch_size=config.get("patch_size", 16),
            hidden=config.get("hidden_size", 256),
            frame_depth=config.get("frame_depth", 4),
            temporal_depth=config.get("temporal_depth", 4),
            heads=config.get("num_attention_heads", 4),
            mlp_dim=config.get("intermediate_size", 512),
            dtype=dtype,
            frame_stride=config.get("frame_stride", 1),
            remat=bool(config.get("remat", False)),
            matmul_patchify=bool(config.get("matmul_patchify", True)),
            pool_before_norm=bool(config.get("pool_before_norm", False)),
            device=device,
        )

    def blocks(self):
        return [getattr(self, f"Block_{i}")
                for i in range(self.temporal_depth)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``init``'s distributions: lecun_normal kernels, zero biases,
        unit LayerNorm scales, normal(0.02) heads, zero head biases, the
        linear-interpolation resample."""
        self.frame_encoder.reset_parameters(generator)
        for blk in self.blocks():
            blk.reset_parameters(generator)
        self.temporal_norm.reset_parameters()
        with torch.no_grad():
            self.time_resample.copy_(torch.from_numpy(
                time_resample_init(self.t_encoded, self.t_bins)))
            self.session_heads.normal_(0.0, 0.02, generator=generator)
            self.session_bias.zero_()

    def forward(self, video: torch.Tensor,
                session_ids: torch.Tensor) -> torch.Tensor:
        """video: (B, T, 1, H, W) uint8 or float; session_ids: (B,) ints."""
        if self.frame_stride > 1:
            video = video[:, ::self.frame_stride]
        B, T = video.shape[:2]
        if T != self.t_encoded:
            raise ValueError(f"video has {T} frames after stride "
                             f"{self.frame_stride}; the model was built for "
                             f"{self.t_encoded} (t_frames={self.t_frames})")
        x = video.float() / 255.0
        emb = self.frame_encoder(x.reshape(B * T, *x.shape[2:]))
        h = emb.reshape(B, T, self.hidden)
        h = h + self._pos.get(T, h.device).to(h.dtype)
        h = self.temporal_norm(_run_blocks(self.blocks(), h, self.remat))
        # learned time resampling (encoded frames -> spike bins), f32
        h = torch.einsum("btd,tz->bzd", h, self.time_resample)
        Wb = self.session_heads[session_ids]              # (B, D, N_max)
        bb = self.session_bias[session_ids]               # (B, N_max)
        return torch.bmm(h.float(), Wb) + bb[:, None, :]
