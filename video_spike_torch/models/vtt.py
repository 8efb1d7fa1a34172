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

Tensor sharding over a mesh's ``model`` axis: :func:`vtt_sharding_rules`
is the port of the production rules (``__graft_entry__._vtt_sharding_rules``
in the JAX package) on the port's flat names, and :func:`split_over_model`
makes the model run what they split: each column-split kernel as a
column-split Dense (``parallel/tensor``), and the session heads on this
rank's block of neurons, gathered before the output leaves the model.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn

from video_spike_torch.models.vit_mae import (
    Block,
    LayerNorm,
    Patchify,
    PosTable,
    _run_blocks,
    sincos_pos_embed_1d,
    sincos_pos_embed_2d,
)
from video_spike_torch.parallel.mesh import Placement
from video_spike_torch.parallel.tensor import copy_to_model, gather_last


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


# leaves split on their last (neuron) axis by the production rules
HEAD_LEAVES = ("session_heads", "session_bias")
# a 2-D kernel splits its columns from this output width on
MIN_SPLIT_WIDTH = 256


def vtt_sharding_rules(params, mesh) -> dict:
    """A placement per flat parameter name, the JAX package's production
    rules: a leaf named ``session_heads`` or ``session_bias`` splits its
    last dimension over ``model``; a leaf ending in ``kernel`` with 2
    dimensions whose output width divides the model axis and is at least
    256 splits its columns (dim 1, ``P(None, "model")``); everything else
    is replicated. A head split that does not divide the axis raises when
    the tree is placed (``multihost.put_tree``), as ``jax.device_put``
    does."""
    n = mesh.shape["model"]
    out = {}
    for k, v in params.items():
        names = k.split(".")
        if any(h in names for h in HEAD_LEAVES):
            out[k] = Placement(mesh, "model", v.ndim, v.ndim - 1)
        elif (names[-1] == "kernel" and v.ndim == 2 and v.shape[1] % n == 0
              and v.shape[1] >= MIN_SPLIT_WIDTH):
            out[k] = Placement(mesh, "model", 2, 1)
        else:
            out[k] = Placement(mesh, None, v.ndim)
    return out


def split_over_model(model: nn.Module, placements) -> tuple:
    """Make `model` (a ``VideoTemporalTransformer`` holding, or about to be
    given, the blocks of its split leaves) run the split that `placements`
    fix: each ``Dense`` whose 2-D kernel splits its columns gets the model
    group (its bias must be replicated), and the session heads and biases,
    split on their last axis together, make the forward compute this
    rank's neurons and gather them. Returns the split leaves' names.
    Raises ``NotImplementedError`` for a split the forward does not run."""
    modules = dict(model.named_modules())
    split = tuple(k for k, p in placements.items() if p.axis is not None)
    heads = {k for k in split if k in HEAD_LEAVES}
    if heads and heads != set(HEAD_LEAVES):
        raise NotImplementedError(f"the session heads and biases split "
                                  f"together, not {sorted(heads)} alone")
    for k in split:
        p = placements[k]
        if p.axis != "model":
            raise NotImplementedError(f"{k}: split over {p.axis!r}; the VTT "
                                      f"splits over the model axis only")
        if k in HEAD_LEAVES:
            if p.dim % p.ndim != p.ndim - 1:
                raise NotImplementedError(f"{k}: heads split on the neuron "
                                          f"axis only, not dim {p.dim}")
            continue
        owner, _, leaf = k.rpartition(".")
        bias = f"{owner}.bias"
        if (leaf != "kernel" or p.ndim != 2 or p.dim % 2 != 1
                or owner not in modules or bias not in placements
                or placements[bias].axis is not None):
            raise NotImplementedError(
                f"{k}: the VTT runs column splits of 2-D Dense kernels with "
                f"a replicated bias and its session heads only")
    groups = {placements[k].mesh.group("model") for k in split}
    group = groups.pop() if groups else None
    for k in split:
        if k not in HEAD_LEAVES:
            modules[k.rpartition(".")[0]].model_group = group
    model.model_group = group if heads else None
    return split


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
        group = getattr(self, "model_group", None)
        if group is None:
            return torch.bmm(h.float(), Wb) + bb[:, None, :]
        # this rank's neuron block (split heads), gathered in model order
        out = torch.bmm(copy_to_model(h.float(), group), Wb) + bb[:, None, :]
        return gather_last(out, group)
