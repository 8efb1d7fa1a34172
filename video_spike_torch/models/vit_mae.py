"""ViT-MAE (masked autoencoder), its contrastive wrappers, and the
transformer parts shared by the ViT models.

Counterpart of ``video_spike_tpu/models/vit_mae.py`` (reference: the
vendored HF ViT-MAE ``src/model/vit_mae/modeling_vit_mae.py`` and the
wrappers of ``vit_mae.py:7-94``):

- sin-cos position tables (numpy copies), flax's ``LayerNorm``,
  ``SelfAttention``, the pre-LN ``Block`` and ``Encoder`` (blocks, then an
  f32 LayerNorm; ``remat`` recomputes each block in the backward pass with
  ``torch.utils.checkpoint``, same numerics);
- ``random_masking`` keeps ``int(L * (1 - mask_ratio))`` patches by argsorted
  uniform noise (``modeling_vit_mae.py:269``) and returns ``ids_restore``;
  the noise comes from the caller's ``torch.Generator`` or is passed in
  (the JAX package draws it from ``jax.random``);
- ``ViTMAEBackbone``: stride-P patch embedding (the flax ``patch_embed``
  (P, P, C, D) kernel read as a (P²C, D) matrix), CLS token, encoder,
  decoder with mask tokens and its own sin-cos table, an f32 per-patch
  pixel regression and the masked-patch MSE ``forward_loss``
  (``modeling_vit_mae.py:1092``), optional ``norm_pix_loss``;
- the model-zoo wrappers ``MAE`` (L2-normalized CLS + recon loss),
  ``ContrastViT`` (mask ratio 0, projection + learnable temperature, no
  decoder) and ``ContrastViTMAE`` (projection + recon + temperature).

Precision follows flax's per-module dtypes, cast explicitly (no autocast):

- ``Dense(dtype=bf16)`` casts the f32 kernel and bias to bf16 on every call
  and returns bf16 (``ops/dense.dense``); kernels keep flax's
  (in, out) layout and ``lecun_normal`` init;
- ``LayerNorm`` takes its statistics in f32 with flax's fast variance
  (E[x²] − E[x]², clipped at 0), normalises in f32 with the f32 scale and
  bias, and casts once to its dtype;
- GELU is the tanh approximation (the exact erf one with
  ``gelu_approx=False``, for the VideoMAE backbone's imported weights);
- the backbone casts the frames to the compute dtype before the patch
  embedding and adds the position tables in that dtype, so the residual
  stream is bf16; each encoder's final LayerNorm returns f32; the
  decoder's pixel head and the projection are f32 Dense layers on f32
  inputs; the reconstruction target is patchified from the f32 frames;
- ``z / ||z||`` has no epsilon, as in the JAX package.

Parameter names follow the flax tree: ``vit_mae.encoder.Block_0.
SelfAttention_0.qkv.kernel``, ``vit_mae.patch_embed.kernel``, ``proj.bias``,
``temperature`` and so on; init draws from the caller's ``torch.Generator``
with flax's distributions (the values differ from flax's init).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_spike_torch.core.spans import backward_span, span
from video_spike_torch.models.linear import Dense, layer_dense, lecun_normal_
from video_spike_torch.ops.attention import attention_bshd
from video_spike_torch.ops.dense import dense


# ---------------------------------------------------------------------------
# position embeddings (numpy copies of the JAX package's tables)
# ---------------------------------------------------------------------------

def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_2d(dim: int, grid_size: int,
                        cls_token: bool = True) -> np.ndarray:
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first (HF convention)
    grid = np.stack(grid, axis=0).reshape(2, -1)
    emb = np.concatenate(
        [_sincos_1d(dim // 2, grid[0]), _sincos_1d(dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb.astype(np.float32)


def sincos_pos_embed_1d(dim: int, length: int,
                        interleaved: bool = False) -> np.ndarray:
    """1-D sinusoid table in the concatenated (sin | cos) layout, or with
    ``interleaved=True`` the HF VideoMAE layout (even dims sin, odd dims
    cos, one frequency per pair), which released HF weights need."""
    if interleaved:
        pos = np.arange(length, dtype=np.float64)[:, None]
        angle = pos / np.power(10000, 2 * (np.arange(dim) // 2) / dim)
        angle[:, 0::2] = np.sin(angle[:, 0::2])
        angle[:, 1::2] = np.cos(angle[:, 1::2])
        return angle.astype(np.float32)
    return _sincos_1d(dim, np.arange(length, dtype=np.float64)).astype(
        np.float32)


class PosTable:
    """A fixed numpy position table as a tensor, copied to each device once."""

    def __init__(self, make):
        self._make = make
        self._cache: dict = {}

    def get(self, key, device: torch.device) -> torch.Tensor:
        if (key, device) not in self._cache:
            self._cache[(key, device)] = torch.from_numpy(
                self._make(key)).to(device)
        return self._cache[(key, device)]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(epsilon, dtype)`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class SelfAttention(nn.Module):
    """qkv Dense -> ``attention_bshd`` -> proj Dense; while a profiler
    records, ``attention_bshd`` and its backward are the ``vs.attention``
    spans (``core/spans.py``)."""

    def __init__(self, hidden: int, heads: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        self.qkv = Dense(hidden, 3 * hidden, device=device)
        self.proj = Dense(hidden, hidden, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.qkv.reset_parameters(generator)
        self.proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        qkv = layer_dense(self.qkv, x, self.dtype)
        qkv = qkv.reshape(b, s, 3, self.heads, self.hidden // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        with span("attention"):
            out = attention_bshd(q, k, v)
        backward_span("attention", out, (q, k, v))
        out = out.reshape(b, s, self.hidden)
        return layer_dense(self.proj, out, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)), then x + MLP(LN(x)).

    The residual adds follow torch's type promotion, which is JAX's here: a
    bf16 branch added to an f32 stream stays f32. ``gelu_approx=False`` is
    the exact erf GELU (HF's "gelu"); ``ln_dtype`` is the LayerNorms' output
    dtype (None: the compute dtype), f32 for imported weights."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dtype=torch.bfloat16, eps: float = 1e-12, device=None,
                 gelu_approx: bool = True, ln_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.gelu = "tanh" if gelu_approx else "none"
        ln = dtype if ln_dtype is None else ln_dtype
        self.LayerNorm_0 = LayerNorm(hidden, eps, ln, device)
        self.SelfAttention_0 = SelfAttention(hidden, heads, dtype, device)
        self.LayerNorm_1 = LayerNorm(hidden, eps, ln, device)
        self.Dense_0 = Dense(hidden, mlp_dim, device=device)
        self.Dense_1 = Dense(mlp_dim, hidden, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.LayerNorm_0, self.SelfAttention_0, self.LayerNorm_1,
                  self.Dense_0, self.Dense_1):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        y = layer_dense(self.Dense_0, self.LayerNorm_1(x), self.dtype)
        y = F.gelu(y, approximate=self.gelu)
        return x + layer_dense(self.Dense_1, y, self.dtype)


def _run_blocks(blocks, x: torch.Tensor, remat: bool) -> torch.Tensor:
    for blk in blocks:
        x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
    return x


class Patchify(nn.Module):
    """Stride-P patch embedding on an NHWC input -> (N, tokens, D) in the
    compute dtype; parameters ``kernel`` (P, P, C, D) and ``bias`` (D,), a
    flax ``nn.Conv(kernel_size=P, strides=P, padding="VALID")``."""

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


class Encoder(nn.Module):
    """``Block_0 … Block_{depth-1}``, then an f32 ``LayerNorm_0`` unless
    ``final_norm=False`` (HF VideoMAE with mean pooling has none);
    ``gelu_approx`` and ``ln_dtype`` go to every block."""

    def __init__(self, depth: int, hidden: int, heads: int, mlp_dim: int,
                 dtype=torch.bfloat16, eps: float = 1e-12,
                 remat: bool = False, device=None, final_norm: bool = True,
                 gelu_approx: bool = True, ln_dtype=None):
        super().__init__()
        self.depth, self.remat = depth, remat
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(
                hidden, heads, mlp_dim, dtype, eps, device,
                gelu_approx=gelu_approx, ln_dtype=ln_dtype))
        self.LayerNorm_0 = (LayerNorm(hidden, eps, torch.float32, device)
                            if final_norm else None)

    def blocks(self):
        return [getattr(self, f"Block_{i}") for i in range(self.depth)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        for blk in self.blocks():
            blk.reset_parameters(generator)
        if self.LayerNorm_0 is not None:
            self.LayerNorm_0.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_blocks(self.blocks(), x, self.remat)
        return x if self.LayerNorm_0 is None else self.LayerNorm_0(x)


# ---------------------------------------------------------------------------
# masking / patchify
# ---------------------------------------------------------------------------

def random_masking(x: torch.Tensor, mask_ratio: float,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
    """Keep a random (1 - mask_ratio) subset of the sequence.

    ``noise`` (B, L) decides the order; without it, uniform noise is drawn
    from ``generator`` on x's device. Returns (x_masked, mask, ids_restore);
    mask is 1 where removed (``modeling_vit_mae.py:269-306``)."""
    B, L, D = x.shape
    len_keep = int(L * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand((B, L), generator=generator, device=x.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, D))
    mask = torch.ones((B, L), device=x.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return x_masked, mask, ids_restore


def patchify(imgs: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, L, patch*patch*C), HF channel-last-pixel order."""
    B, C, H, W = imgs.shape
    h, w = H // patch, W // patch
    x = imgs.reshape(B, C, h, patch, w, patch)
    x = torch.einsum("nchpwq->nhwpqc", x)
    return x.reshape(B, h * w, patch * patch * C)


def unpatchify(patches: torch.Tensor, patch: int,
               channels: int) -> torch.Tensor:
    B, L, _ = patches.shape
    h = w = int(np.sqrt(L))
    x = patches.reshape(B, h, w, patch, patch, channels)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(B, channels, h * patch, w * patch)


# ---------------------------------------------------------------------------
# ViT-MAE backbone
# ---------------------------------------------------------------------------

def _normal_(t: torch.Tensor, std: float, generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


class ViTMAEBackbone(nn.Module):
    """Encoder (+ decoder, unless ``decoder=False``) with random masking.

    ``decoder=False`` builds what flax creates for ``ContrastViT``, which
    only calls ``encode``: no decoder layers, but the ``mask_token``."""

    def __init__(self, image_size: int = 144, patch_size: int = 16,
                 num_channels: int = 1, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12,
                 intermediate_size: int = 3072,
                 decoder_hidden_size: int = 512,
                 decoder_num_hidden_layers: int = 8,
                 decoder_num_attention_heads: int = 16,
                 decoder_intermediate_size: int = 2048,
                 mask_ratio: float = 0.75, norm_pix_loss: bool = False,
                 layer_norm_eps: float = 1e-12, dtype=torch.bfloat16,
                 remat: bool = False, decoder: bool = True, device=None):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.num_channels, self.hidden_size = num_channels, hidden_size
        self.decoder_hidden_size = decoder_hidden_size
        self.mask_ratio, self.norm_pix_loss = mask_ratio, norm_pix_loss
        self.dtype = dtype
        self.grid = image_size // patch_size
        self.patch_embed = Patchify(hidden_size, patch_size, num_channels,
                                    dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_size,
                                                  device=device))
        self.encoder = Encoder(num_hidden_layers, hidden_size,
                               num_attention_heads, intermediate_size, dtype,
                               layer_norm_eps, remat, device)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_hidden_size,
                                                   device=device))
        self.has_decoder = decoder
        if decoder:
            self.decoder_embed = Dense(hidden_size, decoder_hidden_size,
                                       device=device)
            self.decoder = Encoder(decoder_num_hidden_layers,
                                   decoder_hidden_size,
                                   decoder_num_attention_heads,
                                   decoder_intermediate_size, dtype,
                                   layer_norm_eps, remat, device)
            self.decoder_pred = Dense(decoder_hidden_size,
                                      patch_size ** 2 * num_channels,
                                      device=device)
        self._pos = PosTable(partial(sincos_pos_embed_2d, grid_size=self.grid))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``init``'s distributions: lecun_normal kernels, zero biases,
        unit LayerNorm scales, normal(0.02) CLS and mask tokens."""
        self.patch_embed.reset_parameters(generator)
        _normal_(self.cls_token, 0.02, generator)
        self.encoder.reset_parameters(generator)
        _normal_(self.mask_token, 0.02, generator)
        if self.has_decoder:
            self.decoder_embed.reset_parameters(generator)
            self.decoder.reset_parameters(generator)
            self.decoder_pred.reset_parameters(generator)

    def encode(self, imgs: torch.Tensor, mask_ratio: float,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """imgs: (B, C, H, W) -> (latent incl. CLS, mask, ids_restore)."""
        x = self.patch_embed(imgs.permute(0, 2, 3, 1).to(self.dtype))
        B, L, D = x.shape
        pos = self._pos.get(D, x.device)
        x = x + pos[None, 1:].to(self.dtype)
        if mask_ratio > 0:
            x, mask, ids_restore = random_masking(x, mask_ratio, generator,
                                                  noise)
        else:
            mask = torch.zeros((B, L), device=x.device)
            ids_restore = torch.arange(L, device=x.device)[None].expand(B, L)
        cls = (self.cls_token + pos[None, :1]).to(self.dtype)
        x = torch.cat([cls.expand(B, 1, D), x], dim=1)
        return self.encoder(x), mask, ids_restore

    def decode(self, latent: torch.Tensor,
               ids_restore: torch.Tensor) -> torch.Tensor:
        x = dense(latent, self.decoder_embed.kernel, self.decoder_embed.bias,
                  self.dtype)
        B, _, D = x.shape
        L = ids_restore.shape[1]
        n_masked = L + 1 - x.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(B, n_masked, D)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[:, :, None].expand(-1, -1, D))
        x = torch.cat([x[:, :1], x_], dim=1)
        x = x + self._pos.get(D, x.device)[None].to(x.dtype)
        x = self.decoder(x)
        return dense(x, self.decoder_pred.kernel, self.decoder_pred.bias,
                     torch.float32)[:, 1:]                    # drop CLS

    def forward_loss(self, imgs: torch.Tensor, pred: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """Masked-patch MSE (``modeling_vit_mae.py:1092-1117``)."""
        target = patchify(imgs.float(), self.patch_size)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, unbiased=False, keepdim=True)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = ((pred - target) ** 2).mean(dim=-1)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def forward(self, imgs: torch.Tensor, mask_ratio: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Full MAE pass -> (cls_latent f32, recon_loss)
        (reference ``vit_mae.py:61-94``)."""
        ratio = self.mask_ratio if mask_ratio is None else mask_ratio
        latent, mask, ids_restore = self.encode(imgs, ratio, generator, noise)
        pred = self.decode(latent, ids_restore)
        loss = self.forward_loss(imgs, pred, mask)
        return latent[:, 0].float(), loss


_BACKBONE_KEYS = ("image_size", "patch_size", "num_channels", "hidden_size",
                  "num_hidden_layers", "num_attention_heads",
                  "intermediate_size", "decoder_hidden_size",
                  "decoder_num_hidden_layers", "decoder_num_attention_heads",
                  "decoder_intermediate_size", "mask_ratio", "norm_pix_loss",
                  "layer_norm_eps", "remat")


def _backbone_kwargs(config) -> dict:
    return {k: config[k] for k in _BACKBONE_KEYS if k in config}


def _unit(z: torch.Tensor) -> torch.Tensor:
    """z / ||z|| over the last axis, without an epsilon."""
    return z / torch.sqrt((z * z).sum(dim=-1, keepdim=True))


# ---------------------------------------------------------------------------
# wrappers (the model-zoo entries)
# ---------------------------------------------------------------------------

class _Wrapper(nn.Module):
    """``from_config`` and the shared init of the three wrappers."""

    @classmethod
    def from_config(cls, config, device=None, dtype=torch.bfloat16):
        return cls(dict(config), device=device, dtype=dtype)

    def _build_head(self, config, device) -> None:
        self.proj = Dense(config["hidden_size"], config["embed_size"],
                          device=device)
        self.temperature = nn.Parameter(torch.zeros((), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(generator)
        if hasattr(self, "temperature"):
            with torch.no_grad():
                self.temperature.zero_()


class MAE(_Wrapper):
    """Reconstruction-only wrapper: z = L2-normalized CLS latent
    (reference ``vit_mae.py:45-58``)."""

    def __init__(self, config, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.config = dict(config)
        self.vit_mae = ViTMAEBackbone(**_backbone_kwargs(config), dtype=dtype,
                                      device=device)

    def forward(self, x, mask_ratio: Optional[float] = None,
                generator=None, noise=None) -> Dict[str, torch.Tensor]:
        cls_latent, recon = self.vit_mae(x, mask_ratio, generator, noise)
        return {"z": _unit(cls_latent), "recon_loss": recon}


class ContrastViT(_Wrapper):
    """Unmasked encoder + projection head + learnable temperature
    (reference ``vit_mae.py:26-44``). No decoder runs."""

    def __init__(self, config, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.config = dict(config)
        cfg = dict(_backbone_kwargs(config), mask_ratio=0.0)
        self.vit = ViTMAEBackbone(**cfg, dtype=dtype, decoder=False,
                                  device=device)
        self._build_head(config, device)

    def forward(self, x, mask_ratio: Optional[float] = None,
                generator=None, noise=None) -> Dict[str, torch.Tensor]:
        latent, _, _ = self.vit.encode(x, 0.0)
        z = dense(latent[:, 0].float(), self.proj.kernel, self.proj.bias,
                  torch.float32)
        return {"z": _unit(z), "temp": 1.0 / torch.exp(self.temperature)}


class ContrastViTMAE(_Wrapper):
    """Masked autoencoding + contrastive projection (reference
    ``vit_mae.py:7-24``)."""

    def __init__(self, config, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.config = dict(config)
        self.vit_mae = ViTMAEBackbone(**_backbone_kwargs(config), dtype=dtype,
                                      device=device)
        self._build_head(config, device)

    def forward(self, x, mask_ratio: Optional[float] = None,
                generator=None, noise=None) -> Dict[str, torch.Tensor]:
        cls_latent, recon = self.vit_mae(x, mask_ratio, generator, noise)
        z = dense(cls_latent, self.proj.kernel, self.proj.bias, torch.float32)
        return {"z": _unit(z), "recon_loss": recon,
                "temp": 1.0 / torch.exp(self.temperature)}
