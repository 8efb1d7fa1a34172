"""VideoMAE: tubelet video transformer, masked-video pretraining, and the
frozen-backbone spike probe.

Counterpart of ``video_spike_tpu/models/videomae.py`` (reference: the
vendored HF ``src/model/videomae/modeling_videomae.py`` and the probe
wrapper ``src/model/videomae.py:4-36``):

- ``TubeletEmbed``: the flax 3-D ``Conv_0`` with a (kT, kH, kW, C, D)
  kernel and tubelet strides, computed as one matmul over patches
  flattened in (kT, kH, kW, C) order, tokens in (t, h, w) order;
- ``VideoMAEBackbone``: tubelets + a fixed 1-D sin-cos table + the ViT
  encoder of ``models/vit_mae.py``. ``hf_compat`` hosts released HF
  weights: the interleaved table, no final LayerNorm, the exact erf GELU
  and f32 LayerNorm outputs feeding the bf16 Dense layers (the residual
  stream stays bf16);
- ``VideoMAEForPreTraining``: encode the visible tubelets, decode all of
  them with mask tokens, regress the masked tubelets' pixels; the encoder
  ends in its f32 LayerNorm, so the decoder's stream is f32. Masking is
  random over the tokens or, with ``mask_type: tube``, VideoMAE's tubes
  (``tube_masking``); ``norm_pix_loss`` regresses VideoMAE's per-tubelet
  normalized pixels (``normalized_tubelets``);
- ``preprocess_frames``: 16 of the trial's frames, [0, 1], a half-pixel
  bilinear resize (antialiased when it shrinks, as ``jax.image.resize``),
  grayscale to RGB, ImageNet normalization;
- ``VideoMAEProbe``: ``encode`` (preprocess + backbone, without autograd
  while the backbone is frozen, as ``stop_gradient``) and ``head``
  (``Linear(L*D -> enc_out) -> Linear(-> 100*N)``, no activation, in f32:
  a flax ``Dense(dtype=None)`` promotes a bf16 kernel).

Parameter names follow the flax tree: ``video_mae.patch_embed.Conv_0.
kernel``, ``video_mae.encoder.Block_3.SelfAttention_0.qkv.kernel``,
``encoder_head.kernel``, ``mask_token``, ``decoder_pred.kernel``;
``reset_parameters`` draws flax's distributions from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_spike_torch.models.linear import Dense, lecun_normal_
from video_spike_torch.models.vit_mae import (
    Encoder,
    PosTable,
    _normal_,
    random_masking,
    sincos_pos_embed_1d,
)
from video_spike_torch.ops.dense import dense

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class _Conv3d(nn.Module):
    """The parameters of a flax ``nn.Conv`` over three axes."""

    def __init__(self, kernel_size, channels: int, features: int,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*kernel_size, channels,
                                               features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[:-1]),
                      generator)
        with torch.no_grad():
            self.bias.zero_()


class TubeletEmbed(nn.Module):
    """(B, T, C, H, W) -> (B, L, D) in the compute dtype: a conv with
    (tubelet, patch, patch) kernel and strides, as one matmul."""

    def __init__(self, hidden_size: int = 768, patch_size: int = 16,
                 tubelet_size: int = 2, channels: int = 3,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.patch, self.tubelet, self.dtype = patch_size, tubelet_size, dtype
        self.Conv_0 = _Conv3d((tubelet_size, patch_size, patch_size),
                              channels, hidden_size, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.Conv_0.reset_parameters(generator)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        B, T, C, H, W = video.shape
        p, k = self.patch, self.tubelet
        t, h, w = T // k, H // p, W // p
        x = video.to(self.dtype).reshape(B, t, k, C, h, p, w, p)
        x = x.permute(0, 1, 4, 6, 2, 5, 7, 3).reshape(B, t * h * w,
                                                      k * p * p * C)
        kernel = self.Conv_0.kernel.to(self.dtype)
        y = x @ kernel.reshape(-1, kernel.shape[-1])
        return y + self.Conv_0.bias.to(self.dtype)


def tubelet_patchify(video: torch.Tensor, tubelet: int,
                     patch: int) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, L, tubelet*patch*patch*C) tubelet pixels."""
    B, T, C, H, W = video.shape
    t, h, w = T // tubelet, H // patch, W // patch
    x = video.reshape(B, t, tubelet, C, h, patch, w, patch)
    x = torch.einsum("btschpwq->bthwspqc", x)
    return x.reshape(B, t * h * w, tubelet * patch * patch * C)


def tube_masking(x: torch.Tensor, mask_ratio: float, slots: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
    """VideoMAE's ``TubeMaskingGenerator``: each clip masks
    ``int(mask_ratio * P)`` of its P spatial positions in every one of its
    ``slots`` tubelet slots, so whole tubes are hidden. The kept positions
    are the first of the argsort of uniform noise (B, P) (drawn from
    ``generator`` unless ``noise`` is given). Returns what
    ``random_masking`` returns: the visible tokens in their (t, h, w)
    order, the mask (1 where removed) and ``ids_restore``."""
    B, L, D = x.shape
    patches = L // slots
    keep = patches - int(mask_ratio * patches)
    if noise is None:
        noise = torch.rand((B, patches), generator=generator,
                           device=x.device)
    order = torch.argsort(noise, dim=1, stable=True)
    spatial = torch.ones((B, patches), device=x.device)
    spatial.scatter_(1, order[:, :keep], 0.0)
    mask = spatial.repeat(1, slots)                      # (B, L), t-major
    # the visible tokens first, each group in token order
    ids_shuffle = torch.argsort(mask, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :keep * slots]
    visible = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, D))
    return visible, mask, ids_restore


def normalized_tubelets(video: torch.Tensor, tubelet: int,
                        patch: int) -> torch.Tensor:
    """VideoMAE's normalized-pixel target: (B, T, 3, H, W) frames as
    ``preprocess_frames`` gives them -> (B, L, tubelet*patch*patch*3).
    The frames are taken back to [0, 1] (``x * std + mean``); each
    tubelet's pixels of a channel less their mean, over their unbiased
    standard deviation plus 1e-6, laid out (pixel, channel)."""
    c = video.shape[2]
    mean = torch.from_numpy(IMAGENET_MEAN).to(video.device)
    std = torch.from_numpy(IMAGENET_STD).to(video.device)
    x = video.float() * std.reshape(1, 1, c, 1, 1) + mean.reshape(
        1, 1, c, 1, 1)
    t = tubelet_patchify(x, tubelet, patch)
    b, length, _ = t.shape
    t = t.reshape(b, length, -1, c)
    t = (t - t.mean(dim=-2, keepdim=True)) / (
        t.var(dim=-2, unbiased=True, keepdim=True).sqrt() + 1e-6)
    return t.reshape(b, length, -1)


def preprocess_frames(video: torch.Tensor, num_frames: int = 16,
                      image_size: int = 224,
                      source_frames: int = 120) -> torch.Tensor:
    """(B, T, 1, H, W) uint8/float trial video -> (B, num_frames, 3, S, S)
    normalized f32 frames (the reference's AutoImageProcessor)."""
    idx = (np.linspace(0, 1, num_frames) * (source_frames - 1)).astype(int)
    x = video[:, torch.from_numpy(idx).to(video.device)].float() / 255.0
    b, t, c, h, w = x.shape
    if (h, w) != (image_size, image_size):
        # jax.image.resize "linear": half-pixel bilinear, antialiased on an
        # axis it shrinks
        x = F.interpolate(x.reshape(b * t, c, h, w),
                          size=(image_size, image_size), mode="bilinear",
                          align_corners=False,
                          antialias=h > image_size or w > image_size)
        x = x.reshape(b, t, c, image_size, image_size)
    if c == 1:
        x = x.repeat_interleave(3, dim=2)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device).reshape(1, 1, 3, 1, 1)
    std = torch.from_numpy(IMAGENET_STD).to(x.device).reshape(1, 1, 3, 1, 1)
    return (x - mean) / std


class VideoMAEBackbone(nn.Module):
    """Encoder over tubelet tokens with a fixed sinusoid position table."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_channels: int = 3, num_frames: int = 16,
                 tubelet_size: int = 2, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12,
                 intermediate_size: int = 3072, dtype=torch.bfloat16,
                 hf_compat: bool = False, remat: bool = False, device=None):
        super().__init__()
        self.hidden_size, self.hf_compat = hidden_size, hf_compat
        self.seq_len = ((num_frames // tubelet_size)
                        * (image_size // patch_size) ** 2)
        self.patch_embed = TubeletEmbed(hidden_size, patch_size,
                                        tubelet_size, num_channels, dtype,
                                        device)
        self.encoder = Encoder(
            num_hidden_layers, hidden_size, num_attention_heads,
            intermediate_size, dtype, remat=remat, device=device,
            final_norm=not hf_compat, gelu_approx=not hf_compat,
            ln_dtype=torch.float32 if hf_compat else None)
        self._pos = PosTable(partial(sincos_pos_embed_1d, hidden_size,
                                     interleaved=hf_compat))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch_embed.reset_parameters(generator)
        self.encoder.reset_parameters(generator)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(video)
        x = x + self._pos.get(x.shape[1], x.device)[None].to(x.dtype)
        return self.encoder(x)          # (B, L, D) last hidden state


class VideoMAEForPreTraining(nn.Module):
    """Masked video modeling (``modeling_videomae.py:790-972``): a ViT
    encoder over the visible tubelets, a 4 x 384 decoder over all of them,
    MSE on the masked tubelets' pixels.

    Two configuration keys: ``mask_type`` ``"random"`` (the default:
    ``random_masking`` over every token) or ``"tube"`` (``tube_masking``,
    VideoMAE's), and ``norm_pix_loss`` (default false: the normalized
    frames' pixels; true: ``normalized_tubelets``, VideoMAE's target)."""

    def __init__(self, config, device=None, dtype=torch.bfloat16,
                 decoder_hidden_size: int = 384,
                 decoder_num_hidden_layers: int = 4,
                 decoder_num_attention_heads: int = 6,
                 decoder_intermediate_size: int = 1536):
        super().__init__()
        cfg = self.config = dict(config)
        c = cfg.get("num_channels", 3)
        self.mask_type = cfg.get("mask_type", "random")
        if self.mask_type not in ("random", "tube"):
            raise ValueError(f"mask_type {self.mask_type!r}: want 'random' "
                             f"or 'tube'")
        self.norm_pix_loss = bool(cfg.get("norm_pix_loss", False))
        self.patch = cfg.get("patch_size", 16)
        self.tubelet = cfg.get("tubelet_size", 2)
        hidden = cfg.get("hidden_size", 768)
        remat = bool(cfg.get("remat", False))
        self.patch_embed = TubeletEmbed(hidden, self.patch, self.tubelet, c,
                                        dtype, device)
        self.encoder = Encoder(cfg.get("num_hidden_layers", 12), hidden,
                               cfg.get("num_attention_heads", 12),
                               cfg.get("intermediate_size", 3072), dtype,
                               remat=remat, device=device)
        self.decoder_embed = Dense(hidden, decoder_hidden_size,
                                   device=device)
        self.mask_token = nn.Parameter(torch.empty(
            1, 1, decoder_hidden_size, device=device))
        self.decoder = Encoder(decoder_num_hidden_layers, decoder_hidden_size,
                               decoder_num_attention_heads,
                               decoder_intermediate_size, dtype, remat=remat,
                               device=device)
        self.decoder_pred = Dense(decoder_hidden_size,
                                  self.tubelet * self.patch ** 2 * c,
                                  device=device)
        self._pos = PosTable(lambda key: sincos_pos_embed_1d(*key))

    @classmethod
    def from_config(cls, config, device=None, dtype=torch.bfloat16):
        return cls(config, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch_embed.reset_parameters(generator)
        self.encoder.reset_parameters(generator)
        self.decoder_embed.reset_parameters(generator)
        _normal_(self.mask_token, 0.02, generator)
        self.decoder.reset_parameters(generator)
        self.decoder_pred.reset_parameters(generator)

    def forward(self, video: torch.Tensor, mask_ratio: float = 0.9,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Dict:
        tokens = self.patch_embed(video)
        B, L, D = tokens.shape
        tokens = tokens + self._pos.get((D, L), tokens.device)[None].to(
            tokens.dtype)
        if self.mask_type == "tube":
            visible, mask, ids_restore = tube_masking(
                tokens, mask_ratio, video.shape[1] // self.tubelet,
                generator, noise)
        else:
            visible, mask, ids_restore = random_masking(tokens, mask_ratio,
                                                        generator, noise)
        enc = self.encoder(visible)                        # f32 (final LN)
        # flax Dense(dtype=None) on the f32 stream: an f32 Dense
        x = dense(enc, self.decoder_embed.kernel, self.decoder_embed.bias,
                  enc.dtype)
        dd = x.shape[-1]
        mask_tokens = self.mask_token.to(x.dtype).expand(B, L - x.shape[1],
                                                         dd)
        x = torch.cat([x, mask_tokens], dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(-1, -1, dd))
        x = x + self._pos.get((dd, L), x.device)[None].to(x.dtype)
        dec = self.decoder(x)
        pred = dense(dec, self.decoder_pred.kernel, self.decoder_pred.bias,
                     torch.float32)
        if self.norm_pix_loss:
            target = normalized_tubelets(video, self.tubelet, self.patch)
        else:
            target = tubelet_patchify(video.float(), self.tubelet,
                                      self.patch)
        loss = ((pred - target) ** 2).mean(dim=-1)
        loss = (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return {"recon_loss": loss, "logits": pred, "mask": mask}


def head_apply(params: Mapping[str, torch.Tensor], hidden: torch.Tensor,
               out_dim: int) -> torch.Tensor:
    """``VideoMAEProbe.head`` from explicit parameters: (B, L, D) features
    -> (B, 100, out_dim // 100) log-rates, all in f32."""
    b = hidden.shape[0]
    x = dense(hidden.reshape(b, -1), params["encoder_head.kernel"],
              params["encoder_head.bias"], torch.float32)
    x = dense(x, params["decoder_head.kernel"], params["decoder_head.bias"],
              torch.float32)
    return x.reshape(b, 100, out_dim // 100)


class VideoMAEProbe(nn.Module):
    """Frozen VideoMAE backbone + trainable linear readout to spike rates."""

    def __init__(self, config, device=None, dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = dict(config)
        self.video_mae = VideoMAEBackbone(
            image_size=cfg.get("image_size", 224),
            patch_size=cfg.get("patch_size", 16), num_channels=3,
            num_frames=cfg.get("num_frames", 16),
            tubelet_size=cfg.get("tubelet_size", 2),
            hidden_size=cfg.get("hidden_size", 768),
            num_hidden_layers=cfg.get("num_hidden_layers", 12),
            num_attention_heads=cfg.get("num_attention_heads", 12),
            intermediate_size=cfg.get("intermediate_size", 3072),
            dtype=dtype,
            # default True: the probe hosts released HF weights; False for
            # a backbone pretrained by cli/pretrain_videomae.py
            hf_compat=cfg.get("hf_compat", True),
            remat=bool(cfg.get("remat", False)), device=device)
        self.out_dim = cfg["decoder"]["output_dim"]
        enc_out = cfg["encoder"]["output_dim"]
        self.encoder_head = Dense(
            self.video_mae.seq_len * self.video_mae.hidden_size, enc_out,
            device=device)
        self.decoder_head = Dense(enc_out, self.out_dim, device=device)

    @classmethod
    def from_config(cls, config, device=None, dtype=torch.bfloat16):
        return cls(config, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.video_mae.reset_parameters(generator)
        self.encoder_head.reset_parameters(generator)
        self.decoder_head.reset_parameters(generator)

    def frozen_param_paths(self) -> tuple:
        """Top-level parameter names the optimizer must not touch: the
        reference builds its optimizer after ``requires_grad=False`` on the
        backbone, so weight decay never reaches it either."""
        return (("video_mae",)
                if self.config.get("freeze_backbone", True) else ())

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """Preprocess + backbone: the features the head reads; without
        autograd while the backbone is frozen (``stop_gradient``)."""
        cfg = self.config
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.frozen_param_paths()):
            x = preprocess_frames(video, cfg.get("num_frames", 16),
                                  cfg.get("image_size", 224),
                                  source_frames=video.shape[1])
            return self.video_mae(x)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Trainable readout over (B, L, D) backbone features."""
        params = {f"{m}.{p}": getattr(getattr(self, m), p)
                  for m in ("encoder_head", "decoder_head")
                  for p in ("kernel", "bias")}
        return head_apply(params, hidden, self.out_dim)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.head(self.encode(video))
