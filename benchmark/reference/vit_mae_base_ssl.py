"""Plain reference of ``vit_mae_base_ssl``: the ContrastViTMAE of the
reference repository's SSL pretraining (``src/model/vit_mae.py`` over the
HF ViT-MAE of He et al., arXiv:2111.06377), written from the published
description:

- frames scaled to [0, 1], resized to ``image_size`` (antialiased
  bilinear, half-pixel centres) and normalized by (x - 0.5) / 0.5, the
  recipe's transform;
- a stride-P patch embedding, fixed 2-D sin-cos positions (the width
  coordinate first, a zero row for CLS), random masking that keeps
  ``int(L (1 - mask_ratio))`` patches in the order of ``argsort`` of
  uniform noise, a CLS token; pre-LN transformer blocks (multi-head
  softmax attention, an MLP with a GELU), a final
  LayerNorm; the decoder embeds the latent, appends the mask token for the
  masked patches, restores their order, adds its own sin-cos positions and
  runs its blocks, a LayerNorm and the pixel head (the MLPs' GELU as
  the configuration's ``hidden_act`` names it); the reconstruction loss
  is the masked patches' mean squared error (``norm_pix_loss`` off);
- the contrastive head projects the CLS latent to ``embed_size`` and
  normalizes it; the loss of a (ref, pos, neg) triplet batch, run as one
  stacked forward, is the stacked batch's reconstruction loss plus the
  stabilized InfoNCE at temperature 1;
- AdamW (b1 0.9, b2 0.999) at the configuration's constant learning rate
  and weight decay, f32 parameters.

It computes in f32 with TF32 off (or, as the control, with every matmul
in fp8), from the starting parameters the benchmark makes and gives the
program (``param_specs``, ``benchlib/weights.py``), on the same frames and
the same masking noise: the noise of a step is ``torch.rand((rows, L))``
from a generator on the device seeded with that step's masking seed. Its
parameter names follow the program's flat layout (packed ``qkv`` (D, 3D)
kernels as ``[q | k | v]`` of heads, (in, out) kernels used as
``x @ kernel + bias``, the patch kernel (P, P, C, D)). It imports nothing
of the program."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchlib import plain


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                            / (dim / 2.0))
    out = np.outer(pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """MAE's ``get_2d_sincos_pos_embed`` with a leading zero row for CLS."""
    gw, gh = np.meshgrid(np.arange(grid, dtype=np.float64),
                         np.arange(grid, dtype=np.float64))
    emb = np.concatenate([_sincos_1d(dim // 2, gw), _sincos_1d(dim // 2, gh)],
                         axis=1)
    return torch.from_numpy(np.concatenate([np.zeros((1, dim)), emb])).float()


# HF's hidden_act names: "gelu" is the exact erf form, the others the tanh
# approximation
GELU = {"gelu": "none", "gelu_new": "tanh", "gelu_pytorch_tanh": "tanh"}


class Model:
    def __init__(self, cfg: dict, precision: str, device):
        self.m = cfg["config"]["model"]
        self.precision, self.device = precision, device
        self.pos_enc = sincos_2d(self.m["hidden_size"], self.grid).to(device)
        self.pos_dec = sincos_2d(self.m["decoder_hidden_size"],
                                 self.grid).to(device)

    @property
    def grid(self) -> int:
        return self.m["image_size"] // self.m["patch_size"]

    def dense(self, p, name, x):
        return plain.matmul(x, p[f"{name}.kernel"], self.precision) \
            + p[f"{name}.bias"]

    def layer_norm(self, p, name, x):
        eps = self.m["layer_norm_eps"]
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.scale"],
                            p[f"{name}.bias"], eps)

    def block(self, p, name, x, heads):
        b, s, d = x.shape
        h = self.layer_norm(p, f"{name}.LayerNorm_0", x)
        qkv = self.dense(p, f"{name}.SelfAttention_0.qkv", h)
        qkv = qkv.reshape(b, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = plain.matmul(q, k.transpose(-1, -2), self.precision) \
            / math.sqrt(d // heads)
        o = plain.matmul(torch.softmax(att, dim=-1), v, self.precision)
        o = o.permute(0, 2, 1, 3).reshape(b, s, d)
        x = x + self.dense(p, f"{name}.SelfAttention_0.proj", o)
        h = self.layer_norm(p, f"{name}.LayerNorm_1", x)
        h = F.gelu(self.dense(p, f"{name}.Dense_0", h),
                   approximate=GELU[self.m["hidden_act"]])
        return x + self.dense(p, f"{name}.Dense_1", h)

    def transform(self, frames_u8: torch.Tensor) -> torch.Tensor:
        x = frames_u8.float() / 255.0
        size = self.m["image_size"]
        if tuple(x.shape[-2:]) != (size, size):
            x = F.interpolate(x, size=(size, size), mode="bilinear",
                              align_corners=False, antialias=True)
        return (x - 0.5) / 0.5

    def forward(self, p: dict, frames_u8: torch.Tensor, mask_seed: int):
        """(normalized projections (N, embed), reconstruction loss)."""
        m, pp = self.m, self.m["patch_size"]
        imgs = self.transform(frames_u8)
        n, c = imgs.shape[:2]
        pk = p["vit_mae.patch_embed.kernel"]            # (P, P, C, D)
        patches = (imgs.reshape(n, c, self.grid, pp, self.grid, pp)
                   .permute(0, 2, 4, 3, 5, 1)
                   .reshape(n, self.grid ** 2, pp * pp * c))
        x = plain.matmul(patches, pk.reshape(pp * pp * c, -1),
                         self.precision) + p["vit_mae.patch_embed.bias"]
        length, d = x.shape[1], x.shape[2]
        x = x + self.pos_enc[1:]
        gen = torch.Generator(device=self.device).manual_seed(mask_seed)
        noise = torch.rand((n, length), generator=gen, device=self.device)
        keep = int(length * (1 - m["mask_ratio"]))
        shuffle = torch.argsort(noise, dim=1, stable=True)
        restore = torch.argsort(shuffle, dim=1, stable=True)
        x = torch.gather(x, 1, shuffle[:, :keep, None].expand(-1, -1, d))
        mask = torch.ones((n, length), device=self.device)
        mask[:, :keep] = 0
        mask = torch.gather(mask, 1, restore)
        cls = (p["vit_mae.cls_token"] + self.pos_enc[:1]).expand(n, 1, d)
        x = torch.cat([cls, x], dim=1)
        for i in range(m["num_hidden_layers"]):
            x = self.block(p, f"vit_mae.encoder.Block_{i}", x,
                           m["num_attention_heads"])
        latent = self.layer_norm(p, "vit_mae.encoder.LayerNorm_0", x)
        y = self.dense(p, "vit_mae.decoder_embed", latent)
        dd = y.shape[-1]
        tokens = p["vit_mae.mask_token"].expand(n, length + 1 - y.shape[1],
                                                dd)
        y_ = torch.cat([y[:, 1:], tokens], dim=1)
        y_ = torch.gather(y_, 1, restore[:, :, None].expand(-1, -1, dd))
        y = torch.cat([y[:, :1], y_], dim=1) + self.pos_dec
        for i in range(m["decoder_num_hidden_layers"]):
            y = self.block(p, f"vit_mae.decoder.Block_{i}", y,
                           m["decoder_num_attention_heads"])
        y = self.layer_norm(p, "vit_mae.decoder.LayerNorm_0", y)
        pred = self.dense(p, "vit_mae.decoder_pred", y)[:, 1:]
        target = (imgs.reshape(n, c, self.grid, pp, self.grid, pp)
                  .permute(0, 2, 4, 3, 5, 1)
                  .reshape(n, length, pp * pp * c))
        per_patch = ((pred - target) ** 2).mean(dim=-1)
        recon = (per_patch * mask).sum() / mask.sum().clamp(min=1.0)
        z = self.dense(p, "proj", latent[:, 0])
        return z / z.norm(dim=-1, keepdim=True), recon


def param_specs(cfg: dict) -> dict:
    """The model's leaves and the init the recipe states (flax's, as the
    JAX package's ``init`` draws them): ``name -> (shape, init, fan-in)``,
    lecun_normal kernels, zero biases, unit LayerNorm scales, the CLS and
    mask tokens normal at ``initializer_range``, the unused temperature 0."""
    m = cfg["config"]["model"]
    d, dd, pp = m["hidden_size"], m["decoder_hidden_size"], m["patch_size"]
    c = m["num_channels"]
    out = {"temperature": ((), "zeros", 0),
           "vit_mae.cls_token": ((1, 1, d), "normal",
                                 m["initializer_range"]),
           "vit_mae.mask_token": ((1, 1, dd), "normal",
                                  m["initializer_range"])}

    def dense(name, n_in, n_out):
        out[f"{name}.kernel"] = ((n_in, n_out), "lecun", n_in)
        out[f"{name}.bias"] = ((n_out,), "zeros", 0)

    def norm(name, n):
        out[f"{name}.scale"] = ((n,), "ones", 0)
        out[f"{name}.bias"] = ((n,), "zeros", 0)

    def blocks(prefix, n, width, mlp):
        for i in range(n):
            b = f"{prefix}.Block_{i}"
            norm(f"{b}.LayerNorm_0", width)
            dense(f"{b}.SelfAttention_0.qkv", width, 3 * width)
            dense(f"{b}.SelfAttention_0.proj", width, width)
            norm(f"{b}.LayerNorm_1", width)
            dense(f"{b}.Dense_0", width, mlp)
            dense(f"{b}.Dense_1", mlp, width)
        norm(f"{prefix}.LayerNorm_0", width)

    out["vit_mae.patch_embed.kernel"] = ((pp, pp, c, d), "lecun", pp * pp * c)
    out["vit_mae.patch_embed.bias"] = ((d,), "zeros", 0)
    blocks("vit_mae.encoder", m["num_hidden_layers"], d,
           m["intermediate_size"])
    dense("vit_mae.decoder_embed", d, dd)
    blocks("vit_mae.decoder", m["decoder_num_hidden_layers"], dd,
           m["decoder_intermediate_size"])
    dense("vit_mae.decoder_pred", dd, pp * pp * c)
    dense("proj", d, m["embed_size"])
    return out


def store_dtype(cfg: dict):
    """Every leaf is stored in f32."""
    return lambda name, shape: torch.float32


def parts(name: str) -> int:
    """The packed q|k|v projections count as three parameters each, as in
    the published model: the key bias has no gradient under softmax."""
    return 3 if name.endswith(("qkv.kernel", "qkv.bias")) else 1


def norms(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(plain.part_norms(k, v, parts(k)))
    return out


def parted(tree: dict) -> dict:
    """Each leaf (or packed part) flattened, on the host."""
    out = {}
    for k, v in tree.items():
        n = parts(k)
        if n == 1:
            out[k] = v.detach().float().reshape(-1).cpu()
        else:
            t = v.detach().float().reshape(-1, n, v.shape[-1] // n)
            out.update({f"{k}[{i}/{n}]": t[:, i].reshape(-1).cpu()
                        for i in range(n)})
    return out


def triplet_loss(z: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """Reconstruction plus the stabilized InfoNCE (temperature 1) over the
    stacked [ref | pos | neg] rows."""
    b = z.shape[0] // 3
    ref, pos, neg = z[:b], z[b:2 * b], z[2 * b:]
    pos_d = (ref * pos).sum(dim=-1)
    neg_d = ref @ neg.T
    c = neg_d.max(dim=1, keepdim=True).values.detach()
    return recon - (pos_d - c[:, 0]).mean() \
        + torch.logsumexp(neg_d - c, dim=1).mean()


def reference_steps(cfg: dict, traffic: dict, p0: dict, batches: list,
                    seeds: list, device, precision: str = "f32",
                    fault: str = None) -> dict:
    """The first ``len(batches)`` steps from ``p0``. Each batch is
    ``(uint8 frames (3, B, C, H, W) of ref, pos and neg, masking seed)``;
    ``seeds`` are unused (the store is f32). ``fault="half_batch"`` keeps
    the first half of each of ref, pos and neg;
    ``fault="state_unchanged"`` updates nothing."""
    opt = cfg["config"]["optimizer"]
    with plain.exact_f32():
        model = Model(cfg, precision, device)
        params = {k: v.to(device).float() for k, v in p0.items()}
        start = {k: v.clone() for k, v in params.items()}
        tx = plain.AdamW(opt.get("wd", 0.01), opt.get("eps", 1e-8))
        losses, grad_norms = [], None
        for trip, mask_seed in batches:
            trip = torch.as_tensor(trip).to(device)
            if fault == "half_batch":
                trip = trip[:, : trip.shape[1] // 2]
            frames = trip.reshape(-1, *trip.shape[2:])
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            z, recon = model.forward(leaves, frames, mask_seed)
            loss = triplet_loss(z, recon)
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                     for k, g in zip(names, grads)}
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = norms(grads)
                moments = parted(grads)
            if fault == "state_unchanged":
                continue
            with torch.no_grad():
                upd = tx.update(grads, params, opt["lr"])
                params = {k: params[k] + upd[k] for k in params}
        change = norms({k: params[k] - start[k] for k in params})
    return {"losses": losses, "grad_norms": grad_norms, "moments": moments,
            "change_norms": change}


def program_moments(opt_state, params) -> dict:
    """The first gradient, element by element, as the program's AdamW
    holds it after one step: its first moment over (1 - b1)."""
    return {k: v / 0.1 for k, v in parted(
        {k: opt_state["mu"][k] for k in params}).items()}


def program_grad_norms(opt_state, params) -> dict:
    """The first gradient's norm per leaf from the program's AdamW state
    after one step: its first moment is then (1 - b1) g."""
    return {k: v / 0.1 for k, v in norms(
        {k: opt_state["mu"][k] for k in params}).items()}
