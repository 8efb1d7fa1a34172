"""Plain reference of ``videomae_base_pretrain``: VideoMAE's masked-video
pretraining (Tong et al., arXiv:2203.12602) at MCG-NJU/videomae-base's
widths, written from the published description:

- a trial's 16 frames taken at ``linspace(0, 1, 16) * (frames - 1)``,
  scaled to [0, 1], resized to ``image_size`` (bilinear, half-pixel
  centres, antialiased only where it shrinks), gray repeated to RGB and
  normalized by ImageNet's mean and standard deviation;
- the tubelet embedding (a (2, 16, 16) convolution of stride its size,
  computed as a matmul over each tubelet's pixels in (t, h, w, c) order,
  tokens in (t, h, w) order) plus a fixed 1-D sin-cos table;
- tube masking: a clip's spatial positions kept are the first
  ``P - int(mask_ratio * P)`` of the ``argsort`` of uniform noise (clips,
  P) drawn with ``torch.rand`` from a generator on the device seeded with
  the step's masking seed, the same in every tubelet slot; the visible
  tokens in token order;
- pre-LN transformer blocks (multi-head softmax attention, an MLP with a
  GELU), a final LayerNorm; ``decoder_embed``, a mask token for every
  masked tubelet, the tokens back in their order, the decoder's own sin-cos
  table, its blocks, a LayerNorm and ``decoder_pred``;
- the normalized-pixel target (``norm_pix_loss``): the input taken back to
  [0, 1] (``x * std + mean``), each tubelet's pixels of a channel less
  their mean over their unbiased standard deviation plus 1e-6, laid out
  (pixel, channel); the loss is the mean squared error over the masked
  tubelets;
- AdamW (b1 0.9, b2 0.999) at the configuration's constant learning rate
  and weight decay, f32 parameters.

Departures from VideoMAE it shares with the program (the configuration's
``assumed``): biases on k (a packed q|k|v projection; VideoMAE has q and v
biases) and on ``decoder_embed`` (VideoMAE's has none); LayerNorm eps
1e-12 (HF's configuration) where VideoMAE's code takes 1e-6; the sin-cos
table as (sin | cos) halves, not interleaved; predictions for the visible
tokens computed and left out of the loss (VideoMAE predicts the masked
ones only); the tanh GELU (``hidden_act``).

It computes in f32 with TF32 off (or, as the control, with every matmul
in fp8), from the starting parameters the benchmark makes and gives the
program (``param_specs``, ``benchlib/weights.py``), on the same trials and
the same masking noise, in blocks of ``BLOCK`` clips with the gradients
summed, so that a step of 64 clips fits on one card. Parameter names
follow the program's flat layout (packed ``qkv`` (D, 3D) kernels as
``[q | k | v]`` of heads, (in, out) kernels used as ``x @ kernel + bias``,
the tubelet kernel (2, P, P, C, D)). It imports nothing of the program."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchlib import plain

BLOCK = 8                       # clips a block
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# HF's hidden_act names: "gelu" is the exact erf form, the others the tanh
# approximation
GELU = {"gelu": "none", "gelu_new": "tanh", "gelu_pytorch_tanh": "tanh"}


def sincos_1d(dim: int, length: int) -> torch.Tensor:
    """(length, dim): sines of the positions at ``dim / 2`` frequencies
    ``10000^(-i / (dim / 2))``, then their cosines."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                            / (dim / 2.0))
    out = np.outer(np.arange(length, dtype=np.float64), omega)
    return torch.from_numpy(
        np.concatenate([np.sin(out), np.cos(out)], axis=1)).float()


def tubelets(video: torch.Tensor, kt: int, p: int) -> torch.Tensor:
    """(N, T, C, H, W) -> (N, L, kt*p*p*C): each tubelet's pixels in
    (t, h, w, c) order, tokens in (t, h, w) order."""
    n, t, c, h, w = video.shape
    x = video.reshape(n, t // kt, kt, c, h // p, p, w // p, p)
    x = x.permute(0, 1, 4, 6, 2, 5, 7, 3)
    return x.reshape(n, (t // kt) * (h // p) * (w // p), kt * p * p * c)


class Model:
    def __init__(self, cfg: dict, precision: str, device):
        self.m = m = cfg["config"]["model"]
        self.precision, self.device = precision, device
        self.slots = m["num_frames"] // m["tubelet_size"]
        self.spatial = (m["image_size"] // m["patch_size"]) ** 2
        self.length = self.slots * self.spatial
        self.pos_enc = sincos_1d(m["hidden_size"], self.length).to(device)
        self.pos_dec = sincos_1d(m["decoder_hidden_size"],
                                 self.length).to(device)
        self.mean = torch.tensor(MEAN, device=device).reshape(1, 1, 3, 1, 1)
        self.std = torch.tensor(STD, device=device).reshape(1, 1, 3, 1, 1)

    def dense(self, p, name, x):
        return plain.matmul(x, p[f"{name}.kernel"], self.precision) \
            + p[f"{name}.bias"]

    def layer_norm(self, p, name, x):
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.scale"],
                            p[f"{name}.bias"], self.m["layer_norm_eps"])

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

    def transform(self, trials_u8: torch.Tensor) -> torch.Tensor:
        """(N, frames, 1, H, W) uint8 trials -> (N, 16, 3, S, S)."""
        m, size = self.m, self.m["image_size"]
        frames = trials_u8.shape[1]
        idx = (np.linspace(0, 1, m["num_frames"])
               * (frames - 1)).astype(int)
        x = trials_u8[:, torch.from_numpy(idx).to(trials_u8.device)]
        x = x.float() / 255.0
        n, t, c, h, w = x.shape
        if (h, w) != (size, size):
            x = F.interpolate(x.reshape(n * t, c, h, w), size=(size, size),
                              mode="bilinear", align_corners=False,
                              antialias=h > size or w > size)
            x = x.reshape(n, t, c, size, size)
        x = x.expand(n, t, 3, size, size)
        return (x - self.mean) / self.std

    def target(self, video: torch.Tensor) -> torch.Tensor:
        m = self.m
        x = tubelets(video * self.std + self.mean, m["tubelet_size"],
                     m["patch_size"])
        n, length, _ = x.shape
        x = x.reshape(n, length, -1, 3)
        x = (x - x.mean(dim=-2, keepdim=True)) / (
            x.var(dim=-2, unbiased=True, keepdim=True).sqrt() + 1e-6)
        return x.reshape(n, length, -1)

    def mask(self, n: int, mask_seed: int) -> torch.Tensor:
        """(n, L) bool, True where masked: whole tubes."""
        gen = torch.Generator(device=self.device).manual_seed(mask_seed)
        noise = torch.rand((n, self.spatial), generator=gen,
                           device=self.device)
        keep = self.spatial - int(self.m["mask_ratio"] * self.spatial)
        order = torch.argsort(noise, dim=1, stable=True)
        spatial = torch.ones((n, self.spatial), dtype=torch.bool,
                             device=self.device)
        spatial[torch.arange(n, device=self.device)[:, None],
                order[:, :keep]] = False
        return spatial.repeat(1, self.slots)

    def masked_error(self, p: dict, trials_u8: torch.Tensor,
                     masked: torch.Tensor) -> torch.Tensor:
        """The sum over the masked tubelets of their mean squared error,
        for the clips of ``trials_u8``; ``masked`` (N, L) bool."""
        m = self.m
        video = self.transform(trials_u8)
        n = video.shape[0]
        x = plain.matmul(tubelets(video, m["tubelet_size"], m["patch_size"]),
                         p["patch_embed.Conv_0.kernel"].reshape(
                             -1, m["hidden_size"]), self.precision) \
            + p["patch_embed.Conv_0.bias"]
        x = x + self.pos_enc
        d = x.shape[-1]
        vis = (~masked).nonzero()[:, 1].reshape(n, -1)   # token order
        hid = masked.nonzero()[:, 1].reshape(n, -1)
        x = torch.gather(x, 1, vis[:, :, None].expand(-1, -1, d))
        for i in range(m["num_hidden_layers"]):
            x = self.block(p, f"encoder.Block_{i}", x,
                           m["num_attention_heads"])
        x = self.layer_norm(p, "encoder.LayerNorm_0", x)
        y = self.dense(p, "decoder_embed", x)
        dd = y.shape[-1]
        full = p["mask_token"].expand(n, self.length, dd).clone()
        full = full.scatter(1, vis[:, :, None].expand(-1, -1, dd), y)
        y = full + self.pos_dec
        for i in range(m["decoder_num_hidden_layers"]):
            y = self.block(p, f"decoder.Block_{i}", y,
                           m["decoder_num_attention_heads"])
        y = self.layer_norm(p, "decoder.LayerNorm_0", y)
        pred = self.dense(p, "decoder_pred", y)
        pred = torch.gather(pred, 1,
                            hid[:, :, None].expand(-1, -1, pred.shape[-1]))
        target = torch.gather(self.target(video), 1,
                              hid[:, :, None].expand(-1, -1,
                                                     pred.shape[-1]))
        return ((pred - target) ** 2).mean(dim=-1).sum()


def param_specs(cfg: dict) -> dict:
    """The model's leaves and the init the recipe states (flax's, as the
    program's ``reset_parameters`` draws them): ``name -> (shape, init,
    fan-in)``, lecun_normal kernels, zero biases, unit LayerNorm scales,
    the mask token normal at ``initializer_range``."""
    m = cfg["config"]["model"]
    d, dd, pp = m["hidden_size"], m["decoder_hidden_size"], m["patch_size"]
    kt, c = m["tubelet_size"], m["num_channels"]
    out = {}

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

    out["patch_embed.Conv_0.kernel"] = ((kt, pp, pp, c, d), "lecun",
                                        kt * pp * pp * c)
    out["patch_embed.Conv_0.bias"] = ((d,), "zeros", 0)
    blocks("encoder", m["num_hidden_layers"], d, m["intermediate_size"])
    dense("decoder_embed", d, dd)
    out["mask_token"] = ((1, 1, dd), "normal", m["initializer_range"])
    blocks("decoder", m["decoder_num_hidden_layers"], dd,
           m["decoder_intermediate_size"])
    dense("decoder_pred", dd, kt * pp * pp * c)
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


def step_grads(model: Model, params: dict, trials, mask_seed: int):
    """(loss, gradients) of one step over ``trials`` (N, frames, 1, H, W)
    uint8, taken in blocks of ``BLOCK`` clips: each block's masked error
    over the whole batch's masked tubelets, the gradients summed."""
    masked = model.mask(trials.shape[0], mask_seed)
    total = float(masked.sum())
    names = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = 0.0
    for s in range(0, trials.shape[0], BLOCK):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        part = model.masked_error(
            leaves, torch.as_tensor(trials[s:s + BLOCK]).to(model.device),
            masked[s:s + BLOCK]) / total
        got = torch.autograd.grad(part, [leaves[k] for k in names],
                                  allow_unused=True)
        for k, g in zip(names, got):
            if g is not None:
                grads[k] += g
        loss += float(part.detach())
        del leaves, part, got
    return loss, grads


def reference_steps(cfg: dict, traffic: dict, p0: dict, batches: list,
                    seeds: list, device, precision: str = "f32",
                    fault: str = None) -> dict:
    """The first ``len(batches)`` steps from ``p0``. Each batch is
    ``(uint8 trials (B, frames, 1, H, W), masking seed)``; ``seeds`` are
    unused (the store is f32). ``fault="half_batch"`` keeps the first half
    of each batch's clips; ``fault="state_unchanged"`` updates nothing."""
    opt = cfg["config"]["optimizer"]
    with plain.exact_f32():
        model = Model(cfg, precision, device)
        params = {k: v.to(device).float() for k, v in p0.items()}
        start = {k: v.clone() for k, v in params.items()}
        tx = plain.AdamW(opt.get("wd", 0.01), opt.get("eps", 1e-8))
        losses, grad_norms = [], None
        for trials, mask_seed in batches:
            if fault == "half_batch":
                trials = trials[: trials.shape[0] // 2]
            loss, grads = step_grads(model, params, trials, mask_seed)
            losses.append(loss)
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
