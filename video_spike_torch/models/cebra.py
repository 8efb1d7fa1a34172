"""CEBRA-style temporal contrastive embedder and PCA embedding.

Counterpart of ``video_spike_tpu/models/cebra.py`` (reference
``src/utils/utils.py:306-360``: offset10-model, out_dim 3-5, 5000
iterations, batch 512):

- :class:`Offset10Encoder`: a 1-D temporal conv encoder with a 10-frame
  receptive field (kernel 2, three residual kernel-3 blocks, kernel 3; VALID
  padding, tanh GELU as flax's ``nn.gelu``), unit-norm output. The kernels
  keep flax's ``(k, in, out)`` layout under flax's names (``Conv_0.kernel``
  ...), so ``convert.flax_to_torch`` carries them over as they are. Each
  conv is one matmul of the input with the ``(in, k·out)`` view of its
  kernel, the k shifted output slices summed: no cuDNN convolution, so no
  TF32 rounding under PyTorch's default backend flags;
- :class:`CEBRA`: InfoNCE with temporal positives, trained in place by Adam
  (``ops/optim.AdamW`` with no weight decay, ``optax.adam``'s numerics).
  The anchors, offsets and negatives are drawn on the device from a
  ``torch.Generator``; ``step`` takes them as arguments. The fit loop never
  syncs with the host: the losses of every 100th iteration stay on the
  device and are copied once at the end;
- :func:`get_cebra_embedding` / :func:`get_pca_embedding` with the
  reference's (N, T, C, H, W) video conventions and output shapes; PCA
  through the Gram matrix when there are fewer frames than pixels, the
  covariance otherwise.

``jax.random`` streams cannot be reproduced, so a fit matches the JAX
package in its statistics and a step at given indices matches it exactly.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_spike_torch.core.device import resolve_device
from video_spike_torch.models.linear import lecun_normal_
from video_spike_torch.ops.contrastive import info_nce
from video_spike_torch.ops.optim import AdamW
from video_spike_torch.ops.step import train_step

RECEPTIVE_FIELD = 10
LOSS_EVERY = 100     # losses_ keeps the loss of every 100th iteration


class Conv1d(nn.Module):
    """flax ``nn.Conv(features, kernel_size=(k,), padding="VALID")`` on a
    (B, T, C) input: ``kernel`` (k, in, out), ``bias`` (out,)."""

    def __init__(self, in_features: int, features: int, k: int,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, in_features, features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        k, c, _ = self.kernel.shape
        lecun_normal_(self.kernel, k * c, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, c, out = self.kernel.shape
        t = x.shape[1] - k + 1
        # y[:, s] = sum_i x[:, s + i] @ kernel[i] + bias
        proj = x @ self.kernel.permute(1, 0, 2).reshape(c, k * out)
        y = self.bias
        for i in range(k):
            y = y + proj[:, i:i + t, i * out:(i + 1) * out]
        return y


class Offset10Encoder(nn.Module):
    """Temporal conv encoder, receptive field 10, normalized output."""

    def __init__(self, in_dim: int, num_units: int = 32, out_dim: int = 3,
                 device=None):
        super().__init__()
        self.num_units, self.out_dim = num_units, out_dim
        self.Conv_0 = Conv1d(in_dim, num_units, 2, device)
        for i in range(1, 4):
            self.add_module(f"Conv_{i}", Conv1d(num_units, num_units, 3,
                                                device))
        self.Conv_4 = Conv1d(num_units, out_dim, 3, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``init``'s distributions: lecun_normal over k·in, zero
        biases, in layer order."""
        for i in range(5):
            getattr(self, f"Conv_{i}").reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, d) -> (B, T - 9, out_dim)
        x = F.gelu(self.Conv_0(x), approximate="tanh")
        for i in range(1, 4):
            y = F.gelu(getattr(self, f"Conv_{i}")(x), approximate="tanh")
            x = x[:, 1:-1] + y  # residual, trimmed to VALID output
        x = self.Conv_4(x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=1e-12)


class CEBRA:
    """Temporal-contrastive embedding with the CEBRA training recipe."""

    def __init__(self, output_dimension: int = 3, num_units: int = 32,
                 batch_size: int = 512, max_iterations: int = 5000,
                 time_offset: int = 10, learning_rate: float = 3e-4,
                 temperature: float = 1.0, seed: int = 0, device="cuda"):
        self.out_dim = output_dimension
        self.num_units = num_units
        self.batch_size = batch_size
        self.max_iterations = max_iterations
        self.time_offset = time_offset
        self.temperature = temperature
        self.seed = seed
        self.device = resolve_device(device)
        self.tx = AdamW(learning_rate, weight_decay=0.0)   # optax.adam
        self.model: Optional[Offset10Encoder] = None
        self.params: Optional[dict] = None
        self.losses_: list = []
        self.fit_seconds_ = 0.0

    # ------------------------------------------------------------------
    @staticmethod
    def _windows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Gather (B, RECEPTIVE_FIELD, d) windows starting at idx."""
        offs = torch.arange(RECEPTIVE_FIELD, device=idx.device)
        return X[idx[:, None] + offs[None, :]]

    def loss(self, params: Mapping[str, torch.Tensor], X: torch.Tensor,
             anchor: torch.Tensor, delta: torch.Tensor,
             negi: torch.Tensor) -> torch.Tensor:
        """InfoNCE of the reference, positive and negative windows, run as
        one (3B, 10, d) batch."""
        idx = torch.cat([anchor, anchor + delta, negi]).long()
        z = torch.func.functional_call(self.model, dict(params),
                                       (self._windows(X, idx),))[:, 0]
        ref, pos, neg = z.split(anchor.shape[0])
        return info_nce(ref, pos, neg, self.temperature)["loss"]

    def step(self, params: Mapping[str, torch.Tensor], opt_state: dict,
             X: torch.Tensor, anchor: torch.Tensor, delta: torch.Tensor,
             negi: torch.Tensor):
        """One Adam step at the given indices, in place: (params,
        opt_state, loss)."""
        params, opt_state, loss, _ = train_step(
            lambda leaves: (self.loss(leaves, X, anchor, delta, negi), None),
            params, opt_state, self.tx)
        return params, opt_state, loss

    def sample(self, generator: torch.Generator, max_start: int):
        """(anchor, delta, negi) for one step, drawn on the device with the
        ranges of the JAX package's fit."""
        def draw(lo, hi):
            return torch.randint(lo, hi, (self.batch_size,),
                                 generator=generator, device=self.device)

        return (draw(0, max_start), draw(1, self.time_offset + 1),
                draw(0, max_start))

    def init_params(self, in_dim: int, generator: torch.Generator) -> dict:
        self.model = Offset10Encoder(in_dim, self.num_units, self.out_dim,
                                     device=self.device)
        self.model.reset_parameters(generator)
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def fit(self, X: np.ndarray) -> "CEBRA":
        """X: (n_samples, d) time series."""
        dev = self.device
        X = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(dev)
        n = X.shape[0]
        max_start = n - RECEPTIVE_FIELD - self.time_offset - 1
        assert max_start > 1, f"series too short: {n}"
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        params = self.init_params(X.shape[1], gen)
        opt_state = self.tx.init(params)
        iters = self.max_iterations
        trace = torch.zeros(-(-iters // LOSS_EVERY), device=dev)
        t0 = time.perf_counter()
        for i in range(iters):
            params, opt_state, loss = self.step(
                params, opt_state, X, *self.sample(gen, max_start))
            if i % LOSS_EVERY == 0:
                trace[i // LOSS_EVERY] = loss
        self.losses_ = trace.cpu().tolist()        # the fit's one sync
        self.fit_seconds_ = time.perf_counter() - t0
        self.params = params
        return self

    @torch.inference_mode()
    def transform(self, X: np.ndarray) -> np.ndarray:
        """Embed every timestep; edges are replicate-padded so the output
        length matches the input (cebra.transform convention)."""
        assert self.params is not None, "fit first"
        X = np.asarray(X, dtype=np.float32)
        left = RECEPTIVE_FIELD // 2
        right = RECEPTIVE_FIELD - 1 - left
        Xp = np.concatenate([np.repeat(X[:1], left, 0), X,
                             np.repeat(X[-1:], right, 0)], axis=0)
        x = torch.from_numpy(Xp).to(self.device)[None]
        out = torch.func.functional_call(self.model, self.params, (x,))[0]
        emb = out.cpu().numpy()
        assert emb.shape[0] == X.shape[0], (emb.shape, X.shape)
        return emb


def _frames(video: np.ndarray) -> np.ndarray:
    video = np.asarray(video)
    return video.squeeze(2) if video.ndim == 5 else video


def get_cebra_embedding(video: np.ndarray, out_dim: int = 3,
                        save_path: Optional[str] = None,
                        max_iterations: int = 5000, batch_size: int = 512,
                        device="cuda", return_model: bool = False):
    """(N, T, C, H, W) grayscale video -> (N, T, out_dim) embedding
    (parity with ``/root/reference/src/utils/utils.py:306-330``); with
    ``return_model`` also the fitted :class:`CEBRA`. ``save_path`` writes
    ``<save_path>_loss.png`` and ``<save_path>_embedding.png`` (needs
    matplotlib)."""
    data = _frames(video)
    n, t = data.shape[:2]
    flat = data.reshape(n * t, -1)
    model = CEBRA(output_dimension=out_dim, batch_size=batch_size,
                  max_iterations=max_iterations, device=device)
    model.fit(flat)
    emb = model.transform(flat)
    assert emb.shape == (n * t, out_dim)
    if save_path:
        from video_spike_torch.viz import pyplot
        from video_spike_torch.viz.embeddings import plot_embeddings

        plt = pyplot()
        fig, ax = plt.subplots()
        ax.plot(model.losses_)
        ax.set_xlabel("iteration / 100")
        ax.set_ylabel("InfoNCE loss")
        fig.savefig(save_path + "_loss.png")
        plt.close(fig)
        fig = plot_embeddings(emb[:2000])
        fig.savefig(save_path + "_embedding.png")
        plt.close(fig)
    emb = emb.reshape(n, t, out_dim)
    return (emb, model) if return_model else emb


@torch.inference_mode()
def get_pca_embedding(video: np.ndarray, out_dim: int = 5,
                      device="cuda") -> np.ndarray:
    """(N, T, C, H, W) video -> (N, T, out_dim) PCA projection on the
    device, through the eigendecomposition of the (n·t)² Gram matrix when
    there are no more frames than pixels, of the d² covariance otherwise.
    Columns come out in descending variance; each is defined up to sign."""
    dev = resolve_device(device)
    data = _frames(video)
    n, t = data.shape[:2]
    flat = torch.from_numpy(np.ascontiguousarray(
        data.reshape(n * t, -1))).to(dev).float()
    centered = flat - flat.mean(dim=0, keepdim=True)
    m, d = centered.shape
    if m <= d:
        vals, vecs = torch.linalg.eigh(centered @ centered.T)
        vals, vecs = vals.flip(0)[:out_dim], vecs.flip(1)[:, :out_dim]
        # principal scores = U * s = eigvecs * sqrt(eigvals)
        emb = vecs * torch.sqrt(torch.clamp(vals, min=0))
    else:
        _, vecs = torch.linalg.eigh(centered.T @ centered)
        emb = centered @ vecs.flip(1)[:, :out_dim]
    emb = emb.cpu().numpy()
    assert emb.shape == (m, out_dim)
    return emb.reshape(n, t, out_dim)
