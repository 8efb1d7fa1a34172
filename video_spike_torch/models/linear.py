"""Linear (MLP) video->spike readout.

Counterpart of ``video_spike_tpu/models/linear.py`` (reference
``src/model/linear.py:3-56``): an encoder MLP (hidden dims + ReLU, linear
head) into a decoder MLP, applied to the flattened input, output reshaped to
(B, T_bins, N) with ``T_bins = 100``.

Every Dense keeps flax's layout: an ``(in, out)`` ``kernel`` parameter used as
``x @ kernel + bias``, named ``encoder.Dense_0.kernel`` and so on like the flax
tree's ``params/encoder/Dense_0/kernel``. (``nn.Linear``'s (out, in) layout
would change every stochastic-rounding bit, which is keyed by the flat index
of the (in, out) kernel.) Kernels start from flax's ``lecun_normal`` (a
normal truncated at two standard deviations, variance 1/fan_in) and biases
from zeros. For raw video the first kernel is (1,966,080, 256), ~503M
parameters.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from video_spike_torch.ops.dense import dense, preprocess_flat
from video_spike_torch.parallel.tensor import column_dense, row_dense

# flax's variance_scaling "truncated_normal": stddev / this constant is the
# untruncated std whose [-2, 2]-truncated draw has the target variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax ``lecun_normal`` in place: variance 1/fan_in, truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class Dense(nn.Module):
    """``flax.linen.Dense`` with an (in, out) kernel; the compute dtype is
    the caller's (``dense`` casts both operands).
    ``parallel/tensor.split_over_model`` gives a layer whose kernel is held
    split over the ``model`` axis that axis's group and the kernel's split
    dimension (0 rows, 1 columns)."""

    model_group = None
    split_dim = None

    def __init__(self, in_features: int, out_features: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, **kw))
        self.bias = nn.Parameter(torch.empty(out_features, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        with torch.no_grad():
            self.bias.zero_()


def layer_dense(layer: Dense, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``dense`` through a ``Dense`` layer's kernel and bias; a layer given
    a ``model_group`` holds its kernel's row or column block and runs as a
    row- or column-split Dense over that group (``parallel/tensor``)."""
    if layer.model_group is None:
        return dense(x, layer.kernel, layer.bias, dtype)
    split = row_dense if layer.split_dim == 0 else column_dense
    return split(x, layer.kernel, layer.bias, dtype, layer.model_group)


class MLP(nn.Module):
    """Hidden Dense layers with ReLU, then a linear head; the layers are
    named ``Dense_0 ... Dense_{len(hidden_dims)}`` like flax's."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = [input_dim, *hidden_dims, output_dim]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}",
                            Dense(dims[i], dims[i + 1], device=device))

    def layer(self, i: int) -> Dense:
        return getattr(self, f"Dense_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            d = self.layer(i)
            x = layer_dense(d, x, self.compute_dtype)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


class LinearModel(nn.Module):
    """Encoder/decoder MLP emitting per-bin log-rates."""

    def __init__(self, input_dim: int, encoder_hidden: Sequence[int],
                 encoder_out: int, decoder_hidden: Sequence[int],
                 output_dim: int, t_bins: int = 100,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.input_dim = input_dim
        self.encoder_hidden = tuple(encoder_hidden)
        self.encoder_out = encoder_out
        self.decoder_hidden = tuple(decoder_hidden)
        self.output_dim = output_dim          # T_bins * n_neurons
        self.t_bins = t_bins
        self.compute_dtype = compute_dtype
        self.encoder = MLP(input_dim, self.encoder_hidden, encoder_out,
                           compute_dtype, device)
        self.decoder = MLP(encoder_out, self.decoder_hidden, output_dim,
                           compute_dtype, device)

    @classmethod
    def from_config(cls, config, device=None,
                    compute_dtype=torch.bfloat16) -> "LinearModel":
        """Build from a model config with encoder/decoder sections (the
        reference's ``config/model/linear_*.yaml`` schema); the input and
        output dims must be filled in, as ``cli/train.py`` does from data."""
        return cls(
            input_dim=config.encoder.input_dim,
            encoder_hidden=tuple(config.encoder.hidden_dims),
            encoder_out=config.encoder.output_dim,
            decoder_hidden=tuple(config.decoder.hidden_dims),
            output_dim=config.decoder.output_dim,
            compute_dtype=compute_dtype,
            device=device,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``init``: lecun_normal kernels, zero biases, in layer order."""
        for mlp in (self.encoder, self.decoder):
            for i in range(mlp.n_layers):
                mlp.layer(i).reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        # raw pixels are scaled to [0, 1] in the compute dtype (the
        # reference feeds 0-255 straight in, which overflows the exp link)
        x = preprocess_flat(self, x)
        x = self.decoder(self.encoder(x))
        return x.float().reshape(b, self.t_bins, self.output_dim // self.t_bins)


def first_layer_sharding_rules(params, mesh, min_dim: int = 1 << 18):
    """A placement per leaf of a flat params dict: 2-D kernels whose input
    dimension is at least `min_dim` split their rows over the ``model``
    axis (the contraction is then a partial product per rank and one
    all-reduce); everything else is replicated."""
    from video_spike_torch.parallel.mesh import Placement

    return {k: Placement(mesh, "model" if k.endswith("kernel")
                         and v.ndim == 2 and v.shape[0] >= min_dim else None)
            for k, v in params.items()}
