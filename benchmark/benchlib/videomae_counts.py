"""Operations and bytes of VideoMAE's masked-video pretraining step,
computed from the configuration's shapes, so that ``step_mfu`` and the
attention's share of its roofline read the same work whatever implements
it."""

from __future__ import annotations

from . import peaks
from .counts import vit_block_flops


def tokens(m: dict) -> tuple:
    """(tokens of a clip, visible tokens under tube masking)."""
    slots = m["num_frames"] // m["tubelet_size"]
    spatial = (m["image_size"] // m["patch_size"]) ** 2
    return (slots * spatial,
            slots * (spatial - int(m["mask_ratio"] * spatial)))


def forward_flops(m: dict, clips: int) -> int:
    """Forward matmul FLOPs over ``clips`` clips: the tubelet embedding of
    every tubelet, the encoder over the visible tokens, the decoder
    embedding, the decoder over every token and the pixel head on every
    token (the visible ones' predictions are computed too)."""
    length, visible = tokens(m)
    pixels = m["tubelet_size"] * m["patch_size"] ** 2 * m["num_channels"]
    d, dd = m["hidden_size"], m["decoder_hidden_size"]
    return (2 * clips * length * pixels * d
            + m["num_hidden_layers"] * vit_block_flops(
                clips, visible, d, m["intermediate_size"])
            + 2 * clips * visible * d * dd
            + m["decoder_num_hidden_layers"] * vit_block_flops(
                clips, length, dd, m["decoder_intermediate_size"])
            + 2 * clips * length * dd * pixels)


def train_flops(m: dict, clips: int) -> int:
    """Forward and backward: three times the forward's matmul FLOPs."""
    return 3 * forward_flops(m, clips)


def attention_flops(rows: int, seq: int, dim: int) -> int:
    """Matmul FLOPs of one layer's attention core over ``rows`` sequences
    of ``seq`` tokens, ``dim`` wide over its heads: q kᵀ and P v forward,
    and the four products of the backward (dV, dP, dQ, dK)."""
    return 6 * 2 * rows * seq * seq * dim


def attention_bytes(rows: int, seq: int, dim: int) -> int:
    """The least HBM bytes of one layer's attention core: q, k, v, the
    output and each one's gradient, once each in bf16."""
    return 8 * rows * seq * dim * 2


def attention(m: dict, clips: int) -> tuple:
    """(FLOPs, bytes) of a training step's attention cores, every layer of
    the encoder (visible tokens) and the decoder (every token)."""
    length, visible = tokens(m)
    layers = ((m["num_hidden_layers"], visible, m["hidden_size"]),
              (m["decoder_num_hidden_layers"], length,
               m["decoder_hidden_size"]))
    return (sum(n * attention_flops(clips, s, d) for n, s, d in layers),
            sum(n * attention_bytes(clips, s, d) for n, s, d in layers))


def attention_bound_s(flops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the FLOPs at the
    bf16 dense peak (bf16 inputs, each product exact in f32, as tensor
    cores accumulate) and the bytes at the HBM rate."""
    return max(flops / peaks.BF16_FLOP_PER_S,
               nbytes / peaks.HBM_BYTES_PER_S)
