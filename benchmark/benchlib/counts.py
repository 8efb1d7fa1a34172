"""Operations and bytes computed from shapes, so that a share of a roofline
or of the peak reads the same work whatever implements it."""

from __future__ import annotations

from . import peaks


def fused_readout_bytes(m: int, n: int, b: int) -> int:
    """HBM bytes of one fused readout update W <- SR(W + xaᵀ @ dzc) on a
    bf16 (M, N) W at batch B: W read and written once, xa (B, M) and dzc
    (B, N) in f32 read once."""
    return 2 * m * n * 2 + b * m * 4 + b * n * 4


def fused_readout_flops(m: int, n: int, b: int) -> int:
    """f32 FLOPs of the rank-B product xaᵀ @ dzc (2 a multiply-add)."""
    return 2 * b * m * n


def fused_readout_bound_s(m: int, n: int, b: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the f32 FLOPs over the f32 (non-tensor-core) peak."""
    return max(fused_readout_bytes(m, n, b) / peaks.HBM_BYTES_PER_S,
               fused_readout_flops(m, n, b) / peaks.F32_FLOP_PER_S)


def mlp_train_flops(dims, batch: int) -> int:
    """Matmul FLOPs of one training step of a stack of Dense layers with
    widths ``dims`` (input first) at ``batch`` rows: the forward, the
    weight gradient of every layer and the input gradient of every layer
    but the first (the input needs none). No recomputation."""
    total = 0
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        total += (4 if i == 0 else 6) * batch * a * b
    return total


def linear_model_dims(model_cfg: dict) -> tuple:
    enc, dec = model_cfg["encoder"], model_cfg["decoder"]
    return ((enc["input_dim"], *enc["hidden_dims"], enc["output_dim"]),
            (dec["input_dim"], *dec["hidden_dims"], dec["output_dim"]))


def linear_train_flops(model_cfg: dict, batch: int) -> int:
    """A LinearModel training step: the encoder (its first layer needs no
    input gradient) and the decoder (every layer does)."""
    enc, dec = linear_model_dims(model_cfg)
    return mlp_train_flops(enc, batch) + (
        mlp_train_flops(dec, batch) + 2 * batch * dec[0] * dec[1])


def vit_block_flops(rows: int, seq: int, dim: int, mlp: int) -> int:
    """Forward matmul FLOPs of one pre-norm transformer block over ``rows``
    sequences of ``seq`` tokens: qkv, scores, P·V, the projection and the
    two MLP layers."""
    n = rows * seq
    return (2 * n * dim * 3 * dim + 2 * 2 * rows * seq * seq * dim
            + 2 * n * dim * dim + 2 * 2 * n * dim * mlp)


def vit_mae_forward_flops(m: dict, frames: int) -> int:
    """Forward matmul FLOPs of ViT-MAE over ``frames`` images at the
    config's mask ratio: the patch embedding of every patch, the encoder
    over the kept patches and CLS, the decoder embedding, the decoder over
    every patch and CLS, the pixel head and the embedding projection."""
    p, c = m["patch_size"], m["num_channels"]
    d, dd = m["hidden_size"], m["decoder_hidden_size"]
    length = (m["image_size"] // p) ** 2
    enc_seq = int(length * (1 - m["mask_ratio"])) + 1
    dec_seq = length + 1
    return (2 * frames * length * p * p * c * d
            + m["num_hidden_layers"] * vit_block_flops(
                frames, enc_seq, d, m["intermediate_size"])
            + 2 * frames * enc_seq * d * dd
            + m["decoder_num_hidden_layers"] * vit_block_flops(
                frames, dec_seq, dd, m["decoder_intermediate_size"])
            + 2 * frames * dec_seq * dd * p * p * c
            + 2 * frames * d * m["embed_size"])


def vit_mae_train_flops(m: dict, frames: int) -> int:
    """Forward and backward: three times the forward's matmul FLOPs."""
    return 3 * vit_mae_forward_flops(m, frames)
