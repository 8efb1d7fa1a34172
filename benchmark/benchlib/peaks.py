"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit):
NVIDIA's data sheet. Roofline and MFU shares are taken against these, with
the card's power limit printed beside them."""

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12        # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
