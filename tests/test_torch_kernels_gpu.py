"""The port's hand-written CUDA kernels against their plain torch versions,
on a CUDA card.

A CUDA kernel has no CPU mode, so every test here carries the ``gpu`` marker
and skips on a host without a card. The file imports neither JAX nor the
JAX package (the plain versions are held against JAX in
``tests/test_torch_fused_readout.py``), so on a CUDA host without JAX it runs
apart from ``tests/conftest.py``, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tolerances: bitwise on exact-sum inputs (small integers times powers of two,
so every f32 rank-B sum is exact in any order); on random inputs >= 99.9%
bitwise and every element within 1 bf16 ulp plus the f32 error bound of
the rank-B sum (the kernel's summation order may differ from torch's
matmul, which can flip a rounding).
"""

import numpy as np
import pytest
import torch

from video_spike_torch.ops import fused_readout as tfr

torch.set_num_threads(1)

SEEDS = (0, 7, 2**32 - 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _exact_factors(rng, b, m, n):
    """xa, dzc whose f32 rank-b sums are exact in any order, ~2^-10 of W."""
    xa = rng.integers(-7, 8, (b, m)).astype(np.float32) * np.float32(2.0**-8)
    dzc = rng.integers(-7, 8, (b, n)).astype(np.float32) * np.float32(2.0**-12)
    return torch.from_numpy(xa), torch.from_numpy(dzc)


def _random_w(rng, m, n) -> torch.Tensor:
    return torch.from_numpy(
        rng.normal(size=(m, n)).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4133, 32])     # ragged last tile; one tile
def test_cuda_kernel_matches_plain(cuda_device, m):
    rng = np.random.default_rng(5)
    n, b = 256, 16
    w = _random_w(rng, m, n)
    xa, dzc = _exact_factors(rng, b, m, n)
    for seed in SEEDS:
        ref = tfr._apply_scaled_outer_plain(w, xa, dzc, seed)
        w_d = w.to(cuda_device)
        before = tfr.apply_scaled_outer.launches
        out = tfr.apply_scaled_outer(w_d, xa.to(cuda_device),
                                     dzc.to(cuda_device), seed)
        torch.cuda.synchronize()
        assert out.data_ptr() == w_d.data_ptr()          # in place
        assert tfr.apply_scaled_outer.launches == before + 1
        np.testing.assert_array_equal(_bf16_bits(w_d), _bf16_bits(ref))


@pytest.mark.gpu
def test_cuda_kernel_random_inputs_within_one_ulp(cuda_device):
    rng = np.random.default_rng(6)
    m, n, b = 20_000, 256, 16
    w = _random_w(rng, m, n)
    xa = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32) * 1e-2)
    dzc = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32) * 1e-2)
    ref = tfr._apply_scaled_outer_plain(w, xa, dzc, 3).float()
    w_d = w.to(cuda_device)
    tfr.apply_scaled_outer(w_d, xa.to(cuda_device), dzc.to(cuda_device), 3)
    got = w_d.cpu().float()
    assert (got == ref).float().mean().item() >= 0.999
    big = torch.maximum(got.abs(), ref.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    err = b * 2.0**-24 * (xa.abs().T @ dzc.abs())
    assert bool(((got - ref).abs() <= ulp + err).all())


@pytest.mark.gpu
def test_cuda_tensor_never_takes_the_plain_version(cuda_device):
    """A bf16 W on the card that the kernel cannot take raises; it is not
    handed to the plain version."""
    w = torch.zeros(64, 256, dtype=torch.bfloat16, device=cuda_device)
    xa = torch.zeros(4, 256, device=cuda_device)
    dzc = torch.zeros(4, 64, device=cuda_device)
    before = tfr.apply_scaled_outer.launches
    with pytest.raises(ValueError, match="contiguous"):
        tfr.apply_scaled_outer(w.t(), xa, dzc, 0)
    assert tfr.apply_scaled_outer.launches == before
