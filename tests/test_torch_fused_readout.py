"""PyTorch port of ops/fused_readout (and its SR hash) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. The JAX
Pallas kernel runs in interpret mode, as tests/test_fused_readout.py runs
it. Tolerances:

- hash bits, SR epilogue: bitwise (integer arithmetic);
- the plain ``_apply_scaled_outer`` on exact-sum inputs (small integers
  times powers of two, so every f32 sum is exact in any order): bitwise;
  on random inputs: >= 99.9% bitwise and every element within 1 bf16 ulp
  plus the f32 error bound of the rank-B sum (the sum may round
  differently between XLA and torch, which can flip an SR decision, and
  where W + upd cancels to near zero the bf16 ulp is finer than that
  error);
- ``lowrank_row_col_sq``: rtol 1e-5 (eigh basis and f32 summation order);
- chained updates: f32 state rtol 1e-5, bf16 kernel as above per step.

The CUDA kernel against the plain version, on a card, is in
``tests/test_torch_kernels_gpu.py`` (a file without JAX, so it also runs on a
CUDA host that has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_spike_tpu.ops import fused_readout as jfr
from video_spike_tpu.ops import optim as joptim
from video_spike_torch.ops import fused_readout as tfr
from video_spike_torch.ops import optim as toptim

torch.set_num_threads(1)

B, M, N = 8, 384, 256
SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**31, 2**32 - 1]


def _bf16_bits(x) -> np.ndarray:
    """uint16 bit patterns of a bf16 array from either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _ulp_diff(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps between two bf16 bit patterns (same sign)."""
    def ordered(u):
        u = u.astype(np.int64)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)
    return np.abs(ordered(a_bits) - ordered(b_bits))


def _within_sr_tolerance(a_bits, b_bits, f32_err):
    """Elementwise |a - b| <= 1 bf16 ulp at max(|a|, |b|) + f32_err.

    Two SR roundings of sums that differ only by f32 rounding land at most
    one bf16 ulp apart, unless the sum cancels to near zero, where the bf16
    ulp is finer than the f32 error of the update (f32_err bounds it)."""
    fa = (a_bits.astype(np.uint32) << 16).view(np.float32)
    fb = (b_bits.astype(np.uint32) << 16).view(np.float32)
    big = np.maximum(np.abs(fa), np.abs(fb))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-38))) - 7)
    return np.abs(fa - fb) <= ulp + f32_err


def _exact_factors(rng, b, m, n):
    """xa, dzc whose f32 rank-b sums are exact in any order, ~2^-10 of W."""
    xa = rng.integers(-7, 8, (b, m)).astype(np.float32) * np.float32(2.0**-8)
    dzc = rng.integers(-7, 8, (b, n)).astype(np.float32) * np.float32(2.0**-12)
    return xa, dzc


def _random_w(rng, m, n):
    return rng.normal(size=(m, n)).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_bits_matches_jax(seed):
    idx = np.array([0, 1, 2, 255, 256, 65535, 65536, 2**31 - 1, 2**31,
                    2**32 - 2, 2**32 - 1], dtype=np.uint32)
    ref = np.asarray(jfr._mix_bits(jnp.asarray(idx), jnp.uint32(seed)))
    got = tfr._mix_bits(torch.from_numpy(idx.astype(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


@pytest.mark.parametrize("seed,leaf_id", [(0, 1), (7, 2), (2**32 - 1, 3),
                                          (123456789, 1000)])
def test_hash_bits_matches_jax(seed, leaf_id):
    n = 70_000
    ref = np.asarray(joptim._hash_bits(jnp.uint32(seed), leaf_id, n))
    got = toptim._hash_bits(seed, leaf_id, n)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_sr_epilogue_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    w32 = _random_w(rng, 64, 128)
    w = jnp.asarray(w32).astype(jnp.bfloat16)
    upd = (rng.normal(size=w32.shape) * 1e-3).astype(np.float32)
    upd[0, :4] = [np.inf, -np.inf, 3e38, -3e38]   # carries into the exponent
    bits = rng.integers(0, 2**32, w32.shape, dtype=np.uint64).astype(np.uint32)
    ref = jfr._sr_add_to_bf16(w, jnp.asarray(upd), jnp.asarray(bits))
    w_t = torch.from_numpy(_bf16_bits(w).astype(np.int16)).view(torch.bfloat16)
    got = tfr._sr_add_to_bf16(w_t, torch.from_numpy(upd),
                              torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(ref))
    # ops/optim's rounding is the same function of the f32 sum
    s = np.asarray(w, np.float32) + upd
    ref2 = joptim._sr_to_bf16(jnp.asarray(s), jnp.asarray(bits))
    got2 = toptim._sr_to_bf16(torch.from_numpy(s),
                              torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(_bf16_bits(got2), _bf16_bits(ref2))


def _jax_pallas(w_bf16_np, xa, dzc, seed):
    w = jnp.asarray(w_bf16_np)
    return jfr._apply_scaled_outer_pallas(w, jnp.asarray(xa), jnp.asarray(dzc),
                                          jnp.uint32(seed), interpret=True)


def _torch_bf16(w32):
    return torch.from_numpy(w32).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_plain_apply_scaled_outer_bitwise_on_exact_sums(seed):
    rng = np.random.default_rng(seed % 1000)
    w32 = _random_w(rng, M, N)
    xa, dzc = _exact_factors(rng, B, M, N)
    w_t = _torch_bf16(w32)
    ref = _jax_pallas(_bf16_bits(w_t).view(jnp.bfloat16), xa, dzc, seed)
    got = tfr._apply_scaled_outer_plain(w_t, torch.from_numpy(xa),
                                        torch.from_numpy(dzc), seed)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(ref))
    # the public wrapper updates in place and takes the same path on CPU
    before = tfr.apply_scaled_outer.launches
    out = tfr.apply_scaled_outer(w_t, torch.from_numpy(xa),
                                 torch.from_numpy(dzc), seed)
    assert out is w_t and tfr.apply_scaled_outer.launches == before
    np.testing.assert_array_equal(_bf16_bits(w_t), _bf16_bits(ref))


def test_plain_apply_scaled_outer_wrapping_index():
    """Rows whose flat index row*N+col passes 2^32 wrap exactly like JAX's
    uint32 iota arithmetic (a row offset of 2^24 rows at N=256)."""
    n = 256
    rows = np.arange(2**24 - 3, 2**24 + 3, dtype=np.int64)
    flat = (rows[:, None] * n + np.arange(n)[None, :]) & 0xFFFFFFFF
    ref = np.asarray(jfr._mix_bits(jnp.asarray(flat.astype(np.uint32)),
                                   jnp.uint32(5)))
    got = tfr._mix_bits(torch.from_numpy(flat), 5).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, ref)


def test_plain_apply_scaled_outer_random_within_one_ulp():
    rng = np.random.default_rng(11)
    w32 = _random_w(rng, M, N)
    xa = rng.normal(size=(B, M)).astype(np.float32) * np.float32(1e-2)
    dzc = rng.normal(size=(B, N)).astype(np.float32) * np.float32(1e-2)
    w_t = _torch_bf16(w32)
    ref = _jax_pallas(_bf16_bits(w_t).view(jnp.bfloat16), xa, dzc, 9)
    got = tfr._apply_scaled_outer_plain(w_t, torch.from_numpy(xa),
                                        torch.from_numpy(dzc), 9)
    d = _ulp_diff(_bf16_bits(got), _bf16_bits(ref))
    assert (d == 0).mean() >= 0.999
    # f32 error bound of a B-term sum: B * 2^-24 * sum_b |xa_b dzc_b|
    err = B * 2.0**-24 * (np.abs(xa).T @ np.abs(dzc))
    assert _within_sr_tolerance(_bf16_bits(got), _bf16_bits(ref), err).all()


def test_lowrank_row_col_sq_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, M)).astype(np.float32)
    dz = (rng.normal(size=(B, N)) * 0.1).astype(np.float32)
    r_ref, c_ref = jfr.lowrank_row_col_sq(jnp.asarray(x), jnp.asarray(dz))
    r, c = tfr.lowrank_row_col_sq(torch.from_numpy(x), torch.from_numpy(dz))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5)
    g = x.T.astype(np.float64) @ dz.astype(np.float64)
    np.testing.assert_allclose(r.numpy(), (g * g).sum(1), rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_fused_updates_match_jax(dtype):
    """3 chained steps with a schedule: state rtol 1e-5; kernel rtol 2e-5 in
    f32, within 1 bf16 ulp (>= 99.9% bitwise) in bf16."""
    rng = np.random.default_rng(1)
    w32 = (_random_w(rng, M, N) * 0.05).astype(np.float32)
    sched_j = jax.jit(lambda c: 1e-3 * (1.0 + 0.5 * c))

    def sched_t(c):
        return float(np.float32(1e-3) * (np.float32(1.0)
                                         + np.float32(0.5) * np.float32(c)))

    if dtype == "bfloat16":
        w_j = jnp.asarray(w32).astype(jnp.bfloat16)
        w_t = torch.from_numpy(_bf16_bits(w_j).astype(np.int16)).view(
            torch.bfloat16).clone()
    else:
        w_j = jnp.asarray(w32)
        w_t = torch.from_numpy(w32.copy())
    st_j = jfr.init_fused_state(w_j)
    st_t = tfr.init_fused_state(w_t)
    for step in range(3):
        x = rng.normal(size=(B, M)).astype(np.float32)
        dz = (rng.normal(size=(B, N)) * 0.1).astype(np.float32)
        w_j, st_j = jfr.fused_readout_update(
            w_j, jnp.asarray(x), jnp.asarray(dz), st_j, sched_j,
            seed=jnp.uint32(step), use_pallas=(dtype == "bfloat16"),
            interpret=True)
        w_t, st_t = tfr.fused_readout_update(
            w_t, torch.from_numpy(x), torch.from_numpy(dz), st_t, sched_t,
            seed=step)
        assert st_t.count == int(st_j.count)
        np.testing.assert_allclose(st_t.row.numpy(), np.asarray(st_j.row),
                                   rtol=1e-5)
        np.testing.assert_allclose(st_t.col.numpy(), np.asarray(st_j.col),
                                   rtol=1e-5)
        if dtype == "bfloat16":
            d = _ulp_diff(_bf16_bits(w_t), _bf16_bits(w_j))
            assert (d == 0).mean() >= 0.999, step
            # 2^-20 of the kernel's scale bounds the update's f32 error
            err = 2.0**-20 * np.abs(np.asarray(w_j, np.float32)).max()
            assert _within_sr_tolerance(_bf16_bits(w_t), _bf16_bits(w_j),
                                        err).all(), step
            # the state chains; the kernel restarts from the reference bits
            # so that each step is held to 1 ulp (two independent SR draws
            # on a value already 1 ulp apart may land 2 apart)
            w_t = torch.from_numpy(_bf16_bits(w_j).astype(np.int16)).view(
                torch.bfloat16).clone()
        else:
            np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                                       rtol=2e-5, atol=1e-7)


def test_fused_state_converts_both_ways():
    from video_spike_torch.convert import (fused_state_from_flax,
                                           fused_state_to_flax)

    rng = np.random.default_rng(6)
    w = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(B, M)).astype(np.float32))
    dz = jnp.asarray(rng.normal(size=(B, N)).astype(np.float32))
    _, st = jfr.fused_readout_update(w, x, dz, jfr.init_fused_state(w), 1e-3,
                                     seed=jnp.uint32(0), use_pallas=False)
    st = jax.device_get(st)
    port = fused_state_from_flax(st)
    assert isinstance(port, tfr.FusedReadoutState) and port.count == 1
    back = fused_state_to_flax(port)
    for a, b in zip(back, st):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_update_survives_roundoff_negative_stats(monkeypatch):
    """Mirror of the JAX regression: statistics that cancel to tiny
    negatives must be clamped before rsqrt (no NaN row, state >= 0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, M)).astype(np.float32))
    dz = torch.from_numpy((rng.normal(size=(B, N)) * 0.1).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(M, N)) * 0.01).astype(np.float32))
    real = tfr.lowrank_row_col_sq

    def negative_roundoff(x_, dz_):
        row_sq, col_sq = real(x_, dz_)
        row_sq[7] = -34.0
        col_sq[3] = -1e-3
        return row_sq, col_sq

    monkeypatch.setattr(tfr, "lowrank_row_col_sq", negative_roundoff)
    w2, st = tfr.fused_readout_update(w, x, dz, tfr.init_fused_state(w), 1e-3,
                                      seed=0)
    assert torch.isfinite(w2).all()
    assert torch.isfinite(st.row).all() and (st.row >= 0).all()
    assert torch.isfinite(st.col).all() and (st.col >= 0).all()


def test_f32_kernel_takes_plain_add_like_xla():
    """An f32 W is outside the kernel's bf16 contract: the wrapper does the
    exact f32 add (what _apply_scaled_outer_xla does), keeping the dtype."""
    rng = np.random.default_rng(4)
    w32 = _random_w(rng, M, N)
    xa, dzc = _exact_factors(rng, B, M, N)
    ref = jfr._apply_scaled_outer_xla(jnp.asarray(w32), jnp.asarray(xa),
                                      jnp.asarray(dzc), jnp.uint32(0))
    w_t = torch.from_numpy(w32.copy())
    tfr.apply_scaled_outer(w_t, torch.from_numpy(xa), torch.from_numpy(dzc), 0)
    assert w_t.dtype == torch.float32
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(ref))


def test_cuda_contract_errors():
    """The kernel's checks reject what it does not take before any build:
    bf16 W only, f32 factors, matching shapes, N % 8 == 0, M > 0."""
    w = torch.zeros(16, 256, dtype=torch.bfloat16)
    xa = torch.zeros(4, 16)
    dzc = torch.zeros(4, 256)
    cases = [
        (w.float(), xa, dzc, "bf16 only"),
        (w, xa.double(), dzc, "f32 only"),
        (w, torch.zeros(4, 15), dzc, "shapes"),
        (torch.zeros(16, 250, dtype=torch.bfloat16), xa, torch.zeros(4, 250),
         "N % 8"),
        (w.t(), torch.zeros(4, 256), torch.zeros(4, 16), "contiguous"),
    ]
    for w_, xa_, dzc_, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tfr._launch_cuda(w_, xa_, dzc_, 0)
