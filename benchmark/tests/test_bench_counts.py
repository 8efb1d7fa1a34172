"""The operation and byte counts reproduce the fused readout's bounds:
2.139 GB, 0.639 ms at B = 16 (bytes), and 64.4 GFLOP, 0.962 ms at B = 64
(f32 FLOPs), on the (1,966,080, 256) first Dense kernel."""

import pytest

import tiny_cells  # noqa: F401
from benchlib import counts, spec

M, N = 1_966_080, 256


def test_linear_b16_is_bound_by_bytes():
    assert counts.fused_readout_bytes(M, N, 16) / 1e9 == pytest.approx(
        2.139, abs=5e-4)
    assert counts.fused_readout_bound_s(M, N, 16) * 1e3 == pytest.approx(
        0.639, abs=5e-4)


def test_b64_is_bound_by_f32_flops():
    assert counts.fused_readout_flops(M, N, 64) / 1e9 == pytest.approx(
        64.4, abs=0.05)
    assert counts.fused_readout_bound_s(M, N, 64) * 1e3 == pytest.approx(
        0.962, abs=5e-4)


def test_linear_step_flops_from_the_configuration():
    cfg = spec.load_json(spec.BENCH_DIR / "configs/linear_video.json")
    flops = counts.linear_train_flops(cfg["config"]["model"], 16)
    first = 4 * 16 * M * N                 # forward and weight gradient
    assert first < flops < 1.1 * first


def test_vit_mae_flops_grow_with_frames():
    cfg = spec.load_json(spec.BENCH_DIR / "configs/vit_mae_base_ssl.json")
    m = cfg["config"]["model"]
    one = counts.vit_mae_train_flops(m, 1)
    assert counts.vit_mae_train_flops(m, 384) == 384 * one
    assert 1e9 < one < 1e11
