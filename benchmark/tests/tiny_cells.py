"""Cells of the benchmark at widths a CPU test can hold: the same
configuration files and references, with the video, the hidden widths and
the trial counts cut, and the fused step engaged at the small width."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import spec  # noqa: E402


def cell(real: spec.Cell, config: dict, traffic: dict) -> spec.Cell:
    real.config, real.traffic = config, traffic
    return real


def linear_cell(name: str = "linear.train") -> spec.Cell:
    """``linear.train`` from its files: ``BENCHMARK.json`` holds it back
    until the program's step stops raising at some seeds (PERF.md)."""
    return spec.cell_from_files(name, "linear_video", "staged_epochs", 1,
                                spec.load_json(spec.ROOT / "BENCHMARK.json"))


def tiny_linear(name: str = "linear.train") -> spec.Cell:
    real = linear_cell(name)
    cfg = copy.deepcopy(real.config)
    cfg["video"] = {"frames": 4, "channels": 1, "height": 64, "width": 64}
    cfg["neurons"] = 8
    m = cfg["config"]["model"]
    m["encoder"].update(input_dim=4 * 64 * 64, hidden_dims=[128, 64],
                        output_dim=32)
    m["decoder"].update(input_dim=32, hidden_dims=[64, 128],
                        output_dim=100 * 8)
    cfg["config"]["optimizer"]["fused_min_kernel"] = 1
    traffic = dict(real.traffic, train_trials=32, eval_trials=8, batch=8,
                   warmup_epochs=1, trace_epochs=1)
    c = cell(real, cfg, traffic)
    # at these widths the median leaf's statistics gap reads 0.0028-0.046
    # for the program and 0.077-0.20 for the fp8 control (25 seeds on the
    # CPU); the card's limit (0.03) is for the published widths
    c.limits = dict(c.limits, moment_gap=0.06)
    return c


def tiny_ssl(name: str = "ssl.train") -> spec.Cell:
    real = spec.find_cell(name)
    cfg = copy.deepcopy(real.config)
    cfg["frames"] = {"trials": 4, "frames_per_trial": 30, "channels": 1,
                     "height": 24, "width": 40, "field": [3, 5], "noise": 8}
    cfg["config"]["model"].update(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, decoder_hidden_size=32,
        decoder_num_hidden_layers=1, decoder_num_attention_heads=4,
        decoder_intermediate_size=64)
    traffic = dict(real.traffic, batch=8, warmup_steps=3, trace_steps=2)
    return cell(real, cfg, traffic)


def tiny_dp4() -> spec.Cell:
    """``linear_video`` data parallel over four ranks (gloo on the CPU),
    each with its own trials, at the reduced widths; the limits are the
    one-rank cell's, with ``replica_gap`` exact."""
    c = tiny_linear()
    c.name = "linear.dp4"
    c.chips = 4
    c.traffic = dict(c.traffic, ranks=4)
    c.limits = dict(c.limits, replica_gap=0)
    return c
