"""The comparison always gives a number: every training cell's comparison,
rehearsed on the CPU at reduced widths with the kernel's plain version,
over 24 random 32-bit seeds and 781048366, gives a finite value for every
compared number; the reference in the nearest lower precision (fp8), put
in the program's place, fails at least one of them."""

import math
import random

import pytest
import torch

import tiny_cells
from benchlib import compare

SEEDS = [781048366] + random.Random(16).sample(range(1, 2 ** 32), 24)
CELLS = {"linear.train": tiny_cells.tiny_linear,
         "ssl.train": tiny_cells.tiny_ssl}


def _runner(cell):
    import importlib

    return importlib.import_module(f"benchlib.{cell.config['trainer']}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_every_seed_gives_finite_numbers(name):
    cell = CELLS[name]()
    runner_mod = _runner(cell)
    for seed in SEEDS:
        out = runner_mod.readings(cell, seed, torch.device("cpu"),
                                  controls=())
        checked = compare.checks(out["program"], cell.limits)
        for k, c in checked.items():
            assert math.isfinite(c["value"]) and c["value"] < \
                compare.NOT_FINITE, (seed, k, c)
        assert checked["rows_unmatched"]["value"] == 0, seed


@pytest.mark.parametrize("name", sorted(CELLS))
def test_fp8_control_fails(name):
    cell = CELLS[name]()
    runner_mod = _runner(cell)
    for seed in SEEDS[:3]:
        out = runner_mod.readings(cell, seed, torch.device("cpu"),
                           controls=("fp8",))
        assert compare.passed(compare.checks(out["program"], cell.limits))
        assert not compare.passed(compare.checks(out["fp8"], cell.limits))
