"""A run with the timed path broken underneath comes out not correct. Each
test skips the harness's look for a card and drives the rest of a run on
the CPU at reduced widths, with one fault of ``benchlib/faults.py``
planted in the program's step: a step that returns its state unchanged,
half of the batch left out with the mean taken over the rest, and, on the
four-rank cell (four gloo processes), the exchange between ranks left
out. A sound run of the same size comes out correct."""

import argparse

import pytest
import torch

import json
import os
import subprocess
import sys

import run
import tiny_cells
from benchlib import faults

CELLS = {"linear.train": tiny_cells.tiny_linear,
         "ssl.train": tiny_cells.tiny_ssl}
SEED = 2 ** 31 + 11


def _args(name, trace=0):
    return argparse.Namespace(workload=name, seed=SEED, seconds=0.5,
                              trace=trace)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    line, checks = run.run_cell(_args(name, trace=1), torch.device("cpu"),
                                cell=CELLS[name]())
    assert line["correct"], checks
    assert list(line)[-1] == "device" and line["attempted"] > 0


@pytest.mark.parametrize("fault", [faults.state_unchanged,
                                   faults.half_batch],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", sorted(CELLS))
def test_fault_is_not_correct(name, fault):
    line, checks = run.run_cell(_args(name), torch.device("cpu"),
                                fault=fault, cell=CELLS[name]())
    assert not line["correct"], checks


def _dp4(fault: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", str(tiny_cells.BENCH / "tests/dp_rank.py"),
           "--fault", fault]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tiny_cells.BENCH.parent), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault,correct", [("", True),
                                           ("no_exchange", False)])
def test_four_ranks(fault, correct):
    line = _dp4(fault)
    assert line["correct"] is correct, line["checks"]
    assert line["device"]["count"] == 4
