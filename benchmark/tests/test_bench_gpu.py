"""On the card: one short run of each one-card cell through the command
``BENCHMARK.json`` names, with the result's keys and a correct output.
Marked ``gpu``; it skips here without a card. On the chip:

    python -m pytest --noconftest -p no:cacheprovider -q \
        benchmark/tests/test_bench_gpu.py
"""

import json
import subprocess
import sys

import pytest

import tiny_cells
from benchlib import spec

ONE_CARD = [w["name"] for w in spec.load_json(
    spec.ROOT / "BENCHMARK.json")["workloads"] if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CARD)
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused readout kernel has no "
                    "CPU mode)")
    cmd = [sys.executable, str(tiny_cells.BENCH / "run.py"), "--workload",
           cell, "--seed", str(2 ** 32 + 5), "--seconds", "2", "--trace",
           "0"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=str(spec.ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) >= {"setup_s", "train_frames_per_s"}
