"""One rank of a multi-card cell's run on the CPU (gloo), at the reduced
widths of ``tiny_cells``: the tests start four under
``torch.distributed.run``. ``--fault`` plants one of
``benchlib/faults.py`` in the program's step. Rank 0 prints the result's
line."""

import argparse
import json
import sys

import torch

import tiny_cells
import run
from benchlib import faults


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--fault", default="")
    p.add_argument("--seed", type=int, default=2 ** 31 + 7)
    a = p.parse_args()
    from video_spike_torch.core.runtime import exit_rank, setup_runtime

    setup_runtime("cpu")
    args = argparse.Namespace(workload="linear.dp4", seed=a.seed,
                              seconds=0.5, trace=0)
    line, checks = run.run_cell(args, torch.device("cpu"),
                                fault=faults.FAULTS.get(a.fault),
                                cell=tiny_cells.tiny_dp4())
    if line is not None:
        line["checks"] = checks
        print(json.dumps(line), flush=True)
    sys.stdout.flush()
    exit_rank(0)


if __name__ == "__main__":
    main()
