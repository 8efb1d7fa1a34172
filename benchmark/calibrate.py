"""Readings for a training cell's comparison limits, on the chip at the
cell's own size (not run by the benchmark's own runs):

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--controls fp8,half_batch,state_unchanged,bf16,sr_key] \
        [--fault <name>]

For a multi-card cell, one rank a card:
    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \
        benchmark/calibrate.py --workload <name> --seeds ...

For each seed, set-up builds the program as a run does and takes its first
steps; the plain reference then follows them. One JSON line a seed gives
the program's compared numbers and, for each control, those of the
reference put in the program's place: ``fp8`` computes every matmul in fp8
(the nearest precision below the configuration's bf16); ``half_batch``
leaves out half of each batch and takes the mean over the rest;
``state_unchanged`` updates nothing (in the program's place it also
leaves the optimizer's state as it was, so its gradient and change
numbers read 1 by their definition: the run reads what the losses
give). Two witnesses read what sound arithmetic gives: ``bf16`` computes
every matmul in bfloat16, as the program does, and ``sr_key`` draws the
bf16 store's stochastic rounding from another stream."""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="fp8,half_batch,state_unchanged")
    p.add_argument("--fault", default=None,
                   help="a fault of benchlib/faults.py planted in the program")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR.parent))
    sys.path.insert(0, str(BENCH_DIR))
    import run

    run.set_cache_dirs()
    import torch

    from benchlib import faults, ranks, spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = run.rank_device(cell)
    runner_mod = run.runner(cell)
    controls = tuple(c for c in args.controls.split(",") if c)
    fault = faults.FAULTS[args.fault] if args.fault else None
    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner_mod.readings(cell, seed, device, controls, fault=fault)
        if ranks.rank() == 0:
            print(json.dumps({"seed": seed, "fault": args.fault, **out},
                             default=str), flush=True)
    return run.end_rank(0)


if __name__ == "__main__":
    sys.exit(main())
