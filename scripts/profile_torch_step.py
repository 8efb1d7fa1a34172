#!/usr/bin/env python3
"""Where the time of one train step goes on the card.

    python3 scripts/profile_torch_step.py [--model linear|vtt] [--steps 10]
        [--out DIR]

Builds a trainer through ``video_spike_torch.cli.train`` at full width, as
``chip_smoke.py`` drives it:

- ``linear`` (the default): the production fused Linear step
  (120x128x128 uint8 video, first Dense 1,966,080 x 256 in a bf16 SR
  store, lean adafactor, fused readout) on a synthetic 40-trial session;
- ``vtt``: the VTT flagship step (``configs/{model,train}/vtt_video.yaml``,
  AdamW) at batch 16 on five synthetic sessions of up to 668 neurons.

It warms up, then runs ``torch.profiler`` (CPU + CUDA activities) over
``--steps`` staged steps. Prints one JSON line: wall ms/step (with the
profiler on), the summed device time of every kernel per step, the
device's busy share (kernel time / wall time), kernel launches per step,
and the top kernels and operators by device time (each as
[name, ms/step, calls/step]). The
full table and a Chrome trace go to ``--out`` (default ``profile_out/``,
git-ignored). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("linear", "vtt"), default="linear")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", type=str,
                   default=str(ROOT / "profile_out"))
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step.py needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke
    from video_spike_torch.cli import make_fixture
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="vst_prof_") as tmp:
        work = Path(tmp)
        if args.model == "vtt":
            chip_smoke.vtt_fixture(work / "vtt_data")
            trainer = train_cli.build_trainer(get_args(
                chip_smoke.vtt_args(work, "logs")))
            trainer.train_epoch()                 # stage + warm up
            idx = np.random.default_rng(0).permutation(
                trainer._n_train)[:chip_smoke.BATCH]

            def run():
                trainer.staged_step(idx, chip_smoke.BATCH)
        else:
            make_fixture.main(["--out", str(work / "data"),
                               "--eid", "profeid00",
                               "--n_trials", str(chip_smoke.N_TRIALS),
                               "--n_neurons", str(chip_smoke.N_NEURONS)])
            trainer = train_cli.build_trainer(get_args(
                ["--model_config",
                 str(ROOT / "configs/model/linear_video.yaml"),
                 "--train_config", str(chip_smoke._train_yaml(work)),
                 "--eid", "profeid00", "--data_dir", str(work / "data"),
                 "--log_dir", str(work / "logs"),
                 "--batch_size", str(chip_smoke.BATCH), "--device", "cuda"]))
            trainer.train_epoch()                 # stage + warm up
            run = trainer.train_epoch
        run()
        torch.cuda.synchronize()
        step0 = trainer.global_step
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while trainer.global_step - step0 < args.steps:
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = trainer.global_step - step0
    from torch.autograd import DeviceType

    events = prof.key_averages()
    self_attr = ("self_device_time_total"
                 if hasattr(events[0], "self_device_time_total")
                 else "self_cuda_time_total")
    # kernel rows only: an operator row repeats the time of its kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and getattr(e, self_attr) > 0]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and getattr(e, self_attr) > 0]
    device_us = sum(getattr(e, self_attr) for e in kernels)

    def top(rows):
        rows = sorted(rows, key=lambda e: -getattr(e, self_attr))[:15]
        return [[e.key[:90], getattr(e, self_attr) / 1e3 / steps,
                 e.count / steps] for e in rows]

    (out / "key_averages.txt").write_text(events.table(
        sort_by=self_attr, row_limit=80))
    prof.export_chrome_trace(str(out / "trace.json"))
    print(json.dumps({
        "model": args.model,
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": top(kernels),
        "top_ops": top(ops),
        "card": chip_smoke.nvidia_smi_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
