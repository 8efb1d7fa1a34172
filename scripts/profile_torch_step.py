#!/usr/bin/env python3
"""Where the time of one train step goes on the card.

    python3 scripts/profile_torch_step.py [--model linear|vtt|ssl|probe|cebra]
        [--steps 10] [--out DIR]

Builds a trainer through ``video_spike_torch.cli.train`` at full width, as
``chip_smoke.py`` drives it:

- ``linear`` (the default): the production fused Linear step
  (120x128x128 uint8 video, first Dense 1,966,080 x 256 in a bf16 SR
  store, lean adafactor, fused readout) on a synthetic 40-trial session;
- ``vtt``: the VTT flagship step (``configs/{model,train}/vtt_video.yaml``,
  AdamW) at batch 16 on five synthetic sessions of up to 668 neurons;
- ``ssl``: the ContrastViTMAE pretraining step
  (``configs/model/vit_mae/vit_mae.yaml`` + ``configs/train/vmae_video.yaml``,
  constant-lr AdamW) at batch 128 triplets on a synthetic 40-trial
  session, frame cache live, as ``cli.pretrain`` builds it;
- ``probe``: the VideoMAE probe's staged fused head step
  (``configs/model/videomae/videomae.yaml`` with ``hf_compat: false`` and
  a random backbone, ``configs/train/vmae_video.yaml`` with the production
  optimizer, batch 8; the kernel updates the (1,204,224, 256)
  ``encoder_head``) on the 40-trial session, features staged; then, apart,
  the frozen encode of one batch of 8 raw trials (``encode`` in the
  output, per trial);
- ``cebra``: one iteration of the CEBRA fit (``models/cebra.py``: batch 512,
  32 units, 5 dimensions) on the 8,640 whisker frames of 64x96 that
  ``cli.use_cebra`` reads from the RRR phase's 80-trial session.

It warms up, then runs ``torch.profiler`` (CPU + CUDA activities) over
``--steps`` staged steps. Prints one JSON line: wall ms/step (with the
profiler on), the summed device time of every kernel per step, the
device's busy share (the union of every kernel, copy and memset interval,
streams that overlap counted once, over wall time), kernel launches per
step, host ms a step in each of the program's ``vs.*`` spans
(``video_spike_torch/core/spans.py``: ``vs.step`` and, inside it,
``vs.forward``, ``vs.backward``, ``vs.optimizer``, ...; whole durations,
children included), and the top kernels and operators by device time
(each as [name, ms/step, calls/step]). The
full table and a gzipped Chrome trace go to ``--out`` (default ``profile_out/``,
git-ignored). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import gzip
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def device_busy_s(prof) -> float:
    """Seconds in which any kernel, copy or memset ran: the union of their
    intervals, so streams that overlap count once. A host range
    (``record_function``) mirrored on the device track is left out: its
    name is also a host event's."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    acts = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.device_type() == DeviceType.CUDA
                  and e.name() not in host)
    busy, reach = 0, float("-inf")
    for s, e in acts:            # by start: count what passes the reach
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return 1e-9 * busy


def span_ms(prof, units: int) -> dict:
    """Host ms a ``unit`` in each ``vs.*`` span of the profiled window,
    children included: the profiler's own rows of the spans' ranges."""
    from torch.autograd import DeviceType

    return {e.key: e.cpu_time_total / 1e3 / units
            for e in sorted(prof.key_averages(), key=lambda e: e.key)
            if e.device_type == DeviceType.CPU and e.key.startswith("vs.")}


def summarize(prof, wall: float, units: int, unit: str,
              out=None) -> dict:
    """Per ``unit`` (step or trial) of a profiled window: wall ms (profiler
    on), summed kernel device ms, the busy share, kernel launches, and the
    top kernels and operators by device time ([name, ms, calls] each). With
    ``out``, the full table and a gzipped Chrome trace go there."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    self_attr = ("self_device_time_total"
                 if hasattr(events[0], "self_device_time_total")
                 else "self_cuda_time_total")
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    # kernel rows only: an operator row repeats the time of its kernels,
    # and a host range (a vs.* span) mirrored on the device track is none
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and getattr(e, self_attr) > 0 and e.key not in host]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and getattr(e, self_attr) > 0]
    device_us = sum(getattr(e, self_attr) for e in kernels)

    def top(rows):
        rows = sorted(rows, key=lambda e: -getattr(e, self_attr))[:15]
        return [[e.key[:90], getattr(e, self_attr) / 1e3 / units,
                 e.count / units] for e in rows]

    if out is not None:
        (out / "key_averages.txt").write_text(events.table(
            sort_by=self_attr, row_limit=80))
        # gzipped: an SSL step's ~10^4 events a step run to ~100 MB
        raw = out / "trace.json"
        prof.export_chrome_trace(str(raw))
        with open(raw, "rb") as src, \
                gzip.open(out / "trace.json.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        raw.unlink()
    return {f"wall_ms_per_{unit}": wall * 1e3 / units,
            f"device_ms_per_{unit}": device_us / 1e3 / units,
            "device_busy_share": device_busy_s(prof) / wall,
            f"kernel_launches_per_{unit}":
                sum(e.count for e in kernels) / units,
            "top_kernels": top(kernels), "top_ops": top(ops)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model",
                   choices=("linear", "vtt", "ssl", "probe", "cebra"),
                   default="linear")
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
        if args.model == "ssl":
            trainer, staged = chip_smoke.ssl_staged_trainer(
                work, chip_smoke.ssl_data(work), "logs")

            def run():
                trainer._step_staged(staged, 0)
        elif args.model == "probe":
            make_fixture.main(["--out", str(work / "data"),
                               "--eid", "smokeeid0",
                               "--n_trials", str(chip_smoke.N_TRIALS),
                               "--n_neurons", str(chip_smoke.N_NEURONS)])
            trainer = chip_smoke.probe_staged_trainer(work, "logs")
            run = trainer.train_epoch
        elif args.model == "cebra":
            from video_spike_torch.cli import use_cebra
            from video_spike_torch.models.cebra import CEBRA, RECEPTIVE_FIELD

            make_fixture.main(["--out", str(work / "rrr" / "fixture"),
                               "--eid", chip_smoke.RRR_EID,
                               "--n_trials", str(chip_smoke.RRR_TRIALS),
                               "--n_neurons", str(chip_smoke.RRR_NEURONS),
                               "--height", "32", "--width", "32"])
            frames = use_cebra.build(chip_smoke._cebra_argv(work))["X"]
            X = torch.from_numpy(frames.reshape(
                -1, chip_smoke.CEBRA_PIXELS).astype(np.float32)).cuda()
            trainer = CEBRA(output_dimension=chip_smoke.CEBRA_OUT_DIM)
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = trainer.init_params(X.shape[1], gen)
            fit = {"params": params, "opt": trainer.tx.init(params)}
            max_start = X.shape[0] - RECEPTIVE_FIELD - trainer.time_offset - 1
            trainer.global_step = 0

            def run():
                fit["params"], fit["opt"], _ = trainer.step(
                    fit["params"], fit["opt"], X,
                    *trainer.sample(gen, max_start))
                trainer.global_step += 1
        elif args.model == "vtt":
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

        def step_count():
            # the SSL trainer counts its steps in _step_count
            return (trainer._step_count if args.model == "ssl"
                    else trainer.global_step)

        run()
        torch.cuda.synchronize()
        step0 = step_count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while step_count() - step0 < args.steps:
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = step_count() - step0
        encode = None
        if args.model == "probe":
            video = trainer._to_device(trainer._assemble_inputs(
                next(iter(trainer.train_loader))))
            with torch.no_grad():
                trainer.model.encode(video)            # warm up
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as eprof:
                    t0 = time.perf_counter()
                    for _ in range(2):
                        trainer.model.encode(video)
                    torch.cuda.synchronize()
                    ewall = time.perf_counter() - t0
            encode = summarize(eprof, ewall, 2 * video.shape[0], "trial")
    print(json.dumps({"model": args.model, "steps": steps,
                      **summarize(prof, wall, steps, "step", out),
                      "host_ms_per_step": span_ms(prof, steps),
                      **({"encode": encode} if encode else {}),
                      "card": chip_smoke.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
