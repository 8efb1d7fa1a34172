"""Run one cell of the video_spike_torch benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic, limits,
per-layer metric readers and plain reference are found by the names in
``BENCHMARK.json`` (``benchlib/spec.py``). Set-up (loading, the kernel's
build or load, the trials and weights made on the card from the seed,
warm-up epochs) is timed as ``setup_s``; then the window runs for
``--seconds``; with ``--trace 1`` a traced slice follows it and the run
reports the per-layer metrics. After the window the program's state is
freed and the plain reference checks the first training steps that set-up
took. The last lines on standard error give each compared number beside
its limit; the last line on standard output is the result as JSON.

A cell on several cards runs this command once a card under
``torch.distributed.run --standalone`` (NCCL, one rank a card); rank 0
prints the result.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and 3 when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".bench_cache"


THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one thread for the host's math libraries: the cells' host work is
    dispatch, and idle pool threads only take cores from it."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    for k in THREADS:
        os.environ[k] = "1"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def runner(cell):
    """The runner module the configuration names: ``benchlib/<trainer>.py``."""
    import importlib

    return importlib.import_module(f"benchlib.{cell.config['trainer']}")


def per_layer(cell, info) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(info)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell, res: dict, checks: dict, trace: bool, device) -> dict:
    import torch

    from benchlib import compare, report

    info = res["info"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(res["peak_bytes"]),
           "power_limit": report.power_limit()
           if device.type == "cuda" else "not read"}
    line = {"correct": compare.passed(checks),
            "attempted": int(res["attempted"]), "failed": int(res["failed"])}
    if trace:
        line["metrics"] = per_layer(cell, info)
        if info.trace is not None:
            # averaged over the chips the cell uses
            per_rank = getattr(info, "busy_by_rank", None) or [
                (info.trace.busy_s(), info.trace.window_s)]
            dev["busy_s"] = sum(b for b, _ in per_rank) / len(per_rank)
            dev["window_s"] = sum(w for _, w in per_rank) / len(per_rank)
            line["breakdown"] = info.trace.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        line["metrics"] = {k: {"value": v, "unit": units[k]}
                           for k, v in res["end_to_end"].items()
                           if k in units}
    line["device"] = dev
    return line


def rank_device(cell):
    """This process's card: under ``torch.distributed.run`` (a multi-card
    cell, one rank a card) the program's runtime starts the process group
    and the rank's card; otherwise card 0."""
    import torch

    if cell.chips > 1 and "LOCAL_RANK" in os.environ:
        from video_spike_torch.core.runtime import setup_runtime

        setup_runtime("cuda")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", 0)


def end_rank(code: int) -> int:
    """Leave a rank of a multi-card cell through the program's runtime
    (every rank meets, the groups are destroyed, the process ends);
    without a process group, return ``code``."""
    from video_spike_torch.core.runtime import exit_rank

    exit_rank(code)
    return code


def launch_ranks(cell, argv) -> int:
    """Run this command once a card under ``torch.distributed.run``; rank 0
    prints the result. Returns the launcher's exit code."""
    import subprocess

    env = dict(os.environ, VSB_T0=repr(T_PROCESS))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(cell.chips), str(Path(__file__)),
           *(sys.argv[1:] if argv is None else argv)]
    return subprocess.run(cmd, env=env, cwd=str(ROOT)).returncode


def run_cell(args, device, fault=None, cell=None):
    """The cell's run on ``device``, without the look for a card: the
    result's line (checks last) and the checks. Tests call it on the CPU."""
    from benchlib import compare, spec
    from benchlib.steps import quantile

    cell = cell or spec.find_cell(args.workload)
    res, numbers = runner(cell).run(cell, args.seed, args.seconds,
                                    bool(args.trace), device, T_PROCESS,
                                    fault=fault)
    if res is None:        # a rank other than 0 of a multi-card cell
        return None, None
    numbers.pop("_want", None)
    checks = compare.checks(numbers, cell.limits)
    line = result_line(cell, res, checks, bool(args.trace), device)
    for k, v in numbers.items():
        if k.startswith("_"):
            print(f"detail {k[1:]} = {v}", file=sys.stderr)
    ms = res["info"].step_ms
    tenth = max(len(ms) // 10, 1)
    medians = [round(quantile(ms[i:i + tenth], 0.5), 3)
               for i in range(0, len(ms), tenth)]
    print(f"detail step_ms_median_by_tenth_of_window = {medians}",
          file=sys.stderr)
    print(f"detail window_spans_s = {res['info'].spans}", file=sys.stderr)
    return line, checks


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(BENCH_DIR))
    from benchlib import guard, report, spec

    cell = spec.find_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this host has "
              f"{n}: no result", file=sys.stderr)
        return 2
    if cell.chips > 1 and "LOCAL_RANK" not in os.environ:
        return launch_ranks(cell, argv)
    global T_PROCESS
    T_PROCESS = float(os.environ.get("VSB_T0", T_PROCESS))
    device = rank_device(cell)
    if device.index == 0:
        print(f"card: {report.power_limit()}", file=sys.stderr)
    line, checks = run_cell(args, device, cell=cell)
    if line is None:                      # not rank 0
        return end_rank(0)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}: no result", file=sys.stderr)
        return end_rank(3)
    for v in line["metrics"].values():
        if not math.isfinite(v["value"]):
            print(f"non-finite metric in {line['metrics']}", file=sys.stderr)
    report.emit(line, checks)
    return end_rank(0)


if __name__ == "__main__":
    sys.exit(main())
