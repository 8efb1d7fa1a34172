"""Find a cell and everything that belongs to it by the names in
``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, parameters a runner reads;
- ``workloads/<cell>.json``: the cell's comparison limits, how many first
  steps' losses are compared and, for each gap over leaves, which leaf (a
  quantile over the leaves; the worst by default) and over which leaves
  (those whose name starts with a stated prefix; all by default);
- ``metrics/<metric>.py``: one per-layer metric's reader, ``read(run)``;
- ``reference/<config>.py``: the configuration's plain reference.

A later cell, configuration or metric is a new file; none of these
functions changes for it."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import ``path`` as a module named ``name`` (file names may hold
    dots, which ``import`` cannot)."""
    if not path.exists():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict              # compared number -> its limit
    loss_steps: int           # the first steps whose losses are compared
    quantiles: dict           # gap -> the leaf compared, as a quantile
    leaves: dict              # gap -> the prefix of the leaves it reads
    end_to_end: list          # the cell's end-to-end metric entries
    per_layer: list           # the cell's per-layer metric entries
    reference_path: Path
    bench: dict = field(repr=False, default_factory=dict)

    def reference(self):
        return load_module(self.reference_path,
                           f"bench_reference_{self.config['name']}")

    def metric_reader(self, name: str):
        return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                           f"bench_metric_{name.replace('.', '_')}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path} "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell_from_files(name, w["config"], w["traffic"], int(w["chips"]),
                           bench, ROOT / configs[w["config"]]["file"])


def cell_from_files(name: str, config: str, traffic: str, chips: int,
                    bench: dict, config_file: Path = None) -> Cell:
    """A cell from its own files, whether or not ``BENCHMARK.json`` lists
    it yet (the tests build cells the benchmark holds back this way); the
    metrics are those of ``bench`` that every cell or this one reports."""
    config_file = config_file or BENCH_DIR / "configs" / f"{config}.json"
    checks = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=chips, config=load_json(config_file),
        traffic=load_json(BENCH_DIR / "traffic" / f"{traffic}.json"),
        limits=checks["limits"], loss_steps=checks.get("loss_steps"),
        quantiles=checks.get("quantiles", {}),
        leaves=checks.get("leaves", {}),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        reference_path=BENCH_DIR / "reference" / f"{config}.py",
        bench=bench)
