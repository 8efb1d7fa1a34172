"""Discovery by name: every cell, configuration, traffic mix, per-layer
metric and reference that BENCHMARK.json names is found in its own file,
and the file is within the contract's limits."""

import json
import re

import pytest

import tiny_cells  # noqa: F401  (puts the benchmark on sys.path)
from benchlib import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.find_cell(cell)
    assert c.chips in (1, 4)
    assert c.reference_path.exists()
    ref = c.reference()
    assert callable(ref.reference_steps)
    assert callable(ref.program_grad_norms)
    assert set(c.limits) >= {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert (spec.BENCH_DIR / "benchlib" / f"{c.config['trainer']}.py"
            ).exists()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    cell = spec.find_cell(BENCH["workloads"][0]["name"])
    reader = cell.metric_reader(metric)
    assert callable(reader.read)


def test_names_and_entries():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).exists()
        assert spec.load_json(spec.ROOT / c["file"])["name"] == c["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m.get("layer", "x"))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert _line(entry["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
