"""The per-layer metrics that read the program's own spans
(``benchlib/program_spans.py`` and its five readers): the tiny SSL cell's
traced run on the CPU reports the four host times, finite, and counts as
many ``vs.step`` spans as traced steps; on a synthetic device trace and
span list each reader gives the hand-computed value; without the spans
or the device trace each reader gives nothing."""

import argparse
import math
import types

import pytest
import torch

import tiny_cells  # noqa: I001 (puts the harness on the path first)
import run
from benchlib import program_spans, spec
from benchlib.trace import Trace

HOST = ("producer_wait_ms", "forward_host_ms", "backward_host_ms",
        "optimizer_host_ms")
SEED = 2 ** 31 + 101


def test_tiny_ssl_cell_reports_the_span_metrics(monkeypatch):
    cell = tiny_cells.tiny_ssl()
    real, seen = run.runner(cell), {}

    def capture(*args, **kwargs):
        res, numbers = real.run(*args, **kwargs)
        seen["info"] = res["info"]
        return res, numbers

    monkeypatch.setattr(run, "runner",
                        lambda c: types.SimpleNamespace(run=capture))
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=0.5,
                              trace=1)
    line, checks = run.run_cell(args, torch.device("cpu"), cell=cell)
    assert line["correct"], checks
    for name in HOST:
        v = line["metrics"][name]
        assert v["unit"] == "ms" and math.isfinite(v["value"]), name
        assert v["value"] >= 0, name
    # no device trace on the CPU
    assert "optimizer_idle_ms" not in line["metrics"]
    info = seen["info"]
    spans = program_spans.main_spans(program_spans.recorded(),
                                     info.trace.window)
    assert info.trace_steps == cell.traffic["trace_steps"]
    assert program_spans.step_count(spans) == info.trace_steps


# the window (0, 10) s; device work at [0, 2], [4, 6], [7, 7.5] and
# [9.9, 11], so the device idles over [2, 4], [6, 7] and [7.5, 9.9]
DEVICE = [("a", 0.0, 2.0), ("b", 4.0, 6.0), ("c", 7.0, 7.5),
          ("d", 9.9, 11.0)]
MAIN, OTHER = 1, 2
RAW = [("producer_wait", MAIN, 0.5, 1.0),
       ("step", MAIN, 1.0, 9.0),
       ("forward", MAIN, 1.0, 3.0),
       ("backward", MAIN, 3.0, 5.0),
       ("optimizer", MAIN, 5.0, 8.0),
       ("inner", MAIN, 6.5, 7.0),
       ("producer_wait", MAIN, 9.0, 9.2),
       ("step", MAIN, 9.2, 9.8),
       ("step", MAIN, 12.0, 13.0),          # after the window
       ("optimizer", OTHER, 2.0, 4.0)]      # another thread
# by hand, over the window's 2 steps: forward and backward 2 s of self
# time each; the optimizer 3 s less its child's 0.5; the waits 0.5 + 0.2;
# the optimizer's self time [5, 6.5] + [7, 8] meets the idle gaps over
# [6, 6.5] and [7.5, 8]
WANT = {"producer_wait_ms": 350.0, "forward_host_ms": 1000.0,
        "backward_host_ms": 1000.0, "optimizer_host_ms": 1250.0,
        "optimizer_idle_ms": 500.0}


def _run(trace=True, device=DEVICE):
    return types.SimpleNamespace(
        trace=Trace(device=list(device), window=(0.0, 10.0))
        if trace else None, trace_steps=2)


def _reader(name):
    return spec.find_cell("ssl.train").metric_reader(name)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_trace(monkeypatch, name):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(RAW))
    assert _reader(name).read(_run()) == pytest.approx(WANT[name])


def test_idle_time_is_put_down_to_the_innermost_span():
    trace = _run().trace
    spans = program_spans.main_spans(RAW, trace.window)
    assert program_spans.step_count(spans) == 2
    got = program_spans.idle_by_span(trace, spans)
    want = {"forward": 1.0, "backward": 1.0, "optimizer": 1.0,
            "inner": 0.5, "step": 1.0 + 0.6, "producer_wait": 0.2,
            None: 0.1}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(2.0 + 1.0 + 2.4)


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("absent", ["spans", "trace", "device"])
def test_reader_gives_nothing_without_what_it_reads(monkeypatch, name,
                                                    absent):
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: None if absent == "spans" else list(RAW))
    run_ = _run(trace=absent != "trace",
                device=[] if absent == "device" else DEVICE)
    got = _reader(name).read(run_)
    if absent == "device" and name != "optimizer_idle_ms":
        assert got == pytest.approx(WANT[name])
    else:
        assert got is None
