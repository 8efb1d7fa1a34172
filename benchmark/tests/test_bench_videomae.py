"""The VideoMAE pretraining cell, ``vmae.pretrain``: its runner drives
``cli/pretrain_videomae.py``'s functions on the CPU at reduced widths
through ``cell_from_files`` and comes out correct, and not correct with
the step's update left out or half of each batch; the fp8 reference in
the program's place fails a limit; ``attention_ms_per_step`` and
``attention_roofline_pct`` read the device time launched inside the
``vs.attention`` ranges of a synthetic trace, forward and backward; the
FLOP counts at the published size equal the hand count."""

import argparse
import copy
import math
import types

import pytest
import torch

import tiny_cells  # noqa: F401  (puts the benchmark on sys.path)
import run
from benchlib import compare, launched, spec, videomae_counts

SEED = 2 ** 31 + 19


def tiny_vmae() -> spec.Cell:
    """``vmae.pretrain`` from its files with 8 trials of 12 frames at
    32 x 32, clips of 4 frames at 32 px in tubelets of 2 x 8 x 8, a 32-wide
    encoder of 2 layers; the decoder keeps the program's 384 / 4 / 6 /
    1536, which ``VideoMAEForPreTraining`` builds whatever its config."""
    real = spec.cell_from_files(
        "vmae.pretrain", "videomae_base_pretrain", "masked_clips", 1,
        spec.load_json(spec.ROOT / "BENCHMARK.json"))
    cfg = copy.deepcopy(real.config)
    cfg["frames"] = {"trials": 8, "frames_per_trial": 12, "channels": 1,
                     "height": 32, "width": 32, "field": [4, 4], "noise": 8}
    cfg["config"]["model"].update(
        image_size=32, patch_size=8, num_frames=4, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        mask_ratio=0.75)
    real.config = cfg
    real.traffic = dict(real.traffic, batch=4, warmup_steps=3,
                        trace_steps=2)
    # at these widths the first losses' gap reads 3.3e-4 to 6.5e-4 for the
    # program and 1.0e-3 to 7.3e-3 for the fp8 control (8 seeds on the
    # CPU); the card's limit (5e-4) is for 64 clips at the published widths
    real.limits = dict(real.limits, loss_gap=2e-3)
    return real


def _args(trace=0):
    return argparse.Namespace(workload="vmae.pretrain", seed=SEED,
                              seconds=0.5, trace=trace)


def state_unchanged(ses):
    real = ses.step_fn
    ses.step_fn = lambda p, o, v, g: (p, o, real(p, o, v, g)[2])


def half_batch(ses):
    real = ses.step_fn
    ses.step_fn = lambda p, o, v, g: real(p, o, v[: v.shape[0] // 2], g)


def test_tiny_cell_is_correct_and_reports_its_metrics():
    line, checks = run.run_cell(_args(trace=1), torch.device("cpu"),
                                cell=tiny_vmae())
    assert line["correct"], checks
    assert line["attempted"] > 0 and line["failed"] == 0
    for name in ("step_ms_p50", "step_mfu", "forward_host_ms",
                 "backward_host_ms", "optimizer_host_ms",
                 "producer_wait_ms"):
        v = line["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
    # no device trace on the CPU
    assert "attention_ms_per_step" not in line["metrics"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    line, checks = run.run_cell(_args(), torch.device("cpu"), fault=fault,
                                cell=tiny_vmae())
    assert not line["correct"], checks


def test_fp8_control_fails():
    cell = tiny_vmae()
    out = run.runner(cell).readings(cell, SEED, torch.device("cpu"),
                                    controls=("fp8",))
    assert compare.passed(compare.checks(out["program"], cell.limits))
    assert not compare.passed(compare.checks(out["fp8"], cell.limits))


# the window (0, 10) s. Thread 1 (the main thread) opens a vs.attention
# range over [1, 2], thread 2 (autograd's) one over [5, 6]; op 10 starts
# inside the first, op 11 after it, op 20 inside the second; a runtime
# event (CUPTI id 30, linked to op 10) is no op, so the kernel linked to 30
# is not counted; the range's mirror on the device track is no work
EVENTS = [
    launched.Event("vs.attention", False, 1, 1.0, 2.0, 1, 0),
    launched.Event("aten::bmm", False, 1, 1.1, 1.2, 10, 0),
    launched.Event("cudaLaunchKernel", False, 1, 1.15, 1.16, 30, 10),
    launched.Event("aten::add", False, 1, 2.5, 2.6, 11, 0),
    launched.Event("vs.attention", False, 2, 5.0, 6.0, 2, 0),
    launched.Event("aten::mm", False, 2, 5.5, 5.6, 20, 0),
    launched.Event("gemm", True, 0, 3.0, 3.5, 0, 10),
    launched.Event("vs.attention", True, 0, 3.0, 3.5, 0, 10),
    launched.Event("add", True, 0, 3.5, 4.0, 0, 11),
    launched.Event("orphan", True, 0, 4.0, 4.1, 0, 30),
    launched.Event("gemm_bwd", True, 0, 6.0, 6.25, 0, 20),
    launched.Event("Memcpy DtoD", True, 0, 6.25, 6.3, 0, 20),
    launched.Event("gemm_bwd", True, 0, 9.9, 10.4, 0, 20),   # clipped
]


def test_attention_time_is_what_its_ranges_launched():
    got = launched.launched_in(EVENTS, "vs.attention", (0.0, 10.0))
    assert got["forward_s"] == pytest.approx(0.5)
    assert got["backward_s"] == pytest.approx(0.25 + 0.05 + 0.1)
    assert got["s"] == pytest.approx(0.9) and got["ranges"] == 2
    assert launched.launched_in(EVENTS, "vs.nothing", (0.0, 10.0)) is None
    run_ = types.SimpleNamespace(attention=got, trace_steps=2,
                                 attention_bound_s=0.009)
    cell = spec.find_cell("vmae.pretrain")
    assert cell.metric_reader("attention_ms_per_step").read(run_) == \
        pytest.approx(450.0)
    assert cell.metric_reader("attention_roofline_pct").read(run_) == \
        pytest.approx(2.0)
    # a program without the span, or a run without a trace: nothing
    for empty in (types.SimpleNamespace(trace_steps=2),
                  types.SimpleNamespace(attention=None, trace_steps=0,
                                        attention_bound_s=0.009)):
        for name in ("attention_ms_per_step", "attention_roofline_pct"):
            assert cell.metric_reader(name).read(empty) is None


class _Kineto:
    def __init__(self, ev):
        self.ev = ev

    def name(self):
        return self.ev.name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.ev.device
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return self.ev.thread

    def start_ns(self):
        return int(round(self.ev.start * 1e9))

    def duration_ns(self):
        return int(round((self.ev.end - self.ev.start) * 1e9))

    def correlation_id(self):
        return self.ev.correlation

    def linked_correlation_id(self):
        return self.ev.linked


def test_kineto_events_are_read_as_they_are_given():
    got = launched.from_kineto([_Kineto(e) for e in EVENTS])
    assert [e.name for e in got] == [e.name for e in EVENTS]
    for a, b in zip(got, EVENTS):
        assert a._replace(start=0, end=0) == b._replace(start=0, end=0)
        assert a.start == pytest.approx(b.start)
        assert a.end == pytest.approx(b.end)


def test_flops_at_the_published_size_are_the_hand_count():
    cell = spec.find_cell("vmae.pretrain")
    m, b = cell.config["config"]["model"], cell.traffic["batch"]
    assert b == 64 and videomae_counts.tokens(m) == (1568, 160)
    length, vis = 1568, 160

    def block(rows, seq, d, mlp):
        return (2 * rows * seq * d * 3 * d + 2 * 2 * rows * seq * seq * d
                + 2 * rows * seq * d * d + 2 * 2 * rows * seq * d * mlp)

    forward = (2 * b * length * 1536 * 768 + 12 * block(b, vis, 768, 3072)
               + 2 * b * vis * 768 * 384 + 4 * block(b, length, 384, 1536)
               + 2 * b * length * 384 * 1536)
    assert videomae_counts.train_flops(m, b) == 3 * forward \
        == 13_645_111_099_392
    flops, nbytes = videomae_counts.attention(m, b)
    assert flops == 12 * b * (12 * vis * vis * 768
                              + 4 * length * length * 384) \
        == 3_081_504_817_152
    assert nbytes == 16 * b * (12 * vis * 768 + 4 * length * 384) \
        == 3_976_200_192
    # bound by the FLOPs: 3.116 ms at 989 TFLOP/s (bytes: 1.187 ms)
    assert videomae_counts.attention_bound_s(flops, nbytes) * 1e3 == \
        pytest.approx(3.1158, abs=1e-4)
