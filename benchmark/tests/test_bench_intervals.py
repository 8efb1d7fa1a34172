"""The interval union counts overlapping streams once; idle gaps are
named by the innermost benchmark span they fell in."""

import pytest

import torch

import tiny_cells  # noqa: F401
from benchlib import intervals
from benchlib.trace import Trace, from_events


class _Ev:
    def __init__(self, name, start_us, dur_us, cuda):
        self._n, self._s, self._d, self._c = name, start_us, dur_us, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._d * 1000

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def test_union_of_overlapping_streams():
    compute = [(0.0, 4.0), (5.0, 6.0)]
    copies = [(1.0, 3.0), (4.5, 5.5)]          # a second stream overlapping
    nccl = [(5.8, 7.0)]
    u = intervals.union(compute + copies + nccl)
    assert u == [(0.0, 4.0), (4.5, 7.0)]
    assert intervals.covered(compute + copies + nccl) == pytest.approx(6.5)
    # summed kernel time would count the overlap twice
    total = sum(e - s for s, e in compute + copies + nccl)
    assert total > intervals.covered(compute + copies + nccl)


def test_clip_and_gaps():
    ivs = [(1.0, 2.0), (1.5, 3.0), (4.0, 6.0)]
    assert intervals.covered(ivs, 0.0, 5.0) == pytest.approx(3.0)
    assert intervals.gaps(ivs, 0.0, 7.0) == [(0.0, 1.0), (3.0, 4.0),
                                             (6.0, 7.0)]
    assert intervals.union([(2.0, 2.0)]) == []


def test_trace_busy_idle_and_breakdown():
    t = Trace(device=[("gemm", 0.0, 2.0), ("copy_kernel", 1.0, 3.0),
                      ("ncclKernel_AllGather", 5.0, 6.0)],
              host=[("bench.trace_window", 0.0, 10.0),
                    ("bench.train_epoch", 0.0, 8.0),
                    ("bench.step", 0.0, 3.5),
                    ("bench.eval_epoch", 8.0, 10.0)],
              window=(0.0, 10.0))
    assert t.busy_s() == pytest.approx(4.0)
    assert t.busy_s(lambda n: "nccl" in n.lower()) == pytest.approx(1.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm", 2.0]
    gaps = dict((round(v, 6), n) for n, v in b["idle_gaps"])
    assert gaps[4.0] == "train_epoch"       # 6 -> 10 starts in train_epoch
    assert gaps[2.0] == "step"              # 3 -> 5 starts inside a step


def test_host_ranges_mirrored_on_the_device_are_not_device_work():
    evs = [_Ev("bench.trace_window", 0, 100, False),
           _Ev("bench.step", 0, 50, False), _Ev("bench.step", 0, 50, True),
           _Ev("nccl:all_reduce", 10, 30, False),
           _Ev("nccl:all_reduce", 10, 40, True),
           _Ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 30, 10, True),
           _Ev("gemm_kernel", 60, 20, True),
           _Ev("cudaLaunchKernel", 58, 1, False)]
    t = from_events(evs)
    assert [d[0] for d in t.device] == [
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "gemm_kernel"]
    assert t.window == (0.0, 100e-6)
    assert t.busy_s() == pytest.approx(30e-6)
