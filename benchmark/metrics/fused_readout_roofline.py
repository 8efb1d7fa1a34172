"""The fused readout kernel's share of its roofline, %: the least time
the card could take for its (M, N, B) update (the larger of its bytes
over 3.35 TB/s and its f32 FLOPs over 67 TFLOP/s, ``benchlib/counts.py``)
over its mean device time in the traced slice. Nothing when the slice
ran no such kernel."""

from benchlib import counts

KERNEL = "fused_readout_kernel"


def read(run):
    if run.trace is None or run.fused_shape is None:
        return None
    times = [e - s for n, s, e in run.trace.kernels() if KERNEL in n]
    if not times:
        return None
    mean = sum(times) / len(times)
    return 100.0 * counts.fused_readout_bound_s(*run.fused_shape) / mean
