"""The attention cores' share of their roofline, %: the least time the
card could take for a step's attention (the larger of its model FLOPs,
q kᵀ and P v forward and the four products of the backward, at the bf16
dense peak, and the bytes of q, k, v, the output and their gradients at
the HBM rate; ``benchlib/videomae_counts.py``) over the device time a
step launched inside ``vs.attention`` (``attention_ms_per_step``). It
counts the same work whatever implements attention."""


def read(run):
    got = getattr(run, "attention", None)
    bound = getattr(run, "attention_bound_s", None)
    if not got or not got["s"] or not bound or not run.trace_steps:
        return None
    return 100.0 * bound * run.trace_steps / got["s"]
