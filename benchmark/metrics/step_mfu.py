"""The whole training step's share of the chips' bf16 peak, %: the
model's matmul FLOPs a step (forward and backward, counted from shapes in
``benchlib/counts.py``, no recomputation) times the window's steps, over
the window and the chips' 989 TFLOP/s."""

from benchlib import peaks


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    chips = run.cell.chips
    return 100.0 * run.flops_per_step * run.steps / run.window_s / (
        peaks.BF16_FLOP_PER_S * chips)
