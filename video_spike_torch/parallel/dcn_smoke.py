"""Multi-process smoke: one data-parallel train step across ranks.

Counterpart of ``video_spike_tpu/parallel/dcn_smoke.py``. Run under the
launcher, one process per rank:

    python -m torch.distributed.run --nproc_per_node=2 \
        -m video_spike_torch.parallel.dcn_smoke

(``DCN_SMOKE_FORCE_CPU=1`` runs the ranks on the CPU over gloo; otherwise
each rank drives a card.) Each rank initialises the process group through
``core.runtime.setup_runtime``, draws its own rows, and takes two Poisson-NLL
steps whose gradient and loss are all-reduced over the ranks. The loss is a
global mean, so every rank prints the same value.
"""

from __future__ import annotations

import os
import sys


def say(line: str) -> None:
    """One line in one write: the ranks of a launch share a pipe."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main() -> None:
    import numpy as np
    import torch

    from video_spike_torch.core.device import resolve_device
    from video_spike_torch.core.runtime import setup_runtime
    from video_spike_torch.ops.poisson import poisson_nll_mean
    from video_spike_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    kind = "cpu" if os.environ.get("DCN_SMOKE_FORCE_CPU") else "cuda"
    setup_runtime(kind)              # sets this rank's card first
    device = resolve_device(kind)
    pid, nproc = mh.process_index(), mh.process_count()
    say(f"pid={pid} process_count={nproc} local_devices=1 "
        f"global_devices={nproc}")

    # this rank's rows of the global batch (two per device)
    rng = np.random.default_rng(pid)
    rows = 2
    x_np = rng.normal(size=(rows, 16)).astype(np.float32)
    y_np = rng.poisson(1.0, (rows, 8)).astype(np.float32)
    x, y = (t.to(device) for t in mh.local_rows_to_global(x_np, y_np))
    group = None if nproc == 1 else torch.distributed.group.WORLD
    w = torch.zeros((16, 8), dtype=torch.float32, device=device)

    def step(w):
        wg = w.detach().requires_grad_(True)
        # the global mean: this rank's sum over the global element count
        loss = poisson_nll_mean(x @ wg, y, rows * nproc)
        g, = torch.autograd.grad(loss, [wg])
        grads, loss = mh.sum_grads_and_loss({"w": g}, loss.detach(), group)
        return (w - 0.1 * grads["w"]).detach(), loss

    w, loss = step(w)
    w, loss = step(w)   # second step: the gradient actually applied
    say(f"pid={pid} global_loss={float(loss):.6f}")


if __name__ == "__main__":
    from video_spike_torch.core.runtime import run_rank

    run_rank(main)
