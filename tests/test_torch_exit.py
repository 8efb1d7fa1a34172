"""Rank exits of the port (``core/runtime``): ``exit_rank`` and ``run_rank``.

A gloo rank left to the interpreter's teardown can abort after its work
is done (``terminate called without an active exception``: a gloo worker
thread dropping a tensor's last reference once finalization has begun is
ended by ``pthread_exit``). Each launch here runs two gloo ranks on the
CPU under ``torch.distributed.run --standalone``; a rank program sets up
the runtime, all-reduces over the world and over a ``new_group``, and
leaves through ``run_rank`` (an entry point's ``main``) or an explicit
``exit_rank()`` (the tests' ``-c`` programs). Checks: every clean launch
exits 0 on every rank with both ranks' results; a rank that raises exits
1 with its traceback printed, and the launch ends (its peer, waiting in a
collective, is stopped by the launcher) within the launch timeout.
``test_exit_loop`` (slow) repeats the clean launch 128 times, 16 at a
time, with no abort.
"""

import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_dist_train import _env, _wait, results, torch_code

RANK_PROGRAM = r"""
import json, sys
import torch
import torch.distributed as dist
from video_spike_torch.core.runtime import exit_rank, run_rank, setup_runtime


def main():
    assert setup_runtime("cpu")
    torch.set_num_threads(1)
    r = dist.get_rank()
    t = torch.full((4,), r + 1.0)
    dist.all_reduce(t)
    g = dist.new_group([0, 1])
    u = torch.full((3,), float(r))
    dist.all_reduce(u, group=g)
    if sys.argv[1].startswith("raise"):
        if r == 1:
            raise ValueError("rank 1 fails on purpose")
        dist.all_reduce(t)     # waits for a peer that has left
    print(f"pid={r} result={json.dumps({'t': t.tolist(), 'u': u.tolist()})}",
          flush=True)


if sys.argv[1] in ("run_rank", "raise"):
    run_rank(main)
else:                           # a -c program: its body, then exit_rank()
    main()
    exit_rank()
"""
EXIT_TIMEOUT = 120


def _launch(mode: str):
    return torch_code(RANK_PROGRAM, _env(), args=(mode,))


def _clean(outs) -> None:
    for out in results(outs):
        assert out == {"t": [3.0] * 4, "u": [1.0] * 3}


def test_clean_launches_exit_zero_on_every_rank():
    """Four launches at once, two through ``run_rank`` and two ending with
    ``exit_rank()``: rc 0 on every rank (the launcher's rc), results from
    both ranks."""
    launches = [_launch(m) for m in ("run_rank", "exit_rank") * 2]
    for procs in launches:
        _clean(_wait(procs, timeout=EXIT_TIMEOUT))


@pytest.mark.parametrize("mode", ["raise", "raise_plain"])
def test_a_rank_that_raises_exits_nonzero_and_frees_its_peer(mode):
    """Rank 1 raises after the collectives, rank 0 waits in another: the
    launch ends within the timeout with a non-zero code and rank 1's
    traceback; through ``run_rank`` rank 1's own code is 1. Without it
    (``raise_plain``) the ``atexit`` hook destroys the groups and the
    interpreter exits non-zero."""
    (proc,) = _launch(mode)
    try:
        out = proc.communicate(timeout=EXIT_TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the launch hung past {EXIT_TIMEOUT} s")
    assert proc.returncode != 0
    assert "ValueError: rank 1 fails on purpose" in out
    assert "Traceback" in out
    if mode == "raise":
        assert "exitcode  : 1 " in out, out[-3000:]


@pytest.mark.slow
def test_exit_loop():
    """128 clean two-rank launches through ``run_rank``, 16 at a time:
    none aborts (every launcher rc 0)."""
    def one(_):
        (proc,) = _launch("run_rank")
        try:
            out = proc.communicate(timeout=600)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            return -1, "hung"
        return proc.returncode, out

    with ThreadPoolExecutor(16) as pool:
        runs = list(pool.map(one, range(128)))
    failed = [out[-2000:] for rc, out in runs if rc != 0]
    assert not failed, f"{len(failed)} of 128 launches failed:\n{failed[0]}"
