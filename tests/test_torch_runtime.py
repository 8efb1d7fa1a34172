"""The rank-to-card mapping of ``core/runtime.setup_runtime``, on the CPU.

``torch.distributed.run`` gives each process ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; ``setup_runtime`` sets the card ``LOCAL_RANK`` modulo the
visible count, picks NCCL for ``cuda`` and gloo for ``cpu`` (unless
``VST_DIST_BACKEND`` names one), hands the process group a timeout
(``VST_DIST_TIMEOUT`` seconds, else ``DEFAULT_TIMEOUT_S``) and, under NCCL,
checks through the group's store that no two ranks drive one card. Here
the card calls, ``init_process_group`` and the store are stand-ins (a
``HashStore`` holding the other ranks' cards), so every case runs without
a card or a peer.
"""

from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from video_spike_torch.core import runtime

torch.set_num_threads(1)


@pytest.fixture
def fake_cards(monkeypatch):
    """A host with `n` cards (default 4): returns the record of what
    ``setup_runtime`` called, and a function that sets the card count and
    the other ranks' cards in the store."""
    calls = {"set_device": [], "init": [], "store": dist.HashStore(),
             "count": 4}
    current = {"card": 0}

    def set_device(i):
        calls["set_device"].append(i)
        current["card"] = i

    def init(backend, **kw):
        calls["init"].append({"backend": backend, **kw})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: calls["count"])
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: current["card"])
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(runtime, "_default_store", lambda: calls["store"])
    monkeypatch.setattr(runtime, "_card_name", lambda i: f"host/GPU-{i}")
    monkeypatch.setattr(runtime.atexit, "register", lambda fn: None)
    for k in ("VST_DIST_BACKEND", "VST_DIST_TIMEOUT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)

    def peers(cards):
        """Publish the other ranks' cards: {rank: card index}."""
        for r, c in cards.items():
            calls["store"].set(f"vst_card/{r}", f"host/GPU-{c}")

    return calls, peers


def _env(monkeypatch, rank, world, local, **extra):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize(
    "local,count,device,env,card,backend",
    [(0, 4, "cuda", {}, 0, "nccl"),
     (1, 4, "cuda", {}, 1, "nccl"),
     (2, 4, "cuda", {}, 2, "nccl"),
     (3, 4, "cuda", {}, 3, "nccl"),
     # more local ranks than cards: they share, which only gloo allows
     (5, 4, "cuda", {"VST_DIST_BACKEND": "gloo"}, 1, "gloo"),
     (0, 4, "cpu", {}, None, "gloo"),
     (3, 1, "cuda", {"VST_DIST_BACKEND": "gloo"}, 0, "gloo"),
     (1, 4, "cpu", {"VST_DIST_BACKEND": "gloo", "VST_DIST_TIMEOUT": "17"},
      None, "gloo")])
def test_setup_runtime_maps_local_rank_to_card(fake_cards, monkeypatch,
                                               local, count, device, env,
                                               card, backend):
    """``LOCAL_RANK`` modulo the card count is the rank's card, set before
    the group; the backend follows the device or ``VST_DIST_BACKEND``; the
    group's timeout is ``VST_DIST_TIMEOUT`` or the default."""
    calls, peers = fake_cards
    calls["count"] = count
    world = count if backend == "nccl" else 8   # NCCL: one rank a card
    peers({r: r % count for r in range(world) if r != local})
    _env(monkeypatch, local, world, local, **env)
    assert runtime.setup_runtime(device) is True
    assert calls["set_device"] == ([] if card is None else [card])
    (init,) = calls["init"]
    assert init["backend"] == backend
    assert (init["rank"], init["world_size"]) == (local, world)
    assert init["init_method"] == "env://"
    want = float(env.get("VST_DIST_TIMEOUT", runtime.DEFAULT_TIMEOUT_S))
    assert init["timeout"] == timedelta(seconds=want)
    # under NCCL the rank published its card for its peers
    published = calls["store"].check([f"vst_card/{local}"])
    assert published == (backend == "nccl")


@pytest.mark.parametrize("local,count,other", [(5, 4, 1), (1, 4, 5),
                                               (1, 1, 0)])
def test_two_ranks_on_one_card_under_nccl_raise_naming_both(
        fake_cards, monkeypatch, local, count, other):
    """Under NCCL a rank whose card another rank drives raises, naming
    both ranks (NCCL takes one rank per card)."""
    calls, peers = fake_cards
    calls["count"] = count
    world = 8
    peers({r: r % count for r in range(world) if r != local})
    _env(monkeypatch, local, world, local)
    with pytest.raises(RuntimeError,
                       match=rf"ranks {local} and {other} both drive card "
                             rf"host/GPU-{local % count}"):
        runtime.setup_runtime("cuda")


@pytest.mark.parametrize("cards", [{0: 0, 1: 1, 2: 2, 3: 3},
                                   {0: 3, 1: 2, 2: 1, 3: 0}])
def test_check_one_rank_per_card_passes_distinct_cards(cards):
    """Four ranks on four distinct cards, in any order, pass the check."""
    store = dist.HashStore()
    for r, c in cards.items():
        store.set(f"vst_card/{r}", f"host/GPU-{c}")
    for r, c in cards.items():
        runtime.check_one_rank_per_card(store, r, len(cards), f"host/GPU-{c}")


@pytest.mark.parametrize("env", [{}, {"VST_DIST_BACKEND": "gloo"}])
def test_cuda_without_a_card_raises(fake_cards, monkeypatch, env):
    """A run asked for on ``cuda`` on a host without a card raises before
    any group is made, whatever the backend."""
    calls, _ = fake_cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _env(monkeypatch, 0, 2, 0, **env)
    with pytest.raises(RuntimeError, match="is_available"):
        runtime.setup_runtime("cuda")
    assert calls["init"] == [] and calls["set_device"] == []


def test_without_launcher_variables_nothing_happens(fake_cards, monkeypatch):
    """No ``RANK`` / ``WORLD_SIZE``: no group, no card set."""
    calls, _ = fake_cards
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert runtime.setup_runtime("cuda") is False
    assert calls["init"] == [] and calls["set_device"] == []


def test_dist_timeout_reads_the_environment(monkeypatch):
    monkeypatch.delenv("VST_DIST_TIMEOUT", raising=False)
    assert runtime.dist_timeout() == timedelta(
        seconds=runtime.DEFAULT_TIMEOUT_S)
    monkeypatch.setenv("VST_DIST_TIMEOUT", "2.5")
    assert runtime.dist_timeout() == timedelta(seconds=2.5)


class _Exited(Exception):
    pass


@pytest.fixture
def fake_group(monkeypatch):
    """A live default group of the given backend: records barriers,
    destroys and the exit code ``os._exit`` was given."""
    calls = {"barrier": [], "destroy": 0, "backend": "gloo"}

    def exit_(code):
        calls["code"] = code
        raise _Exited

    def destroy(group=None):
        calls["destroy"] += 1

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None:
                        calls["backend"])
    monkeypatch.setattr(dist, "barrier", lambda **kw:
                        calls["barrier"].append(kw))
    monkeypatch.setattr(dist, "destroy_process_group", destroy)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(runtime.os, "_exit", exit_)
    monkeypatch.setattr(runtime, "_flush", lambda: None)
    return calls


@pytest.mark.parametrize("backend,code,barriers,destroys", [
    ("gloo", 0, [{}], 1),
    ("nccl", 0, [{"device_ids": [2]}], 1),
    ("gloo", 1, [], 1),
    # a failed NCCL rank leaves its communicators to the process's end:
    # destroying them while the peers wait in a collective blocks
    ("nccl", 1, [], 0)])
def test_exit_rank_by_backend_and_code(fake_group, backend, code, barriers,
                                       destroys):
    """A clean exit meets the peers at a barrier (on the rank's card
    under NCCL) and destroys the groups; a failed one skips the barrier,
    destroys gloo groups and leaves NCCL ones; either ends with its
    code."""
    fake_group["backend"] = backend
    with pytest.raises(_Exited):
        runtime.exit_rank(code)
    assert fake_group["code"] == code
    assert fake_group["barrier"] == barriers
    assert fake_group["destroy"] == destroys


@pytest.mark.parametrize("backend,raised,destroys,code", [
    ("gloo", False, 1, None), ("gloo", True, 1, None),
    ("nccl", False, 1, None), ("nccl", True, 0, 1)])
def test_atexit_hook_after_an_uncaught_exception(fake_group, monkeypatch,
                                                 backend, raised, destroys,
                                                 code):
    """The ``atexit`` hook destroys the groups, except under NCCL after
    an exception nobody caught: the process then ends with code 1."""
    fake_group["backend"] = backend
    monkeypatch.setattr(runtime.sys, "last_value",
                        ValueError("uncaught") if raised else None,
                        raising=False)
    if code is None:
        runtime._release_groups()
    else:
        with pytest.raises(_Exited):
            runtime._release_groups()
    assert fake_group["destroy"] == destroys
    assert fake_group.get("code") == code
