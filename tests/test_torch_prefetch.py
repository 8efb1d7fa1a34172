"""The port's ``data/prefetch.py`` (``device_put_batch``,
``prefetch_to_device``) against the JAX package's, on the CPU.

The same numpy batches go through both; the outputs, as numpy, must be
equal (bitwise), in the same order, with strings left on the host. The
pinned, double-buffered path of a CUDA device is held against the CPU path
in ``tests/test_torch_kernels_gpu.py`` on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch

from video_spike_tpu.data import prefetch as jpf
from video_spike_torch.data import prefetch as tpf

torch.set_num_threads(1)


def _batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(4, 3)).astype(np.float32),
             "video": rng.integers(0, 255, (4, 2, 1, 8, 8), dtype=np.uint8),
             "eid": [f"e{i}"] * 4} for i in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_order_matches_jax(depth):
    batches = _batches()
    got = list(tpf.prefetch_to_device(iter(batches), "cpu", depth=depth))
    ref = list(jpf.prefetch_to_device(iter(batches), depth=depth))
    assert len(got) == len(ref) == 6
    for g, r, b in zip(got, ref, batches):
        assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == "cpu"
        assert g["eid"] == r["eid"] == b["eid"]            # strings on host
        for k in ("x", "video"):
            assert g[k].numpy().dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))


def test_prefetch_transform_matches_jax():
    batches = [{"x": np.full((3, 2), i, np.float32)} for i in range(3)]

    def pad(b):
        return {"x": np.pad(b["x"], ((0, 1), (0, 0)))}

    got = list(tpf.prefetch_to_device(iter(batches), "cpu", transform=pad))
    ref = list(jpf.prefetch_to_device(iter(batches), transform=pad))
    assert all(tuple(b["x"].shape) == (4, 2) for b in got)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(r["x"]))


@pytest.mark.parametrize("keys", [None, ("x",)])
def test_device_put_batch_matches_jax(keys):
    batch = _batches(1)[0]
    got = tpf.device_put_batch(batch, "cpu", array_keys=keys)
    ref = jpf.device_put_batch(batch, array_keys=keys)
    assert got.keys() == ref.keys()
    for k in ("x", "video"):
        moved = keys is None or k in keys
        assert isinstance(got[k], torch.Tensor) == moved, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    assert got["eid"] == batch["eid"]


def test_prefetch_propagates_errors_in_order():
    """A source that fails after two batches: the error reaches the
    consumer, as from the JAX prefetch (which raises it before yielding
    what it holds staged); the port yields both batches first."""
    def source():
        for b in _batches(2):
            yield b
        raise ValueError("shard unreadable")

    with pytest.raises(ValueError, match="shard unreadable"):
        list(jpf.prefetch_to_device(source()))
    it = tpf.prefetch_to_device(source(), "cpu")
    for want in _batches(2):
        np.testing.assert_array_equal(next(it)["x"].numpy(), want["x"])
    with pytest.raises(ValueError, match="shard unreadable"):
        next(it)


def test_prefetch_close_quiesces_the_source():
    """Closing the prefetch joins its producer: after close nothing draws
    from the source any more (the mid-epoch resume snapshot relies on
    it)."""
    drawn = []

    def source():
        for i in range(1000):
            drawn.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    before = set(threading.enumerate())
    gen = tpf.prefetch_to_device(source(), "cpu", depth=2)
    first = next(gen)
    assert float(first["x"][0]) == 0
    assert set(threading.enumerate()) - before     # the producer runs
    gen.close()
    n = len(drawn)
    time.sleep(0.2)
    assert len(drawn) == n < 10
    assert not set(threading.enumerate()) - before  # and was joined


def test_transform_runs_off_the_consumer_thread():
    """The host assembly (transform) runs on the producer thread, so the
    train step's thread only waits for staged batches."""
    seen = []

    def transform(b):
        seen.append(threading.get_ident())
        return b

    list(tpf.prefetch_to_device(iter(_batches(3)), "cpu",
                                transform=transform))
    assert seen and threading.get_ident() not in seen
