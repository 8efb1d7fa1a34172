"""Host-to-device streaming: background batch production and a pinned,
double-buffered copy to the card.

Counterpart of ``video_spike_tpu/data/prefetch.py``:

- ``background`` runs an iterable on a producer thread with a small queue
  of readahead while the consumer runs the train step on the card; the
  consumer's wait for the next item is the ``producer_wait`` span;
- ``device_put_batch`` moves a batch dict's arrays to a device (strings
  stay on the host);
- ``prefetch_to_device`` decodes and stages batches ``depth`` ahead. On a
  CUDA device the producer thread copies each array into a pinned host
  buffer (a ring of ``depth + 1`` slots per key and shape, allocated once:
  pinning each batch anew would call ``cudaHostAlloc`` every step) and
  issues a ``non_blocking`` copy on its own stream;
  an event per slot marks the copy done, and a slot is refilled only after
  its event completed. The consumer's stream waits on that event before it
  uses the batch, and each output is ``record_stream``-ed on the consumer's
  stream, so the caching allocator never recycles it early. On the CPU it
  is ``torch.from_numpy`` behind ``background``, with no pinning.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from video_spike_torch.core.spans import span

_SENTINEL = object()


def _producer(it: Iterable, q: "queue.Queue", err: list,
              stop: "threading.Event") -> None:
    try:
        for item in it:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
    except BaseException as e:  # handed to the consumer, which re-raises
        err.append(e)
    finally:
        # the sentinel must land even when the queue is momentarily full
        # (normal exhaustion with a slow consumer), but must not block
        # forever once the consumer has abandoned the queue (stop set)
        while not stop.is_set():
            try:
                q.put(_SENTINEL, timeout=0.05)
                break
            except queue.Full:
                continue


def background(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run `iterable` in a daemon thread, yielding with `depth` readahead.

    Closing the generator (``.close()``, or abandoning it) stops the
    producer thread and joins it, so after close no code touches the source
    iterable or its rng streams — callers that snapshot sampler state for a
    mid-epoch resume (``ContrastTrainer.fit``) rely on this quiescence."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()
    t = threading.Thread(target=_producer, args=(iterable, q, err, stop),
                         daemon=True)
    t.start()
    try:
        while True:
            with span("producer_wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # a timed-out join that silently proceeded would let the producer
        # finish an in-flight draw after the caller snapshots sampler/rng
        # state; the producer re-checks `stop` every 50 ms around puts, so
        # only a source draw stuck for a minute can outlive the window
        t.join(timeout=60.0)
        if t.is_alive():
            raise RuntimeError(
                "background() producer failed to quiesce within 60 s of "
                "close; the source iterable may still be mid-draw, so "
                "sampler-state snapshots taken now would be unsafe")


def _arrays(batch: Dict, array_keys: Optional[Sequence[str]]):
    return [k for k, v in batch.items() if isinstance(v, np.ndarray)
            and (array_keys is None or k in array_keys)]


def device_put_batch(batch: Dict, device,
                     array_keys: Optional[Sequence[str]] = None) -> Dict:
    """Move the array entries of a batch dict to `device` (strings and
    lists stay on the host); a plain, pageable copy."""
    device = torch.device(device)
    keys = set(_arrays(batch, array_keys))
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if k in keys else v) for k, v in batch.items()}


class _PinnedRing:
    """Pinned host slots (one tensor per array key and shape in each) and
    the copy stream the producer thread stages through."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = slots
        self.buffers: list = [dict() for _ in range(slots)]
        self.done: list = [None] * slots       # event of each slot's copy
        self.turn = 0

    def stage(self, batch: Dict) -> tuple:
        """Copy `batch`'s arrays into the next slot and on to the device on
        the copy stream; (device batch, the event its copies complete)."""
        slot = self.turn % self.slots
        self.turn += 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()   # its last copy has left the slot
        bufs = self.buffers[slot]
        out = dict(batch)
        with torch.cuda.stream(self.stream):
            for k in _arrays(batch, None):
                v = np.ascontiguousarray(batch[k])
                key = (k, v.shape, v.dtype.str)
                host = bufs.get(key)
                if host is None:
                    host = bufs[key] = torch.from_numpy(v).pin_memory()
                else:
                    host.numpy()[...] = v
                out[k] = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.done[slot] = done
        return out, done


def prefetch_to_device(iterable: Iterable[Dict], device, depth: int = 2,
                       transform: Optional[Callable[[Dict], Dict]] = None
                       ) -> Iterator[Dict]:
    """Decode on a producer thread and keep `depth` batches staged on
    `device`, in order. `transform` runs on the host batch (e.g. assembling
    the model's inputs) before the copy."""
    device = torch.device(device)
    if device.type != "cuda":
        def host():
            for batch in iterable:
                if transform is not None:
                    batch = transform(batch)
                yield device_put_batch(batch, device)

        yield from background(host(), depth=depth)
        return
    ring = _PinnedRing(device, depth + 1)

    def staged():
        for batch in iterable:
            if transform is not None:
                batch = transform(batch)
            yield ring.stage(batch)

    consumer = torch.cuda.current_stream(device)
    for out, done in background(staged(), depth=depth):
        consumer.wait_event(done)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(consumer)
        yield out
