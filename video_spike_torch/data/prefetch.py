"""Background batch production.

Counterpart of ``background`` in ``video_spike_tpu/data/prefetch.py``: a
producer thread runs an iterable (host sampling and the host-to-device copy
of each staged batch) with a small queue of readahead while the consumer
runs the train step on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

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
