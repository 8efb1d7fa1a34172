"""Micro-batching request queue: coalesce concurrent single-trial requests
into one device dispatch.

A copy of ``video_spike_tpu/serve/batcher.py`` (numpy and threads only).
A forward on a batch of 16 costs barely more than on a batch of 1 (the
launches and the walk over the weights dominate at serving shapes), so
throughput under concurrent load comes from batching, not from parallel
single-row calls.
The batcher holds arriving requests for at most ``max_delay_ms`` (or until
``max_batch`` are waiting), stacks them, runs one ``predict``, and fans the
rows back out through futures. Latency percentiles are tracked in-process.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np


class MicroBatcher:
    def __init__(self, predict_fn: Callable, max_batch: int = 16,
                 max_delay_ms: float = 5.0,
                 sample_ndim: Optional[int] = None):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        # rank of ONE sample (no batch dim); lets the HTTP front end detect
        # a client that POSTed a batch without the X-Batched header and fan
        # it out instead of surfacing a shape error from inside the forward
        self.sample_ndim = sample_ndim
        self.max_delay_s = max_delay_ms / 1e3
        self._queue: List[Tuple[np.ndarray, Optional[int], Future, float]] = []
        self._lock = threading.Condition()
        self._closed = False
        self._latencies_ms: List[float] = []
        self.dispatches = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, row: np.ndarray,
               session_id: Optional[int] = None) -> Future:
        """Enqueue one sample (no batch dim); resolves to its output row."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append((np.asarray(row), session_id, fut,
                                time.perf_counter()))
            self._lock.notify()
        return fut

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------
    def _take_batch(self) -> List[Tuple[np.ndarray, Optional[int], Future,
                                        float]]:
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if not self._queue:
                return []
            deadline = self._queue[0][3] + self.max_delay_s
            while (len(self._queue) < self.max_batch
                   and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            rows = np.stack([b[0] for b in batch])
            sids = (np.asarray([b[1] or 0 for b in batch], np.int32)
                    if any(b[1] is not None for b in batch) else None)
            try:
                kw = {"session_ids": sids} if sids is not None else {}
                out = self.predict_fn(rows, **kw)
            except Exception as e:       # propagate to every caller
                for _, _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            now = time.perf_counter()
            self.dispatches += 1
            for i, (_, _, fut, t0) in enumerate(batch):
                self._latencies_ms.append((now - t0) * 1e3)
                fut.set_result(out[i])
            del self._latencies_ms[:-10000]   # bounded history

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        lat = np.asarray(self._latencies_ms[-10000:], np.float64)
        if lat.size == 0:
            return {"served": 0, "dispatches": self.dispatches}
        return {
            "served": int(lat.size),
            "dispatches": self.dispatches,
            "mean_batch": round(lat.size / max(self.dispatches, 1), 2),
            "p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p99_ms": round(float(np.percentile(lat, 99)), 3),
        }
