"""Trial dataset, split logic, and batched loading.

Capability parity with the reference loader stack:

- ``split_dataset`` (``reference:src/utils/dataset_utils.py:50-88``):
  list ``*.tar`` in the data dir, filter by eid substring, shuffle, split
  80/10/10, and report per-split eids.
- ``SessionDataset`` + ``make_loader`` (``reference:src/loader/
  base.py:11-103``, ``make.py:7-31``): decode trial shards, emit per-batch
  dicts of (B, ...) arrays with an ``eid`` string list.
- ``get_metadata_from_loader`` (``dataset_utils.py:99-119``): peek one batch
  to size the model (input_dim = concatenated flattened input modalities,
  output_dim = T_bins * n_neurons).

Batches are numpy; the trainers move them to the device
(``data/prefetch.prefetch_to_device`` on the streaming path). Uncached
shards stream through the C++ reader (``data/native_io.py``, its threads
read whole tars off the GIL in order) and a thread pool parses them ahead
of consumption; ``io_backend="python"`` (or ``"auto"`` where the reader does
not build) decodes on the pool from the paths instead. Decoded trials are
memoized per path (unbounded — IBL trials are ~2 MB, so a session's worth
fits comfortably in host RAM) because they are re-read every epoch.
"""

from __future__ import annotations

import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.data.tar_io import read_trial_tar

_BACKENDS_LOGGED: set = set()


def _log_backend_once(backend: str, why: str = "") -> None:
    if backend not in _BACKENDS_LOGGED:
        _BACKENDS_LOGGED.add(backend)
        make_logger(header="[data]").info(
            f"trial shards read by the {backend} reader{why}")


def get_eids_from_filenames(filenames: Sequence[str]) -> List[str]:
    return sorted({os.path.basename(f).split("_")[0] for f in filenames})


def split_dataset(data_dir: str | Path, eid,
                  train_ratio: float = 0.8, val_ratio: float = 0.1,
                  test_ratio: float = 0.1, seed: Optional[int] = None) -> dict:
    """80/10/10 split of the session's trial tars (reference semantics)."""
    data_dir = Path(data_dir)
    filenames = sorted(str(p) for p in data_dir.glob("*.tar"))
    if isinstance(eid, str):
        eid = [eid]
    filenames = [f for f in filenames if any(e in f for e in eid)]
    rng = random.Random(seed)
    rng.shuffle(filenames)
    split1 = int(train_ratio * len(filenames))
    split2 = int((train_ratio + val_ratio) * len(filenames))
    train, val, test = (filenames[:split1], filenames[split1:split2],
                        filenames[split2:])
    return {
        "train": train,
        "val": val,
        "test": test,
        "eid": {
            "train": get_eids_from_filenames(train),
            "val": get_eids_from_filenames(val),
            "test": get_eids_from_filenames(test),
        },
    }


def _collate(samples: List[dict]) -> Dict[str, np.ndarray]:
    """Stack a list of trial dicts into a batch dict; strings become lists."""
    batch: dict = {}
    keys = samples[0].keys()
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            batch[k] = np.asarray(vals)
        else:
            batch[k] = vals  # eid / __key__ / meta
    return batch


class SessionDataset:
    """Decoded-trial dataset over a list of tar shards with epoch shuffling."""

    def __init__(self, files: Sequence[str], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 modalities: Optional[Sequence[str]] = None,
                 cache: bool = True, num_workers: int = 8,
                 drop_last: bool = False, io_backend: str = "auto"):
        if io_backend not in ("auto", "native", "python"):
            raise ValueError(f"io_backend {io_backend!r} (auto, native or "
                             f"python)")
        self.files = list(files)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.modalities = set(modalities) if modalities else None
        self.cache = cache
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.io_backend = io_backend
        self._cache: Dict[str, dict] = {}
        self._epoch = 0
        self._native_reader = None
        # shards decoded by each backend (cache hits not counted)
        self.blobs_read = {"native": 0, "python": 0}
        self._count_lock = threading.Lock()

    def __len__(self) -> int:
        n = len(self.files)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_trials(self) -> int:
        return len(self.files)

    def _load(self, path: str) -> dict:
        if self.cache and path in self._cache:
            return self._cache[path]
        sample = read_trial_tar(path)
        with self._count_lock:          # _load runs on the pool's threads
            self.blobs_read["python"] += 1
        sample = self._select(sample)
        if self.cache:
            self._cache[path] = sample
        return sample

    def _select(self, sample: dict) -> dict:
        out = {"eid": sample.get("eid", ""), "__key__": sample.get("__key__", "")}
        for k, v in sample.items():
            if k in ("eid", "__key__", "meta"):
                continue
            if self.modalities is None or k in self.modalities:
                if isinstance(v, np.ndarray) and v.dtype not in (
                        np.float32, np.uint8):
                    # video stays uint8 end-to-end (4x cheaper H2D; models
                    # cast on device); everything else becomes float32
                    v = v.astype(np.float32)
                out[k] = v
        return out

    def _native_stream(self, uncached):
        """An iterator of (path, blob) over `uncached` from the persistent
        reader (reset each epoch), or None where ``auto`` takes the python
        reader: the library does not build, or the reader fails to start.
        Under ``native`` both raise."""
        from video_spike_torch.data.native_io import (
            NativeShardReader, build_error, native_available)

        if self.io_backend == "auto" and not native_available():
            _log_backend_once("python", f" (the native reader did not "
                                        f"build: {build_error()})")
            return None
        try:
            if self._native_reader is None:
                self._native_reader = NativeShardReader(
                    uncached, n_workers=self.num_workers)
            else:
                self._native_reader.reset(uncached)
        except Exception:
            if self.io_backend == "native":
                raise
            _log_backend_once("python", " (the native reader failed to "
                                        "start)")
            return None
        _log_backend_once("native")
        return iter(self._native_reader)

    def _iter_samples(self, order) -> Iterator[dict]:
        """Yield decoded samples following `order`, streaming uncached
        shards through the native reader unless ``io_backend`` is python."""
        uncached = ([p for p in order if p not in self._cache]
                    if self.cache else list(order))
        native_gen = None
        if self.io_backend != "python" and uncached:
            native_gen = self._native_stream(uncached)
        elif self.io_backend == "python":
            _log_backend_once("python")
        if native_gen is None:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                yield from pool.map(self._load, order)
            return
        from video_spike_torch.data.native_io import parse_tar_blob

        select = self._select
        # C++ threads stream blobs; a Python pool parses them (pickle + tar
        # headers) ahead of consumption, results yielded in order
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: list = []
            depth = max(2 * self.num_workers, 4)

            def emit(fut, path):
                sample = fut.result()
                if self.cache:
                    self._cache[path] = sample
                return sample

            for path in order:
                if self.cache and path in self._cache:
                    pending.append((None, path))
                else:
                    blob_path, blob = next(native_gen)
                    assert blob_path == path, (blob_path, path)
                    self.blobs_read["native"] += 1
                    pending.append(
                        (pool.submit(lambda b: select(parse_tar_blob(b)),
                                     blob), path))
                while len(pending) > depth:
                    fut, p = pending.pop(0)
                    yield self._cache[p] if fut is None else emit(fut, p)
            for fut, p in pending:
                yield self._cache[p] if fut is None else emit(fut, p)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(self.files)
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        bs = self.batch_size
        batch: list = []
        for sample in self._iter_samples(order):
            batch.append(sample)
            if len(batch) == bs:
                yield _collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield _collate(batch)


def make_loader(config, dataset_split_dict, seed: Optional[int] = None):
    """(train, val, test) SessionDatasets from a split dict + config
    (parity with ``reference:src/loader/make.py:7-31``)."""
    mods = list(config.data.modalities.keys()) + ["timestamp"]
    train_bs = config.training.train_batch_size
    test_bs = config.training.test_batch_size
    seed = config.get("seed", 0) if seed is None else seed
    train = SessionDataset(dataset_split_dict["train"], train_bs,
                           shuffle=True, seed=seed, modalities=mods)
    val = SessionDataset(dataset_split_dict["val"], test_bs, modalities=mods)
    test = SessionDataset(dataset_split_dict["test"], test_bs, modalities=mods)
    return train, val, test


def input_modalities(config) -> List[str]:
    """Modalities flagged ``input: true`` in the config
    (``reference:src/trainer/base.py:8-14``)."""
    mods = []
    for mod in config.data.modalities.keys():
        entry = config.data.modalities[mod]
        if isinstance(entry, dict) and entry.get("input"):
            mods.append(mod)
    return mods


def get_metadata_from_loader(loader: SessionDataset, config) -> dict:
    """Peek one batch to infer model dimensions (reference parity)."""
    batch = next(iter(loader))
    mods = input_modalities(config)
    input_dim = 0
    for mod in mods:
        arr = batch[mod]
        input_dim += int(np.prod(arr.shape[1:]))
    n_neurons = batch["ap"].shape[2]
    return {
        "num_neurons": n_neurons,
        "input_dim": input_dim,
        "input_mods": mods,
        "output_dim": batch["ap"].shape[1] * n_neurons,
    }
