"""Frame-level contrastive dataset over cached whisker-video features.

Counterpart of ``video_spike_tpu/data/contrast.py`` (reference
``src/loader/contrast.py:9-115`` and ``load_h5_file``,
``src/utils/dataset_utils.py:7-47``):

- ``pretrain`` mode concatenates the train/val/test splits, flattens trials
  to frames, sorts by timestamp, and yields ``{ref, pos, neg}`` with the
  positive drawn uniformly within ±``idx_offset`` frames (or ``time_offset``
  seconds) and the negative uniformly excluding the reference index; the
  draws are the JAX package's numpy streams (``default_rng(seed)``), and
  ``sampler_state`` / ``set_sampler_state`` + ``skip`` replay an epoch
  exactly;
- ``train``/``val``/``test`` modes yield per-trial ``{ref, neural}`` pairs.

Frames stay uint8 on the host; :func:`device_frame_transform` resizes and
normalizes them on the card inside the train step.

One addition to the JAX package's interface: ``make_contrast_loader``
takes either the h5 path or the split dict that :func:`load_h5_file` returns
(``cli/create_eid_data.split_dict`` builds it), so the SSL path runs where
``h5py`` is not installed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F


def load_h5_file(file_path: str, eid: Optional[str] = None) -> Dict:
    """Load the cached whisker-video h5 into per-eid split dicts."""
    import h5py
    if isinstance(eid, str):
        eids = [eid]
    with h5py.File(file_path, "r") as f:
        if eid is None:
            eids = list(f.keys())
        out = {}
        for e in eids:
            grp = f[e]
            entry = {}
            for split in ("train", "test", "val"):
                entry[f"{split}_X"] = grp[f"X_{split}"][()]
                entry[f"{split}_y"] = grp[f"y_{split}"][()]
                entry[f"{split}_timestamp"] = grp[f"timestamp_{split}"][()]
            out[e] = entry
    return out


class ContrastDataset:
    """Frame dataset with temporal positive sampling; ``rank`` / ``world``
    of the batch iterators stride it over the ranks of a process group."""

    def __init__(self, data_dict: Dict, mode: str,
                 image_size: int = 144, idx_offset: int = 10,
                 time_offset: Optional[float] = None, seed: int = 0):
        assert mode in ("pretrain", "train", "val", "test"), mode
        self.mode = mode
        self.image_size = image_size
        self.idx_offset = idx_offset
        self.time_offset = time_offset
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._epoch = 0

        if mode == "pretrain":
            video = np.concatenate([data_dict["train_X"], data_dict["val_X"],
                                    data_dict["test_X"]], axis=0)
            n, t, c, h, w = video.shape
            video = video.reshape(n * t, c, h, w)
            ts = np.concatenate([data_dict["train_timestamp"],
                                 data_dict["val_timestamp"],
                                 data_dict["test_timestamp"]],
                                axis=0).reshape(-1)
            order = np.argsort(ts)
            self.video = np.ascontiguousarray(video[order])
            self.timestamp = ts[order]
            self.labels = None
        else:
            self.video = np.asarray(data_dict[f"{mode}_X"])
            self.labels = np.asarray(data_dict[f"{mode}_y"])
            self.timestamp = np.asarray(data_dict[f"{mode}_timestamp"])
        self.num_frames = self.video.shape[0]

    def __len__(self) -> int:
        return len(self.video)

    # -- index sampling (reference `_select_pos_idx` / `_select_neg_idx`) ---
    def _pos_idx(self, idx: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = self.rng if rng is None else rng
        if self.time_offset is None:
            start = np.maximum(0, idx - self.idx_offset)
            end = np.minimum(self.num_frames, idx + self.idx_offset + 1)
            return rng.uniform(start, end).astype(np.int64)
        ts = self.timestamp
        out = np.empty_like(idx)
        for i, j in enumerate(idx):
            valid = np.where(np.abs(ts - ts[j]) <= self.time_offset)[0]
            out[i] = rng.choice(valid) if valid.size else j
        return out

    def _neg_idx(self, idx: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = self.rng if rng is None else rng
        neg = rng.integers(0, self.num_frames, size=idx.shape)
        clash = neg == idx
        while np.any(clash):
            neg[clash] = rng.integers(0, self.num_frames,
                                      size=int(clash.sum()))
            clash = neg == idx
        return neg

    # -- sampler checkpointing (mid-epoch resume) ---------------------------
    def sampler_state(self) -> Dict:
        """JSON-serializable snapshot of the sampling stream (the numpy
        Generator's bit-generator state; PCG64 ints are arbitrary-precision
        and JSON-safe) plus the multi-process epoch counter. Capture it
        before an epoch's ``iter_batches`` call; :meth:`set_sampler_state` +
        ``skip=`` replays that epoch's batch stream exactly."""
        return {"rng_state": self.rng.bit_generator.state,
                "epoch": self._epoch}

    def set_sampler_state(self, state: Dict,
                          restore_rng: bool = True) -> None:
        if restore_rng:
            self.rng.bit_generator.state = state["rng_state"]
        self._epoch = int(state.get("epoch", 0))

    # -- batching ------------------------------------------------------------
    def iter_index_batches(self, batch_size: int, shuffle: bool = True,
                           rank: int = 0, world: int = 1,
                           skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Like :meth:`iter_batches` but yields frame indices instead of
        frames — the frame cache's input (the trainer gathers rows on the
        card). Draws from the same rng stream in the same order, so sampler
        snapshots and ``skip`` replay identically in both forms.

        One process draws from the stateful ``self.rng`` stream. With
        ``world > 1`` the draws are stateless: the epoch's order comes from
        ``default_rng((seed, epoch))``, the same on every rank, and each
        batch's pos/neg draws from ``default_rng((seed, epoch, rank, batch
        position))``, so a mid-epoch resume on any rank replays the rest
        of the epoch exactly without per-rank rng state."""
        order = np.arange(len(self))
        epoch_used = self._epoch
        if shuffle:
            if world > 1:
                np.random.default_rng((self.seed, self._epoch)).shuffle(order)
                self._epoch += 1
            else:
                self.rng.shuffle(order)
        if world > 1:
            order = order[rank::world]
        for bi, s in enumerate(range(0, len(order), batch_size)):
            idx = order[s:s + batch_size]
            if skip > 0:
                skip -= 1
                if self.mode == "pretrain" and world == 1:
                    # consume the skipped batches' draws so the stream stays
                    # bit-aligned with the original epoch (the counter-keyed
                    # multi-process draws need none)
                    self._pos_idx(idx)
                    self._neg_idx(idx)
                continue
            if self.mode == "pretrain":
                rng = (np.random.default_rng((self.seed, epoch_used, rank, bi))
                       if world > 1 else None)
                yield {"ref": idx, "pos": self._pos_idx(idx, rng),
                       "neg": self._neg_idx(idx, rng)}
            else:
                yield {"ref": idx}

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     rank: int = 0, world: int = 1,
                     skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Frame batches ({ref, pos, neg} uint8) in pretrain mode, trial
        batches ({ref, neural}) otherwise. ``rank`` / ``world`` stride the
        shuffled frame order over the ranks (the DistributedSampler
        contract): every rank derives the same order from (seed, epoch),
        takes ``order[rank::world]``, and still draws positives and
        negatives from the whole frame array."""
        for ib in self.iter_index_batches(batch_size, shuffle=shuffle,
                                          rank=rank, world=world, skip=skip):
            if self.mode == "pretrain":
                yield {"ref": self.video[ib["ref"]],
                       "pos": self.video[ib["pos"]],
                       "neg": self.video[ib["neg"]]}
            else:
                yield {"ref": self.video[ib["ref"]],
                       "neural": self.labels[ib["ref"]]}


class ContrastLoader:
    """A re-iterable view of a :class:`ContrastDataset` in batches."""

    def __init__(self, dataset: ContrastDataset, batch_size: int,
                 shuffle: bool):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle

    def __iter__(self):
        return self.dataset.iter_batches(self.batch_size, shuffle=self.shuffle)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size


def make_contrast_loader(dataset, mode: str = "pretrain",
                         eid: Optional[str] = None, batch_size: int = 512,
                         shuffle: bool = True, idx_offset: int = 4,
                         time_offset: Optional[float] = None,
                         image_size: int = 144, seed: int = 0):
    """(loader, 1) factory (reference ``src/loader/make.py:33-59``).
    ``dataset`` is the h5 path or the ``{eid: split dict}`` that
    :func:`load_h5_file` returns."""
    data = (dataset if isinstance(dataset, Mapping)
            else load_h5_file(dataset, eid))
    key = eid if eid is not None else next(iter(data))
    ds = ContrastDataset(data[key], mode=mode, image_size=image_size,
                         idx_offset=idx_offset, time_offset=time_offset,
                         seed=seed)
    return ContrastLoader(ds, batch_size, shuffle), 1


def device_frame_transform(frames: torch.Tensor, image_size: int = 144,
                           normalize: bool = True) -> torch.Tensor:
    """uint8 (B, C, H, W) frames -> resized, normalized f32 on their device.

    The reference's torchvision Resize(144) + Normalize(0.5, 0.5) on /255
    inputs (``src/pretrain.py:60-66``). ``jax.image.resize(..., "linear")``
    antialiases when it shrinks an axis, so the resize is the antialiased
    bilinear one (half-pixel centres); without the antialias a 106×160 crop
    would differ by up to 0.11."""
    x = frames.float() / 255.0
    h, w = x.shape[-2:]
    if (h, w) != (image_size, image_size):
        x = F.interpolate(x, size=(image_size, image_size), mode="bilinear",
                          align_corners=False, antialias=True)
    if normalize:
        x = (x - 0.5) / 0.5
    return x
