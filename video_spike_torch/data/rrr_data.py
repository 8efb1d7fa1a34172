"""Per-modality feature extraction for the RRR pipeline.

A numpy copy of ``video_spike_tpu/data/rrr_data.py`` (reference
``get_rrr_data``, ``src/utils/utils.py:226-304``): iterates a loader and
assembles (X, y, timestamps) per input modality:

- ``whisker-of-video``: per-frame median over the spatial dims of the dense
  flow's x and y channels -> (K, T, 2);
- ``all``: [motion-energy, wheel-speed, choice, block] with the per-trial
  choice/block repeated across T -> (K, T, 4);
- ``other``: [wheel-speed, choice, block];
- ``of-all``: median flow xy (+ last frame repeated if the flow is T-1 long)
  + wheel/choice/block -> (K, T, 5);
- ``whisker-video`` / ``wheel-speed`` / default: the raw modality array.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _median_flow_xy(of_video: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(K, T, H, W, 2) dense flow -> per-frame spatial medians (K, T) x 2."""
    x_vec = np.median(of_video[..., 0], axis=(2, 3))
    y_vec = np.median(of_video[..., 1], axis=(2, 3))
    return x_vec, y_vec


def _repeat_trialwise(arr: np.ndarray, T: int) -> np.ndarray:
    """(K, 1) per-trial scalar -> (K, T)."""
    return np.repeat(arr.reshape(len(arr), -1)[:, :1], T, axis=1)


def get_rrr_data(loader, input_mod: str):
    """Extract (X, y, timestamps) arrays for `input_mod` from a loader."""
    X, y, timestamps = [], [], []
    for batch in loader:
        assert "timestamp" in batch, "timestamp is not in the batch"
        timestamps.append(np.asarray(batch["timestamp"]))
        if input_mod == "whisker-of-video":
            x_vec, y_vec = _median_flow_xy(np.asarray(batch["whisker-of-video"]))
            X.append(np.stack([x_vec, y_vec], axis=2))
        elif input_mod in ("all", "other", "of-all"):
            wheel = np.asarray(batch["wheel-speed"])
            T = wheel.shape[1]
            choice = _repeat_trialwise(np.asarray(batch["choice"]), T)
            block = _repeat_trialwise(np.asarray(batch["block"]), T)
            cols = []
            if input_mod == "of-all":
                x_vec, y_vec = _median_flow_xy(
                    np.asarray(batch["whisker-of-video"]))
                of = np.stack([x_vec, y_vec], axis=2)
                if of.shape[1] == T - 1:  # flow between frame pairs
                    of = np.concatenate([of, of[:, -1:]], axis=1)
                cols.append(of)
            if input_mod == "all":
                cols.append(np.asarray(batch["whisker-motion-energy"])[..., None])
            cols += [wheel[..., None], choice[..., None], block[..., None]]
            X.append(np.concatenate(cols, axis=2))
        elif input_mod in batch:
            X.append(np.asarray(batch[input_mod]))
        else:
            raise KeyError(f"modality {input_mod!r} not in batch "
                           f"(have {sorted(batch.keys())})")
        y.append(np.asarray(batch["ap"]))
    return (np.concatenate(X, axis=0), np.concatenate(y, axis=0),
            np.concatenate(timestamps, axis=0))


# CLI short-name -> stored modality (the dispatch tables of the reference's
# src/create_eid_data.py:40-59 and train_rrr.py:51-83)
SHORTNAME_TO_MOD = {
    "me": "whisker-motion-energy",
    "of": "whisker-of",
    "of-2d": "whisker-of-video",
    "of-2d-v": "whisker-of-video",
    "all": "all",
    "other": "other",
    "me-all": "all",
    "of-all": "of-all",
    "ws": "wheel-speed",
    "whisker-video": "whisker-video",
    "cebra": "cebra",
    "pca": "pca",
    "vit": "vit",
    "cm": "cm",
    "m": "m",
    "c": "c",
}

# short names whose cached feature files are already embeddings and skip the
# one-hot step in train_rrr (reference train_rrr.py:120-131)
EMBEDDING_MODS = {"cebra", "pca", "ws", "whisker-video", "vit", "cm", "m", "c"}
