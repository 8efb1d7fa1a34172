"""Embed whisker video with the CEBRA-style embedder (or PCA) and cache the
per-session RRR feature file.

Counterpart of ``video_spike_tpu/cli/use_cebra.py`` (reference
``src/use_cebra.py``), plus ``--device``:

    python -m video_spike_torch.cli.use_cebra --eid <eid> \
        --model_config configs/model/linear_me.yaml \
        --train_config configs/train/rrr.yaml [--data_dir ...] \
        [--use_pca] [--out_dim 5] [--max_iterations 5000] [--device cuda|cpu]

It reads the train and test whisker video through the loaders, embeds the
frames (train and test jointly) and saves
``data/data_rrr_<cebra|pca>_<eid5>.npy`` relative to the working
directory; ``cli.unify_cebra`` merges those for ``cli.train_rrr``. The
CEBRA fit writes ``<cebra>_<eid5>_loss.png`` and ``..._embedding.png``
unless ``main`` is given ``save_path=None`` (a host without matplotlib).
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.data.dataset import make_loader, split_dataset
from video_spike_torch.data.rrr_data import get_rrr_data
from video_spike_torch.models.cebra import (get_cebra_embedding,
                                            get_pca_embedding)

_DEFAULT = object()     # save_path: the JAX package's f"{label}_{eid[:5]}"


def build(argv=None) -> dict:
    """Parse the arguments and read the session's whisker video: the
    options, the label, and the train + test frames with their spikes."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--use_pca", action="store_true")
    parser.add_argument("--out_dim", type=int, default=5)
    parser.add_argument("--max_iterations", type=int, default=5000)
    extra, rest = parser.parse_known_args(argv)
    args = get_args(rest)
    setup_runtime(args.device)
    resolve_device(args.device)      # a missing card raises before any work

    config = config_from_kwargs({"model": f"include:{args.model_config}"})
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30),
    # so --seed actually takes effect over the yaml
    config["seed"] = args.seed
    if args.data_dir:
        config["dirs"]["data_dir"] = args.data_dir
    if "whisker-video" not in config.data.modalities:
        config["data"]["modalities"]["whisker-video"] = {
            "transform": None, "input": False}
    set_seed(config.seed)

    split = split_dataset(config.dirs.data_dir, eid=args.eid,
                          seed=config.seed)
    train_dl, _val_dl, test_dl = make_loader(config, split)
    train_X, train_y, _ = get_rrr_data(train_dl, "whisker-video")
    test_X, test_y, _ = get_rrr_data(test_dl, "whisker-video")
    return {"args": args, "extra": extra,
            "label": "pca" if extra.use_pca else "cebra",
            "X": np.concatenate([train_X, test_X], axis=0),
            "n_train": train_X.shape[0], "y": [train_y, test_y]}


def main(argv=None, *, save_path=_DEFAULT) -> dict:
    """Returns the written path, the embedding, the seconds of the fit
    (CEBRA) or the projection (PCA), and for CEBRA the fitted model and its
    sampled losses."""
    run = build(argv)
    args, extra, label = run["args"], run["extra"], run["label"]
    eid, n_train = args.eid, run["n_train"]
    if save_path is _DEFAULT:
        save_path = f"{label}_{eid[:5]}"

    model = None
    t0 = time.perf_counter()
    if extra.use_pca:
        emb = get_pca_embedding(run["X"], out_dim=extra.out_dim,
                                device=args.device)
    else:
        emb, model = get_cebra_embedding(
            run["X"], out_dim=extra.out_dim, save_path=save_path,
            max_iterations=extra.max_iterations, device=args.device,
            return_model=True)
    seconds = time.perf_counter() - t0

    train_data = {eid: {"X": [emb[:n_train], emb[n_train:]],
                        "y": run["y"], "setup": {}}}
    os.makedirs("data", exist_ok=True)
    out = f"data/data_rrr_{label}_{eid[:5]}.npy"
    np.save(out, train_data)
    print(f"saved {out}")
    return {"path": out, "embedding": emb,
            "seconds": model.fit_seconds_ if model else seconds,
            "model": model, "losses": model.losses_ if model else None}


if __name__ == "__main__":
    run_rank(main)
