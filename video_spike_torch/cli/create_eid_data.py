"""Extract per-session (X, y, timestamp) feature arrays for the RRR path.

Counterpart of ``video_spike_tpu/cli/create_eid_data.py`` (reference
``src/create_eid_data.py:31-123``):

    python -m video_spike_torch.cli.create_eid_data --input_mod me \
        --data_dir <trial tars> [--eid <eid>]

For each eid in ``data/eid.txt`` (or ``--eid``) it builds the trial loaders,
extracts the features of ``--input_mod`` and saves
``data/data_rrr_<mod>.npy``, or ``data/data_rrr_whisker-video.h5`` (needs
``h5py``) for ``whisker-video``. Split order in the artifact is
[train, test, val]. Host only: there is no ``--device``.

One addition to the JAX package's interface: :func:`build` returns the
features before they are written and :func:`split_dict` lays them out as
``data/contrast.load_h5_file`` returns the h5, so the SSL entry points
(``cli/pretrain.main``, ``cli/test.main``, their ``data`` argument) can run
on a machine without ``h5py``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.data.dataset import make_loader, split_dataset
from video_spike_torch.data.rrr_data import SHORTNAME_TO_MOD, get_rrr_data

SPLITS = ("train", "test", "val")   # the artifact's split order


def read_eids(args) -> list:
    eid_file = Path("data/eid.txt")
    if eid_file.exists():
        return [l.strip() for l in eid_file.read_text().splitlines() if l.strip()]
    return [args.eid]


def build(argv=None):
    """(args, {eid: {"X": [train, test, val], "y": [...], "timestamp": [...],
    "setup": {}}}) for the modality of ``--input_mod``."""
    args = get_args(argv)
    setup_runtime("cpu")
    config = config_from_kwargs({"model": f"include:{args.model_config}"})
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30)
    config["seed"] = args.seed
    if args.data_dir:
        config["dirs"]["data_dir"] = args.data_dir
    set_seed(config.seed)

    input_mod = SHORTNAME_TO_MOD.get(args.input_mod, args.input_mod)
    # make sure the loaders decode the modalities this extraction reads
    needed = {"ap", "timestamp", "choice", "block", "wheel-speed",
              "whisker-motion-energy"}
    if input_mod in ("whisker-of-video", "of-all"):
        needed.add("whisker-of-video")
    if input_mod not in ("all", "other", "of-all"):
        needed.add(input_mod)
    for mod in needed:
        if mod not in config.data.modalities:
            config["data"]["modalities"][mod] = {
                "transform": None, "input": False}
    eids = read_eids(args)

    train_data = {eid: {"X": [], "y": [], "timestamp": [], "setup": {}}
                  for eid in eids}
    for eid in eids:
        split = split_dataset(config.dirs.data_dir, eid=eid, seed=config.seed)
        train_dl, val_dl, test_dl = make_loader(config, split)
        for dl in (train_dl, test_dl, val_dl):
            X, y, ts = get_rrr_data(dl, input_mod)
            train_data[eid]["X"].append(X)
            train_data[eid]["y"].append(y)
            train_data[eid]["timestamp"].append(ts)
    return args, train_data


def split_dict(train_data: dict) -> dict:
    """{eid: {"train_X", "train_y", "train_timestamp", "test_X", ...}}: the
    layout ``data/contrast.load_h5_file`` reads from the h5."""
    out = {}
    for eid, data in train_data.items():
        entry = {}
        for i, split in enumerate(SPLITS):
            entry[f"{split}_X"] = data["X"][i]
            entry[f"{split}_y"] = data["y"][i]
            entry[f"{split}_timestamp"] = data["timestamp"][i]
        out[eid] = entry
    return out


def write_h5(out: str, train_data: dict) -> None:
    import h5py

    with h5py.File(out, "w") as f:
        for eid, entry in split_dict(train_data).items():
            grp = f.create_group(str(eid))
            for split in SPLITS:
                for key in ("X", "y", "timestamp"):
                    grp.create_dataset(f"{key}_{split}",
                                       data=entry[f"{split}_{key}"],
                                       compression="gzip")


def main(argv=None):
    args, train_data = build(argv)
    os.makedirs("data", exist_ok=True)
    if args.input_mod == "whisker-video":
        out = "data/data_rrr_whisker-video.h5"
        write_h5(out, train_data)
    else:
        out = f"data/data_rrr_{args.input_mod}.npy"
        np.save(out, train_data)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    run_rank(main)
