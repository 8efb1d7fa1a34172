"""Supervised end-to-end training entry point.

CLI parity with the reference's ``src/train.py:24-107`` (the ``train.sh``
path) and with ``video_spike_tpu/cli/train.py``, plus ``--device``:

    python -m video_spike_torch.cli.train \
        --model_config configs/model/linear_video.yaml \
        --train_config configs/train/linear_video.yaml \
        --eid <eid> [--data_dir ...] [--num_epochs N] [--device cuda|cpu]

Flow: config merge -> seed -> 80/10/10 trial split -> loaders -> metadata
probe -> model from registry on the device -> optimizer + OneCycle ->
Poisson NLL -> trainer. The same path trains the VideoMAE probe
(``configs/model/videomae/videomae.yaml``: its frozen backbone, from
``model.pretrained_backbone`` when set, is encoded once and the head
trains on the features). ``--eid all`` (the sessions of ``data/eid.txt``) or
a comma list ``--eid e1,e2,...`` trains the multi-session flagship
(``configs/model/vtt_video.yaml``) instead, sized from the probed sessions.
Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises. Under ``torch.distributed.run`` the ranks train
data-parallel (``core/runtime.setup_runtime``; each rank reads its shard of
the training trials, ``--batch_size`` is the per-rank batch):

    torchrun --nproc_per_node=K -m video_spike_torch.cli.train ...

``training.mesh: {data: D, model: M}`` in the train yaml (D·M = K) reaches
both trainers: the parameters stay replicated, the M ranks of a data row
read the same shard and run the same rows, and ``--batch_size`` is a data
row's batch (global D × batch).
"""

from __future__ import annotations

from pathlib import Path

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import setup_runtime
from video_spike_torch.data.dataset import (
    get_metadata_from_loader,
    make_loader,
    split_dataset,
)
from video_spike_torch.parallel.multihost import shard_files_for_process
from video_spike_torch.train.base import BaseTrainer
from video_spike_torch.train.multisession import MultiSessionTrainer


def build_trainer(args):
    """Config, data, model and trainer from parsed args: a
    ``BaseTrainer`` for one session, a ``MultiSessionTrainer`` for
    ``--eid all`` or a comma list."""
    log = make_logger(header="[train]")
    device = resolve_device(args.device)
    kwargs = {"model": f"include:{args.model_config}"}
    config = config_from_kwargs(kwargs)
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30)
    config["seed"] = args.seed
    if args.data_dir:
        config["dirs"]["data_dir"] = args.data_dir
    if args.num_epochs is not None:
        config["training"]["num_epochs"] = args.num_epochs
    if args.batch_size is not None:
        config["training"]["train_batch_size"] = args.batch_size
    config["save_plot"] = bool(args.save_plot)

    set_seed(config.seed)
    if args.eid == "all" or "," in args.eid:
        return _build_multisession(args, config, log, device)

    split = split_dataset(config.dirs.data_dir, eid=args.eid,
                          seed=config.seed)
    if not split["train"]:
        raise SystemExit(
            f"no trial tars for eid {args.eid} in {config.dirs.data_dir}")
    # this rank's training shard (its data row's, under a model axis);
    # val/test stay whole on every rank
    mesh_cfg = config.training.get("mesh", {}) or {}
    local_split = dict(split, train=shard_files_for_process(
        split["train"], mesh_cfg.get("model", 1), mesh_cfg.get("data")))
    train_dl, val_dl, test_dl = make_loader(config, local_split)
    meta = get_metadata_from_loader(train_dl, config)
    log.info(f"meta_data: {meta}")

    config["model"]["encoder"]["input_dim"] = meta["input_dim"]
    config["model"]["decoder"]["output_dim"] = meta["output_dim"]
    model_ctor = NAME2MODEL[config.model.model_class]
    model = model_ctor.from_config(config.model, device=device)

    return BaseTrainer(
        model=model,
        train_loader=train_dl,
        eval_loader=val_dl,
        test_loader=test_dl,
        config=config,
        eid=args.eid,
        dataset_split_dict=split,
        log_dir=args.log_dir,
        device=device,
    )


def _build_multisession(args, config, log, device):
    if args.eid == "all":
        eids = [line.strip() for line in Path("data/eid.txt").read_text()
                .splitlines() if line.strip()]
    else:
        eids = [e for e in args.eid.split(",") if e]
    log.info(f"multi-session training over {len(eids)} sessions")
    trainer = MultiSessionTrainer(
        model=None, config=config, eids=eids,
        data_dir=config.dirs.data_dir, log_dir=args.log_dir,
        seed=config.seed, device=device)
    # size the model from the probed sessions, then build it
    model_cfg = dict(config.model)
    model_cfg["n_sessions"] = len(eids)
    model_cfg["max_neurons"] = trainer.max_neurons
    model_ctor = NAME2MODEL[config.model.get("model_class",
                                             "VideoTransformer")]
    trainer.model = model_ctor.from_config(model_cfg, device=device)
    return trainer


def main(argv=None):
    args = get_args(argv)
    setup_runtime(args.device)
    trainer = build_trainer(args)
    if args.resume:
        trainer.resume()
    return trainer.train()


if __name__ == "__main__":
    main()
