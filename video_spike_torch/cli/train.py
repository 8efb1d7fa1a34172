"""Supervised end-to-end training entry point (single session).

CLI parity with the reference's ``src/train.py:24-107`` (the ``train.sh``
path) and with ``video_spike_tpu/cli/train.py``, plus ``--device``:

    python -m video_spike_torch.cli.train \
        --model_config configs/model/linear_video.yaml \
        --train_config configs/train/linear_video.yaml \
        --eid <eid> [--data_dir ...] [--num_epochs N] [--device cuda|cpu]

Flow: config merge -> seed -> 80/10/10 trial split -> loaders -> metadata
probe -> model from registry on the device -> optimizer + OneCycle ->
Poisson NLL -> trainer. Runs on ``cuda`` unless ``--device cpu`` is given;
asking for ``cuda`` without a card raises.
"""

from __future__ import annotations

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.core.rng import set_seed
from video_spike_torch.data.dataset import (
    get_metadata_from_loader,
    make_loader,
    split_dataset,
)
from video_spike_torch.train.base import BaseTrainer


def build_trainer(args):
    """Config, data, model and trainer for one session, from parsed args."""
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

    if args.eid == "all" or "," in args.eid:
        raise NotImplementedError(
            "multi-session training (--eid all or a comma list) is not "
            "ported yet; see ROADMAP.md Queue A item 8 (VTT flagship)")
    set_seed(config.seed)

    split = split_dataset(config.dirs.data_dir, eid=args.eid,
                          seed=config.seed)
    if not split["train"]:
        raise SystemExit(
            f"no trial tars for eid {args.eid} in {config.dirs.data_dir}")
    train_dl, val_dl, test_dl = make_loader(config, split)
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


def main(argv=None):
    args = get_args(argv)
    trainer = build_trainer(args)
    if args.resume:
        trainer.resume()
    return trainer.train()


if __name__ == "__main__":
    main()
