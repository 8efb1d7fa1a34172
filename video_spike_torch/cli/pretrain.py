"""SSL pretraining of MAE / ContrastViT / ContrastViTMAE on whisker frames.

Counterpart of ``video_spike_tpu/cli/pretrain.py`` (reference
``src/pretrain.py:39-210``), plus ``--device``:

    python -m video_spike_torch.cli.pretrain --model cm \
        --model_config configs/model/vit_mae/vit_mae.yaml \
        --train_config configs/train/vmae_video.yaml --eid <eid> \
        [--h5_path data/data_rrr_whisker-video.h5] [--max_steps 40000] \
        [--validate_every N] [--resume] [--device cuda|cpu]

Flow: contrast loaders (pretrain triplets; per-trial train/val loaders),
the model from the registry via the short-name map (c/cm/m) on the device,
AdamW with the yaml's constant lr, the step-based fit with nested-RRR
validation, then embed train + test with the best checkpoint and save
``data/data_rrr_<model>_<eid5>.npy`` (rank 0 alone under a process
group).

One addition to the JAX package's interface: ``main(argv, data=...)`` takes
the split dict of ``cli/create_eid_data.split_dict`` in place of the h5 (for
a machine without ``h5py``). ``main`` returns a dict: the artifact's
``path`` and the run's ``n_params``, ``train_losses``, ``val_history``,
``best_bps``, ``start_step``, ``steps`` and ``log_dir``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.data.contrast import make_contrast_loader
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.train.contrast import make_contrast_trainer

MODEL_SHORTNAMES = {"c": "ContrastViT", "cm": "ContrastViTMAE", "m": "MAE"}


def build_trainer(argv=None, data=None, log=None,
                  h5_path: str | None = None):
    """(args, trainer, train loader, loader kwargs) as ``main`` builds them;
    ``data`` is the split dict, or None for the h5 at `h5_path` (default
    ``--h5_path``)."""
    log = log or make_logger(header="[pretrain]")
    args, extra = _parse(argv)
    setup_runtime(args.device)
    device = resolve_device(args.device)
    config = config_from_kwargs({"model": f"include:{args.model_config}"})
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30)
    config["seed"] = args.seed
    set_seed(config.seed)

    source = data if data is not None else (h5_path or extra.h5_path)
    image_size = config.model.get("image_size", 144)
    batch_size = (args.batch_size
                  or config.training.get("train_batch_size", 128))
    max_steps = args.max_steps or 40000

    common = dict(eid=args.eid, idx_offset=3, image_size=image_size,
                  seed=config.seed)
    pretrain_dl, _ = make_contrast_loader(source, mode="pretrain",
                                          batch_size=batch_size,
                                          shuffle=True, **common)
    val_dl, _ = make_contrast_loader(source, mode="val", batch_size=1,
                                     shuffle=False, **common)
    train_dl, _ = make_contrast_loader(source, mode="train", batch_size=1,
                                       shuffle=False, **common)

    model_name = MODEL_SHORTNAMES.get(args.model, args.model)
    model = NAME2MODEL[model_name].from_config(config.model, device=device)
    log.info(f"Model: {model_name}, Max steps: {max_steps}, "
             f"Batch: {batch_size}, EID: {args.eid}, device: {device}")

    trainer = make_contrast_trainer(
        model=model,
        data_loader=pretrain_dl,
        optimizer_config=dict(config.optimizer),
        val_data_loader=val_dl,
        train_data_loader=train_dl,
        max_steps=max_steps,
        eid=args.eid,
        log_dir=args.log_dir,
        image_size=image_size,
        seed=config.seed,
        log=log,
        validate_every=extra.validate_every,
        # device frame-cache cap (GB); datasets over it stream per batch
        frame_cache_gb=float(config.training.get("frame_cache_gb", 2.0)),
        # mid-run durability: periodic last_model saves + an immediate
        # best_model write when validation finds a new best
        save_every_steps=config.training.get("save_every_steps", None),
        save_every_min=config.training.get("save_every_min", 10.0),
        flush_best=bool(config.training.get("flush_best", True)),
        device=device,
    )
    return args, trainer, train_dl, dict(source=source, **common)


def main(argv=None, h5_path: str | None = None, data=None):
    log = make_logger(header="[pretrain]")
    log.info("Pretraining!")
    args, trainer, train_dl, loader_kw = build_trainer(argv, data, log,
                                                       h5_path)
    if args.resume:
        trainer.resume()
    trainer.fit()

    source = loader_kw.pop("source")
    test_dl, _ = make_contrast_loader(source, mode="test", batch_size=1,
                                      shuffle=False, **loader_kw)
    train_emb, train_neural = trainer.transform(train_dl, return_neural=True,
                                                use_best=True)
    test_emb, test_neural = trainer.transform(test_dl, return_neural=True,
                                              use_best=True)
    train_n, test_n = train_neural.shape[0], test_neural.shape[0]
    e_dim = train_emb.shape[-1]
    train_emb = train_emb.reshape(train_n, -1, e_dim)
    test_emb = test_emb.reshape(test_n, -1, e_dim)
    log.info(f"Embeddings: train {train_emb.shape}, test {test_emb.shape}")

    out = {args.eid: {"X": [train_emb, test_emb],
                      "y": [train_neural, test_neural],
                      "setup": {}}}
    path = f"data/data_rrr_{args.model}_{args.eid[:5]}.npy"
    # every rank embeds (the transform is collective); rank 0 alone writes
    # the artifact: concurrent writers to one .npy can tear it
    if mh.process_index() == 0:
        os.makedirs("data", exist_ok=True)
        np.save(path, out)
        log.info(f"saved {path}")
    return {"path": path, "n_params": trainer.n_params,
            "train_losses": list(trainer.train_losses),
            "val_history": list(trainer.val_history),
            "best_bps": trainer._best_bps,
            "start_step": trainer._start_step,
            "steps": len(trainer.train_losses),
            "log_dir": trainer.log_dir}


def _parse(argv):
    # extend the shared surface with the h5 feature-cache path
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--h5_path", type=str,
                        default="data/data_rrr_whisker-video.h5")
    parser.add_argument("--validate_every", type=int, default=None,
                        help="validation cadence in steps (default: every "
                             "pass over the pretrain loader)")
    extra, rest = parser.parse_known_args(argv)
    return get_args(rest), extra


if __name__ == "__main__":
    run_rank(main)
