"""Masked-video pretraining of the VideoMAE backbone on trial videos.

Counterpart of ``video_spike_tpu/cli/pretrain_videomae.py``, plus
``--device``. The probe's frozen backbone has to come from somewhere when no
released weights are on disk, so this pretrains ``VideoMAEForPreTraining``
on the session's own videos and writes ``backbone.pt``, which the probe
loads through ``model.pretrained_backbone`` (with ``model.hf_compat:
false``):

    python -m video_spike_torch.cli.pretrain_videomae \
        --model_config configs/model/videomae/videomae.yaml \
        --train_config configs/train/vmae_video.yaml \
        --eid <eid> --data_dir ... [--max_steps N] [--mask_ratio 0.9] \
        [--video_mod video] [--device cuda|cpu]

The loader's trials are cut to the model's 16 frames on the host; the
frames go through the probe's own ``preprocess_frames`` on the device, so
the encoder sees the probe's input distribution. The optimizer is AdamW
(optax semantics) at the yaml's constant ``lr`` and ``wd``; each step's
masking noise comes from a generator seeded from (seed, step).
``backbone.pt`` (``{"params": {name: tensor}}``) goes to
``<log_dir>/<eid[:5]>/VideoMAEPretrain/``. ``main`` returns a dict: its
``path``, ``n_params`` and the per-step ``losses``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.data.dataset import make_loader, split_dataset
from video_spike_torch.models.videomae import (
    VideoMAEForPreTraining,
    preprocess_frames,
)
from video_spike_torch.ops.optim import AdamW, apply_updates
from video_spike_torch.train.checkpoint import save_checkpoint

_MASK63 = (1 << 63) - 1


def make_step(model, tx, num_frames: int, image_size: int,
              mask_ratio: float):
    """``step(params, opt_state, video, generator) -> (params, opt_state,
    loss)``: preprocess, masked reconstruction loss, one optimizer step."""

    def step(params, opt_state, video, generator):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        x = preprocess_frames(video, num_frames, image_size,
                              source_frames=video.shape[1])
        out = torch.func.functional_call(
            model, leaves, (x,),
            {"mask_ratio": mask_ratio, "generator": generator})
        loss = out["recon_loss"]
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        with torch.no_grad():
            # a leaf the loss does not reach (mask_token at ratio 0) has a
            # zero gradient under jax.grad
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(names, grads)}
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return step


def main(argv=None):
    log = make_logger(header="[vmae-pretrain]")
    args, extra = _parse(argv)
    setup_runtime(args.device)
    device = resolve_device(args.device)
    config = config_from_kwargs({"model": f"include:{args.model_config}"})
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30)
    config["seed"] = args.seed
    if args.data_dir:
        config["dirs"]["data_dir"] = args.data_dir
    set_seed(config.seed)

    split = split_dataset(config.dirs.data_dir, eid=args.eid,
                          seed=config.seed)
    if not split["train"]:
        raise SystemExit(f"no trial tars for eid {args.eid} "
                         f"in {config.dirs.data_dir}")
    if args.batch_size is not None:
        config["training"]["train_batch_size"] = args.batch_size
    train_dl, _, _ = make_loader(config, split)

    mcfg = {k: v for k, v in dict(config.model).items()
            if k not in ("encoder", "decoder")}
    model = VideoMAEForPreTraining.from_config(mcfg, device=device)
    model.reset_parameters(
        torch.Generator(device=device).manual_seed(config.seed))
    num_frames = mcfg.get("num_frames", 16)
    image_size = mcfg.get("image_size", 224)
    max_steps = args.max_steps or 2000
    tx = AdamW(config.optimizer.get("lr", 1e-4),
               weight_decay=config.optimizer.get("wd", 0.01))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_state = tx.init(params)
    n_params = sum(p.numel() for p in params.values())
    log.info(f"VideoMAEForPreTraining: {n_params/1e6:.1f}M params, "
             f"mask_ratio={extra.mask_ratio}, max_steps={max_steps}, "
             f"device={device}")
    step_fn = make_step(model, tx, num_frames, image_size, extra.mask_ratio)
    mask_gen = torch.Generator(device=device)

    step, losses, sub_idx = 0, [], None
    while step < max_steps:
        for batch in train_dl:
            raw = np.asarray(batch[extra.video_mod])
            if sub_idx is None:
                # the 16-of-120 subsample on the host (the indices
                # preprocess_frames would take on the device), so only the
                # frames kept cross to the card
                sub_idx = (np.linspace(0, 1, num_frames)
                           * (raw.shape[1] - 1)).astype(int)
            video = torch.from_numpy(
                np.ascontiguousarray(raw[:, sub_idx])).to(device)
            mask_gen.manual_seed(
                (config.seed * 0x9E3779B97F4A7C15 + step) & _MASK63)
            params, opt_state, loss = step_fn(params, opt_state, video,
                                              mask_gen)
            losses.append(loss)   # a device scalar; fetched at log cadence
            if step % 50 == 0:
                log.info({"step": step, "recon_loss": float(loss)})
            step += 1
            if step >= max_steps:
                break

    out_dir = os.path.join(args.log_dir, args.eid[:5], "VideoMAEPretrain")
    path = save_checkpoint(out_dir, "backbone", {"params": params})
    losses = torch.stack(losses).float().cpu().tolist()
    log.info(f"saved backbone checkpoint to {path} (final recon_loss "
             f"{np.mean(losses[-20:]):.4f}); point model.pretrained_backbone "
             f"at it with model.hf_compat: false")
    return {"path": path, "n_params": n_params, "losses": losses}


def _parse(argv):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--mask_ratio", type=float, default=0.9)
    parser.add_argument("--video_mod", type=str, default="video",
                        help="which video modality to pretrain on "
                             "(video | whisker-video)")
    extra, rest = parser.parse_known_args(argv)
    return get_args(rest), extra


if __name__ == "__main__":
    run_rank(main)
