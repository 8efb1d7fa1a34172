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

The loader's trials are cut to the model's 16 frames on the host, on the
producer thread that stages them on the device (``clip_stream``: the
pinned prefetch of ``data/prefetch.py``); the frames go through the
probe's own ``preprocess_frames`` on the device, so the encoder sees the
probe's input distribution. The model yaml's keys reach
``VideoMAEForPreTraining`` as they are, ``mask_type`` (``random`` or
``tube``) and ``norm_pix_loss`` among them. The optimizer is AdamW (optax
semantics) at the yaml's constant ``lr`` and ``wd``; each step's masking
noise comes from a generator seeded from (seed, step) (``mask_seed``).
``main``'s loop is ``clip_stream``, ``make_step`` and ``train_step``, the
functions a benchmark drives too; while a profiler records, each step is
a ``vs.step`` span holding ``ops/step.py``'s.
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
from video_spike_torch.core.spans import span
from video_spike_torch.data.dataset import make_loader, split_dataset
from video_spike_torch.data.prefetch import prefetch_to_device
from video_spike_torch.models.videomae import (
    VideoMAEForPreTraining,
    preprocess_frames,
)
from video_spike_torch.ops import step as ops_step
from video_spike_torch.ops.optim import AdamW
from video_spike_torch.train.checkpoint import save_checkpoint

_MASK63 = (1 << 63) - 1


def frame_indices(source_frames: int, num_frames: int) -> np.ndarray:
    """The ``num_frames`` of a trial's ``source_frames`` that the model
    sees: the indices ``preprocess_frames`` would take on the device."""
    return (np.linspace(0, 1, num_frames)
            * (source_frames - 1)).astype(int)


def clip_batches(loader, video_mod: str, num_frames: int):
    """The loader's batches, epoch after epoch without end, as
    ``{"video": the kept frames}`` on the host: only the frames kept cross
    to the card."""
    idx = None
    while True:
        n = 0
        for batch in loader:
            raw = np.asarray(batch[video_mod])
            if idx is None:
                idx = frame_indices(raw.shape[1], num_frames)
            n += 1
            yield {"video": raw[:, idx]}
        if not n:
            raise ValueError("the loader gave no batch")


def clip_stream(loader, video_mod: str, num_frames: int, device):
    """``clip_batches`` on a producer thread, staged ahead on ``device``;
    the consumer's wait for a batch is the ``producer_wait`` span. Close
    it when done."""
    return prefetch_to_device(clip_batches(loader, video_mod, num_frames),
                              device)


def mask_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s masking generator."""
    return (seed * 0x9E3779B97F4A7C15 + step) & _MASK63


def build(model_config: dict, optimizer_config, seed: int, device):
    """(model, tx, params, opt_state): ``VideoMAEForPreTraining`` from the
    model yaml's keys, initialised from ``seed``, and AdamW at the yaml's
    ``lr`` and ``wd``."""
    model = VideoMAEForPreTraining.from_config(model_config, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    tx = AdamW(optimizer_config.get("lr", 1e-4),
               weight_decay=optimizer_config.get("wd", 0.01))
    params = {k: p.detach() for k, p in model.named_parameters()}
    return model, tx, params, tx.init(params)


def make_step(model, tx, num_frames: int, image_size: int,
              mask_ratio: float):
    """``step(params, opt_state, video, generator) -> (params, opt_state,
    loss)``: preprocess, masked reconstruction loss, one AdamW step into
    new tensors (what it was handed stays as it was)."""

    def step(params, opt_state, video, generator):
        def loss_fn(leaves):
            x = preprocess_frames(video, num_frames, image_size,
                                  source_frames=video.shape[1])
            out = torch.func.functional_call(
                model, leaves, (x,),
                {"mask_ratio": mask_ratio, "generator": generator})
            return out["recon_loss"], None

        params, opt_state, loss, _ = ops_step.train_step(
            loss_fn, params, opt_state, tx, in_place=False)
        return params, opt_state, loss

    return step


def train_step(step_fn, params, opt_state, video, generator, seed: int,
               step: int):
    """Step ``step`` of the loop: its masking seed, then ``step_fn``."""
    with span("step"):
        generator.manual_seed(mask_seed(seed, step))
        return step_fn(params, opt_state, video, generator)


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
    model, tx, params, opt_state = build(mcfg, config.optimizer,
                                         config.seed, device)
    num_frames = mcfg.get("num_frames", 16)
    image_size = mcfg.get("image_size", 224)
    max_steps = args.max_steps or 2000
    n_params = sum(p.numel() for p in params.values())
    log.info(f"VideoMAEForPreTraining: {n_params/1e6:.1f}M params, "
             f"mask_ratio={extra.mask_ratio}, max_steps={max_steps}, "
             f"device={device}")
    step_fn = make_step(model, tx, num_frames, image_size, extra.mask_ratio)
    mask_gen = torch.Generator(device=device)

    losses = []
    stream = clip_stream(train_dl, extra.video_mod, num_frames, device)
    try:
        for step in range(max_steps):
            video = next(stream)["video"]
            params, opt_state, loss = train_step(
                step_fn, params, opt_state, video, mask_gen, config.seed,
                step)
            losses.append(loss)   # a device scalar; fetched at log cadence
            if step % 50 == 0:
                log.info({"step": step, "recon_loss": float(loss)})
    finally:
        stream.close()

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
