"""Multi-session SSL evaluation: embed with the best checkpoint, fit RRR on
the embeddings, report per-eid and mean bps.

Counterpart of ``video_spike_tpu/cli/test.py`` (reference
``src/test.py:43-246``), plus ``--device``:

    python -m video_spike_torch.cli.test --model cm --eid <eid> \
        --model_config ... --train_config ... [--device cuda|cpu]

Loops the eids in ``data/eid.txt`` (or just ``--eid``), loads each
session's ``best_model.pt`` from ``log_dir/<eid>/<Model>/40000`` (no fit),
embeds train/test at mask ratio 0, fits RRR on the embeddings (the 120
frame steps subsampled to the 100 spike bins with the global numpy stream
that ``set_seed`` seeds) and prints per-eid and mean bps. Returns the
per-eid bps list.

``--save_plot`` writes, under ``--plot_dir`` (default ``.``), the train
embedding (``<model>_<eid5>_embed.png``), the first test trial's
(``test_embed_<model>_<eid5>.png``), and for the first 5 test trials the
raw video and the embedding trajectory as GIFs
(``test_<model>_<eid5>_<i>.gif``, ``test_embed_<model>_<eid5>_<i>.gif``),
from the full 120-step embeddings; it needs matplotlib and imageio and
raises naming matplotlib before any work when it is missing. As in
``cli/pretrain.py``, ``main(argv, data=...)`` takes the split dict of
``cli/create_eid_data.split_dict`` in place of the h5.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from video_spike_torch.cli.pretrain import MODEL_SHORTNAMES
from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.data.contrast import make_contrast_loader
from video_spike_torch.train.contrast import make_contrast_trainer
from video_spike_torch.train.rrr_pipeline import train_rrr


def main(argv=None, data=None):
    log = make_logger(header="[test]")
    log.info("Testing!")
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--h5_path", type=str,
                        default="data/data_rrr_whisker-video.h5")
    # where --save_plot would write (the reference writes into the CWD,
    # src/test.py:187-236)
    parser.add_argument("--plot_dir", type=str, default=".")
    extra, rest = parser.parse_known_args(argv)
    args = get_args(rest)
    setup_runtime(args.device)
    if args.save_plot:
        from video_spike_torch.viz import pyplot

        pyplot()   # no matplotlib: fail now, not after the embedding
    device = resolve_device(args.device)
    config = config_from_kwargs({"model": f"include:{args.model_config}"})
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30)
    config["seed"] = args.seed
    set_seed(config.seed)

    eid_file = Path("data/eid.txt")
    eids = ([l.strip() for l in eid_file.read_text().splitlines() if l.strip()]
            if eid_file.exists() else [args.eid])

    source = data if data is not None else extra.h5_path
    image_size = config.model.get("image_size", 144)
    model_name = MODEL_SHORTNAMES.get(args.model, args.model)

    test_bps = []
    for eid in eids:
        common = dict(eid=eid, idx_offset=3, image_size=image_size,
                      seed=config.seed)
        train_dl, _ = make_contrast_loader(source, mode="train",
                                           batch_size=1, shuffle=False,
                                           **common)
        test_dl, _ = make_contrast_loader(source, mode="test",
                                          batch_size=1, shuffle=False,
                                          **common)
        model = NAME2MODEL[model_name].from_config(config.model,
                                                   device=device)
        trainer = make_contrast_trainer(
            model=model, data_loader=train_dl,
            optimizer_config=dict(config.optimizer),
            max_steps=40000, eid=eid, log_dir=args.log_dir,
            image_size=image_size, seed=config.seed, log=log, device=device)

        train_emb, train_y = trainer.transform(train_dl, return_neural=True,
                                               use_best=True)
        test_emb, test_y = trainer.transform(test_dl, return_neural=True,
                                             use_best=True)
        e_dim = train_emb.shape[-1]
        train_emb = train_emb.reshape(train_y.shape[0], -1, e_dim)
        test_emb = test_emb.reshape(test_y.shape[0], -1, e_dim)
        # subsample the 120 frame steps down to the 100 spike bins for the
        # RRR fit only; the figures use the full trajectories
        t_frames, t_bins = train_emb.shape[1], train_y.shape[1]
        if t_frames > t_bins:
            idx = np.sort(np.random.choice(t_frames - 1, t_bins,
                                           replace=False))
            train_emb_rrr, test_emb_rrr = train_emb[:, idx], test_emb[:, idx]
        else:
            train_emb_rrr, test_emb_rrr = train_emb, test_emb

        data_dict = {eid: {"X": [train_emb_rrr, test_emb_rrr],
                           "y": [train_y, test_y], "setup": {}}}
        result = train_rrr(data_dict, device=device)
        bps = float(np.nanmean(result[eid]["bps"]))
        log.info(f"eid {eid[:5]}: bps={bps:.5f}")
        test_bps.append(bps)
        if args.save_plot:
            _save_plots(Path(extra.plot_dir), args.model, eid, train_emb,
                        test_emb, test_dl)

    log.info(f"per-eid bps: {[round(b, 5) for b in test_bps]}")
    log.info(f"mean bps: {np.mean(test_bps):.5f}")
    return test_bps


def _save_plots(out_dir: Path, model: str, eid: str, train_emb: np.ndarray,
                test_emb: np.ndarray, test_dl) -> None:
    """The JAX CLI's ``--save_plot`` files (reference ``src/test.py:186-
    239``): two embedding PNGs, then a raw-video GIF and an embedding-
    trajectory GIF for each of the first 5 test trials."""
    from video_spike_torch.viz import pyplot
    from video_spike_torch.viz.embeddings import (
        plot_embeddings, plot_embeddings_anim, save_numpy_video_to_gif)

    plt = pyplot()
    e_dim = train_emb.shape[-1]
    out_dir.mkdir(parents=True, exist_ok=True)
    fig = plot_embeddings(train_emb.reshape(-1, e_dim))
    fig.savefig(out_dir / f"{model}_{eid[:5]}_embed.png")
    plt.close(fig)
    fig = plot_embeddings(test_emb[0], title=f"{model}_{eid[:5]}_embed_test")
    fig.savefig(out_dir / f"test_embed_{model}_{eid[:5]}.png")
    plt.close(fig)
    for idx, batch in enumerate(test_dl):
        video = np.asarray(batch["ref"])
        if video.ndim == 5:   # (1, T, C, H, W) batch of one trial
            video = video[0]
        save_numpy_video_to_gif(
            video, str(out_dir / f"test_{model}_{eid[:5]}_{idx}.gif"), fps=10)
        plot_embeddings_anim(
            test_emb[idx],
            str(out_dir / f"test_embed_{model}_{eid[:5]}_{idx}.gif"), fps=10)
        if idx > 3:
            break


if __name__ == "__main__":
    run_rank(main)
