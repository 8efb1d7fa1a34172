"""Optical-flow sanity demo: per-trial dense flow -> side-by-side GIF.

Counterpart of ``video_spike_tpu/cli/cal_of.py`` (reference
``src/preprocess/cal_of.py:10-46``), plus ``--device``:

    python -m video_spike_torch.cli.cal_of --data_dir <shards> --eid <eid> \
        [--trial 0] [--modality whisker-video] [--out of_demo.gif] \
        [--device cuda|cpu]

Loads one trial's video from the dataset, computes Farneback flow per
frame pair (on the card unless ``--device cpu``), and writes a GIF pairing
the raw frames with a flow-magnitude heatmap (imageio, imported when the
GIF is written). Returns the flow features.
"""

from __future__ import annotations

import argparse

import numpy as np

from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.runtime import setup_runtime
from video_spike_torch.data.dataset import SessionDataset, split_dataset
from video_spike_torch.ops.flow import get_optic_flow
from video_spike_torch.viz.embeddings import (float32_to_uint8,
                                              save_numpy_video_to_gif)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--eid", type=str, required=True)
    parser.add_argument("--trial", type=int, default=0)
    parser.add_argument("--modality", type=str, default="whisker-video")
    parser.add_argument("--out", type=str, default="of_demo.gif")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    setup_runtime(args.device)
    device = resolve_device(args.device)

    split = split_dataset(args.data_dir, eid=args.eid, seed=0)
    files = sorted(split["train"] + split["val"] + split["test"])
    ds = SessionDataset(files[args.trial:args.trial + 1], batch_size=1)
    batch = next(iter(ds))
    video = np.asarray(batch[args.modality])[0, :, 0]  # (T, H, W)

    feats = get_optic_flow(video, device=device)
    heat = np.abs(feats["of-video"]).sum(-1)           # (T-1, H, W)
    heat = float32_to_uint8(heat)
    raw = float32_to_uint8(video[:-1])
    side_by_side = np.concatenate([raw, heat], axis=2)  # (T-1, H, 2W)
    save_numpy_video_to_gif(side_by_side, args.out, fps=15)
    print(f"wrote {args.out}; of trace head: "
          f"{np.round(feats['of'][:5], 3).tolist()}")
    return feats


if __name__ == "__main__":
    main()
