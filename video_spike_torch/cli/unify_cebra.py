"""Merge per-eid cached embedding files into one multi-session file.

A copy of ``video_spike_tpu/cli/unify_cebra.py`` (reference
``src/unify_cebra.py``): collects ``data/data_rrr_<label>_*.npy`` and writes
``data/data_rrr_<label>.npy``, which ``cli.train_rrr --input_mod <label>``
reads.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", type=str, default="cebra")
    parser.add_argument("--data_dir", type=str, default="data")
    args = parser.parse_args(argv)

    files = [f for f in os.listdir(args.data_dir)
             if f.startswith(f"data_rrr_{args.label}_")]
    print(files)
    merged = {}
    for f in files:
        data = np.load(os.path.join(args.data_dir, f),
                       allow_pickle=True).item()
        merged.update(data)
    out = os.path.join(args.data_dir, f"data_rrr_{args.label}.npy")
    np.save(out, merged)
    print(f"saved {out} ({len(merged)} sessions)")
    return out


if __name__ == "__main__":
    main()
