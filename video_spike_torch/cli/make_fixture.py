"""Write a synthetic IBL-like session fixture (trial tar shards).

Replaces the ONE-API download path for development/testing:

    python -m video_spike_torch.cli.make_fixture --out fixture_dir \
        --eid testeid000 --n_trials 30 --n_neurons 48
"""

from __future__ import annotations

import argparse

from video_spike_torch.data.synthetic import make_synthetic_session


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--eid", type=str, default="testeid000")
    p.add_argument("--n_trials", type=int, default=30)
    p.add_argument("--n_neurons", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--video_format", type=str, default="npy",
                   choices=["npy", "mp4"])
    args = p.parse_args(argv)
    files = make_synthetic_session(
        args.out, eid=args.eid, n_trials=args.n_trials,
        n_neurons=args.n_neurons, seed=args.seed,
        store_video_as=args.video_format,
        height=args.height, width=args.width)
    print(f"wrote {len(files)} trial shards to {args.out}")


if __name__ == "__main__":
    main()
