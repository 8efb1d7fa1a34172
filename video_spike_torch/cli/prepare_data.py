"""Offline ETL: raw session -> per-trial WebDataset-layout tar shards.

Counterpart of ``video_spike_tpu/cli/prepare_data.py`` (reference
``src/prepare_data.py:29-237``), plus ``--device``:

    python -m video_spike_torch.cli.prepare_data --eid <eid> \
        --base_path <out_dir> [--source one | --raw_npz <raw_session.npz>] \
        [--device cuda|cpu] [--flow_backend torch|cv2]

Pipeline per session: load spikes + behaviors + trials (+ camera video +
DLC), bin spikes into 2 s x 20 ms trial rasters, filter inactive neurons
(mean rate <= 2 Hz), interpolate behaviors at 60 Hz, align + min-max
normalize, compute the whisker-pad ROI from DLC nose/pupil midpoints, run
dense optical flow over the whisker crop (every frame pair of a trial in
one batch, on the card unless ``--device cpu``), and write one tar per
trial with keys ``ap / choice / block / wheel-speed /
whisker-motion-energy / whisker-of / whisker-of-2d / whisker-of-video /
timestamp`` plus ``video`` and ``whisker-video``: the same shard names,
keys, dtypes and ``meta`` as the JAX package.

``--source one`` runs the ONE-api orchestration
(:mod:`video_spike_torch.data.one_ingest`), which needs ibllib at the
network edge; ``--raw_npz`` reads the synthetic raw-session format of
:func:`video_spike_torch.data.synthetic.make_raw_session`. Sessions come
from ``--eid``, ``data/eid.txt``, or a ``--datasets brain-wide-map`` draw
over ``data/bwm_release.csv``. ``--video_format mp4`` encodes with cv2;
where cv2 is missing (the H100 machine), write ``npy``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.data.ibl import (
    active_neuron_mask,
    align_spike_behavior,
    bin_spikes,
    interp_behavior,
    whisker_pad_roi_from_dlc,
)
from video_spike_torch.data.tar_io import write_trial_tar
from video_spike_torch.ops.flow import get_optic_flow

INTERVAL_LEN = 2.0     # seconds per trial (reference prepare_data.py:67-74)
BINSIZE = 0.02         # 20 ms spike bins
FREQ = 60              # behavior/video rate


def select_bwm_eids(csv_path: str | Path = "data/bwm_release.csv",
                    n_sessions: int = 6, seed: int = 42) -> list:
    """One session per randomly drawn subject from the brain-wide-map freeze
    manifest (parity with reference ``src/prepare_data.py:55-61``)."""
    import pandas as pd
    np.random.seed(seed)
    bwm_df = pd.read_csv(csv_path, index_col=0)
    subjects = np.unique(bwm_df.subject)
    selected = np.random.choice(subjects, n_sessions, replace=False)
    by_subject = bwm_df.groupby("subject")
    return [bwm_df.eid[by_subject.groups[sub][0]] for sub in selected]


def select_eids(args) -> list:
    """Session list for ingestion: explicit --eid, the BWM manifest draw, or
    the first n_sessions of data/eid.txt (``prepare_data.py:52-64``)."""
    if args.eid:
        return [args.eid]
    if args.datasets == "brain-wide-map":
        return select_bwm_eids(n_sessions=args.n_sessions, seed=args.seed)
    eids = [l.strip() for l in Path("data/eid.txt").read_text().splitlines()
            if l.strip()]
    return eids[:args.n_sessions]


def etl_session(raw: dict, out_dir: str | Path, eid: str,
                store_video_as: str = "npy", min_rate_hz: float = 2.0,
                flow_backend: str = "torch", device=None) -> list:
    """Run the full ETL on an in-memory raw session dict; returns the shard
    list. The flow runs on ``device`` (the card unless the caller asks for
    the CPU)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    trial_starts = np.asarray(raw["trial_starts"])
    intervals = np.c_[trial_starts, trial_starts + INTERVAL_LEN]

    # --- spikes ---------------------------------------------------------
    clusters = np.asarray(raw["spike_clusters"])
    uniq, dense = np.unique(clusters, return_inverse=True)
    binned = bin_spikes(raw["spike_times"], dense, intervals,
                        binsize=BINSIZE, interval_len=INTERVAL_LEN,
                        n_clusters=len(uniq))          # (K, N, T)
    keep_neurons = active_neuron_mask(binned, INTERVAL_LEN, min_rate_hz)
    binned = binned[:, keep_neurons]

    # --- behaviors ------------------------------------------------------
    behaviors = {}
    _, wheel_vals, _ = interp_behavior(raw["wheel_times"],
                                       raw["wheel_speed"], intervals, FREQ)
    behaviors["wheel-speed"] = wheel_vals
    _, me_vals, _ = interp_behavior(raw["me_times"],
                                    raw["whisker_motion_energy"],
                                    intervals, FREQ)
    behaviors["whisker-motion-energy"] = me_vals
    beh_names = list(behaviors.keys())

    spikes, behaviors, keep_trials, _ = align_spike_behavior(
        binned, behaviors, beh_names)
    kept_idx = np.where(keep_trials)[0]

    # --- whisker ROI ----------------------------------------------------
    dlc = {k[len("dlc_"):]: np.asarray(v) for k, v in raw.items()
           if k.startswith("dlc_")}
    roi, mask = whisker_pad_roi_from_dlc(dlc)

    # --- per-trial video + flow + shard ---------------------------------
    video = np.asarray(raw["video"])                   # (F, H, W) uint8
    cam_times = np.asarray(raw["cam_times"])
    files = []
    for out_k, k in enumerate(kept_idx):
        t_beg, t_end = intervals[k]
        f0 = int(np.searchsorted(cam_times, t_beg, side="left"))
        trial_video = video[f0:f0 + int(FREQ * INTERVAL_LEN)]
        whisker_video = trial_video[:, mask[0], mask[1]]
        flow = get_optic_flow(whisker_video.astype(np.float32),
                              backend=flow_backend, device=device)
        timestamp = cam_times[f0:f0 + int(FREQ * INTERVAL_LEN)]

        # whisker-of: [clipped-mean-|flow|, x-med, y-med] summary
        of_summary = np.stack([flow["of"], flow["of-2d"][:, 0],
                               flow["of-2d"][:, 1]], axis=1)

        key = f"{eid}_{out_k}"
        path = out_dir / f"{key}.tar"
        write_trial_tar(
            path, key,
            arrays={
                "ap": spikes[out_k].T.astype(np.float32),  # (T_bins, N)
                "choice": np.asarray([raw["trial_choice"][k]], np.float32),
                "block": np.asarray([raw["trial_block"][k]], np.float32),
                "wheel-speed": behaviors["wheel-speed"][out_k]
                    .astype(np.float32),
                "whisker-motion-energy":
                    behaviors["whisker-motion-energy"][out_k]
                    .astype(np.float32),
                "whisker-of": of_summary.astype(np.float32),
                "whisker-of-2d": flow["of-2d"].astype(np.float32),
                "whisker-of-video": flow["of-video"].astype(np.float32),
                "timestamp": timestamp.astype(np.float64),
            },
            videos={"video": trial_video.astype(np.uint8),
                    "whisker-video": whisker_video.astype(np.uint8)},
            meta={"eid": eid, "trial": int(k),
                  "n_neurons": int(spikes.shape[1]),
                  "whisker_roi": roi.tolist()},
            store_video_as=store_video_as,
        )
        files.append(str(path))
    return files


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--eid", type=str, default=None,
                        help="one session; omit to draw from --datasets")
    parser.add_argument("--base_path", type=str, required=True,
                        help="output directory for trial tars")
    parser.add_argument("--source", type=str, default="local",
                        choices=["local", "one"])
    parser.add_argument("--datasets", type=str, default="reproducible-ephys",
                        choices=["reproducible-ephys", "brain-wide-map"])
    parser.add_argument("--n_sessions", type=int, default=6)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--raw_npz", type=str, default=None,
                        help="raw session npz (local mode)")
    parser.add_argument("--video_format", type=str, default="npy",
                        choices=["npy", "mp4"],
                        help="mp4 needs cv2 (the H100 machine has none: "
                             "use npy there)")
    parser.add_argument("--min_rate_hz", type=float, default=2.0)
    parser.add_argument("--flow_backend", type=str, default="torch",
                        choices=["torch", "cv2", "jax"],
                        help="torch: batched Farneback on --device; cv2: "
                             "OpenCV on the host; jax: the JAX package's "
                             "name, run as torch")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the torch flow (cuda or cpu)")
    args = parser.parse_args(argv)
    setup_runtime(args.device)
    backend = "torch" if args.flow_backend == "jax" else args.flow_backend
    device = resolve_device(args.device)

    if args.source == "one":
        # the ONE orchestration; its only network edges are ONE
        # construction and the ibllib providers
        from video_spike_torch.data.ibl import load_one_session
        from video_spike_torch.data.one_ingest import ingest_one_session
        eids = select_eids(args)
        one = load_one_session(eids[0])
        files = []
        for eid in eids:
            print(f"Preprocess session {eid}:")
            files += ingest_one_session(
                one, eid, args.base_path,
                store_video_as=args.video_format,
                flow_backend=backend, device=device)
        print(f"wrote {len(files)} trial shards to {args.base_path}")
        return files

    if not (args.eid and args.raw_npz):
        parser.error("--eid and --raw_npz are required in local mode")
    raw = dict(np.load(args.raw_npz, allow_pickle=True))
    files = etl_session(raw, args.base_path, args.eid,
                        store_video_as=args.video_format,
                        min_rate_hz=args.min_rate_hz,
                        flow_backend=backend, device=device)
    print(f"wrote {len(files)} trial shards to {args.base_path}")
    return files


if __name__ == "__main__":
    run_rank(main)
