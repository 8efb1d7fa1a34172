"""Aggregate test_results.npy files and draw the per-modality bps boxplot.

Counterpart of ``video_spike_tpu/cli/visualize_result.py`` (reference
``src/visualize_result.py`` + ``get_log``/``draw_results``,
``src/utils/utils.py:183-224``):

    python -m video_spike_torch.cli.visualize_result --log_dir results

walks ``--log_dir`` for ``test_results.npy`` artifacts laid out as
``<log_dir>/<eid5>/<mods>/<Model>/test_results.npy`` and writes ``bps.png``
into the working directory. Needs pandas and matplotlib (imported here,
not at module load: the card's machine has neither).
"""

from __future__ import annotations

import os

import numpy as np

from video_spike_torch.core.cli import get_args


def get_log(log_dir: str):
    """A pandas frame, one row per ``test_results.npy`` (its ``test_res``
    plus ``eid`` and ``mod`` from the path), indexed by the file."""
    import pandas as pd

    rows = {}
    for root, _dirs, files in os.walk(log_dir):
        for file in files:
            if not file.endswith(".npy"):
                continue
            path = os.path.join(root, file)
            data = np.load(path, allow_pickle=True).item()
            if "test_res" not in data:
                continue
            rel = os.path.relpath(path, log_dir).split(os.sep)
            row = dict(data["test_res"])
            row["eid"] = rel[0] if len(rel) > 2 else "?"
            row["mod"] = rel[1] if len(rel) > 2 else "?"
            rows[path] = row
    return pd.DataFrame(rows).T


def main(argv=None):
    from video_spike_torch.viz.plots import draw_results_boxplot

    args = get_args(argv)
    df = get_log(args.log_dir)
    if df.empty:
        print(f"no test_results.npy under {args.log_dir}")
        return None
    fig = draw_results_boxplot(df, metric="test_bps")
    fig.savefig("bps.png")
    print("saved bps.png")
    return df


if __name__ == "__main__":
    main()
