"""Cross-modality raster comparison figures.

Counterpart of the repo-root ``plot_raster.py`` (reference
``plot_raster.py``), with the same argv and files:

    python -m video_spike_torch.cli.plot_raster --ref_mod me --input_mod of-2d

loads ``<mod>_result.npy`` artifacts produced by ``cli.train_rrr``, plus the
``data/data_rrr_all.npy`` covariates for choice/block trial grouping when
present, and writes ``<eid5>_scatter.png`` and ``<eid5>_raster_plot.png``
per session into the working directory. Needs matplotlib.
"""

from __future__ import annotations

import argparse

import numpy as np

from video_spike_torch.viz.raster import raster_grid, scatter_compare


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_mod", type=str, default="me")
    parser.add_argument("--input_mod", type=str, default="of-2d")
    parser.add_argument("--eid_file", type=str, default="data/eid.txt")
    args = parser.parse_args(argv)

    ref_all = np.load(f"{args.ref_mod}_result.npy", allow_pickle=True).item()
    mod_all = np.load(f"{args.input_mod}_result.npy",
                      allow_pickle=True).item()
    try:
        covars = np.load("data/data_rrr_all.npy", allow_pickle=True).item()
    except FileNotFoundError:
        covars = {}

    for eid in ref_all:
        ref_res, mod_res = ref_all[eid], mod_all[eid]
        fig = scatter_compare(ref_res, mod_res, args.ref_mod,
                              args.input_mod, eid)
        fig.savefig(f"{eid[:5]}_scatter.png")

        choice = block = None
        if eid in covars:
            X_test = np.asarray(covars[eid]["X"][1])
            choice, block = X_test[:, 0, -2], X_test[:, 0, -1]
        fig = raster_grid(np.asarray(ref_res["gt"]),
                          {args.ref_mod: np.asarray(ref_res["pred"]),
                           args.input_mod: np.asarray(mod_res["pred"])},
                          choice=choice, block=block, eid=eid)
        fig.savefig(f"{eid[:5]}_raster_plot.png")
        print(f"wrote {eid[:5]}_scatter.png, {eid[:5]}_raster_plot.png")


if __name__ == "__main__":
    main()
