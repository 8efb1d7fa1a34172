"""Per-session R²/bps scatter between two modalities.

Counterpart of the repo-root ``plot_scatter.py`` (reference
``plot_scatter.py``), with the same argv and files:

    python -m video_spike_torch.cli.plot_scatter --ref_mod me --input_mod of-2d

reads the eids of ``--eid_file``, loads per-eid
``<eid5>_<mod>_result.npy`` artifacts and writes
``scatter_r2_sessions.png`` and ``scatter_bps_sessions.png`` into the
working directory. Needs matplotlib.
"""

from __future__ import annotations

import argparse

import numpy as np

from video_spike_torch.ops.metrics import bits_per_spike
from video_spike_torch.viz import pyplot
from video_spike_torch.viz.raster import neuronwise_r2


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mod", type=str, default="of-2d")
    parser.add_argument("--ref_mod", type=str, default="me")
    parser.add_argument("--eid_file", type=str, default="data/eid.txt")
    args = parser.parse_args(argv)
    plt = pyplot()

    with open(args.eid_file) as f:
        eids = [l.strip() for l in f if l.strip()]

    n = len(eids)
    fig_r2, axs_r2 = plt.subplots(1, n, figsize=(5 * n, 5), squeeze=False)
    fig_bps, axs_bps = plt.subplots(1, n, figsize=(5 * n, 5), squeeze=False)

    for idx, eid in enumerate(eids):
        ref = np.load(f"{eid[:5]}_{args.ref_mod}_result.npy",
                      allow_pickle=True).item()
        mod = np.load(f"{eid[:5]}_{args.input_mod}_result.npy",
                      allow_pickle=True).item()
        gt = np.asarray(mod["gt"])
        ref_pred, mod_pred = np.asarray(ref["pred"]), np.asarray(mod["pred"])

        # trial-averaged per-neuron R² (reference plot_scatter convention)
        gt_m, ref_m, mod_m = (np.mean(a, axis=0).T
                              for a in (gt, ref_pred, mod_pred))
        ref_r2 = np.array([neuronwise_r2(gt_m[i][None, :, None],
                                         ref_m[i][None, :, None])[0]
                           for i in range(gt_m.shape[0])])
        mod_r2 = np.array([neuronwise_r2(gt_m[i][None, :, None],
                                         mod_m[i][None, :, None])[0]
                           for i in range(gt_m.shape[0])])

        lo, hi = min(ref_r2.min(), mod_r2.min()), max(ref_r2.max(), mod_r2.max())
        ax = axs_r2[0][idx]
        ax.scatter(ref_r2, mod_r2, s=10)
        ax.plot([lo, hi], [lo, hi], color="red")
        ax.set_xlabel(f"{args.ref_mod} R2")
        ax.set_ylabel(f"{args.input_mod} R2")
        ax.set_title(f"{args.ref_mod} ({np.nanmean(ref_r2):.3f}) vs "
                     f"{args.input_mod} ({np.nanmean(mod_r2):.3f})")

        ref_bps = np.asarray(ref.get("co_bps", ref.get("bps")))
        mod_bps = np.asarray(mod.get("co_bps", mod.get("bps")))
        lo, hi = (np.nanmin([ref_bps.min(), mod_bps.min()]),
                  np.nanmax([ref_bps.max(), mod_bps.max()]))
        ax = axs_bps[0][idx]
        ax.scatter(ref_bps, mod_bps, s=10)
        ax.plot([lo, hi], [lo, hi], color="red")
        ax.set_xlabel(f"{args.ref_mod} BPS")
        ax.set_ylabel(f"{args.input_mod} BPS")
        pop_ref = bits_per_spike(ref_pred, np.asarray(ref["gt"]))
        pop_mod = bits_per_spike(mod_pred, gt)
        ax.set_title(f"{args.ref_mod} ({pop_ref:.3f}) vs "
                     f"{args.input_mod} ({pop_mod:.3f}) BPS")

    fig_r2.tight_layout()
    fig_r2.savefig("scatter_r2_sessions.png")
    fig_bps.tight_layout()
    fig_bps.savefig("scatter_bps_sessions.png")
    print("wrote scatter_r2_sessions.png, scatter_bps_sessions.png")


if __name__ == "__main__":
    main()
