"""Reduced-rank regression fit from cached features.

Counterpart of ``video_spike_tpu/cli/train_rrr.py`` (reference
``src/train_rrr.py:32-248``), plus ``--device``:

    python -m video_spike_torch.cli.train_rrr --input_mod me \
        [--solver als|lbfgs] [--device cuda|cpu]

1. load ``data/data_rrr_<mod>.npy`` (or the whisker-video h5, which needs
   ``h5py``),
2. Gaussian-smooth the spike counts (sigma=2 along time, scipy's filter),
3. one-hot choice/block for the composite modalities,
4. standardize X/y by train stats, append a bias column,
5. subsample 100 of 120 timesteps of X (sorted random choice from the
   global numpy stream that ``set_seed`` seeds, as in the JAX package),
6. fit per-session RRR (l2=100, ncomp=3; closed-form ALS by default) on
   ``--device``,
7. report per-neuron co-bps + R² and save ``<input_mod>_result.npy``.
"""

from __future__ import annotations

import argparse

import numpy as np
from scipy.ndimage import gaussian_filter1d

from video_spike_torch.core.cli import get_args
from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.rng import set_seed
from video_spike_torch.core.runtime import setup_runtime
from video_spike_torch.data.rrr_data import EMBEDDING_MODS, SHORTNAME_TO_MOD
from video_spike_torch.models.rrr import train_model_main
from video_spike_torch.ops.signal import one_hot_per_trial, standardize
from video_spike_torch.train.rrr_pipeline import eval_rrr_predictions


def load_feature_data(input_mod_short: str, path: str | None = None) -> dict:
    mod = SHORTNAME_TO_MOD.get(input_mod_short, input_mod_short)
    if input_mod_short == "whisker-video":
        import h5py
        path = path or f"data/data_rrr_{mod}.h5"
        with h5py.File(path, "r") as f:
            data = {}
            for eid in f.keys():
                data[eid] = {
                    "X": [f[eid]["X_train"][()], f[eid]["X_test"][()]],
                    "y": [f[eid]["y_train"][()], f[eid]["y_test"][()]],
                    "setup": {},
                }
                for i in range(2):
                    n, t = data[eid]["X"][i].shape[:2]
                    data[eid]["X"][i] = data[eid]["X"][i].reshape(n, t, -1)
        return data
    path = path or f"data/data_rrr_{input_mod_short}.npy"
    return np.load(path, allow_pickle=True).item()


def preprocess(train_data: dict, input_mod_short: str, seed_subsample=None):
    """Smooth y, one-hot composite covariates, standardize, bias, subsample."""
    smooth_w, T = 2, 100
    idx = (np.random.choice(119, T, replace=False)
           if seed_subsample is None else seed_subsample)
    sorted_idx = np.sort(idx)

    eids = sorted(train_data.keys())
    ground_truth = {}
    for eid in eids:
        ground_truth[eid] = np.array(train_data[eid]["y"][1], copy=True)
        if input_mod_short not in EMBEDDING_MODS and \
                input_mod_short not in ("me", "of-2d"):
            # category sets pinned to the union across splits so the one-hot
            # channels align even when a split misses a value
            choice_cats = np.unique(np.concatenate(
                [np.asarray(train_data[eid]["X"][j])[:, 0, -2]
                 for j in range(2)]))
            block_cats = np.unique(np.concatenate(
                [np.asarray(train_data[eid]["X"][j])[:, 0, -1]
                 for j in range(2)]))
        for i in range(2):
            train_data[eid]["y"][i] = gaussian_filter1d(
                np.asarray(train_data[eid]["y"][i], dtype=np.float64),
                smooth_w, axis=1)
            if input_mod_short in EMBEDDING_MODS:
                if input_mod_short == "m":
                    train_data[eid]["X"][i] = train_data[eid]["X"][i][..., :3]
                continue
            if input_mod_short not in ("me", "of-2d"):
                inp = np.asarray(train_data[eid]["X"][i], dtype=np.float64)
                choice = inp[:, 0, -2:-1]
                block = inp[:, 0, -1:]
                const = 3 if input_mod_short in ("me-all", "of-all") else 2
                contin_dim = inp.shape[2] - const
                choice_oh = one_hot_per_trial(choice, inp.shape[1], choice_cats)
                block_oh = one_hot_per_trial(block, inp.shape[1], block_cats)
                inp = np.concatenate(
                    [choice_oh, block_oh, inp[..., -2 - contin_dim:-2]],
                    axis=2)
                train_data[eid]["X"][i] = inp

    for eid in eids:
        _, mean_X, std_X = standardize(train_data[eid]["X"][0])
        _, mean_y, std_y = standardize(train_data[eid]["y"][0])
        for i in range(2):
            X = np.asarray(train_data[eid]["X"][i], dtype=np.float64)
            X = (X - mean_X) / std_X
            if X.ndim == 2:
                X = X[..., None]
            K, Tfull = X.shape[:2]
            X = np.concatenate([X, np.ones((K, Tfull, 1))], axis=2)
            if Tfull > T:
                X = X[:, sorted_idx]
            train_data[eid]["X"][i] = X
            y = np.asarray(train_data[eid]["y"][i], dtype=np.float64)
            train_data[eid]["y"][i] = (y - mean_y) / std_y
        train_data[eid]["setup"].update(
            mean_X_Tv=mean_X, std_X_Tv=std_X,
            mean_y_TN=mean_y, std_y_TN=std_y)
    return ground_truth, eids


def fit_and_eval(train_data: dict, ground_truth: dict, eids,
                 l2: float = 100.0, n_comp: int = 3,
                 max_iter: int = 120, solver: str = "als",
                 device="cuda") -> dict:
    result, test_bps = {}, []
    for eid in eids:
        model, _ = train_model_main(
            train_data={eid: train_data[eid]}, l2=l2, n_comp=n_comp,
            model_fname="tmp", save=False, max_iter=max_iter, solver=solver,
            device=device)
        _, _, pred = model.predict_y_fr(train_data, eid, 1)
        gt = ground_truth[eid]
        ev = eval_rrr_predictions(pred, gt, device=model.device)
        bps, r2 = np.asarray(ev["bps"]), np.asarray(ev["r2"])
        co_bps = float(np.nanmean(bps))
        print(f"eid: {eid}\nco-bps: {co_bps}\nr2: {np.nanmean(r2)}")
        test_bps.append(co_bps)
        result[eid] = {"gt": gt, "pred": ev["pred"], "co_bps": bps.tolist(),
                       "r2": r2.tolist(), "eid": eid}
    for b in test_bps:
        print(f"{b:.5f}")
    print(f"mean bps:{np.mean(test_bps):.5f}")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--solver", choices=("als", "lbfgs"), default="als",
                        help="RRR solver: closed-form ALS (production; same "
                             "objective) or the reference-parity LBFGS")
    extra, rest = parser.parse_known_args(argv)
    args = get_args(rest)
    setup_runtime(args.device)
    device = resolve_device(args.device)
    config = config_from_kwargs({"model": f"include:{args.model_config}"})
    config = update_config(args.train_config, config)
    # argparse values merge LAST, as in the reference (src/train.py:28-30)
    config["seed"] = args.seed
    set_seed(config.seed)
    train_data = load_feature_data(args.input_mod)
    ground_truth, eids = preprocess(train_data, args.input_mod)
    result = fit_and_eval(train_data, ground_truth, eids,
                          solver=extra.solver, device=device)
    out = f"{args.input_mod}_result.npy"
    np.save(out, result)
    # per-eid copies for plot_scatter's <eid5>_<mod>_result.npy convention
    for eid, res in result.items():
        np.save(f"{eid[:5]}_{args.input_mod}_result.npy", res)
    print(f"saved {out}")
    return result


if __name__ == "__main__":
    main()
