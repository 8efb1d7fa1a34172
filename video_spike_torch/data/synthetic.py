"""Synthetic IBL-like session fixtures.

The reference has no test fixtures — every run needs the ONE API and remote
videos. Here a full session (trial tars with video, whisker crop, optical
flow, behaviors, spike counts) is generated procedurally with a *learnable*
video->spike relationship: a Gaussian blob ("whisker pad") moves with a
smooth latent trajectory, and spike rates are a positive function of that
latent, so models trained on the fixture achieve real bits-per-spike > 0.

Trial geometry matches the reference ETL (``reference:src/
prepare_data.py:67-74,186-198``): 2 s trials, 120 video frames at 60 Hz
(128x128 whole-face + a smaller whisker crop), 100 spike bins at 20 ms.
"""

from __future__ import annotations

from pathlib import Path
import numpy as np

from video_spike_torch.data.tar_io import write_trial_tar

T_FRAMES = 120
T_BINS = 100
HEIGHT = WIDTH = 128
WHISKER_H, WHISKER_W = 64, 96


def _smooth_latent(rng: np.random.Generator, n: int, dims: int = 2) -> np.ndarray:
    """Smooth bounded trajectory in [-1, 1]^dims via filtered noise."""
    x = rng.normal(size=(n + 40, dims))
    kernel = np.exp(-0.5 * (np.arange(-10, 11) / 4.0) ** 2)
    kernel /= kernel.sum()
    for d in range(dims):
        x[:, d] = np.convolve(x[:, d], kernel, mode="same")
    x = x[20:-20]
    return np.tanh(2.0 * x / np.std(x))


def _render_frames(latent: np.ndarray, h: int, w: int,
                   noise_rng: np.random.Generator) -> np.ndarray:
    """Render (T, h, w) uint8 frames with a blob at the latent position."""
    t = latent.shape[0]
    ys = (h / 2 + latent[:, 0] * h / 4)[:, None, None]
    xs = (w / 2 + latent[:, 1] * w / 4)[:, None, None]
    yy = np.arange(h)[None, :, None]
    xx = np.arange(w)[None, None, :]
    blob = np.exp(-((yy - ys) ** 2 + (xx - xs) ** 2) / (2 * (h / 12) ** 2))
    frames = 40 + 170 * blob + 8 * noise_rng.normal(size=(t, h, w))
    return np.clip(frames, 0, 255).astype(np.uint8)


def make_raw_session(out_path: str | Path, eid: str = "rawsess000",
                     n_trials: int = 10, n_neurons: int = 16,
                     seed: int = 0, height: int = 64, width: int = 64) -> str:
    """Write a synthetic RAW session (pre-ETL) npz: session-wide spike
    times/clusters, behavior time series at native rates, DLC traces, trial
    table, and camera video — the local-mode input to ``cli.prepare_data``.
    """
    rng = np.random.default_rng(seed)
    trial_len, gap = 2.0, 1.0
    session_len = n_trials * (trial_len + gap) + gap
    trial_starts = gap + np.arange(n_trials) * (trial_len + gap)

    # session-wide latent at 60 Hz driving everything
    n_cam = int(session_len * 60)
    latent = _smooth_latent(rng, n_cam)
    cam_times = np.arange(n_cam) / 60.0

    # spikes: inhomogeneous Poisson per neuron from the latent
    w_lat = rng.normal(scale=1.0, size=(2, n_neurons))
    b = rng.uniform(-1.5, -0.5, size=(n_neurons,))
    rates = np.exp(latent @ w_lat + b) * 60.0  # per-frame rate -> Hz-ish
    spike_times, spike_clusters = [], []
    for n in range(n_neurons):
        counts = rng.poisson(rates[:, n] / 60.0)
        for t_idx in np.where(counts > 0)[0]:
            k = counts[t_idx]
            spike_times.append(cam_times[t_idx]
                               + rng.uniform(0, 1 / 60.0, size=k))
            spike_clusters.append(np.full(k, n))
    spike_times = np.concatenate(spike_times)
    spike_clusters = np.concatenate(spike_clusters).astype(np.int64)
    order = np.argsort(spike_times)
    spike_times, spike_clusters = spike_times[order], spike_clusters[order]

    # behaviors at native rates
    wheel = np.abs(latent[:, 1])
    me = 0.5 + 0.5 * latent[:, 0]

    # DLC traces (static-ish nose/pupil with high likelihood)
    n_frames = n_cam
    dlc = {
        "nose_tip_x": 20 + rng.normal(0, 0.5, n_frames),
        "nose_tip_y": 40 + rng.normal(0, 0.5, n_frames),
        "nose_tip_likelihood": np.full(n_frames, 0.99),
        "pupil_top_r_x": 44 + rng.normal(0, 0.5, n_frames),
        "pupil_top_r_y": 22 + rng.normal(0, 0.5, n_frames),
        "pupil_top_r_likelihood": np.full(n_frames, 0.99),
    }

    video = _render_frames(latent, height, width, rng)

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out_path,
        eid=eid,
        spike_times=spike_times,
        spike_clusters=spike_clusters,
        trial_starts=trial_starts,
        trial_choice=rng.choice([-1.0, 1.0], n_trials),
        trial_block=rng.choice([0.2, 0.5, 0.8], n_trials),
        cam_times=cam_times,
        wheel_times=cam_times,
        wheel_speed=wheel,
        me_times=cam_times,
        whisker_motion_energy=me,
        video=video,
        **{f"dlc_{k}": v for k, v in dlc.items()},
    )
    return str(out_path)


def make_synthetic_session(out_dir: str | Path, eid: str = "testeid000",
                           n_trials: int = 30, n_neurons: int = 48,
                           seed: int = 0, store_video_as: str = "npy",
                           height: int = HEIGHT, width: int = WIDTH) -> list:
    """Write `n_trials` trial tars for session `eid`; returns the file list."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # fixed per-neuron tuning to the 2-D latent (+ baseline), shared per session
    w_lat = rng.normal(scale=1.0, size=(2, n_neurons))
    b = rng.uniform(-2.2, -1.2, size=(n_neurons,))

    files = []
    t0 = 0.0
    for k in range(n_trials):
        latent = _smooth_latent(rng, T_FRAMES)          # (120, 2)
        video = _render_frames(latent, height, width, rng)
        whisker = _render_frames(latent, WHISKER_H, WHISKER_W, rng)

        # spikes: subsample latent to 100 bins, positive rates via exp
        idx = np.linspace(0, T_FRAMES - 1, T_BINS).astype(int)
        lograte = latent[idx] @ w_lat + b               # (100, N)
        ap = rng.poisson(np.exp(lograte)).astype(np.float32)

        # behaviors at 60 Hz — directly informative about the spike latent so
        # linear readouts on behavioral inputs are learnable on the fixture
        motion_energy = (0.5 + 0.5 * latent[:, 0]).astype(np.float32)
        wheel_speed = latent[:, 1].astype(np.float32)
        timestamp = (t0 + np.arange(T_FRAMES) / 60.0).astype(np.float64)
        t0 += 3.0  # trials are non-contiguous in session time

        # Farneback-style optical flow features of the whisker crop:
        # (T, h, w, 2) dense flow approximated from the latent velocity.
        vel = np.diff(latent, axis=0, prepend=latent[:1])  # (120, 2)
        flow = np.zeros((T_FRAMES, WHISKER_H // 4, WHISKER_W // 4, 2),
                        dtype=np.float32)
        flow[..., 0] = vel[:, 1, None, None]
        flow[..., 1] = vel[:, 0, None, None]
        of_summary = np.stack([
            np.abs(vel).sum(1),                        # motion energy of flow
            vel[:, 1], vel[:, 0],
        ], axis=1).astype(np.float32)                  # (120, 3)

        choice = np.array([rng.choice([-1.0, 1.0])], dtype=np.float32)
        block = np.array([rng.choice([0.2, 0.5, 0.8])], dtype=np.float32)

        key = f"{eid}_{k}"
        path = out_dir / f"{key}.tar"
        write_trial_tar(
            path, key,
            arrays={
                "ap": ap,
                "choice": choice,
                "block": block,
                "wheel-speed": wheel_speed.astype(np.float32),
                "whisker-motion-energy": motion_energy.astype(np.float32),
                "whisker-of": of_summary,
                "whisker-of-video": flow,
                "timestamp": timestamp,
            },
            videos={"video": video, "whisker-video": whisker},
            meta={"eid": eid, "trial": k, "n_neurons": n_neurons},
            store_video_as=store_video_as,
        )
        files.append(str(path))
    return files
