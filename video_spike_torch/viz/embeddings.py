"""Embedding figures and GIF export (counterpart of
``video_spike_tpu/viz/embeddings.py``, reference
``src/utils/plot_utils.py``): ``plot_embeddings`` (``:10-66``), the figure
``models/cebra.get_cebra_embedding`` writes when given a ``save_path``;
``plot_embeddings_anim`` (``:68-140``), ``cli/test.py --save_plot``'s
trajectory GIFs; ``float32_to_uint8`` (``:237-271``) and
``save_numpy_video_to_gif`` (``:142-235``), which ``cli/cal_of.py`` and
``cli/test.py`` write their GIFs with."""

from __future__ import annotations

import numpy as np

from video_spike_torch.viz import pyplot


def float32_to_uint8(frames: np.ndarray) -> np.ndarray:
    """Scale float frames to the full uint8 range per array."""
    frames = np.asarray(frames, dtype=np.float64)
    lo, hi = np.nanmin(frames), np.nanmax(frames)
    if hi <= lo:
        return np.zeros_like(frames, dtype=np.uint8)
    return ((frames - lo) / (hi - lo) * 255).astype(np.uint8)


def plot_embeddings(embeddings: np.ndarray, timestamps=None, title=""):
    """One panel per embedding dimension over time. embeddings: (T, D)."""
    plt = pyplot()
    embeddings = np.asarray(embeddings)
    d = embeddings.shape[-1]
    t = np.arange(len(embeddings)) if timestamps is None else timestamps
    fig, axes = plt.subplots(d, 1, figsize=(12, 2.2 * d), sharex=True)
    if d == 1:
        axes = [axes]
    for i, ax in enumerate(axes):
        ax.plot(t, embeddings[:, i], lw=0.8)
        ax.set_ylabel(f"dim {i}")
    axes[-1].set_xlabel("time")
    fig.suptitle(title or "Embeddings")
    return fig


def plot_embeddings_anim(embeddings: np.ndarray, save_path: str,
                         fps: int = 20, trail: int = 30) -> str:
    """Animated 2-D/3-D embedding trajectory saved as a GIF."""
    import imageio.v2 as imageio

    plt = pyplot()
    embeddings = np.asarray(embeddings)
    frames = []
    d = min(embeddings.shape[-1], 3)
    for t in range(0, len(embeddings), max(len(embeddings) // 120, 1)):
        fig = plt.figure(figsize=(4, 4))
        if d >= 3:
            ax = fig.add_subplot(111, projection="3d")
            seg = embeddings[max(0, t - trail):t + 1]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], lw=1)
        else:
            ax = fig.add_subplot(111)
            seg = embeddings[max(0, t - trail):t + 1]
            ax.plot(seg[:, 0], seg[:, 1] if d > 1 else np.zeros(len(seg)),
                    lw=1)
        ax.set_title(f"t={t}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        frames.append(buf.copy())
        plt.close(fig)
    # imageio >= 2.28 deprecated fps= for GIFs; duration is ms per frame
    imageio.mimsave(save_path, frames, duration=1000.0 / fps)
    return save_path


def save_numpy_video_to_gif(video: np.ndarray, save_path: str,
                            fps: int = 20) -> str:
    """(T, H, W) or (T, C, H, W) or (T, H, W, C) frames -> GIF."""
    import imageio.v2 as imageio

    video = np.asarray(video)
    if video.ndim == 4 and video.shape[1] in (1, 3):  # (T, C, H, W)
        video = np.moveaxis(video, 1, -1)
    if video.ndim == 4 and video.shape[-1] == 1:
        video = video[..., 0]
    if video.dtype != np.uint8:
        video = float32_to_uint8(video)
    imageio.mimsave(save_path, list(video), duration=1000.0 / fps)
    return save_path
