"""Embedding figures (counterpart of ``video_spike_tpu/viz/embeddings.py``,
reference ``src/utils/plot_utils.py:10-66``): ``plot_embeddings`` only, the
figure ``models/cebra.get_cebra_embedding`` writes when given a
``save_path``."""

from __future__ import annotations

import numpy as np


def plot_embeddings(embeddings: np.ndarray, timestamps=None, title=""):
    """One panel per embedding dimension over time. embeddings: (T, D)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
