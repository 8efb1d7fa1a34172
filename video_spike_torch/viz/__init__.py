"""Figures (counterpart of ``video_spike_tpu/viz``): the trainers'
``save_plot`` figures (``plots``), the cross-modality comparison figures
(``raster``) and the embedding figures and GIFs (``embeddings``).

matplotlib is imported inside each function through :func:`pyplot`: the
card's machine has none, and a run that asks for a figure there fails with
an ``ImportError`` that names it."""

from __future__ import annotations


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or an ``ImportError``
    naming matplotlib (figures are never skipped silently)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "figures (save_plot, the results CLIs) need matplotlib, which "
            "is not installed here; run without save_plot or install "
            "matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
