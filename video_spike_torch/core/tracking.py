"""Experiment tracking: ``<log_dir>/metrics.jsonl`` always, wandb mirrored
when it is enabled and importable.

Counterpart of ``video_spike_tpu/core/tracking.py`` (reference
``src/trainer/base.py:56-58,122-127``): one JSON record a call, ``{"t",
"step", **metrics}`` with every value that has ``__float__`` (0-d tensors
included) written as a float, line-buffered so a run is inspectable while
it trains; ``log_figure`` writes a ``{"t", "figure", "path", "step"}``
record and hands wandb the live figure. wandb is imported only when
``use_wandb`` is set; without it the JSONL still records everything. In a
multi-process run only rank 0 writes: the other ranks write to
``os.devnull``, never init wandb and save no figure.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch.distributed as dist


class Tracker:
    def __init__(self, log_dir: str, project: str = "ibl-video",
                 name: Optional[str] = None, use_wandb: bool = False,
                 config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "metrics.jsonl")
        if (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0):
            self._path = os.devnull
            use_wandb = False
        self._file = open(self._path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb
                wandb.init(project=project, name=name, config=config or {})
            except ImportError:
                pass  # JSONL still records everything

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        record = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            record["step"] = step
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_figure(self, name: str, fig, step: Optional[int] = None,
                   path: Optional[str] = None) -> None:
        """A figure record with its on-disk path (the figure is saved
        beside ``metrics.jsonl`` as ``<name>.png`` unless ``path`` says
        where the caller saved it); wandb gets it as an Image."""
        if path is None:
            if self._path == os.devnull:
                return   # figures are rank 0's
            path = os.path.join(os.path.dirname(self._path), f"{name}.png")
            fig.savefig(path)
        record = {"t": round(time.time() - self._t0, 3),
                  "figure": name, "path": path}
        if step is not None:
            record["step"] = step
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(fig)}, step=step)

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
