"""Model registry mapping config names to constructors.

Parity with ``NAME2MODEL`` in the reference (``src/utils/utils.py:28-34``).
The port has the Linear family, the VTT flagship and the three SSL ViT-MAE
wrappers so far; every other name the JAX package registers raises and
names the ROADMAP item that ports it.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_LAZY: Dict[str, str] = {
    "Linear": "video_spike_torch.models.linear:LinearModel",
    "VideoTransformer": "video_spike_torch.models.vtt:VideoTemporalTransformer",
    "ContrastViT": "video_spike_torch.models.vit_mae:ContrastViT",
    "ContrastViTMAE": "video_spike_torch.models.vit_mae:ContrastViTMAE",
    "MAE": "video_spike_torch.models.vit_mae:MAE",
}

# model_class -> ROADMAP.md Queue A item that ports it
_NOT_PORTED: Dict[str, str] = {
    "VideoMAE": "Queue A item 11 (VideoMAE)",
    "VideoMAEForPreTraining": "Queue A item 11 (VideoMAE)",
}


def get_model(name: str) -> Callable:
    if name in _LAZY:
        module_name, attr = _LAZY[name].split(":")
        return getattr(importlib.import_module(module_name), attr)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; see ROADMAP.md "
            f"{_NOT_PORTED[name]}")
    raise KeyError(f"Unknown model {name!r}; known: {sorted(_LAZY)}")


class _LazyName2Model:
    """Dict-like view so call sites keep the reference idiom
    ``NAME2MODEL[config.model.model_class]``."""

    def __getitem__(self, name: str) -> Callable:
        return get_model(name)

    def __contains__(self, name: str) -> bool:
        return name in _LAZY

    def keys(self):
        return sorted(_LAZY)


NAME2MODEL = _LazyName2Model()
