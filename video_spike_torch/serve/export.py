"""Ahead-of-time model export with ``torch.export``.

Counterpart of ``video_spike_tpu/serve/export.py`` (StableHLO there):
``export_forward`` traces ``model(x[, session_ids])`` with the checkpoint's
params as the exported program's state, and ``save_exported`` writes it as
one ``.pt2`` file that ``torch.export.load`` runs without the port's configs
or model code. A program traced on CUDA bf16 attention holds the kernel op
``vst::flash_attention`` (``ops/attention.py``), and runs the hand-written
kernels; a process that loads it needs the op library, that is
``import video_spike_torch.ops.attention``, as ``load_exported`` does.

Batch polymorphism: the batch is exported as a symbolic dimension
(``torch.export.Dim``) when tracing allows it, so one artifact serves any
batch size; where that export raises, the fixed sample batch is used
instead, as in the JAX package. The result says which one was used, and the
artifact records it. The program keeps the device it was traced on;
``load_exported`` moves inputs there.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

import video_spike_torch.ops.attention  # noqa: F401  (vst::flash_attention)
from video_spike_torch.serve.session import prepare_for_inference

_META = "video_spike_torch.json"


class ExportedForward(NamedTuple):
    program: torch.export.ExportedProgram
    polymorphic: bool            # False: the sample's static batch


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def export_forward(model, params: Mapping[str, torch.Tensor],
                   sample_input, session_ids: Optional[np.ndarray] = None,
                   polymorphic_batch: bool = True) -> ExportedForward:
    """``torch.export`` of ``model(x[, session_ids])`` with `params` (on
    their device, in their stored dtype) as the program's state."""
    device = next(iter(params.values())).device
    model = prepare_for_inference(model, params, device)
    args = [_as_tensor(sample_input, device)]
    if session_ids is not None:
        args.append(_as_tensor(np.asarray(session_ids, np.int64), device))
    args = tuple(args)
    # one eager forward first: tables a model builds lazily on first use
    # are then real tensors (program constants), not tracing placeholders
    with torch.inference_mode():
        model(*args)
    if polymorphic_batch:
        batch = torch.export.Dim("batch")
        try:
            program = torch.export.export(
                model, args, dynamic_shapes=tuple({0: batch} for _ in args))
            return ExportedForward(program, True)
        except Exception:   # tracing needs static shapes -> fixed batch
            pass
    return ExportedForward(torch.export.export(model, args), False)


def save_exported(model, params, sample_input, path: str | Path,
                  **kwargs) -> str:
    """Export and write ``path`` (a ``.pt2`` archive)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    exported = export_forward(model, params, sample_input, **kwargs)
    exported.program.example_inputs = None   # the sample stays out of it
    torch.export.save(exported.program, str(path), extra_files={
        _META: json.dumps({"polymorphic": exported.polymorphic})})
    return str(path)


def load_exported(path: str | Path) -> Callable:
    """Load a saved program; returns ``f(x[, session_ids]) -> out`` (a
    tensor on the program's device). ``f.polymorphic`` says whether the
    batch is symbolic."""
    extra = {_META: ""}
    program = torch.export.load(str(path), extra_files=extra)
    module = program.module()
    device = next(iter(program.state_dict.values())).device
    meta = json.loads(extra[_META] or "{}")

    def call(*args):
        with torch.inference_mode():
            return module(*(_as_tensor(a, device) for a in args))

    call.polymorphic = bool(meta.get("polymorphic", False))
    return call
