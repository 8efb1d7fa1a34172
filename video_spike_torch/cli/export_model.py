"""Export a trained checkpoint as a self-contained ``torch.export`` artifact.

Counterpart of ``video_spike_tpu/cli/export_model.py``, plus ``--device``:

    python -m video_spike_torch.cli.export_model \
        --model_config configs/model/linear_me.yaml \
        --ckpt_dir logs/<eid5>/<mods>/LinearModel \
        --input_dim 120 --out model.pt2 [--device cuda|cpu]

The ``.pt2`` archive holds the weights and the traced forward, with a
symbolic batch unless ``--static_batch`` (or a forward that cannot trace
one); ``video_spike_torch.serve.export.load_exported`` runs it on the device
it was exported on, without configs or model code.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.runtime import run_rank, setup_runtime


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a model with torch.export")
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--ckpt_dir", type=str, required=True)
    parser.add_argument("--ckpt_name", type=str, default="model_best")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--input_dim", type=int, default=None,
                        help="Feature width (Linear family)")
    parser.add_argument("--batch", type=int, default=8,
                        help="Sample batch (the fallback static size)")
    parser.add_argument("--static_batch", action="store_true",
                        help="Skip the polymorphic-batch attempt")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no card is "
                             "present, 'cpu' must be asked for")
    args = parser.parse_args(argv)
    setup_runtime(args.device)

    log = make_logger(header="[export]")
    # update_config resolves the include: (config_from_kwargs alone leaves
    # the literal string)
    config = update_config(
        config_from_kwargs({"model": f"include:{args.model_config}"}))

    from video_spike_torch.serve import InferenceSession
    from video_spike_torch.serve.export import save_exported

    if args.input_dim is None:
        raise SystemExit("--input_dim is required to shape the sample input")
    sample = np.zeros((args.batch, args.input_dim), np.float32)
    session = InferenceSession.from_checkpoint(
        config.model, args.ckpt_dir, ckpt_name=args.ckpt_name,
        sample_input=sample, device=args.device)
    path = save_exported(session.model, session.params, sample, args.out,
                         polymorphic_batch=not args.static_batch)
    log.info(f"exported {os.path.getsize(path)/1e6:.1f} MB -> {path}")
    return path


if __name__ == "__main__":
    run_rank(main)
