"""Serve a trained model over HTTP.

Counterpart of ``video_spike_tpu/cli/serve.py``, plus ``--device``:

    python -m video_spike_torch.cli.serve \
        --model_config configs/model/linear_me.yaml \
        --ckpt_dir logs/<eid5>/<mods>/LinearModel --input_dim 120 \
        --port 8000 [--device cuda|cpu]

POST ``.npy`` bytes to ``/predict``; GET ``/stats`` for latency counters.
The model is wrapped in an InferenceSession (bucketed batch shapes, every
bucket run once at startup when ``--input_dim`` is given) behind a
MicroBatcher (concurrent requests coalesce into single device dispatches).
Sizes the model yaml leaves null are read off the checkpoint. Runs on
``cuda`` unless ``--device cpu`` is given; asking for ``cuda`` without a
card raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from video_spike_torch.core.config import config_from_kwargs, update_config
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.runtime import run_rank, setup_runtime


def make_app(argv=None):
    """Parse args, load the checkpoint, warm the buckets; returns
    ``(args, session, batcher)`` — main() puts the HTTP server on top."""
    parser = argparse.ArgumentParser(description="Serve a trained model")
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--ckpt_dir", type=str, required=True)
    parser.add_argument("--ckpt_name", type=str, default="model_best")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--max_batch", type=int, default=16)
    parser.add_argument("--max_delay_ms", type=float, default=5.0)
    parser.add_argument("--input_dim", type=int, default=None,
                        help="Feature width for warmup (Linear family)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no card is "
                             "present, 'cpu' must be asked for")
    args = parser.parse_args(argv)
    setup_runtime(args.device)

    log = make_logger(header="[serve]")
    # update_config resolves the include: (config_from_kwargs alone leaves
    # the literal string)
    config = update_config(
        config_from_kwargs({"model": f"include:{args.model_config}"}))

    from video_spike_torch.serve import InferenceSession, MicroBatcher
    session = InferenceSession.from_checkpoint(
        config.model, args.ckpt_dir, ckpt_name=args.ckpt_name,
        bucket_sizes=(1, 2, 4, 8, args.max_batch), device=args.device)
    sample_ndim = None
    if args.input_dim:
        log.info("warming buckets...")
        row = np.zeros((args.input_dim,), np.float32)
        session.warmup(row)
        sample_ndim = row.ndim
    batcher = MicroBatcher(session.predict, max_batch=args.max_batch,
                           max_delay_ms=args.max_delay_ms,
                           sample_ndim=sample_ndim)
    log.info(f"serving on {args.host}:{args.port} "
             f"(buckets {session.buckets}, {session.device})")
    return args, session, batcher


def main(argv=None):
    from video_spike_torch.serve import serve_http

    args, _, batcher = make_app(argv)
    server = serve_http(batcher, port=args.port, host=args.host,
                        block=False)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:          # the socket and the batcher's thread, before exit
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    run_rank(main)
