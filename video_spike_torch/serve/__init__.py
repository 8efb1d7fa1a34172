"""Online inference and serving (counterpart of ``video_spike_tpu/serve``).

A serving path for trained models: bucketed batching (requests are padded
to the next bucket, so the card sees a handful of batch shapes), a
micro-batcher that coalesces concurrent requests into one device dispatch,
a stdlib HTTP front end, and ``torch.export`` artifacts (``serve/export.py``).

    session = InferenceSession.from_checkpoint(model_cfg, ckpt_dir)
    rates = session.predict(x)                  # direct, single caller
    batcher = MicroBatcher(session.predict)     # concurrent callers
    fut = batcher.submit(x[0]); fut.result()
    serve_http(batcher, port=8000)              # POST /predict
"""

from video_spike_torch.serve.session import InferenceSession
from video_spike_torch.serve.batcher import MicroBatcher
from video_spike_torch.serve.http import serve_http

__all__ = ["InferenceSession", "MicroBatcher", "serve_http"]
