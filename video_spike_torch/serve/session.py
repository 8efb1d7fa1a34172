"""Checkpoint-backed inference session with bucketed batching.

Counterpart of ``video_spike_tpu/serve/session.py``. Every request batch is
padded up to a fixed bucket (powers of two by default) with copies of its
last row, run through the model, and the padding is stripped from the
output, so the card only ever sees a handful of batch shapes. The forward
is eager under ``torch.inference_mode()`` with the model in eval mode and
``remat`` off; ``stats["compiles"]`` counts the buckets run for the first
time (the JAX package compiles one executable per bucket). ``warmup()``
runs every bucket once at startup.

With ``mesh=`` (``parallel.mesh.make_mesh`` over a process group) and
``sharding_rules=`` (e.g. ``models.linear.first_layer_sharding_rules``)
every rank holds its row block of the Linear model's first Dense kernel
(983,040 of its 1,966,080 rows at model = 2) and the rest replicated; a
request runs on every rank with the same rows (a collective: every rank
calls ``predict`` with the same batch), each rank computes
``x[:, rows] @ W_rows`` and the partial products are all-reduced with SUM
over the ``model`` axis before the bias. With
``models.vtt.vtt_sharding_rules`` the VTT is held split as it trains under
the production rules: its wide kernels by columns and its session heads
on the neuron axis, each split layer run as a column-split Dense and the
heads' neuron blocks gathered (``models/vtt.split_over_model``); every
rank again calls ``predict`` with the same batch. Not in this port yet
(ROADMAP.md): a captured CUDA graph per bucket.
"""

from __future__ import annotations

import bisect
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from video_spike_torch.core.device import resolve_device
from video_spike_torch.models.vtt import (
    VideoTemporalTransformer,
    split_over_model,
)
from video_spike_torch.ops.fused_readout import (
    FIRST_BIAS,
    FIRST_KERNEL,
    preprocess_flat,
    tail_apply,
)
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import replicated


# rows of the row-split first kernel upcast to f32 at once
_ROW_CHUNK = 1 << 16


def prepare_for_inference(model: torch.nn.Module,
                          params: Mapping[str, torch.Tensor],
                          device: torch.device,
                          placements: Optional[Mapping] = None
                          ) -> torch.nn.Module:
    """The model in eval mode with ``remat`` off, holding `params` on
    `device` in their stored dtype (a bf16 SR-stored kernel stays bf16, as
    the trainer's ``_set_params`` keeps it) without a further copy. A leaf
    split by its placement in `placements` holds its block: 1/parts of the
    model's size along the split dimension."""
    named = dict(model.named_parameters())
    if set(named) != set(params):
        raise KeyError(f"checkpoint params differ from the model's: missing "
                       f"{sorted(set(named) - set(params))[:4]}, unexpected "
                       f"{sorted(set(params) - set(named))[:4]}")
    for k, p in named.items():
        t = params[k]
        want = list(p.shape)
        place = (placements or {}).get(k)
        if place is not None and place.axis is not None:
            want[place.split_dim(p.ndim)] //= place.parts
        if list(t.shape) != want:
            raise ValueError(f"{k}: checkpoint shape {tuple(t.shape)} vs "
                             f"model {tuple(p.shape)}")
        p.data = t.detach().to(device)
        p.requires_grad_(False)
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = False
    return model.eval()


def _fill_dims(model_config, params: Mapping[str, torch.Tensor]):
    """The sizes a port model needs at construction where the yaml leaves
    them null (flax reads them off the params): the Linear input and output
    widths, the VTT's session and neuron counts."""
    cfg = model_config
    if cfg["model_class"] == "Linear":
        enc, dec = dict(cfg["encoder"]), dict(cfg["decoder"])
        if enc.get("input_dim") is None:
            enc["input_dim"] = int(params["encoder.Dense_0.kernel"].shape[0])
        if dec.get("output_dim") is None:
            last = len(dec.get("hidden_dims") or ())
            dec["output_dim"] = int(
                params[f"decoder.Dense_{last}.kernel"].shape[1])
        cfg = type(cfg)({**cfg, "encoder": enc, "decoder": dec})
    elif cfg["model_class"] == "VideoTransformer":
        s, _, n = params["session_heads"].shape
        cfg = type(cfg)({**cfg, "n_sessions": cfg.get("n_sessions") or int(s),
                         "max_neurons": cfg.get("max_neurons") or int(n)})
    return cfg


class InferenceSession:
    """Bucket-batched, eager ``model(x[, session_ids])`` over fixed params
    on one device, or with the Linear first kernel's rows split over the
    ranks of a mesh's ``model`` axis.

    ``needs_session_ids`` covers models whose forward takes per-sample
    session ids besides the data batch (the VTT flagship); ids a request
    leaves out default to session 0."""

    def __init__(self, model, params: Mapping[str, torch.Tensor],
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 needs_session_ids: bool = False, device="cuda",
                 mesh=None, sharding_rules=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self._sharded = ()
        rules = None
        if mesh is not None:
            rules = (sharding_rules(params, mesh) if sharding_rules
                     else {k: replicated(mesh) for k in params})
            params = mh.put_tree(
                {k: v.to(self.device) for k, v in params.items()}, rules)
            self._sharded = self._split(model, rules)
        self.model = prepare_for_inference(model, params, self.device, rules)
        self.buckets = sorted(set(int(b) for b in bucket_sizes))
        self.needs_session_ids = needs_session_ids
        self._seen: set = set()
        self.stats = {"requests": 0, "padded_rows": 0, "compiles": 0}

    @property
    def params(self) -> dict:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    @staticmethod
    def _split(model, rules) -> tuple:
        """The split leaves' names, with `model` set up to run them: the
        VTT's column-split kernels and session heads
        (``models/vtt.split_over_model``), or the Linear first kernel's
        row split (run by :meth:`_forward`); anything else raises."""
        split = tuple(k for k, r in rules.items() if r.axis is not None)
        if not split:
            return ()
        if isinstance(model, VideoTemporalTransformer):
            return split_over_model(model, rules)
        if set(split) != {FIRST_KERNEL} or rules[FIRST_KERNEL].axis != "model" \
                or rules[FIRST_KERNEL].dim != 0:
            raise NotImplementedError(
                f"the Linear model's split serving covers the rows of its "
                f"first kernel only, not {sorted(set(split) - {FIRST_KERNEL})}"
                f" or another split of the first kernel")
        return split

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, model_config, ckpt_dir: str,
                        ckpt_name: str = "model_best", sample_input=None,
                        device="cuda", **kwargs) -> "InferenceSession":
        """Build the model from its config through the registry and restore
        the port's ``<ckpt_name>.pt`` params. Sizes the yaml leaves null are
        read off the checkpoint, so ``sample_input`` (which the JAX session
        traces to shape its restore target) is not needed here."""
        from video_spike_torch.core.config import DictConfig
        from video_spike_torch.core.registry import NAME2MODEL
        from video_spike_torch.train.checkpoint import load_checkpoint

        device = resolve_device(device)
        if not isinstance(model_config, DictConfig):
            model_config = DictConfig(model_config)  # dot access on reads
        params = load_checkpoint(ckpt_dir, ckpt_name)["params"]
        model_config = _fill_dims(model_config, params)
        # built on the host (uninitialized storage), then given the
        # checkpoint's tensors on the device
        model = NAME2MODEL[model_config["model_class"]].from_config(
            model_config)
        needs_sids = model_config["model_class"] == "VideoTransformer"
        return cls(model, params, needs_session_ids=needs_sids,
                   device=device, **kwargs)

    # ------------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        if i == len(self.buckets):
            raise ValueError(
                f"batch of {n} exceeds the largest bucket "
                f"{self.buckets[-1]}; raise bucket_sizes")
        return self.buckets[i]

    def warmup(self, sample_row: np.ndarray, session_id: int = 0) -> None:
        """Run every bucket once up front."""
        for b in self.buckets:
            self.predict(np.repeat(sample_row[None], b, axis=0),
                         session_ids=np.full((b,), session_id, np.int32)
                         if self.needs_session_ids else None)

    # ------------------------------------------------------------------
    def predict(self, inputs: np.ndarray,
                session_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Pad to the next bucket, run the forward, unpad; float32 numpy."""
        inputs = np.asarray(inputs)
        n = inputs.shape[0]
        if n == 0:
            raise ValueError("empty batch: predict needs at least one row")
        bucket = self._bucket_for(n)
        pad = bucket - n
        if pad:
            inputs = np.concatenate(
                [inputs, np.repeat(inputs[-1:], pad, axis=0)], axis=0)
        args = [torch.from_numpy(np.ascontiguousarray(inputs))
                .to(self.device)]
        if self.needs_session_ids:
            sids = (np.zeros(n, np.int64) if session_ids is None
                    else np.asarray(session_ids, np.int64))
            if pad:
                sids = np.concatenate([sids, np.repeat(sids[-1:], pad)])
            args.append(torch.from_numpy(sids).to(self.device))
        with torch.inference_mode():
            out = self._forward(*args)[:n].float().cpu().numpy()
        if bucket not in self._seen:
            self._seen.add(bucket)
            self.stats["compiles"] += 1
        self.stats["requests"] += 1
        self.stats["padded_rows"] += pad
        return out

    def _forward(self, *args) -> torch.Tensor:
        """The model's forward, or with a row-split first kernel: this
        rank's partial product of the first Dense, summed over the
        ``model`` axis, then the bias and the rest of the model."""
        if FIRST_KERNEL not in self._sharded:
            return self.model(*args)
        p, model = self.params, self.model
        w = p[FIRST_KERNEL]
        rows, j = w.shape[0], self.mesh.coords["model"]
        cd = model.compute_dtype
        flat = preprocess_flat(model, args[0])[:, j * rows:(j + 1) * rows]
        # the partial product of the compute-dtype operands, summed in f32
        # and rounded to the compute dtype once, after the all-reduce, as
        # the one-rank GEMM rounds its f32 accumulator once (bf16 partials
        # rounded before the sum part from it by more than a bf16 ulp)
        z = torch.zeros((flat.shape[0], w.shape[1]), dtype=torch.float32,
                        device=w.device)
        for r0 in range(0, rows, _ROW_CHUNK):
            r1 = min(r0 + _ROW_CHUNK, rows)
            z += flat[:, r0:r1].to(cd).float() @ w[r0:r1].to(cd).float()
        z = mh.all_sum(z, self.mesh.group("model")).to(cd)
        return tail_apply(model, p, z + p[FIRST_BIAS].to(cd))
