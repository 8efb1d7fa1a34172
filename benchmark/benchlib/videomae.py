"""Runner of the VideoMAE pretraining cells: ``cli/pretrain_videomae.py``'s
loop on trial videos the benchmark makes from the seed.

Set-up makes the session's trials (``contrast.make_frames``), builds the
model and its AdamW with the CLI's ``build``, gives it the benchmark's
starting parameters (``benchlib/weights.py``) and its step with the CLI's
``make_step``, and starts the CLI's ``clip_stream`` over a loader of the
trials in shuffled epochs: the host keeps 16 frames of each trial, the
producer thread stages each batch on the device. Warm-up steps run
through the same path the window drives, the first ones captured for the
comparison. A step is what ``main``'s loop does: the next staged batch,
``train_step`` (the step's masking seed, then the step), the loss fetched
at the logging cadence. The window closes at the first step past
``--seconds``; a traced slice follows it with ``--trace 1``, from which
the device time of the kernels launched inside the program's
``vs.attention`` spans is read (``benchlib/launched.py``)."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import compare, launched, trace as tracing, videomae_counts
from .contrast import make_frames
from .steps import Spans, StepClock, quantile
from .supervised import (CAPTURE_STEPS, FINGERPRINT, RunInfo, _sync,
                         change_norms, control_readings, start_weights)

LOG_EVERY = 50          # main()'s logging cadence, where it syncs
VIDEO = "video"
ATTENTION = "vs.attention"


class ClipLoader:
    """The trials in batches of ``batch``, a fresh permutation from the
    seed each epoch (the last partial batch dropped), in the batch layout
    the CLI reads: ``{"video": (B, frames, C, H, W) uint8}``."""

    def __init__(self, trials: np.ndarray, batch: int, seed: int):
        self.trials, self.batch = trials, batch
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        order = self.rng.permutation(len(self.trials))
        for s in range(0, len(order) - self.batch + 1, self.batch):
            yield {VIDEO: self.trials[np.sort(order[s:s + self.batch])]}


class Session:
    def __init__(self, cell, seed: int, device: torch.device, fault=None):
        # the CLI's loop as functions: a program without them fails here,
        # before any work
        from video_spike_torch.cli.pretrain_videomae import (
            build, clip_stream, make_step, train_step)

        cfg, t = cell.config, cell.traffic
        m = cfg["config"]["model"]
        self.cell, self.device, self.seed = cell, device, seed
        self.ref = cell.reference()
        self.trials = make_frames(cfg, seed, device)
        self.index = {tr[0].tobytes()[:FINGERPRINT]: i
                      for i, tr in enumerate(self.trials)}
        model, self.tx, self.params, self.opt_state = build(
            m, cfg["config"]["optimizer"], seed, device)
        self.p0 = start_weights(cell, self.ref, seed, device, self.params)
        self.step_fn = make_step(model, self.tx, m["num_frames"],
                                 m["image_size"], m["mask_ratio"])
        if fault is not None:
            fault(self)
        self.gen = torch.Generator(device=device)
        self.stream = clip_stream(ClipLoader(self.trials, t["batch"], seed),
                                  VIDEO, m["num_frames"], device)
        self.clock, self.spans = StepClock(device), Spans()
        self.timed = self.clock.wrap(train_step)
        self.rows, self.mask_seeds, self.losses = [], [], []
        self.grad_norms = self.moments = self.change_norms = None
        self.pending = []
        self.done = 0

    def step(self) -> None:
        """One step of ``main``'s loop."""
        k = self.done
        with self.spans.span("producer_wait"):
            video = next(self.stream)[VIDEO]
        if k < CAPTURE_STEPS:
            first = video[:, 0].reshape(video.shape[0], -1)
            head = first[:, :FINGERPRINT].cpu().numpy()
            self.rows.append([self.index.get(r.tobytes(), -1)
                              for r in head])
        with self.spans.span("step"):
            self.params, self.opt_state, loss = self.timed(
                self.step_fn, self.params, self.opt_state, video, self.gen,
                self.seed, k)
        self.pending.append(loss)
        if k < CAPTURE_STEPS:
            self.mask_seeds.append(int(self.gen.initial_seed()))
            self.losses.append(float(loss))
            if k == 0:
                self.grad_norms = self.ref.program_grad_norms(
                    self.opt_state, self.params)
                self.moments = self.ref.program_moments(self.opt_state,
                                                        self.params)
            if k == CAPTURE_STEPS - 1:
                self.change_norms = change_norms(self.params, self.p0,
                                                 self.ref.parts)
        if k % LOG_EVERY == 0:
            with self.spans.span("log_losses"):
                float(loss)
        self.done += 1

    def fetch_losses(self) -> list:
        vals = torch.stack(self.pending).float().cpu().tolist() \
            if self.pending else []
        self.pending = []
        return vals

    def captured(self) -> dict:
        return {"prog": {"losses": self.losses,
                         "grad_norms": self.grad_norms,
                         "moments": self.moments,
                         "change_norms": self.change_norms},
                "p0": self.p0, "rows": self.rows,
                "mask_seeds": self.mask_seeds, "trials": self.trials}

    def free(self) -> None:
        """Drop the program's state so the reference runs on a free card."""
        if self.stream is not None:
            self.stream.close()
        self.stream = self.params = self.opt_state = self.step_fn = None
        self.tx = self.timed = self.pending = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare_with_reference(cell, ref, cap: dict, device) -> dict:
    """The reference's first steps from the benchmark's starting
    parameters on the same trials and masking noise. Every clip a captured
    step took must be one of the benchmark's trials, and no trial twice in
    a step."""
    rows = cap["rows"]
    bad = sum(sum(i < 0 for i in r) + len(r) - len(set(r)) for r in rows)
    if bad or len(rows) < CAPTURE_STEPS:
        return {"rows_unmatched": float(max(bad, 1))}
    batches = [(cap["trials"][r], s) for r, s in zip(rows,
                                                      cap["mask_seeds"])]
    want = ref.reference_steps(cell.config, cell.traffic, cap["p0"], batches,
                               None, device)
    numbers = compare.training_numbers(cap["prog"], want, cell.loss_steps,
                                       cell.quantiles, cell.leaves)
    numbers["rows_unmatched"] = 0.0
    numbers["_want"] = {"batches": batches, "ref": want}
    return numbers


def traced_slice(ses: Session, steps: int):
    """``steps`` more steps under the profiler: (trace, steps, the device
    time launched inside ``vs.attention``)."""
    n0 = ses.clock.count
    ses.spans.profiling = True
    prof = tracing.profiler()
    with prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            _sync(ses.device)
            for _ in range(steps):
                ses.step()
            ses.fetch_losses()
            _sync(ses.device)
    ses.spans.profiling = False
    events = prof.profiler.kineto_results.events()
    traced = tracing.from_events(events)
    attention = launched.launched_in(launched.from_kineto(events),
                                     ATTENTION, traced.window)
    del prof, events
    return traced, ses.clock.count - n0, attention


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float, fault=None) -> tuple:
    t = cell.traffic
    m = cell.config["config"]["model"]
    ses = Session(cell, seed, device, fault)
    for _ in range(t["warmup_steps"]):
        ses.step()
    ses.fetch_losses()
    _sync(device)
    gc.freeze()        # set-up's objects leave the collector's scans
    setup_s = time.time() - t_process

    ses.clock.reset()
    ses.spans.seconds = {}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ses.step()
    losses = ses.fetch_losses()
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = ses.clock.count
    step_ms = ses.clock.times_ms()
    window_spans = dict(ses.spans.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = sum(not np.isfinite(x) for x in losses)

    traced, trace_steps, attention = None, 0, None
    if trace:
        traced, trace_steps, attention = traced_slice(ses, t["trace_steps"])
    cap = ses.captured()
    ses.free()
    numbers = compare_with_reference(cell, ses.ref, cap, device)

    clips = t["batch"]
    att_flops, att_bytes = videomae_counts.attention(m, clips)
    info = RunInfo(cell=cell, steps=steps, window_s=window_s,
                   step_ms=step_ms, spans=window_spans, trace=traced,
                   trace_steps=trace_steps, busy_by_rank=None,
                   flops_per_step=videomae_counts.train_flops(m, clips),
                   fused_shape=None, attention=attention,
                   attention_bound_s=videomae_counts.attention_bound_s(
                       att_flops, att_bytes))
    frames_per_step = clips * m["num_frames"]
    result = {
        "attempted": steps, "failed": failed,
        "end_to_end": {
            "train_frames_per_s": steps * frames_per_step / window_s,
            "step_ms_p95": quantile(step_ms, 0.95),
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s},
        "peak_bytes": peak, "info": info}
    return result, numbers


def readings(cell, seed: int, device: torch.device,
             controls=("fp8", "half_batch", "state_unchanged"),
             fault=None) -> dict:
    """As ``supervised.readings``, for the VideoMAE pretraining cells."""
    ses = Session(cell, seed, device, fault)
    for _ in range(CAPTURE_STEPS):
        ses.step()
    ses.fetch_losses()
    cap = ses.captured()
    ses.free()
    out = {"program": compare_with_reference(cell, ses.ref, cap, device)}
    want = out["program"].pop("_want", None)
    if want is not None:
        out.update(control_readings(cell, ses.ref, cap["p0"], want, None,
                                    device, controls))
    return out
