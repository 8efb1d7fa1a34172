"""Runner of the SSL cells: ``ContrastTrainer``'s epoch path on frames
the benchmark makes from the seed.

Set-up builds the trainer as ``cli/pretrain.py`` does over an in-memory
session (the pretrain loader over every trial's frames), stages the frame
cache on the device, gives the trainer the benchmark's starting
parameters (``benchlib/weights.py``) and runs warm-up steps through the
same path the window drives, capturing its first steps for the
comparison. The window is ``fit()``'s loop without validation or
checkpoints: the epoch sampler's index batches, staged by the producer
thread (``_staged_epoch_stream``), each gathered from the frame cache and
trained on (``_step_staged``), the losses fetched at the logging cadence,
a new epoch's stream when one ends. It closes at the first step past
``--seconds``."""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from . import compare, counts, trace as tracing
from .steps import Spans, StepClock, quantile
from .supervised import (CAPTURE_STEPS, RunInfo, _sync, change_norms,
                         control_readings, start_weights)

EID = "benchsession0"
LOG_EVERY = 50          # fit()'s logging cadence, where it syncs


def make_frames(cfg: dict, seed: int, device: torch.device,
                chunk: int = 4096) -> np.ndarray:
    """Every frame of the session, uint8 (trials, frames, C, H, W), drawn
    on the device from ``seed``: a coarse random field (the
    configuration's ``field`` cells) upsampled bilinearly to the frame,
    plus pixel noise of +-``noise`` levels, so frames differ as video
    frames do at every scale the encoder sees. Returned on the host."""
    f = cfg["frames"]
    g = torch.Generator(device=device).manual_seed(seed)
    n = f["trials"] * f["frames_per_trial"]
    c, h, w = f["channels"], f["height"], f["width"]
    fh, fw = f["field"]
    coarse = torch.rand((n, c, fh, fw), generator=g, device=device) * 255.0
    noise = torch.randint(-f["noise"], f["noise"] + 1, (n, c, h, w),
                          generator=g, device=device, dtype=torch.int16)
    out = np.empty((n, c, h, w), dtype=np.uint8)
    for s in range(0, n, chunk):
        img = torch.nn.functional.interpolate(
            coarse[s:s + chunk], size=(h, w), mode="bilinear",
            align_corners=False)
        img = (img + noise[s:s + chunk]).round().clamp(0, 255)
        out[s:s + chunk] = img.to(torch.uint8).cpu().numpy()
    del coarse, noise
    return out.reshape(f["trials"], f["frames_per_trial"], c, h, w)


def build(cell, seed: int, device: torch.device, log_dir: str):
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.core.registry import NAME2MODEL
    from video_spike_torch.data.contrast import make_contrast_loader
    from video_spike_torch.train.contrast import make_contrast_trainer

    cfg, t = cell.config, cell.traffic
    config = DictConfig(cfg["config"])
    video = make_frames(cfg, seed, device)
    n, tf = video.shape[:2]
    empty = video[:0]
    ts = np.arange(n * tf, dtype=np.float64).reshape(n, tf)
    session = {EID: {"train_X": video, "val_X": empty, "test_X": empty,
                     "train_timestamp": ts, "val_timestamp": ts[:0],
                     "test_timestamp": ts[:0],
                     "train_y": np.zeros((n, 1)), "val_y": np.zeros((0, 1)),
                     "test_y": np.zeros((0, 1))}}
    image = config.model["image_size"]
    loader, _ = make_contrast_loader(
        session, mode="pretrain", eid=EID, batch_size=t["batch"],
        shuffle=True, idx_offset=cfg["idx_offset"], image_size=image,
        seed=seed)
    model = NAME2MODEL[cfg["model_name"]].from_config(config.model,
                                                      device=device)
    trainer = make_contrast_trainer(
        model=model, data_loader=loader,
        optimizer_config=dict(config.optimizer), max_steps=1 << 40,
        eid=EID, log_dir=log_dir, image_size=image, seed=seed,
        validate_every=1 << 40, save_every_steps=None, save_every_min=None,
        flush_best=False,
        frame_cache_gb=float(config.training["frame_cache_gb"]),
        device=device)
    return trainer, loader.dataset.video


class Session:
    def __init__(self, cell, seed: int, device: torch.device, log_dir: str,
                 fault=None):
        self.cell, self.device = cell, device
        self.ref = cell.reference()
        self.trainer, self.frames = build(cell, seed, device, log_dir)
        tr = self.trainer
        tr._init_if_needed()
        if not tr._maybe_stage_frames():
            raise RuntimeError("the frame cache was not staged")
        self.p0 = start_weights(cell, self.ref, seed, device, tr.params)
        if fault is not None:
            fault(tr)
        self.clock, self.spans = StepClock(device), Spans()
        self.rows, self.mask_seeds, self.losses = [], [], []
        self.grad_norms = self.moments = self.change_norms = None
        self.done = 0
        timed = self.clock.wrap(tr._train_step)

        def train_step(trip):
            with self.spans.span("step"):
                return timed(trip)

        tr._train_step = train_step
        self.stream = None

    def step(self) -> None:
        """One step of ``fit()``'s loop: the next staged index batch (a new
        epoch's stream when one ends), the step, the losses fetched at the
        logging cadence."""
        tr = self.trainer
        while True:
            if self.stream is None:
                with self.spans.span("epoch_start"):
                    self.stream = tr._staged_epoch_stream()
            with self.spans.span("producer_wait"):
                staged = next(self.stream, None)
            if staged is not None:
                break
            self.stream.close()
            self.stream = None
        k = self.done
        if k < CAPTURE_STEPS:
            self.rows.append(staged.cpu().numpy())
        logs = tr._step_staged(staged, k)
        tr._pending_losses.append(logs["loss"])
        if k < CAPTURE_STEPS:
            self.mask_seeds.append(int(tr._mask_gen.initial_seed()))
            self.losses.append(float(logs["loss"]))
            if k == 0:
                self.grad_norms = self.ref.program_grad_norms(tr.opt_state,
                                                              tr.params)
                self.moments = self.ref.program_moments(tr.opt_state,
                                                        tr.params)
            if k == CAPTURE_STEPS - 1:
                self.change_norms = change_norms(tr.params, self.p0,
                                                 self.ref.parts)
        if k % LOG_EVERY == 0:
            with self.spans.span("log_losses"):
                tr._log_losses(logs)
        self.done += 1

    def fetch_losses(self) -> list:
        """Every loss since the last call, as ``fit()`` fetches them."""
        tr = self.trainer
        if tr._pending_losses:
            tr._log_losses(None)
        vals, tr.train_losses = tr.train_losses, []
        return vals

    def captured(self) -> dict:
        return {"prog": {"losses": self.losses,
                         "grad_norms": self.grad_norms,
                         "moments": self.moments,
                         "change_norms": self.change_norms},
                "p0": self.p0, "rows": self.rows,
                "mask_seeds": self.mask_seeds, "frames": self.frames}

    def free(self) -> None:
        if self.stream is not None:
            self.stream.close()
        self.stream = self.trainer = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare_with_reference(cell, ref, cap: dict, device) -> dict:
    """The reference's first steps from the benchmark's starting
    parameters on the same frames and masking noise. Every captured index
    batch must hold indices into the benchmark's frames."""
    frames = cap["frames"]
    rows = cap["rows"]
    bad = sum(int(((r < 0) | (r >= len(frames))).sum()) for r in rows)
    if bad or len(rows) < CAPTURE_STEPS:
        return {"rows_unmatched": float(max(bad, 1))}
    batches = [(frames[r], s) for r, s in zip(rows, cap["mask_seeds"])]
    want = ref.reference_steps(cell.config, cell.traffic, cap["p0"], batches,
                               None, device)
    numbers = compare.training_numbers(cap["prog"], want,
                                       cell.loss_steps, cell.quantiles,
                                       cell.leaves)
    numbers["rows_unmatched"] = 0.0
    numbers["_want"] = {"batches": batches, "ref": want}
    return numbers


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float, fault=None) -> tuple:
    t = cell.traffic
    log_dir = tempfile.mkdtemp(prefix="bench_contrast_")
    try:
        ses = Session(cell, seed, device, log_dir, fault)
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

        traced, trace_steps = None, 0
        if trace:
            n0 = ses.clock.count
            ses.spans.profiling = True
            prof = tracing.profiler()
            with prof:
                with torch.profiler.record_function(tracing.WINDOW_SPAN):
                    _sync(device)
                    for _ in range(t["trace_steps"]):
                        ses.step()
                    ses.fetch_losses()
                    _sync(device)
            ses.spans.profiling = False
            trace_steps = ses.clock.count - n0
            traced = tracing.read(prof)
            del prof
        cap = ses.captured()
        ses.free()
        numbers = compare_with_reference(cell, ses.ref, cap, device)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    frames_per_step = 3 * t["batch"] * t.get("ranks", 1)
    info = RunInfo(cell=cell, steps=steps, window_s=window_s,
                   step_ms=step_ms, spans=window_spans, trace=traced,
                   trace_steps=trace_steps, busy_by_rank=None,
                   flops_per_step=counts.vit_mae_train_flops(
                       cell.config["config"]["model"], frames_per_step),
                   fused_shape=None)
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
    """As ``supervised.readings``, for the SSL cells."""
    log_dir = tempfile.mkdtemp(prefix="bench_readings_")
    try:
        ses = Session(cell, seed, device, log_dir, fault)
        for _ in range(CAPTURE_STEPS):
            ses.step()
        ses.fetch_losses()
        cap = ses.captured()
        ses.free()
        out = {"program": compare_with_reference(cell, ses.ref, cap, device)}
        want = out["program"].pop("_want", None)
        out.update(control_readings(cell, ses.ref, cap["p0"], want, None,
                                    device, controls))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return out
