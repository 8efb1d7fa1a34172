"""Runner of the supervised cells: ``BaseTrainer``'s staged epoch loop on
trials the benchmark makes from the seed.

Set-up builds one trainer from the configuration file, stages the trials
on the device, gives it the benchmark's starting parameters
(``benchlib/weights.py``) and runs the warm-up epochs through the same
calls the window makes; its first steps are captured for the comparison.
The window runs whole epochs, as ``BaseTrainer.train()`` does each epoch
without its logging and checkpoint writes: ``train_epoch()``,
``eval_epoch()`` on the held-out split, and the on-device copy of the
parameters when the eval bits per spike improve. It closes at the first
epoch boundary past ``--seconds``."""

from __future__ import annotations

import copy
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from . import compare, counts, ranks, trace as tracing, weights
from .steps import Spans, StepClock, quantile

EID = "benchsession0"
CAPTURE_STEPS = 3
FINGERPRINT = 32       # leading bytes of a trial that identify it


def make_trials(n: int, cfg: dict, rate: float, seed: int,
                device: torch.device):
    """``n`` trials of uint8 video (n, frames*H*W) and Poisson spike counts
    (n, t_bins, neurons) f32, drawn on the device from ``seed`` in two
    calls, returned on the host (the trainer's loaders are host arrays)."""
    v = cfg["video"]
    dim = v["frames"] * v["channels"] * v["height"] * v["width"]
    g = torch.Generator(device=device).manual_seed(seed)
    video = torch.randint(0, 256, (n, dim), generator=g, device=device,
                          dtype=torch.uint8)
    rates = torch.full((n, cfg["t_bins"], cfg["neurons"]), float(rate),
                       device=device)
    ap = torch.poisson(rates, generator=g)
    out = video.cpu().numpy(), ap.cpu().numpy()
    del video, rates, ap
    return out


class ArrayLoader:
    """A loader over host arrays in the batch layout the trainer reads:
    ``{"video", "ap", "eid"}`` in order, ``num_trials`` rows."""

    def __init__(self, video, ap, batch: int):
        self.video, self.ap, self.batch = video, ap, batch
        self.num_trials = len(video)

    def __iter__(self):
        for s in range(0, self.num_trials, self.batch):
            e = min(s + self.batch, self.num_trials)
            yield {"video": self.video[s:e], "ap": self.ap[s:e],
                   "eid": [EID] * (e - s)}


class FirstSteps:
    """Wraps the trainer's step function; for the first ``n`` steps keeps
    which trials each step took (matched to the benchmark's own data by
    their leading bytes), its seed, valid rows and loss, the first
    gradient's per-leaf norms as the optimizer's state holds them after
    one step with its per-element statistics, and each leaf's change over
    the ``n`` steps."""

    def __init__(self, p0: dict, index: dict, ref, n: int):
        self.p0 = p0
        self.index, self.ref, self.n = index, ref, n
        self.rows, self.seeds, self.n_valid, self.losses = [], [], [], []
        self.grad_norms = self.moments = self.change_norms = None
        self.done = 0

    def wrap(self, fn):
        def step(params, opt_state, inputs, ap, n_valid, seed):
            k = self.done
            if k < self.n:
                head = inputs[:, :FINGERPRINT].cpu().numpy()
                self.rows.append([self.index.get(r.tobytes(), -1)
                                  for r in head])
                self.seeds.append(int(seed))
                self.n_valid.append(int(n_valid))
            out = fn(params, opt_state, inputs, ap, n_valid, seed)
            if k < self.n:
                self.losses.append(float(out[2]))
                if k == 0:
                    self.grad_norms = self.ref.program_grad_norms(out[1],
                                                                  out[0])
                    self.moments = self.ref.program_moments(out[1], out[0])
                if k == self.n - 1:
                    self.change_norms = change_norms(out[0], self.p0)
            self.done += 1
            return out

        return step


def change_norms(params: dict, p0: dict, parts=lambda name: 1,
                 chunk: int = 1 << 24) -> dict:
    """Per leaf (or packed part) ``||p - p0||`` with ``p`` on the device
    and ``p0`` on the host, uploaded in chunks so the check adds little
    device memory."""
    from .plain import part_norms

    out = {}
    for k, p in params.items():
        n = parts(k)
        if n > 1:
            out.update(part_norms(k, p.detach().float()
                                  - p0[k].to(p.device).float(), n))
            continue
        a, b = p.detach().reshape(-1), p0[k].reshape(-1)
        acc = torch.zeros((), dtype=torch.float64, device=a.device)
        for s in range(0, a.numel(), chunk):
            d = a[s:s + chunk].float() - b[s:s + chunk].to(a.device).float()
            acc += d.double().pow(2).sum()
        out[k] = float(acc.sqrt())
    return out


def fingerprint_index(video: np.ndarray) -> dict:
    return {row[:FINGERPRINT].tobytes(): i for i, row in enumerate(video)}


def rank_trials(cell, seed: int, r: int, n: int, device: torch.device):
    """Rank ``r``'s (train, held-out) trials of an ``n``-rank run: each rank
    holds ``train_trials`` of its own; the held-out trials are the same on
    every rank (the trainer splits eval rows over the ranks)."""
    t, cfg = cell.traffic, cell.config
    n_train, n_eval = t["train_trials"], t["eval_trials"]
    video, ap = make_trials(n_train, cfg, t["spike_rate"],
                            ranks.data_seed(seed, r, n), device)
    held = make_trials(n_eval, cfg, t["spike_rate"],
                       (seed + 0x5EED) & ranks.MASK63, device)
    return (video, ap), held


def build(cell, seed: int, device: torch.device, log_dir: str):
    """(trainer, train arrays, eval arrays) for the cell, as
    ``cli/train.py`` builds a trainer, on the benchmark's own trials; in a
    multi-rank run this rank's trials, the global batch ``batch x ranks``
    and the schedule over the global step count."""
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.core.registry import NAME2MODEL
    from video_spike_torch.train.base import BaseTrainer

    t, cfg = cell.traffic, cell.config
    config = DictConfig(copy.deepcopy(cfg["config"]))
    config["seed"] = seed
    config["training"]["train_batch_size"] = t["batch"]
    n = ranks.world()
    train, held = rank_trials(cell, seed, ranks.rank(), n, device)
    model = NAME2MODEL[config.model.model_class].from_config(
        config.model, device=device)
    split = {"train": [f"trial{i}" for i in range(t["train_trials"] * n)],
             "eid": {"val": [EID], "test": [EID]}}
    trainer = BaseTrainer(
        model=model, train_loader=ArrayLoader(*train, t["batch"]),
        eval_loader=ArrayLoader(*held, t["batch"]), test_loader=None,
        config=config, eid=EID, dataset_split_dict=split, log_dir=log_dir,
        seed=seed, device=device)
    return trainer, train, held


def start_weights(cell, ref, seed: int, device: torch.device,
                  program: dict) -> dict:
    """The benchmark's starting parameters, made from the seed by the
    configuration's init and loaded into the program's ``program`` leaves;
    returned on the host for the reference."""
    made = weights.make(ref.param_specs(cell.config),
                        ref.store_dtype(cell.config), seed, device)
    p0 = weights.load(program, made)
    del made
    return p0


class Session:
    """One built trainer with its step wrappers: the capture of the first
    steps, the step clock and the spans, and the epoch the window repeats."""

    def __init__(self, cell, seed: int, device: torch.device, log_dir: str,
                 fault=None):
        self.cell, self.device = cell, device
        self.ref = cell.reference()
        self.trainer, self.train, _ = build(cell, seed, device, log_dir)
        self.trainer._init_if_needed()
        p0 = start_weights(cell, self.ref, seed, device, self.trainer.params)
        if fault is not None:
            fault(self.trainer)
        self.first = FirstSteps(p0, fingerprint_index(self.train[0]),
                                self.ref, CAPTURE_STEPS)
        self.clock, self.spans = StepClock(device), Spans()
        timed = self.clock.wrap(self.first.wrap(self.trainer._step_fn))

        def spanned(*a):
            with self.spans.span("step"):
                return timed(*a)

        self.trainer._step_fn = spanned
        self.best = {"bps": -np.inf, "params": None}
        self.epoch_losses = []

    def epoch(self) -> None:
        """What ``BaseTrainer.train()`` does each epoch, without its
        logging and checkpoint writes."""
        tr = self.trainer
        with self.spans.span("train_epoch"):
            res = tr.train_epoch()
        self.epoch_losses.append(res["train_loss"])
        with self.spans.span("eval_epoch"):
            ev = tr.eval_epoch()
        bps = ev["eval_res"]["eval_bps"] if ev else -np.inf
        if bps > self.best["bps"]:
            with self.spans.span("best_copy"):
                self.best["bps"] = bps
                self.best["params"] = {k: v.clone()
                                       for k, v in tr.params.items()}

    def captured(self) -> dict:
        f = self.first
        return {"prog": {"losses": f.losses, "grad_norms": f.grad_norms,
                         "moments": f.moments,
                         "change_norms": f.change_norms},
                "p0": f.p0, "rows": f.rows, "seeds": f.seeds,
                "train": self.train}

    def free(self) -> None:
        """Drop the program's state so the reference runs on a free card."""
        self.trainer = self.best = self.first = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float, fault=None) -> tuple:
    """Set-up, window, optional traced slice, then the comparison.
    Returns ``(result without checks, numbers compared)`` on rank 0 and
    ``(None, None)`` on the other ranks of a multi-card cell. ``fault``
    (tests only) is called with the trainer after set-up has built it, to
    break the timed path underneath."""
    t = cell.traffic
    log_dir = tempfile.mkdtemp(prefix="bench_supervised_")
    try:
        ses = Session(cell, seed, device, log_dir, fault)
        for _ in range(t["warmup_epochs"]):
            ses.epoch()
        _sync(device)
        gc.freeze()        # set-up's objects leave the collector's scans
        setup_s = time.time() - t_process

        clock, spans = ses.clock, ses.spans
        clock.reset()
        spans.seconds = {}
        ses.epoch_losses.clear()
        t0 = time.perf_counter()
        # rank 0 decides: every rank runs the same epochs
        while ranks.from_rank0(time.perf_counter() - t0 < seconds):
            ses.epoch()
        _sync(device)
        window_s = time.perf_counter() - t0
        steps = clock.count
        step_ms = clock.times_ms()
        window_spans = dict(spans.seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        n_epochs = len(ses.epoch_losses)
        failed_epochs = sum(not np.isfinite(x) for x in ses.epoch_losses)

        traced, trace_steps, busy = None, 0, None
        if trace:
            traced, trace_steps = traced_slice(ses, t["trace_epochs"])
            busy = ranks.gather((traced.busy_s(), traced.window_s))
        peak = max(ranks.gather(peak))
        cap = ses.captured()
        shared = ranks.gather({"rows": cap["rows"],
                               "change": cap["prog"]["change_norms"]})
        ses.free()
        numbers = None
        if ranks.rank() == 0:
            numbers = compare_with_reference(cell, ses.ref, cap, device,
                                             seed, shared)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    if ranks.rank() != 0:
        return None, None

    b = t["batch"] * ranks.world()
    frames = steps * b * cell.config["video"]["frames"]
    info = RunInfo(cell=cell, steps=steps, window_s=window_s,
                   step_ms=step_ms, spans=window_spans, trace=traced,
                   trace_steps=trace_steps, busy_by_rank=busy,
                   flops_per_step=counts.linear_train_flops(
                       cell.config["config"]["model"], b),
                   fused_shape=fused_shape(cell.config, b))
    result = {
        "attempted": steps,
        "failed": failed_epochs * (steps // max(n_epochs, 1)),
        "end_to_end": {
            "train_frames_per_s": frames / window_s,
            "step_ms_p95": quantile(step_ms, 0.95),
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s},
        "peak_bytes": peak, "info": info}
    return result, numbers


def traced_slice(ses: Session, epochs: int):
    """``epochs`` more epochs under the profiler: (trace, steps)."""
    n0 = ses.clock.count
    ses.spans.profiling = True
    prof = tracing.profiler()
    with prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            _sync(ses.device)
            for _ in range(epochs):
                ses.epoch()
            _sync(ses.device)
    ses.spans.profiling = False
    return tracing.read(prof), ses.clock.count - n0


SR_KEY_SHIFT = 0x5BD1E995      # another stream of the store's rounding


def control_readings(cell, ref, p0: dict, want: dict, seeds, device,
                     controls) -> dict:
    """The compared numbers of the reference put in the program's place,
    against the reference, for each of ``controls``: ``fp8`` (every matmul
    in the nearest precision below the configurations' bf16: the control);
    ``half_batch`` (half of each batch left out, the mean over the rest);
    ``state_unchanged`` (no update); and two witnesses of what sound
    arithmetic reads: ``bf16`` (every matmul in bfloat16, as the program
    computes) and ``sr_key`` (the bf16 store's stochastic rounding drawn
    from another stream)."""
    out = {}
    for c in controls:
        kw, s = {}, seeds
        if c in ("fp8", "bf16"):
            kw["precision"] = c
        elif c == "sr_key":
            s = seeds and [(x ^ SR_KEY_SHIFT) & 0xFFFFFFFF for x in seeds]
        else:
            kw["fault"] = c
        got = ref.reference_steps(cell.config, cell.traffic, p0,
                                  want["batches"], s, device, **kw)
        out[c] = compare.training_numbers(got, want["ref"], cell.loss_steps,
                                          cell.quantiles, cell.leaves)
    return out


def readings(cell, seed: int, device: torch.device,
             controls=("fp8", "half_batch", "state_unchanged"),
             fault=None) -> dict:
    """For setting limits: the program's compared numbers at ``seed``
    after set-up's first steps (with ``fault`` planted in it, when given),
    and those of ``control_readings`` for each of ``controls``. Rank 0
    returns them; the other ranks of a multi-card cell return None."""
    log_dir = tempfile.mkdtemp(prefix="bench_readings_")
    try:
        ses = Session(cell, seed, device, log_dir, fault)
        ses.epoch()
        cap = ses.captured()
        shared = ranks.gather({"rows": cap["rows"],
                               "change": cap["prog"]["change_norms"]})
        ses.free()
        if ranks.rank() != 0:
            return None
        out = {"program": compare_with_reference(cell, ses.ref, cap, device,
                                                 seed, shared)}
        want = out["program"].pop("_want", None)
        out.update(control_readings(cell, ses.ref, cap["p0"], want,
                                    cap["seeds"], device, controls))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return out


def fused_shape(cfg: dict, batch: int):
    """(M, N, B) of the fused readout update, or None when the
    configuration does not run it."""
    if not cfg["config"]["optimizer"].get("fused_readout"):
        return None
    enc = cfg["config"]["model"]["encoder"]
    return enc["input_dim"], enc["hidden_dims"][0], batch


def compare_with_reference(cell, ref, cap: dict, device, seed: int,
                           shared=None) -> dict:
    """The reference's first steps from the benchmark's starting
    parameters on the same trials, and the numbers compared. Every trial a
    captured step took must be one of the benchmark's, and no trial twice. In a
    multi-rank run a step's batch is every rank's rows in rank order (each
    rank's trials made again here from the seed), and ``replica_gap`` is
    the widest relative gap of any rank's change norms from rank 0's: the
    replicas must stay bitwise equal."""
    shared = shared or [{"rows": cap["rows"],
                         "change": cap["prog"]["change_norms"]}]
    n = len(shared)
    flat = [(r, i) for r, sh in enumerate(shared) for st in sh["rows"]
            for i in st]
    unmatched = sum(i < 0 for _, i in flat) + (len(flat) - len(set(flat)))
    if unmatched or any(len(sh["rows"]) < CAPTURE_STEPS for sh in shared):
        return {"rows_unmatched": float(max(unmatched, 1))}
    data = [cap["train"]] + [rank_trials(cell, seed, r, n, device)[0]
                             for r in range(1, n)]
    batches = [(np.concatenate([data[r][0][shared[r]["rows"][k]]
                                for r in range(n)]),
                np.concatenate([data[r][1][shared[r]["rows"][k]]
                                for r in range(n)]))
               for k in range(CAPTURE_STEPS)]
    del data
    want = ref.reference_steps(cell.config, cell.traffic, cap["p0"],
                               batches, cap["seeds"], device)
    numbers = compare.training_numbers(cap["prog"], want, cell.loss_steps,
                                       cell.quantiles, cell.leaves)
    numbers["rows_unmatched"] = 0.0
    base = shared[0]["change"]
    numbers["replica_gap"] = max(
        (compare.norm_gap(sh["change"], base)[0] for sh in shared[1:]),
        default=0.0)
    numbers["_want"] = {"batches": batches, "ref": want}
    return numbers


class RunInfo:
    """What the per-layer metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
