#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``video_spike_torch``) on one H100.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. build: compile every hand-written kernel from ``video_spike_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit as ``nvidia-smi`` reports them;
2. kernel: each kernel against its plain PyTorch version on the card —
   bitwise on exact-sum inputs (including a flat index that wraps past
   2^32), within tolerance on random inputs at the main path's shape — and
   timed with CUDA events beside its bound;
3. main_path: ``python -m video_spike_torch.cli.train`` (called in-process)
   trains the full-width Linear model on a synthetic 128x128 session in
   the production configuration (bf16 SR store, lean adafactor, fused
   readout), then resumes for one more epoch; the kernel's launch count
   must equal the train steps; then ms/step over staged steps;
4. vtt_main_path: ``cli.train --eid <5 sessions>`` trains the VTT flagship
   (``configs/{model,train}/vtt_video.yaml``, full width, 10,264,188
   parameters) on five synthetic 128x128 sessions of 668, 600, 500, 400
   and 300 neurons for 2 epochs at batch 16, then resumes for one more;
5. vtt_card_vs_cpu: one trial through the VTT forward on the card (bf16 and
   f32 models) against the same weights in f32 on the CPU;
6. vtt_step_time: ms/step of the staged VTT train step (CUDA events),
   frames/s, peak memory, model TFLOP/step and its share of the bf16 peak;
7. rrr_main_path: ``cli.create_eid_data --input_mod me`` then
   ``cli.train_rrr --device cuda`` on a synthetic session of 668 neurons and
   80 trials, and the same fit on the CPU, whose mean bps must agree;
8. ssl_main_path: ``cli.create_eid_data`` whisker-video features of a
   40-trial session (4,800 pretrain frames, kept in memory: the card's
   machine has no ``h5py``), then ContrastViTMAE pretraining at full width
   (``configs/model/vit_mae/vit_mae.yaml``, 111,002,116 parameters,
   ``configs/train/vmae_video.yaml``, batch 128 triplets = 384 frames of
   144×144): a first run stopped mid-epoch at step 20, then
   ``cli.pretrain --resume`` to step 60 with two nested-RRR validations,
   then ``cli.test --model cm``;
9. ssl_card_vs_cpu: the ContrastViTMAE forward on the card (bf16 and f32)
   against the same weights in f32 on the CPU with the same mask noise, and
   ``device_frame_transform`` on the card against the CPU at 106×160 and
   64×96;
10. ssl_step_time: ms/step of the staged SSL train step (frame cache live),
    frames/s, peak memory, model TFLOP/step and its share of the bf16 peak;
11. a ``{"kernels": [...]}`` line (the fused readout runs on the Linear
    path only; the VTT, RRR and SSL paths must launch it 0 times);
12. last line: ``{"ok": true, "device": {...}}``.

Any failure is an uncaught exception and a non-zero exit. Without a CUDA
card, or without the rest of the repository beside it, it exits non-zero
and prints no result. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet (dense): HBM bandwidth, non-tensor-core f32 rate and
# the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# main path (bench.py's production Linear workload)
T_FRAMES, HEIGHT, WIDTH = 120, 128, 128
N_NEURONS = 436
BATCH = 16
N_TRIALS = 40
KERNEL_M, KERNEL_N = T_FRAMES * HEIGHT * WIDTH, 256
WRAP_M = (1 << 24) + 37      # row*N+col passes 2^32 at N=256
SEEDS = (0, 7, (1 << 32) - 1)
REPS = 3                     # timing windows per measurement

# VTT flagship (bench.py:bench_vtt_flagship): 5 sessions, N_max = 668
VTT_NEURONS = (668, 600, 500, 400, 300)
VTT_EIDS = tuple(f"vtt{i}sess0" for i in range(len(VTT_NEURONS)))
VTT_TRIALS = 16              # per session: 12 train, 2 val, 2 test
VTT_PARAMS = 10_264_188
VTT_STEPS = 20               # staged steps per timing window
# card vs CPU, max |card - cpu| / max |cpu| on one trial: a bf16 model
# rounds at ~0.5% (CPU estimate at 10 frames: 0.5%); an f32 model on the
# card differs from the CPU only by summation order unless TF32 is on
VTT_BF16_REL_BOUND = 2e-2
VTT_F32_REL_BOUND = 1e-4

# RRR (cli/train_rrr.py on motion energy): one session, 64 train trials
RRR_EID = "rrrsess00"
RRR_NEURONS = 668
RRR_TRIALS = 80
# mean co-bps of the card's fit against the CPU's: float32 ALS solves with
# TF32 off; the normal equations are ill-conditioned, so the two orders of
# summation may part in the 4th decimal, not more
RRR_CPU_BPS_BOUND = 1e-3

# SSL (cli/pretrain.py --model cm): configs/model/vit_mae/vit_mae.yaml +
# configs/train/vmae_video.yaml at batch 128 triplets (bench.py:103-148)
SSL_EID = "sslsess00"
SSL_TRIALS = 40              # 32 train, 4 val, 4 test; 4,800 frames
SSL_NEURONS = 668
SSL_BATCH = 128
SSL_PARAMS = 111_002_116
SSL_FIRST_STEPS = 20         # the first run stops mid-epoch (38 batches)
SSL_MAX_STEPS = 60           # the resumed run validates at 38 and 60
SSL_STEPS = 10               # staged steps per timing window
SSL_CARD_FRAMES = 4          # frames in the card-vs-CPU forward
# card vs CPU on z and the recon loss, max |card - cpu| / max |cpu|: a bf16
# model rounds at ~0.5-0.8% (CPU bf16 against CPU f32 at full width: 0.53%
# on z, 0.04% on the loss, 0.84% on z at mask 0); f32 differs by summation
# order only, with TF32 off
SSL_BF16_REL_BOUND = 2e-2
SSL_F32_REL_BOUND = 1e-4
# antialiased resize, card vs CPU, in [-1, 1] units: the card's kernel
# forms its taps in another order (measured 1.21e-5 at 106x160 on an H100);
# 3e-5 is under 1% of one uint8 level (2/255 in these units)
RESIZE_ABS_BOUND = 3e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from video_spike_torch.ops import cuda_lib

    sources = sorted(p.name for p in cuda_lib.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    report = cuda_lib.build(sources)
    seconds = time.perf_counter() - t0
    smi = nvidia_smi_line()
    print(smi, flush=True)
    ptxas = {s: [l.strip() for l in r["ptxas"].splitlines()
                 if "registers" in l or "spill" in l]
             for s, r in report.items()}
    emit("build", sources=sources, seconds=seconds,
         per_source={s: r["seconds"] for s, r in report.items()},
         ptxas=ptxas, nvidia_smi=smi)
    return {"seconds": seconds, "nvidia_smi": smi}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _bits(t):
    import torch

    return t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def _sr_compare(got, ref, xa, dzc) -> dict:
    """Bitwise share, raw ulp distance, and the tolerance check: every
    element within 1 bf16 ulp at max(|a|, |b|) plus the f32 error bound of
    the B-term sum, B * 2^-24 * (|xa|^T @ |dzc|) (where W + upd cancels to
    near zero the bf16 ulp is finer than that error)."""
    import torch

    m = got.shape[0]
    b = xa.shape[0]
    n_equal, max_ulp, n_outside, max_abs = 0, 0, 0, 0.0
    step = max(1, (1 << 24) // got.shape[1])
    for r0 in range(0, m, step):
        r1 = min(r0 + step, m)
        ga, gb = _bits(got[r0:r1]), _bits(ref[r0:r1])
        n_equal += int((ga == gb).sum())

        def ordered(u):
            return torch.where(u >= 0x8000, -(u & 0x7FFF), u)

        max_ulp = max(max_ulp, int((ordered(ga) - ordered(gb)).abs().max()))
        fa, fb = got[r0:r1].float(), ref[r0:r1].float()
        big = torch.maximum(fa.abs(), fb.abs()).clamp_min(1e-38)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        err = b * 2.0**-24 * (xa[:, r0:r1].abs().T @ dzc.abs())
        diff = (fa - fb).abs()
        n_outside += int((diff > ulp + err).sum())
        max_abs = max(max_abs, float(diff.max()))
    total = got.numel()
    return {"frac_bitwise": n_equal / total, "max_ulp": max_ulp,
            "n_outside_tolerance": n_outside, "max_abs_err": max_abs}


def phase_kernel() -> dict:
    import torch

    from video_spike_torch.ops import fused_readout as fr

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    b, n = BATCH, KERNEL_N

    def exact_factors(m):
        # small integers times powers of two: every f32 B-term sum is exact
        # in any order, at ~2^-10 of W's scale so SR still rounds
        xa = torch.randint(-7, 8, (b, m), generator=gen, device=dev)
        dzc = torch.randint(-7, 8, (b, n), generator=gen, device=dev)
        return xa.float() * 2.0**-8, dzc.float() * 2.0**-12

    # (a) bitwise on exact sums, ragged M and an M whose index wraps 2^32
    bitwise = []
    for m in (4133, WRAP_M):
        w0 = torch.randn(m, n, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        xa, dzc = exact_factors(m)
        for seed in SEEDS:
            ref = fr._apply_scaled_outer_plain(w0, xa, dzc, seed)
            w = w0.clone()
            fr.apply_scaled_outer(w, xa, dzc, seed)
            torch.cuda.synchronize()
            equal = bool(torch.equal(w.view(torch.int16),
                                     ref.view(torch.int16)))
            bitwise.append({"m": m, "seed": seed, "bitwise": equal})
            if not equal:
                raise AssertionError(f"kernel != plain on exact sums: "
                                     f"M={m}, seed={seed}")
            del ref, w
        del w0, xa, dzc
        torch.cuda.empty_cache()

    # (b) random normal inputs at the main path's shape
    m = KERNEL_M
    w0 = torch.randn(m, n, generator=gen, device=dev, dtype=torch.bfloat16)
    xa = torch.randn(b, m, generator=gen, device=dev) * 1e-2
    dzc = torch.randn(b, n, generator=gen, device=dev) * 1e-2
    ref = fr._apply_scaled_outer_plain(w0, xa, dzc, 3)
    w = w0.clone()
    fr.apply_scaled_outer(w, xa, dzc, 3)
    torch.cuda.synchronize()
    cmp = _sr_compare(w, ref, xa, dzc)
    if cmp["frac_bitwise"] < 0.999 or cmp["n_outside_tolerance"]:
        raise AssertionError(f"kernel vs plain at the Linear shape: {cmp}")
    del ref

    # (c) timing at the main path's shape (W is 1 GB, far above L2); the
    # median of REPS windows, each window printed so its spread shows
    kernel_windows = [cuda_ms(lambda: fr.apply_scaled_outer(w, xa, dzc, 3),
                              20, 3) for _ in range(REPS)]
    kernel_ms = statistics.median(kernel_windows)
    plain_ms = cuda_ms(lambda: fr._apply_scaled_outer_plain(w, xa, dzc, 3),
                       3, 1)
    nbytes = 2 * m * n * 2 + b * m * 4 + b * n * 4
    flops = 2 * b * m * n
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOP_PER_S * 1e3
    result = {
        "name": "apply_scaled_outer",
        "route": "cuda",
        "source": "video_spike_torch/csrc/fused_readout.cu",
        "replaces": "video_spike_tpu/ops/fused_readout.py:161",
        "max_abs_err": cmp["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                     else "operations"),
        "library_ms": None,
    }
    emit("kernel", kernel="apply_scaled_outer", shape=[m, n, b],
         exact_sum_cases=bitwise, random_inputs=cmp, kernel_ms=kernel_ms,
         kernel_ms_windows=kernel_windows, plain_ms=plain_ms, bound_ms=result["bound_ms"],
         bound_bytes=nbytes, bound_flops=flops,
         launches_in_checks=fr.apply_scaled_outer.launches)
    del w, w0, xa, dzc
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 3: the main path through the port's entry points
# ---------------------------------------------------------------------------

PRODUCTION_OPTIMIZER = {
    "name": "adafactor",
    "param_scale": False,
    "clipping": None,
    "param_dtype": "bfloat16_sr",
    "fused_readout": True,
}


def _train_yaml(work: Path) -> Path:
    """configs/train/linear_video.yaml with the production optimizer."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs/train/linear_video.yaml")
                         .read_text())
    cfg["optimizer"].update(PRODUCTION_OPTIMIZER)
    path = work / "train_linear_video_production.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase_main_path(work: Path) -> dict:
    import numpy as np
    import torch

    from video_spike_torch.cli import make_fixture
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.ops import fused_readout as fr

    data = work / "data"
    logs = work / "logs"
    eid = "smokeeid0"
    make_fixture.main(["--out", str(data), "--eid", eid,
                       "--n_trials", str(N_TRIALS),
                       "--n_neurons", str(N_NEURONS),
                       "--height", str(HEIGHT), "--width", str(WIDTH)])
    train_yaml = _train_yaml(work)
    base = ["--model_config", str(ROOT / "configs/model/linear_video.yaml"),
            "--train_config", str(train_yaml), "--eid", eid,
            "--data_dir", str(data), "--log_dir", str(logs),
            "--batch_size", str(BATCH), "--device", "cuda"]

    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    t0 = time.perf_counter()
    res = train_cli.main(base + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["global_step"]
    if not res["fused_readout"]:
        raise AssertionError("the fused readout step was not engaged")
    if launches != steps or steps == 0:
        raise AssertionError(f"kernel launches {launches} != train steps "
                             f"{steps}")
    losses = res["train_losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    evals = res["eval_history"]
    if not evals or not all(math.isfinite(e[k]) for e in evals
                            for k in ("eval_loss", "eval_bps",
                                      "eval_rsquared")):
        raise AssertionError(f"eval metrics missing or not finite: {evals}")
    test_res = res["test_res"]
    for key in ("test_bps", "test_rsquared", "test_loss"):
        if not math.isfinite(test_res[key]):
            raise AssertionError(f"{key} not finite: {test_res[key]}")
    log_dir = Path(res["log_dir"])
    artifacts = {name: (log_dir / name).exists()
                 for name in ("model_best.pt", "model_last.pt",
                              "test_results.npy")}
    if not all(artifacts.values()):
        raise AssertionError(f"missing artifacts: {artifacts}")
    saved = np.load(log_dir / "test_results.npy", allow_pickle=True).item()
    preds = saved["test_preds"][0]
    if preds.shape[1:] != (100, N_NEURONS) or not np.isfinite(preds).all():
        raise AssertionError(f"test preds {preds.shape} not finite/shaped")

    # resume: one more epoch from model_last
    fr.apply_scaled_outer.launches = 0
    res2 = train_cli.main(base + ["--num_epochs", "3", "--resume"])
    torch.cuda.synchronize()
    resumed_steps = res2["global_step"] - steps
    if res2["start_epoch"] != 2 or resumed_steps <= 0 \
            or fr.apply_scaled_outer.launches != resumed_steps:
        raise AssertionError(
            f"resume: start_epoch {res2['start_epoch']}, steps "
            f"{steps}->{res2['global_step']}, launches "
            f"{fr.apply_scaled_outer.launches}")
    out = {"train_steps": steps, "launches": launches,
           "train_losses": losses, "best_eval_bps": res["best_eval_bps"],
           "eval": res["eval_history"], "test": test_res,
           "artifacts": artifacts, "train_seconds": train_s,
           "peak_mem_gb": peak_gb, "resume_start_epoch": res2["start_epoch"],
           "resume_steps": resumed_steps,
           "resume_global_step": res2["global_step"]}
    emit("main_path", **out)
    return out


def phase_step_time(work: Path) -> dict:
    """ms/step of the staged fused train step, CUDA events over REPS
    windows of 20 steps (the median and every window), through the same
    trainer the CLI builds."""
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    args = get_args(
        ["--model_config", str(ROOT / "configs/model/linear_video.yaml"),
         "--train_config", str(_train_yaml(work)), "--eid", "smokeeid0",
         "--data_dir", str(work / "data"), "--log_dir", str(work / "timing"),
         "--batch_size", str(BATCH), "--device", "cuda"])
    trainer = train_cli.build_trainer(args)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_epoch()                         # stages data, warms up
    epochs = 10
    windows = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        step0 = trainer.global_step
        torch.cuda.synchronize()
        start.record()
        for _ in range(epochs):
            trainer.train_epoch()
        end.record()
        torch.cuda.synchronize()
        steps = trainer.global_step - step0
        windows.append(start.elapsed_time(end) / steps)
    ms = statistics.median(windows)
    out = {"ms_per_step": ms, "ms_per_step_windows": windows,
           "steps_per_window": steps, "batch": BATCH,
           "frames_per_s": BATCH * T_FRAMES / (ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("step_time", **out)
    return out


# ---------------------------------------------------------------------------
# phases 4-6: the VTT flagship
# ---------------------------------------------------------------------------

def vtt_fixture(data: Path) -> None:
    from video_spike_torch.cli import make_fixture

    for i, (eid, n) in enumerate(zip(VTT_EIDS, VTT_NEURONS)):
        make_fixture.main(["--out", str(data), "--eid", eid,
                           "--n_trials", str(VTT_TRIALS),
                           "--n_neurons", str(n), "--seed", str(100 + i),
                           "--height", str(HEIGHT), "--width", str(WIDTH)])


def vtt_args(work: Path, log_dir: str) -> list:
    return ["--model_config", str(ROOT / "configs/model/vtt_video.yaml"),
            "--train_config", str(ROOT / "configs/train/vtt_video.yaml"),
            "--eid", ",".join(VTT_EIDS), "--data_dir", str(work / "vtt_data"),
            "--log_dir", str(work / log_dir), "--batch_size", str(BATCH),
            "--device", "cuda"]


def vtt_model_config() -> dict:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs/model/vtt_video.yaml").read_text())
    cfg.update(n_sessions=len(VTT_NEURONS), max_neurons=max(VTT_NEURONS))
    return cfg


def vtt_forward_flops(cfg: dict, batch: int, image: int = HEIGHT,
                      channels: int = 1) -> int:
    """Matmul FLOPs of one VTT forward from the configuration's shapes
    (patchify, qkv, scores, P·V, proj and MLP of every block, the
    resample and the session heads)."""
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    p = cfg["patch_size"]
    t = len(range(0, cfg["t_frames"], cfg.get("frame_stride", 1)))
    tokens = (image // p) ** 2

    def block(rows: int, seq: int) -> int:
        n = rows * seq
        return (2 * n * d * 3 * d + 2 * 2 * rows * seq * seq * d
                + 2 * n * d * d + 2 * 2 * n * d * m)

    return (2 * batch * t * tokens * p * p * channels * d
            + cfg["frame_depth"] * block(batch * t, tokens)
            + cfg["temporal_depth"] * block(batch, t)
            + 2 * batch * t * cfg["t_bins"] * d
            + 2 * batch * cfg["t_bins"] * d * cfg["max_neurons"])


def phase_vtt_main_path(work: Path) -> dict:
    import numpy as np
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.ops import fused_readout as fr

    vtt_fixture(work / "vtt_data")
    base = vtt_args(work, "vtt_logs")
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    t0 = time.perf_counter()
    res = train_cli.main(base + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fused_launches = fr.apply_scaled_outer.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if res["n_params"] != VTT_PARAMS:
        raise AssertionError(f"VTT has {res['n_params']} params, "
                             f"want {VTT_PARAMS}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    losses = res["train_losses"]
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses: {losses}")
    evals = res["eval_history"]
    if not all(math.isfinite(e[k]) for e in evals
               for k in ("eval_bps", "eval_rsquared")):
        raise AssertionError(f"eval metrics not finite: {evals}")
    test = res["test"]
    if set(test["per_session"]) != set(VTT_EIDS) or not all(
            math.isfinite(r[k]) for r in test["per_session"].values()
            for k in ("bps", "rsquared")):
        raise AssertionError(f"test per session: {test['per_session']}")
    log_dir = Path(res["log_dir"])
    artifacts = {name: (log_dir / name).exists()
                 for name in ("model_best.pt", "model_last.pt",
                              "test_results.npy")}
    if not all(artifacts.values()):
        raise AssertionError(f"missing artifacts: {artifacts}")
    saved = np.load(log_dir / "test_results.npy", allow_pickle=True).item()
    if set(saved["per_session"]) != set(VTT_EIDS):
        raise AssertionError(f"test_results.npy: {saved}")

    res2 = train_cli.main(base + ["--num_epochs", "3", "--resume"])
    torch.cuda.synchronize()
    resumed_steps = res2["global_step"] - res["global_step"]
    if res2["start_epoch"] != 2 or resumed_steps <= 0 \
            or not math.isfinite(res2["train_losses"][0]):
        raise AssertionError(f"resume: start_epoch {res2['start_epoch']}, "
                             f"steps {resumed_steps}, losses "
                             f"{res2['train_losses']}")
    out = {"n_params": res["n_params"], "train_steps": res["global_step"],
           "train_losses": losses, "eval": evals,
           "best_eval_bps": res["best_eval_bps"],
           "test_bps": test["test_bps"], "test_rsquared": test["test_rsquared"],
           "artifacts": artifacts, "train_seconds": train_s,
           "peak_mem_gb": peak_gb, "allow_tf32": False,
           "fused_readout_launches": fused_launches,
           "resume_start_epoch": res2["start_epoch"],
           "resume_steps": resumed_steps,
           "resume_train_loss": res2["train_losses"][0]}
    emit("vtt_main_path", **out)
    return out


def phase_vtt_card_vs_cpu() -> dict:
    """One trial through the VTT forward on the card, in bf16 (the
    production dtype) and in f32, against the same weights in f32 on the
    CPU; the error is max |card - cpu| / max |cpu|."""
    import numpy as np
    import torch

    from video_spike_torch.convert import load_into_model
    from video_spike_torch.models.vtt import VideoTemporalTransformer

    cfg = vtt_model_config()
    cpu = VideoTemporalTransformer.from_config(cfg, dtype=torch.float32)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    weights = dict(cpu.named_parameters())
    rng = np.random.default_rng(1)
    video = torch.from_numpy(rng.integers(
        0, 255, (1, T_FRAMES, 1, HEIGHT, WIDTH), dtype=np.uint8))
    sids = torch.tensor([3])
    with torch.no_grad():
        ref = cpu(video, sids)
        errs = {}
        for name, dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            card = VideoTemporalTransformer.from_config(
                cfg, dtype=dtype, device="cuda")
            load_into_model(card, weights)
            got = card(video.cuda(), sids.cuda()).cpu()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: {tuple(got.shape)} or "
                                     f"not finite")
            errs[name] = float((got - ref).abs().max() / ref.abs().max())
    out = {"shape": list(ref.shape), "max_rel_err_bf16": errs["bf16"],
           "bound_bf16": VTT_BF16_REL_BOUND, "max_rel_err_f32": errs["f32"],
           "bound_f32": VTT_F32_REL_BOUND}
    emit("vtt_card_vs_cpu", **out)
    if errs["bf16"] > VTT_BF16_REL_BOUND or errs["f32"] > VTT_F32_REL_BOUND:
        raise AssertionError(f"VTT card vs CPU beyond its bound: {out}")
    return out


def phase_vtt_step_time(work: Path) -> dict:
    """ms/step of the staged VTT train step at batch 16: CUDA events over
    REPS windows of VTT_STEPS steps (the median and every window), through
    the trainer the CLI builds."""
    import numpy as np
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    trainer = train_cli.build_trainer(get_args(vtt_args(work, "vtt_timing")))
    torch.cuda.reset_peak_memory_stats()
    trainer.train_epoch()                         # stages data, warms up
    idx = np.random.default_rng(0).permutation(trainer._n_train)[:BATCH]
    windows = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(VTT_STEPS):
            trainer.staged_step(idx, BATCH)
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / VTT_STEPS)
    ms = statistics.median(windows)
    tflop = 3 * vtt_forward_flops(vtt_model_config(), BATCH) / 1e12
    out = {"ms_per_step": ms, "ms_per_step_windows": windows,
           "steps_per_window": VTT_STEPS, "batch": BATCH,
           "frames_per_s": BATCH * T_FRAMES / (ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_tflop_per_step": tflop,
           "bf16_peak_share": tflop * 1e12 / (ms / 1e3) / BF16_FLOP_PER_S}
    emit("vtt_step_time", **out)
    return out


# ---------------------------------------------------------------------------
# phase 7: RRR
# ---------------------------------------------------------------------------

def _rrr_args() -> list:
    return ["--model_config", str(ROOT / "configs/model/linear_me.yaml"),
            "--train_config", str(ROOT / "configs/train/rrr.yaml")]


def phase_rrr_main_path(work: Path) -> dict:
    """``cli.create_eid_data --input_mod me`` and ``cli.train_rrr`` on the
    card, then the same fit on the CPU. The CLIs write ``data/...`` and
    ``me_result.npy`` relative to the working directory."""
    import numpy as np
    import torch

    from video_spike_torch.cli import create_eid_data, make_fixture, train_rrr
    from video_spike_torch.ops import fused_readout as fr

    run = work / "rrr"
    (run / "data").mkdir(parents=True)
    (run / "data/eid.txt").write_text(f"{RRR_EID}\n")
    make_fixture.main(["--out", str(run / "fixture"), "--eid", RRR_EID,
                       "--n_trials", str(RRR_TRIALS),
                       "--n_neurons", str(RRR_NEURONS),
                       "--height", "32", "--width", "32"])
    args = _rrr_args() + ["--input_mod", "me"]
    with contextlib.chdir(run):
        create_eid_data.main(args + ["--data_dir", str(run / "fixture")])
        fr.apply_scaled_outer.launches = 0
        t0 = time.perf_counter()
        card = train_rrr.main(args + ["--device", "cuda"])[RRR_EID]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fr.apply_scaled_outer.launches
        if not (run / "me_result.npy").exists():
            raise AssertionError("me_result.npy not written")
        cpu = train_rrr.main(args + ["--device", "cpu"])[RRR_EID]
    bps, r2 = np.asarray(card["co_bps"]), np.asarray(card["r2"])
    if bps.shape != (RRR_NEURONS,) or not np.isfinite(np.nanmean(bps)) \
            or not np.isfinite(np.nanmean(r2)):
        raise AssertionError(f"RRR co-bps / R2 not finite: {bps.shape}")
    mean_card = float(np.nanmean(bps))
    mean_cpu = float(np.nanmean(cpu["co_bps"]))
    out = {"neurons": RRR_NEURONS, "trials": RRR_TRIALS,
           "mean_co_bps": mean_card, "mean_r2": float(np.nanmean(r2)),
           "finite_neurons": int(np.isfinite(bps).sum()),
           "cpu_mean_co_bps": mean_cpu,
           "card_minus_cpu": mean_card - mean_cpu,
           "bound": RRR_CPU_BPS_BOUND, "fit_seconds": seconds,
           "fused_readout_launches": launches}
    emit("rrr_main_path", **out)
    if abs(mean_card - mean_cpu) > RRR_CPU_BPS_BOUND or launches:
        raise AssertionError(f"RRR card vs CPU or launches: {out}")
    return out


# ---------------------------------------------------------------------------
# phases 8-10: SSL
# ---------------------------------------------------------------------------

def ssl_args(work: Path, log_dir: str, max_steps: int) -> list:
    return ["--model_config", str(ROOT / "configs/model/vit_mae/vit_mae.yaml"),
            "--train_config", str(ROOT / "configs/train/vmae_video.yaml"),
            "--eid", SSL_EID, "--model", "cm",
            "--batch_size", str(SSL_BATCH), "--max_steps", str(max_steps),
            "--log_dir", str(work / log_dir), "--device", "cuda"]


def ssl_data(work: Path) -> dict:
    """A synthetic 40-trial session's whisker-video features, built by
    ``cli.create_eid_data`` and kept in memory in the h5's layout."""
    from video_spike_torch.cli import create_eid_data, make_fixture

    (work / "data").mkdir(parents=True, exist_ok=True)
    (work / "data/eid.txt").write_text(f"{SSL_EID}\n")
    make_fixture.main(["--out", str(work / "fixture"), "--eid", SSL_EID,
                       "--n_trials", str(SSL_TRIALS),
                       "--n_neurons", str(SSL_NEURONS),
                       "--height", "32", "--width", "32"])
    with contextlib.chdir(work):
        _, raw = create_eid_data.build(
            _rrr_args() + ["--input_mod", "whisker-video",
                           "--data_dir", str(work / "fixture")])
    return create_eid_data.split_dict(raw)


def _free_card() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def vit_mae_forward_flops(cfg: dict, frames: int) -> int:
    """Matmul FLOPs of one ViT-MAE forward at the config's mask ratio:
    patch embedding of every patch, the encoder over the kept patches +
    CLS, the decoder embedding, the decoder over every patch + CLS, the
    pixel head and the projection."""
    p, c = cfg["patch_size"], cfg["num_channels"]
    d, dd = cfg["hidden_size"], cfg["decoder_hidden_size"]
    L = (cfg["image_size"] // p) ** 2
    enc_seq = int(L * (1 - cfg["mask_ratio"])) + 1
    dec_seq = L + 1

    def block(seq: int, dim: int, mlp: int) -> int:
        n = frames * seq
        return (2 * n * dim * 3 * dim + 2 * 2 * frames * seq * seq * dim
                + 2 * n * dim * dim + 2 * 2 * n * dim * mlp)

    return (2 * frames * L * p * p * c * d
            + cfg["num_hidden_layers"] * block(enc_seq, d,
                                               cfg["intermediate_size"])
            + 2 * frames * enc_seq * d * dd
            + cfg["decoder_num_hidden_layers"] * block(
                dec_seq, dd, cfg["decoder_intermediate_size"])
            + 2 * frames * dec_seq * dd * p * p * c
            + 2 * frames * d * cfg["embed_size"])


def phase_ssl_main_path(work: Path) -> tuple:
    """A first pretraining run stopped mid-epoch at step 20 (the state a
    preempted run leaves), then ``cli.pretrain --resume`` to step 60 and
    ``cli.test``. Returns (the phase's numbers, the features)."""
    import numpy as np
    import torch

    from video_spike_torch.cli import pretrain, test
    from video_spike_torch.ops import fused_readout as fr

    run = work / "ssl"
    data = ssl_data(run)
    n_frames = sum(data[SSL_EID][f"{s}_X"].shape[0]
                   * data[SSL_EID][f"{s}_X"].shape[1]
                   for s in ("train", "val", "test"))
    args = ssl_args(run, "logs", SSL_MAX_STEPS)
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    with contextlib.chdir(run):
        _, trainer, _, _ = pretrain.build_trainer(args, data)
        trainer.max_steps = SSL_FIRST_STEPS
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first = {"n_params": trainer.n_params,
                 "losses": list(trainer.train_losses),
                 "val": list(trainer.val_history),
                 "frame_cache": trainer._frame_cache is not None}
        log_dir = Path(trainer.log_dir)
        del trainer
        _free_card()
        t0 = time.perf_counter()
        res = pretrain.main(args + ["--resume"], data=data)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        (log_dir.parent / "40000").symlink_to(log_dir)
        test_bps = test.main(args, data=data)
        embeddings = np.load(res["path"], allow_pickle=True).item()[SSL_EID]
    launches = fr.apply_scaled_outer.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _free_card()
    losses = first["losses"] + res["train_losses"]
    vals = [v["val_bps"] for v in first["val"] + res["val_history"]]
    artifacts = {name: (log_dir / name).exists()
                 for name in ("best_model.pt", "best_model.meta.json",
                              "last_model.pt", "last_model.sampler.json")}
    artifacts[res["path"]] = (run / res["path"]).exists()
    out = {"n_params": first["n_params"], "pretrain_frames": n_frames,
           "batch_triplets": SSL_BATCH, "frame_cache": first["frame_cache"],
           "first_run_steps": len(first["losses"]),
           "resume_start_step": res["start_step"],
           "resumed_steps": res["steps"], "val_bps": vals,
           "validations": len(vals), "best_bps": res["best_bps"],
           "losses_first_last": [losses[0], losses[-1]],
           "test_bps": test_bps,
           "train_emb_shape": list(embeddings["X"][0].shape),
           "artifacts": artifacts, "first_run_seconds": first_s,
           "resumed_run_seconds": resumed_s, "peak_mem_gb": peak_gb,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "fused_readout_launches": launches}
    emit("ssl_main_path", **out)
    if first["n_params"] != SSL_PARAMS:
        raise AssertionError(f"ContrastViTMAE has {first['n_params']} "
                             f"params, want {SSL_PARAMS}")
    if not first["frame_cache"]:
        raise AssertionError("the frame cache was not staged")
    if len(losses) != SSL_MAX_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{len(losses)} losses, or not finite")
    if res["start_step"] != SSL_FIRST_STEPS \
            or res["steps"] != SSL_MAX_STEPS - SSL_FIRST_STEPS:
        raise AssertionError(f"resume: {res['start_step']}, {res['steps']}")
    if len(res["val_history"]) < 2 or not all(map(math.isfinite, vals)):
        raise AssertionError(f"validations: {vals}")
    if not all(artifacts.values()):
        raise AssertionError(f"missing artifacts: {artifacts}")
    if out["train_emb_shape"] != [32, 120, 3] \
            or not np.isfinite(embeddings["X"][0]).all():
        raise AssertionError(f"embeddings: {out['train_emb_shape']}")
    if len(test_bps) != 1 or not math.isfinite(test_bps[0]):
        raise AssertionError(f"cli.test bps: {test_bps}")
    if launches or out["allow_tf32"]:
        raise AssertionError("fused readout launched or TF32 on")
    return out, data


def phase_ssl_card_vs_cpu() -> dict:
    """The full-width ContrastViTMAE forward on the card, in bf16 and f32,
    against the same weights in f32 on the CPU with the same mask noise;
    and the frame transform on the card against the CPU."""
    import numpy as np
    import torch
    import yaml

    from video_spike_torch.convert import load_into_model
    from video_spike_torch.data.contrast import device_frame_transform
    from video_spike_torch.models.vit_mae import ContrastViTMAE

    cfg = yaml.safe_load((ROOT / "configs/model/vit_mae/vit_mae.yaml")
                         .read_text())
    rng = np.random.default_rng(2)
    resize, resized = {}, {}
    for h, w in ((106, 160), (64, 96)):
        frames = torch.from_numpy(rng.integers(
            0, 256, (SSL_CARD_FRAMES, 1, h, w), dtype=np.uint8))
        ref = device_frame_transform(frames, cfg["image_size"])
        got = device_frame_transform(frames.cuda(), cfg["image_size"]).cpu()
        resize[f"{h}x{w}"] = float((got - ref).abs().max())
        resized[f"{h}x{w}"] = ref
    cpu = ContrastViTMAE.from_config(cfg, dtype=torch.float32)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    weights = dict(cpu.named_parameters())
    x = resized["64x96"]                         # the fixture's crop size
    L = (cfg["image_size"] // cfg["patch_size"]) ** 2
    noise = torch.from_numpy(rng.random((SSL_CARD_FRAMES, L),
                                        dtype=np.float32))
    errs = {}
    with torch.no_grad():
        want = cpu(x, noise=noise)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            card = ContrastViTMAE.from_config(cfg, device="cuda", dtype=dtype)
            load_into_model(card, weights)
            got = card(x.cuda(), noise=noise.cuda())
            for k in ("z", "recon_loss"):
                g = got[k].float().cpu()
                if not torch.isfinite(g).all() or g.shape != want[k].shape:
                    raise AssertionError(f"{name} {k}: {g}")
                errs[f"{name}_{k}"] = float((g - want[k]).abs().max()
                                            / want[k].abs().max())
            del card
    _free_card()
    out = {"frames": SSL_CARD_FRAMES, "max_rel_err": errs,
           "bound_bf16": SSL_BF16_REL_BOUND, "bound_f32": SSL_F32_REL_BOUND,
           "resize_max_abs_err": resize, "resize_bound": RESIZE_ABS_BOUND}
    emit("ssl_card_vs_cpu", **out)
    if any(v > SSL_BF16_REL_BOUND for k, v in errs.items()
           if k.startswith("bf16")) or any(
               v > SSL_F32_REL_BOUND for k, v in errs.items()
               if k.startswith("f32")) or max(resize.values()) \
            > RESIZE_ABS_BOUND:
        raise AssertionError(f"SSL card vs CPU beyond its bound: {out}")
    return out


def ssl_staged_trainer(work: Path, data: dict, log_dir: str):
    """(trainer with the frame cache live, one staged (3, 128) index
    batch), built as ``cli.pretrain`` builds it."""
    from video_spike_torch.cli import pretrain

    with contextlib.chdir(work):
        _, trainer, _, _ = pretrain.build_trainer(
            ssl_args(work, log_dir, SSL_MAX_STEPS), data)
    trainer._init_if_needed()
    if not trainer._maybe_stage_frames():
        raise AssertionError("the frame cache was not staged")
    batch = next(trainer.data_loader.dataset.iter_index_batches(SSL_BATCH))
    return trainer, trainer._stage_index_batch(batch)


def phase_ssl_step_time(work: Path, data: dict) -> dict:
    """ms/step of the staged SSL train step (frame cache live, batch 128
    triplets): CUDA events over REPS windows of SSL_STEPS steps (the median
    and every window), through the trainer ``cli.pretrain`` builds."""
    import torch
    import yaml

    trainer, staged = ssl_staged_trainer(work / "ssl", data, "timing")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):                                 # warm up
        trainer._step_staged(staged, 0)
    windows = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(SSL_STEPS):
            trainer._step_staged(staged, 0)
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / SSL_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del trainer, staged
    _free_card()
    ms = statistics.median(windows)
    cfg = yaml.safe_load((ROOT / "configs/model/vit_mae/vit_mae.yaml")
                         .read_text())
    frames = 3 * SSL_BATCH
    tflop = 3 * vit_mae_forward_flops(cfg, frames) / 1e12
    out = {"ms_per_step": ms, "ms_per_step_windows": windows,
           "steps_per_window": SSL_STEPS, "batch_triplets": SSL_BATCH,
           "frames_per_step": frames,
           "frames_per_s": frames / (ms / 1e3), "peak_mem_gb": peak,
           "model_tflop_per_step": tflop,
           "bf16_peak_share": tflop * 1e12 / (ms / 1e3) / BF16_FLOP_PER_S}
    emit("ssl_step_time", **out)
    return out


def main() -> int:
    if not (ROOT / "video_spike_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(video_spike_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke run needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phase_build()
    kernel = phase_kernel()
    with tempfile.TemporaryDirectory(prefix="vst_smoke_") as tmp:
        work = Path(tmp)
        main_path = phase_main_path(work)
        phase_step_time(work)
        phase_vtt_main_path(work)
        phase_vtt_card_vs_cpu()
        phase_vtt_step_time(work)
        phase_rrr_main_path(work)
        _, ssl = phase_ssl_main_path(work)
        phase_ssl_card_vs_cpu()
        phase_ssl_step_time(work, ssl)
    kernel["launches"] = main_path["launches"]
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
