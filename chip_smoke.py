#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``video_spike_torch``) on one H100,
or on four.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --cards 4    # four cards, one NCCL rank a card

``--cards 4`` needs four visible cards (with fewer it exits 2, naming the
count; it never falls back to gloo or to one card). It builds the kernels,
runs the kernel phase on each card at once, then the multi-rank paths
under ``torch.distributed.run --standalone --nproc_per_node=4`` over NCCL,
each rank reporting its backend, card index, name and PCI bus id: (a) the
data-parallel production Linear through ``cli.train`` at 4 ranks x 16
rows, 2 epochs and a resume (a launch a step at the gathered B = 64, the
replicas equal every epoch; W after a first step bitwise that of the same
step on 4 gloo ranks sharing card 0; ms/step against one card's 16- and
64-row steps; the factor gather's bytes and ms; each card's peak memory);
(b) the Linear on {data: 2, model: 2}, W bitwise {data: 2, model: 1}'s;
(c) the tensor-sharded VTT on {data: 2, model: 2} against the unsplit step;
(d) the Linear and VTT ``model_best``s served split over model = 4, by
rows and by columns; (e) SSL data-parallel, 4 ranks x 128 triplets through
``pretrain.main(data=)``, 20 steps then a resume to 30, a fused AdamW
launch a step on each rank; (f) 16 clean
four-rank launches and a raising rank (under the launcher, and as plain
processes ended by the process group's timeout); (g) the multi-process
smokes of ``parallel/``. Every phase runs; the run fails after them if any
failed. Its last line's ``count`` is 4.

Phases of the one-card run, one JSON line each on stdout:

1. build: compile every hand-written kernel from ``video_spike_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit as ``nvidia-smi`` reports them;
2. kernel: each kernel against its plain PyTorch version on the card —
   bitwise on exact-sum inputs (including a flat index that wraps past
   2^32, a ragged M, B = 1, N = 100 and B = 256), within tolerance on
   random inputs — and timed with CUDA events beside its bound, at the
   Linear path's shape, at the probe head's (M = 1,204,224, N = 256, B =
   8) and at the gathered batch of 4 data-parallel ranks (B = 64); beside
   them the ``copy_ms`` yardstick (a bf16 (M, N) ``Tensor.copy_``);
2b. fused_adamw: the multi-tensor AdamW kernel at the SSL model's 255 f32
    leaves (111,002,116 elements): p, mu and nu bitwise the per-leaf
    loop's on the card over 3 steps, one launch a step; timed beside its
    bound (28 bytes an element), the per-leaf loop's time and device time,
    and ``torch._fused_adamw_``'s time as a yardstick the port never calls;
    then at VideoMAE-Base's 203 leaves (94,222,080 elements) its
    out-of-place entry (``AdamW.step``, the VideoMAE pretraining step's):
    bitwise the per-leaf loop over 3 steps with what it was handed
    unchanged, and its device time and host time a call beside its bound
    and the in-place entry's on the same leaves;
2c. flash_attention: the fused attention kernels (forward and backward)
    through ``attention_bshd`` on the packed qkv views at the shapes the
    cells and the smoke's models call it (VideoMAE's decoder and encoder,
    ViT-MAE's encoder and head-dim-32 decoder in the SSL recipe, the VTT's
    head-dim-256 frame and temporal blocks): against their plain version
    and, beside the torch bf16 expression, against the f32 truth; timed
    beside their bound, the expression's time and SDPA's (a yardstick the
    port never calls), with each instantiation's registers and spills;
    the VTT, SSL and probe paths below run through them, counted by path;
3. main_path: ``python -m video_spike_torch.cli.train`` (called in-process)
   trains the full-width Linear model on a synthetic 128x128 session in
   the production configuration (bf16 SR store, lean adafactor, fused
   readout), then resumes for one more epoch; the kernel's launch count
   must equal the train steps; then ms/step over staged steps;
3b. linear_lean_path: the same model under ``adafactor_lean`` (bf16 SR
    store, fused readout) streaming with the ``profiling`` hook on, 2
    epochs then ``--resume`` to 3: a launch a step, ``metrics.jsonl`` with
    a finite record an epoch, a profiler trace (each run traces once),
    the checkpoint's optimizer counts; then ms/step of the staged lean
    step;
3c. linear_accum_path: ``adamw_sr_bf16`` with gradient accumulation 2 for
    2 epochs: the fused readout off (and logged so), 0 launches, the
    checkpoint's MultiSteps counters;
3d. stream_main_path: the production Linear at full width streamed
    (``device_cache: false``, ``save_every: 1``) from a 160-trial fixture's
    tar shards through the native C++ reader and the pinned prefetch, 2
    epochs then ``--resume`` to 3: a launch a step, every train shard read
    by the native reader, ``model_best.pt`` / ``model_last.pt`` (written in
    the background) bitwise what they snapshot; then the reader's rate
    (native against python), the batch's H2D rate (pageable against
    pinned), the streamed step against the staged one and the step-loop
    stall of a background ``model_best`` flush against a synchronous save;
3f. dist_main_path: ``cli.train`` across processes under
    ``torch.distributed.run``: (a) 2 gloo ranks sharing the card, the
    full-width Linear at local batch 8 (global 16), 2 epochs then
    ``--resume`` to 3: identical losses on both ranks, W checksums equal
    every epoch, rank 0 the only writer, a launch a step on each rank
    (the fused step gathers the ranks' rank-B factors), staged ms/step,
    and one 2-rank step against the one-rank step on the same 16 rows;
    (b) NCCL at world 1 through the same CLI: losses and W equal to the
    non-distributed run's; (c) the Linear ``model_best`` served with the
    first kernel's rows split over 2 gloo ranks against the one-rank
    session; (d) 4 gloo ranks at local batch 16 on the 160-trial fixture,
    one epoch: every fused update on the gathered 64 rows, W checksums
    equal, one step against the one-process step on the same 64 rows;
3e. optim_card_vs_cpu: every new optimizer transform on the Linear model's
    non-kernel leaves (the 11,161,600-element decoder head among them), 3
    updates on the card against the CPU within stated bounds, and one
    update timed beside its HBM bound;
4. vtt_main_path: ``cli.train --eid <5 sessions>`` trains the VTT flagship
   (``configs/{model,train}/vtt_video.yaml``, full width, 10,264,188
   parameters) on five synthetic 128x128 sessions of 668, 600, 500, 400
   and 300 neurons for 2 epochs at batch 16, then resumes for one more;
5. vtt_card_vs_cpu: one trial through the VTT forward on the card (bf16 and
   f32 models) against the same weights in f32 on the CPU;
6. vtt_step_time: ms/step of the staged VTT train step (CUDA events),
   frames/s, peak memory, model TFLOP/step and its share of the bf16 peak;
6b. tensor_main_path: the ``model`` axis, ranks sharing the card over gloo
    under ``torch.distributed.run``: (a) ``cli.train`` on the full-width
    Linear with ``training.mesh: {data: 1, model: 2}`` (2 ranks, global
    batch 16), 2 epochs then ``--resume`` to 3: a launch a step on each
    rank (the parameters replicated, both ranks on the same rows), the W
    checksums equal every epoch, W after 2 epochs bitwise a one-process
    streamed run's; (b) the tensor-sharded VTT step at the recipe's width
    under the production sharding rules on {data: 2, model: 2} (4 ranks,
    global batch 8), 3 steps in f32 and in bf16 against the unsplit step
    in one process on the same rows (losses and gathered parameters within
    their stated bounds), each rank's shard shapes, ms/step and bytes
    gathered and all-reduced a step; (c) the VTT ``model_best`` served
    under the same rules on 2 ranks against the one-rank session;
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
   then ``cli.test --model cm``; the first run's periodic ``last_model``
   flush at step 10 runs in the background, and the resume must read a
   checkpoint whose step matches its sampler sidecar; the fused AdamW
   launches once a step trained;
9. ssl_card_vs_cpu: the ContrastViTMAE forward on the card (bf16 and f32)
   against the same weights in f32 on the CPU with the same mask noise, and
   ``device_frame_transform`` on the card against the CPU at 106×160 and
   64×96;
10. ssl_step_time: ms/step of the staged SSL train step (frame cache live),
    frames/s, peak memory, model TFLOP/step and its share of the bf16 peak;
11. probe_pretrain: ``cli.pretrain_videomae`` pretrains
    VideoMAEForPreTraining at full width (94,222,080 parameters, mask ratio
    0.9) for 20 steps at batch 8 on the Linear phase's fixture and writes
    ``backbone.pt``;
12. probe_main_path: ``cli.train`` trains the VideoMAE probe
    (``configs/model/videomae/videomae.yaml`` with ``hf_compat: false`` and
    that backbone, ``configs/train/vmae_video.yaml`` with the production
    optimizer at a peak lr of 1e-6 (PROBE_LR); 405,723,216 parameters,
    the 86,236,416 of the backbone frozen) for 2 epochs at batch 8, then
    resumes for one more: the
    features are staged once and the kernel carries the (1,204,224, 256)
    head update on every step; the backbone must stay the checkpoint's;
13. probe_card_vs_cpu: the ``hf_compat: true`` backbone's ``encode`` of one
    trial on the card (bf16 and f32) against f32 on the CPU, at 4 frames;
14. probe_step_time: ms/step of the staged fused head step, frames/s, the
    per-trial encode and peak memory;
15. serve_main_path: ``cli.serve.make_app`` over the Linear phase's
    ``model_best.pt`` (full width, the bf16 kernel as stored, buckets 1-16
    warmed), ``predict`` timed at each bucket, then ``serve_http`` answers
    128 requests of one raw uint8 trial (every 16th an ``X-Batched`` batch
    of 3) from 16 client threads; each response against the model's direct
    forward on its row; ``/stats`` latencies, requests/s, peak memory;
16. vtt_serve: an ``InferenceSession`` over the VTT phase's
    ``model_best.pt``, 3 rows of mixed session ids in the 4-bucket and the
    same rows with the ids left out, against the direct forward;
16b. split_serve_path: both ``model_best``s served split over 2 gloo
    ranks sharing the card, under any rules: the full-width Linear under
    ``first_layer_sharding_rules(min_dim=256)`` (three kernels split by
    rows) and ``vtt_sharding_rules`` (three by columns) at buckets 1, 4
    and 16, the VTT under ``first_layer_sharding_rules(min_dim=512)``
    (every 512-input kernel by rows) at bucket 4 with session ids: each
    against the one-rank session, the ranks bitwise equal, the shard
    shapes, no leaf gathered, ``predict`` ms against the one-rank session
    and the bytes all-reduced and all-gathered a request;
17. export: ``cli.export_model`` on the full-width Linear checkpoint at
    batch 8 and ``load_exported`` at batches 3 and 8, and the VTT with
    session ids, against ``session.predict``; both with a symbolic batch;
18. cebra_main_path: ``cli.use_cebra`` (5,000 iterations, batch 512, 5
    dimensions) on the RRR phase's session (8,640 frames of 64×96), then
    ``--use_pca``, ``cli.unify_cebra`` and ``cli.train_rrr --input_mod
    cebra`` on the card;
19. cebra_card_vs_cpu: under PyTorch's default backend flags, the fitted
    encoder's ``transform`` on the card against the CPU, and
    ``get_pca_embedding`` (covariance and Gram branches) up to sign;
20. etl_main_path: ``cli.prepare_data.etl_session`` on a raw session of
    80 trials and 668 neurons before the 2 Hz filter (128x192 frames, the
    DLC points placed for a 64x96 whisker crop: 3 pyramid levels), the
    Farneback flow of every trial's 119 frame pairs on the card in one
    batch; every shard read back through ``split_dataset`` and
    ``SessionDataset``; one trial's flow on the card against the CPU
    (field and features, each within its bound), timed with CUDA events
    and profiled (launches and device ms a trial);
21. a ``{"kernels": [...]}`` line (the fused readout runs on the Linear,
    lean Linear, streamed Linear, data-parallel Linear (2 and 4 ranks),
    model-axis Linear and probe paths; the accumulation, VTT,
    tensor-sharded VTT, RRR, SSL, pretraining, serving, split serving,
    export, CEBRA and ETL paths must launch it 0 times; the fused AdamW
    runs on the SSL path);
22. last line: ``{"ok": true, "device": {...}}``.

Any failure is an uncaught exception and a non-zero exit. Every rank of a
multi-rank phase ends through ``core/runtime.exit_rank``, and a launch
whose ranks do not all exit 0 fails the run. Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero and
prints no result. Imports neither JAX nor the JAX package.
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
DP4_WORLD = 4                # data-parallel ranks whose gathered batch the
                             # kernel takes at 4 x BATCH rows
SEEDS = (0, 7, (1 << 32) - 1)
REPS = 3                     # timing windows per measurement
SLEEP_CYCLES = 400_000_000   # ~0.2 s of the card's clock ahead of a window

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
SSL_FLUSH_EVERY = 10         # a periodic last_model flush, in the background
SSL_MAX_STEPS = 60           # the resumed run validates at 38 and 60
SSL_STEPS = 10               # staged steps per timing window
SSL_CARD_FRAMES = 4          # frames in the card-vs-CPU forward
SSL_LR = 5e-5                # configs/train/vmae_video.yaml's
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

# VideoMAE probe (configs/model/videomae/videomae.yaml +
# configs/train/vmae_video.yaml with the production optimizer) on the Linear
# phase's fixture (smokeeid0: 40 trials of 120x128x128, 436 neurons; 32
# train, 4 val, 4 test) at batch 8, from a backbone that cli.pretrain_videomae
# pretrains first
PROBE_YAML = "configs/model/videomae/videomae.yaml"
PROBE_TRAIN_YAML = "configs/train/vmae_video.yaml"
PROBE_BATCH = 8
PROBE_M = 1568 * 768          # encoder_head rows: 1,568 tokens x 768
# at 436 neurons with hf_compat: false, whose backbone ends in a LayerNorm:
# 86,236,416 frozen (hf_compat: true has no final norm: 405,721,680 in all)
PROBE_PARAMS = 405_723_216
PRETRAIN_PARAMS = 94_222_080
PRETRAIN_STEPS = 20
PROBE_EPOCHS_PER_WINDOW = 5   # 4 staged steps an epoch: 20 steps a window
PROBE_CARD_FRAMES = 4         # frames in the card-vs-CPU encode
# peak lr of the probe runs. Lean adafactor's per-element normalized step
# moves each head output by up to ~lr * sum_m |x_m| over M = 1,204,224
# features (mean |x| ~0.8): ~5 a step at the start of the yaml's one-cycle
# (5e-5 / 10), which overflows the exp link within the first epoch (this
# script stopped there on an H100 at 700 W, in torch.linalg.eigh on a NaN
# dz); ~0.1 a step at the start from a peak of 1e-6
PROBE_LR = 1e-6
# card vs CPU on the features, max |card - cpu| / max |cpu|: the hf_compat
# backbone keeps a bf16 residual stream (~0.5% rounding, as the VTT's);
# f32 differs by summation order only, with TF32 off
PROBE_BF16_REL_BOUND = 2e-2
PROBE_F32_REL_BOUND = 1e-4

# serving (cli/serve.py over the Linear phase's model_best.pt): 128 requests
# from 16 client threads, every SERVE_BATCHED_EVERY-th an X-Batched batch
SERVE_MAX_BATCH = 16
SERVE_BUCKETS = (1, 2, 4, 8, 16)
SERVE_REQUESTS = 128
SERVE_CLIENTS = 16
SERVE_BATCHED_EVERY = 16
SERVE_BATCHED_ROWS = 3
SERVE_TRIALS = 16            # distinct fixture trials the requests carry
SERVE_PREDICT_REPS = 5       # predict calls timed at each bucket
# a response against the model's direct forward on its row, max |d| / max
# |ref|: the served batch and the direct one differ in size, so the bf16
# GEMM may sum in another order and round an output by a bf16 ulp (2^-8 to
# 2^-7 of it; measured 7.35e-3 on an H100); also the VTT's and the
# exports' bound (measured 0)
SERVE_REL_BOUND = 1e-2
EXPORT_BATCH = 8
EXPORT_RUN_BATCHES = (3, 8)
# CEBRA (cli/use_cebra.py) on the RRR phase's 80-trial session, 64x96
# whisker crop: the recipe's 5,000 iterations at batch 512, 5 dimensions
CEBRA_OUT_DIM = 5
CEBRA_ITERATIONS = 5000
CEBRA_TRAIN_TEST_TRIALS = 72  # 64 train + 8 test of the 80
CEBRA_PIXELS = 64 * 96
# card vs CPU: the f32 transform (matmul convs, TF32 off for matmuls under
# PyTorch's defaults) differs by summation order only; PCA columns up to
# sign, max |d| / max |cpu|: float32 against float64 on the CPU gives 4.9e-6
# (covariance, 8,640 frames) and 4.0e-5 (Gram, 4,800 frames)
CEBRA_F32_REL_BOUND = 1e-4
PCA_REL_BOUND = 2e-4
PCA_GRAM_TRIALS = 40         # 4,800 frames <= 6,144 pixels: the Gram branch
# offline ETL (cli/prepare_data.py) on a raw session of the RRR and CEBRA
# session's size: 80 trials, 668 neurons before the 2 Hz filter, 120 frames
# a trial. The DLC nose tip and top pupil point sit 192 px apart, so the
# whisker-pad ROI (w = d/2, h = d/3) is the 64x96 crop the SSL and CEBRA
# phases train on, which runs the full 3-level pyramid. Cut: 80 trials of
# a session's several hundred; 128x192 frames, not the camera's own size
ETL_EID = "etlsess00"
ETL_TRIALS = 80
ETL_NEURONS = 668
ETL_FRAME = (128, 192)
ETL_NOSE, ETL_PUPIL = (20.5, 40.5), (212.5, 40.5)   # int(mean): 192 apart
ETL_ROI = [96, 64, 68, 40]                            # w, h, x, y
ETL_FLOW_REPS = 10           # timed flow calls a window
# card vs CPU on one trial's flow, both f32 with TF32 off: the field's max
# |d| / max |cpu| (noise-dominated pixels, where the 2x2 solve is
# ill-conditioned, part most) and the features' max |d|
ETL_FIELD_REL_BOUND = 1e-3
ETL_OF_ABS_BOUND = 1e-3


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


def _kernel_at(m: int, b: int, exact_cases, gen) -> dict:
    """The kernel against its plain version at (M, N=256, B): bitwise on
    exact-sum inputs at each (M, B, N) of ``exact_cases`` for every seed,
    >= 99.9% bitwise and within tolerance on random inputs at M, then timed
    at M (W far above L2) beside its bound; the median of REPS windows."""
    import torch

    from video_spike_torch.ops import fused_readout as fr

    dev, n = torch.device("cuda"), KERNEL_N

    def exact_factors(rows, bb, nn):
        # small integers times powers of two: every f32 B-term sum is exact
        # in any order, at ~2^-10 of W's scale so SR still rounds
        xa = torch.randint(-7, 8, (bb, rows), generator=gen, device=dev)
        dzc = torch.randint(-7, 8, (bb, nn), generator=gen, device=dev)
        return xa.float() * 2.0**-8, dzc.float() * 2.0**-12

    bitwise = []
    for rows, bb, nn in exact_cases:
        w0 = torch.randn(rows, nn, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        xa, dzc = exact_factors(rows, bb, nn)
        for seed in SEEDS:
            ref = fr._apply_scaled_outer_plain(w0, xa, dzc, seed)
            w = w0.clone()
            fr.apply_scaled_outer(w, xa, dzc, seed)
            torch.cuda.synchronize()
            equal = bool(torch.equal(w.view(torch.int16),
                                     ref.view(torch.int16)))
            bitwise.append({"m": rows, "b": bb, "n": nn, "seed": seed,
                            "bitwise": equal})
            if not equal:
                raise AssertionError(f"kernel != plain on exact sums: "
                                     f"M={rows}, B={bb}, N={nn}, "
                                     f"seed={seed}")
            del ref, w
        del w0, xa, dzc
        torch.cuda.empty_cache()

    w0 = torch.randn(m, n, generator=gen, device=dev, dtype=torch.bfloat16)
    xa = torch.randn(b, m, generator=gen, device=dev) * 1e-2
    dzc = torch.randn(b, n, generator=gen, device=dev) * 1e-2
    ref = fr._apply_scaled_outer_plain(w0, xa, dzc, 3)
    w = w0.clone()
    fr.apply_scaled_outer(w, xa, dzc, 3)
    torch.cuda.synchronize()
    cmp = _sr_compare(w, ref, xa, dzc)
    if cmp["frac_bitwise"] < 0.999 or cmp["n_outside_tolerance"]:
        raise AssertionError(f"kernel vs plain at M={m}, B={b}: {cmp}")
    del ref

    windows = [cuda_ms(lambda: fr.apply_scaled_outer(w, xa, dzc, 3), 20, 3)
               for _ in range(REPS)]
    plain_ms = cuda_ms(lambda: fr._apply_scaled_outer_plain(w, xa, dzc, 3),
                       3, 1)
    nbytes = 2 * m * n * 2 + b * m * 4 + b * n * 4
    flops = 2 * b * m * n
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOP_PER_S * 1e3
    plan = fr._launch_plan(m, n, b)._asdict()
    del w, w0, xa, dzc
    torch.cuda.empty_cache()
    ms = statistics.median(windows)
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    return {"shape": [m, n, b], "exact_sum_cases": bitwise,
            "random_inputs": cmp, "ms": ms, "ms_windows": windows,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "share_of_bound": bound_ms / ms,
            "bound_bytes": nbytes, "bound_flops": flops, "plan": plan}


def _copy_ms() -> dict:
    """A yardstick, not the bound and not a library call of the same
    function: ``Tensor.copy_`` between two (M, N) bf16 buffers of the
    Linear shape (2.013 GB moved), the device-memory rate this card reaches
    with a plain stream."""
    import torch

    src = torch.empty(KERNEL_M, KERNEL_N, dtype=torch.bfloat16,
                      device="cuda")
    dst = torch.empty_like(src)
    windows = [cuda_ms(lambda: dst.copy_(src), 20, 3) for _ in range(REPS)]
    nbytes = 2 * src.numel() * 2
    ms = statistics.median(windows)
    del src, dst
    torch.cuda.empty_cache()
    return {"copy_ms": ms, "copy_ms_windows": windows, "bytes": nbytes,
            "tb_per_s": nbytes / ms / 1e9,
            "share_of_hbm_rate": nbytes / ms / 1e9 / (HBM_BYTES_PER_S / 1e12)}


def phase_kernel() -> dict:
    """The kernel at the Linear path's shape (exact sums also at a ragged M,
    at an M whose flat index wraps 2^32, at B = 1 and at N = 100), at the
    probe head's, and at the gathered batch of 4 data-parallel ranks (B =
    64; exact sums also at B = 256, whose dzc is walked in chunks); and the
    device-memory yardstick ``copy_ms``."""
    import torch

    from video_spike_torch.ops import fused_readout as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    linear = _kernel_at(KERNEL_M, BATCH, [
        (KERNEL_M, BATCH, KERNEL_N), (4133, BATCH, KERNEL_N),
        (WRAP_M, BATCH, KERNEL_N), (4133, 1, KERNEL_N),
        (1000, BATCH, 100)], gen)
    probe = _kernel_at(PROBE_M, PROBE_BATCH,
                       [(PROBE_M, PROBE_BATCH, KERNEL_N)], gen)
    wide = _kernel_at(KERNEL_M, DP4_WORLD * BATCH, [
        (KERNEL_M, DP4_WORLD * BATCH, KERNEL_N), (2000, 256, KERNEL_N)],
        gen)
    copy = _copy_ms()
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound")
    result = {
        "name": "apply_scaled_outer",
        "route": "cuda",
        "source": "video_spike_torch/csrc/fused_readout.cu",
        "replaces": "video_spike_tpu/ops/fused_readout.py:161",
        "max_abs_err": max(r["random_inputs"]["max_abs_err"]
                           for r in (linear, probe, wide)),
        "ms": linear["ms"],
        "plain_ms": linear["plain_ms"],
        "bound_ms": linear["bound_ms"],
        "bound_by": linear["bound_by"],
        "library_ms": None,
        "share_of_bound": linear["share_of_bound"],
        "probe": {k: probe[k] for k in keys},
        "b64": {k: wide[k] for k in keys},
        "copy_ms_yardstick": copy["copy_ms"],
        "launches_in_checks": fr.apply_scaled_outer.launches,
    }
    result["probe"]["max_abs_err"] = probe["random_inputs"]["max_abs_err"]
    result["b64"]["max_abs_err"] = wide["random_inputs"]["max_abs_err"]
    emit("kernel", kernel="apply_scaled_outer", linear=linear, probe=probe,
         b64=wide, copy_yardstick=copy,
         launches_in_checks=fr.apply_scaled_outer.launches)
    return result


def _ssl_leaves() -> dict:
    """ContrastViTMAE's leaf shapes at ``configs/model/vit_mae/vit_mae.yaml``'s
    widths (255 f32 leaves, 111,002,116 elements), read on the meta
    device."""
    import yaml

    from video_spike_torch.models.vit_mae import ContrastViTMAE

    cfg = yaml.safe_load((ROOT / "configs/model/vit_mae/vit_mae.yaml")
                         .read_text())
    model = ContrastViTMAE.from_config(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _videomae_leaves() -> dict:
    """VideoMAEForPreTraining's leaf shapes at ``PROBE_YAML``'s widths (203
    f32 leaves, 94,222,080 elements), read on the meta device."""
    import yaml

    from video_spike_torch.models.videomae import VideoMAEForPreTraining

    cfg = yaml.safe_load((ROOT / PROBE_YAML).read_text())
    cfg = {k: v for k, v in cfg.items() if k not in ("encoder", "decoder")}
    model = VideoMAEForPreTraining.from_config(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _queued_ms(fn, iters: int) -> tuple:
    """(device ms, host ms) a call of ``fn``: ``iters`` calls queued behind
    a sleep kernel, so the card runs them back to back whatever the host's
    pace (CUDA events around them), and the host's time to queue each."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def _fused_adamw_videomae(dev) -> dict:
    """The out-of-place AdamW (``AdamW.step``) at VideoMAE-Base's leaves:
    p', mu' and nu' bitwise the per-leaf loop's after each of 3 steps, one
    launch a step, the p, mu and nu it was handed unchanged; then its time
    a call and the in-place entry's on the same leaves (``_queued_ms``,
    the median of REPS windows of 20 calls) beside the bound."""
    import torch

    from video_spike_torch.ops import fused_adamw
    from video_spike_torch.ops import optim as op

    shapes = _videomae_leaves()
    n = sum(math.prod(s) for s in shapes.values())
    if len(shapes) != 203 or n != PRETRAIN_PARAMS:
        raise AssertionError(f"VideoMAE leaves: {len(shapes)}, {n} elements")
    gen = torch.Generator(device=dev).manual_seed(31)
    p = {k: 0.02 * torch.randn(s, generator=gen, device=dev)
         for k, s in shapes.items()}
    ref_p = {k: v.clone() for k, v in p.items()}
    tx, ref_tx = (op.AdamW(SSL_LR, weight_decay=0.01, eps=1e-8)
                  for _ in range(2))
    state, ref_state = tx.init(p), ref_tx.init(ref_p)

    def grads():
        return {k: torch.randn(s, generator=gen, device=dev)
                * 10.0 ** -(2 + i % 4) for i, (k, s) in
                enumerate(shapes.items())}

    def bits(t):
        return t.view(torch.int32)

    launches0 = fused_adamw.step.launches
    unequal, written = [], []
    for step in range(3):
        g = grads()
        upd, ref_state = ref_tx.update(g, ref_state, ref_p)
        ref_p = op.apply_updates(ref_p, upd)
        handed = [(d, {k: t.clone() for k, t in d.items()})
                  for d in (p, state["mu"], state["nu"])]
        p, state = tx.step(p, g, state)
        torch.cuda.synchronize()
        written += [(step, k) for d, kept in handed for k in d
                    if not torch.equal(bits(d[k]), bits(kept[k]))]
        unequal += [(step, k) for k in shapes if not all(
            torch.equal(bits(a), bits(b))
            for a, b in ((p[k], ref_p[k]), (state["mu"][k],
                                            ref_state["mu"][k]),
                         (state["nu"][k], ref_state["nu"][k])))]
    check_launches = fused_adamw.step.launches - launches0
    del upd, ref_p, ref_state, handed
    torch.cuda.empty_cache()

    g = grads()
    in_p = {k: v.clone() for k, v in p.items()}
    in_state = {"count": state["count"],
                **{w: {k: v.clone() for k, v in state[w].items()}
                   for w in ("mu", "nu")}}
    built0 = fused_adamw.step.tables_built
    out_runs = [_queued_ms(lambda: tx.step(p, g, state), 20)
                for _ in range(REPS)]
    tables = fused_adamw.step.tables_built - built0
    in_runs = [_queued_ms(lambda: ref_tx.step_(in_p, g, in_state), 20)
               for _ in range(REPS)]
    del p, g, state, in_p, in_state
    torch.cuda.empty_cache()
    ms = statistics.median(r[0] for r in out_runs)
    bound_ms = 28 * n / HBM_BYTES_PER_S * 1e3
    out = {"leaves": len(shapes), "elements": n, "bitwise_steps": 3,
           "unequal": unequal[:10], "handed_written": written[:10],
           "launches_in_checks": check_launches, "ms": ms,
           "ms_windows": [r[0] for r in out_runs],
           "host_ms": statistics.median(r[1] for r in out_runs),
           "bound_ms": bound_ms, "bound_by": "bytes",
           "share_of_bound": bound_ms / ms,
           "tables_built_in_timing": tables,
           "in_place_ms": statistics.median(r[0] for r in in_runs),
           "in_place_host_ms": statistics.median(r[1] for r in in_runs)}
    if unequal or written or check_launches != 3:
        raise AssertionError(f"out-of-place AdamW against the per-leaf "
                             f"loop: {out}")
    return out


def phase_fused_adamw() -> dict:
    """The multi-tensor AdamW at the SSL model's leaves: p, mu and nu
    bitwise the per-leaf loop's on the card after each of 3 steps; then one
    step timed (CUDA events, the median of REPS windows of 20 launches)
    beside its bound (28 bytes an element at 3.35 TB/s); the per-leaf
    loop's time a step (CUDA events over 5 steps, the host's dispatch
    included) and the device time of its kernels (profiler); and
    ``torch._fused_adamw_``'s time at the same leaves, a yardstick the port
    never calls (torch's AdamW: the decay multiplies p first)."""
    import torch

    from video_spike_torch.ops import fused_adamw
    from video_spike_torch.ops import optim as op

    dev = torch.device("cuda")
    shapes = _ssl_leaves()
    n = sum(math.prod(s) for s in shapes.values())
    if len(shapes) != 255 or n != SSL_PARAMS:
        raise AssertionError(f"SSL leaves: {len(shapes)}, {n} elements")
    gen = torch.Generator(device=dev).manual_seed(23)
    p = {k: 0.02 * torch.randn(s, generator=gen, device=dev)
         for k, s in shapes.items()}
    ref_p = {k: v.clone() for k, v in p.items()}
    tx, ref_tx = (op.AdamW(SSL_LR, weight_decay=0.01, eps=1e-8)
                  for _ in range(2))
    state, ref_state = tx.init(p), ref_tx.init(ref_p)

    def grads():
        return {k: torch.randn(s, generator=gen, device=dev)
                * 10.0 ** -(2 + i % 4) for i, (k, s) in
                enumerate(shapes.items())}

    launches0 = fused_adamw.step_.launches
    unequal = []
    for step in range(3):
        g = grads()
        upd, ref_state = ref_tx.update(g, ref_state, ref_p)
        ref_p = op.apply_updates(ref_p, upd)
        tx.step_(p, g, state)
        torch.cuda.synchronize()
        unequal += [(step, k) for k in shapes if not all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in ((p[k], ref_p[k]), (state["mu"][k],
                                            ref_state["mu"][k]),
                         (state["nu"][k], ref_state["nu"][k])))]
    check_launches = fused_adamw.step_.launches - launches0
    del upd, ref_p, ref_state
    torch.cuda.empty_cache()

    g = grads()
    windows = [cuda_ms(lambda: tx.step_(p, g, state), 20, 3)
               for _ in range(REPS)]
    loop_state = {"p": {k: v.clone() for k, v in p.items()},
                  "s": ref_tx.init(p)}

    def loop():
        upd, loop_state["s"] = ref_tx.update(g, loop_state["s"],
                                             loop_state["p"])
        loop_state["p"] = op.apply_updates(loop_state["p"], upd)

    plain_ms = cuda_ms(loop, 5, 1)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            loop()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
    plain_device_ms = sum(e.self_device_time_total for e in kernels) / 2e3
    plain_launches = sum(e.count for e in kernels) / 2
    del loop_state
    torch.cuda.empty_cache()

    keys = list(shapes)
    lib_state = [[torch.zeros_like(p[k]) for k in keys] for _ in range(2)]
    steps = [torch.ones((), device=dev) for _ in keys]

    def library():
        torch._fused_adamw_([p[k] for k in keys], [g[k] for k in keys],
                            lib_state[0], lib_state[1], [], steps,
                            lr=SSL_LR, beta1=0.9, beta2=0.999,
                            weight_decay=0.01, eps=1e-8, amsgrad=False,
                            maximize=False)

    library_ms = statistics.median(cuda_ms(library, 20, 3)
                                   for _ in range(REPS))
    del lib_state, p, g, state
    torch.cuda.empty_cache()
    ms = statistics.median(windows)
    nbytes = 28 * n
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"name": "fused_adamw", "route": "cuda",
           "source": "video_spike_torch/csrc/fused_adamw.cu",
           "replaces": None, "leaves": len(shapes), "elements": n,
           "bitwise_steps": 3, "unequal": unequal[:10],
           "launches_in_checks": check_launches, "ms": ms,
           "ms_windows": windows, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_bytes": nbytes, "share_of_bound": bound_ms / ms,
           "plain_ms": plain_ms, "plain_device_ms": plain_device_ms,
           "plain_launches": plain_launches, "library_ms": library_ms,
           "grid": tx._fused_tables.grid,
           "chunks": tx._fused_tables.n_chunks,
           "segments": tx._fused_tables.n_segs}
    if unequal or check_launches != 3:
        emit("fused_adamw", **out)
        raise AssertionError(f"fused AdamW against the per-leaf loop: "
                             f"{len(unequal)} leaves differ "
                             f"({unequal[:10]}), {check_launches} launches "
                             f"for 3 steps")
    out["videomae"] = _fused_adamw_videomae(dev)
    emit("fused_adamw", **out)
    return out


# (B, S, H, D) of the fused attention as the cells and the smoke's models
# call it: VideoMAE-Base's decoder (1,568 tokens) and encoder (160 visible)
# at 64 clips, ViT-MAE-Base's encoder (21 tokens) and decoder (82, head dim
# 32) at 384 frames, the VTT's frame (64 patches of 960 frames) and
# temporal (60 frames) blocks at head dim 256
FLASH_SHAPES = {"vmae_decoder": (64, 1568, 6, 64),
                "vmae_encoder": (64, 160, 12, 64),
                "ssl_encoder": (384, 21, 12, 64),
                "ssl_decoder": (384, 82, 16, 32),
                "vtt_frames": (BATCH * T_FRAMES // 2, 64, 2, 256),
                "vtt_time": (BATCH, T_FRAMES // 2, 2, 256)}
FLASH_CHECK_ROWS = 2         # batch rows held against the f32 truth
# batch rows of the plain version at a time, at most ~1 GiB of f32 scores
FLASH_PLAIN_BYTES = 1 << 30
# kernel against its plain version: the output within 2^-8 of the plain
# version's largest element, each gradient within a bf16 ulp of its
# largest (2^-7); against the f32 truth, within twice the torch bf16
# expression's error (tests/test_torch_kernels_gpu.py)
FLASH_OUT_TOL, FLASH_GRAD_TOL = 2.0**-8, 2.0**-7


def _attention_counts() -> list:
    """[forward, backward] launches of the fused attention since the last
    ``_attention_reset()``."""
    from video_spike_torch.ops.attention import attention_bshd

    return [attention_bshd.launches, attention_bshd.backward_launches]


def _attention_reset() -> None:
    from video_spike_torch.ops.attention import attention_bshd

    attention_bshd.launches = attention_bshd.backward_launches = 0


def _flash_vs_plain(got, qkv, dout) -> dict:
    """max |kernel - plain| / max |plain| of the output and each gradient
    over the whole batch, the plain version run over batch chunks of the
    same inputs."""
    from video_spike_torch.ops import attention as att

    b, s, _, h, _ = qkv.shape
    rows = max(1, FLASH_PLAIN_BYTES // (h * s * s * 4))
    q, k, v = qkv.detach().unbind(2)
    diff, scale = [0.0] * 4, [0.0] * 4
    for i in range(0, b, rows):
        at = slice(i, i + rows)
        po, lse = att.flash_attention_plain(q[at], k[at], v[at])
        plain = (po, *att.flash_attention_plain_backward(
            q[at], k[at], v[at], po, lse, dout[at]))
        for j, (g, p) in enumerate(zip(got, plain)):
            diff[j] = max(diff[j], (g[at].float() - p.float()).abs().max()
                          .item())
            scale[j] = max(scale[j], p.float().abs().max().item())
        del po, lse, plain
    return {key: d / max(m, 1e-30)
            for key, d, m in zip(("out", "dq", "dk", "dv"), diff, scale)}


def phase_flash_attention() -> dict:
    """The fused attention at ``FLASH_SHAPES``, forward and backward
    through ``attention_bshd`` and autograd on the packed qkv projection's
    views: the full-shape call that is timed, held against the plain
    version over the whole batch; on ``FLASH_CHECK_ROWS`` batch rows,
    against the f32 truth beside the torch bf16 expression; then at
    the full shape forward alone and forward plus backward (CUDA events,
    the median of REPS windows), beside the bound (``benchmark/benchlib/
    videomae_counts.py``: the six products at the bf16 peak or the eight
    bf16 tensors at the HBM rate, the larger), the torch expression's time
    and ``F.scaled_dot_product_attention``'s (``library_ms``, a yardstick
    the port never calls); registers and spill bytes of each
    instantiation as the runtime reports them."""
    import torch
    import torch.nn.functional as F

    from benchmark.benchlib import videomae_counts as vc
    from video_spike_torch.ops import attention as att

    dev = torch.device("cuda")
    attrs = {str(d): att.kernel_attributes(d) for d in att.HEAD_DIMS}
    _attention_reset()

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max()
                / ref.float().abs().max().clamp_min(1e-30)).item()

    def run(fn, qkv, dout):
        qkv.grad = None
        out = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        out.backward(dout)
        return out.detach(), *qkv.grad.unbind(2)

    shapes, failures = {}, []
    for name, (b, s, h, d) in FLASH_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(31)
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(
            torch.bfloat16).float()
        got = run(att.attention_bshd, qkv, dout)
        check = {"vs_plain": _flash_vs_plain(got, qkv, dout)}
        del got
        small = qkv.detach()[:FLASH_CHECK_ROWS].clone().requires_grad_(True)
        sd = dout[:FLASH_CHECK_ROWS]
        got = run(att.attention_bshd, small, sd)
        truth = run(att.attention_torch,
                    small.detach().float().requires_grad_(True), sd)
        expr = run(att.attention_torch, small, sd)
        keys = ("out", "dq", "dk", "dv")
        check["vs_f32"] = dict(zip(keys, map(rel, got, truth)))
        check["expression_vs_f32"] = dict(zip(keys, map(rel, expr, truth)))
        del got, truth, expr, small
        for key in keys:
            tol = FLASH_OUT_TOL if key == "out" else FLASH_GRAD_TOL
            if not (check["vs_plain"][key] <= tol and check["vs_f32"][key]
                    <= 2 * check["expression_vs_f32"][key]):
                failures.append((name, key))

        qv, kv, vv = qkv.detach().unbind(2)
        iters = max(3, min(50, int(2e10 // (b * s * s * h * d))))
        with torch.no_grad():
            fwd_ms = statistics.median(cuda_ms(
                lambda: att.attention_bshd(qv, kv, vv), iters)
                for _ in range(REPS))
        ms = statistics.median(cuda_ms(
            lambda: run(att.attention_bshd, qkv, dout), iters)
            for _ in range(REPS))
        plain_ms = cuda_ms(lambda: run(att.attention_torch, qkv, dout),
                           max(2, iters // 8), 1)
        heads = [x.detach().permute(0, 2, 1, 3).contiguous()
                 .requires_grad_(True) for x in (qv, kv, vv)]
        dout_h = dout.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()

        def library():
            for x in heads:
                x.grad = None
            F.scaled_dot_product_attention(*heads).backward(dout_h)

        library_ms = statistics.median(cuda_ms(library, iters)
                                       for _ in range(REPS))
        flops = vc.attention_flops(b, s, h * d)
        nbytes = vc.attention_bytes(b, s, h * d)
        bound_ms = vc.attention_bound_s(flops, nbytes) * 1e3
        shapes[name] = {
            "shape": [b, s, h, d], "ms": ms, "fwd_ms": fwd_ms,
            "bound_ms": bound_ms,
            "bound_by": ("flops" if flops / BF16_FLOP_PER_S
                         >= nbytes / HBM_BYTES_PER_S else "bytes"),
            "share_of_bound": bound_ms / ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "tflop_per_s": flops / ms / 1e9,
            **check}
        del qkv, dout, heads, dout_h, qv, kv, vv
        torch.cuda.empty_cache()
    launches = _attention_counts()
    head = shapes["vmae_decoder"]
    out = {"name": "flash_attention", "route": "cuda",
           "source": ["video_spike_torch/csrc/flash_attention_fwd.cu",
                      "video_spike_torch/csrc/flash_attention_bwd.cu"],
           "replaces": None, "ms": head["ms"], "plain_ms": head["plain_ms"],
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": head["library_ms"],
           "share_of_bound": head["share_of_bound"],
           "max_rel_err_vs_plain": max(v for r in shapes.values()
                                       for v in r["vs_plain"].values()),
           "shapes": shapes, "attributes": attrs,
           "launches_in_checks": {"forward": launches[0],
                                  "backward": launches[1]}}
    emit("flash_attention", **out)
    if failures:
        raise AssertionError(f"flash attention outside its tolerances at "
                             f"{failures}: {shapes}")
    return out


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


def staged_window_ms(trainer, epochs: int) -> tuple:
    """(ms/step of each window, steps a window) of a trainer's staged
    epochs (CUDA events): one epoch to stage the trials and warm up, then
    REPS windows of `epochs` epochs."""
    import torch

    trainer.train_epoch()
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
    return windows, steps


def staged_ms_per_step(work: Path, train_yaml: Path, log_dir: str) -> dict:
    """ms/step of the staged train step on the Linear fixture, CUDA events
    over REPS windows of 20 steps (the median and every window), through
    the same trainer the CLI builds."""
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    args = get_args(
        ["--model_config", str(ROOT / "configs/model/linear_video.yaml"),
         "--train_config", str(train_yaml), "--eid", "smokeeid0",
         "--data_dir", str(work / "data"), "--log_dir", str(work / log_dir),
         "--batch_size", str(BATCH), "--device", "cuda"])
    trainer = train_cli.build_trainer(args)
    torch.cuda.reset_peak_memory_stats()
    epochs = 10
    windows, steps = staged_window_ms(trainer, epochs)
    ms = statistics.median(windows)
    return {"ms_per_step": ms, "ms_per_step_windows": windows,
            "steps_per_window": steps, "batch": BATCH,
            "frames_per_s": BATCH * T_FRAMES / (ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_step_time(work: Path) -> dict:
    """The production configuration's fused step (optax adafactor without
    parameter scale or clipping on the rest of the tree)."""
    out = staged_ms_per_step(work, _train_yaml(work), "timing")
    emit("step_time", **out)
    return out


# ---------------------------------------------------------------------------
# phases 3b, 3c and 3e: the optimizer variants on the full-width Linear model
# ---------------------------------------------------------------------------

LEAN_OPTIMIZER = {"name": "adafactor_lean", "param_dtype": "bfloat16_sr",
                  "fused_readout": True}
ACCUM_OPTIMIZER = {"name": "adamw", "param_dtype": "bfloat16_sr",
                   "gradient_accumulation_steps": 2, "fused_readout": True}
PROFILE_STEPS = 3


def _variant_yaml(work: Path, name: str, optimizer: dict,
                  training: dict = None, extra: dict = None) -> Path:
    """configs/train/linear_video.yaml with ``optimizer`` (replacing the
    yaml's optimizer keys it names) and ``training`` overrides."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs/train/linear_video.yaml")
                         .read_text())
    cfg["optimizer"].update(optimizer)
    cfg["training"].update(training or {})
    cfg.update(extra or {})
    path = work / f"train_linear_{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _linear_args(work: Path, train_yaml: Path, log_dir: str) -> list:
    return ["--model_config", str(ROOT / "configs/model/linear_video.yaml"),
            "--train_config", str(train_yaml), "--eid", "smokeeid0",
            "--data_dir", str(work / "data"), "--log_dir", str(work / log_dir),
            "--batch_size", str(BATCH), "--device", "cuda"]


def _metrics_records(log_dir: Path) -> list:
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _finite_records(records: list, keys) -> bool:
    return all(math.isfinite(r[k]) for r in records for k in keys)


def phase_linear_lean_path(work: Path) -> dict:
    """``cli.train`` on the full-width Linear with ``adafactor_lean`` + the
    bf16 SR store + ``fused_readout``, streaming (``device_cache: false``)
    with the profiler hook on: 2 epochs, then ``--resume`` to 3. The
    kernel launches once a train step; ``metrics.jsonl`` gets one record
    an epoch; a trace lands in ``trace/``; then ms/step of the staged lean
    step."""
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.ops import fused_readout as fr

    t_phase = time.perf_counter()
    trace_dir = work / "trace"
    train_yaml = _variant_yaml(
        work, "lean", LEAN_OPTIMIZER, {"device_cache": False},
        {"profiling": {"enable": True, "dir": str(trace_dir),
                       "steps": PROFILE_STEPS}})
    args = _linear_args(work, train_yaml, "lean_logs")
    fr.apply_scaled_outer.launches = 0
    t0 = time.perf_counter()
    res = train_cli.main(args + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    steps = res["global_step"]
    log_dir = Path(res["log_dir"])
    last = torch.load(log_dir / "model_last.pt", weights_only=True)
    fr.apply_scaled_outer.launches = 0
    res2 = train_cli.main(args + ["--num_epochs", "3", "--resume"])
    torch.cuda.synchronize()
    resume_launches = fr.apply_scaled_outer.launches
    resume_steps = res2["global_step"] - steps
    last2 = torch.load(log_dir / "model_last.pt", weights_only=True)
    records = _metrics_records(log_dir)
    traces = sorted(p.name for p in trace_dir.glob("*.json"))
    out = {"optimizer": LEAN_OPTIMIZER, "train_steps": steps,
           "launches": launches, "fused_readout": res["fused_readout"],
           "resume_steps": resume_steps, "resume_launches": resume_launches,
           "rest_count": last["opt_state"]["rest"]["count"],
           "fused_count": last["opt_state"]["fused"]["count"],
           "resume_rest_count": last2["opt_state"]["rest"]["count"],
           "metrics_records": records, "traces": traces,
           "trace_bytes": sum((trace_dir / t).stat().st_size
                              for t in traces),
           "test": res["test_res"], "run_seconds": run_s,
           "ms_per_step_run": run_s / steps * 1e3,
           "train_losses": res["train_losses"] + res2["train_losses"]}
    if not (res["fused_readout"] and res2["fused_readout"]):
        raise AssertionError("the fused readout step was not engaged")
    if steps == 0 or launches != steps or resume_steps <= 0 \
            or resume_launches != resume_steps:
        raise AssertionError(f"lean path: launches {launches} for {steps} "
                             f"steps, {resume_launches} for {resume_steps} "
                             f"resumed steps")
    if not (res["trace_paths"] and traces):
        raise AssertionError(f"no profiler trace under {trace_dir}")
    if (out["rest_count"] != steps or out["fused_count"] != steps
            or out["resume_rest_count"] != steps + resume_steps):
        raise AssertionError(f"optimizer counts: {out}")
    if len(records) != 3 or [r["epoch"] for r in records] != [0, 1, 2] \
            or not _finite_records(records, ("train_loss", "lr", "eval_bps",
                                             "eval_rsquared")):
        raise AssertionError(f"metrics.jsonl: {records}")
    if not (math.isfinite(res["best_eval_bps"])
            and math.isfinite(res["test_res"]["test_bps"])):
        raise AssertionError(f"lean path results not finite: {res}")
    out["staged"] = staged_ms_per_step(
        work, _variant_yaml(work, "lean_staged", LEAN_OPTIMIZER),
        "lean_timing")
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("linear_lean_path", **out)
    return out


class _LogLines:
    """The port's log lines while the block runs."""

    def __enter__(self):
        import logging

        self.lines = []
        handler = logging.Handler()
        handler.emit = lambda rec: self.lines.append(rec.getMessage())
        self._handler = handler
        logging.getLogger("video_spike_torch").addHandler(handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("video_spike_torch").removeHandler(self._handler)


def phase_linear_accum_path(work: Path) -> dict:
    """``cli.train`` on the full-width Linear with ``adamw_sr_bf16`` and
    ``gradient_accumulation_steps: 2`` for 2 epochs: the fused readout is
    turned off (the log says so) and the kernel never launches; the
    checkpoint's MultiSteps counters agree with the micro-steps taken."""
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.ops import fused_readout as fr

    t0 = time.perf_counter()
    train_yaml = _variant_yaml(work, "accum", ACCUM_OPTIMIZER)
    fr.apply_scaled_outer.launches = 0
    with _LogLines() as log:
        res = train_cli.main(_linear_args(work, train_yaml, "accum_logs")
                             + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    steps = res["global_step"]
    log_dir = Path(res["log_dir"])
    state = torch.load(log_dir / "model_last.pt",
                       weights_only=True)["opt_state"]["tx"]
    records = _metrics_records(log_dir)
    off = [l for l in log.lines if "fused_readout disabled" in l]
    out = {"optimizer": ACCUM_OPTIMIZER, "micro_steps": steps,
           "launches": launches, "fused_readout": res["fused_readout"],
           "log": off, "mini_step": state["mini_step"],
           "gradient_step": state["gradient_step"],
           "inner_count": state["inner"]["count"],
           "metrics_records": records, "test": res["test_res"],
           "run_seconds": run_s, "ms_per_micro_step_run": run_s / steps * 1e3}
    k = ACCUM_OPTIMIZER["gradient_accumulation_steps"]
    if res["fused_readout"] or launches or not any(
            "gradient accumulation" in l for l in off):
        raise AssertionError(f"accum path: fused {res['fused_readout']}, "
                             f"launches {launches}, log {off}")
    if (steps == 0 or state["gradient_step"] != steps // k
            or state["mini_step"] != steps % k
            or state["inner"]["count"] != steps // k):
        raise AssertionError(f"MultiSteps counters vs {steps} steps: {out}")
    if len(records) != 2 or not _finite_records(
            records, ("train_loss", "lr", "eval_loss", "eval_bps",
                      "eval_rsquared")) \
            or not all(math.isfinite(v) for v in res["test_res"].values()):
        raise AssertionError(f"accum path metrics: {records}, "
                             f"{res['test_res']}")
    emit("linear_accum_path", **out)
    return out


# ---------------------------------------------------------------------------
# phase 3d: the streaming path (native reader, pinned prefetch, background
# checkpoint flushes) at full width
# ---------------------------------------------------------------------------

STREAM_EID = "streameid0"
STREAM_TRIALS = 160          # 128 train = 8 steps an epoch at batch 16
STREAM_STALL_STEPS = 20      # staged steps timed with and without a flush
STREAM_H2D_REPS = 10
# reckoned figures printed beside the measured ones: the pageable copy rate
# the serving phase measured (PERF.md section 5; NVIDIA H100 80GB HBM3 at
# 700 W) and the nominal PCIe Gen5 x16 rate of the H100 SXM's host link,
# per direction
PAGEABLE_GB_S = 5.0
PCIE_GB_S = 64.0


def _stream_args(work: Path, train_yaml: Path, log_dir: str) -> list:
    return ["--model_config", str(ROOT / "configs/model/linear_video.yaml"),
            "--train_config", str(train_yaml), "--eid", STREAM_EID,
            "--data_dir", str(work / "stream_data"),
            "--log_dir", str(work / log_dir),
            "--batch_size", str(BATCH), "--device", "cuda"]


def _assert_bitwise(got, ref, what: str) -> None:
    import torch

    if isinstance(ref, dict):
        if got.keys() != ref.keys():
            raise AssertionError(f"{what}: keys differ")
        for k in ref:
            _assert_bitwise(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, torch.Tensor):
        if got.dtype != ref.dtype or not torch.equal(got.cpu(), ref.cpu()):
            raise AssertionError(f"{what}: not bitwise equal")
    elif got != ref:
        raise AssertionError(f"{what}: {got} != {ref}")


def _reader_rate(files, backend: str) -> dict:
    """One epoch of the train shards through SessionDataset(cache=False)."""
    from video_spike_torch.data.dataset import SessionDataset

    ds = SessionDataset(files, BATCH, modalities=["ap", "video", "timestamp"],
                        cache=False, io_backend=backend)
    t0 = time.perf_counter()
    n = sum(b["ap"].shape[0] for b in ds)
    s = time.perf_counter() - t0
    nbytes = sum(Path(f).stat().st_size for f in files)
    return {"trials": n, "seconds": s, "trials_per_s": n / s,
            "mb_per_s": nbytes / s / 1e6, "blobs_read": ds.blobs_read}


def _h2d_rates() -> dict:
    """GB/s of the Linear batch (16 x 1,966,080 uint8 + 16 x 100 x 436 f32)
    from pageable numpy memory (a synchronous copy, the port's old streamed
    path) and from a pinned buffer (non_blocking, the prefetch's)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (BATCH, KERNEL_M), dtype=np.uint8)
    ap = rng.poisson(1.0, (BATCH, 100, N_NEURONS)).astype(np.float32)
    nbytes = x.nbytes + ap.nbytes
    dev = torch.device("cuda")

    def pageable():
        torch.from_numpy(x).to(dev)
        torch.from_numpy(ap).to(dev)

    px, pap = (torch.from_numpy(x).pin_memory(),
               torch.from_numpy(ap).pin_memory())

    def pinned():
        px.to(dev, non_blocking=True)
        pap.to(dev, non_blocking=True)

    out = {"batch_bytes": nbytes}
    for name, fn in (("pageable", pageable), ("pinned", pinned),
                     ("pinned_again", pinned), ("pageable_again", pageable)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STREAM_H2D_REPS):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STREAM_H2D_REPS * 1e3
        out[name] = {"ms": ms, "gb_per_s": nbytes / ms / 1e6}
    out["reckoned_ms"] = {"pageable": nbytes / PAGEABLE_GB_S / 1e6,
                          "pinned": nbytes / PCIE_GB_S / 1e6}
    return out


def _producer_ms(trainer) -> dict:
    """ms a batch of what feeds the streamed step, without the step, over 2
    epochs from the host cache: the loader alone (collate), then the loader
    through ``prefetch_to_device`` (assembly, the pinned ring, the copy)."""
    import torch

    from video_spike_torch.data.prefetch import prefetch_to_device

    out = {}
    for name, epoch in (
            ("loader", lambda: trainer.train_loader),
            ("prefetch", lambda: prefetch_to_device(
                trainer.train_loader, trainer.device, depth=2,
                transform=trainer._host_batch))):
        n = 0
        t0 = time.perf_counter()
        for _ in range(2):
            for _batch in epoch():
                n += 1
        torch.cuda.synchronize()
        out[f"{name}_ms_per_batch"] = (time.perf_counter() - t0) / n * 1e3
    return out


def _flush_stall(work: Path, train_yaml: Path) -> dict:
    """ms/step of STREAM_STALL_STEPS staged steps (host clock, synchronized
    each step) without a flush, then with an async ``model_best`` flush in
    flight, then the seconds of the same save done synchronously."""
    import numpy as np
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args
    from video_spike_torch.train.checkpoint import wait_for_checkpoints

    trainer = train_cli.build_trainer(get_args(
        _stream_args(work, train_yaml, "stream_stall")))
    trainer.train_epoch()                         # stages data, warms up
    X, A = trainer._dev_data
    rng = np.random.default_rng(0)

    def steps():
        out = []
        for _ in range(STREAM_STALL_STEPS):
            idx = torch.from_numpy(rng.choice(X.shape[0], BATCH,
                                              replace=False)).cuda()
            t0 = time.perf_counter()
            trainer._step(X.index_select(0, idx), A.index_select(0, idx),
                          BATCH)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer._best_params = {k: v.clone() for k, v in trainer.params.items()}
    nbytes = sum(v.nbytes for v in trainer._best_params.values())
    steps()                                       # warm
    quiet = steps()
    t0 = time.perf_counter()
    trainer.save_model("best", 0, block=False)
    during = steps()
    handed = time.perf_counter() - t0
    wait_for_checkpoints()
    async_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.save_model("best", 0)
    sync_s = time.perf_counter() - t0
    del trainer, X, A
    _free_card()
    return {"flush_bytes": nbytes,
            "quiet_ms": {"median": statistics.median(quiet),
                         "max": max(quiet)},
            "during_flush_ms": {"median": statistics.median(during),
                                "max": max(during)},
            "steps_inside_flush_seconds": handed,
            "async_flush_seconds": async_s, "sync_save_seconds": sync_s,
            "quiet_ms_all": quiet, "during_flush_ms_all": during}


def phase_stream_main_path(work: Path, staged_ms: float) -> dict:
    """``cli.train`` on the full-width Linear in the production
    configuration, streaming (``device_cache: false``) from tar shards
    through the native reader and the pinned prefetch, with ``save_every:
    1`` (background best flushes), 2 epochs then ``--resume`` to 3: a launch
    a step; the native reader read every train shard; ``model_best.pt``
    and ``model_last.pt`` bitwise what they snapshot. Then the reader's
    rate (native against python), the batch's H2D rate (pageable against
    pinned), the streamed step against the staged one and against what
    feeds it (the loader, the prefetch without the step), and the
    step-loop stall of a model_best flush."""
    import torch

    from video_spike_torch.cli import make_fixture
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args
    from video_spike_torch.ops import fused_readout as fr
    from video_spike_torch.train.checkpoint import load_checkpoint, to_cpu

    _free_card()
    t_phase = time.perf_counter()
    make_fixture.main(["--out", str(work / "stream_data"), "--eid",
                       STREAM_EID, "--n_trials", str(STREAM_TRIALS),
                       "--n_neurons", str(N_NEURONS),
                       "--height", str(HEIGHT), "--width", str(WIDTH)])
    fixture_s = time.perf_counter() - t_phase
    train_yaml = _variant_yaml(work, "stream", PRODUCTION_OPTIMIZER,
                               {"device_cache": False, "save_every": 1})
    args = _stream_args(work, train_yaml, "stream_logs")
    trainer = train_cli.build_trainer(get_args(args + ["--num_epochs", "2"]))
    live = {}
    test_model = trainer.test_model

    def capture_then_test():
        # what model_last snapshots: the live tensors after the last step
        live["params"] = to_cpu(trainer.params)
        live["opt_state"] = to_cpu(trainer._opt_state_tree())
        return test_model()

    trainer.test_model = capture_then_test
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    t0 = time.perf_counter()
    res = trainer.train()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["global_step"]
    loader = trainer.train_loader
    n_train = loader.num_trials
    read = dict(loader.blobs_read)
    all_cached = set(loader.files) <= set(loader._cache)
    log_dir = Path(res["log_dir"])
    best = load_checkpoint(log_dir, "model_best")
    _assert_bitwise(best["params"], trainer._best_params, "model_best")
    last = load_checkpoint(log_dir, "model_last")
    _assert_bitwise(last["params"], live["params"], "model_last params")
    _assert_bitwise(last["opt_state"], live["opt_state"],
                    "model_last opt_state")
    split = dict(trainer.split)
    del trainer, best, last, live, loader
    _free_card()
    if not res["fused_readout"] or steps != 2 * (n_train // BATCH) \
            or launches != steps:
        raise AssertionError(f"stream path: {launches} launches, {steps} "
                             f"steps, fused {res['fused_readout']}")
    if read["python"] or read["native"] < n_train or not all_cached:
        raise AssertionError(f"the native reader did not read every train "
                             f"shard: {read}, all cached {all_cached}")
    if not (all(map(math.isfinite, res["train_losses"]))
            and math.isfinite(res["best_eval_bps"])
            and all(math.isfinite(v) for v in res["test_res"].values())):
        raise AssertionError(f"stream path results not finite: {res}")

    fr.apply_scaled_outer.launches = 0
    res2 = train_cli.main(args + ["--num_epochs", "3", "--resume"])
    torch.cuda.synchronize()
    resume_launches = fr.apply_scaled_outer.launches
    resume_steps = res2["global_step"] - steps
    if res2["start_epoch"] != 2 or resume_steps != n_train // BATCH \
            or resume_launches != resume_steps:
        raise AssertionError(f"stream resume: start_epoch "
                             f"{res2['start_epoch']}, steps {steps}->"
                             f"{res2['global_step']}, launches "
                             f"{resume_launches}")
    _free_card()

    # the reader: native against python, one epoch each, no cache
    readers = {b: _reader_rate(split["train"], b)
               for b in ("native", "python")}
    h2d = _h2d_rates()
    # the streamed step: 2 epochs through the prefetch (the host cache
    # serves the shards), host clock; against the staged step of step_time
    trainer = train_cli.build_trainer(get_args(args + ["--num_epochs", "3"]))
    trainer.train_epoch()                         # reads, warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step0 = trainer.global_step
    for _ in range(2):
        trainer.train_epoch()
    torch.cuda.synchronize()
    streamed_ms = (time.perf_counter() - t0) / (trainer.global_step
                                                - step0) * 1e3
    producer = _producer_ms(trainer)
    del trainer
    _free_card()
    stall = _flush_stall(work, _variant_yaml(work, "stream_staged",
                                             PRODUCTION_OPTIMIZER))
    out = {"trials": STREAM_TRIALS, "train_trials": n_train,
           "fixture_seconds": fixture_s, "train_steps": steps,
           "launches": launches, "resume_steps": resume_steps,
           "resume_launches": resume_launches, "blobs_read": read,
           "train_losses": res["train_losses"] + res2["train_losses"],
           "best_eval_bps": res["best_eval_bps"], "test": res["test_res"],
           "run_seconds": run_s, "peak_mem_gb": peak_gb,
           "checkpoints_bitwise": True, "reader": readers,
           "reader_needed_trials_per_s": BATCH / (staged_ms / 1e3),
           "h2d": h2d, "streamed_ms_per_step": streamed_ms,
           "staged_ms_per_step": staged_ms, "producer": producer,
           "flush_stall": stall}
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("stream_main_path", **out)
    return out


# ---------------------------------------------------------------------------
# phase 3f: data parallel across processes (torch.distributed)
# ---------------------------------------------------------------------------

DP_WORLD = 2                  # gloo ranks sharing the one card
DP_TIMED_EPOCHS = 5           # staged epochs a timing window (2 steps each)
DP_LAUNCH_TIMEOUT = 420
DP_LOSS_RTOL = 1e-3           # the 2-rank step's loss against one rank's
DP_SERVE_BUCKETS = (1, 2, 4, 8)
DP_SERVE_ROWS = (3, 8)


def _backend_env(backend: str) -> dict:
    """The ranks' environment for `backend`: gloo is asked for by name
    (ranks sharing the card); NCCL is what ``setup_runtime`` picks for
    ``cuda`` when ``VST_DIST_BACKEND`` is unset (``main_cards`` unsets
    it)."""
    return {"VST_DIST_BACKEND": "gloo"} if backend == "gloo" else {}


def card_report() -> dict:
    """This rank's backend and card: index, name, PCI bus id (as
    ``nvidia-smi`` writes it) and UUID."""
    import os

    import torch
    import torch.distributed as dist

    dev = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(dev)
    pci = (None if getattr(props, "pci_bus_id", None) is None else
           f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
           f"{props.pci_device_id:02X}.0")
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "local_rank": int(os.environ.get("LOCAL_RANK", -1)),
            "backend": dist.get_backend(), "current_device": dev,
            "name": torch.cuda.get_device_name(dev), "pci_bus_id": pci,
            "uuid": str(props.uuid)}


def check_cards(reports: list, world: int) -> None:
    """`world` ranks, every one on NCCL and on a card of its own (distinct
    device index, UUID and PCI bus id); raises naming the reports."""
    keys = ("current_device", "uuid") + (
        ("pci_bus_id",) if all(r["pci_bus_id"] for r in reports) else ())
    if len(reports) != world \
            or any(r["backend"] != "nccl" or r["world"] != world
                   for r in reports) \
            or any(len({r[k] for r in reports}) != world for k in keys):
        raise AssertionError(f"want {world} NCCL ranks on {world} distinct "
                             f"cards: {reports}")

_CHILD_TIMING = r"""
def staged_ms(trainer, windows, epochs, barrier=None):
    trainer.train_epoch()                       # stages the trials, warms
    ms = []
    for _ in range(windows):
        if barrier:
            barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s0 = trainer.global_step
        start.record()
        for _ in range(epochs):
            trainer.train_epoch()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / (trainer.global_step - s0))
    return ms
"""

# one data-parallel step (this rank's rows, the factors gathered) against the
# one-rank fused step on all the rows, from the same params p0, in the same
# process: needs trainer, p0, g, rows, b, rank and cfg["neurons"]
_CHILD_SAME_ROWS = r"""
x = torch.randint(0, 256, (rows, p0[fr.FIRST_KERNEL].shape[0]), generator=g,
                  device="cuda", dtype=torch.uint8)
ap = torch.poisson(torch.full((rows, 100, cfg["neurons"]), 0.5,
                              device="cuda"), generator=g)
one_step = fr.make_fused_linear_step(trainer.model, trainer.tx,
                                     trainer.schedule, trainer.criterion,
                                     trainer._apply_updates)


def start():
    p = {k: v.clone() for k, v in p0.items()}
    return p, fr.init_fused_opt_state(p, trainer.tx)


p_dp, _, loss_dp = trainer._step_fn(*start(), x[rank * b:(rank + 1) * b],
                                    ap[rank * b:(rank + 1) * b], rows, 0)
p_1, _, loss_1 = one_step(*start(), x, ap, rows, 0)
w_dp, w_1 = p_dp[fr.FIRST_KERNEL], p_1[fr.FIRST_KERNEL]
w_0 = p0[fr.FIRST_KERNEL]
# compared a block of rows at a time: f32 copies of the whole W are 2 GB
# each, and several ranks share the card
n_equal = n_outside = 0
max_diff = max_update = 0.0
for r0 in range(0, w_dp.shape[0], 1 << 18):
    blk = slice(r0, r0 + (1 << 18))
    a32, b32 = w_dp[blk].float(), w_1[blk].float()
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.maximum(a32.abs(), b32.abs()).clamp_min(1e-38))) - 7)
    n_equal += int((w_dp[blk].view(torch.int16)
                    == w_1[blk].view(torch.int16)).sum())
    n_outside += int(((a32 - b32).abs() > ulp).sum())
    max_diff = max(max_diff, float((a32 - b32).abs().max()))
    max_update = max(max_update, float((b32 - w_0[blk].float()).abs().max()))
    del a32, b32, ulp
same_rows = {
    "loss_dp": float(loss_dp), "loss_one_rank": float(loss_1),
    "w_frac_bitwise": n_equal / w_dp.numel(), "w_outside_1ulp": n_outside,
    "w_max_abs_diff_over_max_update": max_diff / max_update,
    "w_checksums": mh.replica_checksums({"w": w_dp}, dist.group.WORLD)}
"""

# every rank: cli.train 2 epochs, --resume to 3, staged ms/step, then one
# 2-rank step (this rank's rows, the factors gathered) against the one-rank
# fused step on all 16 rows, from the same params, in the same process
DP_TRAIN_CHILD = r"""
import json, sys, time
import torch
import torch.distributed as dist
from video_spike_torch.cli import train as train_cli
from video_spike_torch.core.cli import get_args
from video_spike_torch.core.runtime import exit_rank
from video_spike_torch.ops import fused_adamw
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.parallel import multihost as mh
""" + _CHILD_TIMING + r"""
cfg = json.loads(sys.argv[1])
fr.apply_scaled_outer.launches = fused_adamw.step_.launches = 0
res = train_cli.main(cfg["argv"] + ["--num_epochs", "2"])
launches = fr.apply_scaled_outer.launches
fr.apply_scaled_outer.launches = 0
res2 = train_cli.main(cfg["argv"] + ["--num_epochs", "3", "--resume"])
resume_launches = fr.apply_scaled_outer.launches
adamw_launches = fused_adamw.step_.launches
rank, world = mh.process_index(), mh.process_count()
trainer = train_cli.build_trainer(get_args(cfg["timing_argv"]))
ms = staged_ms(trainer, cfg["windows"], cfg["epochs"], dist.barrier)

p0 = {k: v.clone() for k, v in trainer.params.items()}
g = torch.Generator(device="cuda").manual_seed(1234)
rows, b = cfg["batch"], cfg["batch"] // world

# the factor gather alone: this rank's (b, M) bf16 rows (host clock; gloo
# returns once the rows are in place)
flat = torch.zeros((b, p0[fr.FIRST_KERNEL].shape[0]), dtype=torch.bfloat16,
                   device="cuda")
gather_ms = []
for i in range(6):
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mh.gather_rows(flat, dist.group.WORLD)
    torch.cuda.synchronize()
    if i:
        gather_ms.append((time.perf_counter() - t0) * 1e3)
del flat
""" + _CHILD_SAME_ROWS + r"""
out = {"rank": rank, "world": world, "backend": dist.get_backend(),
       "train_losses": res["train_losses"], "steps": res["global_step"],
       "launches": launches, "replica_checksums": res["replica_checksums"],
       "resume_start_epoch": res2["start_epoch"],
       "resume_steps": res2["global_step"] - res["global_step"],
       "resume_launches": resume_launches, "adamw_launches": adamw_launches,
       "resume_replica_checksums": res2["replica_checksums"],
       "test": res["test_res"], "log_dir": res["log_dir"],
       "ms_per_step_windows": ms, "gather_ms": gather_ms,
       "same_rows": same_rows}
with open(f"{cfg['out']}{rank}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank of DP4_WORLD: cli.train one epoch on its shard of the 160-trial
# fixture at BATCH rows (2 steps, each fused update on the gathered
# DP4_WORLD * BATCH rows), the kernel's B at each launch, then the same-rows
# step on all DP4_WORLD * BATCH rows
DP4_CHILD = r"""
import gc, json, sys
import torch
import torch.distributed as dist
from video_spike_torch.cli import train as train_cli
from video_spike_torch.core.cli import get_args
from video_spike_torch.core.runtime import exit_rank
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.parallel import multihost as mh

cfg = json.loads(sys.argv[1])
batches, _launch = [], fr._launch_cuda


def recording_launch(w, xa, dzc, seed):
    batches.append(int(xa.shape[0]))
    return _launch(w, xa, dzc, seed)


fr._launch_cuda = recording_launch
fr.apply_scaled_outer.launches = 0
res = train_cli.main(cfg["argv"] + ["--num_epochs", "1"])
launches, kernel_batches = fr.apply_scaled_outer.launches, list(batches)
gc.collect()
torch.cuda.empty_cache()
rank, world = mh.process_index(), mh.process_count()
trainer = train_cli.build_trainer(get_args(cfg["argv"] + ["--num_epochs",
                                                          "1"]))
trainer._init_if_needed()
p0 = {k: v.clone() for k, v in trainer.params.items()}
g = torch.Generator(device="cuda").manual_seed(1234)
rows, b = cfg["batch"], cfg["batch"] // world
""" + _CHILD_SAME_ROWS + r"""
# where a rank's rows part from the same rows inside the one-process batch:
# the first Dense and the model's output on BATCH rows against the same rows
# of the all-rows forward (cuBLAS may take another GEMM at another M)
with torch.no_grad():
    mine = slice(rank * b, (rank + 1) * b)
    kd = p0[fr.FIRST_KERNEL].to(trainer.model.compute_dtype)
    bias = p0[fr.FIRST_BIAS]
    flat = fr.preprocess_flat(trainer.model, x)
    z_all = flat @ kd
    z_mine = flat[mine] @ kd
    o_all = fr.tail_apply(trainer.model, p0, z_all + bias.to(z_all.dtype))
    o_mine = fr.tail_apply(trainer.model, p0, z_mine + bias.to(z_mine.dtype))
    same_rows.update(
        first_dense_rows_bitwise=bool(torch.equal(z_mine, z_all[mine])),
        output_rows_bitwise=bool(torch.equal(o_mine, o_all[mine])),
        output_rows_max_abs=float((o_mine - o_all[mine]).abs().max()))
out = {"rank": rank, "world": world, "backend": dist.get_backend(),
       "train_losses": res["train_losses"], "steps": res["global_step"],
       "launches": launches, "kernel_batches": kernel_batches,
       "replica_checksums": res["replica_checksums"],
       "log_dir": res["log_dir"], "same_rows": same_rows}
with open(f"{cfg['out']}{rank}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# one rank under NCCL: cli.train 2 epochs, NCCL's collectives on the card,
# staged ms/step
DP_NCCL_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
from video_spike_torch.cli import train as train_cli
from video_spike_torch.core.cli import get_args
from video_spike_torch.core.runtime import exit_rank
from video_spike_torch.ops import fused_readout as fr
""" + _CHILD_TIMING + r"""
cfg = json.loads(sys.argv[1])
fr.apply_scaled_outer.launches = 0
res = train_cli.main(cfg["argv"] + ["--num_epochs", "2"])
launches = fr.apply_scaled_outer.launches
t = torch.arange(4.0, device="cuda")
dist.all_reduce(t)
parts = [torch.empty_like(t)]
dist.all_gather(parts, t)
dist.barrier()
trainer = train_cli.build_trainer(get_args(cfg["timing_argv"]))
ms = staged_ms(trainer, cfg["windows"], cfg["epochs"])
out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
       "collectives_ok": bool(torch.equal(parts[0], torch.arange(
           4.0, device="cuda"))),
       "train_losses": res["train_losses"], "steps": res["global_step"],
       "launches": launches, "log_dir": res["log_dir"],
       "ms_per_step_windows": ms}
with open(f"{cfg['out']}0.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: the Linear model_best served with the first kernel's rows
# split over the model axis of a {data: 1, model: 2} mesh
DP_SERVE_CHILD = r"""
import json, sys
import numpy as np
import torch
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import first_layer_sharding_rules
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.serve.session import InferenceSession

cfg = json.loads(sys.argv[1])
assert setup_runtime("cuda")
session = InferenceSession.from_checkpoint(
    cfg["model_config"], cfg["ckpt_dir"], bucket_sizes=cfg["buckets"],
    device="cuda", mesh=make_mesh(n_data=1, n_model=mh.process_count()),
    sharding_rules=first_layer_sharding_rules)
rows = np.load(cfg["rows"])
outs = {str(n): session.predict(rows[:n]) for n in cfg["sizes"]}
np.savez(f"{cfg['out']}{mh.process_index()}.npz",
         kernel_rows=session.params[fr.FIRST_KERNEL].shape[0],
         launches=fr.apply_scaled_outer.launches, **outs)
exit_rank()
"""


def _torchrun(code: str, nproc: int, cfg: dict, env: dict = None,
              timeout: float = None) -> float:
    """``python -m torch.distributed.run --standalone`` with `nproc` ranks
    running `code` on ``json.dumps(cfg)`` (within `timeout` seconds,
    DP_LAUNCH_TIMEOUT by default); raises with the output's tail on a
    non-zero exit; returns the wall seconds."""
    import os

    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "--no-python", sys.executable, "-c",
         code, json.dumps(cfg)],
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
        capture_output=True, text=True, timeout=timeout or DP_LAUNCH_TIMEOUT)
    if p.returncode != 0:
        text = p.stdout + p.stderr
        first = text.find("Traceback")      # the first rank's failure
        raise AssertionError(f"torchrun ({nproc} ranks) failed:\n"
                             + (text[first:first + 4000] + "\n...\n"
                                if first >= 0 else "") + text[-6000:])
    return time.perf_counter() - t0


def _bf16_w(log_dir: str):
    from video_spike_torch.ops import fused_readout as fr
    from video_spike_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(log_dir, "model_last")["params"][fr.FIRST_KERNEL]


def _dp4_linear(work: Path, train_yaml: Path) -> dict:
    """DP4_WORLD gloo ranks sharing the card, BATCH rows each, one epoch of
    the 160-trial fixture (``phase_stream_main_path`` makes it): every
    fused update runs the kernel on the gathered DP4_WORLD * BATCH rows, a
    launch a step, the replicas' W bitwise equal; then one step against
    the one-process step on the same rows. W is bitwise that step's, or
    the ranks' forward on BATCH rows parts from the same rows inside the
    all-rows batch (the stated cause: cuBLAS's GEMM at another M), and
    the difference is reported."""
    global_rows = DP4_WORLD * BATCH
    dp4_s = _torchrun(DP4_CHILD, DP4_WORLD, {
        "argv": _stream_args(work, train_yaml, "dp4_logs"),
        "out": str(work / "dp4_rank"), "batch": global_rows,
        "neurons": N_NEURONS}, env={"VST_DIST_BACKEND": "gloo"})
    ranks4 = [json.loads((work / f"dp4_rank{r}.json").read_text())
              for r in range(DP4_WORLD)]
    q0 = ranks4[0]
    if any(r["backend"] != "gloo" or r["world"] != DP4_WORLD for r in ranks4):
        raise AssertionError(f"not {DP4_WORLD} gloo ranks: {ranks4}")
    for key in ("train_losses", "steps", "replica_checksums"):
        if any(r[key] != q0[key] for r in ranks4):
            raise AssertionError(f"{DP4_WORLD} ranks differ in {key}: "
                                 f"{[r[key] for r in ranks4]}")
    for r in ranks4:
        if r["steps"] == 0 or r["launches"] != r["steps"] \
                or r["kernel_batches"] != [global_rows] * r["steps"]:
            raise AssertionError(f"rank {r['rank']} of {DP4_WORLD}: "
                                 f"launches {r['launches']}, steps "
                                 f"{r['steps']}, kernel B "
                                 f"{r['kernel_batches']}")
    same4 = [r["same_rows"] for r in ranks4]
    t0 = same4[0]
    shared = ("loss_dp", "loss_one_rank", "w_frac_bitwise", "w_outside_1ulp",
              "w_checksums", "w_max_abs_diff_over_max_update")
    bitwise = t0["w_frac_bitwise"] == 1.0
    forward_parts = not all(x["first_dense_rows_bitwise"]
                            and x["output_rows_bitwise"] for x in same4)
    if len(set(t0["w_checksums"])) != 1 \
            or abs(t0["loss_dp"] - t0["loss_one_rank"]) \
            > DP_LOSS_RTOL * abs(t0["loss_one_rank"]) \
            or any({k: x[k] for k in shared} != {k: t0[k] for k in shared}
                   for x in same4) \
            or not (bitwise or forward_parts):
        raise AssertionError(f"{DP4_WORLD}-rank step vs one-rank step on "
                             f"the same {global_rows} rows: {same4}")
    return {"world": DP4_WORLD, "local_batch": BATCH,
            "global_batch": global_rows, "steps_per_rank": q0["steps"],
            "launches_per_rank": [r["launches"] for r in ranks4],
            "launches": sum(r["launches"] for r in ranks4),
            "kernel_batches": q0["kernel_batches"],
            "train_losses": q0["train_losses"],
            "replica_checksums": q0["replica_checksums"],
            "same_rows_step": same4, "w_bitwise_one_process": bitwise,
            "forward_rows_part_at_batch": forward_parts,
            "launch_seconds": dp4_s}


def phase_dist_main_path(work: Path, staged_ms: float) -> dict:
    """The production Linear at full width through ``cli.train`` across
    processes: (a) 2 gloo ranks sharing the card, local batch 8 (global
    16), 2 epochs then ``--resume`` to 3, every rank's kernel launches equal
    to its steps, the replicas' W checksums equal every epoch, rank 0 the
    only writer, staged ms/step, and one 2-rank step against the one-rank
    step on the same 16 rows; (b) NCCL at world 1 under the launcher,
    whose losses and W after 2 epochs equal the non-distributed run's;
    (c) the model-sharded serving session on 2 gloo ranks against the
    one-rank session; (d) DP4_WORLD gloo ranks at BATCH rows each on the
    160-trial fixture, one epoch (2 steps), so the kernel takes the
    gathered DP4_WORLD * BATCH rows: every launch at that B, launches equal
    to steps, W checksums equal, and one step against the one-rank step on
    the same rows."""
    import numpy as np
    import torch
    import yaml

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.ops import fused_readout as fr
    from video_spike_torch.serve.session import InferenceSession

    _free_card()
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    train_yaml = _train_yaml(work)

    def argv(log_dir: str, batch: int) -> list:
        return ["--model_config", str(ROOT / "configs/model/linear_video.yaml"),
                "--train_config", str(train_yaml), "--eid", "smokeeid0",
                "--data_dir", str(work / "data"), "--log_dir",
                str(work / log_dir), "--batch_size", str(batch),
                "--device", "cuda"]

    # (a) two gloo ranks on the card
    local = BATCH // DP_WORLD
    dp_s = _torchrun(DP_TRAIN_CHILD, DP_WORLD, {
        "argv": argv("dp_logs", local),
        "timing_argv": argv("dp_timing", local),
        "out": str(work / "dp_rank"), "windows": REPS,
        "epochs": DP_TIMED_EPOCHS, "batch": BATCH, "neurons": N_NEURONS},
        env={"VST_DIST_BACKEND": "gloo"})
    ranks = [json.loads((work / f"dp_rank{r}.json").read_text())
             for r in range(DP_WORLD)]
    r0 = ranks[0]
    if any(r["backend"] != "gloo" or r["world"] != DP_WORLD for r in ranks):
        raise AssertionError(f"not {DP_WORLD} gloo ranks: {ranks}")
    for key in ("train_losses", "steps", "replica_checksums", "test",
                "resume_replica_checksums"):
        if any(r[key] != r0[key] for r in ranks):
            raise AssertionError(f"ranks differ in {key}: "
                                 f"{[r[key] for r in ranks]}")
    if len(r0["replica_checksums"]) != 2 \
            or len(r0["resume_replica_checksums"]) != 1:
        raise AssertionError(f"want a W checksum an epoch: {r0}")
    # the production optimizer steps through the fused readout: no rank
    # launches the fused AdamW
    for r in ranks:
        if r["launches"] != r["steps"] or r["steps"] == 0 \
                or r["resume_launches"] != r["resume_steps"] \
                or r["resume_steps"] == 0 or r["resume_start_epoch"] != 2 \
                or r["adamw_launches"]:
            raise AssertionError(f"rank {r['rank']}: launches "
                                 f"{r['launches']} / steps {r['steps']}, "
                                 f"resume {r['resume_launches']} / "
                                 f"{r['resume_steps']} from epoch "
                                 f"{r['resume_start_epoch']}, fused AdamW "
                                 f"{r['adamw_launches']}")
    if not all(math.isfinite(v) for v in r0["train_losses"]):
        raise AssertionError(f"non-finite loss: {r0['train_losses']}")
    run_dir = Path(r0["log_dir"])
    written = sorted(p.name for p in run_dir.iterdir())
    if written != ["metrics.jsonl", "model_best.pt", "model_last.pt",
                   "test_results.npy"]:
        raise AssertionError(f"rank-0 artifacts: {written}")
    records = _metrics_records(run_dir)
    if len(records) != 3 or any("replica_checksum" not in rec
                                for rec in records):
        raise AssertionError(f"metrics.jsonl: one record an epoch with its "
                             f"checksum, got {records}")
    same = [r["same_rows"] for r in ranks]
    s0 = same[0]
    if len(set(s0["w_checksums"])) != 1 \
            or abs(s0["loss_dp"] - s0["loss_one_rank"]) \
            > DP_LOSS_RTOL * abs(s0["loss_one_rank"]) \
            or s0["w_frac_bitwise"] < 0.999 or s0["w_outside_1ulp"] \
            or any(s != s0 for s in same):
        raise AssertionError(f"2-rank step vs one-rank step on the same "
                             f"{BATCH} rows: {same}")
    dp_ms = statistics.median(ms for r in ranks
                              for ms in r["ms_per_step_windows"])
    factor_bytes = {   # flat (bf16) and dz (f32) a step
        "sent_per_rank": local * (KERNEL_M * 2 + KERNEL_N * 4),
        "gathered_per_rank": BATCH * (KERNEL_M * 2 + KERNEL_N * 4)}

    # (b) NCCL at world 1 through the same CLI, against the non-distributed
    # run (in this process, twice if the first is not bitwise)
    nccl_s = _torchrun(DP_NCCL_CHILD, 1, {
        "argv": argv("nccl_logs", BATCH),
        "timing_argv": argv("nccl_timing", BATCH),
        "out": str(work / "nccl_rank"), "windows": REPS,
        "epochs": DP_TIMED_EPOCHS})
    nccl = json.loads((work / "nccl_rank0.json").read_text())
    if nccl["backend"] != "nccl" or nccl["world"] != 1 \
            or not nccl["collectives_ok"] \
            or nccl["launches"] != nccl["steps"]:
        raise AssertionError(f"NCCL world 1: {nccl}")
    refs = []

    def reference() -> dict:
        fr.apply_scaled_outer.launches = 0
        res = train_cli.main(argv(f"ref_logs{len(refs)}", BATCH)
                             + ["--num_epochs", "2"])
        torch.cuda.synchronize()
        refs.append({"losses": res["train_losses"],
                     "w": _bf16_w(res["log_dir"])})
        return refs[-1]

    def differ(a: dict, b: dict) -> dict:
        bits = a["w"].view(torch.int16) != b["w"].view(torch.int16)
        return {"loss_max_abs": max(abs(x - y) for x, y in
                                    zip(a["losses"], b["losses"])),
                "w_elements_differ": int(bits.sum())}

    got = {"losses": nccl["train_losses"], "w": _bf16_w(nccl["log_dir"])}
    vs_ref = differ(got, reference())
    nccl_check = {"vs_non_distributed": vs_ref, "bitwise": not any(
        vs_ref.values())}
    if not nccl_check["bitwise"]:
        run_to_run = differ(refs[0], reference())
        nccl_check["non_distributed_run_to_run"] = run_to_run
        if any(vs_ref[k] > run_to_run[k] for k in vs_ref):
            raise AssertionError(f"NCCL world 1 vs non-distributed: {vs_ref}"
                                 f", beyond run to run: {run_to_run}")
    nccl_ms = statistics.median(nccl["ms_per_step_windows"])
    del refs, got

    # (c) the model-sharded session on 2 gloo ranks against one rank
    cfg = yaml.safe_load(_serve_yaml(work).read_text())
    ckpt = _ckpt_dir(work / "logs")
    rows = _fixture_trials(work / "data", "smokeeid0",
                           max(DP_SERVE_ROWS)).reshape(max(DP_SERVE_ROWS), -1)
    np.save(work / "dp_serve_rows.npy", rows)
    serve_s = _torchrun(DP_SERVE_CHILD, DP_WORLD, {
        "model_config": cfg, "ckpt_dir": str(ckpt),
        "buckets": list(DP_SERVE_BUCKETS), "rows": str(work /
                                                      "dp_serve_rows.npy"),
        "sizes": list(DP_SERVE_ROWS), "out": str(work / "dp_serve")},
        env={"VST_DIST_BACKEND": "gloo"})
    session = InferenceSession.from_checkpoint(
        cfg, str(ckpt), bucket_sizes=DP_SERVE_BUCKETS, device="cuda")
    refs = {str(n): session.predict(rows[:n]) for n in DP_SERVE_ROWS}
    del session
    served = [np.load(work / f"dp_serve{r}.npz") for r in range(DP_WORLD)]
    serve_errs = {n: _rel_err(served[0][n], ref) for n, ref in refs.items()}
    if any(int(s["kernel_rows"]) != KERNEL_M // DP_WORLD for s in served) \
            or any(int(s["launches"]) for s in served) \
            or max(serve_errs.values()) > SERVE_REL_BOUND \
            or any(not np.array_equal(s[n], served[0][n])
                   for s in served for n in refs):
        raise AssertionError(f"model-sharded session: rel errs {serve_errs}"
                             f", rows {[int(s['kernel_rows']) for s in served]}")
    _free_card()

    dp4 = _dp4_linear(work, train_yaml)
    _free_card()

    out = {"nvidia_smi": smi, "world": DP_WORLD, "backend": "gloo",
           "local_batch": local, "global_batch": BATCH,
           "train_losses": r0["train_losses"], "steps_per_rank": r0["steps"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "adamw_launches_per_rank": [r["adamw_launches"] for r in ranks],
           "launches": sum(r["launches"] for r in ranks),
           "resume_launches": sum(r["resume_launches"] for r in ranks),
           "replica_checksums": r0["replica_checksums"]
           + r0["resume_replica_checksums"],
           "test": r0["test"], "rank0_artifacts": written,
           "same_rows_step": s0, "factor_bytes_per_step": factor_bytes,
           "flat_gather_ms": statistics.median(
               ms for r in ranks for ms in r["gather_ms"]),
           "dp_ms_per_step": dp_ms,
           "dp_ms_per_step_windows": [r["ms_per_step_windows"]
                                      for r in ranks],
           "nccl1_ms_per_step": nccl_ms,
           "nccl1_ms_per_step_windows": nccl["ms_per_step_windows"],
           "non_distributed_ms_per_step": staged_ms,
           "nccl1": nccl_check, "nccl1_launches": nccl["launches"],
           "nccl1_losses": nccl["train_losses"],
           "serve_sharded_rel_err": serve_errs,
           "serve_kernel_rows_per_rank": KERNEL_M // DP_WORLD,
           "serve_bound": SERVE_REL_BOUND,
           "launch_seconds": {"dp": dp_s, "nccl1": nccl_s, "serve": serve_s},
           "dp4": dp4,
           "note": "ranks time-slice one card: not a scaling figure"}
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("dist_main_path", **out)
    return out


# ---------------------------------------------------------------------------
# phase 6b: the model axis (tensor parallelism over torch.distributed)
# ---------------------------------------------------------------------------

TP_MESH = {"data": 2, "model": 2}      # the tensor-sharded VTT's 4 ranks
TP_BATCH = 8                           # global: 4 rows a data block
TP_STEPS = 3                           # checked steps (as the JAX smoke)
TP_TIMED_STEPS = 3                     # then timed (host clock) steps
TP_LR_PEAK, TP_LR_STEPS = 5e-5, 100    # the JAX smoke's AdamW schedule
TP_F32_LOSS_RTOL = 1e-4
TP_BF16_LOSS_RTOL = 5e-3
# AdamW moves a parameter by at most ~lr a step (|m̂|/√v̂ <= 1.005 in the
# first 3 steps at b1 0.9, b2 0.999, plus weight decay): two runs whose
# gradients differ only in rounding differ by at most twice the summed
# step sizes, in any compute dtype. A block misplaced by the split (a wrong
# dim, a swapped rank) moves weights by their own scale, far beyond it.
TP_PARAM_ATOL_FACTOR = 2 * 1.01
TP_SERVE_BUCKETS = (4, 8)
TP_SERVE_ROWS = (3, 8)


def tp_param_atol() -> float:
    from video_spike_torch.ops.optim import cosine_onecycle_schedule

    lr = cosine_onecycle_schedule(TP_LR_STEPS, TP_LR_PEAK)
    return TP_PARAM_ATOL_FACTOR * sum(lr(i) for i in range(TP_STEPS))


def tensor_vtt_run(dtype_name: str, device: str = "cuda") -> tuple:
    """TP_STEPS tensor-sharded VTT steps at the recipe's shape
    (``configs/model/vtt_video.yaml``, five sessions of 668-300 neurons)
    from a seeded CPU init on a TP_BATCH-row batch from ``default_rng(7)``,
    then TP_TIMED_STEPS timed ones (host clock; ``loss.item()`` waits for
    the last); under a process group on the
    ``TP_MESH`` grid (each rank takes its data block), without one the
    unsplit step on every row. Returns (figures, the gathered params after
    the checked steps on the host)."""
    import numpy as np
    import torch

    from video_spike_torch.models.vtt import VideoTemporalTransformer
    from video_spike_torch.ops.optim import AdamW, cosine_onecycle_schedule
    from video_spike_torch.parallel import multihost as mh
    from video_spike_torch.parallel import tensor as tp
    from video_spike_torch.parallel.mesh import make_mesh
    from video_spike_torch.train.multisession import make_vtt_tensor_step

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    cfg = vtt_model_config()
    model = VideoTemporalTransformer.from_config(cfg, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    mesh = (make_mesh(**{f"n_{a}": n for a, n in TP_MESH.items()})
            if mh.is_multihost() else make_mesh())
    rng = np.random.default_rng(7)
    video = rng.integers(0, 255, (TP_BATCH, T_FRAMES, 1, HEIGHT, WIDTH),
                         dtype=np.uint8)
    sids = np.arange(TP_BATCH) % len(VTT_NEURONS)
    nmask = np.zeros((TP_BATCH, cfg["max_neurons"]), np.float32)
    for i, s in enumerate(sids):
        nmask[i, :VTT_NEURONS[s]] = 1.0
    ap = rng.poisson(0.5, (TP_BATCH, 100, cfg["max_neurons"])).astype(
        np.float32) * nmask[:, None, :]
    block = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
             mh.replicated_rows_to_global(mesh, video, ap, sids, nmask)]
    step, params, opt_state, rules = make_vtt_tensor_step(
        model, params, mesh, AdamW(cosine_onecycle_schedule(
            TP_LR_STEPS, TP_LR_PEAK), weight_decay=0.01))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(TP_STEPS):
        params, opt_state, loss = step(params, opt_state, *block)
        losses.append(float(loss))
    full = {k: v.cpu() for k, v in mh.gather_tree(params, rules).items()}
    tp.gather_last.bytes = tp.copy_to_model.bytes = 0
    mh.barrier()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_TIMED_STEPS):
        params, opt_state, loss = step(params, opt_state, *block)
    loss.item()
    ms = (time.perf_counter() - t0) / TP_TIMED_STEPS * 1e3
    split = sorted(k for k, r in rules.items() if r.axis is not None)
    data_reduced = (4 * (sum(v.numel() for v in params.values()) + 1)
                    if mesh.group("data") is not None else 0)
    return {"dtype": dtype_name, "mesh": dict(mesh.shape),
            "coords": dict(mesh.coords), "losses": losses,
            "ms_per_step": ms,
            "shard_shapes": {k: list(params[k].shape) for k in split},
            "bytes_per_step": {
                "model_gathered": tp.gather_last.bytes // TP_TIMED_STEPS,
                "model_all_reduced":
                    tp.copy_to_model.bytes // TP_TIMED_STEPS,
                "data_all_reduced": data_reduced},
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if on_card else None)}, full


# every rank: cli.train under training.mesh {data: 1, model: 2}, 2 epochs
# (the digest of model_last's W after them, rank 0), then --resume to 3
TP_LINEAR_CHILD = r"""
import hashlib, json, sys
import torch
import torch.distributed as dist
from video_spike_torch.cli import train as train_cli
from video_spike_torch.core.runtime import exit_rank
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.train.checkpoint import load_checkpoint
from chip_smoke import card_report

cfg = json.loads(sys.argv[1])
fr.apply_scaled_outer.launches = 0
res = train_cli.main(cfg["argv"] + ["--num_epochs", "2"])
launches = fr.apply_scaled_outer.launches
rank = mh.process_index()
digest = None
if rank == 0:
    w = load_checkpoint(res["log_dir"], "model_last")["params"][
        fr.FIRST_KERNEL]
    digest = hashlib.blake2b(w.contiguous().view(torch.uint8).numpy(),
                             digest_size=16).hexdigest()
    del w
mh.barrier()
fr.apply_scaled_outer.launches = 0
res2 = (train_cli.main(cfg["argv"] + ["--num_epochs", "3", "--resume"])
        if cfg.get("resume", True) else res)
out = {"rank": rank, "world": mh.process_count(),
       "backend": dist.get_backend(), "train_losses": res["train_losses"],
       "steps": res["global_step"], "launches": launches,
       "replica_checksums": res["replica_checksums"], "w_digest": digest,
       "resume_start_epoch": res2["start_epoch"],
       "resume_steps": res2["global_step"] - res["global_step"],
       "resume_launches": fr.apply_scaled_outer.launches,
       "resume_replica_checksums": res2["replica_checksums"],
       "test": res["test_res"], "log_dir": res["log_dir"],
       "card": card_report()}
with open(f"{cfg['out']}{rank}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: the tensor-sharded VTT step in f32, then in bf16 (rank 0
# saves the gathered params of each)
TP_VTT_CHILD = r"""
import json, sys
import torch
from chip_smoke import card_report, tensor_vtt_run
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.ops import fused_adamw
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops.attention import attention_bshd
from video_spike_torch.parallel import multihost as mh

cfg = json.loads(sys.argv[1])
assert setup_runtime("cuda")
fr.apply_scaled_outer.launches = 0
runs = []
for d in ("f32", "bf16"):
    attention_bshd.launches = attention_bshd.backward_launches = 0
    fused_adamw.step_.launches = 0
    run, full = tensor_vtt_run(d)
    run["attention_launches"] = [attention_bshd.launches,
                                 attention_bshd.backward_launches]
    run["adamw_launches"] = fused_adamw.step_.launches
    if mh.process_index() == 0:
        torch.save(full, f"{cfg['out']}_{d}.pt")
    runs.append(run)
    del full
out = {"runs": runs, "launches": fr.apply_scaled_outer.launches,
       "card": card_report()}
with open(f"{cfg['out']}{mh.process_index()}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: the VTT model_best served under the production rules on a
# {data: 1, model: 2} mesh
TP_SERVE_CHILD = r"""
import json, sys
import numpy as np
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.vtt import vtt_sharding_rules
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops.attention import attention_bshd
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.serve.session import InferenceSession

cfg = json.loads(sys.argv[1])
assert setup_runtime("cuda")
session = InferenceSession.from_checkpoint(
    cfg["model_config"], cfg["ckpt_dir"], bucket_sizes=cfg["buckets"],
    device="cuda", mesh=make_mesh(n_data=1, n_model=mh.process_count()),
    sharding_rules=vtt_sharding_rules)
rows = np.load(cfg["rows"])
sids = np.load(cfg["sids"])
attention_bshd.launches = attention_bshd.backward_launches = 0
outs = {str(n): session.predict(rows[:n], sids[:n]) for n in cfg["sizes"]}
attention = [attention_bshd.launches, attention_bshd.backward_launches]
shapes = {k: list(v.shape) for k, v in session.params.items()
          if k in ("session_heads", "frame_encoder.Block_0.Dense_0.kernel")}
np.savez(f"{cfg['out']}{mh.process_index()}.npz",
         shapes=json.dumps(shapes), launches=fr.apply_scaled_outer.launches,
         attention=np.asarray(attention), **outs)
exit_rank()
"""


def _tp_linear(work: Path) -> dict:
    """(a) the full-width Linear through ``cli.train`` on a {data: 1,
    model: 2} mesh over 2 gloo ranks: both ranks run the same 16 rows a
    step (the rank-local cache refused, streamed), launch the kernel once
    a step, agree bitwise every epoch, and end the 2 epochs with the W of
    a one-process streamed run on the same rows and seed."""
    import hashlib

    import torch

    from video_spike_torch.cli import train as train_cli

    tp_yaml = _variant_yaml(work, "model_axis", PRODUCTION_OPTIMIZER,
                            training={"mesh": {"data": 1, "model": 2}})
    ref_yaml = _variant_yaml(work, "model_axis_ref", PRODUCTION_OPTIMIZER,
                             training={"device_cache": False})
    seconds = _torchrun(TP_LINEAR_CHILD, 2, {
        "argv": _linear_args(work, tp_yaml, "tp_logs"),
        "out": str(work / "tp_linear")}, env={"VST_DIST_BACKEND": "gloo"})
    ranks = [json.loads((work / f"tp_linear{r}.json").read_text())
             for r in range(2)]
    r0 = ranks[0]
    for key in ("train_losses", "steps", "replica_checksums", "test",
                "resume_replica_checksums"):
        if any(r[key] != r0[key] for r in ranks):
            raise AssertionError(f"model-axis ranks differ in {key}: "
                                 f"{[r[key] for r in ranks]}")
    written = sorted(p.name for p in Path(r0["log_dir"]).iterdir())
    if written != ["metrics.jsonl", "model_best.pt", "model_last.pt",
                   "test_results.npy"]:
        raise AssertionError(f"rank-0 artifacts: {written}")
    ref = train_cli.main(_linear_args(work, ref_yaml, "tp_ref_logs")
                         + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    # a data row runs the global batch: the one-process step count
    for r in ranks:
        if r["backend"] != "gloo" or r["world"] != 2 \
                or r["steps"] != ref["global_step"] \
                or r["launches"] != r["steps"] \
                or r["resume_launches"] != r["resume_steps"] \
                or 2 * r["resume_steps"] != r["steps"] \
                or r["resume_start_epoch"] != 2:
            raise AssertionError(f"model-axis rank {r['rank']}: {r}")
    if len(r0["replica_checksums"]) != 2 \
            or len(r0["resume_replica_checksums"]) != 1 \
            or not all(math.isfinite(v) for v in r0["train_losses"]):
        raise AssertionError(f"model-axis run: {r0}")
    w = _bf16_w(ref["log_dir"])
    ref_digest = hashlib.blake2b(w.contiguous().view(torch.uint8).numpy(),
                                 digest_size=16).hexdigest()
    del w
    out = {"mesh": {"data": 1, "model": 2}, "world": 2, "backend": "gloo",
           "global_batch": BATCH, "train_losses": r0["train_losses"],
           "one_process_losses": ref["train_losses"],
           "steps_per_rank": r0["steps"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "launches": sum(r["launches"] for r in ranks),
           "resume_launches": sum(r["resume_launches"] for r in ranks),
           "replica_checksums": r0["replica_checksums"]
           + r0["resume_replica_checksums"],
           "w_bitwise_one_process": r0["w_digest"] == ref_digest,
           "w_digest": r0["w_digest"], "one_process_w_digest": ref_digest,
           "test": r0["test"], "launch_seconds": seconds}
    if not out["w_bitwise_one_process"] \
            or ref["train_losses"] != r0["train_losses"]:
        raise AssertionError(f"model-axis Linear vs one process: {out}")
    return out


def _param_diff(got: dict, want: dict) -> dict:
    """Max |got - want| over every leaf, and the share of elements equal
    bitwise."""
    worst, same, total = 0.0, 0, 0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            raise AssertionError(f"{k}: gathered {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        worst = max(worst, float((g.float() - w.float()).abs().max()))
        same += int((g == w).sum())
        total += w.numel()
    return {"max_abs": worst, "bitwise_share": same / total}


def _tp_vtt(work: Path, backend: str = "gloo") -> dict:
    """(b) the tensor-sharded VTT at full width on TP_MESH (4 gloo ranks
    sharing the card, or 4 NCCL ranks on 4 cards) against the unsplit step
    in this process on the same rows from the same init, in f32 and in
    bf16."""
    import torch

    world = TP_MESH["data"] * TP_MESH["model"]
    base = work / "tp_vtt"
    seconds = _torchrun(TP_VTT_CHILD, world, {"out": str(base)},
                        env=_backend_env(backend))
    ranks = [json.loads((work / f"tp_vtt{r}.json").read_text())
             for r in range(world)]
    if any(r["launches"] for r in ranks):
        raise AssertionError(f"the tensor-sharded VTT launched the fused "
                             f"readout: {[r['launches'] for r in ranks]}")
    if backend == "nccl":
        check_cards([r["card"] for r in ranks], world)
    atol = tp_param_atol()
    out = {"mesh": TP_MESH, "world": world, "backend": backend,
           "global_batch": TP_BATCH, "param_atol": atol,
           "launch_seconds": seconds, "launches": 0,
           "cards": [r["card"] for r in ranks]}
    for i, (name, rtol) in enumerate((("f32", TP_F32_LOSS_RTOL),
                                      ("bf16", TP_BF16_LOSS_RTOL))):
        runs = [r["runs"][i] for r in ranks]
        one, want = tensor_vtt_run(name)
        losses = runs[0]["losses"]
        if any(run["losses"] != losses for run in runs) \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: the ranks' losses "
                                 f"{[run['losses'] for run in runs]}")
        diff = _param_diff(torch.load(f"{base}_{name}.pt",
                                      weights_only=True), want)
        del want
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, one["losses"]))
        out[name] = {
            "losses": losses, "one_process_losses": one["losses"],
            "loss_max_rel_err": loss_err, "loss_rtol": rtol,
            "params_after_steps": diff,
            "shard_shapes_by_rank": [run["shard_shapes"] for run in runs],
            "coords_by_rank": [run["coords"] for run in runs],
            "ms_per_step_by_rank": [run["ms_per_step"] for run in runs],
            "one_process_ms_per_step": one["ms_per_step"],
            "bytes_per_step_by_rank": [run["bytes_per_step"]
                                       for run in runs],
            "peak_mem_gb_by_rank": [run["peak_mem_gb"] for run in runs],
            "one_process_peak_mem_gb": one["peak_mem_gb"],
            "attention_launches_by_rank": [run["attention_launches"]
                                           for run in runs],
            "adamw_launches_by_rank": [run["adamw_launches"]
                                       for run in runs]}
        # the bare AdamW steps each rank's shards in place: one launch a
        # step, after the data group's reduction
        if loss_err > rtol or diff["max_abs"] > atol \
                or losses[-1] == losses[0] or any(
                    run["adamw_launches"] != TP_STEPS + TP_TIMED_STEPS
                    for run in runs):
            raise AssertionError(f"tensor-sharded VTT ({name}) vs the "
                                 f"unsplit step: {out[name]}")
    _free_card()
    return out


def _tp_serve(work: Path) -> dict:
    """(c) the VTT phase's ``model_best`` served under the production rules
    on 2 gloo ranks against the one-rank session."""
    import numpy as np
    import yaml

    from video_spike_torch.serve import InferenceSession

    cfg = yaml.safe_load((ROOT / "configs/model/vtt_video.yaml").read_text())
    ckpt = _ckpt_dir(work / "vtt_logs")
    video, sids = _vtt_trials(work, max(TP_SERVE_ROWS))
    np.save(work / "tp_serve_rows.npy", video)
    np.save(work / "tp_serve_sids.npy", sids)
    seconds = _torchrun(TP_SERVE_CHILD, 2, {
        "model_config": cfg, "ckpt_dir": str(ckpt),
        "buckets": list(TP_SERVE_BUCKETS),
        "rows": str(work / "tp_serve_rows.npy"),
        "sids": str(work / "tp_serve_sids.npy"),
        "sizes": list(TP_SERVE_ROWS), "out": str(work / "tp_serve")},
        env={"VST_DIST_BACKEND": "gloo"})
    session = InferenceSession.from_checkpoint(
        cfg, str(ckpt), bucket_sizes=TP_SERVE_BUCKETS, device="cuda")
    refs = {str(n): session.predict(video[:n], sids[:n])
            for n in TP_SERVE_ROWS}
    del session
    served = [np.load(work / f"tp_serve{r}.npz") for r in range(2)]
    errs = {n: _rel_err(served[0][n], ref) for n, ref in refs.items()}
    shapes = [json.loads(str(s["shapes"])) for s in served]
    out = {"buckets": list(TP_SERVE_BUCKETS), "rows": list(TP_SERVE_ROWS),
           "max_rel_err": errs, "bound": SERVE_REL_BOUND,
           "shard_shapes": shapes[0],
           "launches": sum(int(s["launches"]) for s in served),
           "attention_launches_by_rank": [s["attention"].tolist()
                                          for s in served],
           "launch_seconds": seconds}
    want = {"session_heads": [len(VTT_NEURONS), 512, max(VTT_NEURONS) // 2],
            "frame_encoder.Block_0.Dense_0.kernel": [512, 512]}
    if max(errs.values()) > SERVE_REL_BOUND or out["launches"] \
            or any(s != want for s in shapes) \
            or any(not np.array_equal(s[n], served[0][n])
                   for s in served for n in refs):
        raise AssertionError(f"split VTT session: {out}")
    _free_card()
    return out


def phase_tensor_main_path(work: Path) -> dict:
    """The model axis: (a) the Linear through ``cli.train`` on {data: 1,
    model: 2}; (b) the tensor-sharded VTT step at full width on {data: 2,
    model: 2}; (c) the VTT ``model_best`` served split over 2 ranks. Ranks
    share the one card over gloo; their times are not scaling figures."""
    t_phase = time.perf_counter()
    _free_card()
    out = {"nvidia_smi": nvidia_smi_line(), "linear": _tp_linear(work)}
    out["vtt"] = _tp_vtt(work)
    out["serve"] = _tp_serve(work)
    out["note"] = ("ranks time-slice one card and move their collectives "
                   "through gloo (host memory): not a scaling figure")
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("tensor_main_path", **out)
    return out


# card vs CPU on the optimizer variants, 3 updates of each: f32 values
# (states, f32 updates) within rtol 1e-5 of the CPU's (reductions over
# 43,600-element rows in another order, CUDA's rsqrt within 2 ulp), with an
# atol of 1e-6 of the leaf's largest value where a weight-decay add cancels;
# bf16 values (the bf16 store, bf16 states and updates) within 1 bf16 ulp
# of themselves (an f32 difference in the last bits rounds, or an SR
# decision flips, to the neighbouring bf16) plus 1 bf16 ulp of the leaf's
# largest value where such an add cancels
OPT_F32_RTOL = 1e-5
OPT_F32_ATOL_REL = 1e-6
OPT_UPDATES = 3
OPT_TIMED_UPDATES = 20


def linear_rest_tree(seed: int) -> dict:
    """The full-width Linear model's leaves besides the first kernel, by
    the port's names: the (256, 43,600) decoder head (11,161,600 elements,
    bf16 as the SR store keeps it), the smaller kernels and the biases
    (f32), from a numpy seed."""
    import numpy as np
    import torch

    shapes = {"encoder.Dense_0.bias": (256,),
              "encoder.Dense_1.kernel": (256, 128),
              "encoder.Dense_1.bias": (128,),
              "encoder.Dense_2.kernel": (128, 64),
              "encoder.Dense_2.bias": (64,),
              "decoder.Dense_0.kernel": (64, 128),
              "decoder.Dense_0.bias": (128,),
              "decoder.Dense_1.kernel": (128, 256),
              "decoder.Dense_1.bias": (256,),
              "decoder.Dense_2.kernel": (256, 100 * N_NEURONS),
              "decoder.Dense_2.bias": (100 * N_NEURONS,)}
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        t = torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))
        out[k] = t.to(torch.bfloat16) if t.numel() >= 1 << 16 else t
    return out


def _optim_cases():
    import torch

    from video_spike_torch.ops import optim as op

    sched = op.cosine_onecycle_schedule(1000, 5e-5, 0.15, 10, 1e4)
    return {
        "adafactor_lean": (lambda: op.AdafactorLean(sched), "bf16", False),
        "adamw_lowmem": (lambda: op.AdamWLowmem(sched, weight_decay=0.01),
                         "f32", True),
        "adamw_sr_bf16+apply_updates_sr": (
            lambda: op.AdamWLowmem(sched, weight_decay=0.01), "bf16", True),
        "adamw_mu_bf16": (lambda: op.AdamW(sched, weight_decay=0.01,
                                           mu_dtype=torch.bfloat16),
                          "f32", True),
        "adafactor_all_options": (lambda: op.Adafactor(
            sched, multiply_by_parameter_scale=True, clipping_threshold=1.0,
            momentum=0.9, weight_decay_rate=1e-3), "bf16", True),
        "multisteps_k2_adafactor_lean": (
            lambda: op.MultiSteps(op.AdafactorLean(sched), 2), "bf16",
            False),
    }


def _tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _bf16_ulp(x):
    import torch

    return torch.exp2(torch.floor(torch.log2(
        x.abs().float().clamp_min(1e-38))) - 7)


def _compare_tree(got, ref, what: str, worst: dict) -> None:
    """Card values against the CPU's by the bounds above."""
    import torch

    if isinstance(ref, dict):
        for k in ref:
            _compare_tree(got[k], ref[k], f"{what}.{k}", worst)
        return
    if not isinstance(ref, torch.Tensor):
        if got != ref:
            raise AssertionError(f"{what}: {got} != {ref}")
        return
    g = got.cpu()
    if g.dtype != ref.dtype or g.shape != ref.shape:
        raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} vs "
                             f"{ref.dtype}{tuple(ref.shape)}")
    if ref.numel() == 0:
        return
    gf, rf = g.float(), ref.float()
    scale = float(rf.abs().max())
    diff = (gf - rf).abs()
    if ref.dtype == torch.bfloat16:
        bound = (_bf16_ulp(torch.maximum(gf.abs(), rf.abs()))
                 + _bf16_ulp(torch.tensor(scale)))
        key = "bf16_max_of_bound"
    else:
        bound = OPT_F32_RTOL * rf.abs() + OPT_F32_ATOL_REL * scale
        key = "f32_max_of_bound"
    worst[key] = max(worst.get(key, 0.0),
                     float((diff / bound.clamp_min(1e-38)).max()))
    worst["frac_bitwise"] = min(worst.get("frac_bitwise", 1.0),
                                float((gf == rf).float().mean()))
    worst["max_abs_err"] = max(worst.get("max_abs_err", 0.0),
                               float(diff.max()))
    if bool((diff > bound).any()):
        raise AssertionError(f"{what}: card vs CPU beyond its bound "
                             f"(max |d| {float(diff.max())}, scale {scale})")


def phase_optim_card_vs_cpu() -> dict:
    """Each new optimizer transform on the Linear model's real non-kernel
    leaves, 3 updates on the card and on the CPU from the same numpy
    parameters and gradients, compared by the bounds above; then one
    update timed on the card (CUDA events, median of REPS windows of 20)
    beside its HBM bound: the bytes it must read (gradients, state, the
    parameters where it reads them) and write (state, updates) over
    3.35 TB/s."""
    import numpy as np
    import torch

    from video_spike_torch.ops import optim as op

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    base = linear_rest_tree(11)
    rng = np.random.default_rng(12)
    grads = [{k: torch.from_numpy(rng.normal(0, 1e-3, tuple(v.shape)).astype(
        np.float32)).to(v.dtype) for k, v in base.items()}
        for _ in range(OPT_UPDATES)]
    out = {}
    for name, (make, store, reads_params) in _optim_cases().items():
        params0 = (base if store == "bf16"
                   else {k: v.float() for k, v in base.items()})
        gs = [{k: g.to(params0[k].dtype) for k, g in grad.items()}
              for grad in grads]
        sr = name.endswith("apply_updates_sr")
        apply = op.apply_updates_sr if sr else op.apply_updates
        results = {}
        for where in ("cpu", "cuda"):
            tx = make()
            params = {k: v.to(where) for k, v in params0.items()}
            state = tx.init(params)
            for i in range(OPT_UPDATES):
                upd, state = tx.update(
                    {k: g.to(where) for k, g in gs[i].items()}, state,
                    params)
                params = apply(params, upd, i)
            results[where] = (params, state, upd)
        worst = {}
        for part, idx in (("params", 0), ("state", 1), ("updates", 2)):
            _compare_tree(results["cuda"][idx], results["cpu"][idx],
                          f"{name}.{part}", worst)

        # one update timed on the card (the SR case with its apply)
        tx = make()
        params = {k: v.to(dev) for k, v in params0.items()}
        state = tx.init(params)
        g_dev = {k: g.to(dev) for k, g in gs[0].items()}
        holder = {"state": state}

        def one():
            upd, holder["state"] = tx.update(g_dev, holder["state"], params)
            if sr:
                op.apply_updates_sr(params, upd, 1)

        windows = [cuda_ms(one, OPT_TIMED_UPDATES, 2) for _ in range(REPS)]
        upd, new_state = tx.update(g_dev, state, params)
        state_bytes = sum(t.nbytes for t in _tensors(state))
        new_state_bytes = sum(t.nbytes for t in _tensors(new_state))
        g_bytes = sum(t.nbytes for t in g_dev.values())
        p_bytes = sum(t.nbytes for t in params.values())
        u_bytes = sum(t.nbytes for t in upd.values())
        if isinstance(tx, op.MultiSteps):
            inner = sum(t.nbytes for t in _tensors(state["inner"]))
            acc = sum(t.nbytes for t in _tensors(state["acc_grads"]))
            # a micro-step reads g and acc, writes acc and (zero) updates;
            # the inner update runs on every k-th: its state in and out
            nbytes = g_bytes + 2 * acc + u_bytes + 2 * inner / tx.every_k
        elif sr:
            # the SR apply writes the params in place of the updates
            nbytes = g_bytes + state_bytes + new_state_bytes + 2 * p_bytes
        else:
            nbytes = (g_bytes + state_bytes + new_state_bytes + u_bytes
                      + (p_bytes if reads_params else 0))
        out[name] = {"store": store, "ms": statistics.median(windows),
                     "ms_windows": windows, "bound_bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "card_vs_cpu": worst}
        del results, params, state, holder
        torch.cuda.empty_cache()
    emit("optim_card_vs_cpu", phase_seconds=time.perf_counter() - t0,
         transforms=out,
         leaves={k: list(v.shape) for k, v in base.items()},
         bounds={"f32_rtol": OPT_F32_RTOL, "f32_atol_rel": OPT_F32_ATOL_REL,
                 "bf16": "1 ulp of itself + 1 ulp of the leaf's max"})
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
    _attention_reset()
    t0 = time.perf_counter()
    res = train_cli.main(base + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fused_launches = fr.apply_scaled_outer.launches
    attention = _attention_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if res["n_params"] != VTT_PARAMS:
        raise AssertionError(f"VTT has {res['n_params']} params, "
                             f"want {VTT_PARAMS}")
    if fused_launches:
        raise AssertionError(f"the VTT path launched the fused readout "
                             f"{fused_launches} times")
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
           "attention_launches": attention,
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
    from video_spike_torch.ops import fused_adamw
    from video_spike_torch.ops import fused_readout as fr

    run = work / "ssl"
    data = ssl_data(run)
    n_frames = sum(data[SSL_EID][f"{s}_X"].shape[0]
                   * data[SSL_EID][f"{s}_X"].shape[1]
                   for s in ("train", "val", "test"))
    args = ssl_args(run, "logs", SSL_MAX_STEPS)
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    fused_adamw.step_.launches = 0
    _attention_reset()
    with contextlib.chdir(run):
        _, trainer, _, _ = pretrain.build_trainer(args, data)
        trainer.max_steps = SSL_FIRST_STEPS
        trainer._save_every_steps = SSL_FLUSH_EVERY
        t0 = time.perf_counter()
        with _LogLines() as first_log:
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
        flushes = [l for l in first_log.lines if "periodic last_model" in l]
        sidecar = json.loads((log_dir / "last_model.sampler.json")
                             .read_text())
        ckpt_step = torch.load(log_dir / "last_model.pt",
                               weights_only=True)["step"]
        t0 = time.perf_counter()
        with _LogLines() as resume_log:
            res = pretrain.main(args + ["--resume"], data=data)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        (log_dir.parent / "40000").symlink_to(log_dir)
        test_bps = test.main(args, data=data)
        embeddings = np.load(res["path"], allow_pickle=True).item()[SSL_EID]
    launches = fr.apply_scaled_outer.launches
    adamw_launches = fused_adamw.step_.launches
    attention = _attention_counts()
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
           "fused_readout_launches": launches,
           "fused_adamw_launches": adamw_launches,
           "attention_launches": attention,
           "background_flushes": flushes, "sidecar_step": sidecar["step"],
           "checkpoint_step": ckpt_step,
           "resume_mid_epoch": [l for l in resume_log.lines
                                if "sampler resumed mid-epoch" in l]}
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
    if adamw_launches != len(losses):
        raise AssertionError(f"fused AdamW: {adamw_launches} launches in "
                             f"{len(losses)} steps trained")
    if len(flushes) != SSL_FIRST_STEPS // SSL_FLUSH_EVERY - 1 \
            or sidecar["step"] != ckpt_step or ckpt_step != SSL_FIRST_STEPS \
            or not out["resume_mid_epoch"]:
        raise AssertionError(
            f"SSL flushes {flushes}; the resume read last_model step "
            f"{ckpt_step} with a sidecar of step {sidecar['step']}; "
            f"mid-epoch resume: {out['resume_mid_epoch']}")
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
    out = ssl_step_ms(work, data)
    emit("ssl_step_time", **out)
    return out


def ssl_step_ms(work: Path, data: dict) -> dict:
    """The figures of :func:`phase_ssl_step_time`, on this process's
    card."""
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
    return out


# ---------------------------------------------------------------------------
# phases 11-14: the VideoMAE probe and its pretrained backbone
# ---------------------------------------------------------------------------

def probe_yamls(work: Path, backbone=None) -> tuple:
    """(model yaml, train yaml) of the probe: videomae.yaml with
    ``hf_compat: false`` and ``pretrained_backbone`` (None: random init),
    vmae_video.yaml with the production optimizer at PROBE_LR."""
    import yaml

    model = yaml.safe_load((ROOT / PROBE_YAML).read_text())
    model.update(hf_compat=False, pretrained_backbone=backbone)
    train = yaml.safe_load((ROOT / PROBE_TRAIN_YAML).read_text())
    train["optimizer"].update(PRODUCTION_OPTIMIZER, lr=PROBE_LR)
    paths = work / "probe_model.yaml", work / "probe_train.yaml"
    paths[0].write_text(yaml.safe_dump(model))
    paths[1].write_text(yaml.safe_dump(train))
    return paths


def probe_args(work: Path, log_dir: str, backbone=None) -> list:
    model_yaml, train_yaml = probe_yamls(work, backbone)
    return ["--model_config", str(model_yaml),
            "--train_config", str(train_yaml), "--eid", "smokeeid0",
            "--data_dir", str(work / "data"), "--log_dir", str(work / log_dir),
            "--batch_size", str(PROBE_BATCH), "--device", "cuda"]


def phase_probe_pretrain(work: Path) -> tuple:
    """``cli.pretrain_videomae`` at full width (VideoMAEForPreTraining,
    94,222,080 parameters, mask ratio 0.9) for PRETRAIN_STEPS steps at batch
    8 on the Linear phase's fixture; returns (the backbone.pt path, the
    phase's numbers)."""
    import torch

    from video_spike_torch.cli import pretrain_videomae
    from video_spike_torch.ops import fused_readout as fr

    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    _attention_reset()
    t0 = time.perf_counter()
    res = pretrain_videomae.main(
        ["--model_config", str(ROOT / PROBE_YAML),
         "--train_config", str(ROOT / PROBE_TRAIN_YAML),
         "--eid", "smokeeid0", "--data_dir", str(work / "data"),
         "--log_dir", str(work / "probe_pretrain"),
         "--max_steps", str(PRETRAIN_STEPS),
         "--batch_size", str(PROBE_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    attention = _attention_counts()
    out = {"n_params": res["n_params"], "steps": len(res["losses"]),
           "losses_first_last": [res["losses"][0], res["losses"][-1]],
           "path_exists": Path(res["path"]).is_file(), "seconds": seconds,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "fused_readout_launches": launches,
           "attention_launches": attention}
    emit("probe_pretrain", **out)
    if res["n_params"] != PRETRAIN_PARAMS:
        raise AssertionError(f"VideoMAEForPreTraining has {res['n_params']} "
                             f"params, want {PRETRAIN_PARAMS}")
    if len(res["losses"]) != PRETRAIN_STEPS \
            or not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"pretraining losses: {res['losses']}")
    if not out["path_exists"] or launches:
        raise AssertionError(f"backbone.pt missing or launches: {out}")
    _free_card()
    return res["path"], out


def _assert_backbone_is(params: dict, ckpt: dict, what: str) -> None:
    """Every ``video_mae.*`` leaf equals the pretraining checkpoint's, cast
    to the leaf's dtype (the bf16 SR store rounds leaves >= 65,536
    elements to nearest), bit for bit."""
    import torch

    names = [k for k in params if k.startswith("video_mae.")]
    bad = [k for k in names if not torch.equal(
        params[k], ckpt[k[len("video_mae."):]].to(params[k].dtype))]
    if not names or bad:
        raise AssertionError(f"{what}: backbone differs from the checkpoint "
                             f"at {bad[:4]} ({len(names)} leaves)")


def phase_probe_main_path(work: Path, backbone: str) -> dict:
    """``cli.train`` on the probe (production optimizer, fused head update)
    from the pretrained backbone for 2 epochs, then ``--resume`` for a
    third; the kernel's launches must equal the train steps in both."""
    import numpy as np
    import torch

    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.ops import fused_readout as fr

    base = probe_args(work, "probe_logs", backbone)
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    _attention_reset()
    t0 = time.perf_counter()
    res = train_cli.main(base + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    attention = _attention_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["global_step"]
    log_dir = Path(res["log_dir"])
    artifacts = {name: (log_dir / name).exists()
                 for name in ("model_best.pt", "model_last.pt",
                              "test_results.npy")}
    fr.apply_scaled_outer.launches = 0
    res2 = train_cli.main(base + ["--num_epochs", "3", "--resume"])
    torch.cuda.synchronize()
    resumed_steps = res2["global_step"] - steps
    resume_launches = fr.apply_scaled_outer.launches
    test = res["test_res"]
    out = {"n_params": res["n_params"], "train_steps": steps,
           "launches": launches, "fused_readout": res["fused_readout"],
           "attention_launches": attention,
           "features_staged": res["features_staged"],
           "train_losses": res["train_losses"], "eval": res["eval_history"],
           "test": test, "artifacts": artifacts, "train_seconds": train_s,
           "encode_seconds": res["encode_seconds"], "peak_mem_gb": peak_gb,
           "resume_start_epoch": res2["start_epoch"],
           "resume_steps": resumed_steps, "resume_launches": resume_launches,
           "resume_train_loss": res2["train_losses"]}
    emit("probe_main_path", **out)
    if res["n_params"] != PROBE_PARAMS:
        raise AssertionError(f"the probe has {res['n_params']} params, want "
                             f"{PROBE_PARAMS}")
    if not (res["fused_readout"] and res["features_staged"]):
        raise AssertionError("the fused head step or the feature cache was "
                             "not engaged")
    if steps == 0 or launches != steps:
        raise AssertionError(f"kernel launches {launches} != train steps "
                             f"{steps}")
    if res2["start_epoch"] != 2 or resumed_steps <= 0 \
            or resume_launches != resumed_steps:
        raise AssertionError(f"resume: start_epoch {res2['start_epoch']}, "
                             f"steps {resumed_steps}, launches "
                             f"{resume_launches}")
    losses = res["train_losses"] + res2["train_losses"]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses: {losses}")
    if not res["eval_history"] or not all(
            math.isfinite(e[k]) for e in res["eval_history"]
            for k in ("eval_bps", "eval_rsquared")):
        raise AssertionError(f"eval metrics: {res['eval_history']}")
    if not all(math.isfinite(test[k]) for k in ("test_bps", "test_rsquared",
                                                "test_loss")):
        raise AssertionError(f"test metrics: {test}")
    if not all(artifacts.values()):
        raise AssertionError(f"missing artifacts: {artifacts}")
    preds = np.load(log_dir / "test_results.npy",
                    allow_pickle=True).item()["test_preds"][0]
    if preds.shape[1:] != (100, N_NEURONS) or not np.isfinite(preds).all():
        raise AssertionError(f"test preds {preds.shape}")
    # loaded exactly, and still exactly the checkpoint after 3 epochs
    ckpt = torch.load(backbone, map_location="cpu",
                      weights_only=True)["params"]
    for name in ("model_best", "model_last"):
        _assert_backbone_is(torch.load(log_dir / f"{name}.pt",
                                       weights_only=True)["params"], ckpt,
                            name)
    _free_card()
    return out


def phase_probe_card_vs_cpu() -> dict:
    """The ``hf_compat: true`` probe's ``encode`` (preprocess + ViT-Base) on
    one trial on the card, in bf16 and f32, against f32 on the CPU with the
    same weights. ``num_frames`` is cut to PROBE_CARD_FRAMES (392 tokens) to
    keep the CPU side short, and ``encoder_head`` to 8 outputs (the head is
    not compared)."""
    import numpy as np
    import torch
    import yaml

    from video_spike_torch.convert import load_into_model
    from video_spike_torch.models.videomae import VideoMAEProbe

    cfg = yaml.safe_load((ROOT / PROBE_YAML).read_text())
    cfg.update(num_frames=PROBE_CARD_FRAMES, hf_compat=True,
               encoder={"output_dim": 8},
               decoder={"output_dim": 100 * N_NEURONS})
    cpu = VideoMAEProbe.from_config(cfg, dtype=torch.float32)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    weights = dict(cpu.named_parameters())
    video = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1, T_FRAMES, 1, HEIGHT, WIDTH), dtype=np.uint8))
    errs = {}
    with torch.no_grad():
        ref = cpu.encode(video)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            card = VideoMAEProbe.from_config(cfg, device="cuda", dtype=dtype)
            load_into_model(card, weights)
            got = card.encode(video.cuda()).float().cpu()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: {tuple(got.shape)} or not "
                                     f"finite")
            errs[name] = float((got - ref).abs().max() / ref.abs().max())
            del card
    _free_card()
    out = {"frames": PROBE_CARD_FRAMES, "shape": list(ref.shape),
           "max_rel_err_bf16": errs["bf16"], "bound_bf16": PROBE_BF16_REL_BOUND,
           "max_rel_err_f32": errs["f32"], "bound_f32": PROBE_F32_REL_BOUND}
    emit("probe_card_vs_cpu", **out)
    if errs["bf16"] > PROBE_BF16_REL_BOUND or errs["f32"] > PROBE_F32_REL_BOUND:
        raise AssertionError(f"probe card vs CPU beyond its bound: {out}")
    return out


def probe_staged_trainer(work: Path, log_dir: str):
    """The probe trainer ``cli.train`` builds (random backbone), with its
    features staged and one epoch of fused head steps run."""
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    trainer = train_cli.build_trainer(get_args(probe_args(work, log_dir)))
    trainer.train_epoch()                   # stages, encodes, warms up
    if not (trainer._features_staged and trainer._fused_inner is not None):
        raise AssertionError("probe features not staged or step not fused")
    return trainer


def phase_probe_step_time(work: Path) -> dict:
    """ms/step of the staged fused head step (CUDA events over REPS
    windows of PROBE_EPOCHS_PER_WINDOW epochs, the median and every
    window), frames/s, the per-trial encode and peak memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    trainer = probe_staged_trainer(work, "probe_timing")
    windows = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        step0 = trainer.global_step
        torch.cuda.synchronize()
        start.record()
        for _ in range(PROBE_EPOCHS_PER_WINDOW):
            trainer.train_epoch()
        end.record()
        torch.cuda.synchronize()
        steps = trainer.global_step - step0
        windows.append(start.elapsed_time(end) / steps)
    batch = next(iter(trainer.train_loader))
    video = trainer._to_device(trainer._assemble_inputs(batch))
    with torch.no_grad():
        encode_ms = cuda_ms(lambda: trainer.model.encode(video), 3, 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = video.shape[0]
    del trainer, video
    _free_card()
    ms = statistics.median(windows)
    out = {"ms_per_step": ms, "ms_per_step_windows": windows,
           "steps_per_window": steps, "batch": PROBE_BATCH,
           "frames_per_s": PROBE_BATCH * T_FRAMES / (ms / 1e3),
           "encode_ms_per_trial": encode_ms / n, "encode_batch": n,
           "peak_mem_gb": peak}
    emit("probe_step_time", **out)
    return out


# ---------------------------------------------------------------------------
# phases 15-17: serving and export
# ---------------------------------------------------------------------------

def _ckpt_dir(root: Path) -> Path:
    """The directory of the one ``model_best.pt`` under `root`."""
    found = sorted(root.rglob("model_best.pt"))
    if len(found) != 1:
        raise AssertionError(f"want one model_best.pt under {root}: {found}")
    return found[0].parent


def _serve_yaml(work: Path) -> Path:
    """configs/model/linear_video.yaml with the widths ``cli/train.py``
    fills in from the data (1,966,080 in, 100 x 436 out)."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs/model/linear_video.yaml")
                         .read_text())
    cfg["encoder"]["input_dim"] = KERNEL_M
    cfg["decoder"]["output_dim"] = 100 * N_NEURONS
    path = work / "serve_linear_video.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _fixture_trials(data: Path, eid: str, n: int):
    """The uint8 video of n of a fixture session's trials."""
    import numpy as np

    from video_spike_torch.data.tar_io import read_trial_tar

    files = sorted(data.glob(f"{eid}_*.tar"))[:n]
    return np.stack([read_trial_tar(str(f))["video"] for f in files])


def _rel_err(got, ref) -> float:
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{got.shape} vs {ref.shape}, or not finite")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _post(url: str, arr, batched: bool):
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(
        f"{url}/predict", data=buf.getvalue(), method="POST",
        headers={"X-Batched": "1"} if batched else {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def phase_serve_main_path(work: Path) -> dict:
    """``cli.serve.make_app`` over the Linear phase's ``model_best.pt`` (full
    width, the bf16 kernel as stored) with every bucket warmed; ``predict``
    timed at each bucket; then ``serve_http`` takes SERVE_REQUESTS requests
    of one raw uint8 trial each from SERVE_CLIENTS threads (every
    SERVE_BATCHED_EVERY-th an X-Batched batch of SERVE_BATCHED_ROWS), and
    each response is held against the model's direct forward on its row."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from video_spike_torch.cli import serve as serve_cli
    from video_spike_torch.ops import fused_readout as fr
    from video_spike_torch.serve import serve_http

    t_phase = time.perf_counter()
    trials = _fixture_trials(work / "data", "smokeeid0", SERVE_TRIALS)
    rows = trials.reshape(SERVE_TRIALS, -1)           # uint8 (16, 1966080)
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    t0 = time.perf_counter()
    _, session, batcher = serve_cli.make_app([
        "--model_config", str(_serve_yaml(work)),
        "--ckpt_dir", str(_ckpt_dir(work / "logs")),
        "--max_batch", str(SERVE_MAX_BATCH), "--input_dim", str(KERNEL_M),
        "--host", "127.0.0.1", "--port", "0", "--device", "cuda"])
    load_s = time.perf_counter() - t0
    kernel = session.params["encoder.Dense_0.kernel"]
    if (tuple(kernel.shape) != (KERNEL_M, KERNEL_N)
            or kernel.dtype != torch.bfloat16
            or session.stats["compiles"] != len(SERVE_BUCKETS)
            or session.buckets != list(SERVE_BUCKETS)):
        raise AssertionError(f"session: {tuple(kernel.shape)} "
                             f"{kernel.dtype}, {session.stats}, "
                             f"{session.buckets}")
    predict_ms = {}
    for b in SERVE_BUCKETS:
        x = rows[np.arange(b) % SERVE_TRIALS]
        times = []
        for _ in range(SERVE_PREDICT_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            session.predict(x)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        predict_ms[str(b)] = statistics.median(times)

    server = serve_http(batcher, port=0, host="127.0.0.1", block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    plan = [(i, [(i + j) % SERVE_TRIALS for j in range(SERVE_BATCHED_ROWS)]
             if i % SERVE_BATCHED_EVERY == SERVE_BATCHED_EVERY // 2
             else [i % SERVE_TRIALS]) for i in range(SERVE_REQUESTS)]
    answers, errors = {}, []

    def client(k: int) -> None:
        try:
            for i, idx in plan[k::SERVE_CLIENTS]:
                batched = len(idx) > 1
                answers[i] = _post(url, rows[idx] if batched
                                   else rows[idx[0]], batched)
        except Exception as e:        # re-raised below, after shutdown
            errors.append(e)

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            if r.read() != b"ok":
                raise AssertionError("healthz")
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        serve_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    if errors:
        raise errors[0]
    launches = fr.apply_scaled_outer.launches
    # the references: the model's forward on each row alone, after shutdown
    with torch.inference_mode():
        ref = np.stack([session.model(torch.from_numpy(r[None]).cuda())
                        .float().cpu().numpy()[0] for r in rows])
    errs = [_rel_err(answers[i], ref[idx] if len(idx) > 1 else ref[idx[0]])
            for i, idx in plan]
    n_rows = sum(len(idx) for _, idx in plan)
    out = {"requests": SERVE_REQUESTS, "rows": n_rows,
           "clients": SERVE_CLIENTS,
           "batched_requests": sum(len(idx) > 1 for _, idx in plan),
           "stats": stats, "serve_seconds": serve_s,
           "requests_per_s": SERVE_REQUESTS / serve_s,
           "rows_per_s": n_rows / serve_s,
           "predict_ms_by_bucket": predict_ms, "load_seconds": load_s,
           "session_stats": session.stats,
           "max_rel_err": max(errs), "bound": SERVE_REL_BOUND,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "fused_readout_launches": launches,
           "phase_seconds": time.perf_counter() - t_phase}
    emit("serve_main_path", **out)
    del session, batcher
    _free_card()
    if stats["served"] != n_rows or max(errs) > SERVE_REL_BOUND or launches:
        raise AssertionError(f"serving: {out}")
    return out


def _vtt_trials(work: Path, n: int):
    """n trials of the VTT fixture (sessions in turn) and their ids."""
    import numpy as np

    videos, sids = [], []
    for s, eid in enumerate(VTT_EIDS):
        videos.append(_fixture_trials(work / "vtt_data", eid, n))
        sids.append(np.full(n, s, np.int32))
    order = np.arange(n * len(VTT_EIDS)).reshape(len(VTT_EIDS), n).T.ravel()
    return (np.concatenate(videos)[order][:n],
            np.concatenate(sids)[order][:n])


def _vtt_session(work: Path):
    import yaml

    from video_spike_torch.serve import InferenceSession

    return InferenceSession.from_checkpoint(
        yaml.safe_load((ROOT / "configs/model/vtt_video.yaml").read_text()),
        _ckpt_dir(work / "vtt_logs"), device="cuda")


def phase_vtt_serve(work: Path) -> dict:
    """An InferenceSession over the VTT phase's ``model_best.pt`` (the
    session and neuron counts read off the checkpoint): 3 rows of mixed
    session ids in the 4-bucket, and the same rows with the ids left out
    (session 0), each against the direct forward."""
    import numpy as np
    import torch

    from video_spike_torch.ops import fused_readout as fr

    t_phase = time.perf_counter()
    fr.apply_scaled_outer.launches = 0
    session = _vtt_session(work)
    video, _ = _vtt_trials(work, 3)
    sids = np.asarray([4, 0, 2], np.int32)
    _attention_reset()
    got = session.predict(video, session_ids=sids)
    got0 = session.predict(video)
    attention = _attention_counts()
    with torch.inference_mode():
        v = torch.from_numpy(video).cuda()
        ref = session.model(v, torch.from_numpy(sids).long().cuda())
        ref0 = session.model(v, torch.zeros(3, dtype=torch.long,
                                            device="cuda"))
    errs = {"ids": _rel_err(got, ref.float().cpu()),
            "ids_left_out": _rel_err(got0, ref0.float().cpu())}
    launches = fr.apply_scaled_outer.launches
    out = {"n_sessions": session.model.n_sessions,
           "max_neurons": session.model.max_neurons,
           "shape": list(got.shape), "session_ids": sids.tolist(),
           "stats": session.stats, "max_rel_err": errs,
           "bound": SERVE_REL_BOUND, "fused_readout_launches": launches,
           "attention_launches": attention,
           "phase_seconds": time.perf_counter() - t_phase}
    emit("vtt_serve", **out)
    del session
    _free_card()
    if (max(errs.values()) > SERVE_REL_BOUND or launches
            or out["stats"]["padded_rows"] != 2
            or (out["n_sessions"], out["max_neurons"])
            != (len(VTT_NEURONS), max(VTT_NEURONS))):
        raise AssertionError(f"VTT serving: {out}")
    return out


# split serving under any rules: the Linear model_best under the first-layer
# rules and the production VTT rules, the VTT model_best under the
# first-layer rules, each on 2 gloo ranks sharing the card
SPLIT_BUCKETS = (1, 4, 16)
SPLIT_SIZES = (1, 3, 16)                # rows a request (3 pads to 4)
SPLIT_VTT_ROWS = 4
SPLIT_REPS = 3                          # timed predict calls a size
SPLIT_CASES = (("linear", "first256"), ("linear", "vtt"),
               ("vtt", "first512"))

# every rank: each case's session, its requests timed (host clock; predict
# returns host arrays), the bytes its collectives moved a request, the
# split leaves' shard shapes and the gathered leaves
SPLIT_SERVE_CHILD = r"""
import functools, json, sys, time
import numpy as np
from chip_smoke import card_report
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import first_layer_sharding_rules
from video_spike_torch.models.vtt import vtt_sharding_rules
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops.attention import attention_bshd
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel import tensor
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.serve.session import InferenceSession

cfg = json.loads(sys.argv[1])
assert setup_runtime("cuda")
mesh = make_mesh(n_data=1, n_model=mh.process_count())
fr.apply_scaled_outer.launches = 0
report, outs = {}, {}
for model, rules in cfg["cases"]:
    c = cfg[model]
    rule = (vtt_sharding_rules if rules == "vtt" else functools.partial(
        first_layer_sharding_rules, min_dim=int(rules[5:])))
    session = InferenceSession.from_checkpoint(
        c["model_config"], c["ckpt_dir"], bucket_sizes=c["buckets"],
        device="cuda", mesh=mesh, sharding_rules=rule)
    rows = np.load(c["rows"])
    sids = np.load(c["sids"]) if "sids" in c else None
    r = {"gathered_leaves": session.stats["gathered_leaves"],
         "shard_shapes": {}, "predict_ms": {}, "bytes_per_request": {}}
    attention_bshd.launches = attention_bshd.backward_launches = 0
    for n in c["sizes"]:
        args = (rows[:n],) + (() if sids is None else (sids[:n],))
        b0 = (tensor.sum_over_model.bytes, tensor.gather_last.bytes)
        outs[f"{model}_{rules}_{n}"] = session.predict(*args)
        r["bytes_per_request"][str(n)] = {
            "all_reduced": tensor.sum_over_model.bytes - b0[0],
            "all_gathered": tensor.gather_last.bytes - b0[1]}
        ms = []
        for _ in range(cfg["reps"]):
            mh.barrier()
            t0 = time.perf_counter()
            session.predict(*args)
            ms.append((time.perf_counter() - t0) * 1e3)
        r["predict_ms"][str(n)] = sorted(ms)[len(ms) // 2]
    r["attention_launches"] = [attention_bshd.launches,
                               attention_bshd.backward_launches]
    r["shard_shapes"] = {k: list(v.shape) for k, v in session.params.items()}
    report[f"{model}_{rules}"] = r
    del session
report["launches"] = fr.apply_scaled_outer.launches
report["card"] = card_report()
with open(f"{cfg['out']}{mh.process_index()}.json", "w") as f:
    json.dump(report, f)
np.savez(f"{cfg['out']}{mh.process_index()}.npz", **outs)
exit_rank()
"""


def _split_want(params: dict, rules: str, n_model: int = 2) -> dict:
    """{leaf: split dim} of a rule set on a {data: 1, model: n_model}
    grid."""
    from video_spike_torch.models.linear import first_layer_sharding_rules
    from video_spike_torch.models.vtt import vtt_sharding_rules
    from video_spike_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 1, "model": n_model}, {"data": 0, "model": 0},
                {"data": None, "model": None})
    placed = (vtt_sharding_rules(params, mesh) if rules == "vtt" else
              first_layer_sharding_rules(params, mesh,
                                         min_dim=int(rules[5:])))
    return {k: p.split_dim(params[k].ndim) for k, p in placed.items()
            if p.axis is not None}


def phase_split_serve_path(work: Path, world: int = 2,
                           backend: str = "gloo", cases=SPLIT_CASES,
                           linear=("data", "smokeeid0", "logs"),
                           name: str = "split_serve_path") -> dict:
    """The serve phases' ``model_best``s served split over `world` ranks
    (2 gloo ranks sharing the card; 4 NCCL ranks on 4 cards, where the VTT
    is also split by columns: `cases`; `linear` names the Linear's fixture
    directory, session and log root under `work`): the full-width Linear
    under ``first_layer_sharding_rules(min_dim=256)`` (three kernels split
    by rows) and under ``vtt_sharding_rules`` (kernels split by columns),
    at buckets 1, 4 and 16; the VTT under ``first_layer_sharding_rules(
    min_dim=512)`` (every 512-input kernel split by rows) at bucket 4 with
    session ids. Each against the one-rank session on the same rows within
    SERVE_REL_BOUND, the ranks bitwise equal, every split leaf holding
    1/`world` of its rows or columns, no leaf gathered, the fused readout
    never launched; ``predict`` ms by size against the one-rank session,
    and the bytes each request all-reduces and all-gathers."""
    import numpy as np
    import yaml

    from video_spike_torch.serve import InferenceSession

    t_phase = time.perf_counter()
    _free_card()
    data, eid, logs = linear
    rows = _fixture_trials(work / data, eid,
                           max(SPLIT_SIZES)).reshape(max(SPLIT_SIZES), -1)
    video, sids = _vtt_trials(work, SPLIT_VTT_ROWS)
    for stem, arr in (("split_rows", rows), ("split_video", video),
                      ("split_sids", sids)):
        np.save(work / f"{stem}.npy", arr)
    models = {
        "linear": {"model_config": yaml.safe_load(
            _serve_yaml(work).read_text()),
            "ckpt_dir": str(_ckpt_dir(work / logs)),
            "buckets": list(SPLIT_BUCKETS), "sizes": list(SPLIT_SIZES),
            "rows": str(work / "split_rows.npy")},
        "vtt": {"model_config": yaml.safe_load(
            (ROOT / "configs/model/vtt_video.yaml").read_text()),
            "ckpt_dir": str(_ckpt_dir(work / "vtt_logs")),
            "buckets": [SPLIT_VTT_ROWS], "sizes": [SPLIT_VTT_ROWS],
            "rows": str(work / "split_video.npy"),
            "sids": str(work / "split_sids.npy")}}
    launch_s = _torchrun(SPLIT_SERVE_CHILD, world, {
        **models, "cases": [list(c) for c in cases],
        "reps": SPLIT_REPS, "out": str(work / "split_serve")},
        env=_backend_env(backend))
    served = [np.load(work / f"split_serve{r}.npz") for r in range(world)]
    reports = [json.loads((work / f"split_serve{r}.json").read_text())
               for r in range(world)]
    out = {"world": world, "backend": backend, "cases": {},
           "bound": SERVE_REL_BOUND,
           "fused_readout_launches": sum(r["launches"] for r in reports),
           "launch_seconds": launch_s,
           "cards": [r["card"] for r in reports]}
    if backend == "nccl":
        check_cards(out["cards"], world)
    bad = []
    for model in ("linear", "vtt"):
        c = models[model]
        one = InferenceSession.from_checkpoint(
            c["model_config"], c["ckpt_dir"], bucket_sizes=c["buckets"],
            device="cuda")
        full = {k: list(v.shape) for k, v in one.params.items()}
        src = video if model == "vtt" else rows
        for _, rules in (x for x in cases if x[0] == model):
            key = f"{model}_{rules}"
            r0 = reports[0][key]
            want = _split_want(one.params, rules, world)
            shapes = {k: v for k, v in r0["shard_shapes"].items()
                      if v != full[k]}
            errs, ms = {}, {}
            for n in c["sizes"]:
                args = (src[:n],) + ((sids[:n],) if model == "vtt" else ())
                ref = one.predict(*args)
                got = served[0][f"{key}_{n}"]
                errs[str(n)] = _rel_err(got, ref)
                if any(not np.array_equal(got, s[f"{key}_{n}"])
                       for s in served[1:]):
                    bad.append(f"{key}_{n}: ranks differ")
                times = []
                for _ in range(SPLIT_REPS):
                    t0 = time.perf_counter()
                    one.predict(*args)
                    times.append((time.perf_counter() - t0) * 1e3)
                ms[str(n)] = sorted(times)[len(times) // 2]
            halved = all(
                k in shapes and shapes[k][d] * world == full[k][d]
                for k, d in want.items()) and set(shapes) == set(want)
            out["cases"][key] = {
                "split_leaves": {k: [full[k], shapes.get(k)] for k in want},
                "gathered_leaves": [r[key]["gathered_leaves"]
                                    for r in reports],
                "max_rel_err": errs, "predict_ms_split": r0["predict_ms"],
                "predict_ms_one_rank": ms,
                "bytes_per_request": r0["bytes_per_request"],
                "attention_launches_by_rank": [r[key]["attention_launches"]
                                               for r in reports]}
            if (max(errs.values()) > SERVE_REL_BOUND or not halved
                    or any(r[key]["gathered_leaves"] for r in reports)):
                bad.append(key)
            if model == "vtt" and not all(
                    r[key]["attention_launches"][0] for r in reports):
                bad.append(f"{key}: the fused attention did not run")
        del one
        _free_card()
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit(name, **out)
    if bad or out["fused_readout_launches"]:
        raise AssertionError(f"split serving: {bad}, {out}")
    return out


def phase_export(work: Path) -> dict:
    """``cli.export_model`` on the full-width Linear checkpoint at batch 8,
    then ``load_exported`` at batches 3 and 8 against ``session.predict``;
    the same for the VTT with session ids. Both must export with a symbolic
    batch."""
    import numpy as np
    import torch
    import yaml

    from video_spike_torch.cli import export_model
    from video_spike_torch.ops import fused_readout as fr
    from video_spike_torch.serve import InferenceSession
    from video_spike_torch.serve.export import load_exported, save_exported

    t_phase = time.perf_counter()
    out_dir = work / "export"
    fr.apply_scaled_outer.launches = 0
    result = {}
    # Linear: float inputs in [0, 1] (the export's sample dtype)
    x = (_fixture_trials(work / "data", "smokeeid0", EXPORT_BATCH)
         .reshape(EXPORT_BATCH, -1).astype(np.float32) / 255)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    path = export_model.main([
        "--model_config", str(_serve_yaml(work)),
        "--ckpt_dir", str(_ckpt_dir(work / "logs")),
        "--input_dim", str(KERNEL_M), "--batch", str(EXPORT_BATCH),
        "--out", str(out_dir / "linear.pt2"), "--device", "cuda"])
    export_s = time.perf_counter() - t0
    export_peak = torch.cuda.max_memory_allocated() / 1e9
    _free_card()
    t0 = time.perf_counter()
    fn = load_exported(path)
    load_s = time.perf_counter() - t0
    polymorphic = fn.polymorphic
    got = {b: fn(x[:b]).float().cpu().numpy() for b in EXPORT_RUN_BATCHES}
    del fn
    _free_card()
    session = InferenceSession.from_checkpoint(
        yaml.safe_load(_serve_yaml(work).read_text()),
        _ckpt_dir(work / "logs"), device="cuda")
    result["linear"] = {
        "polymorphic": polymorphic,
        "seconds": export_s, "load_seconds": load_s,
        "bytes": Path(path).stat().st_size, "peak_mem_gb": export_peak,
        "max_rel_err": {str(b): _rel_err(got[b], session.predict(x[:b]))
                        for b in EXPORT_RUN_BATCHES}}
    del session
    _free_card()

    # the VTT's attention: the export's one eager forward, then each call
    # of the loaded program, launch the fused attention kernel
    session = _vtt_session(work)
    video, sids = _vtt_trials(work, EXPORT_BATCH)
    torch.cuda.reset_peak_memory_stats()
    _attention_reset()
    t0 = time.perf_counter()
    path = save_exported(session.model, session.params, video,
                         out_dir / "vtt.pt2", session_ids=sids)
    export_s = time.perf_counter() - t0
    eager = _attention_counts()
    fn = load_exported(path)
    _attention_reset()
    got = {b: fn(video[:b], sids[:b].astype(np.int64)).float().cpu().numpy()
           for b in EXPORT_RUN_BATCHES}
    program = _attention_counts()
    result["vtt"] = {
        "polymorphic": fn.polymorphic, "seconds": export_s,
        "bytes": Path(path).stat().st_size,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "max_rel_err": {str(b): _rel_err(
            got[b], session.predict(video[:b], session_ids=sids[:b]))
            for b in EXPORT_RUN_BATCHES},
        "attention_launches": {"export_forward": eager,
                               "program": program}}
    del session, fn
    _free_card()
    launches = fr.apply_scaled_outer.launches
    out = {**result, "bound": SERVE_REL_BOUND,
           "fused_readout_launches": launches,
           "phase_seconds": time.perf_counter() - t_phase}
    emit("export", **out)
    kernel_ran = (eager[0] > 0 and eager[1] == program[1] == 0
                  and program[0] == len(EXPORT_RUN_BATCHES) * eager[0])
    if launches or not kernel_ran \
            or not all(r["polymorphic"] for r in result.values()) \
            or any(e > SERVE_REL_BOUND for r in result.values()
                   for e in r["max_rel_err"].values()):
        raise AssertionError(f"export: {out}")
    return out


# ---------------------------------------------------------------------------
# phases 18-19: CEBRA and PCA embeddings, then RRR on them
# ---------------------------------------------------------------------------

def _cebra_argv(work: Path) -> list:
    return _rrr_args() + ["--eid", RRR_EID,
                          "--data_dir", str(work / "rrr" / "fixture"),
                          "--out_dim", str(CEBRA_OUT_DIM),
                          "--max_iterations", str(CEBRA_ITERATIONS),
                          "--device", "cuda"]


def phase_cebra_main_path(work: Path) -> tuple:
    """``cli.use_cebra`` (the recipe: 5,000 iterations, batch 512, 32
    units, 5 dimensions) on the RRR phase's session, ``--use_pca``,
    ``cli.unify_cebra``, then ``cli.train_rrr --input_mod cebra`` on the
    card. Returns (the phase's numbers, the fitted CEBRA)."""
    import numpy as np
    import torch

    from video_spike_torch.cli import train_rrr, unify_cebra, use_cebra
    from video_spike_torch.ops import fused_readout as fr

    t_phase = time.perf_counter()
    run = work / "cebra"
    (run / "data").mkdir(parents=True)
    argv = _cebra_argv(work)
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    with contextlib.chdir(run):
        t0 = time.perf_counter()
        cebra = use_cebra.main(argv, save_path=None)
        cebra_s = time.perf_counter() - t0
        pca = use_cebra.main(argv + ["--use_pca"], save_path=None)
        merged = unify_cebra.main(["--label", "cebra"])
        t0 = time.perf_counter()
        rrr = train_rrr.main(_rrr_args() + ["--input_mod", "cebra",
                                            "--device", "cuda"])[RRR_EID]
        rrr_s = time.perf_counter() - t0
        files = {p: (run / p).is_file()
                 for p in (cebra["path"], pca["path"], merged)}
        saved = np.load(run / cebra["path"], allow_pickle=True).item()
    launches = fr.apply_scaled_outer.launches
    losses = cebra["losses"]
    frames = CEBRA_TRAIN_TEST_TRIALS * T_FRAMES
    bps = float(np.nanmean(rrr["co_bps"]))
    out = {"frames": frames, "pixels": CEBRA_PIXELS,
           "pca_branch": "covariance" if frames > CEBRA_PIXELS else "gram",
           "iterations": CEBRA_ITERATIONS,
           "fit_seconds": cebra["seconds"],
           "ms_per_iteration": cebra["seconds"] / CEBRA_ITERATIONS * 1e3,
           "use_cebra_seconds": cebra_s, "pca_seconds": pca["seconds"],
           "losses_first_last": [losses[0], losses[-1]],
           "n_losses": len(losses),
           "embedding_shape": list(cebra["embedding"].shape),
           "pca_shape": list(pca["embedding"].shape),
           "train_X_shape": list(saved[RRR_EID]["X"][0].shape),
           "files": files, "rrr_mean_bps": bps, "rrr_seconds": rrr_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "fused_readout_launches": launches,
           "phase_seconds": time.perf_counter() - t_phase}
    emit("cebra_main_path", **out)
    want = [CEBRA_TRAIN_TEST_TRIALS, T_FRAMES, CEBRA_OUT_DIM]
    if (not all(files.values()) or out["embedding_shape"] != want
            or out["pca_shape"] != want
            or len(losses) != CEBRA_ITERATIONS // 100
            or not all(map(math.isfinite, losses))
            or not losses[-1] < losses[0] or not math.isfinite(bps)
            or not np.isfinite(cebra["embedding"]).all()
            or not np.isfinite(pca["embedding"]).all() or launches):
        raise AssertionError(f"CEBRA path: {out}")
    return out, cebra["model"]


def _up_to_sign_rel_err(got, ref) -> float:
    import numpy as np

    g = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    r = np.asarray(ref, np.float64).reshape(-1, ref.shape[-1])
    if g.shape != r.shape or not np.isfinite(g).all():
        raise AssertionError(f"{g.shape} vs {r.shape}, or not finite")
    return float(max(min(np.abs(g[:, k] - r[:, k]).max(),
                         np.abs(g[:, k] + r[:, k]).max())
                     for k in range(r.shape[1])) / np.abs(r).max())


def phase_cebra_card_vs_cpu(work: Path, model) -> dict:
    """Under PyTorch's default backend flags (cuDNN TF32 on, matmul TF32
    off): the fitted encoder's ``transform`` of every frame on the card
    against the same params on the CPU, and ``get_pca_embedding`` on the
    card against the CPU on both branches, up to a sign per column."""
    import torch

    from video_spike_torch.cli import use_cebra
    from video_spike_torch.models.cebra import (CEBRA, Offset10Encoder,
                                                get_pca_embedding)

    t_phase = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False       # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        video = use_cebra.build(_cebra_argv(work))["X"]
        flat = video.reshape(-1, CEBRA_PIXELS)
        t0 = time.perf_counter()
        card = model.transform(flat)
        card_s = time.perf_counter() - t0
        cpu = CEBRA(output_dimension=CEBRA_OUT_DIM, device="cpu")
        cpu.model = Offset10Encoder(CEBRA_PIXELS, model.num_units,
                                    CEBRA_OUT_DIM)
        cpu.params = {k: v.cpu() for k, v in model.params.items()}
        transform_err = _rel_err(card, cpu.transform(flat))
        pca = {}
        for branch, v in (("covariance", video),
                          ("gram", video[:PCA_GRAM_TRIALS])):
            t0 = time.perf_counter()
            got = get_pca_embedding(v, CEBRA_OUT_DIM, device="cuda")
            pca[f"{branch}_card_seconds"] = time.perf_counter() - t0
            pca[branch] = _up_to_sign_rel_err(
                got, get_pca_embedding(v, CEBRA_OUT_DIM, device="cpu"))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    out = {"frames": flat.shape[0], "transform_max_rel_err": transform_err,
           "transform_bound": CEBRA_F32_REL_BOUND,
           "transform_card_seconds": card_s, "pca_max_rel_err": pca,
           "pca_bound": PCA_REL_BOUND,
           "phase_seconds": time.perf_counter() - t_phase}
    emit("cebra_card_vs_cpu", **out)
    _free_card()
    if transform_err > CEBRA_F32_REL_BOUND or max(
            pca["covariance"], pca["gram"]) > PCA_REL_BOUND:
        raise AssertionError(f"CEBRA card vs CPU beyond its bound: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the offline ETL, raw session -> trial shards
# ---------------------------------------------------------------------------

def phase_etl_main_path(work: Path) -> dict:
    """``cli.prepare_data.etl_session`` (what ``--raw_npz`` runs, on the
    session in memory) with its flow on the card: one npy shard per kept
    trial, every shard read back through ``split_dataset`` and
    ``SessionDataset``; then one trial's flow on the card against the CPU,
    timed with CUDA events and profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scripts.profile_torch_step import summarize
    from video_spike_torch.cli import prepare_data
    from video_spike_torch.data.dataset import SessionDataset, split_dataset
    from video_spike_torch.data.synthetic import raw_session
    from video_spike_torch.data.tar_io import read_trial_tar
    from video_spike_torch.ops import flow
    from video_spike_torch.ops import fused_readout as fr

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    raw = raw_session(ETL_EID, ETL_TRIALS, ETL_NEURONS, seed=0,
                      height=ETL_FRAME[0], width=ETL_FRAME[1],
                      nose_xy=ETL_NOSE, pupil_xy=ETL_PUPIL)
    raw_s = time.perf_counter() - t0
    out_dir = work / "etl"
    torch.cuda.reset_peak_memory_stats()
    fr.apply_scaled_outer.launches = 0
    t0 = time.perf_counter()
    files = prepare_data.etl_session(raw, out_dir, ETL_EID,
                                     store_video_as="npy", device="cuda")
    etl_s = time.perf_counter() - t0
    launches = fr.apply_scaled_outer.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    del raw

    t0 = time.perf_counter()
    split = split_dataset(out_dir, eid=ETL_EID, seed=0)
    shards = split["train"] + split["val"] + split["test"]
    n_read, shapes, finite = 0, set(), True
    for batch in SessionDataset(shards, batch_size=16, cache=False):
        n_read += len(batch["eid"])
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        shapes.add(json.dumps({k: list(v.shape[1:])
                               for k, v in arrays.items()}, sort_keys=True))
        finite &= all(np.isfinite(v).all() for v in arrays.values()
                      if v.dtype == np.float32)
    read_s = time.perf_counter() - t0
    sample = read_trial_tar(files[0])
    n_kept = int(sample["meta"]["n_neurons"])
    h, w = ETL_ROI[1], ETL_ROI[0]
    want = {"ap": [100, n_kept], "block": [1], "choice": [1],
            "timestamp": [T_FRAMES], "video": [T_FRAMES, 1, *ETL_FRAME],
            "wheel-speed": [T_FRAMES], "whisker-motion-energy": [T_FRAMES],
            "whisker-of": [T_FRAMES, 3], "whisker-of-2d": [T_FRAMES, 2],
            "whisker-of-video": [T_FRAMES - 1, h, w, 2],
            "whisker-video": [T_FRAMES, 1, h, w]}

    # one trial's flow: the card against the CPU, then timed and profiled
    video = sample["whisker-video"][:, 0].astype(np.float32)
    card = flow.get_optic_flow(video, device="cuda")
    t0 = time.perf_counter()
    cpu = flow.get_optic_flow(video, device="cpu")
    cpu_s = time.perf_counter() - t0
    field_rel = float(np.abs(card["of-video"] - cpu["of-video"]).max()
                      / np.abs(cpu["of-video"]).max())
    of_err = {k: float(np.abs(card[k] - cpu[k]).max())
              for k in ("of", "of-2d", "me")}
    frames = torch.from_numpy(video).cuda()
    windows = [cuda_ms(lambda: flow.farneback_flow(frames[:-1], frames[1:]),
                       ETL_FLOW_REPS) for _ in range(REPS)]
    t0 = time.perf_counter()
    for _ in range(ETL_FLOW_REPS):
        flow.get_optic_flow(video, device="cuda")
    features_ms = (time.perf_counter() - t0) / ETL_FLOW_REPS * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        flow.farneback_flow(frames[:-1], frames[1:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profiled = summarize(prof, wall, 1, "trial")
    del frames
    _free_card()

    out = {"trials": ETL_TRIALS, "neurons_before_filter": ETL_NEURONS,
           "frame": list(ETL_FRAME), "whisker_roi": sample["meta"]
           ["whisker_roi"], "trials_written": len(files),
           "trials_read": n_read, "neurons_kept": n_kept,
           "shapes": [json.loads(s) for s in shapes], "finite": finite,
           "raw_session_seconds": raw_s, "etl_seconds": etl_s,
           "etl_ms_per_trial": etl_s / max(len(files), 1) * 1e3,
           "read_seconds": read_s, "peak_mem_gb": peak,
           "flow_ms_per_trial": statistics.median(windows),
           "flow_ms_windows": windows,
           "features_ms_per_trial": features_ms,
           "cpu_features_seconds": cpu_s, **profiled,
           "card_vs_cpu": {"field_max_rel_err": field_rel,
                           "field_bound": ETL_FIELD_REL_BOUND,
                           "features_max_abs_err": of_err,
                           "features_bound": ETL_OF_ABS_BOUND},
           "fused_readout_launches": launches,
           "cuts": "80 trials of a session's several hundred; 128x192 "
                   "frames, not the camera's resolution; random session "
                   "from seed 0",
           "phase_seconds": time.perf_counter() - t_phase}
    emit("etl_main_path", **out)
    if (not files or n_read != len(files)
            or shapes != {json.dumps(want, sort_keys=True)}
            or not finite or out["whisker_roi"] != ETL_ROI or n_kept < 1
            or launches):
        raise AssertionError(f"ETL path: {out}")
    if field_rel > ETL_FIELD_REL_BOUND or max(
            of_err["of"], of_err["of-2d"]) > ETL_OF_ABS_BOUND:
        raise AssertionError(f"ETL flow card vs CPU beyond its bound: "
                             f"{out['card_vs_cpu']}")
    return out


# ---------------------------------------------------------------------------
# --cards 4: the multi-rank paths, one rank a card, over NCCL
# ---------------------------------------------------------------------------

CARDS = 4
MC_LAUNCH_TIMEOUT = 420
MC_WINDOWS = 3                # staged timing windows on the ranks
MC_EPOCHS_TIMED = 3           # staged epochs a window on 4 ranks x 16 rows:
                              # 2 steps an epoch of the 160-trial fixture
MC_ONE_CARD_EPOCHS = {BATCH: 2, CARDS * BATCH: 3}   # 16 and 6 steps a window
MC_GATHER_REPS = 6            # timed factor gathers (the first dropped)
MC_SSL_FIRST, MC_SSL_MAX = 20, 30
MC_SSL_VALIDATE_EVERY = 10
MC_CLEAN_LAUNCHES, MC_CLEAN_AT_ONCE = 16, 8
# the plain launch's process-group timeout, and what a peer may take beyond
# it to be ended: NCCL's watchdog aborts a timed-out rank ~70 s after the
# timeout (89.5 s after a raise at a 20 s timeout on 4 H100s)
MC_EXIT_TIMEOUT_S, MC_EXIT_SLACK_S = 20, 90
MC_LAUNCHER_BOUND_S = 30      # torchrun stops a raising rank's peers within
MC_SPLIT_CASES = SPLIT_CASES + (("vtt", "vtt"),)
DCN_EID = "dcntrain00"

# every rank: the kernel phase on its own card (the library the parent
# built, loaded by each process; the launch plan on each card's SM count)
MC_KERNEL_CHILD = r"""
import json, sys
import torch
from chip_smoke import card_report, phase_kernel
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.ops import cuda_lib
from video_spike_torch.ops import fused_readout as fr

cfg = json.loads(sys.argv[1])
prebuilt = cuda_lib.lib_path(fr._SOURCE).exists()
assert setup_runtime("cuda")
out = {"card": card_report(), "library_prebuilt": prebuilt,
       "sm_count": fr._sm_count(torch.cuda.current_device()),
       "kernel": phase_kernel()}
with open(f"{cfg['out']}{out['card']['rank']}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: one fused step of the trainer cfg["argv"] builds, from its
# seeded init, on this rank's block of cfg["rows"] seeded rows; rank 0
# saves W
_FIRST_STEP = r"""
def first_step(argv, rows, out):
    trainer = train_cli.build_trainer(get_args(argv))
    trainer._init_if_needed()
    p = {k: v.clone() for k, v in trainer.params.items()}
    g = torch.Generator(device="cuda").manual_seed(1234)
    m = p[fr.FIRST_KERNEL].shape[0]
    x = torch.randint(0, 256, (rows, m), generator=g, device="cuda",
                      dtype=torch.uint8)
    ap = torch.poisson(torch.full((rows, 100, cfg["neurons"]), 0.5,
                                  device="cuda"), generator=g)
    rank, world = mh.process_index(), mh.process_count()
    b = rows // world
    n0 = fr.apply_scaled_outer.launches
    p1, _, loss = trainer._step_fn(
        p, fr.init_fused_opt_state(p, trainer.tx),
        x[rank * b:(rank + 1) * b], ap[rank * b:(rank + 1) * b], rows, 0)
    w = p1[fr.FIRST_KERNEL]
    if rank == 0:
        torch.save(w.cpu(), f"{out}_w.pt")
    return {"loss": float(loss), "launches": fr.apply_scaled_outer.launches
            - n0, "w_checksums": mh.replica_checksums(
                {"w": w}, dist.group.WORLD)}
"""

_MC_IMPORTS = r"""
import gc, json, sys, time
import torch
import torch.distributed as dist
from chip_smoke import card_report
from video_spike_torch.cli import train as train_cli
from video_spike_torch.core.cli import get_args
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.parallel import multihost as mh
cfg = json.loads(sys.argv[1])
"""

# every rank: the same first step, alone (the four gloo ranks on card 0)
MC_FIRST_STEP_CHILD = _MC_IMPORTS + _FIRST_STEP + r"""
assert setup_runtime("cuda")
out = {"card": card_report(),
       "first": first_step(cfg["argv"], cfg["rows"], cfg["out"])}
with open(f"{cfg['out']}{mh.process_index()}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: cli.train 2 epochs streamed, --resume to 3 (the kernel's B at
# every launch), the first step, staged ms/step, the factor gather alone
MC_DP_CHILD = _MC_IMPORTS + _CHILD_TIMING + _FIRST_STEP + r"""
assert setup_runtime("cuda")
batches, _launch = [], fr._launch_cuda


def recording_launch(w, xa, dzc, seed):
    batches.append(int(xa.shape[0]))
    return _launch(w, xa, dzc, seed)


fr._launch_cuda = recording_launch
torch.cuda.reset_peak_memory_stats()
fr.apply_scaled_outer.launches = 0
res = train_cli.main(cfg["argv"] + ["--num_epochs", "2"])
launches, kernel_batches = fr.apply_scaled_outer.launches, list(batches)
peak_gb = torch.cuda.max_memory_allocated() / 1e9
batches.clear()
fr.apply_scaled_outer.launches = 0
res2 = train_cli.main(cfg["argv"] + ["--num_epochs", "3", "--resume"])
resume_launches, resume_batches = fr.apply_scaled_outer.launches, batches
fr._launch_cuda = _launch
gc.collect()
torch.cuda.empty_cache()
first = first_step(cfg["timing_argv"], cfg["rows"], cfg["out"])
gc.collect()
torch.cuda.empty_cache()
trainer = train_cli.build_trainer(get_args(cfg["timing_argv"]))
ms = staged_ms(trainer, cfg["windows"], cfg["epochs"], mh.barrier)
flat_dtype = trainer.model.compute_dtype
del trainer
gc.collect()
torch.cuda.empty_cache()
b = cfg["rows"] // mh.process_count()
flat = torch.zeros((b, cfg["m"]), dtype=flat_dtype, device="cuda")
dz = torch.zeros((b, cfg["n"]), dtype=torch.float32, device="cuda")
gather_ms = []
for i in range(cfg["gather_reps"]):
    mh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mh.gather_rows(flat, dist.group.WORLD)
    mh.gather_rows(dz, dist.group.WORLD)
    torch.cuda.synchronize()
    if i:
        gather_ms.append((time.perf_counter() - t0) * 1e3)
out = {"card": card_report(), "train_losses": res["train_losses"],
       "steps": res["global_step"], "launches": launches,
       "kernel_batches": kernel_batches,
       "replica_checksums": res["replica_checksums"],
       "resume_start_epoch": res2["start_epoch"],
       "resume_steps": res2["global_step"] - res["global_step"],
       "resume_launches": resume_launches, "resume_batches": resume_batches,
       "resume_replica_checksums": res2["replica_checksums"],
       "test": res["test_res"], "log_dir": res["log_dir"],
       "peak_mem_gb": peak_gb, "first": first, "ms_per_step_windows": ms,
       "gather_ms": gather_ms,
       "factor_bytes": {"sent": flat.numel() * flat.element_size()
                        + dz.numel() * 4,
                        "gathered": mh.process_count() * (
                            flat.numel() * flat.element_size()
                            + dz.numel() * 4)}}
with open(f"{cfg['out']}{mh.process_index()}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: SSL pretraining through pretrain.main(data=) to cfg
# ["first_steps"], then --resume to cfg["max_steps"]; the replicas'
# checksums after each; the lr each trainer built; staged ms/step
MC_SSL_CHILD = r"""
import gc, json, os, pickle, sys
from pathlib import Path
import torch
import torch.distributed as dist
from chip_smoke import card_report, ssl_args, ssl_staged_trainer
from video_spike_torch.cli import pretrain
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.ops import fused_adamw
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.train import contrast

cfg = json.loads(sys.argv[1])
assert setup_runtime("cuda")
run = Path(cfg["run"])
os.chdir(run)
with open(run / "data.pkl", "rb") as f:
    data = pickle.load(f)
trainers, lrs = [], []
_make, _adamw = pretrain.make_contrast_trainer, contrast.AdamW


def make(*args, **kwargs):
    t = _make(*args, **kwargs)
    if not trainers:                # the first run stops at first_steps
        t.max_steps = cfg["first_steps"]
    trainers.append(t)
    return t


def adamw(lr, **kwargs):
    lrs.append(lr)
    return _adamw(lr, **kwargs)


pretrain.make_contrast_trainer, contrast.AdamW = make, adamw
argv = ssl_args(run, "mc_logs", cfg["max_steps"]) + [
    "--validate_every", str(cfg["validate_every"])]
fr.apply_scaled_outer.launches = 0
fused_adamw.step_.launches = 0
res = pretrain.main(argv, data=data)
sums = [mh.replica_checksums(trainers[0].params, dist.group.WORLD)]
res2 = pretrain.main(argv + ["--resume"], data=data)
sums.append(mh.replica_checksums(trainers[1].params, dist.group.WORLD))
launches = fr.apply_scaled_outer.launches
adamw_launches = fused_adamw.step_.launches
grad_bytes = sum(v.numel() * v.element_size()
                 for v in trainers[1].params.values())
pretrain.make_contrast_trainer, contrast.AdamW = _make, _adamw
del trainers
gc.collect()
torch.cuda.empty_cache()
trainer, staged = ssl_staged_trainer(run, data, "mc_timing")
for _ in range(3):
    trainer._step_staged(staged, 0)
ms = []
for _ in range(cfg["windows"]):
    mh.barrier()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(cfg["steps"]):
        trainer._step_staged(staged, 0)
    end.record()
    torch.cuda.synchronize()
    ms.append(start.elapsed_time(end) / cfg["steps"])
out = {"card": card_report(), "lrs": lrs, "launches": launches,
       "adamw_launches": adamw_launches,
       "first": {k: res[k] for k in ("train_losses", "steps", "start_step",
                                     "val_history", "n_params")},
       "resumed": {k: res2[k] for k in ("train_losses", "steps",
                                        "start_step", "val_history")},
       "replica_checksums": sums, "grad_bytes_per_step": grad_bytes,
       "ms_per_step_windows": ms,
       "artifact": os.path.exists(res["path"]), "path": res["path"]}
with open(run / f"mc_ssl{mh.process_index()}.json", "w") as f:
    json.dump(out, f)
exit_rank()
"""

# every rank: collectives over the world and over the mesh's model groups
# (every rank creates every line's group), then leave through run_rank; with
# "raise" rank 1 raises while its peers wait in a collective
MC_EXIT_CHILD = r"""
import json, sys, threading, time
import torch
import torch.distributed as dist
from chip_smoke import card_report
from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.runtime import run_rank, setup_runtime
from video_spike_torch.parallel.mesh import make_mesh


def thread_cards():
    # where a thread this process starts puts a "cuda" tensor, and one on
    # the resolved device
    dev, seen = resolve_device("cuda"), {}

    def probe():
        seen["bare"] = torch.zeros(1, device="cuda").device.index
        seen["resolved"] = torch.zeros(1, device=dev).device.index

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return seen


def main():
    assert setup_runtime("cuda")
    r = dist.get_rank()
    t = torch.full((4,), r + 1.0, device="cuda")
    dist.all_reduce(t)
    mesh = make_mesh(n_data=2, n_model=2)
    u = torch.full((3,), float(r), device="cuda")
    dist.all_reduce(u, group=mesh.group("model"))
    if sys.argv[1] == "raise":
        if r == 1:
            print(f"pid={r} raising_at={time.time()!r}", flush=True)
            raise ValueError("rank 1 fails on purpose")
        dist.all_reduce(t)        # waits for a peer that has left
    print(f"pid={r} result=" + json.dumps(
        {"t": t.tolist(), "u": u.tolist(), "card": card_report(),
         "thread_cards": thread_cards()}), flush=True)


run_rank(main)
"""


def _rank_results(text: str, world: int) -> list:
    """Each rank's ``pid=<rank> result={...}`` object from a launch's
    output."""
    import re

    found = []
    for pid in range(world):
        m = re.search(rf"pid={pid} result=\{{", text)
        if not m:
            raise AssertionError(f"no result from rank {pid}:\n"
                                 f"{text[-4000:]}")
        found.append(json.JSONDecoder().raw_decode(text, m.end() - 1)[0])
    return found


def _launch_cmd(*args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={CARDS}", *args]


def _ranks_json(base: Path, world: int = CARDS) -> list:
    return [json.loads(Path(f"{base}{r}.json").read_text())
            for r in range(world)]


def phase_mc_cards() -> dict:
    """Every card's name, power limit and PCI bus id as ``nvidia-smi``
    reports them, and the links between the cards (``nvidia-smi topo
    -m``)."""
    def smi(*args, check=True):
        p = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True, check=check, timeout=60)
        return (p.stdout + p.stderr).rstrip().splitlines()

    out = {"nvidia_smi": smi("--query-gpu=name,power.limit",
                             "--format=csv,noheader"),
           "cards": smi("--query-gpu=index,name,power.limit,pci.bus_id",
                        "--format=csv,noheader"),
           # the links between the cards (NVLink or PCIe), where the
           # host's nvidia-smi reports them
           "topo": smi("topo", "-m", check=False)}
    emit("mc_cards", **out)
    return out


def phase_mc_kernel() -> dict:
    """The kernel phase on each card at once (one rank a card): bitwise on
    exact sums, within tolerance on random inputs, timed at the Linear,
    probe and B = 64 shapes; each rank loads the library the parent built
    and plans on its own card's SM count."""
    with tempfile.TemporaryDirectory(prefix="vst_mc_kernel_") as tmp:
        base = Path(tmp) / "kernel"
        seconds = _torchrun(MC_KERNEL_CHILD, CARDS, {"out": str(base)},
                            timeout=MC_LAUNCH_TIMEOUT)
        ranks = _ranks_json(base)
    check_cards([r["card"] for r in ranks], CARDS)
    if not all(r["library_prebuilt"] for r in ranks):
        raise AssertionError("a rank built the kernel library itself")
    kernel = dict(ranks[0]["kernel"])
    kernel["max_abs_err"] = max(r["kernel"]["max_abs_err"] for r in ranks)
    kernel["by_card"] = [
        {"card": r["card"]["name"], "pci_bus_id": r["card"]["pci_bus_id"],
         "sm_count": r["sm_count"], "linear_ms": r["kernel"]["ms"],
         "plain_ms": r["kernel"]["plain_ms"],
         "probe_ms": r["kernel"]["probe"]["ms"],
         "b64_ms": r["kernel"]["b64"]["ms"],
         "max_abs_err": r["kernel"]["max_abs_err"]} for r in ranks]
    emit("mc_kernel", by_card=kernel["by_card"], launch_seconds=seconds)
    return kernel


def phase_mc_fixtures(work: Path) -> dict:
    """The 160-trial Linear fixture, the five VTT sessions and a VTT
    ``model_best`` (one epoch on card 0), the SSL session's features (kept
    in memory and pickled for the ranks) and the small fixture of the
    trainer smokes."""
    import pickle

    import torch

    from video_spike_torch.cli import make_fixture
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.data.synthetic import make_synthetic_session

    t0 = time.perf_counter()
    make_fixture.main(["--out", str(work / "stream_data"), "--eid",
                       STREAM_EID, "--n_trials", str(STREAM_TRIALS),
                       "--n_neurons", str(N_NEURONS),
                       "--height", str(HEIGHT), "--width", str(WIDTH)])
    vtt_fixture(work / "vtt_data")
    res = train_cli.main(vtt_args(work, "vtt_logs") + ["--num_epochs", "1"])
    torch.cuda.synchronize()
    data = ssl_data(work / "ssl")
    with open(work / "ssl" / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    del data
    make_synthetic_session(work / "dcn_fix", eid=DCN_EID, n_trials=16,
                           n_neurons=5, seed=31, height=32, width=32)
    _free_card()
    out = {"seconds": time.perf_counter() - t0,
           "vtt_train_losses": res["train_losses"]}
    emit("mc_fixtures", **out)
    return out



def phase_mc_one_card(work: Path) -> dict:
    """One card's staged production Linear step on the 160-trial fixture at
    16 rows and at 64 rows (the 4-card step's local and global batch), in
    this process on card 0, while the other cards idle."""
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.core.cli import get_args

    out = {}
    for rows, epochs in MC_ONE_CARD_EPOCHS.items():
        args = _stream_args(work, _train_yaml(work), f"mc_one{rows}")
        args[args.index("--batch_size") + 1] = str(rows)
        trainer = train_cli.build_trainer(get_args(args))
        windows, _ = staged_window_ms(trainer, epochs)
        del trainer
        _free_card()
        out[str(rows)] = {"ms_per_step": statistics.median(windows),
                          "ms_per_step_windows": windows}
    emit("mc_one_card", **out)
    return out


def phase_mc_dp_linear(work: Path, one_card: dict) -> dict:
    """(a) The production Linear at full width through ``cli.train`` on 4
    NCCL ranks, 16 rows each (the kernel on the gathered 64), streamed
    from the 160-trial fixture, 2 epochs then ``--resume`` to 3: a launch a
    step on every rank, each at B = 64; the replicas' checksums equal every
    epoch; rank 0 the only writer. Then the first step on seeded rows from
    the seeded init, whose W must be bitwise that of the same step on 4
    gloo ranks sharing card 0 (the factors reach the kernel by all-gather,
    a copy); the staged ms/step against one card's 16- and 64-row steps;
    the factor gather's bytes and ms; each card's peak memory."""
    import torch

    rows = CARDS * BATCH
    cli_yaml = _variant_yaml(work, "mc_stream", PRODUCTION_OPTIMIZER,
                             {"device_cache": False, "save_every": 1})
    timing_argv = _stream_args(work, _train_yaml(work), "mc_dp_timing")
    seconds = _torchrun(MC_DP_CHILD, CARDS, {
        "argv": _stream_args(work, cli_yaml, "mc_dp_logs"),
        "timing_argv": timing_argv, "rows": rows, "neurons": N_NEURONS,
        "windows": MC_WINDOWS, "epochs": MC_EPOCHS_TIMED,
        "m": KERNEL_M, "n": KERNEL_N, "gather_reps": MC_GATHER_REPS,
        "out": str(work / "mc_dp")}, timeout=MC_LAUNCH_TIMEOUT)
    ranks = _ranks_json(work / "mc_dp")
    cards = [r["card"] for r in ranks]
    check_cards(cards, CARDS)
    gloo_s = _torchrun(MC_FIRST_STEP_CHILD, CARDS, {
        "argv": _stream_args(work, _train_yaml(work), "mc_gloo_timing"),
        "rows": rows, "neurons": N_NEURONS, "out": str(work / "mc_gloo")},
        env={"VST_DIST_BACKEND": "gloo", "CUDA_VISIBLE_DEVICES": "0"},
        timeout=MC_LAUNCH_TIMEOUT)
    gloo = _ranks_json(work / "mc_gloo")
    r0, bad = ranks[0], []
    for key in ("train_losses", "steps", "replica_checksums", "test",
                "resume_replica_checksums"):
        if any(r[key] != r0[key] for r in ranks):
            bad.append(f"ranks differ in {key}: {[r[key] for r in ranks]}")
    for r in ranks:
        if r["steps"] == 0 or r["launches"] != r["steps"] \
                or r["kernel_batches"] != [rows] * r["steps"] \
                or r["resume_steps"] == 0 \
                or r["resume_launches"] != r["resume_steps"] \
                or r["resume_batches"] != [rows] * r["resume_steps"] \
                or r["resume_start_epoch"] != 2 \
                or r["first"]["launches"] != 1:
            bad.append(f"rank {r['card']['rank']}: launches "
                       f"{r['launches']} at B {r['kernel_batches']}, steps "
                       f"{r['steps']}; resume {r['resume_launches']} at B "
                       f"{r['resume_batches']}, steps {r['resume_steps']} "
                       f"from epoch {r['resume_start_epoch']}")
    if len(r0["replica_checksums"]) != 2 \
            or len(r0["resume_replica_checksums"]) != 1 \
            or not all(math.isfinite(v) for v in r0["train_losses"]):
        bad.append(f"want a finite loss and a checksum an epoch: {r0}")
    run_dir = Path(r0["log_dir"])
    written = sorted(p.name for p in run_dir.iterdir())
    if written != ["metrics.jsonl", "model_best.pt", "model_last.pt",
                   "test_results.npy"]:
        bad.append(f"rank-0 artifacts: {written}")
    w_nccl = torch.load(work / "mc_dp_w.pt", weights_only=True)
    w_gloo = torch.load(work / "mc_gloo_w.pt", weights_only=True)
    differ = (w_nccl.view(torch.int16) != w_gloo.view(torch.int16)).any(1)
    first_rows = differ.nonzero().flatten()[:10].tolist()
    del w_nccl, w_gloo
    first = {"nccl": r0["first"], "gloo": gloo[0]["first"],
             "w_bitwise": not first_rows, "rows_differ": int(differ.sum()),
             "first_differing_rows": first_rows}
    for run in ([r["first"] for r in ranks], [g["first"] for g in gloo]):
        if len(set(run[0]["w_checksums"])) != 1 \
                or any(x["w_checksums"] != run[0]["w_checksums"]
                       for x in run):
            bad.append(f"first-step replicas differ: {run}")
    if any(g["card"]["backend"] != "gloo" or g["card"]["current_device"]
           for g in gloo):
        bad.append(f"the gloo run is not 4 ranks on card 0: "
                   f"{[g['card'] for g in gloo]}")
    if first_rows:
        bad.append(f"W after the first step differs from the 4-gloo-rank "
                   f"run in {first['rows_differ']} rows, first "
                   f"{first_rows}")
    ms = statistics.median(x for r in ranks
                           for x in r["ms_per_step_windows"])
    out = {"world": CARDS, "backend": "nccl", "local_batch": BATCH,
           "global_batch": rows, "cards": cards,
           "train_losses": r0["train_losses"], "steps_per_rank": r0["steps"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "launches": sum(r["launches"] for r in ranks),
           "resume_launches": sum(r["resume_launches"] for r in ranks),
           "kernel_batches": r0["kernel_batches"],
           "replica_checksums": r0["replica_checksums"]
           + r0["resume_replica_checksums"],
           "test": r0["test"], "rank0_artifacts": written,
           "first_step": first, "ms_per_step": ms,
           "ms_per_step_windows": [r["ms_per_step_windows"] for r in ranks],
           "one_card_ms_per_step": one_card,
           "factor_bytes_per_step": r0["factor_bytes"],
           "gather_ms": statistics.median(x for r in ranks
                                          for x in r["gather_ms"]),
           "gather_ms_by_rank": [r["gather_ms"] for r in ranks],
           "peak_mem_gb_by_card": [r["peak_mem_gb"] for r in ranks],
           "launch_seconds": {"nccl": seconds, "gloo_first_step": gloo_s}}
    out["gather_gb_per_s"] = (r0["factor_bytes"]["gathered"]
                              - r0["factor_bytes"]["sent"]) \
        / out["gather_ms"] / 1e6
    emit("mc_dp_linear", **out)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def phase_mc_model_axis_linear(work: Path) -> dict:
    """(b) ``cli.train`` on the full-width Linear with ``training.mesh:
    {data: 2, model: 2}`` over 4 NCCL ranks (16 rows a data row), 2 epochs
    then ``--resume`` to 3: the checks of ``_tp_linear`` (the ranks agree,
    a launch a step, a checksum an epoch, rank 0 the only writer), and W
    after the 2 epochs bitwise that of ``{data: 2, model: 1}`` on 2 NCCL
    ranks (cards 0 and 1), both streamed: a model-axis replica of a data
    row computes what that row's rank computes."""
    # both streamed: a model axis refuses the rank-local trial cache
    mesh_yaml = _variant_yaml(work, "mc_model_axis", PRODUCTION_OPTIMIZER,
                              training={"mesh": {"data": 2, "model": 2},
                                        "device_cache": False})
    ref_yaml = _variant_yaml(work, "mc_model_axis_ref", PRODUCTION_OPTIMIZER,
                             training={"mesh": {"data": 2, "model": 1},
                                       "device_cache": False})
    seconds = _torchrun(TP_LINEAR_CHILD, CARDS, {
        "argv": _stream_args(work, mesh_yaml, "mc_tp_logs"),
        "out": str(work / "mc_tp")}, timeout=MC_LAUNCH_TIMEOUT)
    ref_s = _torchrun(TP_LINEAR_CHILD, 2, {
        "argv": _stream_args(work, ref_yaml, "mc_tp_ref_logs"),
        "out": str(work / "mc_tp_ref"), "resume": False},
        timeout=MC_LAUNCH_TIMEOUT)
    ranks = _ranks_json(work / "mc_tp")
    ref = _ranks_json(work / "mc_tp_ref", 2)[0]
    check_cards([r["card"] for r in ranks], CARDS)
    r0, bad = ranks[0], []
    for key in ("train_losses", "steps", "replica_checksums", "test",
                "resume_replica_checksums"):
        if any(r[key] != r0[key] for r in ranks):
            bad.append(f"ranks differ in {key}: {[r[key] for r in ranks]}")
    written = sorted(p.name for p in Path(r0["log_dir"]).iterdir())
    if written != ["metrics.jsonl", "model_best.pt", "model_last.pt",
                   "test_results.npy"]:
        bad.append(f"rank-0 artifacts: {written}")
    for r in ranks:
        if r["backend"] != "nccl" or r["world"] != CARDS \
                or r["steps"] != ref["steps"] or r["steps"] == 0 \
                or r["launches"] != r["steps"] \
                or r["resume_launches"] != r["resume_steps"] \
                or 2 * r["resume_steps"] != r["steps"] \
                or r["resume_start_epoch"] != 2:
            bad.append(f"model-axis rank {r['rank']}: {r}")
    if len(r0["replica_checksums"]) != 2 \
            or len(r0["resume_replica_checksums"]) != 1 \
            or not all(math.isfinite(v) for v in r0["train_losses"]):
        bad.append(f"model-axis run: {r0}")
    out = {"mesh": {"data": 2, "model": 2}, "world": CARDS,
           "backend": "nccl", "batch_per_data_row": BATCH,
           "train_losses": r0["train_losses"],
           "data_only_losses": ref["train_losses"],
           "steps_per_rank": r0["steps"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "launches": sum(r["launches"] for r in ranks),
           "resume_launches": sum(r["resume_launches"] for r in ranks),
           "replica_checksums": r0["replica_checksums"]
           + r0["resume_replica_checksums"],
           "w_bitwise_data_only": r0["w_digest"] == ref["w_digest"],
           "w_digest": r0["w_digest"], "data_only_w_digest":
           ref["w_digest"], "test": r0["test"],
           "cards": [r["card"] for r in ranks],
           "launch_seconds": {"mesh": seconds, "data_only": ref_s}}
    if not out["w_bitwise_data_only"] \
            or ref["train_losses"] != r0["train_losses"]:
        bad.append("W or the losses differ from {data: 2, model: 1}")
    emit("mc_model_axis_linear", **out)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def phase_mc_tensor_vtt(work: Path) -> dict:
    """(c) The tensor-sharded VTT at full width on {data: 2, model: 2}, 4
    NCCL ranks, 3 steps in f32 and bf16 against the unsplit step on card 0
    (``_tp_vtt``'s bounds), ms/step and bytes a step."""
    out = _tp_vtt(work, "nccl")
    emit("mc_tensor_vtt", **out)
    return out


def phase_mc_ssl(work: Path) -> dict:
    """(e) ContrastViTMAE pretraining data-parallel on 4 NCCL ranks × 128
    triplets through ``pretrain.main(..., data=)``: stopped at step 20,
    then ``--resume`` to 30; the replicas' checksums equal after each, the
    losses finite, the lr 4 × the recipe's, rank 0 the only writer of the
    embeddings; staged ms/step against one card's in this call and the
    gradient bytes all-reduced a step."""
    import pickle

    import yaml

    run = work / "ssl"
    with open(run / "data.pkl", "rb") as f:
        data = pickle.load(f)
    one = ssl_step_ms(work, data)
    del data
    _free_card()
    seconds = _torchrun(MC_SSL_CHILD, CARDS, {
        "run": str(run), "first_steps": MC_SSL_FIRST,
        "max_steps": MC_SSL_MAX, "validate_every": MC_SSL_VALIDATE_EVERY,
        "windows": MC_WINDOWS, "steps": SSL_STEPS},
        timeout=MC_LAUNCH_TIMEOUT)
    ranks = [json.loads((run / f"mc_ssl{r}.json").read_text())
             for r in range(CARDS)]
    check_cards([r["card"] for r in ranks], CARDS)
    lr = yaml.safe_load((ROOT / "configs/train/vmae_video.yaml")
                        .read_text())["optimizer"]["lr"]
    r0, bad = ranks[0], []
    losses = r0["first"]["train_losses"] + r0["resumed"]["train_losses"]
    for r in ranks:
        sums = r["replica_checksums"]
        if any(len(set(s)) != 1 for s in sums) or sums != r0["replica_checksums"]:
            bad.append(f"replicas differ: {sums}")
        if r["lrs"] != [CARDS * lr] * 2:
            bad.append(f"rank {r['card']['rank']} lr {r['lrs']}, want "
                       f"{CARDS} x {lr}")
        if r["first"]["steps"] != MC_SSL_FIRST \
                or r["resumed"]["start_step"] != MC_SSL_FIRST \
                or r["resumed"]["steps"] != MC_SSL_MAX - MC_SSL_FIRST:
            bad.append(f"rank {r['card']['rank']} steps: {r['first']}, "
                       f"{r['resumed']}")
        if r["adamw_launches"] != MC_SSL_MAX:
            bad.append(f"rank {r['card']['rank']}: {r['adamw_launches']} "
                       f"fused AdamW launches in {MC_SSL_MAX} steps")
    if not losses or not all(math.isfinite(v) for v in losses):
        bad.append(f"losses {losses}")
    if [r["artifact"] for r in ranks] != [True] * CARDS:
        bad.append("the embeddings were not written")
    ms = statistics.median(x for r in ranks for x in r["ms_per_step_windows"])
    out = {"world": CARDS, "backend": "nccl", "batch_triplets_per_rank":
           SSL_BATCH, "n_params": r0["first"]["n_params"],
           "losses": losses, "val": r0["first"]["val_history"]
           + r0["resumed"]["val_history"], "lr": r0["lrs"][0],
           "recipe_lr": lr, "replica_checksums": r0["replica_checksums"],
           "ms_per_step": ms,
           "ms_per_step_windows": [r["ms_per_step_windows"] for r in ranks],
           "one_card": one,
           "grad_bytes_all_reduced_per_step": r0["grad_bytes_per_step"],
           "cards": [r["card"] for r in ranks], "launch_seconds": seconds,
           "launches": sum(r["launches"] for r in ranks),
           "adamw_launches": [r["adamw_launches"] for r in ranks]}
    emit("mc_ssl", **out)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raise_plain(work: Path) -> dict:
    """Four ranks started as plain processes (no launcher watching them),
    rank 1 raising while its peers wait in a collective: each rank's exit
    code and the seconds from the raise to its exit (None: still running
    at the deadline, then killed)."""
    import os
    import re

    port = _free_port()
    procs, logs = [], []
    t_start = time.time()
    for r in range(CARDS):
        log = open(work / f"mc_raise_plain{r}.log", "w")
        env = {**os.environ, "PYTHONPATH": str(ROOT), "RANK": str(r),
               "LOCAL_RANK": str(r), "WORLD_SIZE": str(CARDS),
               "LOCAL_WORLD_SIZE": str(CARDS), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port),
               "VST_DIST_TIMEOUT": str(MC_EXIT_TIMEOUT_S)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MC_EXIT_CHILD, "raise"], env=env,
            stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
    ended = [None] * CARDS
    # start-up, then the bound
    deadline = t_start + 60 + MC_EXIT_TIMEOUT_S + MC_EXIT_SLACK_S
    while None in ended and time.time() < deadline:
        for r, p in enumerate(procs):
            if ended[r] is None and p.poll() is not None:
                ended[r] = time.time()
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in logs:
        log.close()
    text = "".join((work / f"mc_raise_plain{r}.log").read_text()
                   for r in range(CARDS))
    m = re.search(r"pid=1 raising_at=([0-9.]+)", text)
    if not m:
        raise AssertionError(f"rank 1 did not reach its raise:\n"
                             f"{text[-4000:]}")
    raised_at = float(m.group(1))
    return {"rcs": [p.returncode if e else None
                    for p, e in zip(procs, ended)],
            "seconds_after_raise": [None if e is None else e - raised_at
                                    for e in ended],
            "traceback": "ValueError: rank 1 fails on purpose" in text,
            "tail": text[-1500:]}


def phase_mc_rank_exits(work: Path) -> dict:
    """(f) Rank exits under NCCL: MC_CLEAN_LAUNCHES clean 4-rank launches
    (MC_CLEAN_AT_ONCE at a time) exit rc 0 with every rank's results, each
    rank on its own card, and a thread each rank starts puts a tensor on
    the resolved device on that card; a raising rank under ``torchrun``
    exits 1 and the
    launch (its peers stopped by the launcher) ends within
    MC_LAUNCHER_BOUND_S of the raise; started as plain processes with
    ``VST_DIST_TIMEOUT`` = MC_EXIT_TIMEOUT_S, the raising rank exits 1 and
    its peers exit non-zero within MC_EXIT_TIMEOUT_S + MC_EXIT_SLACK_S of
    the raise (the process group's timeout, not NCCL's ten minutes)."""
    import os
    import re
    from concurrent.futures import ThreadPoolExecutor

    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def launch(mode):
        t0 = time.time()
        p = subprocess.run(_launch_cmd("--no-python", sys.executable, "-c",
                                       MC_EXIT_CHILD, mode),
                           env=env, capture_output=True, text=True,
                           timeout=MC_LAUNCH_TIMEOUT)
        return p.returncode, p.stdout + p.stderr, t0, time.time()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(MC_CLEAN_AT_ONCE) as pool:
        clean = list(pool.map(launch, ["clean"] * MC_CLEAN_LAUNCHES))
    clean_s = time.perf_counter() - t0
    bad, thread_cards = [], []
    for i, (rc, text, _, _) in enumerate(clean):
        if rc != 0:
            bad.append(f"clean launch {i}: rc {rc}\n{text[-2000:]}")
            continue
        res = _rank_results(text, CARDS)
        try:
            check_cards([r["card"] for r in res], CARDS)
        except AssertionError as e:
            bad.append(f"clean launch {i}: {e}")
        if any(r["t"] != [10.0] * 4 for r in res) \
                or [r["u"] for r in res] != [[1.0] * 3] * 2 + [[5.0] * 3] * 2:
            bad.append(f"clean launch {i}: collectives {res}")
        if any(r["thread_cards"]["resolved"] != r["card"]["current_device"]
               for r in res):
            bad.append(f"clean launch {i}: a thread's tensor on the resolved "
                       f"device left the rank's card: {res}")
        thread_cards.append([r["thread_cards"] for r in res])
    rc, text, _, end = launch("raise")
    m = re.search(r"pid=1 raising_at=([0-9.]+)", text)
    launcher = {"rc": rc, "rank1_exitcode_1": "exitcode  : 1 " in text,
                "traceback": "ValueError: rank 1 fails on purpose" in text,
                "seconds_after_raise": (end - float(m.group(1))) if m
                else None, "bound_s": MC_LAUNCHER_BOUND_S}
    if rc == 0 or not launcher["rank1_exitcode_1"] \
            or not launcher["traceback"] \
            or launcher["seconds_after_raise"] is None \
            or launcher["seconds_after_raise"] > MC_LAUNCHER_BOUND_S:
        bad.append(f"raise under torchrun: {launcher}\n{text[-3000:]}")
    plain = _raise_plain(work)
    plain["bound_s"] = MC_EXIT_TIMEOUT_S + MC_EXIT_SLACK_S
    peers = [plain["seconds_after_raise"][r] for r in (0, 2, 3)]
    if plain["rcs"][1] != 1 or any(plain["rcs"][r] in (0, None)
                                   for r in (0, 2, 3)) \
            or any(s is None or s > plain["bound_s"] for s in peers) \
            or not plain["traceback"]:
        bad.append(f"raise without a launcher: {plain}")
    out = {"clean_launches": MC_CLEAN_LAUNCHES,
           "clean_rc0": sum(rc == 0 for rc, _, _, _ in clean),
           "clean_seconds": clean_s,
           "clean_launch_seconds": [e - s for _, _, s, e in clean],
           "thread_cards_first_launch": thread_cards[:1],
           "raise_under_torchrun": launcher,
           "raise_plain": {k: v for k, v in plain.items() if k != "tail"}}
    emit("mc_rank_exits", **out)
    if bad:
        raise AssertionError("\n".join(bad))
    return out


def phase_mc_dcn_smokes(work: Path) -> dict:
    """``parallel/dcn_smoke`` and ``parallel/dcn_trainer_smoke`` (the
    Linear ``BaseTrainer``, and ``DCN_MODE=tensor`` on {data: 2, model:
    2}) as they are, on 4 NCCL ranks: every rank prints the same
    numbers."""
    import os

    runs = {
        "dcn_smoke": ("video_spike_torch.parallel.dcn_smoke", {},
                      "global_loss"),
        "trainer_linear": ("video_spike_torch.parallel.dcn_trainer_smoke",
                           {"DCN_FIXTURE_DIR": str(work / "dcn_fix"),
                            "DCN_EID": DCN_EID,
                            "DCN_LOG_DIR": str(work / "dcn_logs")},
                           "result"),
        "trainer_tensor": ("video_spike_torch.parallel.dcn_trainer_smoke",
                           {"DCN_MODE": "tensor", "DCN_MODEL_AXIS": "2",
                            "DCN_LOG_DIR": str(work / "dcn_tensor_logs")},
                           "result")}
    out, bad = {}, []
    for name, (module, extra, key) in runs.items():
        t0 = time.perf_counter()
        p = subprocess.run(_launch_cmd("-m", module),
                           env={**os.environ, "PYTHONPATH": str(ROOT),
                                **extra}, cwd=ROOT, capture_output=True,
                           text=True, timeout=MC_LAUNCH_TIMEOUT)
        text = p.stdout + p.stderr
        if p.returncode != 0:
            bad.append(f"{name}: rc {p.returncode}\n{text[-3000:]}")
            continue
        if key == "result":
            got = _rank_results(text, CARDS)
        else:
            import re

            got = [re.search(rf"pid={r} global_loss=(\S+)", text).group(1)
                   for r in range(CARDS)]
        if any(g != got[0] for g in got):
            bad.append(f"{name}: ranks differ: {got}")
        out[name] = {"rank0": got[0], "seconds": time.perf_counter() - t0}
    emit("mc_dcn_smokes", **out)
    if bad:
        raise AssertionError("\n".join(bad))
    return out


def main_cards(cards: int) -> int:
    """``--cards 4``: every multi-rank path with one rank a card over NCCL
    (see the module's docstring). Needs `cards` visible cards; runs every
    phase, then fails when any did, printing no result."""
    import os
    import traceback

    import torch

    if cards != CARDS:
        print(f"chip_smoke.py: --cards takes {CARDS} (or leave it out for "
              f"the one-card run), not {cards}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py --cards: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    if count < cards:
        print(f"chip_smoke.py --cards {cards}: {count} card(s) visible; "
              f"this run needs {cards}, one rank a card over NCCL",
              file=sys.stderr)
        return 2
    os.environ.pop("VST_DIST_BACKEND", None)
    sys.path.insert(0, str(ROOT))
    t_run = time.perf_counter()
    phase_build()
    failed, done = {}, {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            done[name] = fn(*args)
        except Exception:                  # noqa: BLE001  (reported below)
            failed[name] = traceback.format_exc()[-8000:]
            emit(name, failed=True, error=failed[name])
        print(json.dumps({"phase_seconds": {name: time.perf_counter()
                                            - t0}}), flush=True)

    run("mc_cards", phase_mc_cards)
    run("mc_kernel", phase_mc_kernel)
    with tempfile.TemporaryDirectory(prefix="vst_cards_") as tmp:
        work = Path(tmp)
        run("mc_fixtures", phase_mc_fixtures, work)
        run("mc_one_card", phase_mc_one_card, work)
        run("mc_dp_linear", phase_mc_dp_linear, work,
            done.get("mc_one_card"))
        run("mc_model_axis_linear", phase_mc_model_axis_linear, work)
        run("mc_tensor_vtt", phase_mc_tensor_vtt, work)
        run("mc_split_serve", phase_split_serve_path, work, CARDS, "nccl",
            MC_SPLIT_CASES, ("stream_data", STREAM_EID, "mc_dp_logs"),
            "mc_split_serve")
        run("mc_ssl", phase_mc_ssl, work)
        run("mc_rank_exits", phase_mc_rank_exits, work)
        run("mc_dcn_smokes", phase_mc_dcn_smokes, work)
    print(json.dumps({"run_seconds": time.perf_counter() - t_run}),
          flush=True)
    if failed:
        print(f"chip_smoke.py --cards {cards}: failed phases "
              f"{sorted(failed)}", file=sys.stderr)
        return 1
    kernel = done["mc_kernel"]
    dp, tp = done["mc_dp_linear"], done["mc_model_axis_linear"]
    kernel["launches"] = (dp["launches"] + dp["resume_launches"]
                          + tp["launches"] + tp["resume_launches"])
    kernel["launches_by_path"] = {
        "dp4_nccl": dp["launches"], "dp4_nccl_resume": dp["resume_launches"],
        "dp4_nccl_b": dp["kernel_batches"][0],
        "model_axis_2x2_nccl": tp["launches"],
        "model_axis_2x2_nccl_resume": tp["resume_launches"],
        "tensor_vtt_nccl": done["mc_tensor_vtt"]["launches"],
        "split_serve_nccl": done["mc_split_serve"]["fused_readout_launches"],
        "ssl_nccl": done["mc_ssl"]["launches"]}
    if any(kernel["launches_by_path"][p] for p in (
            "tensor_vtt_nccl", "split_serve_nccl", "ssl_nccl")):
        raise AssertionError(f"the fused readout ran on the tensor-sharded "
                             f"VTT, split serving or SSL: "
                             f"{kernel['launches_by_path']}")
    for line in done["mc_cards"]["nvidia_smi"]:
        print(line, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on "
                                     "one card, or on four (--cards 4).")
    parser.add_argument("--cards", type=int, default=None,
                        help="run the multi-rank paths with one NCCL rank "
                        "a card on this many cards (4)")
    args = parser.parse_args(argv)
    if not (ROOT / "video_spike_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(video_spike_torch/ not found beside it)", file=sys.stderr)
        return 2
    if args.cards is not None:
        return main_cards(args.cards)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke run needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from video_spike_torch.ops import fused_adamw

    # this process's fused-AdamW launches in each path's own run (ranks in
    # child processes are not counted here): in place, and into new
    # tensors with the tables that built
    adamw_by_path, adamw_out_by_path = {}, {}

    def counted(path, phase, *args):
        fused_adamw.step_.launches = fused_adamw.step.launches = 0
        built = fused_adamw.step.tables_built
        out = phase(*args)
        adamw_by_path[path] = fused_adamw.step_.launches
        adamw_out_by_path[path] = [fused_adamw.step.launches,
                                   fused_adamw.step.tables_built - built]
        return out

    phase_build()
    kernel = phase_kernel()
    adamw = phase_fused_adamw()
    attention = phase_flash_attention()
    with tempfile.TemporaryDirectory(prefix="vst_smoke_") as tmp:
        work = Path(tmp)
        main_path = counted("linear", phase_main_path, work)
        step_time = phase_step_time(work)
        lean = counted("linear_lean", phase_linear_lean_path, work)
        accum = counted("linear_accum", phase_linear_accum_path, work)
        stream = counted("stream", phase_stream_main_path, work,
                         step_time["ms_per_step"])
        dist = counted("dp_parent", phase_dist_main_path, work,
                       step_time["ms_per_step"])
        phase_optim_card_vs_cpu()
        vtt = counted("vtt", phase_vtt_main_path, work)
        phase_vtt_card_vs_cpu()
        phase_vtt_step_time(work)
        tensor = counted("tensor_parent", phase_tensor_main_path, work)
        counted("rrr", phase_rrr_main_path, work)
        ssl_path, ssl = counted("ssl", phase_ssl_main_path, work)
        phase_ssl_card_vs_cpu()
        phase_ssl_step_time(work, ssl)
        del ssl
        _free_card()
        backbone, vmae = counted("vmae_pretrain", phase_probe_pretrain, work)
        probe = counted("probe", phase_probe_main_path, work, backbone)
        phase_probe_card_vs_cpu()
        phase_probe_step_time(work)
        serve = counted("serve", phase_serve_main_path, work)
        vtt_serve = counted("vtt_serve", phase_vtt_serve, work)
        split_serve = counted("split_serve", phase_split_serve_path, work)
        export = counted("export", phase_export, work)
        cebra, cebra_model = counted("cebra", phase_cebra_main_path, work)
        phase_cebra_card_vs_cpu(work, cebra_model)
        del cebra_model
        etl = counted("etl", phase_etl_main_path, work)
    # launches on the paths that run the kernel (every other path: 0)
    kernel["launches"] = (main_path["launches"] + lean["launches"]
                          + stream["launches"] + dist["launches"]
                          + dist["resume_launches"] + dist["nccl1_launches"]
                          + dist["dp4"]["launches"]
                          + tensor["linear"]["launches"]
                          + tensor["linear"]["resume_launches"]
                          + probe["launches"])
    kernel["launches_by_path"] = {
        "linear": main_path["launches"],
        "linear_resume": main_path["resume_steps"],
        "linear_lean": lean["launches"],
        "linear_lean_resume": lean["resume_launches"],
        "linear_accum": accum["launches"],
        "stream": stream["launches"],
        "stream_resume": stream["resume_launches"],
        "dp": dist["launches"], "dp_resume": dist["resume_launches"],
        "dp_nccl1": dist["nccl1_launches"],
        "dp4_b64": dist["dp4"]["launches"],
        "model_axis_linear": tensor["linear"]["launches"],
        "model_axis_linear_resume": tensor["linear"]["resume_launches"],
        "tensor_vtt": tensor["vtt"]["launches"],
        "tensor_serve": tensor["serve"]["launches"],
        "probe": probe["launches"], "probe_resume": probe["resume_launches"],
        "serve": serve["fused_readout_launches"]
        + vtt_serve["fused_readout_launches"],
        "split_serve": split_serve["fused_readout_launches"],
        "export": export["fused_readout_launches"],
        "cebra": cebra["fused_readout_launches"],
        "etl": etl["fused_readout_launches"]}
    if any(kernel["launches_by_path"][p] for p in (
            "linear_accum", "serve", "split_serve", "export", "cebra",
            "etl", "tensor_vtt", "tensor_serve")):
        raise AssertionError(f"the fused readout ran under accumulation or "
                             f"on an inference, embedding or ETL path: "
                             f"{kernel['launches_by_path']}")
    kernel["probe"]["launches"] = probe["launches"]
    kernel["b64"]["launches"] = dist["dp4"]["launches"]
    # a bare AdamW steps in place (ops/step.py): one launch a step on the
    # SSL, VTT and CEBRA paths; the VideoMAE pretraining step one launch a
    # step into new tensors, with one table; the fused readout's,
    # accumulation's and the frozen probe's optimizers, and the paths that
    # do not train, launch neither; the ranks' own counts are checked in
    # their phases (dp: 0, tensor-sharded VTT: one a step in place)
    adamw["launches"] = sum(adamw_by_path.values())
    adamw["launches_by_path"] = adamw_by_path
    adamw["out_launches_tables_by_path"] = adamw_out_by_path
    if adamw_out_by_path["vmae_pretrain"] != [PRETRAIN_STEPS, 1] or any(
            adamw_out_by_path[p][0] for p in adamw_out_by_path
            if p != "vmae_pretrain"):
        raise AssertionError(f"the out-of-place AdamW did not launch once "
                             f"a VideoMAE pretraining step with one table, "
                             f"or launched elsewhere: {adamw_out_by_path}")
    adamw["launches_by_rank"] = {
        "dp": dist["adamw_launches_per_rank"],
        **{f"tensor_vtt_{d}": tensor["vtt"][d]["adamw_launches_by_rank"]
           for d in ("f32", "bf16")}}
    stepped = ("ssl", "vtt", "cebra")
    if not all(adamw_by_path[p] > 0 for p in stepped) or any(
            adamw_by_path[p] for p in adamw_by_path
            if p not in stepped + ("dp_parent", "tensor_parent")):
        raise AssertionError(f"the fused AdamW did not run on every bare "
                             f"AdamW path, or ran on another: "
                             f"{adamw_by_path}")
    # [forward, backward] launches of the fused attention in each path's
    # own run, counted from 0 just before its entry point (rank 0 where
    # ranks share the card); the tensor-sharded VTT's f32 run takes the
    # torch expression, so 0
    tp_vtt = {d: tensor["vtt"][d]["attention_launches_by_rank"][0]
              for d in ("bf16", "f32")}
    by_path = {
        "vtt": vtt["attention_launches"],
        "tensor_vtt_bf16": tp_vtt["bf16"], "tensor_vtt_f32": tp_vtt["f32"],
        "tensor_serve": tensor["serve"]["attention_launches_by_rank"][0],
        "ssl": ssl_path["attention_launches"],
        "vmae_pretrain": vmae["attention_launches"],
        "probe": probe["attention_launches"],
        "vtt_serve": vtt_serve["attention_launches"],
        "split_serve_vtt": split_serve["cases"]["vtt_first512"][
            "attention_launches_by_rank"][0],
        "export_forward": export["vtt"]["attention_launches"][
            "export_forward"],
        "exported_program": export["vtt"]["attention_launches"]["program"]}
    attention["launches_by_path"] = by_path
    training = ("vtt", "tensor_vtt_bf16", "ssl", "vmae_pretrain")
    if not all(f > 0 for p, (f, _) in by_path.items()
               if p != "tensor_vtt_f32") \
            or not all(by_path[p][1] > 0 for p in training) \
            or by_path["tensor_vtt_f32"] != [0, 0]:
        raise AssertionError(f"the fused attention did not run on every "
                             f"bf16 path, or ran on f32: {by_path}")
    print(json.dumps({"kernels": [kernel, adamw, attention]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
