"""The port's hand-written CUDA kernels against their plain torch versions,
on a CUDA card.

A CUDA kernel has no CPU mode, so every test here carries the ``gpu`` marker
and skips on a host without a card. The file imports neither JAX nor the
JAX package (the plain versions are held against JAX in
``tests/test_torch_fused_readout.py``), so on a CUDA host without JAX it runs
apart from ``tests/conftest.py``, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tolerances: bitwise on exact-sum inputs (small integers times powers of two,
so every f32 rank-B sum is exact in any order); on random inputs >= 99.9%
bitwise and every element within 1 bf16 ulp plus the f32 error bound of
the rank-B sum (the kernel's summation order may differ from torch's
matmul, which can flip a rounding). The kernel takes any (M, B, N): the
cases cover a ragged M, one tile, the probe head, the gathered batch of 4
data-parallel ranks (B = 64), B = 1, N % 8 != 0 (with a W tile that ends
off a 16-byte boundary), a B whose dzc does not fit shared memory (B = 256,
walked in chunks) and unaligned views (the producer's own loads). The
host I/O's card paths (the pinned prefetch, the background fetch) are held
bitwise against the CPU path. Two
gloo ranks on one card run the data-parallel fused step (each gathers the
other's rank-B factors) and end with bitwise-equal kernels; two gloo
ranks run a column-split Dense (``parallel/tensor``) on CUDA tensors
against the unsplit layer.

The fused attention (``csrc/flash_attention_{fwd,bwd}.cu``) is held
against its plain version (``ops/attention.flash_attention_plain`` and
``..._backward``, the kernels' own arithmetic, on the card) at every (head
dim, sequence) the port's models use, through ``attention_bshd`` and
autograd on the packed qkv projection's strided views: the output within
2^-8 of the plain version's largest element (the sums run in another
order), each gradient within one bf16 ulp of its largest element (2^-7 of
it: a bf16 rounding may flip, and dQ's partial sums meet in atomic adds
in no fixed order). Against the f32 truth (the torch expression and its
gradients on the f32 upcast) the kernels' error is at most twice the torch
bf16 expression's.

The multi-tensor AdamW (``csrc/fused_adamw.cu``) is held bitwise against
the per-leaf loop on the card (``AdamW.update`` + ``apply_updates``, the
same f32 operations in the same order) over 3 steps: in place at the SSL
model's 255 leaf shapes (ContrastViTMAE over ViT-MAE-Base, 111,002,116
elements, with its 1- and 3-element leaves), and at odd sizes in views that
start 4 and 8 bytes off a 16-byte boundary; into new tensors at VideoMAE-
Base's 203 leaf shapes, at odd sizes (1, 3, 5 and 130 x 129 elements)
with unaligned views and at its most leaves (576), leaving what it was
handed, and a state kept from two steps before, as they were; and over 3
steps of the VideoMAE pretraining step (into new tensors), the
multi-session VTT trainer and CEBRA (strided gradients; in place), which
take it through ``ops/step.py``, on the gradients each step hands it, one
launch a step.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from video_spike_torch.models.vit_mae import ContrastViTMAE, SelfAttention
from video_spike_torch.ops import attention as tatt
from video_spike_torch.ops import fused_adamw
from video_spike_torch.ops import fused_readout as tfr
from video_spike_torch.ops.optim import (
    AdamW,
    apply_updates,
    cosine_onecycle_schedule,
)

torch.set_num_threads(1)

SEEDS = (0, 7, 2**32 - 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _exact_factors(rng, b, m, n):
    """xa, dzc whose f32 rank-b sums are exact in any order, ~2^-10 of W."""
    xa = rng.integers(-7, 8, (b, m)).astype(np.float32) * np.float32(2.0**-8)
    dzc = rng.integers(-7, 8, (b, n)).astype(np.float32) * np.float32(2.0**-12)
    return torch.from_numpy(xa), torch.from_numpy(dzc)


def _random_w(rng, m, n) -> torch.Tensor:
    return torch.from_numpy(
        rng.normal(size=(m, n)).astype(np.float32)).to(torch.bfloat16)


# (M, B, N): ragged M; one tile; the probe head; the gathered batch of 4
# data-parallel ranks; B = 1; N % 8 != 0; dzc walked in chunks of B
KERNEL_SHAPES = [(4133, 16, 256), (32, 16, 256), (1_204_224, 8, 256),
                 (20_000, 64, 256), (4133, 1, 256), (1000, 16, 100),
                 (2000, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,b,n", KERNEL_SHAPES + [(4133, 16, 100)])
def test_cuda_kernel_matches_plain(cuda_device, m, b, n):
    rng = np.random.default_rng(5)
    w = _random_w(rng, m, n)
    xa, dzc = _exact_factors(rng, b, m, n)
    for seed in SEEDS:
        ref = tfr._apply_scaled_outer_plain(w, xa, dzc, seed)
        w_d = w.to(cuda_device)
        before = tfr.apply_scaled_outer.launches
        out = tfr.apply_scaled_outer(w_d, xa.to(cuda_device),
                                     dzc.to(cuda_device), seed)
        torch.cuda.synchronize()
        assert out.data_ptr() == w_d.data_ptr()          # in place
        assert tfr.apply_scaled_outer.launches == before + 1
        np.testing.assert_array_equal(_bf16_bits(w_d), _bf16_bits(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("m,b,n", KERNEL_SHAPES + [(20_000, 16, 256)])
def test_cuda_kernel_random_inputs_within_one_ulp(cuda_device, m, b, n):
    rng = np.random.default_rng(6)
    w = _random_w(rng, m, n)
    xa = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32) * 1e-2)
    dzc = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32) * 1e-2)
    ref = tfr._apply_scaled_outer_plain(w, xa, dzc, 3).float()
    w_d = w.to(cuda_device)
    before = tfr.apply_scaled_outer.launches
    out = tfr.apply_scaled_outer(w_d, xa.to(cuda_device),
                                 dzc.to(cuda_device), 3)
    assert out.data_ptr() == w_d.data_ptr()              # in place
    assert tfr.apply_scaled_outer.launches == before + 1
    got = w_d.cpu().float()
    assert (got == ref).float().mean().item() >= 0.999
    big = torch.maximum(got.abs(), ref.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    err = b * 2.0**-24 * (xa.abs().T @ dzc.abs())
    assert bool(((got - ref).abs() <= ulp + err).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w_offset,xa_offset", [(1, 1), (4, 2), (0, 1)])
def test_cuda_kernel_unaligned_views(cuda_device, w_offset, xa_offset):
    """Contiguous views that start off a 16-byte boundary: W and xa are
    then loaded by the producer warp (no bulk copy) and W is stored a
    column at a time; bitwise against the plain version on exact sums."""
    rng = np.random.default_rng(7)
    m, b, n = 389, 16, 256
    w = _random_w(rng, m, n)
    xa, dzc = _exact_factors(rng, b, m, n)
    ref = tfr._apply_scaled_outer_plain(w, xa, dzc, 11)
    w_buf = torch.empty(m * n + w_offset, dtype=torch.bfloat16,
                        device=cuda_device)
    w_d = w_buf[w_offset:].view(m, n)
    w_d.copy_(w.to(cuda_device))
    xa_buf = torch.empty(b * m + xa_offset, device=cuda_device)
    xa_d = xa_buf[xa_offset:].view(b, m)
    xa_d.copy_(xa.to(cuda_device))
    before = tfr.apply_scaled_outer.launches
    tfr.apply_scaled_outer(w_d, xa_d, dzc.to(cuda_device), 11)
    torch.cuda.synchronize()
    assert tfr.apply_scaled_outer.launches == before + 1
    np.testing.assert_array_equal(_bf16_bits(w_d), _bf16_bits(ref))


@pytest.mark.gpu
def test_cuda_tensor_never_takes_the_plain_version(cuda_device):
    """A bf16 W on the card that the kernel cannot take raises; it is not
    handed to the plain version."""
    w = torch.zeros(64, 256, dtype=torch.bfloat16, device=cuda_device)
    xa = torch.zeros(4, 256, device=cuda_device)
    dzc = torch.zeros(4, 64, device=cuda_device)
    before = tfr.apply_scaled_outer.launches
    with pytest.raises(ValueError, match="contiguous"):
        tfr.apply_scaled_outer(w.t(), xa, dzc, 0)
    assert tfr.apply_scaled_outer.launches == before


# ---------------------------------------------------------------------------
# host I/O on the card: the pinned prefetch and the background fetch
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_pinned_prefetch_matches_the_cpu_path(cuda_device):
    """prefetch_to_device on the card (pinned ring of depth + 1 slots, copy
    stream, events) yields the CPU path's batches, in order, bitwise, with
    more batches than slots so every slot is refilled."""
    from video_spike_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [{"inputs": rng.integers(0, 255, (4, 120 * 32 * 32),
                                       dtype=np.uint8),
                "ap": rng.poisson(1.0, (4, 100, 7)).astype(np.float32),
                "eid": ["e"] * 4} for _ in range(9)]
    got = list(prefetch_to_device(iter(batches), cuda_device, depth=2))
    ref = list(prefetch_to_device(iter(batches), "cpu", depth=2))
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        assert g["inputs"].is_cuda and g["inputs"].dtype == torch.uint8
        assert g["eid"] == r["eid"]
        for k in ("inputs", "ap"):
            assert torch.equal(g[k].cpu(), r[k]), k


@pytest.mark.gpu
def test_background_fetch_sees_queued_kernels(cuda_device, tmp_path):
    """save_checkpoint_async of a tensor whose write is still queued on the
    compute stream saves the written values (the side stream waits on the
    event recorded at the call), and parallel_device_get equals .cpu()."""
    from video_spike_torch.train import checkpoint as ck

    x = torch.zeros(1 << 24, device=cuda_device)
    big = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(20):                   # keep the stream busy
        big = big @ big / 64.0
    x.add_(3.0)
    ck.save_checkpoint_async(tmp_path, "model_best",
                             {"params": {"x": x}, "epoch": 1})
    assert ck.wait_for_checkpoints() is True
    got = ck.load_checkpoint(tmp_path, "model_best")
    assert got["epoch"] == 1 and torch.all(got["params"]["x"] == 3.0)
    tree = {"a": torch.randn(300, 7, device=cuda_device).to(torch.bfloat16),
            "b": [torch.arange(5, device=cuda_device)], "n": 2}
    fetched = ck.parallel_device_get(tree)
    assert fetched["n"] == 2 and not fetched["a"].is_cuda
    assert torch.equal(fetched["a"], tree["a"].cpu())
    assert torch.equal(fetched["b"][0], tree["b"][0].cpu())


DP_FUSED = r"""
import sys
import torch
import torch.distributed as dist
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import LinearModel
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops import optim
from video_spike_torch.ops.poisson import poisson_nll_mean
from video_spike_torch.parallel import multihost as mh

assert setup_runtime("cuda")
r = mh.process_index()
g = torch.Generator().manual_seed(0)
model = LinearModel(input_dim=20_000, encoder_hidden=(256,), encoder_out=16,
                    decoder_hidden=(32,), output_dim=400, device="cuda")
model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
params = {k: (p.detach().to(torch.bfloat16) if p.numel() >= 1 << 16
              else p.detach()) for k, p in model.named_parameters()}
sched = optim.cosine_onecycle_schedule(16, 5e-5, 0.15, 10, 1e4)
tx = optim.Adafactor(sched)
step = fr.make_fused_linear_step(model, tx, sched, poisson_nll_mean,
                                 optim.apply_updates_sr,
                                 group=dist.group.WORLD)
opt = fr.init_fused_opt_state(params, tx)
for i in range(3):
    x = torch.randint(0, 255, (16, 20_000), generator=g, dtype=torch.uint8)
    ap = torch.poisson(torch.ones(16, 100, 4), generator=g)
    params, opt, _ = step(params, opt, x[8 * r:8 * r + 8].cuda(),
                          ap[8 * r:8 * r + 8].cuda(), 16, i)
w = params[fr.FIRST_KERNEL]
assert fr.apply_scaled_outer.launches == 3, fr.apply_scaled_outer.launches
sums = mh.replica_checksums({"w": w}, dist.group.WORLD)
assert len(set(sums)) == 1, sums
torch.save(w.cpu(), f"{sys.argv[1]}{r}.pt")
exit_rank()
"""


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_keep_w_bitwise_equal(cuda_device,
                                                         tmp_path):
    env = dict(os.environ, VST_DIST_BACKEND="gloo",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parent.parent),
                    os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "--no-python", sys.executable, "-c",
         DP_FUSED, str(tmp_path / "w")],
        env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]
    w0, w1 = (torch.load(tmp_path / f"w{r}.pt") for r in range(2))
    assert torch.equal(w0.view(torch.int16), w1.view(torch.int16))


TP_LAYERS = r"""
import sys
import torch
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.parallel.tensor import column_dense

assert setup_runtime("cuda")
mesh = make_mesh(n_data=1, n_model=2)
group, r = mesh.group("model"), mesh.coords["model"]
g = torch.Generator().manual_seed(0)
x, k, b, gy = (torch.randn(s, generator=g).cuda() for s in
               ((4, 64, 512), (512, 1024), (1024,), (4, 64, 1024)))
out = {}
for split in (False, True):
    xi, bi = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ki = (k[:, 512 * r:512 * r + 512] if split else k).clone()
    ki.requires_grad_(True)
    y = column_dense(xi, ki, bi, torch.float32, group if split else None)
    (y * gy).sum().backward()
    out[split] = (y.detach(), xi.grad, ki.grad, bi.grad)
y1, dx1, dk1, db1 = out[False]
y2, dx2, dk2, db2 = out[True]
rel = lambda a, w: float((a - w).abs().max() / w.abs().max())
errs = [rel(y2, y1), rel(dx2, dx1), rel(dk2, dk1[:, 512 * r:512 * r + 512]),
        rel(db2, db1)]
assert y2.is_cuda and dx2.is_cuda
torch.save(errs, f"{sys.argv[1]}{r}.pt")
exit_rank()
"""


@pytest.mark.gpu
def test_two_gloo_ranks_column_split_dense_on_the_card(cuda_device,
                                                       tmp_path):
    """``copy_to_model`` / ``gather_last`` on CUDA tensors over gloo: a
    column-split Dense (the VTT's MLP width) against the unsplit layer on
    the same card, forward and gradients, rtol 1e-5 (TF32 off; cuBLAS may
    block the column halves differently from the whole)."""
    env = dict(os.environ, VST_DIST_BACKEND="gloo",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parent.parent),
                    os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "--no-python", sys.executable, "-c",
         TP_LAYERS, str(tmp_path / "e")],
        env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]
    for r in range(2):
        errs = torch.load(tmp_path / f"e{r}.pt")
        assert max(errs) <= 1e-5, errs


# ---------------------------------------------------------------------------
# the multi-tensor AdamW
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent


def _ssl_leaf_shapes() -> dict:
    """ContrastViTMAE's leaves at ``configs/model/vit_mae/vit_mae.yaml``'s
    widths, read on the meta device."""
    cfg = yaml.safe_load((REPO / "configs/model/vit_mae/vit_mae.yaml")
                         .read_text())
    model = ContrastViTMAE.from_config(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _leaf(n_shape, offset, device, fill) -> torch.Tensor:
    """A contiguous f32 leaf of shape ``n_shape`` holding ``fill``, as a
    view ``offset`` floats into a larger buffer."""
    n = int(np.prod(n_shape, dtype=np.int64))
    buf = torch.empty(n + offset, device=device)
    t = buf[offset:].view(n_shape)
    t.copy_(fill)
    return t


def _bits32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def _videomae_leaf_shapes() -> dict:
    """VideoMAEForPreTraining's leaves at ``configs/model/videomae/
    videomae.yaml``'s widths (VideoMAE-Base: 203 leaves, 94,222,080
    elements), read on the meta device."""
    from video_spike_torch.models.videomae import VideoMAEForPreTraining

    cfg = yaml.safe_load((REPO / "configs/model/videomae/videomae.yaml")
                         .read_text())
    cfg = {k: v for k, v in cfg.items() if k not in ("encoder", "decoder")}
    model = VideoMAEForPreTraining.from_config(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


ODD_SHAPES = {"one": (1,), "three": (3,), "five": (5,), "seven": (7,),
              "ragged": (1023,), "wide": (4097,), "big": (65_537,),
              "matrix": (129, 33), "scalar": ()}


@pytest.mark.gpu
@pytest.mark.parametrize("case,offset,g_offset", [
    ("ssl", 0, 0), ("odd", 0, 0), ("odd", 1, 1), ("odd", 2, 2),
    ("odd", 0, 1), ("ssl", 0, 3)])
def test_fused_adamw_matches_the_per_leaf_loop(cuda_device, case, offset,
                                               g_offset):
    """p, mu and nu bitwise the per-leaf loop's after each of 3 steps, on
    the card; ``offset`` floats shift p, mu and nu of the kernel's side off
    a 16-byte boundary (4 and 8 bytes), ``g_offset`` its gradients alone
    (as a data-parallel reduction's views into one flat buffer are)."""
    shapes = _ssl_leaf_shapes() if case == "ssl" else ODD_SHAPES
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    sched = cosine_onecycle_schedule(100, 5e-5, 0.15, 10, 1e4)
    ref_tx, tx = (AdamW(sched, weight_decay=0.01, eps=1e-8)
                  for _ in range(2))
    start = {k: 0.02 * torch.randn(s, generator=gen, device=cuda_device)
             for k, s in shapes.items()}
    ref_p = {k: v.clone() for k, v in start.items()}
    ref_state = ref_tx.init(ref_p)
    p = {k: _leaf(s, offset, cuda_device, start[k])
         for k, s in shapes.items()}
    state = {"count": 0,
             "mu": {k: _leaf(s, offset, cuda_device, 0.0)
                    for k, s in shapes.items()},
             "nu": {k: _leaf(s, offset, cuda_device, 0.0)
                    for k, s in shapes.items()}}
    for step in range(3):
        # gradients of several scales, one leaf of zeros (the fixed
        # temperature's)
        g = {k: torch.randn(s, generator=gen, device=cuda_device)
             * 10.0 ** -(2 + i % 4) * (i != 0)
             for i, (k, s) in enumerate(shapes.items())}
        upd, ref_state = ref_tx.update(g, ref_state, ref_p)
        ref_p = apply_updates(ref_p, upd)
        g_k = {k: _leaf(s, g_offset, cuda_device, g[k])
               for k, s in shapes.items()}
        before = fused_adamw.step_.launches
        tx.step_(p, g_k, state)
        torch.cuda.synchronize()
        assert fused_adamw.step_.launches == before + 1
        assert state["count"] == ref_state["count"] == step + 1
        for k in shapes:
            for what, got, want in (("p", p[k], ref_p[k]),
                                    ("mu", state["mu"][k],
                                     ref_state["mu"][k]),
                                    ("nu", state["nu"][k],
                                     ref_state["nu"][k])):
                assert torch.equal(_bits32(got), _bits32(want)), (
                    step, k, what)


@pytest.mark.gpu
def test_fused_adamw_launches_once_a_step_and_keeps_its_table(cuda_device):
    """One launch a step whatever the number of leaves; the device table is
    built once and again only after a leaf moved."""
    shapes = _ssl_leaf_shapes()
    p = {k: torch.zeros(s, device=cuda_device) for k, s in shapes.items()}
    tx = AdamW(5e-5, weight_decay=0.01)
    state = tx.init(p)
    g = {k: torch.ones_like(v) for k, v in p.items()}
    before = fused_adamw.step_.launches
    tables = []
    for step in range(4):
        tx.step_(p, g, state)
        assert fused_adamw.step_.launches == before + step + 1
        tables.append(tx._fused_tables)
    assert all(t is tables[0] for t in tables)
    assert tables[0].claims == 4 * (tables[0].n_chunks + tables[0].grid)
    segs, _ = fused_adamw.segments(
        [int(np.prod(s)) for s in shapes.values()], tables[0].n_chunks)
    assert len(shapes) == 255 and int(segs[:, 2].sum()) == 111_002_116
    state["mu"]["temperature"] = state["mu"]["temperature"].clone()
    tx.step_(p, g, state)
    assert tx._fused_tables is not tables[0]
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_fused_adamw_cuda_leaves_never_take_the_plain_version(cuda_device,
                                                              monkeypatch):
    """What the kernel does not take raises: a bf16 leaf, a non-contiguous
    one, leaves on two devices, ``mu_dtype``; none of it reaches the
    per-leaf loop, which only the CPU's leaves take."""
    def no_loop(self, grads, state, params):
        raise AssertionError("a CUDA leaf took the plain version")

    def case(dtype=torch.float32, transpose=False, grad_on_cpu=False,
             mu_dtype=None, first_on_cpu=False):
        tx = AdamW(1e-3, mu_dtype=mu_dtype)
        p = {"a": torch.zeros(3, device="cpu" if first_on_cpu
                              else cuda_device),
             "b": torch.zeros(8, 4, dtype=dtype, device=cuda_device)}
        if transpose:
            p["b"] = p["b"].t()
        state = tx.init(p)
        g = {k: torch.ones_like(v) for k, v in p.items()}
        if grad_on_cpu:
            g["b"] = g["b"].cpu()
        tx.step_(p, g, state)

    monkeypatch.setattr(AdamW, "update", no_loop)
    before = fused_adamw.step_.launches
    for kw, match in ((dict(dtype=torch.bfloat16), "f32 only"),
                      (dict(transpose=True), "not contiguous"),
                      (dict(grad_on_cpu=True), "on cpu"),
                      (dict(mu_dtype=torch.bfloat16), "mu_dtype"),
                      (dict(first_on_cpu=True), "mixed devices")):
        with pytest.raises(ValueError, match=match):
            case(**kw)
    assert fused_adamw.step_.launches == before
    case()
    torch.cuda.synchronize()
    assert fused_adamw.step_.launches == before + 1


OUT_SHAPES = {"one": (1,), "three": (3,), "five": (5,),
              "matrix": (130, 129)}


@pytest.mark.gpu
@pytest.mark.parametrize("case,offset,g_offset", [
    ("odd", 0, 1), ("odd", 1, 3), ("videomae", 0, 0)])
def test_fused_adamw_into_new_tensors_matches_the_per_leaf_loop(
        cuda_device, case, offset, g_offset):
    """``AdamW.step``: p', mu' and nu' bitwise the per-leaf loop's after
    each of 3 steps, one launch a step; the p, mu, nu and count it was
    handed bit-identical after the step. ``offset`` floats shift the first
    step's p, mu and nu off a 16-byte boundary, ``g_offset`` the gradients
    of every step (an unaligned view)."""
    shapes = _videomae_leaf_shapes() if case == "videomae" else OUT_SHAPES
    if case == "videomae":
        assert len(shapes) == 203 and sum(
            int(np.prod(s)) for s in shapes.values()) == 94_222_080
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    sched = cosine_onecycle_schedule(100, 5e-5, 0.15, 10, 1e4)
    ref_tx, tx = (AdamW(sched, weight_decay=0.01, eps=1e-8)
                  for _ in range(2))
    start = {k: 0.02 * torch.randn(s, generator=gen, device=cuda_device)
             for k, s in shapes.items()}
    ref_p = {k: v.clone() for k, v in start.items()}
    ref_state = ref_tx.init(ref_p)
    p = {k: _leaf(s, offset, cuda_device, start[k])
         for k, s in shapes.items()}
    state = {"count": 0,
             "mu": {k: _leaf(s, offset, cuda_device, 0.0)
                    for k, s in shapes.items()},
             "nu": {k: _leaf(s, offset, cuda_device, 0.0)
                    for k, s in shapes.items()}}
    for step in range(3):
        g = {k: torch.randn(s, generator=gen, device=cuda_device)
             * 10.0 ** -(2 + i % 4) * (i != 0)
             for i, (k, s) in enumerate(shapes.items())}
        upd, ref_state = ref_tx.update(g, ref_state, ref_p)
        ref_p = apply_updates(ref_p, upd)
        g_k = {k: _leaf(s, g_offset, cuda_device, g[k])
               for k, s in shapes.items()}
        handed = {f"{what}:{k}": t.clone() for what, d in (
            ("p", p), ("mu", state["mu"]), ("nu", state["nu"]))
            for k, t in d.items()}
        launches = fused_adamw.step.launches, fused_adamw.step_.launches
        new_p, new_state = tx.step(p, g_k, state)
        torch.cuda.synchronize()
        assert (fused_adamw.step.launches, fused_adamw.step_.launches) == (
            launches[0] + 1, launches[1])
        assert state["count"] == step
        assert new_state["count"] == ref_state["count"] == step + 1
        for what, d in (("p", p), ("mu", state["mu"]), ("nu", state["nu"])):
            for k, t in d.items():
                assert torch.equal(_bits32(t), _bits32(
                    handed[f"{what}:{k}"])), (step, k, what)
        p, state = new_p, new_state
        for k in shapes:
            for what, got, want in (("p", p[k], ref_p[k]),
                                    ("mu", state["mu"][k],
                                     ref_state["mu"][k]),
                                    ("nu", state["nu"][k],
                                     ref_state["nu"][k])):
                assert got.shape == want.shape, (step, k, what)
                assert torch.equal(_bits32(got), _bits32(want)), (
                    step, k, what)


@pytest.mark.gpu
def test_fused_adamw_into_new_tensors_keeps_older_states(cuda_device):
    """A state the caller keeps from two steps back still holds its values
    after two more steps: ``step`` never writes storage it handed out."""
    shapes = _videomae_leaf_shapes()
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    tx = AdamW(5e-5, weight_decay=0.01)
    p = {k: 0.02 * torch.randn(s, generator=gen, device=cuda_device)
         for k, s in shapes.items()}
    state = tx.init(p)
    history = []
    for step in range(6):
        g = {k: torch.randn(s, generator=gen, device=cuda_device) * 1e-3
             for k, s in shapes.items()}
        p, state = tx.step(p, g, state)
        torch.cuda.synchronize()
        history.append((p, state, {
            f"{what}:{k}": t.clone() for what, d in (
                ("p", p), ("mu", state["mu"]), ("nu", state["nu"]))
            for k, t in d.items()}))
        if len(history) > 3:
            history.pop(0)
        if len(history) == 3:       # the state of two steps back
            old_p, old_state, kept = history[0]
            assert old_state["count"] == step - 1
            for what, d in (("p", old_p), ("mu", old_state["mu"]),
                            ("nu", old_state["nu"])):
                for k, t in d.items():
                    assert torch.equal(_bits32(t), _bits32(
                        kept[f"{what}:{k}"])), (step, k, what)
    assert state["count"] == 6


def _videomae_steps(device):
    """``cli/pretrain_videomae.py``'s ``build`` and step at head dim 32 (the
    decoder's 64) on 2 clips of 4 frames: ``(tx, state(), step(k))``,
    ``state()`` the params and optimizer state the last step returned."""
    from video_spike_torch.cli import pretrain_videomae as cli

    cfg = dict(image_size=64, patch_size=16, num_channels=3, num_frames=4,
               tubelet_size=2, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               mask_type="tube", norm_pix_loss=True)
    model, tx, params, state = cli.build(cfg, {"lr": 1e-3, "wd": 0.01}, 0,
                                         device)
    step_fn = cli.make_step(model, tx, 4, 64, 0.75)
    gen = torch.Generator(device=device)
    rng = np.random.default_rng(5)
    video = torch.from_numpy(rng.integers(0, 256, (2, 4, 1, 48, 48),
                                          dtype=np.uint8)).to(device)

    cur = [params, state]

    def step(k):
        cur[:2] = cli.train_step(step_fn, *cur, video, gen, 0, k)[:2]

    return tx, lambda: tuple(cur), step


def _vtt_steps(device, tmp_path):
    """The multi-session trainer's staged step on two synthetic sessions,
    the VTT at head dim 32: ``(tx, state(), step(k))``, ``state()`` its
    live params and optimizer state."""
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.data.synthetic import make_synthetic_session
    from video_spike_torch.models.vtt import VideoTemporalTransformer
    from video_spike_torch.train.multisession import MultiSessionTrainer

    eids = ["sessa0000", "sessb0000"]
    for i, eid in enumerate(eids):
        make_synthetic_session(tmp_path / "data", eid=eid, n_trials=12,
                               n_neurons=6 + 3 * i, seed=20 + i, height=32,
                               width=32)
    tr = MultiSessionTrainer(model=None, config=DictConfig({
        "training": {"num_epochs": 1, "train_batch_size": 4,
                     "test_batch_size": 4},
        "optimizer": {"lr": 1e-3, "wd": 0.01, "eps": 1e-8,
                      "warmup_pct": 0.15, "div_factor": 10}}),
        eids=eids, data_dir=str(tmp_path / "data"),
        log_dir=str(tmp_path / "logs"), device=device)
    tr.model = VideoTemporalTransformer.from_config(dict(
        t_frames=120, t_bins=100, patch_size=8, hidden_size=64,
        frame_depth=1, temporal_depth=1, num_attention_heads=2,
        intermediate_size=128, frame_stride=2, n_sessions=2,
        max_neurons=tr.max_neurons))
    assert tr._stage_device_dataset()

    def step(k):
        tr.staged_step(np.random.default_rng(k).permutation(tr._n_train)[:4],
                       4)

    return tr.tx, lambda: (tr.params, tr.opt_state), step


def _cebra_steps(device):
    """``CEBRA.step`` on a seeded series: ``(tx, state(), step(k))``,
    ``state()`` its live params and optimizer state; its convolution
    kernels' gradients are strided views."""
    from video_spike_torch.models.cebra import CEBRA

    c = CEBRA(batch_size=64, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    series = torch.from_numpy(np.random.default_rng(9).normal(
        size=(400, 12)).astype(np.float32)).to(device)
    params = c.init_params(series.shape[1], gen)
    state = c.tx.init(params)

    def step(k):
        c.step(params, state, series, *c.sample(gen, len(series) - 21))

    return c.tx, lambda: (params, state), step


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["videomae", "vtt", "cebra"])
def test_trainer_steps_equal_the_per_leaf_loop(cuda_device, tmp_path,
                                               monkeypatch, kind):
    """3 steps of the VideoMAE pretraining step, of the multi-session VTT
    trainer and of CEBRA leave parameters and moments bitwise where the
    per-leaf loop (``AdamW.update`` + ``apply_updates``) takes the same
    gradients. The VTT and CEBRA take ``ops/step.py``'s in-place route (one
    ``step_`` launch a step); the VideoMAE step, which leaves what it is
    handed as it was, steps into new tensors (one ``step`` launch a step).
    The gradients are the ones the step hands ``ops/step.update``: the
    attention's backward adds dQ in no fixed order, so two backwards may
    differ."""
    from video_spike_torch.ops import step as ops_step

    handed = []
    real = ops_step.update

    def keep(tx, params, grads, *a, **kw):
        handed.append({k: g.clone() for k, g in grads.items()})
        return real(tx, params, grads, *a, **kw)

    monkeypatch.setattr(ops_step, "update", keep)
    # launches a step of (step, step_)
    launches = (1, 0) if kind == "videomae" else (0, 1)
    tx, live, step = {
        "videomae": lambda: _videomae_steps(cuda_device),
        "vtt": lambda: _vtt_steps(cuda_device, tmp_path),
        "cebra": lambda: _cebra_steps(cuda_device)}[kind]()
    ref_tx = copy.copy(tx)
    ref_p = {k: v.clone() for k, v in live()[0].items()}
    ref_state = ref_tx.init(ref_p)
    for k in range(3):
        before = fused_adamw.step.launches, fused_adamw.step_.launches
        step(k)
        torch.cuda.synchronize()
        assert (fused_adamw.step.launches - before[0],
                fused_adamw.step_.launches - before[1]) == launches
        params, state = live()
        upd, ref_state = ref_tx.update(handed[-1], ref_state, ref_p)
        ref_p = apply_updates(ref_p, upd)
        assert state["count"] == ref_state["count"] == k + 1
        for name in ref_p:
            for what, got, want in (
                    ("p", params[name], ref_p[name]),
                    ("mu", state["mu"][name], ref_state["mu"][name]),
                    ("nu", state["nu"][name], ref_state["nu"][name])):
                assert torch.equal(_bits32(got), _bits32(want)), (
                    k, name, what)


@pytest.mark.gpu
def test_videomae_step_launches_once_a_step_and_builds_one_table(
        cuda_device):
    """20 steps of the VideoMAE pretraining step launch the out-of-place
    AdamW once a step and build its table once (its pointers, new every
    step, travel in the kernel's parameters): no later step copies a table
    to the card or waits for it."""
    _, _, step = _videomae_steps(cuda_device)
    launches, built = fused_adamw.step.launches, fused_adamw.step.tables_built
    for k in range(20):
        step(k)
    torch.cuda.synchronize()
    assert fused_adamw.step.launches - launches == 20
    assert fused_adamw.step.tables_built - built == 1


@pytest.mark.gpu
def test_fused_adamw_into_new_tensors_takes_576_leaves_and_no_more(
        cuda_device):
    """Out of place the kernel takes ``MAX_OUT_LEAVES`` (576) leaves, the
    last one's seven pointers at the end of its parameters, bitwise the
    per-leaf loop's; one more leaf raises before any launch."""
    assert fused_adamw.MAX_OUT_LEAVES == 576
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    shapes = {f"w{i:03d}": ((i % 7) + 1, 4 + i % 5) for i in range(576)}
    tx, ref_tx = (AdamW(1e-3, weight_decay=0.01) for _ in range(2))
    p = {k: torch.randn(s, generator=gen, device=cuda_device)
         for k, s in shapes.items()}
    g = {k: torch.randn(s, generator=gen, device=cuda_device)
         for k, s in shapes.items()}
    upd, ref_state = ref_tx.update(g, ref_tx.init(p), p)
    ref_p = apply_updates(p, upd)
    new_p, state = tx.step(p, g, tx.init(p))
    torch.cuda.synchronize()
    for k in shapes:
        for got, want in ((new_p[k], ref_p[k]),
                          (state["mu"][k], ref_state["mu"][k]),
                          (state["nu"][k], ref_state["nu"][k])):
            assert torch.equal(_bits32(got), _bits32(want)), k
    launches = fused_adamw.step.launches
    extra = {**p, "w576": torch.zeros(3, device=cuda_device)}
    with pytest.raises(ValueError, match="at most 576"):
        tx.step(extra, {k: torch.ones_like(v) for k, v in extra.items()},
                tx.init(extra))
    assert fused_adamw.step.launches == launches


# ---------------------------------------------------------------------------
# the fused attention
# ---------------------------------------------------------------------------

# (B, S, H, D) as the port's models call it: VideoMAE's encoder (160
# visible tokens) and decoder (1,568), the probe's backbone (1,568, forward
# only there), ViT-MAE's encoder (21) and decoder (82, head dim 32) in the
# SSL recipe, the VTT's frame (64 patches) and temporal (60 frames) blocks
# at head dim 256; then ragged and tiny ones
FLASH_SHAPES = [(4, 160, 12, 64), (2, 1568, 6, 64), (2, 1568, 12, 64),
                (16, 21, 12, 64), (16, 82, 16, 32), (8, 64, 2, 256),
                (8, 60, 2, 256), (3, 130, 2, 256), (2, 5, 1, 32),
                (1, 3, 1, 64)]


def _flash_case(shape, device, seed):
    b, s, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=device).to(
        torch.bfloat16).requires_grad_(True)
    dout = torch.randn((b, s, h, d), generator=g, device=device).to(
        torch.bfloat16).float()
    return qkv, dout


def _flash_run(fn, qkv, dout):
    """fn(q, k, v) on the packed views, and the gradients of q, k, v."""
    qkv.grad = None
    out = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    out.backward(dout)
    return out.detach(), *qkv.grad.unbind(2)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_matches_its_plain_version(cuda_device, shape):
    qkv, dout = _flash_case(shape, cuda_device, 11)
    q, k, v = qkv.detach().unbind(2)
    assert all(tatt._kernel_view(x) is x for x in (q, k, v))   # in place
    before = (tatt.attention_bshd.launches,
              tatt.attention_bshd.backward_launches)
    got = _flash_run(tatt.attention_bshd, qkv, dout)
    torch.cuda.synchronize()
    assert (tatt.attention_bshd.launches,
            tatt.attention_bshd.backward_launches) == (before[0] + 1,
                                                       before[1] + 1)
    out, lse = tatt.flash_attention_plain(q, k, v)
    ref = (out, *tatt.flash_attention_plain_backward(q, k, v, out, lse,
                                                     dout))
    assert got[0].dtype == torch.float32
    assert all(x.dtype == torch.bfloat16 for x in got[1:])
    assert _rel(got[0], ref[0]) <= 2.0**-8, _rel(got[0], ref[0])
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert _rel(a, b) <= 2.0**-7, (name, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 160, 12, 64), (2, 1568, 6, 64),
                                   (16, 82, 16, 32), (8, 64, 2, 256)])
def test_flash_attention_error_within_twice_the_expression(cuda_device,
                                                           shape):
    qkv, dout = _flash_case(shape, cuda_device, 12)
    truth = _flash_run(tatt.attention_torch,
                       qkv.detach().float().requires_grad_(True), dout)
    expr = _flash_run(tatt.attention_torch, qkv, dout)
    got = _flash_run(tatt.attention_bshd, qkv, dout)
    for name, a, e, t in zip(("out", "dq", "dk", "dv"), got, expr, truth):
        assert _rel(a, t) <= 2 * _rel(e, t), (name, _rel(a, t), _rel(e, t))


@pytest.mark.gpu
def test_flash_attention_reads_strided_views_in_place(cuda_device):
    """The packed qkv views are read through their strides: the same
    output, bitwise, as from contiguous copies (the forward's sums run in
    a fixed order), and dk, dv bitwise (dq's atomic adds meet in no fixed
    order); an unaligned view is copied first and agrees too."""
    qkv, dout = _flash_case((4, 160, 12, 64), cuda_device, 13)
    views = _flash_run(tatt.attention_bshd, qkv, dout)
    copies = _flash_run(lambda q, k, v: tatt.attention_bshd(
        q.contiguous(), k.contiguous(), v.contiguous()), qkv, dout)
    assert torch.equal(views[0], copies[0])
    assert torch.equal(views[2], copies[2]) and torch.equal(views[3],
                                                            copies[3])
    assert _rel(views[1], copies[1]) <= 2.0**-7
    flat = torch.zeros(qkv.numel() + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    odd = flat[1:].view(qkv.shape)          # 2 bytes off 16-byte alignment
    odd.copy_(qkv.detach())
    q, k, v = odd.unbind(2)
    assert tatt._kernel_view(q) is not q
    out = tatt.attention_bshd(q, k, v)
    assert torch.equal(out, views[0])


@pytest.mark.gpu
def test_cuda_bf16_never_takes_the_torch_expression(cuda_device,
                                                    monkeypatch):
    """A SelfAttention on CUDA bf16 goes through the kernels, forward and
    backward (the counters), and never through the torch expression;
    f32 CUDA inputs take the expression and launch nothing; an
    uninstantiated head dim raises."""
    expression = tatt.attention_torch
    calls = []

    def spy(*args):
        calls.append(args[0].dtype)
        return expression(*args)

    monkeypatch.setattr(tatt, "attention_torch", spy)
    gen = torch.Generator().manual_seed(0)
    layer = SelfAttention(768, 12)
    layer.reset_parameters(gen)
    layer.to(cuda_device)
    x = torch.randn((4, 160, 768), device=cuda_device, requires_grad=True)
    before = (tatt.attention_bshd.launches,
              tatt.attention_bshd.backward_launches)
    layer(x).float().sum().backward()
    torch.cuda.synchronize()
    assert calls == []
    assert (tatt.attention_bshd.launches,
            tatt.attention_bshd.backward_launches) == (before[0] + 1,
                                                       before[1] + 1)
    q = torch.randn((2, 21, 12, 64), device=cuda_device)
    out = tatt.attention_bshd(q, q, q)
    assert calls == [torch.float32] and out.dtype == torch.float32
    assert tatt.attention_bshd.launches == before[0] + 1
    q = torch.randn((2, 21, 4, 48), device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        tatt.attention_bshd(q, q, q)
    with pytest.raises(ValueError, match="bf16 on one card"):
        tatt.attention_bshd(q[..., :32], q[..., :32].float(), q[..., :32])
    assert len(calls) == 1


@pytest.mark.gpu
def test_attention_spans_see_the_kernels(cuda_device):
    """Under a profiler, the ``vs.attention`` ranges (forward on this
    thread, backward on autograd's) hold the launches of the forward and
    backward kernels, and no softmax of the torch expression."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(0)
    layer = SelfAttention(384, 6)
    layer.reset_parameters(gen)
    layer.to(cuda_device)
    x = torch.randn((2, 1568, 384), device=cuda_device, requires_grad=True)
    layer(x).float().sum().backward()                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        layer(x).float().sum().backward()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ranges, ops = {}, {}
    for ev in events:
        if ev.device_type() == cuda:
            continue
        if ev.name() == "vs.attention":
            ranges.setdefault(ev.start_thread_id(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif ev.linked_correlation_id() == 0 and ev.correlation_id():
            ops[ev.correlation_id()] = (ev.start_thread_id(), ev.start_ns())
    assert len(ranges) == 2, ranges     # the forward's and autograd's thread
    inside = set()
    for ev in events:
        if ev.device_type() != cuda or not ev.linked_correlation_id():
            continue
        thread, t0 = ops.get(ev.linked_correlation_id(), (None, 0))
        if any(a <= t0 <= b for a, b in ranges.get(thread, ())):
            inside.add(ev.name())
    for kernel in ("fwd_kernel<64>", "bwd_kernel<64>", "delta_kernel<64>",
                   "dq_kernel"):
        assert any(kernel in name for name in inside), (kernel, inside)
    assert not any("oftmax" in name for name in inside), inside


@pytest.mark.gpu
def test_the_kernel_op_passes_its_registration_checks(cuda_device):
    """``vst::flash_attention`` and its backward op agree with their fake
    implementations and autograd registration (``torch.library.opcheck``)
    on the packed qkv views."""
    qkv, _ = _flash_case((2, 82, 4, 64), cuda_device, 14)
    q, k, v = qkv.unbind(2)
    torch.library.opcheck(tatt.flash_attention, (q, k, v))


@pytest.mark.gpu
def test_an_exported_attention_launches_the_kernel(cuda_device, tmp_path):
    """``torch.export`` of a bf16 SelfAttention on the card, saved and
    loaded back, holds ``vst::flash_attention`` and launches the kernel
    once a call, at any batch, within a bf16 ulp of the eager layer's
    largest output (the program may order the projections' sums
    otherwise)."""
    gen = torch.Generator().manual_seed(0)
    layer = SelfAttention(512, 2)
    layer.reset_parameters(gen)
    layer.to(cuda_device).eval()
    x = torch.randn((4, 60, 512), device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        program = torch.export.export(
            layer, (x,), dynamic_shapes=({0: torch.export.Dim("batch")},))
    torch.export.save(program, str(tmp_path / "layer.pt2"))
    loaded = torch.export.load(str(tmp_path / "layer.pt2"))
    assert any(str(n.target) == "vst.flash_attention.default"
               for n in loaded.graph.nodes)
    module = loaded.module()
    for rows in (3, 4):
        before = tatt.attention_bshd.launches
        with torch.inference_mode():
            got = module(x[:rows])
            want = layer(x[:rows])
        torch.cuda.synchronize()
        assert tatt.attention_bshd.launches == before + 2
        assert got.shape == want.shape and _rel(got, want) <= 2.0**-7
