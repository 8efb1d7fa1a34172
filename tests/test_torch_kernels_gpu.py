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
matmul, which can flip a rounding). The host I/O's card paths (the pinned
prefetch, the background fetch) are held bitwise against the CPU path. Two
gloo ranks on one card run the data-parallel fused step (each gathers the
other's rank-B factors) and end with bitwise-equal kernels; two gloo
ranks run a column-split Dense (``parallel/tensor``) on CUDA tensors
against the unsplit layer.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_spike_torch.ops import fused_readout as tfr

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


@pytest.mark.gpu
@pytest.mark.parametrize("m,b", [(4133, 16), (32, 16),   # ragged; one tile
                                 (1_204_224, 8)])        # the probe head
def test_cuda_kernel_matches_plain(cuda_device, m, b):
    rng = np.random.default_rng(5)
    n = 256
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
@pytest.mark.parametrize("m,b", [(20_000, 16),       # the Linear path's B
                                 (1_204_224, 8)])    # the probe head's shape
def test_cuda_kernel_random_inputs_within_one_ulp(cuda_device, m, b):
    rng = np.random.default_rng(6)
    n = 256
    w = _random_w(rng, m, n)
    xa = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32) * 1e-2)
    dzc = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32) * 1e-2)
    ref = tfr._apply_scaled_outer_plain(w, xa, dzc, 3).float()
    w_d = w.to(cuda_device)
    tfr.apply_scaled_outer(w_d, xa.to(cuda_device), dzc.to(cuda_device), 3)
    got = w_d.cpu().float()
    assert (got == ref).float().mean().item() >= 0.999
    big = torch.maximum(got.abs(), ref.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    err = b * 2.0**-24 * (xa.abs().T @ dzc.abs())
    assert bool(((got - ref).abs() <= ulp + err).all())


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
