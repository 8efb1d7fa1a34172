"""Four NCCL ranks, one a card: the tensor-parallel layers and the
data-parallel fused step of the port across cards.

Every test carries the ``gpu`` marker and skips (inside a fixture) on a
host with fewer than four CUDA cards. The file imports neither JAX nor the
JAX package, so on a four-card host without JAX it runs apart from
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_multicard_gpu.py

Each test starts four ranks with ``torch.distributed.run --standalone``;
``core/runtime.setup_runtime`` gives each its ``LOCAL_RANK``'s card and
NCCL (``VST_DIST_BACKEND`` is removed from the ranks' environment).

Tolerances: ``row_dense`` and ``column_dense`` (``parallel/tensor``) on a
{data: 1, model: 4} mesh against the unsplit f32 layer on the same card,
forward and gradients, rtol 1e-5 of the largest value (TF32 off), the bound
of the gloo card test in ``tests/test_torch_kernels_gpu.py``; the fused
step's W bitwise equal on the four ranks after three steps.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLD = 4


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards, one NCCL rank a card")


def _launch(code: str, *args) -> None:
    env = {k: v for k, v in os.environ.items() if k != "VST_DIST_BACKEND"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", "--no-python", sys.executable, "-c",
         code, *map(str, args)],
        env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]


_RANK_CARD = r"""
assert setup_runtime("cuda")
assert dist.get_backend() == "nccl", dist.get_backend()
assert torch.cuda.current_device() == int(os.environ["LOCAL_RANK"])
"""

SPLIT_LAYERS = r"""
import os, sys
import torch
import torch.distributed as dist
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.parallel.tensor import column_dense, row_dense
""" + _RANK_CARD + r"""
torch.backends.cuda.matmul.allow_tf32 = False
mesh = make_mesh(n_data=1, n_model=4)
group, r = mesh.group("model"), mesh.coords["model"]
g = torch.Generator().manual_seed(0)
x, k, b, gy = (torch.randn(s, generator=g).cuda() for s in
               ((4, 64, 512), (512, 1024), (1024,), (4, 64, 1024)))
rows, cols = slice(128 * r, 128 * r + 128), slice(256 * r, 256 * r + 256)
rel = lambda a, w: float((a - w).abs().max() / w.abs().max())
errs = {}
for kind, layer, block in (("column", column_dense, (slice(None), cols)),
                           ("row", row_dense, (rows, slice(None)))):
    out = {}
    for split in (False, True):
        xi = x.clone().requires_grad_(True)
        bi = b.clone().requires_grad_(True)
        ki = (k[block] if split else k).clone().requires_grad_(True)
        y = layer(xi, ki, bi, torch.float32, group if split else None)
        (y * gy).sum().backward()
        out[split] = (y.detach(), xi.grad, ki.grad, bi.grad)
    (y1, dx1, dk1, db1), (y2, dx2, dk2, db2) = out[False], out[True]
    assert y2.is_cuda and dk2.shape == k[block].shape
    errs[kind] = [rel(y2, y1), rel(dx2, dx1), rel(dk2, dk1[block]),
                  rel(db2, db1)]
torch.save(errs, f"{sys.argv[1]}{r}.pt")
exit_rank()
"""


@pytest.mark.gpu
def test_four_nccl_ranks_row_and_column_dense(four_cards, tmp_path):
    """A row-split and a column-split Dense over the model axis of 4 cards
    against the unsplit layer: forward, input, kernel-block and bias
    gradients within rtol 1e-5."""
    _launch(SPLIT_LAYERS, tmp_path / "e")
    for r in range(WORLD):
        errs = torch.load(tmp_path / f"e{r}.pt")
        for kind, e in errs.items():
            assert max(e) <= 1e-5, (r, kind, e)


DP_FUSED = r"""
import os, sys
import torch
import torch.distributed as dist
from video_spike_torch.core.runtime import exit_rank, setup_runtime
from video_spike_torch.models.linear import LinearModel
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops import optim
from video_spike_torch.ops.poisson import poisson_nll_mean
from video_spike_torch.parallel import multihost as mh
""" + _RANK_CARD + r"""
r, rows = mh.process_index(), 16
b = rows // mh.process_count()
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
    x = torch.randint(0, 255, (rows, 20_000), generator=g, dtype=torch.uint8)
    ap = torch.poisson(torch.ones(rows, 100, 4), generator=g)
    params, opt, _ = step(params, opt, x[b * r:b * r + b].cuda(),
                          ap[b * r:b * r + b].cuda(), rows, i)
w = params[fr.FIRST_KERNEL]
assert fr.apply_scaled_outer.launches == 3, fr.apply_scaled_outer.launches
sums = mh.replica_checksums({"w": w}, dist.group.WORLD)
assert len(set(sums)) == 1, sums
torch.save(w.cpu(), f"{sys.argv[1]}{r}.pt")
exit_rank()
"""


@pytest.mark.gpu
def test_four_nccl_ranks_keep_fused_w_bitwise_equal(four_cards, tmp_path):
    """The data-parallel fused step on 4 cards (4 rows a rank, the kernel
    on the gathered 16): three steps, a launch a step on every rank, the
    four W bitwise equal."""
    _launch(DP_FUSED, tmp_path / "w")
    ws = [torch.load(tmp_path / f"w{r}.pt") for r in range(WORLD)]
    for w in ws[1:]:
        assert torch.equal(w.view(torch.int16), ws[0].view(torch.int16))
