"""The in-place AdamW step (``ops/fused_adamw.py``, ``AdamW.step_``) on the
CPU, and the SSL trainer that takes it.

On the CPU ``step_`` runs the per-leaf loop and copies into the leaves, so
it is held bitwise against ``AdamW.update`` + ``apply_updates`` over 3
steps, on ContrastViTMAE's 255 leaves (the SSL model's depths and heads,
with its 1-element temperature and 3-element ``proj.bias``, at small
widths). The kernel's work table (``segments``) is checked at the SSL
model's full leaf sizes, read on the meta device. The kernel itself runs
only on a card (``tests/test_torch_kernels_gpu.py``).

The trainer updates its leaves in place, so nothing it was handed may
share their storage: after ``transform(use_best=True)``, ``resume()`` or
``_load_model()`` a further step leaves the best stash and the loaded
checkpoint's tensors as they were.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from video_spike_torch.models.vit_mae import ContrastViTMAE
from video_spike_torch.ops import fused_adamw
from video_spike_torch.ops.optim import (
    AdamW,
    apply_updates,
    cosine_onecycle_schedule,
)
from video_spike_torch.train import contrast
from video_spike_torch.train.contrast import ContrastTrainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# ViT-MAE-Base's depths (12 encoder, 8 decoder blocks): the SSL model's
# 255 leaves, at widths a CPU step takes in milliseconds
DEEP_TINY = dict(
    model_class="ViT_MAE", image_size=32, patch_size=8, num_channels=1,
    hidden_size=16, num_hidden_layers=12, num_attention_heads=2,
    intermediate_size=32, decoder_hidden_size=16,
    decoder_num_hidden_layers=8, decoder_num_attention_heads=2,
    decoder_intermediate_size=32, mask_ratio=0.75, norm_pix_loss=False,
    embed_size=3)


def _model(seed: int = 0) -> ContrastViTMAE:
    model = ContrastViTMAE.from_config(DEEP_TINY, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _ssl_numels() -> list:
    cfg = json.loads((REPO / "benchmark/configs/vit_mae_base_ssl.json")
                     .read_text())["config"]["model"]
    model = ContrastViTMAE.from_config(cfg, device="meta")
    return [p.numel() for p in model.parameters()]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int16 if t.element_size() == 2
                                        else torch.int32)


CASES = {
    "f32": dict(),
    "schedule": dict(schedule=True),
    "mu_bf16": dict(mu_dtype=torch.bfloat16),
    "bf16_leaves": dict(leaf_dtype=torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_in_place_equals_update_then_apply(case):
    kw = CASES[case]
    lr = (cosine_onecycle_schedule(100, 5e-5, 0.15, 10, 1e4)
          if kw.get("schedule") else 5e-5)
    dtype = kw.get("leaf_dtype", torch.float32)
    start = {k: p.detach().to(dtype)
             for k, p in _model().named_parameters()}
    assert len(start) == 255
    assert start["temperature"].numel() == 1 and start["proj.bias"].shape \
        == (3,)
    txs = [AdamW(lr, weight_decay=0.01, eps=1e-8,
                 mu_dtype=kw.get("mu_dtype")) for _ in range(2)]
    ref_p = {k: v.clone() for k, v in start.items()}
    ref_state = txs[0].init(ref_p)
    p = {k: v.clone() for k, v in start.items()}
    state = txs[1].init(p)
    rng = np.random.default_rng(3)
    for step in range(3):
        g = {k: torch.from_numpy(rng.normal(
            0, 10.0 ** -(2 + i % 4), v.shape).astype(np.float32)).to(dtype)
             for i, (k, v) in enumerate(start.items())}
        g["temperature"].zero_()           # the fixed temperature's
        upd, ref_state = txs[0].update(g, ref_state, ref_p)
        ref_p = apply_updates(ref_p, upd)
        txs[1].step_(p, g, state)
        assert state["count"] == ref_state["count"] == step + 1
        for k in start:
            assert torch.equal(_bits(p[k]), _bits(ref_p[k])), (step, k)
            assert torch.equal(_bits(state["mu"][k]),
                               _bits(ref_state["mu"][k])), (step, k)
            assert torch.equal(_bits(state["nu"][k]),
                               _bits(ref_state["nu"][k])), (step, k)


def test_step_keeps_the_state_and_its_tensors():
    model = _model()
    p = {k: v.detach() for k, v in model.named_parameters()}
    tx = AdamW(1e-3)
    state = tx.init(p)
    mu, nu = state["mu"], state["nu"]
    ids = {k: (id(mu[k]), id(nu[k]), p[k].data_ptr()) for k in p}
    before = fused_adamw.step_.launches
    for _ in range(2):
        tx.step_(p, {k: torch.ones_like(v) for k, v in p.items()}, state)
    assert set(state) == {"count", "mu", "nu"} and state["count"] == 2
    assert state["mu"] is mu and state["nu"] is nu
    for k, v in p.items():
        assert ids[k] == (id(mu[k]), id(nu[k]), v.data_ptr())
        assert mu[k].shape == nu[k].shape == v.shape
        assert bool((mu[k] != 0).any())
    assert fused_adamw.step_.launches == before       # no kernel on the CPU


def test_cpu_step_refuses_a_leaf_elsewhere():
    """A leaf on another device than the CPU's is refused, not stepped."""
    p = {"a": torch.zeros(3), "b": torch.zeros(3, device="meta")}
    tx = AdamW(1e-3)
    state = tx.init(p)
    with pytest.raises(ValueError, match="mixed devices"):
        tx.step_(p, {k: torch.ones_like(v) for k, v in p.items()}, state)


@pytest.mark.parametrize("n_chunks", [1, 7, 528, 54_201, 100_000])
def test_segments_cover_every_leaf_once(n_chunks):
    """At the SSL model's leaf sizes (255 leaves, 111,002,116 elements; the
    kernel cuts them into 54,201 chunks of 2,048): each element in exactly
    one segment, every segment starting at a multiple of 4 elements of its
    leaf, the chunks in order and none larger than an equal share."""
    numels = _ssl_numels()
    assert len(numels) == 255 and sum(numels) == 111_002_116
    assert sum(n < 1 << 16 for n in numels) == 172
    assert -(-sum(-(-n // 4) for n in numels) // (fused_adamw.CHUNK // 4)) \
        == 54_201
    segs, first = fused_adamw.segments(numels, n_chunks)
    assert len(first) == n_chunks + 1 and first[0] == 0 \
        and first[-1] == len(segs)
    assert bool((np.diff(first) >= 0).all())
    covered = [0] * len(numels)
    for leaf, start, length in segs.tolist():
        assert start % 4 == 0 and length > 0
        assert start == covered[leaf], (leaf, start)
        covered[leaf] += length
    assert covered == numels
    per = -(-sum(-(-n // 4) for n in numels) // n_chunks)
    chunk = np.repeat(np.arange(n_chunks), np.diff(first))
    assert int(np.bincount(chunk, weights=segs[:, 2]).max()) <= 4 * per


# ---------------------------------------------------------------------------
# the trainer: in place, and no live leaf aliases what it was handed
# ---------------------------------------------------------------------------

class _Frames:
    """A transform loader: trial batches of uint8 frames (weakly
    referenceable, as the trainer's staging cache needs)."""

    def __init__(self, frames: np.ndarray):
        self.batches = [{"ref": frames}]

    def __iter__(self):
        return iter(self.batches)


def _trainer(tmp_path, seed: int = 0) -> ContrastTrainer:
    model = ContrastViTMAE.from_config(DEEP_TINY, dtype=torch.float32)
    return ContrastTrainer(model, None, {"lr": 1e-3}, max_steps=4,
                           eid="fa00", log_dir=str(tmp_path),
                           image_size=32, seed=seed, save_every_min=None,
                           device="cpu")


def _triplet(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (3, 4, 1, 32, 32),
                                         dtype=np.uint8))


def _copies(tree: dict) -> dict:
    return {k: v.clone() for k, v in tree.items()}


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_step_updates_the_leaves_in_place(tmp_path):
    tr = _trainer(tmp_path)
    tr._init_if_needed()
    ptrs = {k: v.data_ptr() for k, v in tr.params.items()}
    mu = tr.opt_state["mu"]
    before = _copies(tr.params)
    tr._train_step(_triplet(1))
    assert {k: v.data_ptr() for k, v in tr.params.items()} == ptrs
    assert tr.opt_state["mu"] is mu and tr.opt_state["count"] == 1
    assert any(not torch.equal(v, before[k]) for k, v in tr.params.items())


@pytest.mark.parametrize("site", ["transform_best", "load_model", "resume"])
def test_a_step_writes_nothing_it_was_handed(tmp_path, monkeypatch, site):
    """The best stash (``transform(use_best=True)``) and a loaded
    checkpoint's tensors (``_load_model``, ``resume``) are copied into the
    live leaves: a further step leaves them as they were."""
    tr = _trainer(tmp_path)
    tr._init_if_needed()
    tr._train_step(_triplet(1))
    handed = {}
    if site == "transform_best":
        tr._best_params = {k: v.clone() for k, v in tr.params.items()}
        tr._train_step(_triplet(2))
        tr.transform(_Frames(_triplet(3)[0].numpy()), use_best=True)
        handed = tr._best_params
    else:
        tr._save_last(1)
        tr._save_model("best_model")
        real = contrast.load_checkpoint

        def keep(*a, **kw):
            tree = real(*a, **kw)
            handed.update(tree["params"])
            return tree

        monkeypatch.setattr(contrast, "load_checkpoint", keep)
        tr = _trainer(tmp_path, seed=5)
        if site == "resume":
            assert tr.resume()
        else:
            assert tr._load_model("best_model")
    assert handed
    kept = _copies(handed)
    _assert_same(tr.params, kept)
    tr._train_step(_triplet(4))
    _assert_same(handed, kept)
    assert any(not torch.equal(v, kept[k]) for k, v in tr.params.items())
