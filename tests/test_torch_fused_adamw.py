"""The fused AdamW steps (``ops/fused_adamw.py``: ``AdamW.step_`` in place,
``AdamW.step`` into new tensors) on the CPU, the routes ``ops/step.py``
takes to them, and the trainers that step through them.

On the CPU ``step_`` runs the per-leaf loop and copies into the leaves,
and ``step`` runs it into new tensors, so both are held bitwise against
``AdamW.update`` + ``apply_updates`` over 3 steps, on ContrastViTMAE's 255
leaves (the SSL model's depths and heads, with its 1-element temperature
and 3-element ``proj.bias``, at small widths); ``step`` also leaves what it
was handed as it was. The kernel's work table (``segments``) is checked at
the SSL model's full leaf sizes, and ``step``'s layout of its new tensors
at VideoMAE-Base's, both read on the meta device. The kernel itself runs
only on a card (``tests/test_torch_kernels_gpu.py``).

``ops/step.update`` takes ``step_`` for a bare AdamW, or ``step`` when
asked not to step in place; ``Frozen``, ``MultiSteps``, ``mu_dtype`` and
Adafactor take ``update`` and leave the leaves they were given alone. Every
route gives the per-leaf loop's bits.

Every trainer on the in-place route (the SSL trainer, the supervised
trainer with AdamW, the multi-session VTT trainer and CEBRA) updates its
leaves and moments in place, so nothing it was handed may share their
storage: a further step leaves the best stash, a loaded checkpoint's
tensors, an earlier fit's params and what a save wrote (a background save
reads after the next step here) as they were. The VideoMAE pretraining
step steps into new tensors and leaves its own arguments as they were.
"""

import copy
import json
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from video_spike_torch.models.vit_mae import ContrastViTMAE
from video_spike_torch.ops import fused_adamw
from video_spike_torch.ops.optim import (
    Adafactor,
    AdamW,
    Frozen,
    MultiSteps,
    apply_updates,
    cosine_onecycle_schedule,
)
from video_spike_torch.ops.step import steps_in_place, update
from video_spike_torch.train import contrast
from video_spike_torch.train.contrast import ContrastTrainer

# the data sessions of the supervised and the multi-session trainers
from test_torch_multisession import two_sessions  # noqa: F401
from test_torch_optim_variants import session  # noqa: F401

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


def _videomae_shapes() -> tuple:
    """VideoMAE-Base's 203 leaf shapes (the ``vmae.pretrain`` cell's model),
    read on the meta device."""
    from video_spike_torch.models.videomae import VideoMAEForPreTraining

    cfg = json.loads((REPO / "benchmark/configs/videomae_base_pretrain.json")
                     .read_text())["config"]["model"]
    model = VideoMAEForPreTraining.from_config(cfg, device="meta")
    return tuple(p.shape for p in model.parameters())


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_into_new_tensors_equals_update_then_apply(case):
    """``AdamW.step`` returns new dicts whose leaves, moments and count are
    the per-leaf loop's, bit for bit, after each of 3 steps, and leaves the
    leaves, moments and count it was handed, and a state kept from two
    steps before, as they were."""
    kw = CASES[case]
    lr = (cosine_onecycle_schedule(100, 5e-5, 0.15, 10, 1e4)
          if kw.get("schedule") else 5e-5)
    dtype = kw.get("leaf_dtype", torch.float32)
    start = {k: p.detach().to(dtype)
             for k, p in _model().named_parameters()}
    txs = [AdamW(lr, weight_decay=0.01, eps=1e-8,
                 mu_dtype=kw.get("mu_dtype")) for _ in range(2)]
    ref_p = {k: v.clone() for k, v in start.items()}
    ref_state = txs[0].init(ref_p)
    p = {k: v.clone() for k, v in start.items()}
    state = txs[1].init(p)
    kept = []
    rng = np.random.default_rng(4)
    for step in range(3):
        g = {k: torch.from_numpy(rng.normal(
            0, 10.0 ** -(2 + i % 4), v.shape).astype(np.float32)).to(dtype)
             for i, (k, v) in enumerate(start.items())}
        upd, ref_state = txs[0].update(g, ref_state, ref_p)
        ref_p = apply_updates(ref_p, upd)
        handed = (_copies(p), _copies(state["mu"]), _copies(state["nu"]))
        kept.append((p, state, handed))
        p, state = txs[1].step(p, g, state)
        assert state["count"] == ref_state["count"] == step + 1
        for k in start:
            assert torch.equal(_bits(p[k]), _bits(ref_p[k])), (step, k)
            assert torch.equal(_bits(state["mu"][k]),
                               _bits(ref_state["mu"][k])), (step, k)
            assert torch.equal(_bits(state["nu"][k]),
                               _bits(ref_state["nu"][k])), (step, k)
    for step, (old_p, old_state, handed) in enumerate(kept):
        assert old_state["count"] == step
        for got, want in zip((old_p, old_state["mu"], old_state["nu"]),
                             handed):
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(_bits(got[k]), _bits(want[k])), (step, k)


@pytest.mark.parametrize("model", ["videomae", "odd"])
def test_step_lays_each_leaf_out_at_a_multiple_of_four(model):
    """``step``'s new tensors are views of three flat buffers: each leaf at
    an offset that is a multiple of 4 elements (16 bytes, so the kernel
    takes float4 where a leaf's input pointers are aligned too), in its own
    shape, the leaves in order with no overlap, the buffer no longer than
    the leaves padded to 4; the output pointers the kernel's table gets
    are those views' ``data_ptr``s."""
    shapes = (_videomae_shapes() if model == "videomae" else tuple(
        torch.Size(s) for s in ((1,), (3,), (5,), (130, 129), (), (0,),
                                (2, 3, 4), (7,))))
    keys = tuple(f"leaf{i}" for i in range(len(shapes)))
    outs = fused_adamw._Outputs.of(keys, shapes)
    numels = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    if model == "videomae":
        assert len(shapes) == 203 and sum(numels) == 94_222_080
    assert outs.total == sum(-(-n // 4) * 4 for n in numels)
    bufs = [torch.empty(outs.total) for _ in range(3)]
    views = [outs.views(b) for b in bufs]
    end = 0
    for i, (k, shape, n) in enumerate(zip(keys, shapes, numels)):
        off = int(outs.offsets[i])
        assert off % 4 == 0 and off >= end
        end = off + n
        for b, v in zip(bufs, views):
            assert v[k].shape == shape and v[k].is_contiguous()
            assert v[k].untyped_storage().data_ptr() == b.data_ptr()
            assert v[k].storage_offset() == off
    assert end <= outs.total
    ptrs = fused_adamw.out_pointers([b.data_ptr() for b in bufs],
                                    outs.offsets)
    assert ptrs.shape == (len(shapes), 3)
    assert all(ptrs[i, j] == views[j][k].data_ptr() for j in range(3)
               for i, (k, n) in enumerate(zip(keys, numels)) if n)


# (optimizer, update's in_place argument, the AdamW entry it takes: None
# for ``tx.update`` and ``apply_updates``)
ROUTES = {
    "adamw": (lambda: AdamW(1e-2), True, "step_"),
    "adamw_not_in_place": (lambda: AdamW(1e-2), False, "step"),
    "frozen": (lambda: Frozen(AdamW(1e-2), ("b",)), True, None),
    "multisteps": (lambda: MultiSteps(AdamW(1e-2), 2), True, None),
    "mu_bf16": (lambda: AdamW(1e-2, mu_dtype=torch.bfloat16), True, None),
    "adafactor": (lambda: Adafactor(1e-2), True, None),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_update_routes_by_the_optimizer(monkeypatch, name):
    """``ops/step.update`` steps a bare AdamW in place through ``step_``,
    or into new tensors through ``step`` with ``in_place=False`` (on the
    CPU the per-leaf loop), and every other optimizer through ``update``
    and ``apply_updates``; off the in-place route it leaves the leaves and
    the state it was given as they were; either way the leaves and the
    state are the per-leaf loop's, bit for bit."""
    make, asked, route = ROUTES[name]
    in_place = route == "step_"
    tx, ref = make(), make()
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in (("a", (130, 129)), ("b", (7,)))}
    grads = {k: torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in params.items()}
    kept = _copies(params)
    state = tx.init(params)
    upd, want_state = ref.update(grads, ref.init(kept), kept)
    want = apply_updates(kept, upd)
    routes = []
    for entry in ("step_", "step"):
        real = getattr(AdamW, entry)
        monkeypatch.setattr(AdamW, entry, lambda self, *a, _e=entry,
                            _real=real: (routes.append(_e),
                                         _real(self, *a))[1])
    kept_state = copy.deepcopy(state)
    new, new_state = update(tx, params, grads, state, in_place=asked)
    assert steps_in_place(tx) == name.startswith("adamw")
    assert routes == ([route] if route else [])
    assert (new is params and new_state is state) == in_place
    if not in_place:
        _assert_same(params, kept)
        assert state.get("count") == kept_state.get("count")
        for what in ("mu", "nu"):
            if what in state:
                _assert_same(state[what], kept_state[what])
    _assert_same(new, want)
    for what in ("mu", "nu", "v_row", "v_col", "v"):
        inner = new_state.get("inner", new_state)
        if what in inner:
            want_inner = want_state.get("inner", want_state)
            _assert_same(inner[what], want_inner[what])


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


def _clips(k: int) -> torch.Tensor:
    """Step ``k``'s batch of the VideoMAE step: 2 clips of 4 uint8 frames."""
    rng = np.random.default_rng(k)
    return torch.from_numpy(rng.integers(0, 256, (2, 4, 1, 24, 24),
                                         dtype=np.uint8))


def _linear(d, tmp_path):
    from test_torch_spans import _linear_trainer

    tr = _linear_trainer(d, tmp_path, {"name": "adamw"})
    assert steps_in_place(tr.tx)
    return tr


def _vtt(d, tmp_path):
    from test_torch_multisession import EIDS, MODEL, _trainer_config
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.models.vtt import VideoTemporalTransformer
    from video_spike_torch.train.multisession import MultiSessionTrainer

    tr = MultiSessionTrainer(model=None, config=DictConfig(
        _trainer_config(num_epochs=1)), eids=EIDS, data_dir=str(d / "data"),
        log_dir=str(tmp_path), device="cpu")
    tr.model = VideoTemporalTransformer.from_config(
        dict(MODEL, n_sessions=2, max_neurons=tr.max_neurons),
        dtype=torch.float32)
    assert steps_in_place(tr.tx)
    return tr


class _Run:
    """One trainer with a bare AdamW, as its own loop drives it:
    ``params()`` its live leaves, ``state()`` its optimizer state,
    ``step(k)`` its step on the inputs of ``k``."""

    def __init__(self, kind, tmp_path, data):
        if kind == "contrast":
            tr = _trainer(tmp_path)
            tr._init_if_needed()
            self.step = lambda k: tr._train_step(_triplet(k))
        elif kind == "base":
            tr = _linear(data, tmp_path)
            assert tr._stage_device_dataset()
            x, ap = tr._dev_data

            def step(k):
                rows = torch.from_numpy(
                    np.random.default_rng(k).permutation(len(x))[:8])
                tr._step(x[rows], ap[rows], 8)
            self.step = step
        elif kind == "vtt":
            tr = _vtt(data, tmp_path)
            assert tr._stage_device_dataset()
            self.step = lambda k: tr.staged_step(
                np.random.default_rng(k).permutation(tr._n_train)[:4], 4)
        elif kind == "cebra":
            from video_spike_torch.models.cebra import CEBRA

            tr = CEBRA(batch_size=16, max_iterations=3, device="cpu")
            gen = torch.Generator().manual_seed(0)
            series = torch.from_numpy(SERIES)
            tr.params = tr.init_params(series.shape[1], gen)
            tr.opt_state = tr.tx.init(tr.params)

            def step(k):
                tr.params, tr.opt_state, _ = tr.step(
                    tr.params, tr.opt_state, series,
                    *tr.sample(gen, len(series) - 21))
            self.step = step
        else:
            from video_spike_torch.cli import pretrain_videomae as cli

            model, tx, params, opt_state = cli.build(
                VMAE, {"lr": 1e-3, "wd": 0.01}, 0, torch.device("cpu"))
            tr = types.SimpleNamespace(tx=tx, params=params,
                                       opt_state=opt_state)
            step_fn = cli.make_step(model, tx, 4, 32, 0.75)
            gen = torch.Generator()

            def step(k):
                tr.params, tr.opt_state, _ = cli.train_step(
                    step_fn, tr.params, tr.opt_state, _clips(k), gen, 0, k)
            self.step = step
        self.trainer = tr
        assert steps_in_place(tr.tx)

    def params(self) -> dict:
        return self.trainer.params

    def state(self) -> dict:
        return self.trainer.opt_state


# the in-place route's trainers: the SSL trainer, the supervised trainer
# with AdamW, the multi-session VTT trainer and CEBRA (the VideoMAE step
# is a function of what it is handed, and steps into new tensors)
KINDS = ["contrast", "base", "vtt", "cebra"]
SERIES = np.random.default_rng(9).normal(size=(200, 6)).astype(np.float32)
VMAE = dict(image_size=32, patch_size=8, num_channels=3, num_frames=4,
            tubelet_size=2, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, mask_type="tube",
            norm_pix_loss=True)


@pytest.fixture
def data(request):
    """The data sessions the supervised and multi-session trainers read
    (built once a module), else None."""
    name = {"base": "session", "vtt": "two_sessions"}.get(
        request.node.callspec.params["kind"])
    return request.getfixturevalue(name) if name else None


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_updates_the_leaves_in_place(tmp_path, data, kind):
    run = _Run(kind, tmp_path, data)
    ptrs = {k: v.data_ptr() for k, v in run.params().items()}
    mu = run.state()["mu"]
    before = _copies(run.params())
    run.step(1)
    assert {k: v.data_ptr() for k, v in run.params().items()} == ptrs
    assert run.state()["mu"] is mu and run.state()["count"] == 1
    assert any(not torch.equal(v, before[k])
               for k, v in run.params().items())


def _handed_by_load(monkeypatch, module, handed: dict) -> None:
    """``module.load_checkpoint`` keeps the tensors of the params and the
    optimizer state it hands out in ``handed``."""
    real = module.load_checkpoint

    def keep(*a, **kw):
        tree = real(*a, **kw)
        handed.update(tree["params"])
        state = tree.get("opt_state", {})
        state = state.get("tx", state)
        for what in ("mu", "nu"):
            handed.update({f"{what}:{k}": v
                           for k, v in state.get(what, {}).items()})
        return tree

    monkeypatch.setattr(module, "load_checkpoint", keep)


SITES = [("contrast", "transform_best"), ("contrast", "load_model"),
         ("contrast", "resume"), ("base", "best"), ("base", "resume"),
         ("base", "save_last"), ("vtt", "best"), ("vtt", "resume"),
         ("vtt", "save_last"), ("cebra", "refit"), ("videomae", "backbone"),
         ("videomae", "step")]


@pytest.mark.parametrize("kind,site", SITES)
def test_a_step_writes_nothing_it_was_handed(tmp_path, monkeypatch, data,
                                             kind, site):
    """What a trainer was handed is copied into its live leaves, never
    aliased, and what it saves is a copy: a further step (or fit) leaves
    the best stash (after the train loop, or ``transform(use_best=True)``),
    a loaded checkpoint's params and moments (``resume``, ``_load_model``),
    an earlier fit's params, what an asynchronous ``model_last`` save or
    the backbone save wrote, and the VideoMAE step's own arguments, as they
    were."""
    from video_spike_torch.train import base, checkpoint, multisession

    run = _Run(kind, tmp_path, data)
    tr = run.trainer
    handed = {}
    if site in ("save_last", "backbone"):
        # a background save reads its tensors only after the next step
        stepped = threading.Event()
        fetch = checkpoint.parallel_device_get
        monkeypatch.setattr(checkpoint, "parallel_device_get",
                            lambda *a: stepped.wait(60) and fetch(*a))
        run.step(1)
        kept = _copies(tr.params)
        if site == "backbone":      # as the pretraining CLI's main writes
            checkpoint.save_checkpoint(tmp_path, "backbone",
                                       {"params": tr.params})
        elif kind == "base":
            tr.save_model("last", 0, block=False)
        else:
            tr._save_last(0, block=False)
        run.step(2)
        stepped.set()
        checkpoint.wait_for_checkpoints()
        saved = checkpoint.load_checkpoint(
            tmp_path if site == "backbone" else tr.log_dir,
            "backbone" if site == "backbone" else "model_last")
        _assert_same(saved["params"], kept)
        return
    if site == "transform_best":
        run.step(1)
        tr._best_params = _copies(tr.params)
        run.step(2)
        tr.transform(_Frames(_triplet(3)[0].numpy()), use_best=True)
        handed = tr._best_params
    elif site == "best":
        tr.train()              # one epoch: the best params end up live
        handed = tr._best_params
    elif site == "refit":
        tr.fit(SERIES)
        handed = tr.params
    elif site == "step":        # the params and moments the step is handed
        run.step(1)
        handed = {**tr.params, **{f"{what}:{k}": v for what in ("mu", "nu")
                                  for k, v in tr.opt_state[what].items()}}
    else:                       # resume, load_model: a new trainer loads
        run.step(1)
        if site == "load_model":
            tr._save_model("best_model")
        elif kind == "base":
            tr.save_model("last", 0)
        else:
            tr._save_last(1)
        module = {"contrast": contrast, "base": base,
                  "vtt": multisession}[kind]
        _handed_by_load(monkeypatch, module, handed)
        run = _Run(kind, tmp_path, data)
        assert (run.trainer._load_model("best_model")
                if site == "load_model" else run.trainer.resume())
    assert handed
    kept = _copies(handed)
    if site == "refit":
        run.trainer.fit(SERIES[::-1].copy())
    else:
        _assert_same(run.params(),
                     {k: v for k, v in kept.items() if ":" not in k})
        run.step(4)
    _assert_same(handed, kept)
    assert any(not torch.equal(v, kept[k])
               for k, v in run.params().items())
