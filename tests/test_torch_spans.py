"""``video_spike_torch/core/spans.py``: the port's host spans on the
profiler's clock.

- With no profiler recording, ``span()`` is one shared object that
  allocates nothing and records nothing.
- The ring keeps the newest ``CAP`` spans.
- Under ``torch.profiler``, three steps of a tiny ``ContrastTrainer``
  (``tests/test_torch_contrast.py``'s, over an in-memory session, frame
  cache live) driven as ``fit()`` drives them, a staged epoch of the
  Linear ``BaseTrainer`` (standard step and fused step), three steps of
  ``cli/pretrain_videomae.py``'s loop (``clip_stream``, ``train_step``)
  over a tiny ``VideoMAEForPreTraining`` with tube masking, and a staged
  epoch of the tiny VTT ``MultiSessionTrainer`` over two sessions, record
  one ``vs.step`` a step whose direct children, found by their intervals,
  are ``vs.forward``, ``vs.backward`` and ``vs.optimizer`` in that order.
  The SSL and pretraining loops record one ``vs.producer_wait`` a batch,
  before its step.
- In the two ViT models each attention core is a ``vs.attention`` span
  directly under ``vs.forward``, once a block, and its backward one more
  (on the CPU autograd runs it on the calling thread, inside
  ``vs.backward``).
- Every recorded span matches its kineto ``vs.*`` range within 1 ms at both
  ends.
- Profiling changes no number: losses and parameters equal those of the
  same run without a profiler, bit for bit.
- ``scripts/profile_torch_step.py`` counts the card busy over the union of
  its activities (streams that overlap once, host ranges mirrored on the
  device track not at all), counts no such range as a kernel, and gives
  host ms a step by ``vs.*`` span from the profiler's rows.
"""

import collections
import sys
import threading
import types

import numpy as np
import pytest
import torch

from video_spike_torch.core import spans

# the tiny SSL trainer of the trainer tests; the Linear fixture session;
# the two sessions of the multi-session trainer tests
from test_torch_contrast import _port_trainer
from test_torch_multisession import two_sessions  # noqa: F401
from test_torch_optim_variants import REPO, session  # noqa: F401

torch.set_num_threads(1)

STEP_CHILDREN = ["forward", "backward", "optimizer"]
MS = 1_000_000                       # ns
SSL_STEPS = 3
LOG_EVERY = 50                       # fit()'s logging cadence
LINEAR_OPTIMIZERS = {
    "linear": {"name": "adamw"},
    "linear_fused": {"name": "adafactor_lean", "fused_readout": True,
                     "fused_min_kernel": 1},
}
VMAE_STEPS = 3
VMAE = dict(image_size=32, patch_size=8, num_channels=3, num_frames=4,
            tubelet_size=2, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, mask_type="tube",
            norm_pix_loss=True)
VMAE_DECODER = dict(decoder_hidden_size=32, decoder_num_hidden_layers=1,
                    decoder_num_attention_heads=4,
                    decoder_intermediate_size=64)
VTT_STEPS = 5        # the two sessions' staged training trials at batch 4
KINDS = ["ssl", *LINEAR_OPTIMIZERS, "videomae_pretrain", "vtt"]
VIT_KINDS = ["ssl", "videomae_pretrain"]
MAIN = threading.get_ident()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof) -> dict:
    """name -> sorted [(start_ns, end_ns)] of the profiler's ``vs.*``
    ranges."""
    out = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(spans.PREFIX):
            out[name[len(spans.PREFIX):]].append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _within(got, parent) -> list:
    """The spans of ``parent``'s thread that lie within it, by start."""
    return sorted((s for s in got if s is not parent
                   and s.thread == parent.thread
                   and parent.start_ns <= s.start_ns <= s.end_ns
                   <= parent.end_ns), key=lambda s: s.start_ns)


def _children(got, parent) -> list:
    """The spans directly within ``parent`` (within no other span that is
    within it), by start."""
    inner = _within(got, parent)
    return [s for s in inner
            if not any(s in _within(inner, o) for o in inner if o is not s)]


def _ssl_session(seed: int = 0) -> dict:
    """4 trials of 30 uint8 frames of 24 x 40, in ``load_h5_file``'s
    layout (3 training trials, 1 held out)."""
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (4, 30, 1, 24, 40), dtype=np.uint8)
    ts = np.arange(4 * 30, dtype=np.float64).reshape(4, 30)
    y = rng.poisson(1.0, (4, 30, 8)).astype(np.float32)
    return {"cafe00000": {
        "train_X": video[:3], "val_X": video[3:], "test_X": video[3:],
        "train_timestamp": ts[:3], "val_timestamp": ts[3:],
        "test_timestamp": ts[3:],
        "train_y": y[:3], "val_y": y[3:], "test_y": y[3:]}}


def _ssl_steps(trainer) -> None:
    """``fit()``'s inner loop for ``SSL_STEPS`` steps: the staged stream,
    the step, the losses fetched at the cadence and at the end."""
    trainer._init_if_needed()
    assert trainer._maybe_stage_frames()
    stream = trainer._staged_epoch_stream()
    try:
        for k, staged in zip(range(SSL_STEPS), stream):
            logs = trainer._step_staged(staged, k)
            trainer._pending_losses.append(logs["loss"])
            if k % LOG_EVERY == 0:
                trainer._log_losses(logs)
    finally:
        stream.close()
    trainer._log_losses(None)


def _linear_trainer(d, log_dir, optimizer):
    from video_spike_torch.core import config as tconfig
    from video_spike_torch.data import dataset as tdata
    from video_spike_torch.models.linear import LinearModel as TLinear
    from video_spike_torch.train.base import BaseTrainer

    config = tconfig.config_from_kwargs(
        {"model": f"include:{d / 'model.yaml'}"})
    config = tconfig.update_config(
        str(REPO / "configs/train/linear_video.yaml"), config)
    config["dirs"]["data_dir"] = str(d / "data")
    config["training"].update(num_epochs=1, train_batch_size=8)
    config["optimizer"].update(optimizer)
    split = tdata.split_dataset(str(d / "data"), "optvr0000",
                                seed=config.seed)
    loaders = tdata.make_loader(config, split)
    meta = tdata.get_metadata_from_loader(loaders[0], config)
    config["model"]["encoder"]["input_dim"] = meta["input_dim"]
    config["model"]["decoder"]["output_dim"] = meta["output_dim"]
    return BaseTrainer(
        TLinear.from_config(config.model, compute_dtype=torch.float32),
        *loaders, config, eid="optvr0000", dataset_split_dict=split,
        log_dir=str(log_dir), device="cpu")


class _Pretraining:
    """``cli/pretrain_videomae.py``'s loop over 4 in-memory trials of 12
    uint8 frames of 24 x 24 in batches of 2: ``main``'s functions on a
    tiny model."""

    def __init__(self):
        from video_spike_torch.cli import pretrain_videomae as cli
        from video_spike_torch.models.videomae import VideoMAEForPreTraining
        from video_spike_torch.ops.optim import AdamW

        self.cli = cli
        self.model = VideoMAEForPreTraining(VMAE, dtype=torch.float32,
                                            **VMAE_DECODER)
        self.model.reset_parameters(torch.Generator().manual_seed(0))
        self.tx = AdamW(1e-3, weight_decay=0.01)
        self.params = {k: p.detach()
                       for k, p in self.model.named_parameters()}
        rng = np.random.default_rng(0)
        video = rng.integers(0, 256, (4, 12, 1, 24, 24), dtype=np.uint8)
        self.loader = [{"video": video[:2]}, {"video": video[2:]}]

    def work(self) -> list:
        cli = self.cli
        step_fn = cli.make_step(self.model, self.tx, 4, 32, 0.75)
        opt_state, gen = self.tx.init(self.params), torch.Generator()
        stream = cli.clip_stream(self.loader, "video", 4, "cpu")
        losses = []
        try:
            for k in range(VMAE_STEPS):
                video = next(stream)["video"]
                self.params, opt_state, loss = cli.train_step(
                    step_fn, self.params, opt_state, video, gen, 0, k)
                losses.append(float(loss))
        finally:
            stream.close()
        return losses


def _vtt_trainer(d, log_dir):
    from test_torch_multisession import EIDS, MODEL, _trainer_config
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.models.vtt import VideoTemporalTransformer
    from video_spike_torch.train.multisession import MultiSessionTrainer

    trainer = MultiSessionTrainer(
        model=None, config=DictConfig(_trainer_config(num_epochs=1)),
        eids=EIDS, data_dir=str(d / "data"), log_dir=str(log_dir),
        device="cpu")
    trainer.model = VideoTemporalTransformer.from_config(
        dict(MODEL, n_sessions=2, max_neurons=trainer.max_neurons),
        dtype=torch.float32)
    return trainer


def _run(kind, dirs, log_dir, traced: bool) -> dict:
    """One run of ``kind``, under a profiler or not: its losses, final
    parameters, recorded spans and the profiler's ``vs.*`` ranges."""
    if kind == "ssl":
        trainer = _port_trainer(_ssl_session(), log_dir, SSL_STEPS,
                                frame_cache_gb=1.0, validate_every=10**6)

        def work():
            _ssl_steps(trainer)
            return list(trainer.train_losses)
    elif kind == "videomae_pretrain":
        trainer = _Pretraining()
        work = trainer.work
    elif kind == "vtt":
        trainer = _vtt_trainer(dirs["vtt"], log_dir)

        def work():
            assert trainer._stage_device_dataset()   # staging is set-up
            return [trainer.train_epoch()["train_loss"]]
    else:
        trainer = _linear_trainer(dirs["linear"], log_dir,
                                  LINEAR_OPTIMIZERS[kind])

        def work():
            trainer._stage_device_dataset()   # staging is set-up
            losses = trainer.train_epoch()["train_loss"]
            assert trainer._dev_data is not None
            return [losses]
    spans.clear()
    ranges = {}
    if traced:
        with _profiler() as prof:
            losses = work()
        ranges = _ranges(prof)
    else:
        losses = work()
    out = {"losses": losses,
           "params": {k: v.clone() for k, v in trainer.params.items()},
           "spans": spans.recorded(), "ranges": ranges,
           "model": trainer.model}
    spans.clear()
    return out


@pytest.fixture(scope="module")
def runs(session, two_sessions, tmp_path_factory):  # noqa: F811
    dirs = {"linear": session, "vtt": two_sessions}
    return {(kind, traced): _run(kind, dirs,
                                 tmp_path_factory.mktemp(kind), traced)
            for kind in KINDS for traced in (False, True)}


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------

def test_off_span_is_shared_and_records_nothing(monkeypatch):
    """Off, ``span()`` hands out the object made at import and touches
    neither a span object, nor the clock, nor a profiler range."""
    def touched(*args, **kwargs):
        raise AssertionError("the off path touched it")

    spans.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(spans, "_On", touched)
    monkeypatch.setattr(spans.time, "time_ns", touched)
    monkeypatch.setattr(spans, "_Range", touched)
    for name in ("step", "forward", "producer_wait"):
        with spans.span(name) as s:
            assert s is spans.OFF
        with pytest.raises(ValueError):
            with spans.span(name):
                raise ValueError(name)      # an error passes through
    assert spans.recorded() == []


def test_ring_drops_its_oldest_spans_past_its_cap(monkeypatch):
    assert spans._RING.maxlen == spans.CAP == 100_000
    monkeypatch.setattr(spans, "_RING", collections.deque(maxlen=5))
    with _profiler():
        for i in range(8):
            with spans.span(f"s{i}"):
                pass
    got = spans.recorded()
    assert [s.name for s in got] == [f"s{i}" for i in range(3, 8)]
    assert all(s.thread == MAIN and s.start_ns <= s.end_ns for s in got)
    spans.clear()
    assert spans.recorded() == []


def test_each_thread_keeps_its_own_spans():
    """Sixteen threads, switched every microsecond, open nested spans
    while a span of the main thread is open: each span carries its own
    thread, each inner one lies within an outer one of its thread, and
    none is lost."""
    workers, rounds = 16, 200
    # every worker lives until all are done, so no two share an ident
    done = threading.Barrier(workers, timeout=120)

    def worker():
        for _ in range(rounds):
            with spans.span("outer"):
                with spans.span("inner"):
                    pass
        done.wait()

    spans.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            with spans.span("main"):
                threads = [threading.Thread(target=worker)
                           for _ in range(workers)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = spans.recorded()
    spans.clear()
    assert len(got) == 2 * workers * rounds + 1
    counts = collections.Counter((s.thread, s.name) for s in got)
    assert counts.pop((MAIN, "main")) == 1
    assert set(counts.values()) == {rounds}
    assert len({t for t, _ in counts}) == workers and MAIN not in {
        t for t, _ in counts}
    for s in got:
        if s.name == "outer":
            assert [k.name for k in _children(got, s)] == ["inner"]


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_each_step_holds_forward_backward_optimizer(runs, kind):
    got = runs[kind, True]["spans"]
    steps = [s for s in got if s.name == "step"]
    assert len(steps) == {"ssl": SSL_STEPS, "videomae_pretrain": VMAE_STEPS,
                          "vtt": VTT_STEPS}.get(kind, 2)
    for st in steps:
        assert st.thread == MAIN
        # the step is outermost, its children do not nest
        assert not [s for s in got if st in _children(got, s)]
        assert [s.name for s in _children(got, st)] == STEP_CHILDREN
    # one process: no data group, so no collective span
    assert not [s for s in got if s.name == "grad_allreduce"]
    assert runs[kind, False]["spans"] == []


@pytest.mark.parametrize("kind", KINDS)
def test_spans_match_the_profiler_ranges(runs, kind):
    run = runs[kind, True]
    mine = collections.defaultdict(list)
    for s in run["spans"]:
        mine[s.name].append((s.start_ns, s.end_ns))
    assert set(mine) == set(run["ranges"])
    for name, got in mine.items():
        want = run["ranges"][name]
        assert len(got) == len(want), name
        for (s0, e0), (s1, e1) in zip(sorted(got), want):
            assert abs(s0 - s1) <= MS and abs(e0 - e1) <= MS, (
                name, (s0 - s1) / MS, (e0 - e1) / MS)


@pytest.mark.parametrize("kind", KINDS)
def test_profiling_changes_no_number(runs, kind):
    off, on = runs[kind, False], runs[kind, True]
    assert on["losses"] == off["losses"]
    assert all(np.isfinite(on["losses"]))
    assert on["params"].keys() == off["params"].keys()
    for k, v in off["params"].items():
        assert torch.equal(on["params"][k], v), k


def test_ssl_loop_waits_once_a_batch(runs):
    got = runs["ssl", True]["spans"]
    steps = [s for s in got if s.name == "step"]
    waits = [s for s in got if s.name == "producer_wait"]
    # one wait a batch, each before its step, on the main thread
    assert len(waits) == SSL_STEPS
    for w, st in zip(waits, steps):
        assert w.thread == MAIN and w.end_ns <= st.start_ns
    # the loop's fetch of the losses is no span
    assert {s.name for s in got} == {"step", "producer_wait", "attention",
                                     *STEP_CHILDREN}


def test_videomae_loop_waits_once_a_batch(runs):
    got = runs["videomae_pretrain", True]["spans"]
    steps = [s for s in got if s.name == "step"]
    waits = [s for s in got if s.name == "producer_wait"]
    assert len(waits) == len(steps) == VMAE_STEPS
    for w, st in zip(waits, steps):
        assert w.thread == MAIN and w.end_ns <= st.start_ns
    assert {s.name for s in got} == {"step", "producer_wait", "attention",
                                     *STEP_CHILDREN}


@pytest.mark.parametrize("kind", VIT_KINDS)
def test_attention_nests_under_forward_once_a_block(runs, kind):
    from video_spike_torch.models.vit_mae import SelfAttention

    run = runs[kind, True]
    got = run["spans"]
    blocks = sum(isinstance(m, SelfAttention)
                 for m in run["model"].modules())
    assert blocks >= 3
    for name in ("forward", "backward"):
        phases = [s for s in got if s.name == name]
        assert phases
        for ph in phases:
            # directly under the phase, once a block, none nested
            kids = _children(got, ph)
            assert [s.name for s in kids] == ["attention"] * blocks, name
            assert all(not _within(got, s) for s in kids)
    attention = [s for s in got if s.name == "attention"]
    assert len(attention) == 2 * blocks * len(
        [s for s in got if s.name == "step"])


# ---------------------------------------------------------------------------
# scripts/profile_torch_step.py
# ---------------------------------------------------------------------------

class _Event:
    def __init__(self, name, device, start, end):
        self._v = name, device, start, end

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def test_profile_tool_counts_the_union_and_the_spans(monkeypatch):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import profile_torch_step as tool
    finally:
        sys.path.remove(str(REPO / "scripts"))
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("vs.step", cpu, 0, 40),
              _Event("vs.step", cuda, 0, 40),       # the range, mirrored
              _Event("gemm", cuda, 0, 10),
              _Event("copy", cuda, 5, 15),          # another stream
              _Event("add", cuda, 20, 25)]
    # key_averages' rows: a kernel, its operator, and the span's range on
    # the host and mirrored on the device track (times in us)
    rows = [types.SimpleNamespace(key=k, device_type=d, count=c,
                                  self_device_time_total=t,
                                  cpu_time_total=h)
            for k, d, c, t, h in (("vs.step", cpu, 1, 0.0, 40e-3),
                                  ("vs.step", cuda, 1, 40e-3, 0.0),
                                  ("aten::mm", cpu, 1, 10e-3, 2e-3),
                                  ("gemm", cuda, 1, 10e-3, 0.0),
                                  ("copy", cuda, 1, 10e-3, 0.0),
                                  ("add", cuda, 1, 5e-3, 0.0))]
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            events=lambda: events)),
        key_averages=lambda: rows)
    assert tool.device_busy_s(prof) == pytest.approx(20e-9)
    got = tool.summarize(prof, 40e-9, 1, "step")
    assert got["device_busy_share"] == pytest.approx(0.5)
    assert got["device_ms_per_step"] == pytest.approx(25e-6)
    assert got["kernel_launches_per_step"] == 3
    assert [k[0] for k in got["top_kernels"]] == ["gemm", "copy", "add"]
    assert [k[0] for k in got["top_ops"]] == ["aten::mm"]
    assert tool.span_ms(prof, 1) == {"vs.step": pytest.approx(40e-6)}
    # the spans' host ms a step, children included, from the profiler's
    # rows of their ranges
    with _profiler() as real:
        for _ in range(2):
            with spans.span("step"):
                with spans.span("forward"):
                    pass
    spans.clear()
    got = tool.span_ms(real, 2)
    assert list(got) == ["vs.forward", "vs.step"]
    assert 0 < got["vs.forward"] <= got["vs.step"]
