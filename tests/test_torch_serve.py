"""PyTorch port of the serving stack (``serve/{session,batcher,http}.py``,
``cli/serve.py``) against the JAX package.

The port's ``InferenceSession`` and the JAX one hold the same params of a
tiny float32 ``LinearModel`` (converted from the flax init) and take the
same numpy rows, made from a seed. Tolerances: the Linear model rtol 1e-5,
atol 1e-6 (float32 summation order); the bf16 VTT atol 5e-3, as
``tests/test_serve.py`` holds its own session to the direct forward.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from video_spike_tpu.models.linear import LinearModel as JLinear
from video_spike_tpu.serve import InferenceSession as JSession
from video_spike_torch.convert import flax_to_torch
from video_spike_torch.models.linear import LinearModel as TLinear
from video_spike_torch.serve import InferenceSession, MicroBatcher, serve_http

torch.set_num_threads(1)

N_FEAT, T_BINS, N_NEURONS = 24, 10, 4
BUCKETS = (1, 2, 4, 8)
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_linear(output_dim=T_BINS * N_NEURONS, t_bins=T_BINS):
    jm = JLinear(encoder_hidden=(16,), encoder_out=8, decoder_hidden=(),
                 output_dim=output_dim, t_bins=t_bins,
                 compute_dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, N_FEAT), jnp.float32)))
    return jm, params


def _port_linear(output_dim=T_BINS * N_NEURONS, t_bins=T_BINS):
    return TLinear(N_FEAT, (16,), 8, (), output_dim, t_bins=t_bins,
                   compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def sessions():
    """(the port's session, the JAX session) over the same params."""
    jm, params = _jax_linear()
    return (InferenceSession(_port_linear(), flax_to_torch(params),
                             bucket_sizes=BUCKETS, device="cpu"),
            JSession(jm, params, bucket_sizes=BUCKETS))


def _rows(seed, n):
    return np.random.default_rng(seed).normal(
        size=(n, N_FEAT)).astype(np.float32)


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 5])
def test_predict_matches_jax_session(sessions, n):
    ts, js = sessions
    x = _rows(n, n)
    before_t, before_j = ts.stats["padded_rows"], js.stats["padded_rows"]
    got = ts.predict(x)
    want = js.predict(x)
    assert got.dtype == np.float32 and got.shape == (n, T_BINS, N_NEURONS)
    np.testing.assert_allclose(got, want, **TOL)
    pad = {1: 0, 3: 1, 5: 3}[n]
    assert ts.stats["padded_rows"] - before_t == pad
    assert js.stats["padded_rows"] - before_j == pad


def test_padding_is_stripped_and_rows_independent(sessions):
    """A padded batch gives each row what it gets alone (the pad copies the
    last row and never leaks into the output)."""
    ts, _ = sessions
    x = _rows(11, 3)
    alone = np.concatenate([ts.predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(ts.predict(x), alone, **TOL)


def test_bucket_reuse_counts_first_runs_only():
    jm, params = _jax_linear()
    ts = InferenceSession(_port_linear(), flax_to_torch(params),
                          bucket_sizes=BUCKETS, device="cpu")
    assert ts.stats == {"requests": 0, "padded_rows": 0, "compiles": 0}
    for n in (3, 4, 2, 3):          # buckets 4, 4, 2, 4
        ts.predict(_rows(n, n))
    assert ts.stats == {"requests": 4, "padded_rows": 2, "compiles": 2}
    ts.warmup(_rows(0, 1)[0])
    assert ts.stats["compiles"] == len(BUCKETS)


def test_batch_above_largest_bucket_rejected(sessions):
    with pytest.raises(ValueError, match="largest bucket"):
        sessions[0].predict(np.zeros((9, N_FEAT), np.float32))


def test_predict_rejects_empty_batch(sessions):
    with pytest.raises(ValueError, match="empty batch"):
        sessions[0].predict(np.zeros((0, N_FEAT), np.float32))


def test_mesh_not_ported():
    """``mesh=`` takes any rules (the name dates from when a split of any
    kernel but the first raised): on the one-rank mesh the port's session
    under the first-layer rules, under rules that split every kernel by
    rows, and under rules that split every leaf (the biases, which no
    split Dense runs split, are gathered and listed) serves what the JAX
    session serves under the same rules on a {data: 1, model: 2} mesh;
    ``sharding_rules`` without a mesh is ignored, as in the JAX session."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from video_spike_tpu.parallel.mesh import make_mesh as jax_mesh
    from video_spike_torch.models.linear import first_layer_sharding_rules
    from video_spike_torch.parallel.mesh import Placement, make_mesh

    jm, params = _jax_linear()
    x = _rows(11, 3)
    jmesh = jax_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    mesh = make_mesh()

    def split(kernels_only):
        def port(p, m):
            return {k: Placement(m, "model" if k.endswith("kernel")
                                 or not kernels_only else None) for k in p}

        def jax_rules(p, m):
            return jax.tree_util.tree_map_with_path(
                lambda path, leaf: NamedSharding(m, P("model") if (
                    str(path[-1].key) == "kernel" or not kernels_only)
                    else P()), p)
        return port, jax_rules

    first = lambda p, m: first_layer_sharding_rules(p, m, min_dim=N_FEAT)
    cases = [({"mesh": mesh, "sharding_rules": first}, None, []),
             ({"mesh": mesh}, None, []), ({"sharding_rules": first}, None,
                                          None)]
    for kernels_only in (True, False):
        port, jax_rules = split(kernels_only)
        biases = [] if kernels_only else sorted(
            f"{m}.Dense_{i}.bias" for m, n in (("encoder", 2),
                                                ("decoder", 1))
            for i in range(n))
        cases.append(({"mesh": mesh, "sharding_rules": port}, jax_rules,
                      biases))
    for kw, jax_rules, gathered in cases:
        want = JSession(jm, params, bucket_sizes=BUCKETS, **(
            {"mesh": jmesh, "sharding_rules": jax_rules} if jax_rules
            else {})).predict(x)
        ts = InferenceSession(_port_linear(), flax_to_torch(params),
                              bucket_sizes=BUCKETS, device="cpu", **kw)
        np.testing.assert_allclose(ts.predict(x), want, **TOL)
        got = ts.stats.get("gathered_leaves")
        assert (got if got is None else sorted(got)) == gathered, kw


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, params = _jax_linear()
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceSession(_port_linear(), flax_to_torch(params))


def test_session_ids_path_pads_and_matches_jax():
    """The VTT with session ids given and left out (default 0): 3 rows ride
    the 4-bucket with the last id repeated."""
    from video_spike_tpu.models.vtt import VideoTemporalTransformer as JVTT
    from video_spike_torch.models.vtt import VideoTemporalTransformer as TVTT

    kw = dict(n_sessions=3, max_neurons=10, t_frames=12, t_bins=10,
              patch_size=8, hidden=32, frame_depth=1, temporal_depth=1,
              heads=4, mlp_dim=64)
    jm = JVTT(**kw)
    rng = np.random.default_rng(6)
    video = rng.integers(0, 255, (3, 12, 1, 32, 32), dtype=np.uint8)
    sids = np.asarray([0, 2, 1], np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(video), jnp.asarray(sids)))
    s = InferenceSession(TVTT(**kw, remat=True), flax_to_torch(params),
                         bucket_sizes=(4,), needs_session_ids=True,
                         device="cpu")
    assert not s.model.training and not s.model.remat
    out = s.predict(video, session_ids=sids)
    ref = np.asarray(jm.apply(params, jnp.asarray(video), jnp.asarray(sids)))
    np.testing.assert_allclose(out, ref, atol=5e-3)
    out0 = s.predict(video)
    ref0 = np.asarray(jm.apply(params, jnp.asarray(video),
                               jnp.zeros(3, jnp.int32)))
    np.testing.assert_allclose(out0, ref0, atol=5e-3)
    assert s.stats["padded_rows"] == 2


# ---------------------------------------------------------------------------
# batcher and HTTP
# ---------------------------------------------------------------------------

def test_microbatcher_coalesces_and_matches(sessions):
    ts, _ = sessions
    x = _rows(2, 8)
    direct = ts.predict(x)
    batcher = MicroBatcher(ts.predict, max_batch=8, max_delay_ms=50)
    try:
        futs = [batcher.submit(row) for row in x]
        outs = np.stack([f.result(timeout=10) for f in futs])
        np.testing.assert_allclose(outs, direct, **TOL)
        stats = batcher.stats()
        assert stats["served"] == 8
        assert stats["dispatches"] <= 4
        assert stats["p99_ms"] >= stats["p50_ms"] > 0
    finally:
        batcher.close()


def test_microbatcher_propagates_errors():
    def boom(rows, **kw):
        raise RuntimeError("kaput")

    batcher = MicroBatcher(boom, max_batch=4, max_delay_ms=20)
    try:
        futs = [batcher.submit(np.zeros((3,), np.float32)) for _ in range(3)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="kaput"):
                fut.result(timeout=10)
        assert batcher.stats() == {"served": 0, "dispatches": 0}
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros((3,), np.float32))


class _Server:
    def __init__(self, batcher):
        self.batcher = batcher
        self.server = serve_http(batcher, port=0, host="127.0.0.1",
                                 block=False)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def post(self, arr, headers=None, data=None):
        if data is None:
            buf = io.BytesIO()
            np.save(buf, arr)
            data = buf.getvalue()
        req = urllib.request.Request(f"{self.url}/predict", data=data,
                                     headers=headers or {}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return np.load(io.BytesIO(r.read()))

    def get(self, path):
        with urllib.request.urlopen(f"{self.url}{path}", timeout=10) as r:
            return r.read()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()


def test_http_round_trip(sessions):
    ts, js = sessions
    srv = _Server(MicroBatcher(ts.predict, max_batch=8, max_delay_ms=2))
    try:
        assert srv.get("/healthz") == b"ok"
        row = _rows(3, 1)[0]
        out = srv.post(row)
        np.testing.assert_allclose(out, js.predict(row[None])[0], **TOL)
        assert json.loads(srv.get("/stats"))["served"] >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            srv.post(None, data=b"not-an-npy")
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            srv.get("/nowhere")
        assert ei.value.code == 404
    finally:
        srv.close()


def test_http_unheadered_batch_fans_out(sessions):
    ts, js = sessions
    srv = _Server(MicroBatcher(ts.predict, max_batch=8, max_delay_ms=2,
                               sample_ndim=1))
    try:
        rows = _rows(5, 3)
        out = srv.post(rows)                 # no X-Batched header
        want = js.predict(rows)
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, **TOL)
    finally:
        srv.close()


def test_http_batched_header_single_row(sessions):
    ts, js = sessions
    srv = _Server(MicroBatcher(ts.predict, max_batch=8, max_delay_ms=2))
    try:
        rows = _rows(9, 1)
        out = srv.post(rows, headers={"X-Batched": "1"})
        want = js.predict(rows)
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, **TOL)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A ``model_best.pt`` written by the port's trainer in the production
    configuration (bf16 SR store: the (122,880, 32) first kernel is bf16)."""
    from video_spike_torch.cli import train as train_cli
    from video_spike_torch.data.synthetic import make_synthetic_session
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    d = tmp_path_factory.mktemp("torch_serve")
    make_synthetic_session(d / "data", eid="servesess0", n_trials=10,
                           n_neurons=5, seed=4, height=32, width=32)
    model = yaml.safe_load((repo / "configs/model/linear_video.yaml")
                           .read_text())
    model["encoder"].update(hidden_dims=[32], output_dim=16)
    model["decoder"]["hidden_dims"] = [16]
    (d / "model.yaml").write_text(yaml.safe_dump(model))
    train = yaml.safe_load((repo / "configs/train/linear_video.yaml")
                           .read_text())
    train["optimizer"].update(name="adafactor", param_scale=False,
                              clipping=None, param_dtype="bfloat16_sr",
                              fused_readout=True, fused_min_kernel=1)
    (d / "train.yaml").write_text(yaml.safe_dump(train))
    res = train_cli.main([
        "--model_config", str(d / "model.yaml"),
        "--train_config", str(d / "train.yaml"), "--eid", "servesess0",
        "--data_dir", str(d / "data"), "--log_dir", str(d / "logs"),
        "--num_epochs", "1", "--batch_size", "4", "--device", "cpu"])
    return d, Path(res["log_dir"])


def test_from_checkpoint_of_the_trainer_keeps_bf16(trained):
    from video_spike_torch.core.config import config_from_kwargs, update_config
    from video_spike_torch.models.linear import LinearModel
    from video_spike_torch.train.checkpoint import load_checkpoint

    d, log_dir = trained
    cfg = update_config(config_from_kwargs(
        {"model": f"include:{d / 'model.yaml'}"})).model
    assert cfg["encoder"]["input_dim"] is None       # read off the params
    stored = load_checkpoint(log_dir, "model_best")["params"]
    assert stored["encoder.Dense_0.kernel"].dtype == torch.bfloat16
    video = np.random.default_rng(7).integers(
        0, 255, (3, 120 * 32 * 32), dtype=np.uint8)
    for s in (InferenceSession.from_checkpoint(cfg, log_dir, device="cpu"),
              InferenceSession.from_checkpoint(dict(cfg), log_dir,
                                               sample_input=video[:1],
                                               device="cpu")):
        for k, v in stored.items():
            assert s.params[k].dtype == v.dtype, k
            assert torch.equal(s.params[k], v), k
        # the registry's production (bf16-compute) model on the stored params
        ref = LinearModel(120 * 32 * 32, (32,), 16, (16,), 500)
        for k, p in ref.named_parameters():
            p.data = stored[k]
        with torch.no_grad():
            want = ref(torch.from_numpy(video)).numpy()
        np.testing.assert_array_equal(s.predict(video), want)
        assert s.predict(video).shape == (3, 100, 5)


def test_from_checkpoint_rejects_other_shapes(trained, tmp_path):
    d, log_dir = trained
    cfg = yaml.safe_load((d / "model.yaml").read_text())
    cfg["encoder"]["hidden_dims"] = [8]
    with pytest.raises((KeyError, ValueError)):
        InferenceSession.from_checkpoint(cfg, log_dir, device="cpu")


def test_serve_cli_app_warms_every_bucket(trained):
    from video_spike_torch.cli.serve import make_app

    d, log_dir = trained
    _, session, batcher = make_app([
        "--model_config", str(d / "model.yaml"), "--ckpt_dir", str(log_dir),
        "--input_dim", str(120 * 32 * 32), "--max_batch", "8",
        "--device", "cpu"])
    try:
        assert session.buckets == [1, 2, 4, 8]
        assert session.stats["compiles"] == len(session.buckets)
        out = batcher.submit(np.zeros((120 * 32 * 32,), np.float32)
                             ).result(timeout=30)
        assert out.shape == (100, 5)
        assert batcher.sample_ndim == 1
    finally:
        batcher.close()


def test_serve_cli_defaults_to_cuda(trained):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from video_spike_torch.cli.serve import make_app

    d, log_dir = trained
    with pytest.raises(RuntimeError, match="cuda"):
        make_app(["--model_config", str(d / "model.yaml"),
                  "--ckpt_dir", str(log_dir)])
