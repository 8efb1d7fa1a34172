"""PyTorch port of model export (``serve/export.py``,
``cli/export_model.py``): ``torch.export`` artifacts against the model's
forward and against the JAX package's StableHLO artifact.

Inputs are numpy, made from a seed. Tolerances: float32 models rtol 1e-5,
atol 1e-6 (the port's artifact against its forward, and against the JAX
artifact on the same params); the bf16 VTT against the session's own
forward exactly (the same eager ops at the same batch).
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from video_spike_tpu.models.linear import LinearModel as JLinear
from video_spike_tpu.serve import export as jexport
from video_spike_torch.convert import flax_to_torch
from video_spike_torch.models.linear import LinearModel as TLinear
from video_spike_torch.serve import InferenceSession
from video_spike_torch.serve.export import (export_forward, load_exported,
                                            save_exported)

torch.set_num_threads(1)

N_FEAT = 24
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def linear():
    """(JAX model, flax params, the port model, its converted params)."""
    jm = JLinear(encoder_hidden=(16,), encoder_out=8, decoder_hidden=(),
                 output_dim=100 * 4, compute_dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, N_FEAT), jnp.float32)))
    tm = TLinear(N_FEAT, (16,), 8, (), 400, compute_dtype=torch.float32)
    return jm, params, tm, flax_to_torch(params)


def _rows(seed, n):
    return np.random.default_rng(seed).normal(
        size=(n, N_FEAT)).astype(np.float32)


def _forward(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def test_export_roundtrip_matches_forward(linear, tmp_path):
    _, _, tm, tparams = linear
    sample = _rows(0, 8)
    path = save_exported(tm, tparams, sample, tmp_path / "m.pt2")
    assert zipfile.is_zipfile(path)
    fn = load_exported(path)
    out = fn(sample)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), _forward(tm, sample), **TOL)


def test_export_polymorphic_batch(linear, tmp_path):
    """Exported at 8, one artifact runs at 3 and 5."""
    _, _, tm, tparams = linear
    res = export_forward(tm, tparams, _rows(1, 8))
    assert res.polymorphic
    fn = load_exported(save_exported(tm, tparams, _rows(1, 8),
                                     tmp_path / "p.pt2"))
    assert fn.polymorphic
    for b in (3, 5):
        x = _rows(b, b)
        np.testing.assert_allclose(fn(x).numpy(), _forward(tm, x), **TOL)


def test_static_batch_export(linear, tmp_path):
    _, _, tm, tparams = linear
    assert not export_forward(tm, tparams, _rows(2, 8),
                              polymorphic_batch=False).polymorphic
    fn = load_exported(save_exported(tm, tparams, _rows(2, 8),
                                     tmp_path / "s.pt2",
                                     polymorphic_batch=False))
    assert not fn.polymorphic
    x = _rows(3, 8)
    np.testing.assert_allclose(fn(x).numpy(), _forward(tm, x), **TOL)
    with pytest.raises(Exception):
        fn(_rows(4, 3))


class _FixedBatch(torch.nn.Module):
    """A forward whose trace needs the batch to be 8 (a symbolic batch
    cannot be exported)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(N_FEAT, 2))

    def forward(self, x):
        return (x @ self.w).reshape(8, 2)


def test_symbolic_export_failure_falls_back_to_static(tmp_path):
    m = _FixedBatch()
    params = {"w": torch.full((N_FEAT, 2), 0.5)}
    res = export_forward(m, params, _rows(4, 8))
    assert not res.polymorphic
    fn = load_exported(save_exported(m, params, _rows(4, 8),
                                     tmp_path / "f.pt2"))
    assert not fn.polymorphic
    x = _rows(5, 8)
    np.testing.assert_allclose(fn(x).numpy(), x.sum(1, keepdims=True)
                               .repeat(2, 1) * 0.5, **TOL)


def test_export_with_session_ids(tmp_path):
    """The VTT with per-sample session ids, exported at 8 with a symbolic
    batch, against the session's predict at 3 and 8."""
    from video_spike_torch.models.vtt import VideoTemporalTransformer

    kw = dict(n_sessions=2, max_neurons=10, t_frames=12, t_bins=10,
              patch_size=8, hidden=32, frame_depth=1, temporal_depth=1,
              heads=4, mlp_dim=64)
    init = VideoTemporalTransformer(**kw)
    init.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in init.named_parameters()}
    session = InferenceSession(VideoTemporalTransformer(**kw), params,
                               bucket_sizes=(3, 8), needs_session_ids=True,
                               device="cpu")
    rng = np.random.default_rng(2)
    video = rng.integers(0, 255, (8, 12, 1, 32, 32), dtype=np.uint8)
    sids = rng.integers(0, 2, 8).astype(np.int32)
    path = save_exported(VideoTemporalTransformer(**kw), params, video,
                         tmp_path / "vtt.pt2", session_ids=sids)
    fn = load_exported(path)
    assert fn.polymorphic
    for b in (3, 8):
        out = fn(video[:b], sids[:b].astype(np.int64)).float().numpy()
        np.testing.assert_array_equal(
            out, session.predict(video[:b], session_ids=sids[:b]))


def test_export_matches_jax_stablehlo_artifact(linear, tmp_path):
    """The same f32 params exported by both packages, run on one input."""
    jm, params, tm, tparams = linear
    sample = _rows(6, 8)
    jfn = jexport.load_exported(jexport.save_exported(
        jm, params, sample, tmp_path / "m.stablehlo"))
    tfn = load_exported(save_exported(tm, tparams, sample,
                                      tmp_path / "m.pt2"))
    for b in (3, 8):
        x = _rows(10 + b, b)
        np.testing.assert_allclose(tfn(x).numpy(), np.asarray(jfn(x)),
                                   **TOL)


def test_export_cli(linear, tmp_path):
    from video_spike_torch.cli.export_model import main
    from video_spike_torch.train.checkpoint import save_checkpoint

    _, _, _, tparams = linear
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, "model_best", {"params": tparams, "epoch": 0})
    cfg = tmp_path / "model.yaml"
    cfg.write_text(yaml.safe_dump({
        "model_class": "Linear",
        "encoder": {"hidden_dims": [16], "output_dim": 8},
        "decoder": {"hidden_dims": [], "output_dim": 400}}))
    out = main(["--model_config", str(cfg), "--ckpt_dir", str(ckpt),
                "--input_dim", str(N_FEAT), "--out", str(tmp_path / "m.pt2"),
                "--device", "cpu"])
    with zipfile.ZipFile(out) as z:
        meta = [n for n in z.namelist() if n.endswith("video_spike_torch.json")]
        assert json.loads(z.read(meta[0])) == {"polymorphic": True}
    fn = load_exported(out)
    x = np.zeros((2, N_FEAT), np.float32)
    assert tuple(fn(x).shape) == (2, 100, 4)
    # the registry builds the production bf16-compute model
    session = InferenceSession.from_checkpoint(
        yaml.safe_load(cfg.read_text()), ckpt, device="cpu")
    x = _rows(7, 5)
    np.testing.assert_array_equal(fn(x).float().numpy(), session.predict(x))
    static = main(["--model_config", str(cfg), "--ckpt_dir", str(ckpt),
                   "--input_dim", str(N_FEAT), "--static_batch",
                   "--out", str(tmp_path / "s.pt2"), "--device", "cpu"])
    assert not load_exported(static).polymorphic
    with pytest.raises(SystemExit):
        main(["--model_config", str(cfg), "--ckpt_dir", str(ckpt),
              "--out", str(tmp_path / "x.pt2"), "--device", "cpu"])
