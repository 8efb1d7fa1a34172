"""PyTorch port of the Linear model, converter, loss, metrics and data path
against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; weights go
from the flax tree to the port through ``video_spike_torch.convert``.
Tolerances:

- converter round trip and data path: exact;
- ``LinearModel`` forward: rtol 1e-5 in f32 compute (matmul summation
  order), within 2 bf16 ulps of the output scale in bf16 compute (each layer
  rounds its matmul once; XLA and torch may round a different element);
- loss and metrics: rtol 1e-5 (float32 reductions in another order); bits
  per spike also abs 1e-5, since it is a difference of two float32 NLL
  sums that cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_spike_tpu.data import dataset as jdataset
from video_spike_tpu.data import synthetic as jsynthetic
from video_spike_tpu.models.linear import LinearModel as JLinear
from video_spike_tpu.ops import metrics as jmetrics
from video_spike_tpu.ops.poisson import poisson_nll_mean as j_nll_mean
from video_spike_torch.convert import (
    flax_to_torch,
    load_into_model,
    to_numpy,
    torch_to_flax,
)
from video_spike_torch.data import dataset as tdataset
from video_spike_torch.data import synthetic as tsynthetic
from video_spike_torch.models.linear import LinearModel as TLinear
from video_spike_torch.ops import metrics as tmetrics
from video_spike_torch.ops.poisson import poisson_nll_mean as t_nll_mean

torch.set_num_threads(1)

B = 8
IN_SHAPE = (B, 5, 1, 16, 16)
WIDTHS = dict(encoder_hidden=(128, 32), encoder_out=16,
              decoder_hidden=(32, 256), output_dim=100 * 6)


def _models(compute):
    jdt = jnp.float32 if compute == "float32" else jnp.bfloat16
    tdt = torch.float32 if compute == "float32" else torch.bfloat16
    jm = JLinear(**WIDTHS, compute_dtype=jdt)
    tm = TLinear(input_dim=int(np.prod(IN_SHAPE[1:])), **WIDTHS,
                 compute_dtype=tdt)
    x = np.random.default_rng(6).integers(0, 255, IN_SHAPE, dtype=np.uint8)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.asarray(x.reshape(B, -1)).astype(jnp.float32))
    return jm, tm, jax.device_get(params), x


def test_converter_round_trip_keeps_bits_and_dtypes():
    _, tm, params, _ = _models("float32")
    # a bf16 store for the big leaves, as the SR trainer keeps them
    params = jax.tree.map(lambda p: np.asarray(jnp.asarray(p).astype(
        jnp.bfloat16)) if p.size >= 1 << 16 else p, params)
    flat = flax_to_torch(params)
    assert set(flat) == {k for k, _ in tm.named_parameters()}
    assert flat["decoder.Dense_2.kernel"].dtype == torch.bfloat16
    assert flat["encoder.Dense_0.bias"].dtype == torch.float32
    back = torch_to_flax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    load_into_model(tm, flat)
    assert tm.decoder.Dense_2.kernel.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        to_numpy(tm.decoder.Dense_2.kernel).view(np.uint16),
        np.asarray(params["params"]["decoder"]["Dense_2"]["kernel"])
        .view(np.uint16))


def test_init_is_lecun_normal_with_zero_bias():
    """flax Dense init: truncated normal at +-2 std, variance 1/fan_in."""
    tm = TLinear(input_dim=4096, encoder_hidden=(512,), encoder_out=16,
                 decoder_hidden=(), output_dim=200)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    k = tm.encoder.Dense_0.kernel.detach().numpy()
    assert k.var() == pytest.approx(1 / 4096, rel=0.02)
    bound = 2 * np.sqrt(1 / 4096) / 0.87962566103423978
    assert np.abs(k).max() <= bound
    assert not tm.encoder.Dense_0.bias.detach().any()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_linear_forward_matches_flax(compute):
    jm, tm, params, x = _models(compute)
    load_into_model(tm, flax_to_torch(params))
    ref = np.asarray(jm.apply(params, jnp.asarray(x.reshape(B, -1))))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (B, 100, 6) and got.dtype == np.float32
    if compute == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 2 * scale * 2.0**-8


def test_poisson_nll_mean_with_n_valid():
    rng = np.random.default_rng(1)
    lr_ = rng.normal(size=(B, 100, 6)).astype(np.float32)
    ap = rng.poisson(1.0, (B, 100, 6)).astype(np.float32)
    for n_valid in (None, B, 5, 1):
        ref = float(j_nll_mean(jnp.asarray(lr_), jnp.asarray(ap),
                               None if n_valid is None
                               else jnp.float32(n_valid)))
        got = float(t_nll_mean(torch.from_numpy(lr_), torch.from_numpy(ap),
                               n_valid))
        assert got == pytest.approx(ref, rel=1e-5), n_valid
    # padded rows do not count
    got5 = float(t_nll_mean(torch.from_numpy(lr_), torch.from_numpy(ap), 5))
    first5 = float(t_nll_mean(torch.from_numpy(lr_[:5]),
                              torch.from_numpy(ap[:5])))
    assert got5 == pytest.approx(first5, rel=1e-6)


def _eval_arrays():
    rng = np.random.default_rng(2)
    log_rates = (rng.normal(size=(7, 100, 6)) * 0.3 - 1).astype(np.float32)
    gt = rng.poisson(0.4, (7, 100, 6)).astype(np.float32)
    gt[:, :, 2] = 0.0            # a zero-spike neuron: bps inf -> NaN
    gt[3] = 0.0                  # a zero-variance trial for R²
    return log_rates, gt


def test_device_eval_metrics_match_jax():
    log_rates, gt = _eval_arrays()
    bps_j, r2_j = jmetrics.device_eval_metrics(jnp.asarray(log_rates),
                                               jnp.asarray(gt))
    bps_t, r2_t = tmetrics.device_eval_metrics(torch.from_numpy(log_rates),
                                               torch.from_numpy(gt))
    assert np.isfinite(float(bps_t)) and np.isfinite(float(r2_t))
    assert float(bps_t) == pytest.approx(float(bps_j), rel=1e-5, abs=1e-5)
    assert float(r2_t) == pytest.approx(float(r2_j), rel=1e-5)
    per_j = jmetrics.bits_per_spike_per_neuron(jnp.exp(log_rates),
                                               jnp.asarray(gt))
    per_t = tmetrics.bits_per_spike_per_neuron(
        torch.exp(torch.from_numpy(log_rates)), torch.from_numpy(gt))
    np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-5,
                               atol=1e-5)
    assert np.isinf(per_t[2].item())


@pytest.mark.filterwarnings("ignore:divide by zero:RuntimeWarning")
def test_metrics_list_matches_jax_and_light_path():
    log_rates, gt = _eval_arrays()
    preds = np.exp(log_rates)
    args = (np.swapaxes(gt, 0, -1), np.swapaxes(preds, 0, -1))
    for use_device in (True, False):
        ref = jmetrics.metrics_list(*args, use_device=use_device)
        got = tmetrics.metrics_list(*args, use_device=use_device)
        assert set(got) == set(ref)
        for k in got:
            assert got[k] == pytest.approx(ref[k], rel=1e-5,
                                           abs=1e-5), (use_device, k)
    # the device path agrees with the host dispatcher
    bps_t, r2_t = tmetrics.device_eval_metrics(torch.from_numpy(log_rates),
                                               torch.from_numpy(gt))
    host = tmetrics.metrics_list(*args)
    assert float(bps_t) == pytest.approx(host["bps"], rel=1e-5, abs=1e-5)
    assert float(r2_t) == pytest.approx(host["rsquared"], rel=1e-5)


def test_fixture_and_split_identical_to_jax(tmp_path):
    kw = dict(eid="cmpeid000", n_trials=10, n_neurons=6, seed=3,
              height=32, width=32)
    jfiles = jsynthetic.make_synthetic_session(tmp_path / "j", **kw)
    tfiles = tsynthetic.make_synthetic_session(tmp_path / "t", **kw)
    for a, b in zip(jfiles, tfiles):
        sa = jdataset.read_trial_tar(a)
        sb = tdataset.read_trial_tar(b)
        for k in ("ap", "video", "whisker-motion-energy", "timestamp"):
            np.testing.assert_array_equal(sa[k], sb[k])
    sj = jdataset.split_dataset(tmp_path / "j", "cmpeid000", seed=42)
    st = tdataset.split_dataset(tmp_path / "t", "cmpeid000", seed=42)
    for part in ("train", "val", "test"):
        assert [p.split("/")[-1] for p in sj[part]] == \
            [p.split("/")[-1] for p in st[part]]
    assert st["eid"] == sj["eid"]
