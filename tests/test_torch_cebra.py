"""PyTorch port of the CEBRA embedder and PCA (``models/cebra.py``,
``cli/use_cebra.py``, ``cli/unify_cebra.py``) against the JAX package.

The same numpy inputs, made from a seed, go through both packages; the
port's encoder holds the JAX init through ``video_spike_torch.convert``.
``jax.random`` streams cannot be reproduced in torch, so steps are driven at
injected indices and a fit is held by its statistics. Tolerances (float32):

- the encoder forward and ``transform`` (edge padding included): rtol 1e-5,
  atol 1e-6;
- the loss at fixed indices rtol 1e-5; its gradients rtol 1e-4, atol 1e-7;
- 20 Adam steps on a fixed index schedule against ``optax.adam``: params
  rtol 1e-4, atol 1e-6, losses rtol 1e-4;
- PCA on both branches up to a sign per column: atol 1e-4;
- the CLIs: the same files, keys and shapes; the PCA values up to a sign
  per column within 1e-4 of the largest value.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_spike_tpu.models import cebra as jcebra
from video_spike_tpu.ops.contrastive import info_nce as j_info_nce
from video_spike_torch.convert import (flax_to_torch, load_into_model,
                                       torch_to_flax)
from video_spike_torch.models import cebra as tcebra

torch.set_num_threads(1)

D, UNITS, OUT = 40, 32, 3


def _latent_series(n=1200, d=D, seed=0):
    """tests/test_cebra.py's series: a slow 2-D latent mixed into d
    channels, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    latent = np.stack([np.sin(2 * np.pi * t / 200),
                       np.cos(2 * np.pi * t / 317)], axis=1)
    mix = rng.normal(size=(2, d))
    return (latent @ mix + 0.1 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX encoder, its init as numpy, the port encoder holding it)."""
    jm = jcebra.Offset10Encoder(UNITS, OUT)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 10, D))))
    tm = tcebra.Offset10Encoder(D, UNITS, OUT)
    load_into_model(tm, flax_to_torch(params))
    return jm, params, tm


def _indices(seed, n_steps, bs, n):
    rng = np.random.default_rng(seed)
    max_start = n - tcebra.RECEPTIVE_FIELD - 10 - 1
    return (rng.integers(0, max_start, (n_steps, bs)),
            rng.integers(1, 11, (n_steps, bs)),
            rng.integers(0, max_start, (n_steps, bs)))


def _jax_loss(jm, jc):
    def loss(params, X, anchor, delta, negi):
        ref = jm.apply(params, jc._windows(X, anchor))[:, 0]
        pos = jm.apply(params, jc._windows(X, anchor + delta))[:, 0]
        neg = jm.apply(params, jc._windows(X, negi))[:, 0]
        return j_info_nce(ref, pos, neg, 1.0)["loss"]
    return loss


def _port_cebra(tm, **kw):
    c = tcebra.CEBRA(output_dimension=OUT, num_units=UNITS, device="cpu",
                     **kw)
    c.model = tm
    return c


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# encoder, loss, steps
# ---------------------------------------------------------------------------

def test_param_tree_converts_as_is(pair):
    """``convert`` carries the encoder tree both ways, bit for bit."""
    _, params, tm = pair
    names = {k: tuple(v.shape) for k, v in flax_to_torch(params).items()}
    assert names == {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert names["Conv_0.kernel"] == (2, D, UNITS)
    assert names["Conv_4.kernel"] == (3, UNITS, OUT)
    back = torch_to_flax(dict(tm.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("b,t", [(4, 10), (2, 23)])
def test_encoder_forward_matches_flax(pair, b, t):
    jm, params, tm = pair
    x = np.random.default_rng(1).normal(size=(b, t, D)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == (b, t - 9, OUT)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_init_distribution():
    """flax's lecun_normal over k·in (truncated at 2 std), zero biases."""
    tm = tcebra.Offset10Encoder(400, 64, OUT)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    k = tm.Conv_0.kernel.detach().numpy()
    assert abs(k.std() * np.sqrt(2 * 400) - 1.0) < 0.02
    assert np.abs(k).max() <= 2 / np.sqrt(2 * 400) / 0.8796256610342398 + 1e-6
    assert all(float(getattr(tm, f"Conv_{i}").bias.detach().abs().max()) == 0
               for i in range(5))


def test_loss_and_grads_at_fixed_indices(pair):
    jm, params, tm = pair
    X = _latent_series(300)
    a, dl, ng = (v[0] for v in _indices(2, 1, 64, len(X)))
    jc = jcebra.CEBRA(output_dimension=OUT)
    jl, jg = jax.value_and_grad(_jax_loss(jm, jc))(
        params, jnp.asarray(X), jnp.asarray(a), jnp.asarray(dl),
        jnp.asarray(ng))
    c = _port_cebra(tm)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flax_to_torch(params).items()}
    tl = c.loss(leaves, _t(X), _t(a), _t(dl), _t(ng))
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = flax_to_torch(jax.device_get(jg))
    for name, g in zip(leaves, tg):
        np.testing.assert_allclose(g.numpy(), jflat[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_windows_match(pair):
    X = _latent_series(100)
    idx = np.array([0, 5, 79], np.int64)
    got = tcebra.CEBRA._windows(_t(X), _t(idx)).numpy()
    want = np.asarray(jcebra.CEBRA(output_dimension=OUT)._windows(
        jnp.asarray(X), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)


def test_adam_steps_match_optax(pair):
    jm, params, tm = pair
    X = _latent_series(400)
    steps, bs = 20, 32
    A, DL, NG = _indices(3, steps, bs, len(X))
    jc = jcebra.CEBRA(output_dimension=OUT)
    tx = optax.adam(3e-4)
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss(jm, jc)))
    jp, js, jlosses = params, tx.init(params), []
    for i in range(steps):
        loss, g = grad_fn(jp, jnp.asarray(X), jnp.asarray(A[i]),
                          jnp.asarray(DL[i]), jnp.asarray(NG[i]))
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(loss))

    c = _port_cebra(tm)
    tp = flax_to_torch(params)
    ts = c.tx.init(tp)
    tlosses = []
    for i in range(steps):
        tp, ts, loss = c.step(tp, ts, _t(X), _t(A[i]), _t(DL[i]), _t(NG[i]))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    want = flax_to_torch(jax.device_get(jp))
    for k, v in tp.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert ts["count"] == steps


def test_transform_matches_jax(pair):
    """Same params through both transforms: the edge rows are the
    replicate-padded windows of the series' ends."""
    jm, params, tm = pair
    X = _latent_series(57)
    jc = jcebra.CEBRA(output_dimension=OUT)
    jc.params = params
    want = jc.transform(X)
    c = _port_cebra(tm)
    c.params = flax_to_torch(params)
    got = c.transform(X)
    assert got.shape == (57, OUT)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def fitted():
    X = _latent_series()
    model = tcebra.CEBRA(output_dimension=3, max_iterations=600,
                         batch_size=128, device="cpu")
    model.fit(X)
    return model, X


def test_fit_statistics(fitted):
    """tests/test_cebra.py's checks on a fit from a torch.Generator."""
    model, X = fitted
    emb = model.transform(X)
    assert emb.shape == (1200, 3)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-4)
    assert len(model.losses_) == 6          # iterations 0, 100, ..., 500
    assert all(np.isfinite(model.losses_))
    assert model.losses_[-1] < model.losses_[0] - 0.1, model.losses_
    d_neighbor = np.linalg.norm(emb[1:] - emb[:-1], axis=1).mean()
    perm = np.random.default_rng(0).permutation(len(emb))
    d_random = np.linalg.norm(emb[perm] - emb, axis=1).mean()
    assert d_neighbor < 0.5 * d_random, (d_neighbor, d_random)
    assert model.fit_seconds_ > 0


def test_fit_is_seeded():
    X = _latent_series(300)
    runs = [tcebra.CEBRA(max_iterations=5, batch_size=16, device="cpu",
                         seed=s).fit(X).params for s in (0, 0, 1)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])
    assert not torch.equal(runs[0]["Conv_4.kernel"], runs[2]["Conv_4.kernel"])


def test_fit_rejects_short_series():
    with pytest.raises(AssertionError, match="too short"):
        tcebra.CEBRA(device="cpu").fit(np.zeros((22, 3), np.float32))


# ---------------------------------------------------------------------------
# PCA and the video wrappers
# ---------------------------------------------------------------------------

def _assert_equal_up_to_sign(got, want, atol):
    assert got.shape == want.shape
    g = got.reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    for k in range(g.shape[1]):
        err = min(np.abs(g[:, k] - w[:, k]).max(),
                  np.abs(g[:, k] + w[:, k]).max())
        assert err <= atol, (k, err)


@pytest.mark.parametrize("shape,branch", [((4, 30, 1, 8, 10), "covariance"),
                                          ((2, 20, 1, 8, 10), "gram")])
def test_pca_matches_jax(shape, branch):
    video = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    m, d = shape[0] * shape[1], shape[3] * shape[4]
    assert (m <= d) == (branch == "gram")
    want = np.asarray(jcebra.get_pca_embedding(video, out_dim=3))
    got = tcebra.get_pca_embedding(video, out_dim=3, device="cpu")
    assert got.dtype == np.float32
    _assert_equal_up_to_sign(got, want, 1e-4)


def test_get_cebra_embedding_video_shape(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    video = np.random.default_rng(5).integers(
        0, 255, (3, 60, 1, 8, 8)).astype(np.float32)
    emb = tcebra.get_cebra_embedding(video, out_dim=3, max_iterations=20,
                                     batch_size=32, save_path="t",
                                     device="cpu")
    assert emb.shape == (3, 60, 3)
    assert os.path.exists("t_loss.png") and os.path.exists("t_embedding.png")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcebra.CEBRA()
    with pytest.raises(RuntimeError, match="cuda"):
        tcebra.get_pca_embedding(np.zeros((1, 4, 1, 2, 2), np.float32))


# ---------------------------------------------------------------------------
# CLIs against the JAX package's
# ---------------------------------------------------------------------------

EID = "cebrasess0"


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """A 12-trial session whose whisker crop is cut to 16 x 24 (d = 384) so
    the CPU fit stays short; 11 train + test trials = 1,320 frames > d, so
    the CLI's PCA takes the covariance branch."""
    from video_spike_torch.cli import make_fixture
    from video_spike_torch.data import synthetic

    root = tmp_path_factory.mktemp("cebra_cli")
    mp = pytest.MonkeyPatch()
    mp.setattr(synthetic, "WHISKER_H", 16)
    mp.setattr(synthetic, "WHISKER_W", 24)
    try:
        make_fixture.main(["--out", str(root / "fx"), "--eid", EID,
                           "--n_trials", "12", "--n_neurons", "7",
                           "--height", "16", "--width", "16"])
    finally:
        mp.undo()
    return root


def _cli_args(root):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return ["--eid", EID, "--data_dir", str(root / "fx"),
            "--model_config", os.path.join(repo, "configs/model/linear_me.yaml"),
            "--train_config", os.path.join(repo, "configs/train/rrr.yaml")]


def _run_both(root, tag, extra, monkeypatch):
    """Run the JAX CLI and the port's, each in its own working dir."""
    from video_spike_tpu.cli import use_cebra as j_use
    from video_spike_torch.cli import use_cebra as t_use

    out = {}
    for name, run in (("jax", lambda a: j_use.main(a)),
                      ("torch", lambda a: t_use.main(a + ["--device",
                                                          "cpu"]))):
        wd = root / f"{name}_{tag}"
        wd.mkdir()
        monkeypatch.chdir(wd)
        out[name] = (wd, run(_cli_args(root) + extra))
    return out


def test_use_cebra_cli_matches_jax(fixture_dir, monkeypatch):
    from video_spike_torch.cli import train_rrr
    from video_spike_torch.cli import unify_cebra as t_unify
    from video_spike_tpu.cli import unify_cebra as j_unify

    runs = _run_both(fixture_dir, "cebra", ["--max_iterations", "20"],
                     monkeypatch)
    (jwd, jpath), (twd, tres) = runs["jax"], runs["torch"]
    assert tres["path"] == jpath == f"data/data_rrr_cebra_{EID[:5]}.npy"
    assert len(tres["losses"]) == 1 and np.isfinite(tres["losses"][0])
    j = np.load(jwd / jpath, allow_pickle=True).item()
    t = np.load(twd / tres["path"], allow_pickle=True).item()
    assert set(t) == set(j) == {EID}
    assert set(t[EID]) == set(j[EID]) == {"X", "y", "setup"}
    for key in ("X", "y"):
        assert [a.shape for a in t[EID][key]] == \
            [a.shape for a in j[EID][key]]
    assert t[EID]["X"][0].shape[-1] == 5
    for a, b in zip(t[EID]["y"], j[EID]["y"]):
        np.testing.assert_array_equal(a, b)
    for wd in (jwd, twd):
        assert (wd / f"cebra_{EID[:5]}_loss.png").exists()
        assert (wd / f"cebra_{EID[:5]}_embedding.png").exists()

    # unify, then RRR on the merged embedding (the port's main path)
    merged = {}
    for name, unify, wd in (("jax", j_unify, jwd), ("torch", t_unify, twd)):
        monkeypatch.chdir(wd)
        path = unify.main(["--label", "cebra"])
        assert path == "data/data_rrr_cebra.npy"
        merged[name] = np.load(wd / path, allow_pickle=True).item()
    assert set(merged["torch"]) == set(merged["jax"]) == {EID}
    monkeypatch.chdir(twd)
    result = train_rrr.main(["--input_mod", "cebra", "--device", "cpu"]
                            + _cli_args(fixture_dir)[4:])
    assert np.isfinite(np.nanmean(result[EID]["co_bps"]))


def test_use_cebra_pca_cli_matches_jax(fixture_dir, monkeypatch):
    runs = _run_both(fixture_dir, "pca", ["--use_pca"], monkeypatch)
    (jwd, jpath), (twd, tres) = runs["jax"], runs["torch"]
    assert tres["path"] == jpath == f"data/data_rrr_pca_{EID[:5]}.npy"
    assert tres["model"] is None
    j = np.load(jwd / jpath, allow_pickle=True).item()[EID]
    t = np.load(twd / tres["path"], allow_pickle=True).item()[EID]
    scale = max(np.abs(a).max() for a in j["X"])
    for a, b in zip(t["X"], j["X"]):
        _assert_equal_up_to_sign(a, np.asarray(b), 1e-4 * scale)
    assert not list(twd.glob("*.png"))


def test_use_cebra_save_path_none_writes_no_figure(fixture_dir, monkeypatch):
    from video_spike_torch.cli import use_cebra as t_use

    wd = fixture_dir / "nofig"
    wd.mkdir()
    monkeypatch.chdir(wd)
    res = t_use.main(_cli_args(fixture_dir) + ["--max_iterations", "2",
                                               "--device", "cpu"],
                     save_path=None)
    assert (wd / res["path"]).exists()
    assert not list(wd.glob("*.png"))
