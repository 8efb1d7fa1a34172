"""PyTorch port of the dense optical flow (``ops/flow.py``) against the JAX
package.

The same numpy frames, made from a seed, go through both packages on the
CPU (JAX at ``jax_default_matmul_precision`` "highest"). Tolerances
(float32):

- ``farneback_flow`` on textured pairs: max |Δ| ≤ 1e-4 px, at 1 and 3
  pyramid levels and at odd sizes; its pieces (the banded separable
  correlation, ``poly_exp``, the pyramid's downscale, the clamped warp, one
  iteration) within 1e-4 of JAX's on 0–255 pixel values;
- ``get_optic_flow``: ``of``, ``of-2d`` and ``me`` within atol 1e-4 of
  JAX's, the raw field within 1e-3 of its largest value; against OpenCV at
  ``tests/test_flow.py``'s atol (0.15 and 0.2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from video_spike_tpu.ops import flow as jflow
from video_spike_torch.ops import flow as tflow

torch.set_num_threads(1)

FLOW_ATOL = 1e-4


def _textured_frame(rng, h=64, w=64):
    """Smooth random texture with enough gradient for flow estimation."""
    img = ndimage.gaussian_filter(rng.normal(size=(h, w)), 3)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.float32)


def _shift(img, dx, dy):
    """``img`` moved by (dx, dy) px, bilinear, reflected at the border."""
    return ndimage.shift(img, (dy, dx), order=1,
                         mode="reflect").astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,w,dx,dy", [
    (64, 64, 1.5, -0.8),     # 3 levels
    (63, 95, 2.0, 0.5),      # odd sizes through the resizes
    (40, 60, -1.0, 1.0),     # the smallest ROI with 3 levels
    (10, 15, 0.7, 0.3),      # 1 level
])
def test_farneback_matches_jax(h, w, dx, dy):
    rng = np.random.default_rng(h * w)
    f1 = _textured_frame(rng, h, w)
    f2 = _shift(f1, dx, dy)
    ref = np.asarray(jflow.farneback_flow(f1, f2))
    got = tflow.farneback_flow(_t(f1), _t(f2)).numpy()
    assert got.shape == ref.shape == (h, w, 2)
    err = np.abs(got - ref).max()
    assert err <= FLOW_ATOL, (err, np.abs(ref).max())


@pytest.mark.parametrize("dx,dy", [(2.0, 0.0), (0.0, -1.5), (1.0, 1.0)])
def test_flow_recovers_translation(rng, dx, dy):
    """tests/test_flow.py's cases on the port: the interior median is the
    true shift."""
    f1 = _textured_frame(rng)
    f2 = _shift(f1, dx, dy)
    flow = tflow.farneback_flow(_t(f1), _t(f2)).numpy()
    inner = flow[16:-16, 16:-16]
    assert abs(np.median(inner[..., 0]) - dx) < 0.3, np.median(inner[..., 0])
    assert abs(np.median(inner[..., 1]) - dy) < 0.3, np.median(inner[..., 1])


def test_batch_equals_single_pairs(rng):
    """(B, H, W) pairs in one batch give each pair's own field."""
    frames = np.stack([_shift(_textured_frame(rng, 40, 60), 0.5 * i, -0.3 * i)
                       for i in range(4)])
    batch = tflow.farneback_flow(_t(frames[:-1]), _t(frames[1:])).numpy()
    assert batch.shape == (3, 40, 60, 2)
    for i in range(3):
        one = tflow.farneback_flow(_t(frames[i]), _t(frames[i + 1])).numpy()
        np.testing.assert_allclose(batch[i], one, rtol=0, atol=1e-5)


def test_band_is_replicate_correlation(rng):
    """The banded matrix is np.pad(mode='edge') + a 'valid' correlation."""
    v = rng.normal(size=13).astype(np.float32)
    k = rng.normal(size=7).astype(np.float32)
    ref = np.correlate(np.pad(v, 3, mode="edge"), k, mode="valid")
    np.testing.assert_allclose(tflow._band(13, k) @ v, ref, rtol=1e-5,
                               atol=1e-5)


def _pieces(h, w):
    rng = np.random.default_rng(5)
    f1 = _textured_frame(rng, h, w)
    f2 = _shift(f1, 1.2, -0.7)
    return f1, f2


def _j_poly(img):
    A, b = jflow.poly_exp(jnp.asarray(img))
    A, b = np.asarray(A), np.asarray(b)
    return [A[..., 0, 0], A[..., 0, 1], A[..., 1, 1], b[..., 0], b[..., 1]]


@pytest.mark.parametrize("piece", ["sepconv", "poly_exp", "downscale",
                                   "warp", "iteration"])
def test_pieces_match_jax(piece):
    f1, f2 = _pieces(33, 47)
    if piece == "sepconv":
        g = tflow._poly_exp_kernels(5, 1.2)[0]
        k = np.linspace(-1, 2, 15)
        ref = np.asarray(jflow._sepconv(jnp.asarray(f1), g, k))
        mats = tflow._upload(tflow._sep_mats(33, 47, [g], [k]), "cpu")
        got = tflow._sepconv(_t(f1), *mats).numpy()
    elif piece == "poly_exp":
        ref = np.stack(_j_poly(f1))
        got = torch.stack(tflow.poly_exp(_t(f1))).numpy()
    elif piece == "downscale":
        ref = np.asarray(jflow._downscale(jnp.asarray(f1), 0.5))
        g = tflow._pyr_kernel(0.5)
        mats = tflow._upload(tflow._sep_mats(33, 47, [g], [g]), "cpu")
        # banker's rounding of 16.5, as in JAX
        got = tflow._downscale(_t(f1)[None], mats, (16, 24))[0].numpy()
    else:
        # a flow that reaches past every border, so the clamps bite
        rng = np.random.default_rng(9)
        flow = rng.uniform(-40, 40, (33, 47, 2)).astype(np.float32)
        tfl = _t(flow.transpose(2, 0, 1))[None]
        if piece == "warp":
            field = rng.normal(size=(33, 47, 3)).astype(np.float32)
            ref = np.asarray(jflow._bilinear_warp(jnp.asarray(field),
                                                  jnp.asarray(flow)))
            got = tflow._bilinear_warp(_t(field.transpose(2, 0, 1))[None],
                                       tfl)[0].numpy().transpose(1, 2, 0)
        else:
            flow = flow / 20                # a plausible displacement
            A1, b1 = jflow.poly_exp(jnp.asarray(f1))
            A2, b2 = jflow.poly_exp(jnp.asarray(f2))
            ref = np.asarray(jflow._flow_iteration(A1, b1, A2, b2,
                                                   jnp.asarray(flow), 15))
            e1 = tflow.poly_exp(_t(f1)[None])
            e2 = tflow.poly_exp(_t(f2)[None])
            box = np.ones(15, np.float32) / 15
            mats = tflow._upload(tflow._sep_mats(33, 47, [box], [box]), "cpu")
            got = tflow._flow_iteration(e1, e2, tfl / 20, mats)[0].numpy()
            got = got.transpose(1, 2, 0)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= FLOW_ATOL * max(1.0, np.abs(ref).max() / 255), err


def _moving_video(rng, t=12, h=48, w=48):
    """tests/test_flow.py's video: sinusoidally varying motion, so the
    min-max-normalized features have a well-conditioned range."""
    base = _textured_frame(rng, h, w)
    pos = np.cumsum(1.5 * np.sin(np.arange(t) / 2.0))
    return np.stack([_shift(base, pos[i], -0.5 * pos[i]) for i in range(t)])


def test_get_optic_flow_matches_jax(rng):
    video = _moving_video(rng)
    ref = jflow.get_optic_flow(video, backend="jax")
    got = tflow.get_optic_flow(video, device="cpu")
    assert set(got) == set(ref) == {"of", "of-2d", "of-video", "me"}
    for k in ("of", "of-2d", "me"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=FLOW_ATOL,
                                   err_msg=k)
    assert got["of-video"].shape == (11, 48, 48, 2)
    rel = (np.abs(got["of-video"] - ref["of-video"]).max()
           / np.abs(ref["of-video"]).max())
    assert rel <= 1e-3, rel


def test_get_optic_flow_close_to_cv2(rng):
    """The torch backend against OpenCV's Farneback, at tests/test_flow.py's
    atol; the port's cv2 backend is the JAX package's cv2 backend."""
    pytest.importorskip("cv2")
    video = _moving_video(rng)
    feats = tflow.get_optic_flow(video, device="cpu")
    for k in ("of", "me"):
        assert feats[k].min() >= 0 and feats[k].max() <= 1
    ref = tflow.get_optic_flow(video, backend="cv2")
    np.testing.assert_allclose(feats["of"], ref["of"], atol=0.15)
    np.testing.assert_allclose(feats["of-2d"], ref["of-2d"], atol=0.2)
    jref = jflow.get_optic_flow(video, backend="cv2")
    for k in ref:
        np.testing.assert_array_equal(ref[k], jref[k])


def test_device_and_backend_checks(rng):
    video = _moving_video(rng, t=3, h=16, w=16)
    with pytest.raises(ValueError, match="backend"):
        tflow.get_optic_flow(video, backend="jax", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tflow.get_optic_flow(video, device=device)
