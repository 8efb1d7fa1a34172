"""Dense optical flow (Farneback) in torch, plus the reference's derived
whisker-flow features.

Counterpart of ``video_spike_tpu/ops/flow.py`` (reference
``src/utils/ibl_data_utils.py:1103-1243``, which calls OpenCV's
``calcOpticalFlowFarneback(f1, f2, None, 0.5, 3, 15, 3, 5, 1.2, 0)`` per
frame pair):

- ``of``: mean |flow| with each component clipped to its [10, 90]
  percentile, min-max normalized, last value repeated to T;
- ``of-2d``: per-frame spatial medians of |flow_x| and |flow_y|, min-max
  normalized, (T, 2);
- ``of-video``: the raw (T-1, H, W, 2) field.

The field runs on the device of its inputs, every frame pair of a trial in
one batch (the JAX package vmaps). Each separable correlation is two
matmuls with banded matrices that hold the replicate border, so no
convolution goes through cuDNN, which would round f32 to TF32 by default;
PyTorch's default matmul flags leave f32 alone. The resizes are the
antialiased bilinear ones that match ``jax.image.resize(..., "linear")``,
the warp an explicit index gather with the reference's clamping. The
reductions to features stay numpy on the host, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_spike_torch.core.device import resolve_device


# ---------------------------------------------------------------------------
# separable correlation as banded matmuls
# ---------------------------------------------------------------------------

def _poly_exp_kernels(n: int, sigma: float):
    """numpy (g, xg, xxg, x): host-side so the Gram scalars equal JAX's."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    return g, xg, xxg, x


def _pyr_kernel(scale: float) -> np.ndarray:
    """The Gaussian a pyramid level is smoothed with before its resize
    (OpenCV's recipe)."""
    sigma = (1.0 / scale - 1.0)
    n = int(round(sigma * 5)) | 1
    x = np.arange(-(n // 2), n // 2 + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _band(n: int, k) -> np.ndarray:
    """(n, n) f32 matrix M with ``(M @ v)[i] = sum_j k[j] v[clip(i+j-r)]``:
    the 'same' correlation of a length-n axis with replicate borders (the
    taps that fall past an edge add onto the edge sample)."""
    k = np.asarray(k, np.float32).astype(np.float64)
    r = (len(k) - 1) // 2
    rows = np.arange(n)
    m = np.zeros((n, n), np.float64)
    for j, kj in enumerate(k):
        np.add.at(m, (rows, np.clip(rows + j - r, 0, n - 1)), kj)
    return m.astype(np.float32)


def _sep_mats(h: int, w: int, kvs, khs) -> Tuple[np.ndarray, np.ndarray]:
    """Host (mv, mh) for ``mv @ img @ mh``: the vertical kernels ``kvs``
    stacked as (len(kvs)·h, h), the horizontal ``khs`` side by side as
    (w, len(khs)·w)."""
    return (np.concatenate([_band(h, k) for k in kvs]),
            np.concatenate([_band(w, k).T for k in khs], axis=1))


def _upload(arrays, device) -> list:
    """Host arrays as tensors on ``device``, in one transfer: a copy from
    pageable host memory waits for the device's queue to drain."""
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    parts = flat.to(device).split([a.size for a in arrays])
    return [t.view(a.shape) for t, a in zip(parts, arrays)]


def _sepconv(img: torch.Tensor, mv: torch.Tensor,
             mh: torch.Tensor) -> torch.Tensor:
    """Separable 'same' correlation with replicate borders over the last two
    axes of ``img`` (..., H, W), through ``_sep_mats``' matrices."""
    return mv @ img @ mh


def _expand(img: torch.Tensor, mv: torch.Tensor, mh: torch.Tensor,
            n: int = 5, sigma: float = 1.2) -> Tuple[torch.Tensor, ...]:
    """``poly_exp`` with its matrices (``_sep_mats`` of (g, xg, xxg) both
    ways) already on the device."""
    g, xg, xxg, x = _poly_exp_kernels(n, sigma)
    h, w = img.shape[-2:]
    # the six moment projections m_pq = sum w * x^p y^q * f in two matmuls:
    # the three vertical kernels stacked, then the three horizontal ones
    m = _sepconv(img, mv, mh)                          # (..., 3H, 3W)
    m = m.unflatten(-1, (3, w)).unflatten(-3, (3, h))  # (..., 3, H, 3, W)

    def proj(v, hz):                                   # vertical, horizontal
        return m[..., v, :, hz, :]

    m00, m10, m01 = proj(0, 0), proj(0, 1), proj(1, 0)     # x = horizontal
    m20, m02, m11 = proj(0, 2), proj(2, 0), proj(1, 1)

    # Gram entries of the weighted basis (1, x, y, x^2, y^2, xy): separable
    # Gaussian weights leave only (1, x^2, y^2) coupled
    s0 = g.sum()
    s2 = (g * x * x).sum()
    s4 = (g * x ** 4).sum()
    i_11, i_1x2, i_x2x2 = s0 * s0, s2 * s0, s4 * s0
    i_x2y2 = i_xyxy = s2 * s2
    i_xx = s2 * s0
    minv = np.linalg.inv(np.array([[i_11, i_1x2, i_1x2],
                                   [i_1x2, i_x2x2, i_x2y2],
                                   [i_1x2, i_x2y2, i_x2x2]]))
    c = minv.astype(np.float32).tolist()     # JAX's f32 Minv, as scalars
    a_xx = c[1][0] * m00 + c[1][1] * m20 + c[1][2] * m02
    a_yy = c[2][0] * m00 + c[2][1] * m20 + c[2][2] * m02
    b_x = m10 / i_xx
    b_y = m01 / i_xx
    a_xy = m11 / i_xyxy / 2
    return a_xx, a_xy, a_yy, b_x, b_y


def poly_exp(img: torch.Tensor, n: int = 5, sigma: float = 1.2
             ) -> Tuple[torch.Tensor, ...]:
    """Quadratic expansion coefficients per pixel of ``img`` (..., H, W).

    Returns (a_xx, a_xy, a_yy, b_x, b_y), each (..., H, W): the symmetric
    A = [[a_xx, a_xy], [a_xy, a_yy]] and b of the local model
    f(x+dx) ~ dx'A dx + b'dx + c, least-squares fit under the Gaussian
    applicability. (JAX's ``A`` holds ``a_xy`` at both off-diagonal places,
    already halved.)
    """
    ks = _poly_exp_kernels(n, sigma)[:3]
    mats = _upload(_sep_mats(*img.shape[-2:], ks, ks), img.device)
    return _expand(img, *mats, n, sigma)


# ---------------------------------------------------------------------------
# displacement estimation
# ---------------------------------------------------------------------------

def _bilinear_warp(field: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample ``field`` (B, C, H, W) at x + flow, flow (B, 2, H, W) in
    (x, y) order, with the reference's clamped bilinear lookup: the
    coordinate is clamped first, then ``x0 + 1`` to ``W - 1``."""
    b, c, h, w = field.shape
    dev = field.device
    xx = torch.arange(w, dtype=torch.float32, device=dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    sx = torch.clamp(xx + flow[:, 0], 0.0, w - 1.0)
    sy = torch.clamp(yy + flow[:, 1], 0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    flat = field.reshape(b, c, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    v00, v01, v10, v11 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _flow_iteration(exp1, exp2, flow: torch.Tensor, box) -> torch.Tensor:
    """One Farneback displacement update. ``exp1``/``exp2``: the
    ``poly_exp`` tuples of the two frames; ``flow`` (B, 2, H, W); ``box``:
    the device (mv, mh) of the window's box filter."""
    a1xx, a1xy, a1yy, b1x, b1y = exp1
    w2 = _bilinear_warp(torch.stack(exp2, dim=1), flow)
    a2xx, a2xy, a2yy, b2x, b2y = w2.unbind(1)
    a00 = 0.5 * (a1xx + a2xx)
    a01 = 0.5 * (a1xy + a2xy)                  # = a10: A is symmetric
    a11 = 0.5 * (a1yy + a2yy)
    fx, fy = flow[:, 0], flow[:, 1]
    # db = -(b2(x+d) - b1(x))/2 + A d  (normal-equation right-hand side)
    db0 = -0.5 * (b2x - b1x) + (a00 * fx + a01 * fy)
    db1 = -0.5 * (b2y - b1y) + (a01 * fx + a11 * fy)

    # G = A'A and h = A'db, window-averaged (box, flags=0)
    g11, g12, g22, h1, h2 = _sepconv(torch.stack([
        a00 * a00 + a01 * a01,
        a00 * a01 + a01 * a11,
        a01 * a01 + a11 * a11,
        a00 * db0 + a01 * db1,
        a01 * db0 + a11 * db1], dim=1), *box).unbind(1)

    det = g11 * g22 - g12 * g12
    det = torch.where(det.abs() < 1e-9, 1e-9, det)
    new_x = (g22 * h1 - g12 * h2) / det
    new_y = (g11 * h2 - g12 * h1) / det
    return torch.stack([new_x, new_y], dim=1)


def _resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` over the last two axes of
    (N, C, H, W): half-pixel centres, antialiased when an axis shrinks."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


def _downscale(img: torch.Tensor, smooth, size: Tuple[int, int]
               ) -> torch.Tensor:
    """One pyramid level of ``img`` (N, H, W): the Gaussian ``smooth``
    (device (mv, mh) of ``_pyr_kernel``), then the resize to ``size``."""
    return _resize(_sepconv(img, *smooth)[:, None], size)[:, 0]


def farneback_flow(prev: torch.Tensor, nxt: torch.Tensor,
                   pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3, poly_n: int = 5,
                   poly_sigma: float = 1.2) -> torch.Tensor:
    """Dense flow from ``prev`` to ``nxt`` (grayscale images, (B, H, W) or
    one (H, W) pair) on their device: (B, H, W, 2), or (H, W, 2), in
    (x, y) order."""
    single = prev.dim() == 2
    prev = prev.float().reshape(-1, *prev.shape[-2:])
    nxt = nxt.float().reshape(-1, *nxt.shape[-2:])
    b = prev.shape[0]

    # the level sizes, then every level's matrices in one transfer
    sizes = [tuple(prev.shape[-2:])]
    for _ in range(levels - 1):
        h, w = sizes[-1]
        if min(h, w) * pyr_scale < max(poly_n * 2, 8):
            break
        sizes.append((max(int(round(h * pyr_scale)), 2),
                      max(int(round(w * pyr_scale)), 2)))
    ks = _poly_exp_kernels(poly_n, poly_sigma)[:3]
    box = [np.ones((winsize,), np.float32) / winsize]
    smooth = [_pyr_kernel(pyr_scale)]
    host = []
    for h, w in sizes:
        host += [*_sep_mats(h, w, ks, ks), *_sep_mats(h, w, box, box),
                 *_sep_mats(h, w, smooth, smooth)]
    mats = _upload(host, prev.device)
    # a level's (mv, mh) pairs: the expansion's, the window's box filter's
    # and the smoothing before its downscale
    ops = [{"poly": mats[i:i + 2], "box": mats[i + 2:i + 4],
            "smooth": mats[i + 4:i + 6]} for i in range(0, len(mats), 6)]

    # both frames of every pair go through the pyramid and the expansion
    # as one batch
    pyramid = [torch.cat([prev, nxt])]
    for i in range(1, len(sizes)):
        pyramid.append(_downscale(pyramid[-1], ops[i - 1]["smooth"],
                                  sizes[i]))

    flow = prev.new_zeros((b, 2, *sizes[-1]))
    for pq, op in zip(reversed(pyramid), reversed(ops)):
        size = tuple(pq.shape[-2:])
        if tuple(flow.shape[-2:]) != size:
            scale_x = size[1] / flow.shape[-1]
            scale_y = size[0] / flow.shape[-2]
            flow = _resize(flow, size)
            flow[:, 0] *= scale_x
            flow[:, 1] *= scale_y
        coeffs = _expand(pq, *op["poly"], poly_n, poly_sigma)
        exp1 = tuple(c[:b] for c in coeffs)
        exp2 = tuple(c[b:] for c in coeffs)
        for _ in range(iterations):
            flow = _flow_iteration(exp1, exp2, flow, op["box"])
    flow = flow.permute(0, 2, 3, 1)
    return flow[0] if single else flow


def _minmax(v: np.ndarray) -> np.ndarray:
    lo, hi = np.min(v), np.max(v)
    return (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)


def get_optic_flow(video: np.ndarray, backend: str = "torch",
                   device=None) -> Dict:
    """Per-trial flow features with the reference's reductions.

    ``video``: (T, H, W) grayscale. Returns {'of', 'of-2d', 'of-video',
    'me'} (the reference also computes frame-difference motion energy
    inline). ``backend``: 'torch' runs the T-1 frame pairs as one batch on
    ``device`` (the card unless the caller asks for the CPU); 'cv2' runs
    OpenCV's Farneback on the host.
    """
    video = np.asarray(video, dtype=np.float32)
    me = np.mean(np.abs(np.diff(video, axis=0)), axis=(1, 2))
    me = _minmax(me)

    if backend == "cv2":
        import cv2
        fields = np.stack([
            cv2.calcOpticalFlowFarneback(video[i], video[i + 1], None,
                                         0.5, 3, 15, 3, 5, 1.2, 0)
            for i in range(len(video) - 1)], axis=0)
    elif backend == "torch":
        frames = torch.from_numpy(video).to(
            resolve_device("cuda" if device is None else device))
        fields = farneback_flow(frames[:-1], frames[1:]).cpu().numpy()
    else:
        raise ValueError(f"flow backend {backend!r}: 'torch' or 'cv2'")

    raw = fields.copy()
    absf = np.abs(fields)
    vec_x_med = _minmax(np.median(absf[..., 0], axis=(1, 2)))
    vec_y_med = _minmax(np.median(absf[..., 1], axis=(1, 2)))
    clip = absf.copy()
    for c in range(2):
        clip[..., c] = np.clip(clip[..., c],
                               np.percentile(clip[..., c], 10),
                               np.percentile(clip[..., c], 90))
    clip_of = _minmax(np.mean(clip, axis=(1, 2, 3)))

    rep = lambda v: np.append(v, v[-1])
    return {
        "of": rep(clip_of),
        "of-2d": np.stack([rep(vec_x_med), rep(vec_y_med)], axis=1),
        "of-video": raw,
        "me": rep(me),
    }
