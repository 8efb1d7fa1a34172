"""The port's VideoMAE masked-video pretraining (``VideoMAEForPreTraining``
with ``mask_type: tube`` and ``norm_pix_loss``, driven by
``cli/pretrain_videomae.py``'s ``make_step``) against the benchmark's
plain reference, ``benchmark/reference/videomae_base_pretrain.py``, loaded
by path.

At a small size (trials of 12 gray 24 x 24 frames, 4 kept and resized to
32, tubelets 2 x 8 x 8: 32 tokens, 8 of them visible; a 64-wide encoder of
2 layers, a 32-wide decoder of 1) from the same seeded weights (made by
the benchmark's ``benchlib/weights.py`` from the reference's
``param_specs``, which also checks that the leaves agree) and the same
masking seed:

- float32: the loss within 1e-5 relative; every gradient within 1e-5 of
  its leaf's largest element (the two sum in other orders); after one
  AdamW step, every parameter whose gradient is well above Adam's eps and
  the leaf's rounding within an f32 ulp at 1.0 (1.2e-7) of the
  reference's, and every other within two learning rates;
- bfloat16 (the port's compute dtype) against the float32 reference: the
  loss within 2e-3 relative (it reads 1.3e-4) and every gradient's gap
  within 5e-2 of the larger of its own norm and the median leaf's (it
  reads at most 1.35e-2: bf16 keeps 8 bits of mantissa, a relative
  rounding of 3.9e-3 a cast, over a dozen casts on the way; the key bias,
  whose gradient is zero but for rounding, is held by the same floor);
- tube masking keeps whole tubes: at the published size (8 slots of 196
  positions) every slot hides the same 176 positions, 160 of 1,568
  tokens are visible, and the mask is the reference's for the same seed;
- the normalized-pixel target of one tubelet equals a hand computation:
  each channel's 512 pixels of [0, 1] frames less their mean over their
  unbiased standard deviation plus 1e-6, in (pixel, channel) order.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_spike_torch.cli import pretrain_videomae as cli
from video_spike_torch.models import videomae as tvmae
from video_spike_torch.ops.optim import AdamW

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import plain, weights  # noqa: E402

torch.set_num_threads(1)

DECODER = dict(decoder_hidden_size=32, decoder_num_hidden_layers=1,
               decoder_num_attention_heads=4, decoder_intermediate_size=64)
MODEL = dict(image_size=32, patch_size=8, num_channels=3, num_frames=4,
             tubelet_size=2, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             mask_type="tube", norm_pix_loss=True)
CFG = {"config": {
    "model": dict(MODEL, **DECODER, hidden_act="gelu_pytorch_tanh",
                  layer_norm_eps=1e-12, initializer_range=0.02,
                  mask_ratio=0.75),
    "optimizer": {"lr": 5e-5, "wd": 0.01, "eps": 1e-8}}}
CLIPS, FRAMES, SIDE = 3, 12, 24
SEED, MASK_SEED = 2 ** 31 + 7, 1234567


def _reference():
    path = BENCH / "reference" / "videomae_base_pretrain.py"
    spec = importlib.util.spec_from_file_location("vmae_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def _trials() -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (CLIPS, FRAMES, 1, SIDE, SIDE),
                        dtype=np.uint8)


def _port(dtype):
    """The port's model in ``dtype`` with the benchmark's weights for
    ``SEED``: (model, params, the weights on the host)."""
    model = tvmae.VideoMAEForPreTraining(MODEL, dtype=dtype, **DECODER)
    params = {k: p.detach() for k, p in model.named_parameters()}
    made = weights.make(REF.param_specs(CFG), REF.store_dtype(CFG), SEED,
                        torch.device("cpu"))
    return model, params, weights.load(params, made)


def _port_loss_and_grads(model, params, trials):
    """The CLI's forward on the host's 4-of-12 subsample: loss and every
    gradient."""
    video = torch.from_numpy(
        trials[:, cli.frame_indices(FRAMES, MODEL["num_frames"])])
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = tvmae.preprocess_frames(video, MODEL["num_frames"],
                                MODEL["image_size"], source_frames=4)
    gen = torch.Generator().manual_seed(MASK_SEED)
    out = torch.func.functional_call(model, leaves, (x,),
                                     {"mask_ratio": 0.75, "generator": gen})
    names = list(leaves)
    grads = torch.autograd.grad(out["recon_loss"],
                                [leaves[k] for k in names])
    return float(out["recon_loss"].detach()), dict(zip(names, grads))


def _reference_loss_and_grads(p0):
    with plain.exact_f32():
        ref = REF.Model(CFG, "f32", torch.device("cpu"))
        return REF.step_grads(ref, {k: v.clone() for k, v in p0.items()},
                              _trials(), MASK_SEED)


def test_float32_loss_and_every_gradient_match_the_reference():
    model, params, p0 = _port(torch.float32)
    loss, grads = _port_loss_and_grads(model, params, _trials())
    ref_loss, ref_grads = _reference_loss_and_grads(p0)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert grads.keys() == ref_grads.keys()
    for k, g in grads.items():
        scale = float(ref_grads[k].abs().max())
        torch.testing.assert_close(g, ref_grads[k], rtol=0,
                                   atol=1e-5 * max(scale, 1e-12),
                                   msg=k)


def test_float32_adamw_step_matches_the_reference():
    model, params, p0 = _port(torch.float32)
    tx = AdamW(5e-5, weight_decay=0.01)
    step = cli.make_step(model, tx, MODEL["num_frames"],
                         MODEL["image_size"], 0.75)
    video = torch.from_numpy(
        _trials()[:, cli.frame_indices(FRAMES, MODEL["num_frames"])])
    new, _, loss = step(params, tx.init(params), video,
                        torch.Generator().manual_seed(MASK_SEED))
    want = REF.reference_steps(CFG, None, p0, [(_trials(), MASK_SEED)],
                               None, torch.device("cpu"))
    assert float(loss) == pytest.approx(want["losses"][0], rel=1e-5)
    with plain.exact_f32():
        _, ref_grads = _reference_loss_and_grads(p0)
        upd = plain.AdamW(0.01).update(ref_grads, p0, 5e-5)
    for k, p in new.items():
        want_k = p0[k] + upd[k]
        g = ref_grads[k].abs()
        # where |g| is near Adam's eps, or cancels to rounding (the key
        # bias), the first step lr g / (|g| + eps) follows the rounding of
        # g; elsewhere it is lr times g's sign, and the two agree to the
        # rounding of p + u (an f32 ulp at 1.0)
        sound = g >= max(1e-3 * float(g.max()), 1e-6)
        assert (p - want_k).abs().max() <= 2 * 5e-5, k
        torch.testing.assert_close(p[sound], want_k[sound], rtol=0,
                                   atol=1.2e-7)


def test_bfloat16_is_within_its_bound_of_the_float32_reference():
    model, params, p0 = _port(torch.bfloat16)
    loss, grads = _port_loss_and_grads(model, params, _trials())
    ref_loss, ref_grads = _reference_loss_and_grads(p0)
    assert loss == pytest.approx(ref_loss, rel=2e-3)
    ref_norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    median = float(np.median(list(ref_norms.values())))
    for k, g in grads.items():
        gap = float((g.float() - ref_grads[k]).norm())
        assert gap <= 5e-2 * max(ref_norms[k], median), (k, gap,
                                                        ref_norms[k])


def test_tube_masking_keeps_whole_tubes_at_the_published_size():
    slots, spatial = 8, 196
    x = torch.arange(2 * slots * spatial, dtype=torch.float32).reshape(
        2, slots * spatial, 1)
    gen = torch.Generator().manual_seed(MASK_SEED)
    visible, mask, ids_restore = tvmae.tube_masking(x, 0.9, slots, gen)
    assert visible.shape == (2, 160, 1)
    by_slot = mask.reshape(2, slots, spatial)
    assert torch.equal(by_slot, by_slot[:, :1].expand_as(by_slot))
    assert by_slot[:, 0].sum(dim=1).tolist() == [176.0, 176.0]
    # the visible tokens are the kept positions in every slot, in order
    for b in range(2):
        kept = (by_slot[b, 0] == 0).nonzero()[:, 0]
        want = torch.cat([t * spatial + kept for t in range(slots)])
        assert torch.equal(visible[b, :, 0].long() - b * slots * spatial,
                           want)
    # ids_restore puts the visible and the masked tokens back in order
    order = torch.cat([visible[..., 0], torch.full((2, 1408), -1.0)], 1)
    back = torch.gather(order, 1, ids_restore)
    assert torch.equal(back[mask == 0], x[..., 0][mask == 0])
    # the reference draws the same tubes from the same seed
    ref = REF.Model({"config": {"model": dict(
        CFG["config"]["model"], image_size=224, patch_size=16,
        num_frames=16, mask_ratio=0.9)}}, "f32", torch.device("cpu"))
    assert torch.equal(ref.mask(2, MASK_SEED), mask.bool())


def test_normalized_pixel_target_of_one_tubelet():
    rng = np.random.default_rng(3)
    frames = rng.random((1, 2, 3, 16, 16)).astype(np.float32)    # [0, 1]
    mean = tvmae.IMAGENET_MEAN.reshape(1, 1, 3, 1, 1)
    std = tvmae.IMAGENET_STD.reshape(1, 1, 3, 1, 1)
    video = torch.from_numpy((frames - mean) / std)
    got = tvmae.normalized_tubelets(video, 2, 16)
    assert got.shape == (1, 1, 2 * 16 * 16 * 3)
    want = np.empty((512, 3))
    for c in range(3):
        px = frames[0, :, c].astype(np.float64).reshape(-1)  # (t, h, w)
        want[:, c] = (px - px.mean()) / (px.std(ddof=1) + 1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(), want.reshape(-1),
                               rtol=0, atol=2e-5)
