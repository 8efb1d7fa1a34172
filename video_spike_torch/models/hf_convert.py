"""Filling ``VideoMAEProbe``'s backbone from a checkpoint on disk.

Counterpart of ``video_spike_tpu/models/hf_convert.py`` (the reference
loads ``MCG-NJU/videomae-base``, ``src/model/videomae.py:8``). Parameters
are the port's flat dicts (``{"video_mae.encoder.Block_0...": tensor}``):

- :func:`convert_hf_videomae` translates a state dict with HF VideoMAE
  names (``videomae.embeddings...``, ``encoder.layer.{i}...``) into the
  flat numpy dict of ``VideoMAEBackbone(hf_compat=True)``: the Conv3d
  (out, in, kT, kH, kW) kernel becomes (kT, kH, kW, in, out), q/k/v are
  concatenated into ``qkv`` with the key bias pinned to zero, and torch's
  (out, in) Linear weights become (in, out) kernels;
- :func:`graft_backbone_into_probe` replaces the probe's ``video_mae.*``
  leaves, checking the names and every shape first;
- :func:`load_pretrained_into_probe` reads the port's own ``backbone.pt``
  (written by ``cli/pretrain_videomae.py``), an HF ``state_dict``
  (``.bin`` / ``.pt`` / ``.pth``) or an ``.npz`` with HF names.

The JAX package's pretraining writes an orbax directory, which the port
cannot read (it imports no orbax); ``convert.py`` turns that flax tree into
the port's ``.pt`` on a host with JAX. No network access happens anywhere:
weights must already be on disk.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

BACKBONE_PREFIX = "video_mae."


def _t(w) -> np.ndarray:
    """torch tensor / array -> numpy float32."""
    if hasattr(w, "detach"):
        w = w.detach().float().cpu().numpy()
    return np.asarray(w, dtype=np.float32)


def convert_hf_videomae(state_dict: Mapping, num_layers: int,
                        prefix: str = "") -> Dict[str, np.ndarray]:
    """HF VideoMAE(Model) state dict -> ``VideoMAEBackbone(hf_compat=True)``
    parameters, flat (``patch_embed.Conv_0.kernel``, ``encoder.Block_0...``).

    ``prefix`` strips a leading scope, e.g. ``"videomae."`` for a
    ``VideoMAEForPreTraining`` state dict."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}

    def get(name):
        if name not in sd:
            raise KeyError(f"missing {prefix}{name} in state_dict; have e.g. "
                           f"{sorted(sd)[:5]}")
        return _t(sd[name])

    conv_w = get("embeddings.patch_embeddings.projection.weight")
    out = {"patch_embed.Conv_0.kernel": np.transpose(conv_w, (2, 3, 4, 1, 0)),
           "patch_embed.Conv_0.bias":
               get("embeddings.patch_embeddings.projection.bias")}
    for i in range(num_layers):
        base = f"encoder.layer.{i}."
        wq = get(base + "attention.attention.query.weight")
        wk = get(base + "attention.attention.key.weight")
        wv = get(base + "attention.attention.value.weight")
        hidden = wq.shape[1]
        zeros = np.zeros(hidden, np.float32)
        # HF VideoMAE: query and value carry biases, the key bias is zero
        bq = (_t(sd[base + "attention.attention.q_bias"])
              if base + "attention.attention.q_bias" in sd else zeros)
        bv = (_t(sd[base + "attention.attention.v_bias"])
              if base + "attention.attention.v_bias" in sd else zeros)
        blk = f"encoder.Block_{i}."
        out.update({
            blk + "LayerNorm_0.scale": get(base + "layernorm_before.weight"),
            blk + "LayerNorm_0.bias": get(base + "layernorm_before.bias"),
            blk + "SelfAttention_0.qkv.kernel":
                np.concatenate([wq.T, wk.T, wv.T], axis=1),
            blk + "SelfAttention_0.qkv.bias": np.concatenate([bq, zeros, bv]),
            blk + "SelfAttention_0.proj.kernel":
                get(base + "attention.output.dense.weight").T,
            blk + "SelfAttention_0.proj.bias":
                get(base + "attention.output.dense.bias"),
            blk + "LayerNorm_1.scale": get(base + "layernorm_after.weight"),
            blk + "LayerNorm_1.bias": get(base + "layernorm_after.bias"),
            blk + "Dense_0.kernel": get(base + "intermediate.dense.weight").T,
            blk + "Dense_0.bias": get(base + "intermediate.dense.bias"),
            blk + "Dense_1.kernel": get(base + "output.dense.weight").T,
            blk + "Dense_1.bias": get(base + "output.dense.bias"),
        })
    return out


def graft_backbone_into_probe(probe_params: Mapping[str, torch.Tensor],
                              backbone: Mapping) -> Dict[str, torch.Tensor]:
    """Probe params with every ``video_mae.*`` leaf replaced by the
    backbone's (names relative to the backbone), cast to the probe leaf's
    dtype and device; the names and each shape must match."""
    target = {k[len(BACKBONE_PREFIX):]: v for k, v in probe_params.items()
              if k.startswith(BACKBONE_PREFIX)}
    if set(target) != set(backbone):
        differ = sorted(set(target) ^ set(backbone))
        raise ValueError(f"backbone tree does not match the probe backbone "
                         f"(hf_compat mismatch? differing keys: {differ[:4]})")
    for name, leaf in target.items():
        if tuple(leaf.shape) != tuple(np.shape(backbone[name])):
            raise ValueError(f"shape mismatch at {name}: probe "
                             f"{tuple(leaf.shape)} vs checkpoint "
                             f"{tuple(np.shape(backbone[name]))}")
    out = dict(probe_params)
    for name, leaf in target.items():
        src = backbone[name]
        src = src if isinstance(src, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(src))
        out[BACKBONE_PREFIX + name] = src.to(device=leaf.device,
                                             dtype=leaf.dtype)
    return out


def load_pretrained_into_probe(probe_params: Mapping[str, torch.Tensor],
                               path: str) -> Dict[str, torch.Tensor]:
    """Fill the probe's backbone from ``path``: the port's ``backbone.pt``
    (``{"params": {name: tensor}}`` of ``VideoMAEForPreTraining``), an HF
    state dict file or an ``.npz`` with HF names."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            f"package?); the port reads .pt files: on a host with JAX run "
            f"`python scripts/convert_jax_checkpoint.py {path}`, which "
            f"writes {path.rstrip('/')}.pt beside it")
    if path.endswith(".npz"):
        sd = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("params"), Mapping):     # the port's backbone.pt
        backbone = {k: v for k, v in sd["params"].items()
                    if k.startswith(("patch_embed.", "encoder."))}
        return graft_backbone_into_probe(probe_params, backbone)
    depth = len({k.split(".")[2] for k in probe_params
                 if k.startswith(BACKBONE_PREFIX + "encoder.Block_")})
    prefix = ("videomae." if any(k.startswith("videomae.") for k in sd)
              else "")
    return graft_backbone_into_probe(
        probe_params, convert_hf_videomae(sd, num_layers=depth, prefix=prefix))
