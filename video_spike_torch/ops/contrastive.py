"""Contrastive losses: stabilized InfoNCE, CEBRA-style criteria, NCE, CLIP.

Counterpart of ``video_spike_tpu/ops/contrastive.py`` (reference
``src/utils/loss_utils.py``) as plain torch ops:

- ``info_nce`` — the numerically stabilized InfoNCE of the SSL trainer
  (``loss_utils.py:409-431``): the row max of the negative similarities is
  subtracted, detached, before the logsumexp;
- ``dot_similarity`` / ``euclidean_similarity`` — the CEBRA similarity
  measures (``loss_utils.py:80-122``);
- ``infonce_from_dists`` — align + uniformity decomposition
  (``loss_utils.py:125-151``);
- ``nce_loss`` — Gutmann-Hyvarinen NCE (``loss_utils.py:351-386``);
- ``clip_contrastive_loss`` — CLIP's symmetric cross-entropy;
- ``loss_fn_`` — the output-dict dispatcher the SSL trainer calls
  (``loss_utils.py:3-21``): MAE-only / contrast + recon / InfoNCE.

Similarity matrices are float32 products of the embeddings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def dot_similarity(ref: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) ref·pos similarities and (n, n) ref·neg similarities."""
    pos_dist = (ref * pos).sum(dim=-1)
    neg_dist = ref.float() @ neg.float().T
    return pos_dist, neg_dist


def euclidean_similarity(ref: torch.Tensor, pos: torch.Tensor,
                         neg: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Negative squared L2 similarities (CEBRA convention)."""
    ref_sq = (ref * ref).sum(dim=-1)
    pos_sq = (pos * pos).sum(dim=-1)
    neg_sq = (neg * neg).sum(dim=-1)
    pos_cos, neg_cos = dot_similarity(ref, pos, neg)
    pos_dist = -(ref_sq + pos_sq - 2 * pos_cos)
    neg_dist = -(ref_sq[:, None] + neg_sq[None, :] - 2 * neg_cos)
    return pos_dist, neg_dist


def infonce_from_dists(pos_dist: torch.Tensor, neg_dist: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, align, uniform) from precomputed similarities."""
    align = (-pos_dist).mean()
    uniform = torch.logsumexp(neg_dist, dim=1).mean()
    return align + uniform, align, uniform


def info_nce(ref: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
             tau=1.0) -> Dict[str, torch.Tensor]:
    """Stabilized InfoNCE: subtract the detached row max of the negative
    similarity matrix before the softmax terms; gradients flow through a
    learnable ``tau`` tensor."""
    tau = torch.as_tensor(tau, dtype=torch.float32, device=ref.device)
    pos_dist = (ref * pos).sum(dim=-1) / tau
    neg_dist = (ref.float() @ neg.float().T) / tau
    c = neg_dist.max(dim=1, keepdim=True).values.detach()
    pos_loss = -(pos_dist - c[:, 0]).mean()
    neg_loss = torch.logsumexp(neg_dist - c, dim=1).mean()
    return {"loss": pos_loss + neg_loss, "pos_loss": pos_loss,
            "neg_loss": neg_loss}


def nce_loss(ref: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
             temperature: float = 1.0, negative_weight: float = 1.0,
             reduce: str = "mean"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noise contrastive estimation (per-sample, like the reference's NCE)."""
    pos_dist = (ref * pos).sum(dim=-1) / temperature
    neg_dist = (ref @ neg.T) / temperature
    align = F.logsigmoid(pos_dist)
    terms = F.logsigmoid(-neg_dist)
    uniform = terms.mean(dim=1) if reduce == "mean" else terms.sum(dim=1)
    return align + negative_weight * uniform, align, uniform


def clip_contrastive_loss(similarity_matrix: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP symmetric cross-entropy over a square similarity matrix
    (reference ``metric_utils.py:26-34``). Returns (loss, top-1 accuracy)."""
    n = similarity_matrix.shape[0]
    labels = torch.arange(n, device=similarity_matrix.device)
    logprobs_i = torch.log_softmax(similarity_matrix, dim=1)
    logprobs_t = torch.log_softmax(similarity_matrix.T, dim=1)
    loss_i = -logprobs_i[labels, labels].mean()
    loss_t = -logprobs_t[labels, labels].mean()
    top1 = (similarity_matrix.argmax(dim=1) == labels).float().mean()
    return (loss_i + loss_t) / 2, top1


def contrast_recon_loss(ref: Dict, pos: Dict, neg: Dict,
                        fix_temp: bool = True) -> Dict[str, torch.Tensor]:
    """Joint InfoNCE + reconstruction objective (``loss_utils.py:22-36``)."""
    temp = 1.0 if fix_temp else ref["temp"]
    nce = info_nce(ref["z"], pos["z"], neg["z"], temp)
    mean_recon = (ref["recon_loss"] + pos["recon_loss"] + neg["recon_loss"]) / 3
    return {
        "loss": mean_recon + nce["loss"],
        "recon_loss": mean_recon,
        "pos_loss": nce["pos_loss"],
        "neg_loss": nce["neg_loss"],
        "contrast_loss": nce["loss"],
    }


def loss_fn_(ref: Dict, pos: Optional[Dict], neg: Optional[Dict],
             fix_temp: bool = True) -> Dict[str, torch.Tensor]:
    """Dispatch on the model-output dict shape (``loss_utils.py:3-21``):

    - MAE (pos/neg None): pure reconstruction.
    - ContrastViTMAE ('recon_loss' + 'temp'): InfoNCE + reconstruction.
    - ContrastViT ('z' + 'temp'): InfoNCE (optionally learnable temperature).
    - 'z' + 'recon_loss' (no temp): mean reconstruction across the triplet.
    """
    if pos is None and neg is None:
        return {"loss": ref["recon_loss"]}
    if "recon_loss" in ref and "temp" in ref:
        return contrast_recon_loss(ref, pos, neg, fix_temp)
    if "z" in ref and "temp" in ref:
        tau = 1.0 if fix_temp else ref["temp"]
        return info_nce(ref["z"], pos["z"], neg["z"], tau)
    if "z" in ref and "recon_loss" in ref:
        return {"loss": (ref["recon_loss"] + pos["recon_loss"]
                         + neg["recon_loss"]) / 3}
    raise ValueError("Invalid loss input")
