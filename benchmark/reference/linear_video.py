"""Plain reference of ``linear_video``: the LinearModel readout of the
reference repository's ``train.sh`` recipe, written from its definition
(``src/model/linear.py``: an encoder MLP into a decoder MLP over the
flattened video scaled to [0, 1], ReLU between layers, output reshaped to
(B, t_bins, neurons) log-rates) with the Poisson NLL (log input, mean) and
the configuration's production optimizer: optax's adafactor (no parameter
scale, no clipping) under the one-cycle cosine schedule, and a bfloat16
parameter store with stochastic rounding for leaves of at least 2^16
elements. It computes in f32 with TF32 off (or, as the control, with every
matmul's operands in fp8), from the starting parameters the benchmark
makes and gives the program (``param_specs``, ``store_dtype``,
``benchlib/weights.py``), on the same trials. It imports nothing of the
program.

Parameter names follow the model's flat layout (``encoder.Dense_0.kernel``,
an (in, out) kernel used as ``x @ kernel + bias``)."""

from __future__ import annotations

import math

import torch

from benchlib import plain

FIRST_KERNEL = "encoder.Dense_0.kernel"


def _layers(model_cfg: dict):
    enc, dec = model_cfg["encoder"], model_cfg["decoder"]
    for part, d in (("encoder", enc), ("decoder", dec)):
        dims = [d["input_dim"], *d["hidden_dims"], d["output_dim"]]
        for i in range(len(dims) - 1):
            yield part, i, i == len(dims) - 2


def param_specs(cfg: dict) -> dict:
    """The model's leaves and the init the recipe states (flax's
    ``Dense``): ``name -> (shape, init, fan-in)``, lecun_normal kernels and
    zero biases."""
    out = {}
    for part, i, _ in _layers(cfg["config"]["model"]):
        d = cfg["config"]["model"][part]
        dims = [d["input_dim"], *d["hidden_dims"], d["output_dim"]]
        out[f"{part}.Dense_{i}.kernel"] = ((dims[i], dims[i + 1]), "lecun",
                                           dims[i])
        out[f"{part}.Dense_{i}.bias"] = ((dims[i + 1],), "zeros", 0)
    return out


def store_dtype(cfg: dict):
    """The dtype each leaf is stored in: bfloat16 for leaves of at least
    2^16 elements under the ``bfloat16_sr`` store, f32 otherwise."""
    sr = cfg["config"]["optimizer"].get("param_dtype") == "bfloat16_sr"

    def dtype(name: str, shape) -> torch.dtype:
        big = math.prod(shape) >= plain.SR_MIN_ELEMENTS
        return torch.bfloat16 if sr and big else torch.float32

    return dtype


def forward(params: dict, x_u8: torch.Tensor, cfg: dict,
            precision: str) -> torch.Tensor:
    m = cfg["config"]["model"]
    h = x_u8.reshape(x_u8.shape[0], -1).float() / 255.0
    for part, i, last in _layers(m):
        k = params[f"{part}.Dense_{i}.kernel"]
        h = plain.matmul(h, k, precision) + params[f"{part}.Dense_{i}.bias"]
        if not last:
            h = torch.relu(h)
    return h.reshape(h.shape[0], cfg["t_bins"], cfg["neurons"])


def poisson_nll_mean(log_rates, targets):
    return (torch.exp(log_rates) - targets * log_rates).mean()


def total_steps(cfg: dict, traffic: dict) -> int:
    """Schedule horizon: global steps an epoch times the recipe's epochs."""
    ranks = traffic.get("ranks", 1)
    per_epoch = (traffic["train_trials"] * ranks) // (traffic["batch"] * ranks)
    return per_epoch * cfg["config"]["training"]["num_epochs"]


def reference_steps(cfg: dict, traffic: dict, p0: dict, batches: list,
                    seeds: list, device, precision: str = "f32",
                    fault: str = None) -> dict:
    """The first ``len(batches)`` training steps from ``p0``. Each batch
    is ``(uint8 video (B, D), spike counts (B, t_bins, neurons))`` of the
    global batch. Returns each step's loss, the first gradient's norm per
    leaf and its adafactor statistics, and each leaf's change over the
    steps. ``fault="half_batch"`` leaves out half of every batch and takes
    the mean over the rest; ``fault="state_unchanged"`` updates nothing."""
    opt = cfg["config"]["optimizer"]
    fused = FIRST_KERNEL if opt.get("fused_readout") else None
    steps = total_steps(cfg, traffic)
    with plain.exact_f32():
        params = {k: v.to(device).float() for k, v in p0.items()}
        start = {k: v.clone() for k, v in params.items()}
        tx = plain.Adafactor()
        losses, grad_norms = [], None
        for n, ((x, y), seed) in enumerate(zip(batches, seeds)):
            x = torch.as_tensor(x).to(device)
            y = torch.as_tensor(y).to(device).float()
            if fault == "half_batch":
                x, y = x[: len(x) // 2], y[: len(y) // 2]
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            loss = poisson_nll_mean(forward(leaves, x, cfg, precision), y)
            names = list(leaves)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            del leaves
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {k: float(g.double().norm())
                              for k, g in grads.items()}
                moments = {k: plain.factored_stats(g)
                           for k, g in grads.items()}
            if fault == "state_unchanged":
                continue
            lr = plain.onecycle(n, steps, opt["lr"],
                                opt.get("warmup_pct", 0.15),
                                opt.get("div_factor", 10))
            with torch.no_grad():
                upd = tx.update(grads, lr)
                del grads
                params = plain.store(params, upd, seed, fused=fused)
                del upd
        change = {k: float((params[k] - start[k]).double().norm())
                  for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "moments": moments,
            "change_norms": change}


def program_moments(opt_state, params) -> dict:
    """The first gradient's adafactor statistics as the program's state
    holds them after one step (square roots, flattened as
    ``plain.factored_stats`` orders them): the fused readout's row and
    column means of g^2 for the first kernel, optax's ``v_row`` and
    ``v_col`` (or ``v``) for the rest."""
    fused, rest = opt_state
    out = {FIRST_KERNEL: torch.cat([fused.col.double().sqrt(),
                                    fused.row.double().sqrt()])
           .float().cpu()}
    for k, p in params.items():
        if k == FIRST_KERNEL:
            continue
        v = rest["v"][k]
        if tuple(v.shape) == tuple(p.shape):
            out[k] = v.double().sqrt().reshape(-1).float().cpu()
        else:
            out[k] = torch.cat([rest["v_row"][k].double().sqrt().reshape(-1),
                                rest["v_col"][k].double().sqrt().reshape(-1)]
                               ).float().cpu()
    return out


def parts(name: str) -> int:
    """Every leaf is one parameter."""
    return 1


def program_grad_norms(opt_state, params) -> dict:
    """The first gradient's norm per leaf, as the program's optimizer got
    it, from its state after one step: adafactor's decay is 0 at its first
    step, so each second-moment statistic is the mean of g^2 (+1e-30) over
    the axis it reduces. The fused readout's state holds the first
    kernel's row and column statistics in f32; the rest is optax's
    factored state, ``v_row`` (or ``v`` for a leaf it does not factor)."""
    fused, rest = opt_state
    out = {}
    m, n = params[FIRST_KERNEL].shape
    out[FIRST_KERNEL] = float(fused.row.double().sum().mul(n).clamp(min=0)
                              .sqrt())
    for k, p in params.items():
        if k == FIRST_KERNEL:
            continue
        v = rest["v"][k]
        if tuple(v.shape) == tuple(p.shape):
            sq = v.double().sum()
        else:
            row = rest["v_row"][k].double()
            sq = row.sum() * (p.numel() / row.numel())
        out[k] = float(sq.clamp(min=0).sqrt())
    return out
