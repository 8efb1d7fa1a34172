"""Weight and optimizer-state converter between the JAX package and the port.

A flax param tree of numpy arrays (``{"params": {"encoder": {"Dense_0":
{"kernel", "bias"}}}}``, e.g. ``jax.device_get(params)``) becomes the port's
flat dict ``{"encoder.Dense_0.kernel": tensor, ...}`` and back. Layouts are
kept as they are (kernels stay (in, out), conv kernels (P, P, C, D)) and so
are dtypes and shapes: a bf16 leaf stays bf16, bit for bit, and a scalar
leaf stays 0-d. The ViT-MAE trees convert this way as they are (255 leaves
for ``ContrastViTMAE``, among them the scalar ``temperature`` and the
``vit_mae.patch_embed`` conv kernel), since the port's parameter names
follow the flax tree.

Optimizer states:

- ``FusedReadoutState(count, row, col)`` <-> the port's namedtuple;
- optax ``adafactor`` chain state ``(FactoredState(count, v_row, v_col, v),
  [clip EmptyState], ScaleByScheduleState(count) | EmptyState(), [param
  scale EmptyState], [EmaState(count, ema)], [decay EmptyState],
  EmptyState())`` (the bracketed links present as the options are set) <->
  the port's ``Adafactor`` state dict;
- optax ``adamw`` chain state ``(ScaleByAdamState(count, mu, nu),
  EmptyState(), ScaleByScheduleState(count) | EmptyState())`` <-> the port's
  ``AdamW`` state dict, a bf16 ``mu`` under ``mu_dtype`` included; the SSL
  trainer's constant learning rate has no schedule count
  (``schedule=False``). The JAX package's ``adamw_lowmem`` and
  ``adamw_sr_bf16`` chains, ``(ScaleByAdamLowmemState(count, mu, nu),
  EmptyState(), ScaleByScheduleState(count))``, convert through the same
  two functions to the port's ``AdamWLowmem`` state;
- ``FactoredRMSState(count, row, col)`` of ``adafactor_lean`` <-> the port's
  ``AdafactorLean`` state;
- ``MultiStepsState(mini_step, gradient_step, inner_opt_state, acc_grads,
  skip_state)`` <-> the port's ``MultiSteps`` state, around any of these
  (the frozen one included: its ``acc_grads`` hold every leaf);
- the frozen-path ``optax.multi_transform`` state of a frozen probe
  (``MaskedNode`` placeholders where the backbone is) <-> the port's
  ``Frozen`` state, the inner optimizer's over the trained leaves; under
  ``fused_readout`` the JAX state is ``(FusedReadoutState, that state)``.

The VideoMAE probe and pretraining trees convert like the others
(``video_mae.patch_embed.Conv_0.kernel`` (kT, kH, kW, C, D),
``encoder_head.kernel``, ``mask_token``, ...), and so does the CEBRA
``Offset10Encoder`` (``Conv_0.kernel`` (2, d, units) ... ``Conv_4.kernel``
(3, units, out_dim), each with its ``bias``).

Back-conversion returns plain nested tuples and dicts in the optax
structure's flatten order, so
``jax.tree.unflatten(jax.tree.structure(optax_state), jax.tree.leaves(x))``
rebuilds the optax object on the JAX side.

Imports neither JAX nor the JAX package; numpy bf16 arrays carry the
``ml_dtypes`` bfloat16 dtype, which is imported only to build one.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from video_spike_torch.ops.fused_readout import FusedReadoutState


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def to_torch(arr, device=None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch, same dtype and bits."""
    arr = np.asarray(arr)
    if _is_bf16(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy, same dtype and bits (bf16 via ml_dtypes)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flax_to_torch(tree: Mapping, device=None) -> dict:
    """Flax param tree -> flat ``{name: tensor}``; the top ``params``
    collection is dropped from the names."""
    if "params" in tree:
        tree = tree["params"]
    return {k: to_torch(v, device) for k, v in _flatten(tree).items()}


def torch_to_flax(params: Mapping[str, torch.Tensor]) -> dict:
    """Flat ``{name: tensor}`` -> ``{"params": nested numpy tree}``."""
    return {"params": _unflatten({k: to_numpy(v) for k, v in params.items()})}


def load_into_model(model: torch.nn.Module,
                    params: Mapping[str, torch.Tensor]) -> None:
    """Copy converted params into the model's parameters, dtype included."""
    named = dict(model.named_parameters())
    if set(named) != set(params):
        raise KeyError(f"param names differ: model {sorted(named)} vs "
                       f"given {sorted(params)}")
    with torch.no_grad():
        for k, p in named.items():
            src = params[k]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)} vs "
                                 f"{tuple(p.shape)}")
            p.data = src.to(device=p.device).clone()


# ---------------------------------------------------------------------------
# optimizer states
# ---------------------------------------------------------------------------

def fused_state_from_flax(state, device=None) -> FusedReadoutState:
    count, row, col = state
    return FusedReadoutState(int(np.asarray(count)), to_torch(row, device),
                             to_torch(col, device))


def fused_state_to_flax(state: FusedReadoutState) -> tuple:
    return (np.asarray(state.count, np.int32), to_numpy(state.row),
            to_numpy(state.col))


def adafactor_state_from_optax(state, device=None) -> dict:
    """optax adafactor chain state -> the port's ``Adafactor`` state."""
    factored = state[0]
    count, v_row, v_col, v = factored

    def conv(tree):
        return flax_to_torch(tree, device)

    out = {"count": int(np.asarray(count)), "v_row": conv(v_row),
           "v_col": conv(v_col), "v": conv(v)}
    for link in state[1:]:
        if hasattr(link, "ema"):          # optax EmaState (momentum)
            out["momentum"] = {"count": int(np.asarray(link.count)),
                               "ema": conv(link.ema)}
    return out


def adafactor_state_to_optax(state: Mapping, schedule: bool = True, *,
                             clipping: bool = False,
                             param_scale: bool = False,
                             weight_decay: bool = False) -> tuple:
    """The port's ``Adafactor`` state -> plain nested tuples in optax's
    chain order. ``schedule``: the learning rate was a schedule (a
    ``ScaleByScheduleState``, else an empty link); ``clipping``,
    ``param_scale``, ``weight_decay``: those options were set (each an
    empty link); momentum is read off the state."""
    count = np.asarray(state["count"], np.int32)
    chain = [(count, torch_to_flax(state["v_row"]),
              torch_to_flax(state["v_col"]), torch_to_flax(state["v"]))]
    if clipping:
        chain.append(())
    chain.append((count,) if schedule else ())
    if param_scale:
        chain.append(())
    if "momentum" in state:
        mom = state["momentum"]
        chain.append((np.asarray(mom["count"], np.int32),
                      torch_to_flax(mom["ema"])))
    if weight_decay:
        chain.append(())
    chain.append(())
    return tuple(chain)


def lean_state_from_flax(state, device=None) -> dict:
    """``FactoredRMSState(count, row, col)`` -> the port's ``AdafactorLean``
    state (bf16 ``row`` and 0-d ``col`` of unfactored leaves kept)."""
    count, row, col = state
    return {"count": int(np.asarray(count)),
            "row": flax_to_torch(row, device),
            "col": flax_to_torch(col, device)}


def lean_state_to_flax(state: Mapping) -> tuple:
    return (np.asarray(state["count"], np.int32),
            torch_to_flax(state["row"]), torch_to_flax(state["col"]))


def multisteps_state_from_optax(state, inner_from, device=None) -> dict:
    """``optax.MultiStepsState`` -> the port's ``MultiSteps`` state, the
    inner state through ``inner_from(inner_state, device)``."""
    mini, gstep, inner, acc = state[:4]
    return {"mini_step": int(np.asarray(mini)),
            "gradient_step": int(np.asarray(gstep)),
            "inner": inner_from(inner, device),
            "acc_grads": flax_to_torch(acc, device), "skip_state": ()}


def multisteps_state_to_optax(state: Mapping, inner_to) -> tuple:
    """The port's ``MultiSteps`` state -> plain tuples in
    ``MultiStepsState``'s order, the inner state through ``inner_to``."""
    return (np.asarray(state["mini_step"], np.int32),
            np.asarray(state["gradient_step"], np.int32),
            inner_to(state["inner"]), torch_to_flax(state["acc_grads"]),
            ())


def adamw_state_from_optax(state, device=None) -> dict:
    """optax adamw chain state -> the port's ``AdamW`` state."""
    count, mu, nu = state[0]
    return {"count": int(np.asarray(count)),
            "mu": flax_to_torch(mu, device), "nu": flax_to_torch(nu, device)}


def adamw_state_to_optax(state: Mapping, schedule: bool = True) -> tuple:
    """The port's ``AdamW`` state -> plain nested tuples in optax's order
    (``schedule``: the learning rate was a schedule, whose count fills the
    chain's last slot)."""
    count = np.asarray(state["count"], np.int32)
    adam = (count, torch_to_flax(state["mu"]), torch_to_flax(state["nu"]))
    return (adam, (), (count,) if schedule else ())


def _drop_masked(tree):
    """An optax state tree without the ``MaskedNode`` placeholders (empty
    named tuples standing for frozen leaves in a param-shaped dict)."""
    if isinstance(tree, Mapping):
        out = {k: _drop_masked(v) for k, v in tree.items()
               if not (isinstance(v, tuple) and len(v) == 0)}
        return {k: v for k, v in out.items()
                if not (isinstance(v, Mapping) and not v)}
    if isinstance(tree, tuple):
        return tuple(_drop_masked(v) for v in tree)
    return tree


def frozen_state_from_optax(state, inner_from, device=None):
    """The JAX trainer's frozen-path state, ``optax.multi_transform({"train":
    tx, "freeze": set_to_zero()})``'s ``PartitionState(inner_states={"train":
    MaskedState(tx state), "freeze": ...})``, -> the port's ``Frozen`` state:
    ``inner_from`` (``adafactor_state_from_optax`` or
    ``adamw_state_from_optax``) of the train state without its placeholders.
    """
    return inner_from(_drop_masked(state[0]["train"][0]), device)


def frozen_state_to_optax(inner: tuple) -> tuple:
    """The optax tuples of a ``Frozen`` optimizer's inner state (from
    ``adafactor_state_to_optax`` / ``adamw_state_to_optax``) -> plain tuples
    in ``PartitionState``'s flatten order (``set_to_zero`` keeps no state
    and the placeholders hold no leaves)."""
    return ({"freeze": ((),), "train": (inner,)},)
