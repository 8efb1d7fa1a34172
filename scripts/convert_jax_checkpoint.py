"""Convert the JAX package's checkpoints into the PyTorch port's.

The JAX trainers write orbax directories; the port reads one ``torch.save``
file per checkpoint (``video_spike_torch/train/checkpoint.py``). This script
runs on a host with JAX and orbax (the H100 host has neither: convert
before the files reach it) and writes ``<name>.pt`` beside each converted
directory, or into ``--out``, in the tree the port's trainers write:

- ``BaseTrainer`` (Linear, VideoMAE probe): ``model_best`` (params, epoch)
  and ``model_last`` (params, epoch, global_step and the optimizer state:
  ``{"fused": ..., "rest": ...}`` under the fused readout, else ``{"tx":
  ...}``);
- ``MultiSessionTrainer`` (VTT): the same with ``best_bps``, the optimizer
  state as it is;
- the SSL ``ContrastTrainer``: ``best_model`` (params) and ``last_model``
  (params, AdamW state, step, best_bps), with the ``last_model.sampler.json``
  and ``best_model.meta.json`` sidecars copied beside them (the port's
  resume reads the same fields);
- a ``pretrain_videomae`` ``backbone`` (params), which the port's
  ``load_pretrained_into_probe`` reads.

Params go through ``video_spike_torch.convert.flax_to_torch``, optimizer
states through its converters: optax ``adafactor`` chains (momentum
included), ``adamw`` (``mu_dtype`` too) and the ``adamw_lowmem`` /
``adamw_sr_bf16`` chains, ``adafactor_lean``, ``MultiSteps`` around any of
them, the frozen-backbone ``multi_transform``, and the fused readout's
state. The checkpoint is restored without a target, so each optimizer
state is recognised by its fields; a leaf or a state the port has no place
for is refused by name, and nothing is written for that checkpoint.

    python scripts/convert_jax_checkpoint.py LOG_DIR [LOG_DIR ...]
    python scripts/convert_jax_checkpoint.py LOG_DIR/model_last --out DIR

A path that is a checkpoint is converted; a directory holding checkpoints
(``model_best``, ``model_last``, ``best_model``, ``last_model``,
``backbone``) has each of them converted.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from collections import namedtuple
from pathlib import Path

import jax
import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from video_spike_torch import convert as cv  # noqa: E402

NAMES = ("model_best", "model_last", "best_model", "last_model", "backbone")
# sidecars of the SSL trainer and the fields the port's resume reads
SIDECARS = {"last_model": ("last_model.sampler.json",
                           {"epoch_start": {"rng_state", "epoch"},
                            "consumed": None, "step": None}),
            "best_model": ("best_model.meta.json",
                           {"best_bps": None, "step": None})}

# optax states by their fields, in the order the converters unpack them
FACTORED = ("count", "v_row", "v_col", "v")
ADAM = ("count", "mu", "nu")
RMS = ("count", "row", "col")
MULTISTEPS = ("mini_step", "gradient_step", "inner_opt_state", "acc_grads",
              "skip_state")
_Ema = namedtuple("_Ema", "count ema")


class Unmapped(ValueError):
    """A leaf or state of the JAX tree that the port has no place for."""


def _is_checkpoint(path: Path) -> bool:
    return path.is_dir() and (path / "_CHECKPOINT_METADATA").exists()


def _plain(node):
    """orbax's restore without a target: named tuples come back as dicts
    of their fields, tuples as lists, empty states (``EmptyState``,
    ``MaskedNode``) as None. Lists become tuples and None the empty tuple,
    as the converters read them; arrays become numpy."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return tuple(_plain(v) for v in node)
    if node is None:
        return ()
    return np.asarray(node)


def _fields(node, names) -> bool:
    return isinstance(node, dict) and set(node) == set(names)


def _link(link, where: str):
    """A chain link after the first: empty, a schedule count or momentum."""
    if link == () or _fields(link, ("count",)):
        return link
    if _fields(link, ("count", "ema")):
        return _Ema(link["count"], link["ema"])
    raise Unmapped(f"{where}: a chain link with fields "
                   f"{sorted(link) if isinstance(link, dict) else link!r} "
                   f"has no counterpart in the port's optimizers")


def tx_state(node, where: str = "opt_state"):
    """One optimizer's state (``tx.init``'s) -> the port's."""
    inner = lambda st, device=None: tx_state(st, where + ".inner")
    if _fields(node, MULTISTEPS):
        return cv.multisteps_state_from_optax(
            tuple(node[k] for k in MULTISTEPS[:4]), inner)
    if _fields(node, ("inner_states",)):           # the frozen backbone
        train = node["inner_states"].get("train")
        if not _fields(train, ("inner_state",)):
            raise Unmapped(f"{where}.inner_states: no 'train' partition")
        return cv.frozen_state_from_optax(
            ({"train": (train["inner_state"],)},), inner)
    if _fields(node, RMS) and isinstance(node["row"], dict):
        return cv.lean_state_from_flax(tuple(node[k] for k in RMS))
    if isinstance(node, tuple) and node and isinstance(node[0], dict):
        links = tuple(_link(x, f"{where}[{i + 1}]")
                      for i, x in enumerate(node[1:]))
        if _fields(node[0], FACTORED):
            return cv.adafactor_state_from_optax(
                (tuple(node[0][k] for k in FACTORED),) + links)
        if _fields(node[0], ADAM) and not any(
                isinstance(x, _Ema) for x in links):
            return cv.adamw_state_from_optax(
                (tuple(node[0][k] for k in ADAM),) + links)
    raise Unmapped(f"{where}: no port optimizer keeps a state of "
                   f"{sorted(node) if isinstance(node, dict) else type(node)}")


def base_opt_state(node):
    """``BaseTrainer``'s optimizer state: ``(FusedReadoutState, rest)``
    under the fused readout, else the optimizer's own."""
    if (isinstance(node, tuple) and len(node) == 2 and _fields(node[0], RMS)
            and not isinstance(node[0]["row"], dict)):
        fused = cv.fused_state_from_flax(tuple(node[0][k] for k in RMS))
        return {"fused": fused._asdict(),
                "rest": tx_state(node[1], "opt_state.rest")}
    return {"tx": tx_state(node)}


def _params(node, where: str = "params") -> dict:
    def check(n, path):
        if isinstance(n, dict):
            for k, v in n.items():
                check(v, f"{path}.{k}")
        elif not isinstance(n, np.ndarray) or n.dtype == object:
            raise Unmapped(f"{path}: not an array ({type(n).__name__})")
    check(node, where)
    return cv.flax_to_torch(node)


def convert_tree(raw: dict, name: str) -> dict:
    """A restored JAX checkpoint tree -> the port's, by the trainer that
    wrote it: ``step`` marks the SSL trainer, ``best_bps`` with ``epoch``
    the multi-session one, ``epoch`` alone ``BaseTrainer``."""
    tree = _plain(raw)
    known = {"params", "epoch", "global_step", "opt_state", "best_bps",
             "step"}
    extra = sorted(set(tree) - known)
    if extra or "params" not in tree:
        raise Unmapped(f"{name}: top-level leaves {extra or ['no params']}"
                       f" have no place in the port's checkpoint")
    out = {"params": _params(tree["params"])}
    for k in ("epoch", "global_step", "step"):
        if k in tree:
            out[k] = int(tree[k])
    if "best_bps" in tree:
        out["best_bps"] = float(tree["best_bps"])
    if "opt_state" in tree:
        base = "epoch" in tree and "best_bps" not in tree
        out["opt_state"] = (base_opt_state(tree["opt_state"]) if base
                            else tx_state(tree["opt_state"]))
    return out


def _sidecar(src: Path):
    """The SSL sidecar of checkpoint `src` as (its path, its name) when
    its fields are the ones the port's resume reads; None when there is
    none; refused otherwise."""
    if src.name not in SIDECARS:
        return None
    fname, fields = SIDECARS[src.name]
    path = src.parent / fname
    if not path.exists():
        return None
    state = json.loads(path.read_text())
    if set(state) != set(fields) or any(
            sub is not None and set(state[k]) != sub
            for k, sub in fields.items()):
        raise Unmapped(f"{path}: fields {sorted(state)} differ from the "
                       f"port's {sorted(fields)}")
    return path, fname


def convert_checkpoint(src: str | Path, out_dir: str | Path | None = None
                       ) -> list:
    """Convert one orbax checkpoint directory; returns the files written
    (``<out_dir>/<name>.pt`` and any sidecar). Nothing is written when a
    part is refused."""
    from video_spike_torch.train.checkpoint import save_checkpoint
    from video_spike_tpu.train.checkpoint import load_checkpoint

    src = Path(src).resolve()
    out_dir = Path(out_dir) if out_dir is not None else src.parent
    raw = jax.device_get(load_checkpoint(src.parent, src.name))
    tree = convert_tree(raw, src.name)
    sidecar = _sidecar(src)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = [save_checkpoint(out_dir, src.name, tree)]
    if sidecar is not None:
        path, fname = sidecar
        if (out_dir / fname).resolve() != path.resolve():
            shutil.copyfile(path, out_dir / fname)
        written.append(str(out_dir / fname))
    return written


def convert_path(path: str | Path, out_dir: str | Path | None = None
                 ) -> list:
    """A checkpoint, or a directory holding checkpoints under the
    trainers' names."""
    path = Path(path)
    if _is_checkpoint(path):
        return convert_checkpoint(path, out_dir)
    found = [path / n for n in NAMES if _is_checkpoint(path / n)]
    if not found:
        raise FileNotFoundError(f"{path}: no JAX checkpoint there (looked "
                                f"for {', '.join(NAMES)})")
    return [f for src in found for f in convert_checkpoint(src, out_dir)]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("paths", nargs="+",
                        help="checkpoint directories, or log directories "
                             "holding them")
    parser.add_argument("--out", default=None,
                        help="write here (default: beside each checkpoint)")
    args = parser.parse_args(argv)
    written = []
    for p in args.paths:
        written += convert_path(p, args.out)
    for f in written:
        print(f)
    return written


if __name__ == "__main__":
    main()
