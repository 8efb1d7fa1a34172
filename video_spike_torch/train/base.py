"""Supervised trainer: epoch loop, Poisson-NLL objective, per-session
bits-per-spike / R² eval, best-checkpoint selection, test report.

Counterpart of ``video_spike_tpu/train/base.py:BaseTrainer`` on one device
(reference ``src/trainer/base.py:15-291``):

- input assembly concatenates the flattened ``input: true`` modalities for
  the Linear family (``_assemble_inputs``);
- loss = PoissonNLL(log_input) mean, masked to the valid rows of a padded
  batch;
- the training set is staged on the device once (``training.device_cache``,
  capped at ``device_cache_gb``); each step gathers its batch there, the
  ragged last batch is padded by repeating indices, and a dataset over the
  cap streams batch by batch instead;
- with ``optimizer.param_dtype: bfloat16_sr`` leaves of >= 65,536 elements
  are stored in bf16 with stochastically rounded updates, and with
  ``optimizer.fused_readout`` the Linear model's first kernel is updated by
  the fused rank-B step (``ops/fused_readout.py``) whose parameter write is
  the hand-written CUDA kernel;
- eval accumulates gt/preds per session and reports nanmean bps + per-trial
  R² (on the device for one session, on the host for the test report);
- ``model_best`` on best eval bps, ``model_last`` (params + optimizer state
  + step) at the end, then ``test_results.npy`` from the best params.

Not in this slice (ROADMAP.md): the device mesh and multihost, the
profiler, the frozen-feature split, wandb tracking, asynchronous checkpoint
flushes and figure plotting.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.data.dataset import input_modalities
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops.metrics import device_eval_metrics, metrics_list
from video_spike_torch.ops.optim import (
    MASK32,
    apply_updates,
    apply_updates_sr,
    make_optimizer,
)
from video_spike_torch.ops.poisson import poisson_nll_mean
from video_spike_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

# leaves at or above this many elements go to the bf16 SR store
SR_MIN_ELEMENTS = 1 << 16


class BaseTrainer:
    def __init__(self, model, train_loader, eval_loader, test_loader,
                 config, eid: str, dataset_split_dict: dict,
                 log_dir: Optional[str] = None, criterion=poisson_nll_mean,
                 seed: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.test_loader = test_loader
        self.config = config
        self.eid = eid
        self.split = dataset_split_dict
        self.criterion = criterion
        self.metrics = ("bps", "rsquared")
        self.log = make_logger(header="[train]")
        self.input_mods = input_modalities(config)
        self.model_class = config.model.model_class
        if callable(getattr(model, "frozen_param_paths", None)):
            raise NotImplementedError(
                "frozen parameter paths (the frozen-feature probe) are not "
                "ported yet; see ROADMAP.md Queue A item 11")
        if config.get("save_plot"):
            raise NotImplementedError(
                "save_plot (figures) is not ported yet; see ROADMAP.md "
                "(trainer paths this slice leaves out)")

        base_log_dir = log_dir or config.dirs.log_dir
        self.log_dir = os.path.join(
            base_log_dir, eid[:5], "_".join(self.input_mods),
            type(model).__name__)
        os.makedirs(self.log_dir, exist_ok=True)

        seed = seed if seed is not None else config.get("seed", 42)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        total_steps = (len(dataset_split_dict["train"])
                       // config.training.train_batch_size
                       * config.training.num_epochs)
        self.tx, self.schedule = make_optimizer(config, total_steps)

        self._device_cache_enabled = bool(
            config.training.get("device_cache", True))
        self._device_cache_gb = float(
            config.training.get("device_cache_gb", 6.0))
        self._dev_data = None          # (X_all, ap_all) device tensors
        self._staged_bytes = 0
        self._eval_input_cache: dict = {}
        self._rng = np.random.default_rng(seed)
        self._best_params = None
        self._best_epoch = -1
        self._last_best_flush = -(1 << 30)
        self._save_every = int(config.training.get("save_every", 100) or 100)

        self._sr_params = (config.optimizer.get("param_dtype")
                           == "bfloat16_sr")
        self._fused_readout = bool(config.optimizer.get("fused_readout"))
        opt_name = config.optimizer.get("name", "adamw")
        if self._fused_readout and opt_name != "adafactor":
            # the fused step IS adafactor numerics on the giant kernel
            self.log.info(f"fused_readout disabled: it implements adafactor "
                          f"numerics but optimizer.name={opt_name} "
                          f"(set name: adafactor)")
            self._fused_readout = False
        self._apply_updates = (apply_updates_sr if self._sr_params
                               else apply_updates)

        self.opt_state = None
        self._step_fn = None
        self._fused_inner = None
        self._initialized = False
        self.global_step = 0
        self._start_epoch = 0
        self.train_losses: list = []
        self.eval_history: list = []

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters as a flat dict of plain tensors sharing
        the parameters' storage."""
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def _set_params(self, new: Dict[str, torch.Tensor]) -> None:
        named = dict(self.model.named_parameters())
        for k, t in new.items():
            named[k].data = t

    # ------------------------------------------------------------------
    # input assembly (reference `_forward_model_outputs`)
    # ------------------------------------------------------------------
    def _assemble_inputs(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        if self.model_class == "Linear":
            if len(self.input_mods) == 1:
                mod = self.input_mods[0]
                # single modality keeps its dtype (uint8 video stays compact)
                return np.asarray(batch[mod]).reshape(
                    batch[mod].shape[0], -1)
            parts = [np.asarray(batch[mod], dtype=np.float32)
                     .reshape(batch[mod].shape[0], -1)
                     for mod in self.input_mods]
            return np.concatenate(parts, axis=-1)
        return np.asarray(batch["video"])

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------------------
    # init and steps
    # ------------------------------------------------------------------
    def _init_if_needed(self) -> None:
        if self._initialized:
            return
        self.model.to(self.device)
        self.model.reset_parameters(self.generator)
        if self._sr_params:
            for p in self.model.parameters():
                if p.dtype == torch.float32 and p.numel() >= SR_MIN_ELEMENTS:
                    p.data = p.data.to(torch.bfloat16)
        params = self.params
        if self._fused_readout:
            min_kernel = int(self.config.optimizer.get(
                "fused_min_kernel", 1 << 22))
            kern = params.get(fr.FIRST_KERNEL)
            if (type(self.model).__name__ == "LinearModel"
                    and kern is not None and kern.ndim == 2
                    and kern.numel() >= min_kernel):
                self._fused_inner = fr.make_fused_linear_step(
                    self.model, self.tx, self.schedule, self.criterion,
                    self._apply_updates)
                self.log.info(
                    f"fused readout update on {tuple(kern.shape)} kernel "
                    f"(rank-B factored stats, no materialized gradient)")
            else:
                self.log.info("fused_readout requested but the model has "
                              "no eligible readout kernel; using the "
                              "standard step")
        if self._fused_inner is not None:
            self.opt_state = fr.init_fused_opt_state(params, self.tx)
            self._step_fn = self._fused_inner
        else:
            self.opt_state = self.tx.init(params)
            self._step_fn = self._make_standard_step()
        n_params = sum(p.numel() for p in params.values())
        self.log.info(f"initialized {type(self.model).__name__}: "
                      f"{n_params/1e6:.1f}M params on {self.device}")
        self._initialized = True

    def _make_standard_step(self):
        model, tx, criterion = self.model, self.tx, self.criterion
        apply_fn = self._apply_updates

        def train_step(params, opt_state, inputs, ap, n_valid, seed):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            out = torch.func.functional_call(model, leaves, (inputs,))
            loss = criterion(out, ap, n_valid)
            names = list(leaves)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            with torch.no_grad():
                updates, opt_state = tx.update(grads, opt_state, params)
                params = apply_fn(params, updates, seed)
            return params, opt_state, loss.detach()

        return train_step

    def _step(self, inputs, ap, n_valid) -> torch.Tensor:
        params, self.opt_state, loss = self._step_fn(
            self.params, self.opt_state, inputs, ap, n_valid,
            self.global_step & MASK32)
        self._set_params(params)
        self.global_step += 1
        return loss

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------
    def _stage_device_dataset(self) -> bool:
        """Stage every training trial on the device once; returns False if
        the dataset exceeds the configured cap (the streaming path is used
        then)."""
        if self._dev_data is not None:
            return True
        if not self._device_cache_enabled:
            return False
        xs, aps = [], []
        for batch in self.train_loader:
            xs.append(self._assemble_inputs(batch))
            aps.append(np.asarray(batch["ap"], dtype=np.float32))
        if not xs:
            return False
        X = np.concatenate(xs, axis=0)
        A = np.concatenate(aps, axis=0)
        if X.nbytes + A.nbytes > self._device_cache_gb * 1e9:
            self.log.info(
                f"dataset {X.nbytes/1e9:.1f} GB exceeds device cache cap; "
                f"streaming per step")
            self._device_cache_enabled = False
            return False
        self._init_if_needed()
        self._n_train = X.shape[0]
        self._staged_bytes = X.nbytes + A.nbytes
        self._dev_data = (self._to_device(X), self._to_device(A))
        self.log.info(f"staged {X.nbytes/1e6:.0f} MB of trials on "
                      f"{self.device} ({self._n_train} trials); epochs are "
                      f"now transfer-free")
        return True

    def _epoch_result(self, losses) -> dict:
        loss_vals = torch.stack(losses).float().cpu().numpy()  # one sync
        mean = float(loss_vals.mean())
        self.train_losses.append(mean)
        return {"train_loss": round(mean, 5),
                "lr": float(self.schedule(self.global_step))}

    def _train_epoch_cached(self) -> dict:
        X_all, ap_all = self._dev_data
        bs = self.config.training.train_batch_size
        perm = self._rng.permutation(self._n_train)
        losses = []
        for s in range(0, self._n_train, bs):
            idx = perm[s:s + bs]
            n_valid = len(idx)
            if n_valid < bs:   # ragged tail: pad by repeating, mask the loss
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - n_valid)])
            idx_d = self._to_device(idx.astype(np.int64))
            losses.append(self._step(X_all.index_select(0, idx_d),
                                     ap_all.index_select(0, idx_d), n_valid))
        return self._epoch_result(losses)

    def train_epoch(self) -> dict:
        if self._stage_device_dataset():
            return self._train_epoch_cached()
        self._init_if_needed()
        losses = []
        for batch in self.train_loader:
            inputs = self._to_device(self._assemble_inputs(batch))
            ap = self._to_device(np.asarray(batch["ap"], np.float32))
            losses.append(self._step(inputs, ap, inputs.shape[0]))
        return self._epoch_result(losses)

    def _stage_eval_batch(self, batch):
        self._init_if_needed()
        inputs = self._assemble_inputs(batch)
        ap = np.asarray(batch["ap"], np.float32)
        return (self._to_device(inputs), self._to_device(ap), ap.shape[0],
                ap, list(batch["eid"]))

    def _eval_batches(self, loader, phase: str):
        """Eval inputs are static across epochs: stage them on the device
        once, within what the staged train set left of ``device_cache_gb``;
        a split beyond that streams per eval instead."""
        cache = self._eval_input_cache
        if phase in cache:
            if cache[phase] is not None:
                return cache[phase]
            return (self._stage_eval_batch(b) for b in loader)  # too big
        cap = max(self._device_cache_gb * 1e9 - self._staged_bytes, 0)
        staged, nbytes = [], 0
        it = (self._stage_eval_batch(b) for b in loader)
        for item in it:
            staged.append(item)
            nbytes += item[0].nbytes + item[1].nbytes
            if nbytes > cap:
                self.log.info(f"{phase} split exceeds the remaining device "
                              f"cache budget; streaming eval inputs")
                cache[phase] = None
                return itertools.chain(staged, it)
        cache[phase] = staged
        return staged

    @torch.no_grad()
    def _run_eval(self, loader, split_eids, phase: str) -> Optional[dict]:
        if loader is None or loader.num_trials == 0:
            return None
        # light path: metrics on the device, two scalars to the host. The
        # full arrays are fetched for the test_results.npy contract and for
        # multi-session grouping.
        light = phase != "test" and len(split_eids) == 1
        session = {e: {"gt": [], "preds": []} for e in split_eids}
        losses, dev_outs, dev_gts = [], [], []
        for x, ap_d, n_valid, ap, eids in self._eval_batches(loader, phase):
            out = self.model(x)
            losses.append(poisson_nll_mean(out, ap_d, n_valid))
            if light:
                dev_outs.append(out[:n_valid])
                dev_gts.append(ap_d[:n_valid])
                continue
            out_np = out[:ap.shape[0]].cpu().numpy()
            for i, e in enumerate(eids):
                session[e]["gt"].append(ap[i])
                session[e]["preds"].append(out_np[i])
        if light:
            bps, r2 = device_eval_metrics(torch.cat(dev_outs, 0),
                                          torch.cat(dev_gts, 0))
            vals = torch.stack(losses + [bps, r2]).double().cpu().numpy()
            return {f"{phase}_res": {
                f"{phase}_loss": round(float(vals[:-2].mean()), 5),
                f"{phase}_bps": round(float(vals[-2]), 5),
                f"{phase}_rsquared": round(float(vals[-1]), 5)}}
        losses = torch.stack(losses).double().cpu().numpy()
        gt, preds = {}, {}
        metric_acc = {k: [] for k in self.metrics}
        for idx, e in enumerate(split_eids):
            _gt = np.stack(session[e]["gt"], axis=0)
            _preds = np.exp(np.stack(session[e]["preds"], axis=0))
            gt[idx], preds[idx] = _gt, _preds
            res = metrics_list(np.swapaxes(_gt, 0, -1),
                               np.swapaxes(_preds, 0, -1),
                               metrics=self.metrics)
            for k, v in res.items():
                metric_acc[k].append(v)
        named = {f"{phase}_{k}": round(float(np.mean(v)), 5)
                 for k, v in metric_acc.items()}
        return {
            f"{phase}_gt": gt,
            f"{phase}_preds": preds,
            f"{phase}_res": {f"{phase}_loss": round(float(np.mean(losses)), 5),
                             **named},
        }

    def eval_epoch(self) -> Optional[dict]:
        return self._run_eval(self.eval_loader, self.split["eid"]["val"],
                              "eval")

    # ------------------------------------------------------------------
    # full loop
    # ------------------------------------------------------------------
    def train(self) -> dict:
        from video_spike_torch.core.preempt import graceful_stop

        best_bps = -np.inf
        best_loss = np.inf
        best_epoch = -1
        num_epochs = self.config.training.num_epochs
        eval_every = int(self.config.training.get("eval_every") or 1)
        t0 = time.time()
        with graceful_stop(self.log) as preempted:
            for epoch in range(self._start_epoch, num_epochs):
                train_res = self.train_epoch()
                # evaluate on the cadence and always on the final epoch
                eval_res = (self.eval_epoch()
                            if (epoch % eval_every == 0
                                or epoch == num_epochs - 1) else None)
                line = {"epoch": epoch, **train_res}
                if eval_res:
                    line.update(eval_res["eval_res"])
                    self.eval_history.append(
                        {"epoch": epoch, **eval_res["eval_res"]})
                    if eval_res["eval_res"]["eval_bps"] > best_bps:
                        best_bps = eval_res["eval_res"]["eval_bps"]
                        best_loss = eval_res["eval_res"]["eval_loss"]
                        best_epoch = epoch
                        # an on-device copy; written to disk at the
                        # save_every cadence and at the end
                        self._best_params = {k: v.clone() for k, v
                                             in self.params.items()}
                        self._best_epoch = epoch
                        if epoch - self._last_best_flush >= self._save_every:
                            self.save_model("best", epoch)
                            self._last_best_flush = epoch
                self.log.info(f"{line}")
                if preempted:
                    # SIGTERM / Ctrl-C: persist the true-resume checkpoint
                    self.save_model("last", epoch)
                    if self._best_params is not None:
                        self.save_model("best", self._best_epoch)
                    self.log.info(f"preempted at epoch {epoch}: model_last "
                                  f"saved, resume with --resume")
                    return self._result(best_bps, best_epoch, None,
                                        preempted=True, epoch=epoch)
        if self._best_params is not None \
                and self._last_best_flush != self._best_epoch:
            self.save_model("best", self._best_epoch)
        self.save_model("last", num_epochs - 1)
        self.log.info(f"trained {num_epochs} epochs in {time.time()-t0:.1f}s; "
                      f"best eval_bps={best_bps} @ epoch {best_epoch}")

        test_res = self.test_model()
        if test_res:
            test_res["test_res"].update(best_eval_loss=best_loss,
                                        best_eval_bps=best_bps)
            np.save(os.path.join(self.log_dir, "test_results.npy"), test_res)
            self.log.info(f"{test_res['test_res']}")
        return self._result(best_bps, best_epoch,
                            (test_res or {}).get("test_res"))

    def _result(self, best_bps, best_epoch, test_res, **extra) -> dict:
        return {"best_eval_bps": best_bps, "best_epoch": best_epoch,
                "test_res": test_res, "global_step": self.global_step,
                "start_epoch": self._start_epoch,
                "train_losses": list(self.train_losses),
                "eval_history": list(self.eval_history),
                "fused_readout": self._fused_inner is not None,
                "log_dir": self.log_dir, **extra}

    def test_model(self) -> Optional[dict]:
        if self._best_params is not None:
            self._set_params(self._best_params)
        elif checkpoint_exists(self.log_dir, "model_best"):
            self._init_if_needed()
            restored = load_checkpoint(self.log_dir, "model_best",
                                       self.device)
            self._set_params(restored["params"])
        return self._run_eval(self.test_loader, self.split["eid"]["test"],
                              "test")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _opt_state_tree(self):
        if self._fused_inner is not None:
            fstate, rest = self.opt_state
            return {"fused": fstate._asdict(), "rest": rest}
        return {"tx": self.opt_state}

    def _load_opt_state(self, tree) -> None:
        if self._fused_inner is not None:
            if "fused" not in tree:
                raise ValueError("checkpoint has no fused readout state but "
                                 "this run uses the fused step")
            self.opt_state = (fr.FusedReadoutState(**tree["fused"]),
                              tree["rest"])
        else:
            if "tx" not in tree:
                raise ValueError("checkpoint holds a fused readout state but "
                                 "this run uses the standard step")
            self.opt_state = tree["tx"]

    def save_model(self, name: str = "last", epoch: int = 0) -> None:
        """``model_best`` holds params only; ``model_last`` adds the
        optimizer state and step counter for a true resume."""
        params = (self._best_params
                  if name == "best" and self._best_params is not None
                  else self.params)
        tree = {"params": params, "epoch": epoch}
        if name == "last":
            tree["opt_state"] = self._opt_state_tree()
            tree["global_step"] = self.global_step
        save_checkpoint(self.log_dir, f"model_{name}", tree)

    def resume(self, name: str = "last") -> bool:
        """Restore params + optimizer state + epoch from ``model_last``."""
        if not checkpoint_exists(self.log_dir, f"model_{name}"):
            return False
        self._init_if_needed()
        restored = load_checkpoint(self.log_dir, f"model_{name}", self.device)
        self._set_params(restored["params"])
        self._load_opt_state(restored["opt_state"])
        self.global_step = int(restored["global_step"])
        self._start_epoch = int(restored["epoch"]) + 1
        self.log.info(f"resumed from epoch {restored['epoch']} "
                      f"(step {self.global_step})")
        return True
