"""Supervised trainer: epoch loop, Poisson-NLL objective, per-session
bits-per-spike / R² eval, best-checkpoint selection, test report.

Counterpart of ``video_spike_tpu/train/base.py:BaseTrainer`` on one device
(reference ``src/trainer/base.py:15-291``):

- input assembly concatenates the flattened ``input: true`` modalities for
  the Linear family (``_assemble_inputs``), raw video otherwise;
- loss = PoissonNLL(log_input) mean, masked to the valid rows of a padded
  batch;
- the training set is staged on the device once (``training.device_cache``,
  capped at ``device_cache_gb``); each step gathers its batch there, the
  ragged last batch is padded by repeating indices, and a dataset over the
  cap (or ``device_cache: false``) streams instead: a producer thread reads
  the shards (the native C++ reader), assembles each batch and copies it to
  the card through pinned, double-buffered host memory
  (``data/prefetch.prefetch_to_device``) while the current step runs;
- every optimizer of ``ops/optim.make_optimizer`` (AdamW, ``mu_dtype``,
  ``adamw_lowmem``, ``adamw_sr_bf16``, optax's adafactor with its options,
  ``adafactor_lean``) and ``optimizer.gradient_accumulation_steps`` (each
  micro-step one loader batch; updates land every k-th);
- with ``optimizer.param_dtype: bfloat16_sr`` leaves of >= 65,536 elements
  are stored in bf16 with stochastically rounded updates, and with
  ``optimizer.fused_readout`` under ``adafactor`` or ``adafactor_lean``
  (and no accumulation) the Linear model's first kernel, or the VideoMAE
  probe's ``encoder_head`` kernel, is updated by the fused rank-B step
  (``ops/fused_readout.py``) whose parameter write is the hand-written CUDA
  kernel, the other leaves by the configured optimizer;
- a model with frozen parameter paths (``VideoMAEProbe``) keeps them out of
  the optimizer; with an ``encode`` / ``head`` split its frozen backbone
  encodes every staged trial once (``_encode_staged_trials``) and the steps
  and evals run the head on the cached features; ``model.pretrained_backbone``
  fills the backbone from a checkpoint first;
- eval accumulates gt/preds per session and reports nanmean bps + per-trial
  R² (on the device for one session, on the host for the test report);
- ``model_best`` on best eval bps, written in the background at the
  ``save_every`` cadence (the stash is a device copy); at the end the
  in-flight saves are joined, then ``model_best`` (unless the cadence
  flush wrote that epoch) and ``model_last`` (params + optimizer state +
  step, from a device snapshot: the fused step updates the first kernel in
  place) are written in the background while ``test_model`` runs, and
  joined before ``test_results.npy`` and the return; SIGTERM / Ctrl-C
  joins the flushes (a failed one is logged) and saves both synchronously;
- every epoch's line goes to ``<log_dir>/metrics.jsonl`` (``core/tracking``,
  wandb mirrored under ``wandb.use``); ``save_plot`` writes
  ``best_trial_<tag>.png`` and ``best_neuron_<tag>.png`` at each new best
  epoch and for the test split; ``profiling: {enable, dir, steps}`` traces
  ``steps`` steps of the streaming epoch once ``global_step > 2`` with
  ``torch.profiler`` into ``dir`` (the cached epoch is not traced, as in
  the JAX trainer);
- under a process group (``torch.distributed.run``; ``core/runtime``) the
  ranks train data-parallel on the mesh's ``data`` axis
  (``training.mesh``, default every rank on ``data``): each rank streams
  its shard of the training trials (``parallel/multihost``), drops its
  ragged tail and runs the step count every rank agrees on
  (``global_min``); a standard step all-reduces the gradients and the
  loss with SUM (the criterion divides by the global row count), the fused
  step gathers its rank-B factors; ``device_cache`` stages each rank's
  shard on its own device (``_stage_device_dataset_multihost``, with a
  ``global_any`` fallback to streaming); eval rows are split over the
  ranks and the predictions gathered; a preemption is agreed with
  ``global_any`` before any save; rank 0 alone writes checkpoints,
  results and figures, synchronously (no background flush mid-train and
  no async final save), and every rank reads them after a barrier; after
  each epoch the ranks compare checksums of their parameters and raise if
  the replicas drifted apart. Under ``training.mesh: {data: D, model: M}``
  the parameters and the optimizer state stay replicated on all D·M ranks
  (as in the JAX trainer), ``train_batch_size`` is a data row's batch and
  the M ranks of a row read the same shard (``shard_files_for_process``
  by data index) and run the same rows; the gradients, the fused step's
  factors, the loss sums and the eval rows go over the ``data`` group (the
  column of ranks sharing this rank's model index), so every rank of the
  mesh launches the fused step's kernel once a step on the D·b gathered
  rows; the rank-local trial cache needs each block on one rank and is
  refused (logged) in favour of streaming, as the JAX trainer refuses its
  cache when a block's devices span processes; the replica checksums
  compare all D·M ranks.
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
from video_spike_torch.core.tracking import Tracker
from video_spike_torch.data.dataset import input_modalities
from video_spike_torch.data.prefetch import prefetch_to_device
from video_spike_torch.models.videomae import head_apply
from video_spike_torch.ops import fused_readout as fr
from video_spike_torch.ops.metrics import device_eval_metrics, metrics_list
from video_spike_torch.ops.optim import (
    MASK32,
    apply_updates,
    apply_updates_sr,
    is_frozen,
    make_optimizer,
)
from video_spike_torch.ops.poisson import poisson_nll_mean
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
    snapshot,
    wait_for_checkpoints,
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
        if config.get("save_plot"):
            from video_spike_torch.viz import pyplot

            pyplot()   # no matplotlib: fail now, not after training

        # the mesh from config (the Accelerate-config analog), e.g.
        # training.mesh: {data: 4, model: 2}; default: every rank on data.
        # One rank drives one device, so a rank's batch always divides its
        # devices; under a model axis the parameters stay replicated (as in
        # the JAX trainer) and the ranks of a data row run the same rows.
        mesh_cfg = config.training.get("mesh", {}) or {}
        mesh = make_mesh(n_data=mesh_cfg.get("data"),
                         n_model=mesh_cfg.get("model", 1))
        self.mesh = mesh
        self._dp_group = mesh.group("data")
        self._multihost = mh.is_multihost()
        self._is_main = mh.process_index() == 0
        self.replica_checksums: list = []

        base_log_dir = log_dir or config.dirs.log_dir
        self.log_dir = os.path.join(
            base_log_dir, eid[:5], "_".join(self.input_mods),
            type(model).__name__)
        os.makedirs(self.log_dir, exist_ok=True)

        seed = seed if seed is not None else config.get("seed", 42)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # schedule horizon = global steps: each data row takes one global
        # step per local batch of its shard, so the count divides by the
        # data axis
        total_steps = (len(dataset_split_dict["train"])
                       // (config.training.train_batch_size
                           * mesh.shape["data"])
                       * config.training.num_epochs)
        frozen = getattr(model, "frozen_param_paths", None)
        self._frozen_paths = tuple(frozen()) if callable(frozen) else ()
        self.tx, self.schedule = make_optimizer(
            config, total_steps, frozen_paths=self._frozen_paths)
        # frozen-feature training: with frozen subtrees and an encode/head
        # split (VideoMAEProbe) every trial is encoded once and the steps
        # train the head on cached features; the optimizer cannot move the
        # frozen encoder, so the features stay exact for the whole run
        self._frozen_split = bool(
            self._frozen_paths and callable(getattr(model, "encode", None))
            and callable(getattr(model, "head", None)))
        self._features_staged = False
        self.encode_seconds = 0.0
        self.n_params = 0

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
        # the fused step's kernel update is adafactor_lean's numerics; it
        # cannot sit under MultiSteps (which wraps tx.update)
        self._fused_readout = bool(config.optimizer.get("fused_readout"))
        if self._fused_readout:
            opt_name = config.optimizer.get("name", "adamw")
            if int(config.optimizer.get(
                    "gradient_accumulation_steps", 1) or 1) > 1:
                self.log.info("fused_readout disabled: incompatible with "
                              "gradient accumulation")
                self._fused_readout = False
            elif self._frozen_paths and not self._frozen_split:
                self.log.info("fused_readout disabled: frozen paths "
                              "without an encode/head split")
                self._fused_readout = False
            elif opt_name not in ("adafactor", "adafactor_lean"):
                self.log.info(
                    f"fused_readout disabled: it implements adafactor "
                    f"numerics but optimizer.name={opt_name} "
                    f"(set name: adafactor)")
                self._fused_readout = False
        self._apply_updates = (apply_updates_sr if self._sr_params
                               else apply_updates)

        self.opt_state = None
        self._step_fn = self._feature_step_fn = None
        self._fused_inner = None
        self._initialized = False
        self.global_step = 0
        self._start_epoch = 0
        self.train_losses: list = []
        self.eval_history: list = []

        wandb_cfg = config.get("wandb", {}) or {}
        self.tracker = Tracker(
            self.log_dir, project=wandb_cfg.get("project", "ibl-video"),
            name=f"{eid[:5]}_{'_'.join(self.input_mods)}_"
                 f"{type(model).__name__}",
            use_wandb=bool(wandb_cfg.get("use", False)),
            config=config.to_plain() if hasattr(config, "to_plain") else None)
        prof = config.get("profiling", {}) or {}
        self._profile_dir = prof.get("dir") if prof.get("enable") else None
        self._profile_steps = prof.get("steps", 10)
        self.trace_paths: list = []

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

    def _host_batch(self, batch: Dict[str, np.ndarray]) -> dict:
        """A loader batch as the streamed step's host arrays (runs on the
        prefetch's producer thread)."""
        return {"inputs": self._assemble_inputs(batch),
                "ap": np.asarray(batch["ap"], np.float32)}

    # ------------------------------------------------------------------
    # init and steps
    # ------------------------------------------------------------------
    def _init_if_needed(self) -> None:
        if self._initialized:
            return
        self.model.to(self.device)
        self.model.reset_parameters(self.generator)
        pretrained = self.config.model.get("pretrained_backbone")
        if pretrained:
            # the reference's from_pretrained("MCG-NJU/videomae-base") is an
            # explicit checkpoint on disk here
            from video_spike_torch.models.hf_convert import (
                load_pretrained_into_probe)
            self._set_params(load_pretrained_into_probe(self.params,
                                                        pretrained))
            self.log.info(f"loaded pretrained backbone from {pretrained}")
        if self._sr_params:
            for p in self.model.parameters():
                if p.dtype == torch.float32 and p.numel() >= SR_MIN_ELEMENTS:
                    p.data = p.data.to(torch.bfloat16)
        params = self.params
        split = None
        if self._fused_readout:
            min_kernel = int(self.config.optimizer.get(
                "fused_min_kernel", 1 << 22))
            model_name = type(self.model).__name__
            kern = None
            if model_name == "LinearModel":
                kern, make, split = (params.get(fr.FIRST_KERNEL),
                                     fr.make_fused_linear_step,
                                     fr.split_first_kernel)
            elif self._frozen_split:
                # the probe's head-only step: it consumes frozen features
                kern, make, split = (params.get(fr.HEAD_KERNEL),
                                     fr.make_fused_probe_head_step,
                                     fr.split_head_kernel)
            if (kern is not None and kern.ndim == 2
                    and kern.numel() >= min_kernel):
                self._fused_inner = make(
                    self.model, self.tx, self.schedule, self.criterion,
                    self._apply_updates, group=self._dp_group)
                self.log.info(
                    f"fused readout update on {tuple(kern.shape)} kernel "
                    f"(rank-B factored stats, no materialized gradient)")
            else:
                split = None
                self.log.info("fused_readout requested but the model has "
                              "no eligible readout kernel; using the "
                              "standard step")
        if split is not None:
            self.opt_state = fr.init_fused_opt_state(params, self.tx,
                                                     split=split)
        else:
            self.opt_state = self.tx.init(params)
        self._step_fn, self._feature_step_fn = self._make_steps()
        self.n_params = sum(p.numel() for p in params.values())
        self.log.info(f"initialized {type(self.model).__name__}: "
                      f"{self.n_params/1e6:.1f}M params on {self.device}")
        self._initialized = True

    def _make_steps(self):
        """(the step on raw inputs, the step on staged frozen features or
        None); each is ``step(params, opt_state, x, ap, n_valid, seed)``."""
        model = self.model
        if self._fused_inner is None:
            full = self._make_standard_step(
                lambda p, x: torch.func.functional_call(model, p, (x,)))
            if not self._frozen_split:
                return full, None
            return full, self._make_standard_step(
                lambda p, x: head_apply(p, x, model.out_dim))
        if not self._frozen_split:
            return self._fused_inner, None
        # the fused head step reads features: raw inputs are encoded first
        fused = self._fused_inner

        def encode_then_fused(params, opt_state, inputs, ap, n_valid, seed):
            with torch.no_grad():
                hidden = model.encode(inputs)
            return fused(params, opt_state, hidden, ap, n_valid, seed)

        return encode_then_fused, fused

    def _make_standard_step(self, apply):
        """A train step through ``apply(params, x)`` that differentiates
        and updates every leaf outside the frozen paths."""
        tx, criterion = self.tx, self.criterion
        apply_fn, frozen = self._apply_updates, self._frozen_paths
        group = self._dp_group

        def train_step(params, opt_state, inputs, ap, n_valid, seed):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items() if not is_frozen(k, frozen)}
            out = apply({**params, **leaves}, inputs)
            loss = criterion(out, ap, n_valid)
            names = list(leaves)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            with torch.no_grad():
                grads, loss = mh.sum_grads_and_loss(grads, loss.detach(),
                                                    group)
                trained = {k: params[k] for k in names}
                updates, opt_state = tx.update(grads, opt_state, trained)
                params = {**params, **apply_fn(trained, updates, seed)}
            return params, opt_state, loss

        return train_step

    def _step(self, inputs, ap, n_valid, step_fn=None) -> torch.Tensor:
        params, self.opt_state, loss = (step_fn or self._step_fn)(
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
        if self._frozen_split:
            feats = self._encode_staged_trials()
            if feats is not None:       # the raw video is dropped here
                self._dev_data = (feats, self._dev_data[1])
                self._staged_bytes = feats.nbytes + A.nbytes
                self._features_staged = True
                self.log.info(f"frozen-encoder features staged "
                              f"({feats.nbytes/1e6:.0f} MB, {feats.dtype}) "
                              f"in {self.encode_seconds:.2f} s; train steps "
                              f"are now head-only")
        return True

    @torch.no_grad()
    def _encode_staged_trials(self) -> Optional[torch.Tensor]:
        """The frozen encoder over every staged trial, in chunks of the
        batch size (the ragged tail padded by repeating the last trial), or
        None when the staging peak would pass ``device_cache_gb``: the raw
        video, the chunks and their concatenation coexist until the raw
        video is dropped."""
        X_all, A_all = self._dev_data
        rows = X_all.shape[0]
        bs = min(self.config.training.train_batch_size, rows)
        t0 = time.perf_counter()
        one = self.model.encode(X_all[:1])
        feat_bytes = rows * one.numel() * one.element_size()
        peak = X_all.nbytes + 2 * feat_bytes + A_all.nbytes
        if peak > self._device_cache_gb * 1e9:
            self.log.info(f"frozen features ({feat_bytes/1e9:.1f} GB, "
                          f"staging peak {peak/1e9:.1f} GB) exceed the "
                          f"device cache cap; keeping raw-input steps")
            return None
        chunks = []
        for s in range(0, rows, bs):
            idx = np.minimum(np.arange(s, s + bs), rows - 1)
            chunks.append(self.model.encode(
                X_all.index_select(0, self._to_device(idx))))
        feats = torch.cat(chunks, dim=0)[:rows]
        if feats.device.type == "cuda":
            torch.cuda.synchronize(feats.device)
        self.encode_seconds = time.perf_counter() - t0
        return feats

    def _epoch_result(self, losses) -> dict:
        loss_vals = torch.stack(losses).float().cpu().numpy()  # one sync
        mean = float(loss_vals.mean())
        self.train_losses.append(mean)
        return {"train_loss": round(mean, 5),
                "lr": float(self.schedule(self.global_step))}

    def _train_epoch_cached(self) -> dict:
        X_all, ap_all = self._dev_data
        step_fn = (self._feature_step_fn if self._features_staged
                   else self._step_fn)
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
                                     ap_all.index_select(0, idx_d), n_valid,
                                     step_fn))
        return self._epoch_result(losses)

    def _train_epoch_multihost(self) -> dict:
        """One streamed epoch across ranks: each rank drops its ragged tail
        batch (DDP drop_last), the ranks agree on the common step count,
        and every step is this rank's rows of the global batch."""
        bs = self.config.training.train_batch_size
        # the loader batches its shuffled shard in order: full batches are
        # num_trials // bs, known without reading the epoch
        steps = mh.global_min(self.train_loader.num_trials // bs)
        n_valid = bs * self.mesh.shape["data"]
        self._init_if_needed()
        losses = []
        stream = prefetch_to_device(self.train_loader, self.device, depth=2,
                                    transform=self._host_batch)
        try:
            for batch in stream:
                if len(losses) >= steps:
                    break
                if batch["inputs"].shape[0] < bs:   # ragged tail
                    continue
                losses.append(self._step(batch["inputs"], batch["ap"],
                                         n_valid))
        finally:
            stream.close()
        if not losses:   # no rank has a full batch
            return {"train_loss": float("nan"),
                    "lr": float(self.schedule(self.global_step))}
        return self._epoch_result(losses)

    def _stage_device_dataset_multihost(self) -> bool:
        """The rank-local trial cache: each rank stages its own shard once
        on its device and every later epoch gathers batches there with a
        rank-local index (no collective); the only per-step host-to-device
        copy is the index (``_cached_mh_h2d_bytes``). Every rank keeps the
        same row count R (the smallest shard's; the rest of a shard is
        dropped, as DDP's drop_last) and shuffles within its block. Falls
        back to streaming, agreed by every rank (``global_any``), when a
        block is shared by ranks, the global batch does not divide the data
        axis, a shard is too small or any rank would pass the cap."""
        if self._dev_data is not None:
            return True
        if not self._device_cache_enabled or getattr(
                self, "_mh_cache_failed", False):
            return False
        n_data = self.mesh.shape["data"]
        bs_global = (self.config.training.train_batch_size
                     * n_data)
        mine, g_min, private = mh.data_axis_blocks(self.mesh)
        if not private or g_min == 0 or bs_global % n_data:
            self.log.info(
                f"multihost trial cache unavailable (blocks private: "
                f"{private}, min blocks/rank: {g_min}, global batch "
                f"{bs_global} vs data axis {n_data}); streaming")
            self._mh_cache_failed = True
            return False
        rpb = bs_global // n_data   # rows each block gives a step
        xs, aps = [], []
        for batch in self.train_loader:
            xs.append(self._assemble_inputs(batch))
            aps.append(np.asarray(batch["ap"], dtype=np.float32))
        g = len(mine)
        n_local = sum(x.shape[0] for x in xs)
        r_block = mh.global_min(n_local // g if g else 0)
        over = False
        if r_block >= rpb:
            x_loc = np.concatenate(xs, axis=0)[: g * r_block]
            a_loc = np.concatenate(aps, axis=0)[: g * r_block]
            over = x_loc.nbytes + a_loc.nbytes > self._device_cache_gb * 1e9
        if mh.global_any(r_block < rpb or over):
            self.log.info(
                f"multihost trial cache fallback (rows/block {r_block} vs "
                f"{rpb} needed, over-cap: {over}); streaming per step")
            self._mh_cache_failed = True
            return False
        self._init_if_needed()
        self._staged_bytes = x_loc.nbytes + a_loc.nbytes
        self._dev_data = (self._to_device(x_loc), self._to_device(a_loc))
        self._mh_cache = {"R": r_block, "g": g, "rpb": rpb,
                          "steps": r_block // rpb}
        self._block_take = mh.make_block_local_take()
        self._cached_mh_h2d_bytes = 0
        self.log.info(
            f"staged {self._staged_bytes / 1e6:.0f} MB of local trials on "
            f"{self.device} ({g} block x {r_block} rows; "
            f"{self._mh_cache['steps']} steps/epoch); multihost epochs are "
            f"now transfer-free")
        return True

    def _train_epoch_cached_multihost(self) -> dict:
        x_all, ap_all = self._dev_data
        info = self._mh_cache
        r_block, g, rpb = info["R"], info["g"], info["rpb"]
        # fresh within-block permutations every epoch (rank-local stream;
        # the step count is fixed, so the streams may differ across ranks)
        perms = np.stack([self._rng.permutation(r_block) for _ in range(g)])
        n_valid = self.mesh.shape["data"] * rpb
        losses = []
        for s in range(info["steps"]):
            idx = np.ascontiguousarray(
                perms[:, s * rpb:(s + 1) * rpb].reshape(-1), dtype=np.int32)
            self._cached_mh_h2d_bytes += idx.nbytes
            x, ap = self._block_take(x_all, ap_all, self._to_device(idx))
            losses.append(self._step(x, ap, n_valid))
        return self._epoch_result(losses)

    def train_epoch(self) -> dict:
        if self._multihost:
            if self._stage_device_dataset_multihost():
                return self._train_epoch_cached_multihost()
            return self._train_epoch_multihost()
        if self._stage_device_dataset():
            return self._train_epoch_cached()
        self._init_if_needed()
        losses = []
        prof = None
        for batch in prefetch_to_device(self.train_loader, self.device,
                                        depth=2, transform=self._host_batch):
            inputs, ap = batch["inputs"], batch["ap"]
            if self._profile_dir and prof is None and self.global_step > 2:
                prof = self._start_profiler()
                profile_until = self.global_step + self._profile_steps
            losses.append(self._step(inputs, ap, inputs.shape[0]))
            if prof is not None and self.global_step >= profile_until:
                self._stop_profiler(prof, losses[-1])
                prof = None
        if prof is not None:   # epoch shorter than the profile window
            self._stop_profiler(prof, losses[-1])
        return self._epoch_result(losses)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self._profile_from = self.global_step
        return prof

    def _stop_profiler(self, prof, last_loss: torch.Tensor) -> None:
        """Wait for the traced steps, stop, and write the chrome trace
        ``trace_steps<from>-<to>.json`` into ``profiling.dir``; the run
        traces once."""
        last_loss.item()
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, f"trace_steps"
                            f"{self._profile_from}-{self.global_step}.json")
        prof.export_chrome_trace(path)
        self.trace_paths.append(path)
        self.log.info(f"profiled steps {self._profile_from}-"
                      f"{self.global_step} into {path}")
        self._profile_dir = None

    def _stage_eval_batch(self, batch):
        """(inputs, ap, n_valid, host ap, eids); multi-process, ``inputs``
        is this rank's block of the batch padded to the data axis."""
        self._init_if_needed()
        x = self._assemble_inputs(batch)
        if self._multihost:
            pad = (-x.shape[0]) % self.mesh.shape["data"]
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)], 0)
            x, = mh.replicated_rows_to_global(self.mesh, x)
        inputs = self._to_device(x)
        if self._frozen_split:
            # frozen features, not raw video: evals rerun only the head
            with torch.no_grad():
                inputs = self.model.encode(inputs)
        ap = np.asarray(batch["ap"], np.float32)
        return (inputs, self._to_device(ap), ap.shape[0], ap,
                list(batch["eid"]))

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
        light = (phase != "test" and len(split_eids) == 1
                 and not self._multihost
                 and not self.config.get("save_plot"))
        session = {e: {"gt": [], "preds": []} for e in split_eids}
        losses, dev_outs, dev_gts = [], [], []
        eval_fn = self.model.head if self._frozen_split else self.model
        for x, ap_d, n_valid, ap, eids in self._eval_batches(loader, phase):
            out = eval_fn(x)
            if self._multihost:   # every rank's rows, in rank order
                out = mh.gather_rows(out, self._dp_group)[:n_valid]
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
                        # multi-process: no mid-train background flush;
                        # the stash is written once after the loop
                        if (not self._multihost and epoch
                                - self._last_best_flush >= self._save_every):
                            # fetch and write in the background: training
                            # continues
                            self.save_model("best", epoch, block=False)
                            self._last_best_flush = epoch
                        self._plot_figs(eval_res, epoch=epoch)
                if self._multihost:
                    line["replica_checksum"] = self._check_replicas()
                self.log.info(f"{line}")
                self.tracker.log(line, step=self.global_step)
                # a TERM may reach only some ranks: agree before anyone
                # diverges into the save barrier
                if mh.global_any(bool(preempted)):
                    # SIGTERM / Ctrl-C: persist the true-resume checkpoint;
                    # a died best flush must not abort that
                    wait_for_checkpoints(raise_errors=False)
                    self.save_model("last", epoch)
                    if self._best_params is not None:
                        self.save_model("best", self._best_epoch)
                    self.log.info(f"preempted at epoch {epoch}: model_last "
                                  f"saved, resume with --resume")
                    return self._result(best_bps, best_epoch, None,
                                        preempted=True, epoch=epoch)
        wait_for_checkpoints()   # don't race the in-flight best flush
        # the final saves run in the background, overlapped with the test
        # eval; the best re-save is skipped when the cadence flush already
        # wrote exactly the best epoch. Both capture their tensors before
        # test_model swaps the best params in.
        final_async = not self._multihost
        if self._best_params is not None \
                and self._last_best_flush != self._best_epoch:
            self.save_model("best", self._best_epoch, block=not final_async)
        self.save_model("last", num_epochs - 1, block=not final_async)
        self.log.info(f"trained {num_epochs} epochs in {time.time()-t0:.1f}s; "
                      f"best eval_bps={best_bps} @ epoch {best_epoch}")

        test_res = self.test_model()
        wait_for_checkpoints()   # artifacts must exist before returning
        if test_res:
            self._plot_figs(test_res, test=True)
            test_res["test_res"].update(best_eval_loss=best_loss,
                                        best_eval_bps=best_bps)
            if self._is_main:
                np.save(os.path.join(self.log_dir, "test_results.npy"),
                        test_res)
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
                "n_params": self.n_params,
                "features_staged": self._features_staged,
                "encode_seconds": self.encode_seconds,
                "trace_paths": list(self.trace_paths),
                "replica_checksums": list(self.replica_checksums),
                "log_dir": self.log_dir, **extra}

    def _check_replicas(self) -> str:
        """The ranks' common parameter checksum as hex; raises when the
        replicas, which must stay bitwise equal, drifted apart (every rank
        of the mesh: the model-axis copies of a data row too)."""
        self.replica_checksums.append(
            mh.check_replicas(self.params, mh.world_group()))
        return f"{self.replica_checksums[-1]:016x}"

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

    def _plot_figs(self, eval_results: dict, epoch: int = 0,
                   test: bool = False) -> None:
        """``save_plot``: the first session's trial-averaged gt/pred
        heatmaps and the first 5 neurons' traces, as PNGs beside the
        checkpoints and as the tracker's figure records."""
        if not self.config.get("save_plot") or not self._is_main:
            return
        from video_spike_torch.viz import pyplot
        from video_spike_torch.viz.plots import plot_gt_pred, plot_neurons_r2

        phase = "test" if test else "eval"
        tag = "test" if test else str(epoch)
        gt = eval_results[f"{phase}_gt"][0]
        preds = eval_results[f"{phase}_preds"][0]
        fig1 = plot_gt_pred(gt.mean(0).T, preds.mean(0).T, epoch=tag,
                            modality="ap")
        fig2 = plot_neurons_r2(gt.mean(0), preds.mean(0),
                               neuron_idx=range(min(5, gt.shape[-1])),
                               epoch=tag)
        p1 = os.path.join(self.log_dir, f"best_trial_{tag}.png")
        p2 = os.path.join(self.log_dir, f"best_neuron_{tag}.png")
        fig1.savefig(p1)
        fig2.savefig(p2)
        self.tracker.log_figure(f"best_trial_{tag}", fig1,
                                step=self.global_step, path=p1)
        self.tracker.log_figure(f"best_neuron_{tag}", fig2,
                                step=self.global_step, path=p2)
        plt = pyplot()
        plt.close(fig1)
        plt.close(fig2)

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

    def save_model(self, name: str = "last", epoch: int = 0,
                   block: bool = True) -> None:
        """``model_best`` holds params only; ``model_last`` adds the
        optimizer state and step counter for a true resume. ``block=False``
        runs the device fetch and the write on a background thread
        (:func:`wait_for_checkpoints` joins it); an async ``last`` first
        copies the live params and optimizer state on the device, since the
        next fused step updates the first kernel in place (the best stash
        is a copy already)."""
        params = (self._best_params
                  if name == "best" and self._best_params is not None
                  else self.params)
        tree = {"params": params, "epoch": epoch}
        if name == "last":
            tree["opt_state"] = self._opt_state_tree()
            tree["global_step"] = self.global_step
        if self._multihost:
            # rank 0 writes (the replicas are equal); every rank waits
            if self._is_main:
                save_checkpoint(self.log_dir, f"model_{name}", tree)
            mh.barrier()
            return
        if block:
            save_checkpoint(self.log_dir, f"model_{name}", tree)
            return
        if name == "last":
            tree = snapshot(tree)
        save_checkpoint_async(self.log_dir, f"model_{name}", tree)

    def resume(self, name: str = "last") -> bool:
        """Restore params + optimizer state + epoch from ``model_last``
        (every rank reads rank 0's file, after a barrier)."""
        wait_for_checkpoints()
        mh.barrier()
        if not checkpoint_exists(self.log_dir, f"model_{name}"):
            return False
        # the JAX trainer draws a probe batch here, which moves a shuffled
        # loader on by an epoch: drawing it too keeps a resumed run on the
        # JAX run's batch order
        next(iter(self.train_loader))
        self._init_if_needed()
        restored = load_checkpoint(self.log_dir, f"model_{name}", self.device)
        self._set_params(restored["params"])
        self._load_opt_state(restored["opt_state"])
        self.global_step = int(restored["global_step"])
        self._start_epoch = int(restored["epoch"]) + 1
        self.log.info(f"resumed from epoch {restored['epoch']} "
                      f"(step {self.global_step})")
        return True
