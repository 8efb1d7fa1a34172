"""Self-supervised (contrastive / masked-autoencoding) trainer on one device.

Counterpart of ``video_spike_tpu/train/contrast.py`` (reference
``src/trainer/contrast.py:10-246``):

- step-based ``fit()`` to ``max_steps`` over the frame loader; each step
  stacks the (ref, pos, neg) triplet into one (3B, C, H, W) forward and
  splits the outputs back (scalars such as the reconstruction loss of the
  whole stacked batch and the temperature stay shared), then applies the
  ``loss_fn_`` dispatch (InfoNCE / + recon / MAE-only);
- the optimizer is AdamW with a constant learning rate, as in the JAX
  trainer (the yaml's scheduler is not read); masking noise for step k is
  drawn from a ``torch.Generator`` seeded from (seed, k), so a resumed run
  draws the same masks as an uninterrupted one;
- the whole uint8 pretrain frame array is staged on the device once when it
  fits ``frame_cache_gb``, and each step gathers its triplet there by an
  int64 index; a larger dataset streams its triplets instead. Either way a
  producer thread (``data/prefetch.background``) samples and copies the
  next batches while the current step runs;
- after every pass over the loader (or at ``validate_every`` steps),
  ``_validate()`` embeds the train and val trial loaders at mask ratio 0,
  subsamples the frame axis with the seeded ``default_rng(seed +
  1_000_003)`` stream, fits a nested RRR model on the embeddings and
  reports ``val_bps``; an improvement stashes a device copy of the params
  and writes ``best_model.pt`` and ``best_model.meta.json`` at once;
- ``last_model.pt`` (params, AdamW state, step, best bps) plus the
  ``last_model.sampler.json`` sidecar (epoch-start sampler state, batches
  consumed, step stamp) is written at the end, on the
  ``save_every_steps`` / ``save_every_min`` cadence and on SIGTERM /
  Ctrl-C (``graceful_stop``); ``resume()`` continues mid-epoch on the exact
  batch stream;
- ``transform()`` embeds a trial loader at mask ratio 0, staging its frames
  on the device once (weakly keyed by loader, capped by
  ``device_cache_gb``).

Checkpoints are written synchronously (``train/checkpoint.py``). Not in
this slice (ROADMAP.md Queue A item 10): the device mesh, multihost and the
lr / batch scaling by the data axis (item 14), the ``Tracker`` / wandb and
asynchronous checkpoint flushes.
"""

from __future__ import annotations

import itertools
import json
import os
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.data.contrast import device_frame_transform
from video_spike_torch.data.prefetch import background
from video_spike_torch.ops.contrastive import loss_fn_
from video_spike_torch.ops.optim import AdamW, apply_updates
from video_spike_torch.train.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from video_spike_torch.train.rrr_pipeline import train_rrr

_MASK63 = (1 << 63) - 1


class ContrastTrainer:
    def __init__(self, model, data_loader, optimizer_config=None, *,
                 val_data_loader=None, train_data_loader=None,
                 max_steps: int = 1000, criterion=loss_fn_,
                 eid: str = "", log_dir: str = "logs",
                 image_size: int = 144, seed: int = 42, log=None,
                 validate_every: Optional[int] = None,
                 device_cache_gb: float = 6.0,
                 frame_cache_gb: float = 2.0,
                 save_every_steps: Optional[int] = None,
                 save_every_min: Optional[float] = 10.0,
                 flush_best: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.data_loader = data_loader
        self.val_data_loader = val_data_loader
        self.train_data_loader = train_data_loader
        self.max_steps = max_steps
        # None -> validate after each pass over the loader (reference
        # behavior); an int decouples validation cadence from epoch length
        self.validate_every = validate_every
        self.criterion = criterion
        self.eid = eid
        self.image_size = image_size
        self.model_name = type(model).__name__
        self._is_mae = self.model_name == "MAE"
        self.log = log or make_logger(header="[ssl]")
        self.log_dir = os.path.join(log_dir, eid, self.model_name,
                                    str(max_steps))
        os.makedirs(self.log_dir, exist_ok=True)

        opt = optimizer_config or {}
        self.tx = AdamW(opt.get("lr", 1e-4), weight_decay=opt.get("wd", 0.01),
                        eps=opt.get("eps", 1e-8))
        self._seed = int(seed)
        self._mask_gen = torch.Generator(device=self.device)
        # dedicated stream for the nested-RRR validation subsample, so the
        # best-checkpoint choice is reproducible run to run
        self._val_rng = np.random.default_rng(seed + 1_000_003)
        self._step_count = 0
        self._initialized = False
        self.n_params = 0
        self.opt_state = None
        self._best_params = None
        self._start_step = 0
        self._best_bps = -np.inf
        self._best_step = -1
        self._best_on_disk = None       # step of the best_model.pt on disk
        self.train_losses: list = []    # per step, fetched at the log cadence
        self._pending_losses: list = []
        self.val_history: list = []
        # mid-epoch resume: sampler snapshot at the current epoch's start +
        # how many batches of it the train loop has consumed
        self._sampler_epoch_start = None
        self._epoch_consumed = 0
        self._resume_skip = 0
        # transform-loader staging cache: weakly keyed so a dead loader's
        # device buffers go with it, byte-capped so large splits stream
        self._transform_cache = weakref.WeakKeyDictionary()
        self._device_cache_gb = float(device_cache_gb)
        self._frame_cache_gb = float(frame_cache_gb)
        self._frame_cache = None
        self._frame_cache_tried = False
        self._save_every_steps = save_every_steps
        self._save_every_min = save_every_min
        self._flush_best = flush_best
        self._last_save_t = time.time()
        self._last_save_step = 0

    # ------------------------------------------------------------------
    # parameters and the step
    # ------------------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def _set_params(self, new: Dict[str, torch.Tensor]) -> None:
        named = dict(self.model.named_parameters())
        for k, t in new.items():
            named[k].data = t

    def _init_if_needed(self) -> None:
        if self._initialized:
            return
        self.model.to(self.device)
        self.model.reset_parameters(
            torch.Generator(device=self.device).manual_seed(self._seed))
        self.opt_state = self.tx.init(self.params)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self.log.info(f"{self.model_name}: {self.n_params/1e6:.1f}M params, "
                      f"max_steps={self.max_steps}, device={self.device}")
        self._initialized = True

    def _next_generator(self) -> torch.Generator:
        """The masking generator of the next step, seeded from (seed, step)
        like the JAX trainer's ``fold_in(key, step)``."""
        self._step_count += 1
        return self._mask_gen.manual_seed(
            (self._seed * 0x9E3779B97F4A7C15 + self._step_count) & _MASK63)

    def _train_step(self, trip: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One AdamW step on a uint8 triplet (3, B, C, H, W) — or, for
        MAE, a frame batch (B, C, H, W) — on the device."""
        named = dict(self.model.named_parameters())
        gen = self._next_generator()
        size = self.image_size
        if self._is_mae:
            out = self.model(device_frame_transform(trip, size),
                             generator=gen)
            loss, aux = self.criterion(out, None, None)["loss"], {}
        else:
            # (3, B, ...) -> (3B, ...): one large batch with the
            # [all-ref | all-pos | all-neg] row layout
            b = trip.shape[1]
            x = device_frame_transform(trip.reshape(-1, *trip.shape[2:]),
                                       size)
            out = self.model(x, generator=gen)
            ref, pos, neg = ({k: v[i * b:(i + 1) * b] if v.ndim > 0 else v
                              for k, v in out.items()} for i in range(3))
            loss_dict = self.criterion(ref, pos, neg)
            loss = loss_dict["loss"]
            aux = {k: v.detach() for k, v in loss_dict.items() if k != "loss"}
            if "temp" in ref:
                aux["temperature"] = ref["temp"].detach()
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        # a parameter the loss does not reach (ContrastViT's mask_token,
        # the fixed temperature) has a zero gradient, as under jax.grad;
        # AdamW still decays it
        grads = {k: g if g is not None else torch.zeros_like(p)
                 for (k, p), g in zip(named.items(), grads)}
        with torch.no_grad():
            params = self.params
            updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                     params)
            self._set_params(apply_updates(params, updates))
        return {"loss": loss.detach(), **aux}

    # ------------------------------------------------------------------
    # input staging
    # ------------------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _maybe_stage_frames(self) -> bool:
        """Stage the pretrain loader's whole uint8 frame array on the device
        once. True when the cache is live; False (with the reason logged)
        keeps the streamed per-batch path. Decided on the first call."""
        if self._frame_cache is not None:
            return True
        if self._frame_cache_tried:
            return False
        self._frame_cache_tried = True
        ds = getattr(self.data_loader, "dataset", None)
        video = getattr(ds, "video", None)
        if video is None or getattr(ds, "mode", "") != "pretrain":
            return False
        gb = video.nbytes / 1e9
        if gb > self._frame_cache_gb:
            self.log.info(
                f"pretrain frames ({gb:.2f} GB) exceed the "
                f"{self._frame_cache_gb} GB device frame cache; streaming "
                f"batches instead")
            return False
        self._frame_cache = self._to_device(np.asarray(video))
        self.log.info(
            f"staged {video.shape[0]} pretrain frames ({gb * 1e3:.0f} MB "
            f"uint8) on {self.device}; per-step H2D is the index array")
        return True

    def _stage_index_batch(self, ib: Dict[str, np.ndarray]) -> torch.Tensor:
        """Index batch -> int64 device tensor, (3, B) or (B,) for MAE. Runs
        in fit()'s producer thread."""
        if self._is_mae:
            idx = np.asarray(ib["ref"])
        else:
            idx = np.stack([ib["ref"], ib["pos"], ib["neg"]])
        return self._to_device(idx.astype(np.int64))

    def _stage_step_batch(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Host batch -> uint8 device triplet (3, B, C, H, W), or the ref
        frames for MAE. Runs in fit()'s producer thread."""
        if self._is_mae:
            return self._to_device(np.asarray(batch["ref"]))
        return self._to_device(np.stack([np.asarray(batch["ref"]),
                                         np.asarray(batch["pos"]),
                                         np.asarray(batch["neg"])]))

    def _step_staged(self, staged: torch.Tensor, cur_step: int) -> Dict:
        """One train step on a producer-staged input: an index tensor when
        the frame cache is live, a device triplet otherwise."""
        trip = (self._frame_cache[staged] if self._frame_cache is not None
                else staged)
        return {"cur_step": cur_step, **self._train_step(trip)}

    def _epoch_batches(self, skip: int = 0, index: bool = False):
        """One pass over the pretrain loader; ``skip`` (mid-epoch resume)
        fast-forwards past the first ``skip`` batches while consuming their
        draws, so the sampling stream stays aligned."""
        if skip == 0 and not index:
            return iter(self.data_loader)
        ds = self.data_loader.dataset
        fn = ds.iter_index_batches if index else ds.iter_batches
        return fn(self.data_loader.batch_size,
                  shuffle=getattr(self.data_loader, "shuffle", True),
                  skip=skip)

    def _staged_epoch_stream(self, skip: int = 0, depth: int = 2):
        """Producer-thread pipeline for one epoch: host sampling and the
        host-to-device copy run ``depth`` batches ahead of the step."""
        cached = self._frame_cache is not None

        def staged():
            if cached:
                for ib in self._epoch_batches(skip=skip, index=True):
                    yield self._stage_index_batch(ib)
            else:
                for b in self._epoch_batches(skip=skip):
                    yield self._stage_step_batch(b)

        return background(staged(), depth=depth)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def _log_losses(self, logs: Optional[Dict]) -> None:
        """Fetch the losses since the last cadence in one sync; log `logs`
        (one step's outputs) beside them."""
        vals = torch.stack(self._pending_losses).float().cpu().tolist()
        self.train_losses.extend(vals)
        self._pending_losses = []
        if logs is not None:
            self.log.info(str({k: float(v) if isinstance(v, torch.Tensor)
                               else v for k, v in logs.items()}))

    def fit(self) -> float:
        from video_spike_torch.core.preempt import graceful_stop

        self.log.info("Starting fitting!")
        self._init_if_needed()
        self._maybe_stage_frames()
        current_step = self._start_step
        best_bps = self._best_bps
        start = time.time()
        # periodic-save cadence counts from this fit's start (resume included)
        self._last_save_t = start
        self._last_save_step = current_step
        last_validation = current_step
        stop = False
        with graceful_stop(self.log) as preempted:
            while current_step < self.max_steps and not stop:
                # snapshot the sampler before the epoch iterator draws its
                # shuffle: (snapshot, consumed) written by _save_last lets
                # resume() replay this epoch's stream exactly
                ds = getattr(self.data_loader, "dataset", None)
                if ds is not None and hasattr(ds, "sampler_state"):
                    self._sampler_epoch_start = ds.sampler_state()
                skip, self._resume_skip = self._resume_skip, 0
                self._epoch_consumed = skip
                stream = self._staged_epoch_stream(skip=skip)
                try:
                    for staged in stream:
                        self._epoch_consumed += 1
                        logs = self._step_staged(staged, current_step)
                        self._pending_losses.append(logs["loss"])
                        if current_step % 50 == 0:
                            self._log_losses(logs)
                        current_step += 1
                        if current_step >= self.max_steps or preempted:
                            break
                        if self._periodic_save_due(current_step):
                            self._save_last_periodic(current_step)
                finally:
                    # join the producer thread now: the next sampler
                    # snapshot (and the sidecar) must see a quiescent stream
                    stream.close()
                if preempted:
                    # skip the nested-RRR validation inside the grace window
                    stop = True
                    break
                if (self.validate_every is not None
                        and current_step - last_validation < self.validate_every
                        and current_step < self.max_steps):
                    continue
                last_validation = current_step
                val = self._validate()
                self.val_history.append({"step": current_step, **val})
                self.log.info(f"{val}")
                if val["val_bps"] > best_bps:
                    best_bps = val["val_bps"]
                    self._best_bps = best_bps
                    self._best_step = current_step
                    self.log.info(f"Best val bps: {best_bps}")
                    # a device stash for transform(use_best=True) ...
                    self._best_params = {k: v.clone()
                                         for k, v in self.params.items()}
                    if self._flush_best:
                        # ... and on disk at once
                        self._flush_best_model(current_step)
            if stop:
                self.log.info(f"preempted at step {current_step}: saving "
                              f"best_model + last_model before exit")
        if self._pending_losses:
            self._log_losses(None)
        self._best_bps = best_bps
        if self._best_params is not None \
                and self._best_on_disk != self._best_step:
            self._flush_best_model(self._best_step)
        self._save_last(current_step)
        self.log.info(f"Training took: {time.time()-start:.1f} seconds")
        return best_bps

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _sidecar_state(self, step: int) -> Optional[Dict]:
        """The mid-epoch resume sidecar at the call: epoch-start sampler
        snapshot + batches the train loop has consumed + the step stamp
        pairing it with one checkpoint. The producer prefetches ahead, but
        replay restores the epoch-start state and re-draws the consumed
        batches, so the snapshot holds wherever the prefetch has got to."""
        if self._sampler_epoch_start is None:
            return None
        return {"epoch_start": self._sampler_epoch_start,
                "consumed": int(self._epoch_consumed),
                "step": int(step)}

    def _write_json(self, name: str, state: Optional[Dict]) -> None:
        """Atomically (re)write ``log_dir/name``, or remove it when `state`
        is None."""
        path = os.path.join(self.log_dir, name)
        if state is None:
            if os.path.exists(path):
                os.remove(path)
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def _save_last(self, step: int) -> None:
        """True-resume checkpoint: params + AdamW state + step + running
        best, then the sampler sidecar (a stale sidecar never pairs with a
        newer checkpoint: resume() checks the step stamp)."""
        state = self._sidecar_state(step)
        try:
            save_checkpoint(self.log_dir, "last_model", {
                "params": self.params, "opt_state": self.opt_state,
                "step": step, "best_bps": float(self._best_bps)})
        except OSError as e:
            self.log.error(f"Error saving last_model: {e}")
            return
        try:
            self._write_json("last_model.sampler.json", state)
        except OSError as e:
            self.log.error(f"Error saving the sampler sidecar (resume "
                           f"will fall back to an epoch boundary): {e}")
            self._write_json("last_model.sampler.json", None)

    def _periodic_save_due(self, step: int) -> bool:
        """Step- or wall-clock-cadence check for the mid-run save."""
        if self._save_every_steps \
                and step - self._last_save_step >= self._save_every_steps:
            return True
        return bool(self._save_every_min) and (
            time.time() - self._last_save_t >= self._save_every_min * 60)

    def _save_last_periodic(self, step: int) -> None:
        self._last_save_t = time.time()
        self._last_save_step = step
        self.log.info(f"periodic last_model save @ step {step}")
        self._save_last(step)

    def _flush_best_model(self, step: int) -> None:
        """Write the stashed best params and then ``best_model.meta.json``
        (best bps + step). The meta follows the checkpoint, so it can
        understate a best on disk but never claim one that is not;
        resume() restores the running best from it."""
        if self._save_model("best_model"):
            self._best_on_disk = step
            try:
                self._write_json("best_model.meta.json",
                                 {"best_bps": float(self._best_bps),
                                  "step": int(step)})
            except OSError as e:
                self.log.error(f"Error saving best_model.meta.json: {e}")

    def resume(self, name: str = "last_model") -> bool:
        """Restore params + AdamW state + step from ``last_model`` and
        continue ``fit()`` from there; with the sampler sidecar present the
        data stream resumes mid-epoch bit-exactly (sampler state restored,
        consumed batches fast-forwarded draw for draw)."""
        if not checkpoint_exists(self.log_dir, name):
            return False
        self._init_if_needed()
        restored = load_checkpoint(self.log_dir, name, self.device)
        self._set_params(restored["params"])
        self.opt_state = restored["opt_state"]
        self._start_step = int(restored["step"])
        self._step_count = self._start_step
        self._best_bps = float(restored["best_bps"])
        # the checkpoint's running best can predate a flushed best_model
        # (a periodic last_model from before the validation that found it);
        # take the max so a later worse validation never overwrites it
        meta_path = os.path.join(self.log_dir, "best_model.meta.json")
        if os.path.exists(meta_path) and checkpoint_exists(self.log_dir,
                                                           "best_model"):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                if float(meta.get("best_bps", -np.inf)) > self._best_bps:
                    self._best_bps = float(meta["best_bps"])
                    self._best_step = int(meta.get("step", -1))
                    self._best_on_disk = self._best_step
                    self.log.info(
                        f"restored flushed best val_bps {self._best_bps} "
                        f"(step {self._best_step}) from best_model.meta")
            except (ValueError, OSError) as e:
                self.log.warning(f"unreadable best_model.meta.json ({e}); "
                                 f"keeping the checkpoint's best_bps")
        sidecar = os.path.join(self.log_dir, "last_model.sampler.json")
        ds = getattr(self.data_loader, "dataset", None)
        if os.path.exists(sidecar) and ds is not None \
                and hasattr(ds, "set_sampler_state"):
            with open(sidecar) as f:
                state = json.load(f)
            if int(state.get("step", -1)) != self._start_step:
                self.log.warning(
                    f"sampler sidecar step {state.get('step')} does not "
                    f"match checkpoint step {self._start_step}; ignoring it "
                    f"(epoch-boundary resume with a fresh shuffle)")
            else:
                ds.set_sampler_state(state["epoch_start"])
                self._resume_skip = int(state["consumed"])
                self.log.info(f"sampler resumed mid-epoch: skipping "
                              f"{self._resume_skip} consumed batches")
        self.log.info(f"resumed from step {self._start_step} "
                      f"(best val_bps {self._best_bps})")
        return True

    def _save_model(self, name: str) -> bool:
        params = (self._best_params if name == "best_model"
                  and self._best_params is not None else self.params)
        try:
            save_checkpoint(self.log_dir, name, {"params": params})
            return True
        except OSError as e:  # keep training on checkpoint failure
            self.log.error(f"Error saving the model: {e}")
            return False

    def _load_model(self, name: str) -> bool:
        if not checkpoint_exists(self.log_dir, name):
            self.log.warning(f"Path does not exist: "
                             f"{os.path.join(self.log_dir, name)}.pt")
            return False
        self._init_if_needed()
        self._set_params(load_checkpoint(self.log_dir, name,
                                         self.device)["params"])
        return True

    # ------------------------------------------------------------------
    # validation and embedding
    # ------------------------------------------------------------------
    def _validate(self) -> Dict:
        train_emb, train_y = self.transform(self.train_data_loader,
                                            return_neural=True)
        val_emb, val_y = self.transform(self.val_data_loader,
                                        return_neural=True)
        train_n, val_n = train_y.shape[0], val_y.shape[0]
        e_dim = train_emb.shape[-1]
        train_emb = train_emb.reshape(train_n, -1, e_dim)
        val_emb = val_emb.reshape(val_n, -1, e_dim)
        t_frames = train_emb.shape[1]
        # the reference's literal 100 is its t_bins (subsample the frame
        # axis down to the spike-bin count, src/trainer/contrast.py:139)
        n_keep = min(train_y.shape[1], t_frames)
        idx = np.sort(self._val_rng.choice(max(t_frames - 1, n_keep), n_keep,
                                           replace=False))
        data_dict = {self.eid: {
            "X": [train_emb[:, idx], val_emb[:, idx]],
            "y": [train_y, val_y],
            "setup": {},
        }}
        rrr_result = train_rrr(data_dict, device=self.device)
        return {"val_bps": float(np.nanmean(rrr_result[self.eid]["bps"]))}

    def _stage_batch(self, batch):
        """One transform batch -> (uint8 frames on the device, neural)."""
        ref = np.asarray(batch["ref"])
        if ref.ndim == 5:  # (B, T, C, H, W) trials -> a frame batch
            ref = ref.reshape(-1, *ref.shape[2:])
        neural = np.asarray(batch["neural"]) if "neural" in batch else None
        return self._to_device(ref), neural

    def _transform_batches(self, data_loader):
        """Stage a transform loader's uint8 frames on the device once (the
        nested-RRR validation re-embeds the same frames at every cadence);
        loaders above ``device_cache_gb`` stream instead."""
        entry = self._transform_cache.get(data_loader, False)
        if entry is not False:
            if entry is not None:
                return entry
            return (self._stage_batch(b) for b in data_loader)  # too big
        staged, nbytes = [], 0
        cap = self._device_cache_gb * 1e9
        it = (self._stage_batch(b) for b in data_loader)
        for item in it:
            staged.append(item)
            nbytes += item[0].nbytes
            if nbytes > cap:
                self.log.info(
                    f"transform loader exceeds {self._device_cache_gb} GB "
                    f"device cache; streaming embeds")
                self._transform_cache[data_loader] = None
                return itertools.chain(staged, it)
        self._transform_cache[data_loader] = staged
        return staged

    @torch.no_grad()
    def transform(self, data_loader, use_best: bool = False,
                  return_neural: bool = False):
        """Embed every frame of a (trial-level) loader with mask_ratio=0."""
        self._init_if_needed()
        if use_best:
            if self._best_params is not None:   # same process: device copy
                self._set_params(self._best_params)
            else:
                self._load_model("best_model")
        neurals, outs = [], []
        for frames, neural in self._transform_batches(data_loader):
            out = self.model(device_frame_transform(frames, self.image_size),
                             mask_ratio=0.0)
            if "z" not in out:
                raise KeyError("No embedding found in the model output!")
            outs.append(out["z"])               # fetched after all batches
            if neural is not None:
                neurals.append(neural)
        feats = torch.cat(outs, dim=0).float().cpu().numpy()
        if return_neural:
            neurals = np.concatenate(neurals, axis=0)
            if neurals.ndim == 4:  # (B, 1?, T, N) guard
                neurals = neurals.reshape(-1, *neurals.shape[-2:])
            return feats, neurals
        return feats


def make_contrast_trainer(**kwargs) -> ContrastTrainer:
    """Factory (reference ``src/trainer/make.py:20-33``)."""
    return ContrastTrainer(**kwargs)
