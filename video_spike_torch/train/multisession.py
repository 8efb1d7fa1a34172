"""Multi-session training for the end-to-end video -> spike flagship.

Counterpart of ``video_spike_tpu/train/multisession.py`` on one device.
Trials from several sessions train one model. Sessions have different
neuron counts, so spike targets are padded to ``max_neurons`` and the
Poisson NLL is masked per (valid trial × valid neuron) element; evaluation
reports bits per spike and R² per session over its real neurons only.

- Training trials of every session are staged on the device once
  (``training.device_cache``, capped at ``device_cache_gb``); each step
  gathers its batch there with ``index_select``, so batches mix sessions
  (the model gathers each trial's head). The ragged last batch is padded by
  repeating indices and masked by its valid-row count. A dataset over the
  cap takes the streaming path instead: single-session batches round-robin
  over the sessions, each padded to the batch size.
- The losses of an epoch reach the host in one fetch at its end.
- Eval inputs are staged on the device once, within what the train cache
  left of the cap; the light eval computes every session's bps and R² on
  the device and fetches them in one sync. ``return_outputs`` fetches the
  predictions and scores them on the host with ``metrics_list``.
- Improvements of eval bps stash a device copy of the params; it is written
  to ``model_best.pt`` in the background at the ``save_every`` cadence and
  at the end. ``model_last.pt`` (params, optimizer state, epoch, step, best
  bps) is the resume point: a device copy written after training in the
  background, overlapped with the test eval, and joined before
  ``test_results.npy``; SIGTERM / Ctrl-C joins the
  flushes (a failed one is logged), saves it synchronously and returns.
  ``test_results.npy`` holds ``test_res`` and ``per_session``. The
  streaming loop copies each batch synchronously, as in the JAX trainer.
- The optimizer is ``ops/optim.make_optimizer``'s, every variant and
  gradient accumulation included, by ``ops/step.py`` inside a ``vs.step``
  (loads and the best stash are copied into the live leaves).
- Every epoch's line goes to ``<log_dir>/metrics.jsonl``
  (``core/tracking``); ``save_plot`` fetches the eval and test outputs and
  writes ``best_{trial,neuron}_<eid5>_<tag>.png`` per session at each new
  best epoch and for the test split, each also a figure record.
- Under a process group (``core/runtime``) the ranks train data-parallel
  on the mesh's ``data`` axis (``training.mesh``): each rank streams its
  shard of every session (``parallel/multihost``), drops ragged tails, and
  runs the step count the ranks agree on (``global_min``); a step's loss
  divides by the global valid-element count and the gradients and loss are
  all-reduced with SUM. Eval rows are split over the ranks and the
  predictions gathered; a preemption is agreed with ``global_any``; rank 0
  alone writes, synchronously, and every rank reads after a barrier; the
  ranks compare parameter checksums after each epoch. Under
  ``training.mesh: {data: D, model: M}`` the parameters stay replicated on
  all D·M ranks (as in the JAX trainer): the M ranks of a data row read
  the same shards and run the same rows, the collectives above go over
  the ``data`` group, and the checksums compare all D·M ranks.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from video_spike_torch.core.device import resolve_device
from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.core.spans import span
from video_spike_torch.core.tracking import Tracker
from video_spike_torch.data.dataset import SessionDataset, split_dataset
from video_spike_torch.ops.metrics import device_eval_metrics, metrics_list
from video_spike_torch.ops.optim import make_optimizer
from video_spike_torch.ops.poisson import poisson_nll
from video_spike_torch.ops.step import train_step
from video_spike_torch.parallel import multihost as mh
from video_spike_torch.parallel.mesh import make_mesh
from video_spike_torch.train.checkpoint import (
    checkpoint_exists,
    copy_into,
    load_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
    snapshot,
    wait_for_checkpoints,
)


def masked_poisson_nll(log_rates: torch.Tensor, targets: torch.Tensor,
                       neuron_mask: torch.Tensor,
                       n_valid_rows, group=None) -> torch.Tensor:
    """Mean Poisson NLL over (valid trial, any bin, valid neuron) elements.
    neuron_mask: (B, N_max) 0/1; n_valid_rows: the leading valid rows. With
    a data ``group`` the element count is the group's: this rank's share of
    the global mean."""
    nll = poisson_nll(log_rates, targets)
    b, t = log_rates.shape[:2]
    rows = (torch.arange(b, device=nll.device) < n_valid_rows).to(nll.dtype)
    mask = rows[:, None, None] * neuron_mask[:, None, :]  # (B, 1, N)
    # mask broadcasts over the T axis, so the element count is sum(mask) * T
    count = mh.all_sum(mask.sum() * t, group)
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def make_vtt_tensor_step(model, params: Dict[str, torch.Tensor], mesh, tx):
    """The tensor-sharded VTT train step under the production sharding
    rules (the JAX package's ``DCN_MODE=tensor`` / ``_dryrun_body`` step):
    `params` (full values, the same on every rank) are placed by
    ``models/vtt.vtt_sharding_rules``, `model` runs their split
    (``parallel/tensor.split_over_model``), and ``step(params, opt_state,
    video, ap, sids, nmask)`` takes this rank's data block of the batch, with
    :func:`masked_poisson_nll` over the global batch, value and grad, and
    ``tx`` on each rank's blocks (copies of ``params``', stepped in place).
    The gradients and the loss are summed over the ``data`` group only: the
    split layers all-reduce their input gradients. Returns ``(step,
    params, opt_state, placements)``; ``multihost.gather_tree(params,
    placements)`` gives the full values back."""
    from video_spike_torch.models.vtt import vtt_sharding_rules
    from video_spike_torch.parallel.tensor import split_over_model

    rules = vtt_sharding_rules(params, mesh)
    params = {k: v.clone() for k, v in mh.put_tree(params, rules).items()}
    _, whole = split_over_model(model, rules)
    if whole:
        raise ValueError(f"the tensor-sharded step runs every split leaf "
                         f"split; these it cannot: {list(whole)}")
    group = mesh.group("data")

    def step(params, opt_state, video, ap, sids, nmask):
        def loss_fn(leaves):
            out = torch.func.functional_call(model, leaves, (video, sids))
            return masked_poisson_nll(out, ap, nmask, video.shape[0],
                                      group), None

        params, opt_state, loss, _ = train_step(loss_fn, params, opt_state,
                                                tx, group=group)
        return params, opt_state, loss

    return step, params, tx.init(params), rules


class MultiSessionTrainer:
    """Mixed-session staged batches (or single-session round-robin
    streaming) through one train step on one device, or data-parallel
    across the ranks of a process group."""

    def __init__(self, model, config, eids: Sequence[str], data_dir: str,
                 log_dir: str = "results_multi", seed: int = 42,
                 max_neurons: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        mesh_cfg = config.training.get("mesh", {}) or {}
        # under a model axis the parameters stay replicated (as in the JAX
        # trainer) and the ranks of a data row run the same rows
        mesh = make_mesh(n_data=mesh_cfg.get("data"),
                         n_model=mesh_cfg.get("model", 1))
        self.mesh = mesh
        self._dp_group = mesh.group("data")
        self._multihost = mh.is_multihost()
        self._is_main = mh.process_index() == 0
        self.replica_checksums: list = []
        self.model = model
        self.config = config
        self.eids = list(eids)
        self.sid = {e: i for i, e in enumerate(self.eids)}
        self.log = make_logger(header="[multisession]")
        if config.get("save_plot"):
            from video_spike_torch.viz import pyplot

            pyplot()   # no matplotlib: fail now, not after training
        self.log_dir = os.path.join(log_dir, "multi_" + "_".join(
            e[:5] for e in self.eids))
        os.makedirs(self.log_dir, exist_ok=True)
        self.tracker = Tracker(self.log_dir, name="multisession")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        mods = ["ap", "video", "timestamp"]
        bs = config.training.train_batch_size
        self.splits = {}
        self.train_loaders: Dict[str, SessionDataset] = {}
        self.val_loaders: Dict[str, SessionDataset] = {}
        self.test_loaders: Dict[str, SessionDataset] = {}
        self.n_neurons: Dict[str, int] = {}
        for eid in self.eids:
            split = split_dataset(data_dir, eid=eid, seed=seed)
            self.splits[eid] = split
            # this rank's training shard; val/test stay whole on every rank
            self.train_loaders[eid] = SessionDataset(
                mh.shard_files_for_process(split["train"],
                                           mesh.shape["model"]),
                bs, shuffle=True,
                seed=seed, modalities=mods)
            self.val_loaders[eid] = SessionDataset(
                split["val"], bs, modalities=mods)
            self.test_loaders[eid] = SessionDataset(
                split["test"], bs, modalities=mods)
            probe = next(iter(self.val_loaders[eid]
                              if split["val"] else self.train_loaders[eid]))
            self.n_neurons[eid] = probe["ap"].shape[2]
        self.max_neurons = max_neurons or max(self.n_neurons.values())

        # global steps an epoch: each data row takes one per local batch
        steps_per_epoch = sum(len(split["train"]) // bs
                              for split in self.splits.values())
        steps_per_epoch //= mesh.shape["data"]
        self.tx, self.schedule = make_optimizer(
            config, steps_per_epoch * config.training.num_epochs)
        self.opt_state = None
        self.n_params = 0
        self._initialized = False
        self.global_step = 0
        self._start_epoch = 0
        self._best_bps = -np.inf
        self._best_params = None
        self._best_epoch = -1
        self._last_best_flush = -(1 << 30)
        self._save_every = int(config.training.get("save_every", 100) or 100)
        self._staged_bytes = 0
        self._rng = np.random.default_rng(seed)
        self._device_cache_enabled = bool(
            config.training.get("device_cache", True))
        self._device_cache_gb = float(
            config.training.get("device_cache_gb", 6.0))
        self._dev_data = None
        self._n_train = 0
        self._eval_input_cache: dict = {}
        self.train_losses: list = []
        self.eval_history: list = []

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

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _init_if_needed(self) -> None:
        if self._initialized:
            return
        self.model.to(self.device)
        self.model.reset_parameters(self.generator)
        self.opt_state = self.tx.init(self.params)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self.log.info(f"VTT: {self.n_params/1e6:.1f}M params, sessions="
                      f"{self.eids}, max_neurons={self.max_neurons}, "
                      f"device={self.device}")
        self._initialized = True

    def _train_step(self, video, ap, sids, nmask, n_valid) -> torch.Tensor:
        def loss_fn(_):
            return masked_poisson_nll(self.model(video, sids), ap, nmask,
                                      n_valid, self._dp_group), None

        with span("step"):
            params, self.opt_state, loss, _ = train_step(
                loss_fn, self.params, self.opt_state, self.tx,
                leaves=dict(self.model.named_parameters()),
                group=self._dp_group)
            self._set_params(params)
        self.global_step += 1
        return loss

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _session_arrays(self, batch: Dict[str, np.ndarray], eid: str):
        """(uint8 video, spikes padded to max_neurons, session ids, neuron
        mask) of one session's batch, on the host."""
        video = np.asarray(batch["video"], dtype=np.uint8)
        ap = np.asarray(batch["ap"], dtype=np.float32)
        ap = np.pad(ap, ((0, 0), (0, 0), (0, self.max_neurons - ap.shape[2])))
        sids = np.full((video.shape[0],), self.sid[eid], np.int64)
        nmask = np.zeros((video.shape[0], self.max_neurons), np.float32)
        nmask[:, :self.n_neurons[eid]] = 1.0
        return video, ap, sids, nmask

    def _pad_batch(self, batch: Dict[str, np.ndarray], eid: str, rows: int):
        """Device tensors (video, ap, sids, neuron mask) and n_valid, the
        rows padded to `rows` by repeating the last trial (masked out of
        the loss by n_valid)."""
        arrays = self._session_arrays(batch, eid)
        b = arrays[0].shape[0]
        if b < rows:
            arrays = [np.concatenate([x, np.repeat(x[-1:], rows - b, 0)])
                      for x in arrays]
        return (*(self._to_device(x) for x in arrays), b)

    def _interleaved_batches(self):
        """Round-robin over session loaders so every step is single-session
        but sessions mix within the epoch."""
        iters = {e: iter(self.train_loaders[e]) for e in self.eids}
        live = set(self.eids)
        while live:
            for eid in self.eids:
                if eid not in live:
                    continue
                try:
                    yield eid, next(iters[eid])
                except StopIteration:
                    live.discard(eid)

    def _stage_device_dataset(self) -> bool:
        """Stage every session's training trials on the device with padded
        spike targets, per-trial session ids and neuron masks; False (and
        the streaming path from then on) when they exceed the cap."""
        if self._dev_data is not None:
            return True
        if not self._device_cache_enabled:
            return False
        parts = [self._session_arrays(batch, eid) for eid in self.eids
                 for batch in self.train_loaders[eid]]
        V, A, S, M = (np.concatenate(x, 0) for x in zip(*parts))
        if V.nbytes + A.nbytes > self._device_cache_gb * 1e9:
            self.log.info("dataset exceeds device cache cap; streaming")
            self._device_cache_enabled = False
            return False
        self._n_train = V.shape[0]
        self._staged_bytes = V.nbytes + A.nbytes
        self._init_if_needed()
        self._dev_data = tuple(self._to_device(x) for x in (V, A, S, M))
        self.log.info(f"staged {V.nbytes/1e6:.0f} MB across "
                      f"{len(self.eids)} sessions on {self.device}")
        return True

    def staged_step(self, idx: np.ndarray, n_valid: int) -> torch.Tensor:
        """One train step on the staged trials `idx` (the first `n_valid`
        count in the loss)."""
        V, A, S, M = self._dev_data
        idx_d = self._to_device(idx.astype(np.int64))
        return self._train_step(V.index_select(0, idx_d),
                                A.index_select(0, idx_d),
                                S.index_select(0, idx_d),
                                M.index_select(0, idx_d), n_valid)

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------
    def _epoch_result(self, losses) -> dict:
        loss_vals = torch.stack(losses).cpu().numpy()   # one sync an epoch
        mean = float(loss_vals.mean())
        self.train_losses.append(mean)
        return {"train_loss": round(mean, 5),
                "lr": float(self.schedule(self.global_step))}

    def _train_epoch_cached(self) -> dict:
        bs = self.config.training.train_batch_size
        perm = self._rng.permutation(self._n_train)
        losses = []
        for s in range(0, self._n_train, bs):
            idx = perm[s:s + bs]
            n_valid = len(idx)
            if n_valid < bs:   # ragged tail: pad by repeating, mask the loss
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - n_valid)])
            losses.append(self.staged_step(idx, n_valid))
        return self._epoch_result(losses)

    def _train_epoch_multihost(self) -> dict:
        """One streamed epoch across ranks: each rank round-robins its
        session shards and drops ragged tails (DDP drop_last); the ranks
        agree on the step count and every step is this rank's rows of the
        global mixed-session batch."""
        bs = self.config.training.train_batch_size
        # the loaders batch their shards in order: full batches per session
        # are num_trials // bs, known without reading the epoch
        steps = mh.global_min(sum(dl.num_trials // bs
                                  for dl in self.train_loaders.values()))
        self._init_if_needed()
        losses = []
        for eid, batch in self._interleaved_batches():
            if len(losses) >= steps:
                break
            if np.asarray(batch["ap"]).shape[0] < bs:   # ragged tail
                continue
            losses.append(self._train_step(*self._pad_batch(batch, eid, bs)))
        if not losses:   # no rank has a full batch
            return {"train_loss": float("nan"),
                    "lr": float(self.schedule(self.global_step))}
        return self._epoch_result(losses)

    def train_epoch(self) -> dict:
        if self._multihost:   # rank-local shards stream (JAX policy)
            return self._train_epoch_multihost()
        if self._stage_device_dataset():
            return self._train_epoch_cached()
        self._init_if_needed()
        bs = self.config.training.train_batch_size
        losses = [self._train_step(*self._pad_batch(batch, eid, bs))
                  for eid, batch in self._interleaved_batches()]
        return self._epoch_result(losses)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _iter_staged_eval(self, loaders, need_ap: bool = True):
        """``need_ap=False`` drops the padded device ``ap`` from the yielded
        item: only the light on-device metrics read it."""
        self._init_if_needed()
        n_data = self.mesh.shape["data"]
        for eid, loader in loaders.items():
            if loader.num_trials == 0:
                continue
            rows = -(-loader.batch_size // n_data) * n_data
            for batch in loader:
                video, ap, sids, _, b = self._pad_batch(batch, eid, rows)
                if self._multihost:   # this rank's block of the rows
                    video, sids = mh.replicated_rows_to_global(
                        self.mesh, video, sids)
                yield (eid, video, sids, b, np.asarray(batch["ap"]),
                       ap if need_ap else None)

    def _eval_batches(self, loaders, phase: str, need_ap: bool = True):
        """Stage each split's eval inputs on the device once, within what
        the train cache left of ``device_cache_gb``; a split beyond that
        streams on every eval instead."""
        cache = self._eval_input_cache
        if phase in cache:
            if cache[phase] is not None:
                return cache[phase]
            return self._iter_staged_eval(loaders, need_ap)   # too big
        cap = max(self._device_cache_gb * 1e9 - self._staged_bytes, 0)
        staged, nbytes = [], 0
        it = self._iter_staged_eval(loaders, need_ap)
        for item in it:
            staged.append(item)
            nbytes += item[1].nbytes + (
                item[5].nbytes if item[5] is not None else 0)
            if nbytes > cap:
                self.log.info(f"{phase} split exceeds the remaining device "
                              f"cache budget; streaming eval inputs")
                cache[phase] = None
                return itertools.chain(staged, it)
        cache[phase] = staged
        return staged

    @torch.no_grad()
    def _eval(self, loaders: Dict[str, SessionDataset], phase: str,
              return_outputs: bool = False) -> dict:
        per_session = {}
        gt_out, pred_out = {}, {}
        sess_out: Dict[str, list] = {}
        light = not return_outputs and not self._multihost
        for eid, video, sids, b, ap_np, ap_d in self._eval_batches(
                loaders, phase, need_ap=light):
            out = self.model(video, sids)
            if self._multihost:   # every rank's rows, in rank order
                out = mh.gather_rows(out, self._dp_group)
            sess_out.setdefault(eid, []).append((out, b, ap_np, ap_d))
            if ap_d is None:   # the split was staged for the host path
                light = False
        if light:
            # per-session metrics on the device, one fetch for the eval
            eids, scalars = [], []
            for eid, outs in sess_out.items():
                n = self.n_neurons[eid]
                out_cat = torch.cat([o[:b, :, :n] for o, b, _, _ in outs])
                gt_cat = torch.cat([a[:b, :, :n] for _, b, _, a in outs])
                eids.append(eid)
                scalars.extend(device_eval_metrics(out_cat, gt_cat))
            vals = torch.stack(scalars).double().cpu().numpy()
            for i, eid in enumerate(eids):
                per_session[eid] = {"bps": float(vals[2 * i]),
                                    "rsquared": float(vals[2 * i + 1])}
        else:
            for eid, outs in sess_out.items():
                n = self.n_neurons[eid]
                gt = np.concatenate([ap[:, :, :n] for _, _, ap, _ in outs])
                pr = np.concatenate([np.exp(o[:b, :, :n].cpu().numpy())
                                     for o, b, _, _ in outs])
                per_session[eid] = metrics_list(
                    np.swapaxes(gt, 0, -1), np.swapaxes(pr, 0, -1),
                    metrics=("bps", "rsquared"))
                if return_outputs:
                    gt_out[eid], pred_out[eid] = gt, pr
        agg = {f"{phase}_{k}": round(float(np.mean(
                   [r[k] for r in per_session.values()])), 5)
               for k in ("bps", "rsquared")}
        out = {"per_session": per_session, **agg}
        if return_outputs:
            out["gt"], out["preds"] = gt_out, pred_out
        return out

    def _plot_figs(self, ev: dict, tag: str) -> None:
        """``save_plot``: each session's trial-averaged gt/pred heatmaps and
        first 5 neurons' traces, as PNGs and as figure records."""
        if not self.config.get("save_plot") or "gt" not in ev \
                or not self._is_main:
            return
        from video_spike_torch.viz import pyplot
        from video_spike_torch.viz.plots import plot_gt_pred, plot_neurons_r2

        plt = pyplot()
        for eid, gt in ev["gt"].items():
            pr = ev["preds"][eid]
            fig1 = plot_gt_pred(gt.mean(0).T, pr.mean(0).T, epoch=tag,
                                modality="ap")
            fig2 = plot_neurons_r2(gt.mean(0), pr.mean(0),
                                   neuron_idx=range(min(5, gt.shape[-1])),
                                   epoch=tag)
            for fig, kind in ((fig1, "trial"), (fig2, "neuron")):
                name = f"best_{kind}_{eid[:5]}_{tag}"
                path = os.path.join(self.log_dir, f"{name}.png")
                fig.savefig(path)
                self.tracker.log_figure(name, fig, step=self.global_step,
                                        path=path)
                plt.close(fig)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _save_last(self, epoch: int, block: bool = True) -> None:
        """True-resume checkpoint: params + optimizer state + counters.
        ``block=False`` fetches and writes a device copy of them on a
        background thread, overlapped with the test eval (the best params
        are copied into the live leaves meanwhile)."""
        tree = {"params": self.params, "opt_state": self.opt_state,
                "epoch": epoch, "global_step": self.global_step,
                "best_bps": float(self._best_bps)}
        if self._multihost:
            self._save_rank0("model_last", tree)
        elif block:
            save_checkpoint(self.log_dir, "model_last", tree)
        else:
            save_checkpoint_async(self.log_dir, "model_last", snapshot(tree))

    def _flush_best(self, block: bool = True) -> None:
        """Write the stashed best params unless that epoch is on disk;
        ``block=False`` keeps training running while it is fetched and
        written."""
        if self._best_params is None \
                or self._last_best_flush == self._best_epoch:
            return
        tree = {"params": self._best_params, "epoch": self._best_epoch}
        if self._multihost:
            self._save_rank0("model_best", tree)
        elif block:
            save_checkpoint(self.log_dir, "model_best", tree)
        else:
            save_checkpoint_async(self.log_dir, "model_best", tree)

    def _save_rank0(self, name: str, tree) -> None:
        """Multi-process: rank 0 writes (the replicas are equal), in program
        order, and every rank waits for the file."""
        if self._is_main:
            save_checkpoint(self.log_dir, name, tree)
        mh.barrier()

    def resume(self, name: str = "last") -> bool:
        """Restore params + optimizer state + epoch from ``model_last``
        (every rank reads rank 0's file, after a barrier)."""
        wait_for_checkpoints()
        mh.barrier()
        if not checkpoint_exists(self.log_dir, f"model_{name}"):
            return False
        # the JAX trainer draws a probe batch of the first session here,
        # which moves its shuffled loader on by an epoch: drawing it too
        # keeps a resumed run on the JAX run's batch order
        next(iter(self.train_loaders[self.eids[0]]))
        self._init_if_needed()
        restored = load_checkpoint(self.log_dir, f"model_{name}", self.device)
        self._set_params(copy_into(self.params, restored["params"]))
        self.opt_state = copy_into(self.opt_state, restored["opt_state"])
        self.global_step = int(restored["global_step"])
        self._start_epoch = int(restored["epoch"]) + 1
        self._best_bps = float(restored["best_bps"])
        self.log.info(f"resumed from epoch {restored['epoch']} "
                      f"(step {self.global_step})")
        return True

    # ------------------------------------------------------------------
    # full loop
    # ------------------------------------------------------------------
    def train(self) -> dict:
        from video_spike_torch.core.preempt import graceful_stop

        num_epochs = self.config.training.num_epochs
        want_figs = bool(self.config.get("save_plot"))
        t0 = time.time()
        with graceful_stop(self.log) as preempted:
            for epoch in range(self._start_epoch, num_epochs):
                tr = self.train_epoch()
                ev = self._eval(self.val_loaders, "eval",
                                return_outputs=want_figs)
                line = {"epoch": epoch, **tr, "eval_bps": ev["eval_bps"],
                        "eval_rsquared": ev["eval_rsquared"]}
                if self._multihost:
                    self.replica_checksums.append(
                        mh.check_replicas(self.params, mh.world_group()))
                    line["replica_checksum"] = \
                        f"{self.replica_checksums[-1]:016x}"
                self.log.info(f"{line}")
                self.tracker.log(line, step=self.global_step)
                self.eval_history.append(line)
                if ev["eval_bps"] > self._best_bps:
                    self._best_bps = ev["eval_bps"]
                    # a device copy; on disk at the save_every cadence
                    self._best_params = {k: v.clone() for k, v
                                         in self.params.items()}
                    self._best_epoch = epoch
                    if epoch - self._last_best_flush >= self._save_every:
                        self._flush_best(block=False)
                        self._last_best_flush = epoch
                    self._plot_figs(ev, tag=str(epoch))
                # a TERM may reach only some ranks: agree before anyone
                # diverges into the save barrier
                if mh.global_any(bool(preempted)):
                    # SIGTERM / Ctrl-C: persist and return, no test eval
                    wait_for_checkpoints(raise_errors=False)
                    self._save_last(epoch)
                    self._flush_best()
                    self.log.info(f"preempted at epoch {epoch}: model_last "
                                  f"saved, resume with --resume")
                    return self._result(None, preempted=True, epoch=epoch)
            # after the loop: the fetch and write overlap the test eval;
            # same-path saves join, and the trainer waits before returning
            self._save_last(num_epochs - 1, block=False)
        self._flush_best(block=False)
        self.log.info(f"trained in {time.time()-t0:.1f}s; "
                      f"best eval_bps={self._best_bps}")
        # copied into the live leaves, which a step updates in place
        if self._best_params is not None:
            self._set_params(copy_into(self.params, self._best_params))
        elif checkpoint_exists(self.log_dir, "model_best"):
            restored = load_checkpoint(self.log_dir, "model_best",
                                       self.device)
            self._set_params(copy_into(self.params, restored["params"]))
        test = self._eval(self.test_loaders, "test",
                          return_outputs=want_figs)
        wait_for_checkpoints()   # artifacts must exist before returning
        self._plot_figs(test, tag="test")
        if self._is_main:
            np.save(os.path.join(self.log_dir, "test_results.npy"),
                    {"test_res": {"test_bps": test["test_bps"],
                                  "test_rsquared": test["test_rsquared"]},
                     "per_session": dict(test["per_session"])})
        self.log.info(f"test: {test['test_bps']} bps, "
                      f"{test['test_rsquared']} r2")
        return self._result({k: v for k, v in test.items()
                             if k not in ("gt", "preds")})

    def _result(self, test, **extra) -> dict:
        return {"best_eval_bps": self._best_bps, "test": test,
                "global_step": self.global_step,
                "start_epoch": self._start_epoch,
                "train_losses": list(self.train_losses),
                "eval_history": list(self.eval_history),
                "n_params": self.n_params,
                "replica_checksums": list(self.replica_checksums),
                "log_dir": self.log_dir, **extra}
