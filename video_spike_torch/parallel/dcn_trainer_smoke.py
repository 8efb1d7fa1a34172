"""Multi-process run of the real trainers (not a toy step).

Counterpart of ``video_spike_tpu/parallel/dcn_trainer_smoke.py``. Every
rank loads its own shard of a synthetic session's training trials, runs a
trainer's ``train()`` / ``fit()`` and prints ``pid=<rank> result={...}``.
The metrics are global, so every rank must print the same numbers; only
rank 0 writes checkpoints and results.

    DCN_FIXTURE_DIR=... DCN_LOG_DIR=... \
    python -m torch.distributed.run --nproc_per_node=2 \
        -m video_spike_torch.parallel.dcn_trainer_smoke

Environment: ``DCN_MODE`` (unset: the Linear ``BaseTrainer``;
``multisession``; ``ssl``; ``ssl_resume``; ``tensor``), ``DCN_EID``,
``DCN_DEVICE_CACHE=0`` (the streaming Linear path), ``DCN_H5`` (the SSL
modes' frame cache), ``DCN_SMOKE_FORCE_CPU=1`` (ranks on the CPU over
gloo), and ``DCN_INIT``: a ``torch.save``d flat parameter dict every rank
starts from instead of its seeded init (to hold the run against another
package's run from the same weights), and ``DCN_MODEL_AXIS``: the
``model`` axis of the mesh (``training.mesh.model``; the ranks of a data
row then read the same rows, 2 × M of them a step, as the JAX smoke's 2
rows a device) in the Linear and multisession modes, default 1, and in
the ``tensor`` mode, default 4.

``DCN_MODE=tensor`` trains the VTT flagship (hidden 128, 3 sessions of 32
neurons, 12 frames) for 3 steps on a {data: 2, model: M} mesh over 2·M
ranks under the production sharding rules (``models/vtt.
vtt_sharding_rules``): the model axis spans processes, the layout the JAX
package's ``_tensor_sharded`` was written to test. Every rank builds the
same global batch from ``default_rng(7)`` and takes its data block.

    DCN_MODE=tensor DCN_MODEL_AXIS=2 DCN_LOG_DIR=... \
    python -m torch.distributed.run --nproc_per_node=4 \
        -m video_spike_torch.parallel.dcn_trainer_smoke
"""

from __future__ import annotations

import hashlib
import json
import os

from video_spike_torch.parallel.dcn_smoke import say


def _device():
    """The run's device, after ``setup_runtime`` has set this rank's
    card."""
    from video_spike_torch.core.device import resolve_device
    from video_spike_torch.core.runtime import setup_runtime

    kind = "cpu" if os.environ.get("DCN_SMOKE_FORCE_CPU") else "cuda"
    setup_runtime(kind)
    return resolve_device(kind)


def _load_init(trainer) -> None:
    """Overwrite the trainer's seeded init with ``DCN_INIT`` (if set); the
    optimizer state starts at zeros either way."""
    path = os.environ.get("DCN_INIT")
    if not path:
        return
    import torch

    trainer._init_if_needed()
    init = torch.load(path, map_location=trainer.device, weights_only=True)
    params = trainer.params
    missing = set(params) ^ set(init)
    if missing:
        raise KeyError(f"DCN_INIT does not match the model: {sorted(missing)}")
    trainer._set_params({k: init[k].to(params[k].dtype) for k in params})


def main() -> None:
    import torch

    from video_spike_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    device = _device()
    pid = mh.process_index()
    log_dir = os.environ["DCN_LOG_DIR"]
    eid = os.environ.get("DCN_EID", "dcntrain00")
    mode = os.environ.get("DCN_MODE")
    if mode == "tensor":
        out = _tensor_sharded(device)
    elif mode in ("ssl", "ssl_resume"):
        fn = _ssl if mode == "ssl" else _ssl_resume
        out = fn(os.environ["DCN_H5"], log_dir, eid, device)
    elif mode == "multisession":
        out = _multisession(os.environ["DCN_FIXTURE_DIR"], log_dir,
                            eid.split(","), device)
    else:
        out = _linear(os.environ["DCN_FIXTURE_DIR"], log_dir, eid, device)
    say(f"pid={pid} result={json.dumps(out)}")


def _linear(data_dir: str, log_dir: str, eid: str, device) -> dict:
    """2 epochs of the Linear ``BaseTrainer`` on whisker motion energy."""
    from video_spike_torch.core.config import config_from_kwargs, update_config
    from video_spike_torch.core.registry import NAME2MODEL
    from video_spike_torch.data.dataset import (
        get_metadata_from_loader,
        make_loader,
        split_dataset,
    )
    from video_spike_torch.parallel import multihost as mh
    from video_spike_torch.train.base import BaseTrainer

    config = config_from_kwargs(
        {"model": "include:configs/model/linear_me.yaml"})
    config = update_config("configs/train/linear_me.yaml", config)
    config["dirs"]["data_dir"] = data_dir
    config["training"]["num_epochs"] = 2
    n_model = int(os.environ.get("DCN_MODEL_AXIS", "1"))
    config["training"]["mesh"] = {"model": n_model}
    # two rows per device of a data block, as the JAX smoke's
    # 2 × local_device_count with a data block's devices in one process
    config["training"]["train_batch_size"] = 2 * n_model
    config["training"]["device_cache"] = (
        os.environ.get("DCN_DEVICE_CACHE", "1") != "0")

    split = split_dataset(data_dir, eid, seed=42)
    # this rank's training shard; val/test stay whole on every rank
    local_split = dict(split, train=mh.shard_files_for_process(
        split["train"], n_model))
    train_dl, val_dl, test_dl = make_loader(config, local_split)
    meta = get_metadata_from_loader(train_dl, config)
    config["model"]["encoder"]["input_dim"] = meta["input_dim"]
    config["model"]["decoder"]["output_dim"] = meta["output_dim"]
    model = NAME2MODEL[config.model.model_class].from_config(
        config.model, device=device)
    trainer = BaseTrainer(model, train_dl, val_dl, test_dl, config, eid=eid,
                          dataset_split_dict=split, log_dir=log_dir, seed=42,
                          device=device)
    assert trainer._multihost, "expected a multi-process runtime"
    _load_init(trainer)
    res = trainer.train()
    return {"best_eval_bps": res["best_eval_bps"],
            "test_bps": res["test_res"]["test_bps"],
            "test_loss": res["test_res"]["test_loss"],
            "cached": trainer._dev_data is not None,
            "h2d_bytes": int(getattr(trainer, "_cached_mh_h2d_bytes", 0)),
            "train_losses": res["train_losses"]}


def _flagship(n_sessions: int, max_neurons: int, t_frames: int,
              hidden: int, device, dtype=None):
    """``__graft_entry__._flagship``: the production VTT recipe's shape
    (2 + 2 blocks, 2 heads, MLP 2 × hidden, frame_stride 2)."""
    import torch

    from video_spike_torch.models.vtt import VideoTemporalTransformer

    return VideoTemporalTransformer(
        n_sessions=n_sessions, max_neurons=max_neurons, t_frames=t_frames,
        t_bins=100, patch_size=16, hidden=hidden, frame_depth=2,
        temporal_depth=2, heads=2, mlp_dim=2 * hidden, frame_stride=2,
        dtype=dtype or torch.bfloat16, device=device)


def _split(params, placements, name: str) -> dict:
    return {"shape": list(params[name].shape),
            "dim": placements[name].split_dim(params[name].ndim)}


def _tensor_sharded(device) -> dict:
    """3 tensor-sharded VTT steps on {data: 2, model: M}: every rank prints
    the same losses, its shard shapes, and the checksums of the replicated
    leaves (equal over the whole world) and of its split blocks (equal
    over its data group, the ranks holding the same blocks)."""
    import numpy as np
    import torch

    from video_spike_torch.ops.optim import AdamW, cosine_onecycle_schedule
    from video_spike_torch.parallel import multihost as mh
    from video_spike_torch.parallel.mesh import make_mesh
    from video_spike_torch.train.multisession import make_vtt_tensor_step

    n_model = int(os.environ.get("DCN_MODEL_AXIS", "4"))
    mesh = make_mesh(n_data=2, n_model=n_model)
    t_frames, t_bins, max_n = 12, 100, 32
    batch = mesh.shape["data"] * 2
    model = _flagship(n_sessions=3, max_neurons=max_n, t_frames=t_frames,
                      hidden=128, device=device)
    rng = np.random.default_rng(7)   # the same global batch on every rank
    video = rng.integers(0, 255, (batch, t_frames, 1, 32, 32), dtype=np.uint8)
    ap = rng.poisson(1.0, (batch, t_bins, max_n)).astype(np.float32)
    sids = rng.integers(0, 3, (batch,)).astype(np.int64)
    nmask = np.ones((batch, max_n), np.float32)

    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    init = os.environ.get("DCN_INIT")
    if init:
        loaded = torch.load(init, map_location=device, weights_only=True)
        if set(loaded) != set(params):
            raise KeyError(f"DCN_INIT does not match the model: "
                           f"{sorted(set(params) ^ set(loaded))}")
        params = {k: loaded[k].to(params[k].dtype) for k in params}
    step, params, opt_state, rules = make_vtt_tensor_step(
        model, params, mesh,
        AdamW(cosine_onecycle_schedule(100, 5e-5), weight_decay=0.01))
    block = [torch.as_tensor(a).to(device) for a in
             mh.replicated_rows_to_global(mesh, video, ap, sids, nmask)]
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, *block)
        losses.append(round(float(loss), 8))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    split = [k for k, r in rules.items() if r.axis is not None]
    whole = {k: v for k, v in params.items() if k not in split}
    return {"losses": losses,
            "head_split": _split(params, rules, "session_heads"),
            "mlp_split": _split(
                params, rules, "frame_encoder.Block_0.Dense_0.kernel"),
            "n_split": len(split),
            "replicated_checksum": mh.check_replicas(
                whole, torch.distributed.group.WORLD),
            "split_checksums": mh.replica_checksums(
                {k: params[k] for k in split}, torch.distributed.group.WORLD)}


def _multisession(data_dir: str, log_dir: str, eids, device) -> dict:
    """2 epochs of the ``MultiSessionTrainer``: each rank streams its shard
    of every session into mixed-session global batches."""
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.models.vtt import VideoTemporalTransformer
    from video_spike_torch.train.multisession import MultiSessionTrainer

    n_model = int(os.environ.get("DCN_MODEL_AXIS", "1"))
    config = DictConfig({
        "training": {"num_epochs": 2, "train_batch_size": 2 * n_model,
                     "test_batch_size": 2 * n_model,
                     "mesh": {"model": n_model}},
        "optimizer": {"lr": 1e-3, "wd": 0.01, "eps": 1e-8,
                      "warmup_pct": 0.15, "div_factor": 10},
    })
    trainer = MultiSessionTrainer(model=None, config=config, eids=eids,
                                  data_dir=data_dir, log_dir=log_dir,
                                  seed=42, device=device)
    trainer.model = VideoTemporalTransformer.from_config({
        "n_sessions": len(eids), "max_neurons": trainer.max_neurons,
        "t_frames": 120, "t_bins": 100, "patch_size": 16,
        "hidden_size": 32, "frame_depth": 1, "temporal_depth": 1,
        "num_attention_heads": 2, "intermediate_size": 64,
        # cross-rank equality is checked, not quality: encoding 30 of 120
        # frames quarters the dominant CPU cost
        "frame_stride": 4}, device=device)
    assert trainer._multihost, "expected a multi-process runtime"
    _load_init(trainer)
    res = trainer.train()
    return {"best_eval_bps": res["best_eval_bps"],
            "test_bps": res["test"]["test_bps"],
            "train_losses": res["train_losses"]}


_SSL_CFG = dict(image_size=16, patch_size=8, num_channels=1, hidden_size=32,
                num_hidden_layers=1, num_attention_heads=4,
                intermediate_size=64, decoder_hidden_size=32,
                decoder_num_hidden_layers=1, decoder_num_attention_heads=4,
                decoder_intermediate_size=64, mask_ratio=0.0,
                norm_pix_loss=False, embed_size=3)


def _ssl_trainer(h5_path: str, log_dir: str, eid: str, device, batch: int,
                 **kw):
    from video_spike_torch.core.registry import NAME2MODEL
    from video_spike_torch.data.contrast import make_contrast_loader
    from video_spike_torch.train.contrast import ContrastTrainer

    model = NAME2MODEL["ContrastViT"].from_config(_SSL_CFG, device=device)
    common = dict(eid=eid, idx_offset=3, image_size=16, seed=0)
    dl, _ = make_contrast_loader(h5_path, mode="pretrain", batch_size=batch,
                                 **common)
    train_dl, _ = make_contrast_loader(h5_path, mode="train", batch_size=4,
                                       shuffle=False, **common)
    val_dl, _ = make_contrast_loader(h5_path, mode="val", batch_size=4,
                                     shuffle=False, **common)
    trainer = ContrastTrainer(
        model, dl, {"lr": 1e-3}, val_data_loader=val_dl,
        train_data_loader=train_dl, eid=eid, log_dir=log_dir, image_size=16,
        seed=42, device=device, **kw)
    assert trainer._multihost, "expected a multi-process runtime"
    _load_init(trainer)
    return trainer, train_dl


def _ssl(h5_path: str, log_dir: str, eid: str, device) -> dict:
    """A multi-process ``ContrastTrainer.fit()``: rank-strided frame shards
    feed global triplet batches; the nested-RRR validation and the best
    checkpoint agree on every rank."""
    import numpy as np

    trainer, train_dl = _ssl_trainer(h5_path, log_dir, eid, device, 4,
                                     max_steps=6, validate_every=3)
    best = trainer.fit()
    emb = trainer.transform(train_dl)   # rows split over ranks, gathered
    return {"best_bps": round(float(best), 8),
            "emb_sum": round(float(np.abs(emb).sum()), 4),
            "emb_rows": int(emb.shape[0])}


def _ssl_resume(h5_path: str, log_dir: str, eid: str, device) -> dict:
    """Draw-exact multi-process mid-epoch resume: stop a 2-rank run two
    batches into its second epoch, resume with fresh trainers to
    ``max_steps``, and compare the parameters with an uninterrupted run's:
    they must be bitwise equal on every rank (the epoch shuffle and the
    pos/neg draws derive from (seed, epoch) and (seed, epoch, rank,
    batch))."""
    # 144 frames / 2 ranks = 72 a rank: 12-step epochs at batch 6. Stop at
    # 14 = 2 batches into epoch 1; max_steps 30 ends mid-epoch 2: both
    # seams crossed.
    import torch

    max_steps, stop_at, consumed = 30, 14, 2

    def make(logs: str):
        return _ssl_trainer(h5_path, logs, eid, device, 6,
                            max_steps=max_steps, validate_every=10 ** 6,
                            save_every_min=None, flush_best=False)[0]

    def digest(trainer) -> str:
        h = hashlib.blake2b(digest_size=16)
        for _, v in sorted(trainer.params.items()):
            h.update(v.cpu().contiguous().view(-1).view(torch.uint8)
                     .numpy().tobytes())
        return h.hexdigest()

    ab_dir = os.path.join(log_dir, "ab")
    ta = make(ab_dir)
    ta.max_steps = stop_at
    ta.fit()
    tb = make(ab_dir)
    assert tb.resume(), "resume found no checkpoint"
    assert tb._start_step == stop_at, tb._start_step
    assert tb._resume_skip == consumed, tb._resume_skip   # mid-epoch
    tb.fit()
    tc = make(os.path.join(log_dir, "c"))
    tc.fit()
    return {"resumed": digest(tb), "control": digest(tc)}


if __name__ == "__main__":
    from video_spike_torch.core.runtime import run_rank

    run_rank(main)
