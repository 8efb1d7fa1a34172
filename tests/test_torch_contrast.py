"""PyTorch port of the SSL data and trainer path (``data/contrast.py``,
``data/prefetch.py``, ``train/contrast.py``, ``cli/create_eid_data.py``
for whisker video, ``cli/pretrain.py``, ``cli/test.py``) against the JAX
package.

One synthetic session (20 trials, 8 neurons, 64×96 whisker frames) is
cached by the JAX package's ``create_eid_data`` into the h5 both packages
read. The small ViT is ``tests/test_contrast_stack.py``'s at image 32.
Tolerances:

- the h5 layout, the port's in-memory split dict, and the sampler streams
  (triplet draws, ``skip`` replay, snapshots): equal;
- a few trainer steps against the JAX trainer from the same converted
  init, float32 models (the flax backbone's dtype is overridden in the
  test), on a one-device mesh, with both packages' ``random_masking``
  monkeypatched here to one fixed noise per (B, L): per-step loss rtol
  1e-4, ``val_bps`` of the nested RRR within 1e-3;
- the port's frame cache against its streamed path, and a mid-epoch resume
  against an uninterrupted run: bitwise equal parameters.
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from video_spike_tpu.data.contrast import ContrastDataset as JDataset
from video_spike_tpu.data.contrast import load_h5_file as j_load_h5
from video_spike_tpu.data.contrast import make_contrast_loader as j_loader
from video_spike_tpu.models import vit_mae as jvit
from video_spike_torch.convert import flax_to_torch, load_into_model
from video_spike_torch.core.registry import NAME2MODEL
from video_spike_torch.data.contrast import ContrastDataset as TDataset
from video_spike_torch.data.contrast import load_h5_file as t_load_h5
from video_spike_torch.data.contrast import make_contrast_loader as t_loader
from video_spike_torch.data.prefetch import background
from video_spike_torch.data.synthetic import make_synthetic_session
from video_spike_torch.models import vit_mae as tvit
from video_spike_torch.train.checkpoint import load_checkpoint
from video_spike_torch.train.contrast import ContrastTrainer as TTrainer

# the small ViT and the shared masking noise of the model tests
from test_torch_ssl import TINY, _F32Backbone, _jax_masking, _torch_masking

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EID = "cafe00000"
COMMON = dict(eid=EID, idx_offset=3, image_size=32, seed=0)
CREATE_ARGS = ["--model_config", str(REPO / "configs/model/linear_me.yaml"),
               "--train_config", str(REPO / "configs/train/rrr.yaml"),
               "--input_mod", "whisker-video"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """(trial tar dir, the JAX-written whisker-video h5)."""
    fx = tmp_path_factory.mktemp("contrast_fx")
    work = tmp_path_factory.mktemp("contrast_work")
    make_synthetic_session(fx, eid=EID, n_trials=20, n_neurons=8, seed=7,
                           height=32, width=32)
    from video_spike_tpu.cli.create_eid_data import main as j_create

    cwd = os.getcwd()
    os.chdir(work)
    try:
        os.makedirs("data")
        Path("data/eid.txt").write_text(f"{EID}\n")
        j_create(CREATE_ARGS + ["--data_dir", str(fx)])
    finally:
        os.chdir(cwd)
    return fx, work / "data" / "data_rrr_whisker-video.h5"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_create_eid_data_whisker_video_equals_jax(cache, tmp_path,
                                                  monkeypatch):
    """The port's in-memory split dict and its h5 hold what the JAX
    package's h5 holds."""
    from video_spike_torch.cli import create_eid_data as t_create

    fx, h5 = cache
    ref = j_load_h5(str(h5), EID)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    (tmp_path / "data/eid.txt").write_text(f"{EID}\n")
    args = CREATE_ARGS + ["--data_dir", str(fx)]
    split = t_create.split_dict(t_create.build(args)[1])
    written = t_load_h5(t_create.main(args), EID)
    assert ref[EID]["train_X"].shape == (16, 120, 1, 64, 96)
    for got in (split, written, t_load_h5(str(h5))):
        assert got[EID].keys() == ref[EID].keys()
        for k, v in ref[EID].items():
            assert got[EID][k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[EID][k], v, err_msg=k)


def test_sampler_streams_equal_jax(cache):
    data = j_load_h5(str(cache[1]), EID)[EID]
    jd = JDataset(data, mode="pretrain", idx_offset=3, seed=0)
    td = TDataset(data, mode="pretrain", idx_offset=3, seed=0)
    np.testing.assert_array_equal(td.video, jd.video)
    for _ in range(2):                                   # two epochs
        for a, b in zip(td.iter_index_batches(64), jd.iter_index_batches(64)):
            for k in ("ref", "pos", "neg"):
                np.testing.assert_array_equal(a[k], b[k])
    # a port snapshot replays in the JAX dataset, with skip
    snap = td.sampler_state()
    want = [b for _, b in zip(range(5), td.iter_batches(16))]
    jd.set_sampler_state(json.loads(json.dumps(snap)))
    replay = jd.iter_batches(16, skip=3)
    td.set_sampler_state(snap)
    port_replay = td.iter_batches(16, skip=3)
    for k in (3, 4):
        a, b = next(replay), next(port_replay)
        for key in ("ref", "pos", "neg"):
            np.testing.assert_array_equal(b[key], want[k][key])
            np.testing.assert_array_equal(a[key], want[k][key])
    # trial mode
    tv = TDataset(data, mode="val")
    batch = next(tv.iter_batches(1, shuffle=False))
    assert batch["ref"].shape == (1, 120, 1, 64, 96)
    assert batch["neural"].shape == (1, 100, 8)


def test_background_propagates_errors_and_quiesces():
    def source():
        yield 1
        raise ValueError("boom")

    it = background(source(), depth=1)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)
    gen = background(iter(range(100)), depth=2)
    assert next(gen) == 0
    gen.close()                                    # joins the producer


# ---------------------------------------------------------------------------
# the trainer against JAX
# ---------------------------------------------------------------------------

def _loaders(source, make, batch=16):
    dl, _ = make(source, mode="pretrain", batch_size=batch, shuffle=True,
                 **COMMON)
    train_dl, _ = make(source, mode="train", batch_size=16, shuffle=False,
                       **COMMON)
    val_dl, _ = make(source, mode="val", batch_size=16, shuffle=False,
                     **COMMON)
    return dl, train_dl, val_dl


def _port_trainer(source, log_dir, max_steps, name="ContrastViTMAE",
                  dtype=torch.float32, **kw):
    dl, train_dl, val_dl = _loaders(source, t_loader)
    model = NAME2MODEL[name].from_config(TINY, dtype=dtype)
    return TTrainer(model, dl, {"lr": 1e-3}, val_data_loader=val_dl,
                    train_data_loader=train_dl, max_steps=max_steps,
                    eid=EID, log_dir=str(log_dir), image_size=32, seed=0,
                    device="cpu", **kw)


def test_trainer_steps_match_jax(cache, tmp_path, monkeypatch):
    from video_spike_tpu.parallel.mesh import make_mesh
    from video_spike_tpu.train.contrast import ContrastTrainer as JTrainer

    monkeypatch.setattr(jvit, "ViTMAEBackbone", _F32Backbone)
    monkeypatch.setattr(jvit, "random_masking", _jax_masking)
    monkeypatch.setattr(tvit, "random_masking", _torch_masking)
    h5 = str(cache[1])
    dl, train_dl, val_dl = _loaders(h5, j_loader)
    jt = JTrainer(jvit.ContrastViTMAE.from_config(TINY), dl, {"lr": 1e-3},
                  val_data_loader=val_dl, train_data_loader=train_dl,
                  max_steps=5, eid=EID, log_dir=str(tmp_path / "jax"),
                  image_size=32, seed=0,
                  mesh=make_mesh(devices=jax.devices()[:1]))
    jt._init_if_needed(np.asarray(dl.dataset.video[:1]))
    losses_j, vals_j = [], []
    step, validate = jt._step_staged, jt._validate

    def record_step(staged, cur_step):
        out = step(staged, cur_step)
        losses_j.append(float(out["loss"]))
        return out

    def record_val():
        out = validate()
        vals_j.append(out["val_bps"])
        return out

    jt._step_staged, jt._validate = record_step, record_val

    tt = _port_trainer(h5, tmp_path / "port", 5)
    tt._init_if_needed()
    load_into_model(tt.model, flax_to_torch(jax.device_get(jt.params)))
    jt.fit()
    tt.fit()
    assert len(tt.train_losses) == len(losses_j) == 5
    np.testing.assert_allclose(tt.train_losses, losses_j, rtol=1e-4)
    assert [v["step"] for v in tt.val_history] == [5] and len(vals_j) == 1
    assert abs(tt.val_history[0]["val_bps"] - vals_j[0]) < 1e-3, (
        tt.val_history, vals_j)
    # the fixed temperature stayed 0 under AdamW's weight decay
    assert float(tt.model.temperature.detach()) == 0.0


def test_frame_cache_matches_streaming(cache, tmp_path):
    runs = []
    for tag, gb in (("cached", 2.0), ("streamed", 0.0)):
        tr = _port_trainer(str(cache[1]), tmp_path / tag, 3,
                           name="ContrastViT", frame_cache_gb=gb,
                           validate_every=10**6)
        tr.fit()
        runs.append(tr)
    assert runs[0]._frame_cache is not None and runs[1]._frame_cache is None
    for k, v in runs[0].params.items():
        assert torch.equal(v, runs[1].params[k]), k


def test_mid_epoch_resume_is_bit_exact(cache, tmp_path):
    """Stop at step 3 of a 150-batch epoch, resume to 6: the parameters
    equal an uninterrupted 6-step run's bit for bit (sampler sidecar,
    AdamW state and the per-step masking seed)."""
    h5 = str(cache[1])
    a = _port_trainer(h5, tmp_path / "ab", 6, validate_every=10**6)
    a.max_steps = 3
    a.fit()
    state = json.loads((Path(a.log_dir) / "last_model.sampler.json")
                       .read_text())
    assert state["step"] == 3 and state["consumed"] == 3
    b = _port_trainer(h5, tmp_path / "ab", 6, validate_every=10**6)
    assert b.resume()
    assert b._start_step == 3 and b._resume_skip == 3
    b.fit()
    c = _port_trainer(h5, tmp_path / "c", 6, validate_every=10**6)
    c.fit()
    for k, v in b.params.items():
        assert torch.equal(v, c.params[k]), k
    assert b.train_losses == c.train_losses[3:]


def test_resume_ignores_stale_sidecar(cache, tmp_path):
    h5 = str(cache[1])
    a = _port_trainer(h5, tmp_path, 3, name="ContrastViT",
                      validate_every=10**6)
    a.fit()
    sidecar = Path(a.log_dir) / "last_model.sampler.json"
    state = json.loads(sidecar.read_text())
    state["step"] = 1                           # a stale pairing
    sidecar.write_text(json.dumps(state))
    b = _port_trainer(h5, tmp_path, 3, name="ContrastViT")
    assert b.resume()
    assert b._start_step == 3 and b._resume_skip == 0


def test_best_flush_meta_and_resume_keeps_it(cache, tmp_path):
    h5 = str(cache[1])
    a = _port_trainer(h5, tmp_path, 2, name="ContrastViT")
    a.fit()                          # validates at step 2: a first best
    log_dir = Path(a.log_dir)
    meta = json.loads((log_dir / "best_model.meta.json").read_text())
    assert meta == {"best_bps": a._best_bps, "step": 2}
    best = load_checkpoint(log_dir, "best_model")["params"]
    for k, v in a._best_params.items():
        assert torch.equal(best[k], v), k
    # a better best flushed after the last_model was written
    a._best_bps, a._best_params = 0.9, {k: torch.full_like(v, 7.0)
                                        for k, v in a.params.items()}
    a._flush_best_model(1)
    b = _port_trainer(h5, tmp_path, 2, name="ContrastViT")
    assert b.resume()
    assert b._best_bps == 0.9 and b._best_step == 1
    b.max_steps, b.validate_every = 4, 1
    b.fit()                          # a real, worse validation
    assert b._best_params is None
    for v in load_checkpoint(log_dir, "best_model")["params"].values():
        assert torch.all(v == 7.0)
    assert json.loads((log_dir / "best_model.meta.json").read_text()) == {
        "best_bps": 0.9, "step": 1}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("short,cls,source", [("cm", "ContrastViTMAE", "dict"),
                                              ("m", "MAE", "h5"),
                                              ("c", "ContrastViT", "h5")])
def test_pretrain_then_test_cli(cache, tmp_path, monkeypatch, short, cls,
                                source):
    from video_spike_torch.cli import create_eid_data as t_create
    from video_spike_torch.cli import pretrain as t_pretrain
    from video_spike_torch.cli import test as t_test

    fx, h5 = cache
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(TINY))
    data = (t_create.split_dict(t_create.build(
        CREATE_ARGS + ["--data_dir", str(fx), "--eid", EID])[1])
        if source == "dict" else None)
    common = ["--model_config", str(tmp_path / "tiny.yaml"),
              "--train_config", str(REPO / "configs/train/vmae_video.yaml"),
              "--eid", EID, "--model", short, "--log_dir", "logs",
              "--device", "cpu", "--h5_path", str(h5)]
    res = t_pretrain.main(common + ["--max_steps", "3", "--batch_size", "16"],
                          data=data)
    saved = np.load(res["path"], allow_pickle=True).item()[EID]
    e_dim = TINY["hidden_size"] if short == "m" else TINY["embed_size"]
    assert saved["X"][0].shape == (16, 120, e_dim)
    assert saved["y"][0].shape == (16, 100, 8)
    assert res["steps"] == 3 and np.isfinite(res["train_losses"]).all()
    assert np.isfinite(res["val_history"][0]["val_bps"])
    log_dir = tmp_path / "logs" / EID / cls / "3"
    for name in ("best_model.pt", "last_model.pt", "best_model.meta.json",
                 "last_model.sampler.json"):
        assert (log_dir / name).exists(), name
    # --resume restores the saved step (max_steps is part of the log dir)
    res2 = t_pretrain.main(common + ["--max_steps", "3", "--resume"],
                           data=data)
    assert res2["start_step"] == 3 and res2["steps"] == 0
    # test.py reads the 40000-step log dir, as in the JAX package
    os.symlink(log_dir, log_dir.parent / "40000")
    bps = t_test.main(common, data=data)
    assert len(bps) == 1 and np.isfinite(bps[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_test.main(common + ["--save_plot"], data=data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_pretrain.main(common[:-4] + ["--device", "cuda"], data=data)
