"""The port's C++ shard reader (``video_spike_torch/data/native_io.py``) and
``SessionDataset(io_backend=...)`` against the JAX package's.

The port builds the repo-root ``native/trialtar.cpp`` with ``g++`` into its
own git-ignored build directory. The cases of ``tests/test_native_io.py``
run on the port's reader; the decoded trials (``parse_tar_blob``) and the
batches of two shuffled epochs must equal the JAX package's and the python
reader's exactly: arrays bitwise, keys and string lists equal.
"""

import numpy as np
import pytest
import torch

from video_spike_tpu.data import dataset as jds
from video_spike_tpu.data import native_io as jnio
from video_spike_torch.data import dataset as tds
from video_spike_torch.data import native_io as nio
from video_spike_torch.data.synthetic import make_synthetic_session
from video_spike_torch.data.tar_io import read_trial_tar

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native")
    return make_synthetic_session(d, eid="native0000", n_trials=10,
                                  n_neurons=6, seed=9, height=32, width=32)


@pytest.fixture
def built():
    if not nio.native_available():
        pytest.fail(f"the port's g++ build failed:\n{nio.build_error()}")


def _assert_samples_equal(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _assert_batches_equal(got, ref) -> None:
    assert len(got) == len(ref)
    for b_got, b_ref in zip(got, ref):
        _assert_samples_equal(b_got, b_ref)


# ---------------------------------------------------------------------------
# the reader (the cases of tests/test_native_io.py)
# ---------------------------------------------------------------------------

def test_reader_streams_in_order(shards, built):
    reader = nio.NativeShardReader(shards, n_workers=4, capacity=3)
    seen = []
    for path, blob in reader:
        assert len(blob) > 0
        assert nio.parse_tar_blob(blob)["ap"].shape == (100, 6)
        seen.append(path)
    assert seen == list(shards)
    reader.close()


def test_reader_reset_new_epoch(shards, built):
    reader = nio.NativeShardReader(shards[:4], n_workers=2, capacity=2)
    assert [p for p, _ in reader] == shards[:4]
    reader.reset(list(reversed(shards[:4])))
    assert [p for p, _ in reader] == list(reversed(shards[:4]))
    reader.close()


def test_blob_matches_python_decoder(shards, built):
    reader = nio.NativeShardReader(shards[:2], n_workers=1)
    for path, blob in reader:
        native, python = nio.parse_tar_blob(blob), read_trial_tar(path)
        assert native.keys() == python.keys()
        np.testing.assert_array_equal(native["ap"], python["ap"])
        np.testing.assert_array_equal(native["video"], python["video"])
    reader.close()


def test_reader_unreadable_shard_raises(shards, built, tmp_path):
    """A missing or 0-byte shard mid-list raises an IOError naming it,
    never read as the end of the epoch."""
    missing = str(tmp_path / "nope.tar")
    reader = nio.NativeShardReader([shards[0], missing, shards[1]],
                                   n_workers=2)
    it = iter(reader)
    path, blob = next(it)
    assert path == shards[0] and len(blob) > 0
    with pytest.raises(IOError, match="nope.tar"):
        next(it)
    reader.close()
    empty = tmp_path / "empty.tar"
    empty.write_bytes(b"")
    reader = nio.NativeShardReader([str(empty)], n_workers=1)
    with pytest.raises(IOError, match="empty.tar"):
        next(iter(reader))
    reader.close()


def test_reader_builds_its_own_library(built):
    """The port's library lives in its own build directory, named by the
    source's hash, not in the JAX wrapper's ``native/build/``."""
    from video_spike_torch.ops import cuda_lib

    lib = cuda_lib.build_host(nio.SRC)
    assert lib.parent == cuda_lib.BUILD_DIR and lib.is_file()
    assert lib.name.startswith("libtrialtar_")
    assert nio.SRC == jnio._SRC


# ---------------------------------------------------------------------------
# parse_tar_blob against the JAX package and read_trial_tar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 5, 9])
def test_parse_tar_blob_equals_jax_and_read_trial_tar(shards, index):
    blob = open(shards[index], "rb").read()
    got = nio.parse_tar_blob(blob)
    _assert_samples_equal(got, jnio.parse_tar_blob(blob))
    _assert_samples_equal(got, read_trial_tar(shards[index]))
    assert got["video"].dtype == np.uint8 and got["video"].shape[1] == 1


# ---------------------------------------------------------------------------
# SessionDataset(io_backend=...)
# ---------------------------------------------------------------------------

def _epochs(ds, n=2):
    return [list(ds) for _ in range(n)]


@pytest.mark.parametrize("cache", [False, True])
def test_native_batches_equal_python_and_jax(shards, built, cache):
    """Two shuffled epochs with the same seed: the port's native batches
    equal its python reader's and the JAX package's native batches."""
    kw = dict(batch_size=4, shuffle=True, seed=3, cache=cache,
              modalities=["ap", "video", "timestamp"])
    native = tds.SessionDataset(shards, io_backend="native", **kw)
    got = _epochs(native)
    python = tds.SessionDataset(shards, io_backend="python", **kw)
    ref = _epochs(python)
    jax_native = _epochs(jds.SessionDataset(shards, io_backend="native",
                                            **kw))
    for epoch in range(2):
        _assert_batches_equal(got[epoch], ref[epoch])
        _assert_batches_equal(got[epoch], jax_native[epoch])
    assert sum(b["ap"].shape[0] for b in got[0]) == 10
    # with the cache the second epoch reads nothing; without it, every one
    assert native.blobs_read == {"native": 10 if cache else 20, "python": 0}
    assert python.blobs_read == {"native": 0, "python": 10 if cache else 20}


def test_auto_takes_native_and_drop_last(shards, built):
    ds = tds.SessionDataset(shards, batch_size=4, drop_last=True)
    assert ds.io_backend == "auto"
    batches = list(ds)
    assert [b["ap"].shape[0] for b in batches] == [4, 4]
    assert ds.blobs_read == {"native": 10, "python": 0}
    assert len(ds) == 2


def test_failed_build_raises_under_native_and_auto_reads_python(
        shards, tmp_path, monkeypatch):
    """A source that does not compile: native_available() is False and
    keeps the compiler's output; io_backend="native" raises with it;
    "auto" takes the python reader and gives the same batches."""
    broken = tmp_path / "trialtar.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(nio, "SRC", broken)
    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_build_error", None)
    assert nio.native_available() is False
    assert "g++ failed" in nio.build_error()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        list(tds.SessionDataset(shards, batch_size=4, io_backend="native"))
    auto = tds.SessionDataset(shards, batch_size=4, cache=False)
    ref = tds.SessionDataset(shards, batch_size=4, cache=False,
                             io_backend="python")
    _assert_batches_equal(list(auto), list(ref))
    assert auto.blobs_read == {"native": 0, "python": 10}


def test_unknown_backend_is_rejected(shards):
    with pytest.raises(ValueError, match="io_backend"):
        tds.SessionDataset(shards, batch_size=4, io_backend="fast")


def test_make_loader_matches_jax(shards, built):
    """make_loader's three datasets (io_backend left at auto) give the JAX
    package's batches."""
    from video_spike_tpu.core.config import config_from_kwargs as jcfg
    from video_spike_torch.core.config import config_from_kwargs as tcfg

    split = tds.split_dataset(str(shards[0].rsplit("/", 1)[0]),
                              "native0000", seed=0)
    assert split == jds.split_dataset(str(shards[0].rsplit("/", 1)[0]),
                                      "native0000", seed=0)
    kw = {"training.train_batch_size": "4", "training.test_batch_size": "2",
          "data.modalities.video.input": "true",
          "data.modalities.ap.input": "false"}
    t_loaders = tds.make_loader(tcfg(kw), split, seed=1)
    j_loaders = jds.make_loader(jcfg(kw), split, seed=1)
    for t_dl, j_dl in zip(t_loaders, j_loaders):
        _assert_batches_equal(list(t_dl), list(j_dl))
