"""ctypes wrapper and lazy build of the C++ shard reader
(counterpart of ``video_spike_tpu/data/native_io.py``).

The repo-root ``native/trialtar.cpp`` is compiled as it is, by ``g++``,
into ``video_spike_torch/csrc/build/`` (``ops/cuda_lib.build_host``: named
by a hash of the source and flags, written through a temporary file, so
parallel builds never race). Its worker threads read whole tar blobs off
the GIL into a bounded, ordered queue; Python parses the members from
memory (:func:`parse_tar_blob`).

:func:`native_available` says whether the library builds; a failed build
keeps the compiler's output, and :class:`NativeShardReader` raises with it.
Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import io
import json
import pickle
import tarfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent.parent.parent / "native" / "trialtar.cpp"

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_build_lock = threading.Lock()


def _build() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _build_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            from video_spike_torch.ops.cuda_lib import build_host

            lib = ctypes.CDLL(str(build_host(SRC)))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        lib.vst_reader_create.restype = ctypes.c_void_p
        lib.vst_reader_create.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                          ctypes.c_int, ctypes.c_int]
        lib.vst_reader_next_size.restype = ctypes.c_int64
        lib.vst_reader_next_size.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.vst_reader_next_copy.restype = ctypes.c_int
        lib.vst_reader_next_copy.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p]
        lib.vst_reader_reset.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char]
        lib.vst_reader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _build() is not None


def build_error() -> Optional[str]:
    """The compiler's output of a failed build (None when it built or was
    not tried)."""
    return _build_error


class NativeShardReader:
    """Ordered, threaded whole-tar blob stream over a list of shard paths."""

    SEP = "\n"

    def __init__(self, paths: Sequence[str], n_workers: int = 4,
                 capacity: int = 8):
        lib = _build()
        if lib is None:
            raise RuntimeError(f"native shard reader unavailable: the g++ "
                               f"build of {SRC} failed:\n{_build_error}")
        self._lib = lib
        self._paths = list(paths)
        self._handle = lib.vst_reader_create(
            self.SEP.join(self._paths).encode(), self.SEP.encode(),
            n_workers, capacity)
        if not self._handle:
            raise RuntimeError("vst_reader_create failed")
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[str, bytes]]:
        lib = self._lib
        idx = ctypes.c_int(0)
        while True:
            size = lib.vst_reader_next_size(self._handle, ctypes.byref(idx))
            if size == 0:
                return
            if size < 0:
                # the C++ side marks unreadable or empty shards apart from
                # the end of the epoch, so a shard deleted mid-epoch raises
                # here instead of silently truncating the epoch
                raise IOError(f"native reader failed to read shard "
                              f"{self._paths[idx.value]!r}")
            buf = ctypes.create_string_buffer(size)
            if lib.vst_reader_next_copy(self._handle, buf) != 0:
                return
            yield self._paths[idx.value], buf.raw

    def reset(self, paths: Sequence[str]) -> None:
        """Start a new epoch over (possibly reshuffled) paths."""
        self._paths = list(paths)
        self._lib.vst_reader_reset(self._handle,
                                   self.SEP.join(self._paths).encode(),
                                   self.SEP.encode())

    def close(self) -> None:
        if not self._closed and self._handle:
            self._lib.vst_reader_destroy(self._handle)
            self._closed = True

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def parse_tar_blob(blob: bytes) -> dict:
    """Decode an in-memory trial tar blob into the sample dict (the
    contract of :func:`video_spike_torch.data.tar_io.read_trial_tar`)."""
    out: dict = {}
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r") as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            data = tar.extractfile(member).read()
            parts = member.name.split(".")
            ext, mod = parts[-1], parts[-2] if len(parts) >= 2 else member.name
            out.setdefault("__key__", ".".join(parts[:-2]))
            if ext == "pyd":
                out[mod] = pickle.loads(data)
            elif ext == "json":
                out["meta"] = json.loads(data)
            elif ext == "npy":
                out[mod] = np.load(io.BytesIO(data))[:, None, :, :]  # uint8
            elif ext == "mp4":
                from video_spike_torch.data.tar_io import decode_mp4

                out[mod] = decode_mp4(data)[:, None, :, :]
    if "__key__" in out:
        out["eid"] = out["__key__"].split("_")[0]
    return out
