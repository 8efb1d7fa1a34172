"""Per-trial tar shard IO, layout-compatible with the reference's WebDataset
output (``reference:src/prepare_data.py:210-234``).

Each trial is one ``<eid>_<trial_idx>.tar`` containing members named
``<eid>_<trial_idx>.<modality>.<ext>``:

- ``.pyd``  — a pickled numpy array (spike counts ``ap`` (T_bins, N),
  behaviors at 60 Hz, optical-flow features, ``timestamp`` ...)
- ``.mp4``  — ``video`` (whole face) and ``whisker-video`` (pad crop)
- ``.json`` — trial metadata

No webdataset dependency: the format is plain tar + pickle, read with the
stdlib and decoded with cv2 where mp4s are present (cv2 is imported only
when an mp4 is met). Batched decode fans out over a thread pool in
:mod:`video_spike_torch.data.dataset`.
"""

from __future__ import annotations

import io
import json
import pickle
import tarfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 unavailable; cannot encode or decode mp4") from e
    return cv2


def encode_mp4(frames: np.ndarray, fps: int = 60) -> bytes:
    """Encode (T, H, W) uint8 grayscale frames to mp4 bytes (cv2/FFV path)."""
    cv2 = _cv2()
    import tempfile, os
    T, H, W = frames.shape
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        tmp = f.name
    try:
        writer = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (W, H), isColor=True)
        for t in range(T):
            writer.write(cv2.cvtColor(frames[t], cv2.COLOR_GRAY2BGR))
        writer.release()
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.unlink(tmp)


def decode_mp4(data: bytes) -> np.ndarray:
    """Decode mp4 bytes to (T, H, W) uint8 grayscale (first channel, matching
    ``reference:src/loader/base.py:52-55``)."""
    cv2 = _cv2()
    import tempfile, os
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        cap = cv2.VideoCapture(tmp)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, 0])  # BGR -> first channel
        cap.release()
        return np.stack(frames, axis=0)
    finally:
        os.unlink(tmp)


def write_trial_tar(path: str | Path, key: str,
                    arrays: Dict[str, np.ndarray],
                    videos: Optional[Dict[str, np.ndarray]] = None,
                    meta: Optional[dict] = None,
                    store_video_as: str = "npy") -> None:
    """Write one trial shard.

    `arrays`: modality name -> numpy array, stored as pickled ``.pyd``.
    `videos`: modality name -> (T, H, W) uint8, stored as mp4 (parity) or as
      a raw ``.npy`` member (faster, used by synthetic fixtures and the
      high-throughput ETL path; the reader handles both).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "w") as tar:
        def add(name: str, data: bytes):
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        for mod, arr in arrays.items():
            add(f"{key}.{mod}.pyd", pickle.dumps(np.asarray(arr)))
        for mod, vid in (videos or {}).items():
            vid = np.asarray(vid, dtype=np.uint8)
            if store_video_as == "mp4":
                add(f"{key}.{mod}.mp4", encode_mp4(vid))
            else:
                buf = io.BytesIO()
                np.save(buf, vid)
                add(f"{key}.{mod}.npy", buf.getvalue())
        if meta is not None:
            add(f"{key}.meta.json", json.dumps(meta).encode())


def read_trial_tar(path: str | Path, decode_video: bool = True) -> dict:
    """Read one trial shard into ``{"__key__": key, <modality>: array, ...}``.

    Video members come back as (T, 1, H, W) **uint8** — the reference
    loader's grayscale shape (``reference:src/loader/base.py:50-55``)
    but kept compact (the reference's is float32); models cast on device.
    """
    out: dict = {}
    with tarfile.open(path, "r") as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            stem = member.name
            data = tar.extractfile(member).read()
            parts = stem.split(".")
            ext = parts[-1]
            mod = parts[-2] if len(parts) >= 2 else stem
            key = ".".join(parts[:-2])
            out.setdefault("__key__", key)
            if ext == "pyd":
                out[mod] = pickle.loads(data)
            elif ext == "json":
                out["meta"] = json.loads(data)
            elif ext == "npy" and decode_video:
                # uint8 (T, 1, H, W): stays compact through host memory and
                # H2D; consumers cast on device
                vid = np.load(io.BytesIO(data))
                out[mod] = vid[:, None, :, :]
            elif ext == "mp4" and decode_video:
                vid = decode_mp4(data)
                out[mod] = vid[:, None, :, :]
    if "__key__" in out:
        out["eid"] = out["__key__"].split("_")[0]
    return out
