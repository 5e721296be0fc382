"""Native (C++) host batch assembly (counterpart of medvae_tpu/native).

`feeder.cpp`, the port's copy of the JAX package's, is compiled at first use
with the host's g++ into `build/medvae_tpu_torch/` beside the package (the
directory `ops/_build.py` builds the CUDA kernels into), named by a hash of
the source and flags, and driven through ctypes. `assemble_batch` is
`DeviceFeeder._gather`'s fused pass: image rows, labels and modality indices
gathered, the one-hot and the channel lookup built, in one native call
sharded across `MEDVAE_NATIVE_THREADS` threads (default: the CPU count,
capped at 8).

As in the JAX package, a host that cannot build or load the library (no
compiler, `MEDVAE_NATIVE=0`) takes the numpy gather, which gives the same
bytes: `assemble_batch` returns None then. `calls` counts the batches the
native pass assembled, so a run can show that it was used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "feeder.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "medvae_tpu_torch"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

calls = 0  # batches assembled by the native pass
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    """The compiled library, built unless an up-to-date one exists; None when
    it cannot be built here."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"feeder-{digest}.so"
    if out.exists():
        return out
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("MEDVAE_NATIVE", "1") == "0":
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.mv_assemble_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _threads() -> int:
    env = os.environ.get("MEDVAE_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(8, os.cpu_count() or 1))


def available() -> bool:
    """True when the native library built and loaded on this host."""
    return _load() is not None


def assemble_batch(
    images: np.ndarray,
    labels: np.ndarray,
    modality_idx: np.ndarray,
    idx: np.ndarray,
    channels_by_mod: np.ndarray,
    n_mod: int,
) -> Optional[Dict[str, np.ndarray]]:
    """The fused gather: the batch dict of rows `idx` without `valid`, or
    None when the library is unavailable or `images` is not C-contiguous
    uint8 (the caller takes the numpy gather)."""
    global calls
    lib = _load()
    if lib is None or images.dtype != np.uint8 or not images.flags.c_contiguous:
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    labels32 = np.ascontiguousarray(labels, np.int32)
    midx32 = np.ascontiguousarray(modality_idx, np.int32)
    ch32 = np.ascontiguousarray(channels_by_mod, np.int32)
    n = len(idx)
    row_bytes = images[0].nbytes if images.shape[0] else 0
    out = {
        "image_u8": np.empty((n,) + images.shape[1:], np.uint8),
        "label": np.empty((n,), np.int32),
        "modality_onehot": np.zeros((n, n_mod), np.float32),
        "modality_idx": np.empty((n,), np.int32),
        "channels": np.empty((n,), np.int32),
    }
    lib.mv_assemble_batch(
        images.ctypes.data, row_bytes, labels32.ctypes.data, midx32.ctypes.data, idx.ctypes.data,
        n, n_mod, ch32.ctypes.data, out["image_u8"].ctypes.data, out["label"].ctypes.data,
        out["modality_idx"].ctypes.data, out["modality_onehot"].ctypes.data,
        out["channels"].ctypes.data, _threads(),
    )
    with _lock:
        calls += 1
    return out
