"""ctypes bindings for the native host runtime (``native/runtime.cpp`` and
``native/tokenizer.cpp``).

Port of the JAX package's ``runtime/native.py``.  The C++ sources are the
repository's ``native/`` directory, read and never rebuilt in place: the
port compiles them with ``g++`` (``native/Makefile``'s flags) into its own
``build/native/`` directory at the root of the checkout, at first use,
under a file lock (``fcntl.flock`` on ``<library>.lock`` beside it), as
:mod:`autodist_tpu_torch.ops._build` builds the kernels.  The library is
named by a hash of the sources and the flags, so an edited source
rebuilds.  It binds the same C ABI.  Where the build or the load fails
(no ``g++``, an unwritable checkout) the numpy paths run in its place and
:func:`native_available` says False; ``AUTODIST_NO_NATIVE`` set to
anything asks for them.

This is host code: batches are shuffled, gathered and cast on CPU
threads while the card runs the step.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from autodist_tpu_torch.utils import logging

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("runtime.cpp", "tokenizer.cpp")
#: ``native/Makefile``'s ``CXXFLAGS`` and its ``-shared``
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """Where the library of the current sources lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libautodist_runtime-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the sources into ``path`` under its file lock (a process
    that waited finds it built); the output is renamed into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_name(path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               *[str(NATIVE_DIR / s) for s in SOURCES]]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, path)     # readers never see a partial library
        finally:
            tmp.unlink(missing_ok=True)


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not all((NATIVE_DIR / s).exists() for s in SOURCES):
        return None
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (subprocess.CalledProcessError, OSError) as e:
        err = getattr(e, "stderr", b"") or b""
        logging.warning("native runtime build failed (%s); using the numpy "
                        "paths. %s", e, err.decode(errors="replace")[-500:])
        return None
    _bind_signatures(lib)
    return lib


def _bind_signatures(lib: ctypes.CDLL) -> None:
    lib.ad_buffer_alloc.restype = ctypes.c_void_p
    lib.ad_buffer_alloc.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ad_buffer_free.argtypes = [ctypes.c_void_p]
    lib.ad_fp32_to_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t, ctypes.c_int]
    lib.ad_loader_create.restype = ctypes.c_void_p
    lib.ad_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int]
    lib.ad_loader_next.restype = ctypes.c_size_t
    lib.ad_loader_next.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p)]
    lib.ad_loader_release.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.c_int]
    lib.ad_loader_num_batches.restype = ctypes.c_size_t
    lib.ad_loader_num_batches.argtypes = [ctypes.c_void_p]
    lib.ad_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.ad_bpe_create_v2.restype = ctypes.c_void_p
    lib.ad_bpe_create_v2.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                     ctypes.c_int32, ctypes.c_int32]
    lib.ad_bpe_encode.restype = ctypes.c_int32
    lib.ad_bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.ad_bpe_destroy.argtypes = [ctypes.c_void_p]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if needed; None when it is
    unavailable (the numpy paths run)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is None and not _build_failed:
            if os.environ.get("AUTODIST_NO_NATIVE"):
                _build_failed = True
            else:
                _lib = _build_and_load()
                _build_failed = _lib is None
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def bf16_tensor(bits: np.ndarray):
    """A ``torch.bfloat16`` CPU tensor holding the bfloat16 values whose
    bits are the uint16 array ``bits`` (shared memory, no copy)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(bits, np.uint16)).view(
        torch.bfloat16)


def fp32_to_bf16_bits(src: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """Round-to-nearest-even float32 → bfloat16 bits (uint16) on the
    native threads (a NaN keeps its payload, quieted) or in numpy."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    lib = get_lib()
    if lib is None:
        return bf16_bits_numpy(src)
    out = np.empty(src.shape, dtype=np.uint16)
    lib.ad_fp32_to_bf16(src.ctypes.data_as(ctypes.c_void_p),
                        out.ctypes.data_as(ctypes.c_void_p),
                        src.size, num_threads)
    return out


def bf16_bits_numpy(src: np.ndarray) -> np.ndarray:
    """Float32 → bfloat16 bits (uint16) in numpy, as ``ml_dtypes`` casts
    (the JAX package's numpy path): round to nearest even on the upper 16
    bits; a NaN becomes the canonical quiet NaN ``0x7fc0`` with its
    sign."""
    u = src.view(np.uint32).astype(np.uint64)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    canonical = ((u >> 16) & 0x8000) | 0x7FC0
    return np.where(np.isnan(src), canonical, rounded).astype(np.uint16)


def fp32_to_bf16(src: np.ndarray, num_threads: int = 4):
    """Round-to-nearest-even float32 → bfloat16 on the host: a
    ``torch.bfloat16`` CPU tensor of ``src``'s shape (the JAX package
    returns an ``ml_dtypes.bfloat16`` array of the same bits).  The
    native path is multi-threaded; the numpy path casts the same."""
    return bf16_tensor(fp32_to_bf16_bits(src, num_threads))


class NativeLoader:
    """Thin RAII wrapper over the C loader.  One epoch per instance."""

    def __init__(self, arrays, batch_size: int, drop_last: bool,
                 shuffle: bool, seed: int, num_threads: int,
                 prefetch_depth: int, cast_bf16_flags):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("the native runtime is not available")
        self._arrays = [np.ascontiguousarray(a) for a in arrays]  # alive
        n = len(self._arrays)
        arr_ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self._arrays])
        row_bytes = (ctypes.c_size_t * n)(
            *[a.strides[0] for a in self._arrays])
        casts = (ctypes.c_int * n)(*[int(c) for c in cast_bf16_flags])
        self._handle = self._lib.ad_loader_create(
            arr_ptrs, row_bytes, casts, n, self._arrays[0].shape[0],
            batch_size, int(drop_last), int(shuffle), seed & (2**64 - 1),
            num_threads, prefetch_depth)
        if not self._handle:
            raise RuntimeError("ad_loader_create failed")
        self._n = n

    def next(self):
        """``(rows, ptrs)``: ``ptrs`` go back through :meth:`release`;
        ``rows == 0`` ends the epoch."""
        ptrs = (ctypes.c_void_p * self._n)()
        rows = self._lib.ad_loader_next(self._handle, ptrs)
        return rows, ptrs

    def release(self, ptrs) -> None:
        self._lib.ad_loader_release(self._handle, ptrs, self._n)

    def close(self) -> None:
        if self._handle:
            self._lib.ad_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass
