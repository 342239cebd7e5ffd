"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with :mod:`ctypes`.  Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is reused.  :func:`build_all` starts one ``nvcc`` per missing library,
all at once, and waits for them together.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("paged_attention.cu", "int8_matmul.cu", "flash_attention.cu",
           "fused_sync.cu", "quant_hop.cu", "leg_cursor.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_KERNEL_NAME = re.compile(r"(flash_[a-z]+_kernel)ILi(\d+)ELb([01])E")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def find_nvcc() -> str:
    """The path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``,
    then ``PATH``; raises if there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lives for its current contents."""
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Raises with the compiler's output if
    any build fails.  Returns ``{source: library path}``."""
    paths = {src: library_path(src) for src in SOURCES}
    missing = [src for src, p in paths.items() if not p.exists()]
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for src in missing:
        tmp = paths[src].with_name(paths[src].name + f".tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[src])   # atomic: readers see whole files
    if failures:
        raise RuntimeError("CUDA kernel build failed: "
                           + "\n".join(failures))
    return paths


def kernel(source: str, symbol: str, argtypes: Sequence,
           restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``source``'s library, building
    every kernel library first if needed (bound once, then cached)."""
    fn = _fns.get((source, symbol))
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get((source, symbol))
        if fn is None:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build_all()[source]))
                _libs[source] = lib
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _fns[(source, symbol)] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of CUDA ``device`` (queried once per device): the launch
    rules size grids and clusters by it."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def parse_ptxas(log: str) -> dict:
    """``{"flash_fwd_kernel<64, causal>": {"registers", "spill_stores",
    "spill_loads", "stack", "static_smem"}, ...}`` from the output of an
    ``nvcc -Xptxas -v`` run (a flash kernel under its template arguments,
    any other under its mangled name)."""
    report, name = {}, None
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            k = _KERNEL_NAME.search(m.group(1))
            name = (f"{k.group(1)}<{k.group(2)}, "
                    f"{'causal' if k.group(3) == '1' else 'full'}>"
                    if k else m.group(1))
            report[name] = {}
        elif name and (m := _PTXAS_SPILL.search(line)):
            report[name].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        elif name and (m := _PTXAS_USED.search(line)):
            report[name].update(registers=int(m.group(1)),
                                static_smem=int(m.group(2) or 0))
    return report
