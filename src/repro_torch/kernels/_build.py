"""Build, load and launch the CUDA kernels in ``src/repro_torch/csrc``.

Nothing here runs at import: the first CUDA tensor that reaches a kernel
calls `lib()`, which compiles every ``csrc/*.cu`` for ``sm_90a`` with
``nvcc`` (one process per source, all started together, then one link)
into ``build/repro_torch/`` at the root of the checkout, keyed by a hash of
the sources and flags, and loads the shared library with ``ctypes``.  The
library has a plain C interface: pointers and the stream travel as
``ctypes.c_void_p``, sizes as ``ctypes.c_int``, and every entry returns
``cudaGetLastError()`` after its launch, which `launch` turns into an
exception.

`LAUNCHES` counts kernel launches per kernel name; `launch` is the only
place that adds to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C entry points: name → argtypes (every pointer and the stream as c_void_p).
SIGNATURES = {
    "race_hist_launch": [P, P, I, I, I, P],
    "sann_table_scatter_launch": [P, P, P, P, P, P, P, I, I, I, I, P],
    "batch_score_topk_launch": [P, P, P, P, P, I, I, I, I, P],
    "swakde_segment_pass_launch": [P, P, P, P, P, P, P, P, P,
                                   I, I, I, I, I, I, I, I, I, P],
    "cand_score_launch": [P, P, P, I, I, P],
    "srp_hash_launch": [P, P, P, P, I, I, I, I, I, P],
}

LAUNCHES = {"race_hist": 0, "sann_table_scatter": 0, "batch_score_topk": 0,
            "swakde_segment_pass": 0, "cand_score": 0, "srp_hash": 0}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card")
    return found


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (cached by content)
    and return its path.  Records the build time and ptxas report in
    `BUILD_INFO`."""
    headers = sorted(CSRC.glob("*.cuh"))
    sources = sorted(CSRC.glob("*.cu"))
    key = _source_hash(headers + sources)
    out = BUILD_DIR / f"librepro_torch_{key}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{key}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = []
    failed = []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log="\n".join(log))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def launch(name: str, entry: str, *args) -> None:
    """Call C entry ``entry`` with ``args`` (tensors become device pointers,
    ints stay ints) on the current stream, raise on a CUDA error, and count
    one launch of kernel ``name``."""
    fn = getattr(lib(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
            for a in args]
    err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Wrapper-side argument check: a contiguous CUDA tensor of ``dtype``
    and ``shape`` (``None`` entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
