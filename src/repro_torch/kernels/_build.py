"""Build, load and launch the CUDA kernels in ``src/repro_torch/csrc``.

Nothing here runs at import: the first CUDA tensor that reaches a kernel
calls `lib()`, which compiles every ``csrc/*.cu`` for ``sm_90a`` with
``nvcc`` (one process per source, all started together, then one link)
into ``build/repro_torch/`` at the root of the checkout, keyed by a hash of
the sources and flags, and loads the shared library with ``ctypes``.  The
library has a plain C interface: pointers and the stream travel as
``ctypes.c_void_p``, sizes as ``ctypes.c_int``, scalars of the arithmetic
as ``ctypes.c_float``, and every entry returns
``cudaGetLastError()`` after its launch, which `launch` turns into an
exception.

`LAUNCHES` counts kernel launches per kernel name; `launch` is the only
place that adds to it.  Each C entry is resolved once and its function
object kept, so a launch costs one ctypes call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
F = ctypes.c_float
# C entry points: name → argtypes (every pointer and the stream as c_void_p).
SIGNATURES = {
    "race_hist_launch": [P, P, I, I, I, P],
    "sann_table_scatter_launch": [P, P, P, P, P, P, P, I, I, I, I, P],
    "sann_table_commit_launch": [P, P, P, P, P, P, P, P, P, P,
                                 I, I, I, I, I, I, P],
    "batch_score_topk_launch": [P, P, P, P, P, I, I, I, I, P],
    "batch_score_topk_gather_launch": [P, P, P, P, P, P, I, I, I, I, I, P],
    "swakde_segment_pass_launch": [P] * 10 + [I] * 9 + [P],
    "swakde_segment_commit_launch": [P] * 9 + [I] * 10 + [P],
    "cand_score_launch": [P, P, P, I, I, P],
    "srp_hash_launch": [P, P, P, P, I, I, I, I, I, P],
    "sketch_decode_attn_launch": [P] * 8 + [I] * 11 + [F] * 3 + [P],
}

LAUNCHES = {"race_hist": 0, "sann_table_scatter": 0, "batch_score_topk": 0,
            "swakde_segment_pass": 0, "cand_score": 0, "srp_hash": 0,
            "sketch_decode_attn": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRIES: dict = {}
BUILD_INFO: dict = {}
# The services launch kernels from several threads (prepare, commit,
# queries): one lock for the first build, one for the launch counts.
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


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
    with _BUILD_LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def launch(name: str, entry_name: str, *args) -> None:
    """Call C entry ``entry_name`` with ``args`` (tensors become device
    pointers, None a null pointer, floats stay floats, anything else
    becomes an int) on the current stream, raise on a CUDA error, and count
    one launch of kernel ``name`` (an entry that launches several kernels
    counts once)."""
    fn = _ENTRIES.get(entry_name)
    if fn is None:                      # resolved once a process
        fn = _ENTRIES[entry_name] = getattr(lib(), entry_name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else a if isinstance(a, float) or a is None else int(a)
            for a in args]
    # the current stream's handle, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _shape_ok(got, want) -> bool:
    return got == want or (len(got) == len(want) and all(
        w is None or w == n for w, n in zip(want, got)))


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Wrapper-side argument check: a contiguous CUDA tensor of ``dtype``
    and ``shape`` (``None`` entries match any size)."""
    if t.is_cuda and t.dtype == dtype and t.is_contiguous() and \
            _shape_ok(t.shape, shape):
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not _shape_ok(t.shape, shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    raise ValueError(f"{name}: expected a contiguous tensor")


def check_all(name: str, tensors: dict, dtype: torch.dtype, shape) -> None:
    """`check` for several tensors of one ``dtype`` and ``shape`` in one
    pass; on a failure, `check` names the tensor at fault."""
    if all(t.is_cuda and t.dtype == dtype and t.is_contiguous()
           and _shape_ok(t.shape, shape) for t in tensors.values()):
        return
    for key, t in tensors.items():
        check(f"{name} {key}", t, dtype, shape)
