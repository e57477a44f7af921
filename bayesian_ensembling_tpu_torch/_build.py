"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, at first use, into ``build/torch_kernels/`` at the repository
root.  The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale build is never loaded.
Nothing here runs at import time: the CPU-only test environment imports
every module but never builds.

Every C entry point takes raw device pointers, sizes and a ``cudaStream_t``
and returns ``cudaGetLastError()`` after its launch; :func:`launch` raises
on a non-zero code and counts the launch.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Shared memory one block may opt into on an H100 (227 KB).  The kernels'
# size gates (ops/linalg_cuda.py, ops/dtw_cuda.py) are computed from it, so a
# route is chosen by shape and dtype alone, the same on every device.
SMEM_BYTES = 232_448

# C entry points: name -> (number of pointer arguments, number of int arguments).
# Every entry point ends with the stream pointer.
_SIGNATURES = {
    "bet_dba_update_f32": (4, 2),
    "bet_dba_update_f64": (4, 2),
    "bet_chol_solve_f32": (6, 2),
    "bet_chol_solve_f64": (6, 2),
    "bet_tri_inv_f32": (2, 2),
    "bet_tri_inv_f64": (2, 2),
    "bet_chol_f32": (2, 2),
    "bet_chol_f64": (2, 2),
    "bet_dba_update_split_f32": (5, 2),
    "bet_dba_update_split_f64": (5, 2),
    "bet_dtw_cost_f32": (3, 2),
    "bet_dtw_cost_f64": (3, 2),
}

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.
LAUNCHES = {"dba_update": 0, "dba_update_split": 0, "chol_solve": 0, "tri_inv": 0, "chol": 0,
            "dtw_cost": 0}

# Batched-linalg calls since the last reset, by the route they took: the
# kernels or torch.linalg (one per routed call in ops/linalg_cuda.py), or
# the recursive blocked NLML on the kernels (one per evaluation).
ROUTES = {"kernel": 0, "blocked": 0, "library": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _library_path(sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libbet_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(sources: list[Path], so: Path) -> str:
    """One ``nvcc -c`` per source, all at once, then one link; returns the
    compilers' output (``-Xptxas=-v``: registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = so.with_name(f"{tag}.so.tmp")
    link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *map(str, objs)]
    try:
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(outs)


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cu = sorted(CSRC.glob("*.cu"))
        so = _library_path(cu + sorted(CSRC.glob("*.cuh")))
        t0 = time.perf_counter()
        log = ""
        if not so.exists():
            log = _compile(cu, so)
        lib = ctypes.CDLL(str(so))
        for name, (n_ptr, n_int) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.bet_error_string.argtypes = [ctypes.c_int]
        lib.bet_error_string.restype = ctypes.c_char_p
        build_info.update(path=str(so), seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def launch(kernel: str, symbol: str, *args) -> None:
    """Call C entry point ``symbol`` on the current stream; count a launch of
    ``kernel``; raise if the launch was refused."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, symbol)(*args, stream)
    if rc != 0:
        msg = lib.bet_error_string(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc} ({msg}); arguments {args[-2:]}")
    LAUNCHES[kernel] += 1


def largest_t(smem_bytes, t_max: int = 1 << 20) -> int:
    """Largest T up to ``t_max`` whose launcher's shared memory,
    ``smem_bytes(T)``, fits :data:`SMEM_BYTES`."""
    t = 1
    while t < t_max and smem_bytes(t + 1) <= SMEM_BYTES:
        t += 1
    return t


def symbol_suffix(dtype: torch.dtype) -> str:
    """The C entry point suffix for ``dtype``; raises for a type the kernels lack."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the CUDA kernels take float32 or float64 tensors, got {dtype}")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with one dtype."""
    first = tensors[0]
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {x.device}")
        if x.device != first.device or x.dtype != first.dtype:
            raise ValueError(f"{name}: tensors differ in device or dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
