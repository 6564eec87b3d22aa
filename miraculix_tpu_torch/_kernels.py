"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, under ``_build/<hash of sources and
flags>/``, and ``ctypes`` loads it.  Nothing is built or loaded at import, so
the package imports (and its CPU paths run) where there is no CUDA toolkit.

Each launcher checks its tensors, launches on the current stream, adds one
to its entry of :data:`LAUNCHES`, and raises if the launch failed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"tall_dgemm": 0, "tall_dgemm_cv": 0, "crossprod": 0}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / h.hexdigest()[:16] / "libmxtorch.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library of these sources exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mx_tall_cols_per_warp.argtypes = [i32]
            lib.mx_tall_cols_per_warp.restype = i32
            lib.mx_tall_dgemm.argtypes = [vp, i32, vp, i64, i32, vp, vp, vp,
                                          vp, vp, i32, vp]
            lib.mx_tall_dgemm.restype = i32
            lib.mx_crossprod.argtypes = [vp, i32, i32, vp, vp]
            lib.mx_crossprod.restype = i32
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if not t.is_cuda or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


TALL_WARPS_PER_SM = 128  # launched warps per SM the contraction split aims at


def tall_splits(kwi: int, contract: int, n: int, device) -> int:
    """Contraction splits that launch about TALL_WARPS_PER_SM warps per SM
    (narrow outputs have too few word tiles to fill the card alone)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    warps = (kwi + 31) // 32 * -(-n // _load().mx_tall_cols_per_warp(n))
    want = -(-TALL_WARPS_PER_SM * sms // warps)
    return max(1, min(want, contract // 256, 65535))


def tall_dgemm(zq: torch.Tensor, b: torch.Tensor, cv=None):
    """K1/K2: ct [n, 16*kwi] (and v [n] when ``cv`` is given).  ``zq`` int32
    [spad, kwi], ``b`` f32 [contract, n] with contract <= spad, ``cv`` f32
    [contract]."""
    lib = _load()
    _check(zq, "zq", torch.int32, 2)
    _check(b, "b", torch.float32, 2)
    spad, kwi = zq.shape
    contract, n = b.shape
    if contract > spad or not 1 <= n <= 64 or b.device != zq.device:
        raise ValueError(f"tall_dgemm: b {tuple(b.shape)} does not fit zq "
                         f"{tuple(zq.shape)} (n must be 1..64)")
    if cv is not None:
        _check(cv, "cv", torch.float32, 1)
        if cv.shape[0] != contract:
            raise ValueError("cv must have one entry per contraction row")
    dev = zq.device
    splits = tall_splits(kwi, contract, n, dev)
    ct = torch.empty((n, 16 * kwi), dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev) if cv is not None \
        else None
    work = vwork = None
    if splits > 1:
        work = torch.empty((splits, n, 16 * kwi), dtype=torch.float32,
                           device=dev)
        if cv is not None:
            vwork = torch.empty((splits, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES["tall_dgemm" if cv is None else "tall_dgemm_cv"] += 1
    _raise_if(lib.mx_tall_dgemm(_ptr(zq), kwi, _ptr(b), contract, n, _ptr(cv),
                                _ptr(ct), _ptr(v), _ptr(work), _ptr(vwork),
                                splits, ctypes.c_void_p(stream)), "tall_dgemm")
    return ct, v


def crossprod(zq: torch.Tensor) -> torch.Tensor:
    """K3: exact int32 decode(zq) decode(zq)^T, [rows, rows]."""
    lib = _load()
    _check(zq, "zq", torch.int32, 2)
    rows, kw = zq.shape
    out = torch.empty((rows, rows), dtype=torch.int32, device=zq.device)
    stream = torch.cuda.current_stream(zq.device).cuda_stream
    LAUNCHES["crossprod"] += 1
    _raise_if(lib.mx_crossprod(_ptr(zq), rows, kw, _ptr(out),
                               ctypes.c_void_p(stream)), "crossprod")
    return out
