"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one shared
library with a plain C interface, under ``_build/<hash of sources and
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launch_counts().  The tall
# and wide kernels count per mode: "tall_dgemm" is the split mode, the
# other names carry their mode.
LAUNCHES = {"tall_dgemm": 0, "tall_dgemm_cv": 0, "tall_dgemm_bf16": 0,
            "tall_dgemm_f32": 0, "wide_dgemm_split": 0, "wide_dgemm_f32": 0,
            "wide_dgemm_bf16": 0, "wide_dgemm_hilo": 0, "crossprod": 0,
            "crossprod_rect": 0, "crossprod_tri": 0, "crossprod_weighted": 0}
TALL_RHS = {"split": 0, "f32": 0, "bf16": 1}            # B as given / bf16(B)
WIDE_RHS = {"split": 0, "f32": 0, "bf16": 1, "hilo": 2}

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
    for src in sorted(_CSRC.glob("*.cu*")):   # the headers too
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so,
                               *objs], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        (lib.parent / "build.log").write_text("".join(logs))
        failed = [p.returncode for p in procs if p.returncode] \
            or ([link.returncode] if link.returncode else [])
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n" + "".join(logs))
        os.replace(so, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mx_tall_warps_per_tile.argtypes = [i32]
            lib.mx_tall_warps_per_tile.restype = i32
            lib.mx_tall_dgemm.argtypes = [vp, i32, vp, i64, i32, vp, vp, vp,
                                          vp, vp, i32, i32, vp]
            lib.mx_tall_dgemm.restype = i32
            lib.mx_wide_chunks.argtypes = [i32]
            lib.mx_wide_chunks.restype = i32
            lib.mx_wide_dgemm.argtypes = [vp, i32, i32, vp, i64, i32, i32, vp,
                                          vp, i32, vp]
            lib.mx_wide_dgemm.restype = i32
            lib.mx_crossprod.argtypes = [vp, i32, i32, vp, vp]
            lib.mx_crossprod.restype = i32
            lib.mx_crossprod_rect.argtypes = [vp, i32, vp, i32, i32, i32, vp,
                                              vp]
            lib.mx_crossprod_rect.restype = i32
            lib.mx_crossprod_weighted.argtypes = [vp, i32, i32, vp, i32, vp,
                                                  vp]
            lib.mx_crossprod_weighted.restype = i32
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


CROSSPROD_TILE = 64      # output tile edge of csrc/crossprod.cu
TALL_WARPS_PER_SM = 128  # launched warps per SM the contraction split aims at
WIDE_BLOCKS_PER_SM = 8   # launched wide blocks per SM the split aims at


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tall_splits(kwi: int, contract: int, n: int, device) -> int:
    """Contraction splits that launch about TALL_WARPS_PER_SM warps per SM
    (narrow outputs have too few word tiles to fill the card alone)."""
    warps = (kwi + 31) // 32 * _load().mx_tall_warps_per_tile(n)
    want = -(-TALL_WARPS_PER_SM * _sms(device) // warps)
    return max(1, min(want, contract // 256, 65535))


def wide_splits(rows: int, kw: int, n: int, device) -> int:
    """Contraction splits that launch about WIDE_BLOCKS_PER_SM blocks per SM,
    each split keeping at least 64 packed words."""
    blocks = -(-rows // 128) * _load().mx_wide_chunks(n)
    want = -(-WIDE_BLOCKS_PER_SM * _sms(device) // blocks)
    return max(1, min(want, kw // 64, 65535))


def tall_dgemm(zq: torch.Tensor, b: torch.Tensor, cv=None, mode="split"):
    """K1/K2: ct [n, 16*kwi] (and v [n] when ``cv`` is given).  ``zq`` int32
    [spad, kwi], ``b`` f32 [contract, n] with contract <= spad, ``cv`` f32
    [contract] (split mode only).  ``mode``: "split" or "f32" (B as given),
    "bf16" (B rounded once to bf16)."""
    lib = _load()
    _check(zq, "zq", torch.int32, 2)
    _check(b, "b", torch.float32, 2)
    spad, kwi = zq.shape
    contract, n = b.shape
    if mode not in TALL_RHS:
        raise ValueError(f"mode must be split/bf16/f32, got {mode!r}")
    if contract > spad or n < 1 or b.device != zq.device:
        raise ValueError(f"tall_dgemm: b {tuple(b.shape)} does not fit zq "
                         f"{tuple(zq.shape)}")
    if cv is not None and mode != "split":
        raise ValueError("center_vec fusion is a split-mode feature")
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
    name = "tall_dgemm_cv" if cv is not None else \
        "tall_dgemm" if mode == "split" else f"tall_dgemm_{mode}"
    LAUNCHES[name] += 1
    _raise_if(lib.mx_tall_dgemm(_ptr(zq), kwi, _ptr(b), contract, n, _ptr(cv),
                                _ptr(ct), _ptr(v), _ptr(work), _ptr(vwork),
                                splits, TALL_RHS[mode],
                                ctypes.c_void_p(stream)), name)
    return ct, v


def wide_dgemm(zq: torch.Tensor, b: torch.Tensor, rhs: str) -> torch.Tensor:
    """B3/B4/B5/B11: decode(zq) @ B -> f32 [rows, n].  ``zq`` int32
    [rows, kw], ``b`` f32 [cols, n] with cols <= 16*kw (rows past ``cols``
    count as zero).  ``rhs``: "split" or "f32" (B as given), "bf16" (bf16(B)),
    "hilo" (bf16 hi + bf16 lo of B)."""
    lib = _load()
    _check(zq, "zq", torch.int32, 2)
    _check(b, "b", torch.float32, 2)
    rows, kw = zq.shape
    cols, n = b.shape
    if rhs not in WIDE_RHS:
        raise ValueError(f"rhs must be split/f32/bf16/hilo, got {rhs!r}")
    if cols > 16 * kw or n < 1 or b.device != zq.device:
        raise ValueError(f"wide_dgemm: b {tuple(b.shape)} does not fit zq "
                         f"{tuple(zq.shape)}")
    dev = zq.device
    splits = wide_splits(rows, kw, n, dev)
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    work = torch.empty((splits, rows, n), dtype=torch.float32, device=dev) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = f"wide_dgemm_{rhs}"
    LAUNCHES[name] += 1
    _raise_if(lib.mx_wide_dgemm(_ptr(zq), rows, kw, _ptr(b), cols, n,
                                WIDE_RHS[rhs], _ptr(out), _ptr(work), splits,
                                ctypes.c_void_p(stream)), name)
    return out


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


def _rect(za: torch.Tensor, zb: torch.Tensor, upper: bool, name: str):
    lib = _load()
    _check(za, "za", torch.int32, 2)
    _check(zb, "zb", torch.int32, 2)
    (ra, kw), (rb, kwb) = za.shape, zb.shape
    if kw != kwb or za.device != zb.device:
        raise ValueError(f"{name}: words {tuple(za.shape)} and "
                         f"{tuple(zb.shape)} do not pair")
    out = torch.empty((ra, rb), dtype=torch.int32, device=za.device)
    stream = torch.cuda.current_stream(za.device).cuda_stream
    LAUNCHES[name] += 1
    _raise_if(lib.mx_crossprod_rect(_ptr(za), ra, _ptr(zb), rb, kw, int(upper),
                                    _ptr(out), ctypes.c_void_p(stream)), name)
    return out


def crossprod_rect(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """B8: exact int32 decode(za) decode(zb)^T, [ra, rb]."""
    return _rect(za, zb, False, "crossprod_rect")


def crossprod_tri(zq: torch.Tensor) -> torch.Tensor:
    """B12: decode(zq) decode(zq)^T [rows, rows] on the CROSSPROD_TILE tiles
    that touch or lie above the diagonal; the tiles wholly below it are left
    unwritten for the caller's mirror merge."""
    return _rect(zq, zq, True, "crossprod_tri")


def crossprod_weighted(zq: torch.Tensor, w: torch.Tensor,
                       triangle: bool = True) -> torch.Tensor:
    """B9: f32 decode(zq) diag(w) decode(zq)^T [rows, rows]; ``w`` f32
    [16, kw] plane-major.  ``triangle`` walks the upper tile pairs and
    mirrors; otherwise every tile is computed."""
    lib = _load()
    _check(zq, "zq", torch.int32, 2)
    _check(w, "w", torch.float32, 2)
    rows, kw = zq.shape
    if tuple(w.shape) != (16, kw) or w.device != zq.device:
        raise ValueError(f"crossprod_weighted: w {tuple(w.shape)} must be "
                         f"[16, {kw}] on {zq.device}")
    out = torch.empty((rows, rows), dtype=torch.float32, device=zq.device)
    stream = torch.cuda.current_stream(zq.device).cuda_stream
    LAUNCHES["crossprod_weighted"] += 1
    _raise_if(lib.mx_crossprod_weighted(_ptr(zq), rows, kw, _ptr(w),
                                        int(not triangle), _ptr(out),
                                        ctypes.c_void_p(stream)),
              "crossprod_weighted")
    return out
