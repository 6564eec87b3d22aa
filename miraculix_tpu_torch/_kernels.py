"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one shared
library with a plain C interface, under ``_build/<hash of sources and
flags>/``, and ``ctypes`` loads it.  Nothing is built or loaded at import, so
the package imports (and its CPU paths run) where there is no CUDA toolkit.

Each launcher checks its tensors, launches on the current stream, adds one
to its entry of :data:`LAUNCHES`, and raises if the launch failed; its
call is a span (``utils.logging.span``, recorded while a profile does)
named by that entry, with the packed words' shape (``zq``), B's or the
weights' (``b``) and the mode.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .utils.logging import span

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
            "crossprod_rect": 0, "crossprod_tri": 0, "crossprod_weighted": 0,
            "matmul_int8": 0, "row_sq_stats": 0}
TALL_PASSES = {"bf16": 1, "split": 2, "f32": 3}  # bf16 parts of B per mode
# bf16 parts of B per wide instance: "split" and "hilo" are one instance
WIDE_PASSES = {"bf16": 1, "split": 2, "hilo": 2, "f32": 3}

# (mode, n) -> tall launches since the last reset_launch_counts()
TALL_WIDTHS: collections.Counter = collections.Counter()
# plain version -> its calls since the last reset_launch_counts(): each call
# is a product whose words lay on the CPU, so a run on the card whose
# products all launched kernels leaves every count at 0
PLAIN_CALLS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    TALL_WIDTHS.clear()
    PLAIN_CALLS.clear()


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
            lib.mx_tall_tiles.argtypes = [i32, i32, i32]
            lib.mx_tall_tiles.restype = i32
            lib.mx_tall_blocks_per_sm.argtypes = [i32, i32]
            lib.mx_tall_blocks_per_sm.restype = i32
            lib.mx_tall_parts_bytes.argtypes = [i64, i32, i32]
            lib.mx_tall_parts_bytes.restype = i64
            lib.mx_tall_vrows.argtypes = [i64]
            lib.mx_tall_vrows.restype = i64
            lib.mx_tall_dgemm.argtypes = [vp, i32, vp, i64, i32, vp, vp, vp,
                                          vp, vp, vp, i32, i32, vp]
            lib.mx_tall_dgemm.restype = i32
            lib.mx_wide_tiles.argtypes = [i32, i32, ctypes.POINTER(i32)]
            lib.mx_wide_tiles.restype = i32
            lib.mx_wide_info.argtypes = [i32, i32, ctypes.POINTER(i32)]
            lib.mx_wide_info.restype = i32
            lib.mx_wide_parts_bytes.argtypes = [i32, i32, i32]
            lib.mx_wide_parts_bytes.restype = i64
            lib.mx_wide_dgemm.argtypes = [vp, i32, i32, vp, i64, i32, i32, vp,
                                          i32, vp, vp, vp]
            lib.mx_wide_dgemm.restype = i32
            lib.mx_crossprod_tile.argtypes = []
            lib.mx_crossprod_tile.restype = i32
            lib.mx_crossprod_info.argtypes = [i32, ctypes.POINTER(i32)]
            lib.mx_crossprod_info.restype = i32
            lib.mx_crossprod.argtypes = [vp, i32, i32, vp, vp]
            lib.mx_crossprod.restype = i32
            lib.mx_crossprod_rect.argtypes = [vp, i32, vp, i32, i32, i32, vp,
                                              vp]
            lib.mx_crossprod_rect.restype = i32
            lib.mx_weighted_info.argtypes = [ctypes.POINTER(i32)]
            lib.mx_weighted_info.restype = i32
            lib.mx_weighted_digits_bytes.argtypes = [i32]
            lib.mx_weighted_digits_bytes.restype = i64
            lib.mx_crossprod_weighted.argtypes = [vp, i32, i32, vp, i32, vp,
                                                  vp, vp]
            lib.mx_crossprod_weighted.restype = i32
            lib.mx_matmul_int8_info.argtypes = [i32, ctypes.POINTER(i32)]
            lib.mx_matmul_int8_info.restype = i32
            lib.mx_matmul_int8_layout.argtypes = [vp, i32, i32, i32, vp, vp]
            lib.mx_matmul_int8_layout.restype = i32
            lib.mx_matmul_int8.argtypes = [vp, i32, i32, vp, i32, i32, i32, vp,
                                           vp]
            lib.mx_matmul_int8.restype = i32
            lib.mx_row_sq_stats.argtypes = [vp, i32, i32, vp, vp]
            lib.mx_row_sq_stats.restype = i32
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


# the most contraction rows one tall split sums: the kernel's f32 total
# over all 65,536 SNPs of the 'n' shape drifted past 1e-5 of max |plain|
TALL_SPLIT_ROWS = 8192
WIDE_SPLIT_WORDS = 64    # the wide kernel's splits keep at least this many
WIDE_FILL = 0.9          # ... and split until the last wave is this full
INT8_SPLIT_WORDS = 128   # B10's splits keep at least this many packed words
INT8_INSTANCES = ("narrow", "wide")   # csrc/matmul_int8.cu's two instances


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tall_splits(kwi: int, contract: int, n: int, passes: int,
                device) -> int:
    """Contraction splits that fill one wave of the blocks the card holds at
    once (narrow outputs have too few word tiles to fill it alone), and
    that sum at most TALL_SPLIT_ROWS rows each, each split keeping at least
    256 contraction rows."""
    lib = _load()
    resident = lib.mx_tall_blocks_per_sm(n, passes)
    if resident < 1:
        raise RuntimeError("tall_dgemm: the kernel fits no block on an SM")
    want = max(resident * _sms(device) // lib.mx_tall_tiles(kwi, n, passes),
               -(-contract // TALL_SPLIT_ROWS))
    return max(1, min(want, contract // 256, 65535))


def tall_dgemm(zq: torch.Tensor, b: torch.Tensor, cv=None, mode="split"):
    """K1/K2: ct [n, 16*kwi] (and v [n] when ``cv`` is given).  ``zq`` int32
    [spad, kwi], ``b`` f32 [contract, n] with contract <= spad, ``cv`` f32
    [contract] (split mode only).  ``mode``: "split" (B's bf16 hi + lo),
    "bf16" (hi), "f32" (hi + mid + lo): one bf16 tensor-core pass per part.
    The bf16 parts and the cv partials go through scratch allocated here."""
    name = "tall_dgemm_cv" if cv is not None else \
        "tall_dgemm" if mode == "split" else f"tall_dgemm_{mode}"
    with span(name, zq=zq, b=b, mode=mode):
        lib = _load()
        _check(zq, "zq", torch.int32, 2)
        _check(b, "b", torch.float32, 2)
        spad, kwi = zq.shape
        contract, n = b.shape
        if mode not in TALL_PASSES:
            raise ValueError(f"mode must be split/bf16/f32, got {mode!r}")
        if contract > spad or n < 1 or b.device != zq.device:
            raise ValueError(f"tall_dgemm: b {tuple(b.shape)} does not fit "
                             f"zq {tuple(zq.shape)}")
        if cv is not None and mode != "split":
            raise ValueError("center_vec fusion is a split-mode feature")
        if cv is not None:
            _check(cv, "cv", torch.float32, 1)
            if cv.shape[0] != contract:
                raise ValueError(
                    "cv must have one entry per contraction row")
        dev = zq.device
        passes = TALL_PASSES[mode]
        splits = tall_splits(kwi, contract, n, passes, dev)
        ct = torch.empty((n, 16 * kwi), dtype=torch.float32, device=dev)
        parts = torch.empty(lib.mx_tall_parts_bytes(contract, n, passes),
                            dtype=torch.uint8, device=dev)
        v = vwork = work = None
        if cv is not None:
            v = torch.empty(n, dtype=torch.float32, device=dev)
            vwork = torch.empty((lib.mx_tall_vrows(contract), n),
                                dtype=torch.float32, device=dev)
        if splits > 1:
            work = torch.empty((splits, n, 16 * kwi), dtype=torch.float32,
                               device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        LAUNCHES[name] += 1
        TALL_WIDTHS[(mode, n)] += 1
        _raise_if(lib.mx_tall_dgemm(_ptr(zq), kwi, _ptr(b), contract, n,
                                    _ptr(cv), _ptr(ct), _ptr(v), _ptr(work),
                                    _ptr(vwork), _ptr(parts), splits, passes,
                                    ctypes.c_void_p(stream)), name)
        return ct, v


def _wave_fill(rows: int, kw: int, n: int, info: dict, sms: int):
    """(words a split for s splits, share of the last wave's resident
    blocks that s splits fill) for a kernel of ``info``'s geometry (rows and
    columns a block, words a stage, blocks per SM); splits hold whole
    stages."""
    stage = info["words"]
    tiles = -(-rows // info["rows"]) * -(-n // info["cols"])
    resident = info["blocks_per_sm"] * sms

    def words(s):   # ceil(kw / s), rounded up to whole stages
        per = -(-kw // s)
        return -(-per // stage) * stage

    def fill(s):
        blocks = tiles * -(-kw // words(s))
        return blocks / (-(-blocks // resident) * resident)

    return words, fill, tiles, resident


def wide_tiles(n: int, passes: int) -> tuple:
    """(column chunks, n8 tiles a chunk) of the wide kernel for an n-column
    RHS in ``passes`` bf16 parts."""
    vals = (ctypes.c_int * 3)()
    _raise_if(_load().mx_wide_tiles(n, passes, vals), "wide_tiles")
    return vals[0], vals[1]


_wide_info: dict = {}
_wide_splits: dict = {}   # (shape, passes, device) -> split words


def wide_info() -> dict:
    """Of each instance of ``csrc/wide_dgemm.cu`` on the current device,
    keyed (parts, n8 tiles a chunk): registers and local (spill) bytes a
    thread, dynamic shared memory a block, resident blocks per SM, and its
    geometry (rows a block, columns a chunk, words a stage, threads a
    block, words a promotion, stages), as the CUDA runtime and the library
    report them."""
    key = torch.cuda.current_device()
    if key not in _wide_info:
        lib, info = _load(), {}
        for passes in sorted(set(WIDE_PASSES.values())):
            widest = (ctypes.c_int * 3)()
            _raise_if(lib.mx_wide_tiles(1, passes, widest), "wide_tiles")
            for nt in range(1, widest[2] + 1):
                vals = (ctypes.c_int * 10)()
                _raise_if(lib.mx_wide_info(passes, nt, vals), "wide_info")
                info[(passes, nt)] = dict(zip(
                    ("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "rows", "cols", "words", "threads",
                     "promote", "stages"), vals))
                if vals[3] < 1:
                    raise RuntimeError(f"wide_dgemm: the instance of {passes} "
                                       f"parts x {nt} tiles fits no block on "
                                       "an SM")
        _wide_info[key] = info
    return _wide_info[key]


def wide_split_words(rows: int, kw: int, n: int, info: dict,
                     sms: int) -> int:
    """Packed words a contraction split of the wide kernel sums, a whole
    number of the instance's stages (``info``: one instance of
    :func:`wide_info`): the fewest splits whose last wave of resident
    blocks is at least WIDE_FILL full (else the fullest), each split keeping
    at least WIDE_SPLIT_WORDS words."""
    words, fill, _, _ = _wave_fill(rows, kw, n, info, sms)
    most = max(1, min(kw // WIDE_SPLIT_WORDS, 65535))
    best = 1
    for s in range(1, most + 1):
        if fill(s) >= WIDE_FILL:
            return words(s)
        if fill(s) > fill(best):
            best = s
    return words(best)


def wide_dgemm(zq: torch.Tensor, b: torch.Tensor, rhs: str,
               split_words: int | None = None) -> torch.Tensor:
    """B3/B4/B5/B11: decode(zq) @ B' -> f32 [rows, n].  ``zq`` int32
    [rows, kw], ``b`` f32 [cols, n] with cols <= 16*kw (rows past ``cols``
    count as zero).  ``rhs``: "bf16" (B' = bf16 hi), "split" or "hilo" (hi +
    lo), "f32" (hi + mid + lo = B): one bf16 tensor-core pass per part.
    ``split_words``: words a contraction split (a multiple of the instance's
    stage; default :func:`wide_split_words`).  The bf16 parts and the split
    partials go through scratch allocated here."""
    name = f"wide_dgemm_{rhs}"
    with span(name, zq=zq, b=b, mode=rhs):
        lib = _load()
        _check(zq, "zq", torch.int32, 2)
        _check(b, "b", torch.float32, 2)
        rows, kw = zq.shape
        cols, n = b.shape
        if rhs not in WIDE_PASSES:
            raise ValueError(
                f"rhs must be split/f32/bf16/hilo, got {rhs!r}")
        if cols > 16 * kw or n < 1 or b.device != zq.device:
            raise ValueError(f"wide_dgemm: b {tuple(b.shape)} does not fit "
                             f"zq {tuple(zq.shape)}")
        dev = zq.device
        passes = WIDE_PASSES[rhs]
        if split_words is None:
            key = (rows, kw, n, passes, dev)
            if key not in _wide_splits:
                info = wide_info()[(passes, wide_tiles(n, passes)[1])]
                _wide_splits[key] = wide_split_words(rows, kw, n, info,
                                                     _sms(dev))
            split_words = _wide_splits[key]
        splits = -(-kw // split_words)
        out = torch.empty((rows, n), dtype=torch.float32, device=dev)
        work = torch.empty((splits, rows, n), dtype=torch.float32,
                           device=dev) if splits > 1 else None
        parts = torch.empty(lib.mx_wide_parts_bytes(kw, n, passes),
                            dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        LAUNCHES[name] += 1
        _raise_if(lib.mx_wide_dgemm(_ptr(zq), rows, kw, _ptr(b), cols, n,
                                    passes, _ptr(parts), split_words,
                                    _ptr(out), _ptr(work),
                                    ctypes.c_void_p(stream)), name)
        return out


def crossprod_tile() -> int:
    """The output tile edge of ``csrc/crossprod.cu``: the unit of K3's tile
    pairs and of B12's mask (and so of its mirror merge)."""
    return _load().mx_crossprod_tile()


def crossprod_info() -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory a
    block and resident blocks per SM of the crossproduct kernels, as the
    CUDA runtime reports them on the current device."""
    lib, info = _load(), {}
    for which, name in enumerate(("crossprod_kernel",
                                  "crossprod_rect_kernel")):
        vals = (ctypes.c_int * 4)()
        _raise_if(lib.mx_crossprod_info(which, vals), "crossprod_info")
        info[name] = dict(zip(("registers", "local_bytes", "smem_bytes",
                               "blocks_per_sm"), vals))
    return info


def crossprod(zq: torch.Tensor) -> torch.Tensor:
    """K3: exact int32 decode(zq) decode(zq)^T, [rows, rows]."""
    with span("crossprod", zq=zq):
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
    with span(name, zq=za, b=zb):
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
        _raise_if(lib.mx_crossprod_rect(_ptr(za), ra, _ptr(zb), rb, kw,
                                        int(upper), _ptr(out),
                                        ctypes.c_void_p(stream)), name)
        return out


def crossprod_rect(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """B8: exact int32 decode(za) decode(zb)^T, [ra, rb]."""
    return _rect(za, zb, False, "crossprod_rect")


def crossprod_tri(zq: torch.Tensor) -> torch.Tensor:
    """B12: decode(zq) decode(zq)^T [rows, rows] on the crossprod_tile() tiles
    that touch or lie above the diagonal; the tiles wholly below it are left
    unwritten for the caller's mirror merge."""
    return _rect(zq, zq, True, "crossprod_tri")


_weighted_info: dict = {}


def weighted_info() -> dict:
    """Of ``csrc/crossprod_weighted.cu``'s kernel on the current device:
    registers and local (spill) bytes a thread, dynamic shared memory a
    block, resident blocks per SM, and its geometry (output tile edge,
    threads a block, words a stage, stages), as the CUDA runtime and the
    library report them."""
    key = torch.cuda.current_device()
    if key not in _weighted_info:
        vals = (ctypes.c_int * 8)()
        _raise_if(_load().mx_weighted_info(vals), "weighted_info")
        info = dict(zip(("registers", "local_bytes", "smem_bytes",
                         "blocks_per_sm", "tile", "threads", "words",
                         "stages"), vals))
        if info["blocks_per_sm"] < 1:
            raise RuntimeError("crossprod_weighted: the kernel fits no block "
                               "on an SM")
        _weighted_info[key] = info
    return _weighted_info[key]


def crossprod_weighted(zq: torch.Tensor, w: torch.Tensor,
                       triangle: bool = True) -> torch.Tensor:
    """B9: f32 decode(zq) diag(w) decode(zq)^T [rows, rows]; ``w`` f32
    [16, kw] plane-major.  ``triangle`` walks the upper tile pairs and
    mirrors; otherwise every tile is computed.  w's three masked bf16
    digits go through scratch allocated here."""
    with span("crossprod_weighted", zq=zq, b=w):
        lib = _load()
        _check(zq, "zq", torch.int32, 2)
        _check(w, "w", torch.float32, 2)
        rows, kw = zq.shape
        if tuple(w.shape) != (16, kw) or w.device != zq.device:
            raise ValueError(f"crossprod_weighted: w {tuple(w.shape)} must "
                             f"be [16, {kw}] on {zq.device}")
        out = torch.empty((rows, rows), dtype=torch.float32, device=zq.device)
        dg = torch.empty(lib.mx_weighted_digits_bytes(kw), dtype=torch.uint8,
                         device=zq.device)
        stream = torch.cuda.current_stream(zq.device).cuda_stream
        LAUNCHES["crossprod_weighted"] += 1
        _raise_if(lib.mx_crossprod_weighted(
            _ptr(zq), rows, kw, _ptr(w), int(not triangle), _ptr(dg),
            _ptr(out), ctypes.c_void_p(stream)), "crossprod_weighted")
        return out


def digit_quads(d: torch.Tensor, kw: int) -> torch.Tensor:
    """int8 digits [cols <= 16*kw, n] (plane-major rows m*kw + w) -> int32
    [n, ceil(kw / 4), 4, 4] whose byte b of entry (j, P, q, u) is the digit
    of plane 4b + q, word 4P + u, column j (zero past ``cols`` and kw): the
    digit operand of ``csrc/matmul_int8.cu``, one 16-byte chunk per
    (column, four words, register q).  CUDA tensors take the kernel's
    pre-pass (part of B10's launch in :func:`matmul_int8`), CPU tensors
    this plain version."""
    cols, n = d.shape
    kwq = -(-kw // 4)
    if d.is_cuda:
        _check(d, "d", torch.int8, 2)
        dq = torch.empty((n, kwq, 4, 4), dtype=torch.int32, device=d.device)
        stream = torch.cuda.current_stream(d.device).cuda_stream
        _raise_if(_load().mx_matmul_int8_layout(_ptr(d), cols, n, kw,
                                                _ptr(dq),
                                                ctypes.c_void_p(stream)),
                  "matmul_int8 layout")
        return dq
    full = torch.zeros((16, 4 * kwq, n), dtype=torch.int8, device=d.device)
    planes = cols // kw
    full[:planes, :kw] = d[:planes * kw].reshape(planes, kw, n)
    if cols % kw:
        full[planes, :cols % kw] = d[planes * kw:]
    # [b, q, P, u, j] -> [j, P, q, u, b]; four little-endian bytes per int32
    return (full.reshape(4, 4, kwq, 4, n).permute(4, 2, 1, 3, 0).contiguous()
            .view(torch.int32).reshape(n, kwq, 4, 4))


_int8_info: dict = {}
_int8_splits: dict = {}   # (shape, instance, device) -> split words


def matmul_int8_info() -> dict:
    """Of each instance of ``csrc/matmul_int8.cu`` on the current device:
    registers and local (spill) bytes a thread, dynamic shared memory a
    block, resident blocks per SM, and its geometry (rows and digit columns
    a block, words a stage, threads a block), as the CUDA runtime and the
    library report them."""
    key = torch.cuda.current_device()
    if key not in _int8_info:
        lib, info = _load(), {}
        for wide, name in enumerate(INT8_INSTANCES):
            vals = (ctypes.c_int * 8)()
            _raise_if(lib.mx_matmul_int8_info(wide, vals), "matmul_int8_info")
            info[name] = dict(zip(("registers", "local_bytes", "smem_bytes",
                                   "blocks_per_sm", "rows", "cols", "words",
                                   "threads"), vals))
            if info[name]["blocks_per_sm"] < 1:
                raise RuntimeError(f"matmul_int8: the {name} instance fits "
                                   "no block on an SM")
        _int8_info[key] = info
    return _int8_info[key]


def int8_split_words(rows: int, kw: int, n: int, info: dict, sms: int,
                     waves: int = 1) -> int:
    """Packed words a contraction split of B10 sums, a whole number of the
    instance's stages (``info``: one instance of :func:`matmul_int8_info`).
    Where the row and column tiles alone launch fewer than ``waves`` waves
    of resident blocks, the contraction splits: of the split counts from
    the least that reaches ``waves`` waves to twice that, the one whose
    last wave is fullest, each split keeping >= INT8_SPLIT_WORDS words."""
    words, fill, tiles, resident = _wave_fill(rows, kw, n, info, sms)
    least = -(-waves * resident // tiles)
    most = max(1, min(kw // INT8_SPLIT_WORDS, 65535))
    if least <= 1 or most == 1:
        return words(1)
    best = max(range(least, 2 * least + 1), key=lambda s: (fill(s), -s))
    return words(min(best, most))


def matmul_int8_quads(zq: torch.Tensor, dq: torch.Tensor, n: int,
                      instance: str | None = None,
                      split_words: int | None = None) -> torch.Tensor:
    """B10 on digit quads ``dq`` (:func:`digit_quads` of the int8 digits):
    exact int32 decode(zq) @ D [rows, n].  ``instance``: "narrow" (8 digit
    columns a block) or "wide" (96); by default the narrow one up to 8
    columns.  ``split_words``: words a contraction split (a multiple of the
    instance's stage; default :func:`int8_split_words`)."""
    lib = _load()
    _check(zq, "zq", torch.int32, 2)
    _check(dq, "dq", torch.int32, 4)
    rows, kw = zq.shape
    if tuple(dq.shape) != (n, -(-kw // 4), 4, 4) or dq.device != zq.device \
            or dq.data_ptr() % 16:
        raise ValueError(f"matmul_int8: digit quads {tuple(dq.shape)} do not "
                         f"fit zq {tuple(zq.shape)} at {n} columns (or are "
                         "not 16-byte aligned)")
    dev = zq.device
    info = matmul_int8_info()
    if instance is None:
        instance = "narrow" if n <= info["narrow"]["cols"] else "wide"
    if instance not in INT8_INSTANCES:
        raise ValueError(f"instance must be narrow/wide, got {instance!r}")
    if split_words is None:
        key = (rows, kw, n, instance, dev)
        if key not in _int8_splits:
            _int8_splits[key] = int8_split_words(rows, kw, n, info[instance],
                                                 _sms(dev))
        split_words = _int8_splits[key]
    out = torch.empty((rows, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES["matmul_int8"] += 1
    _raise_if(lib.mx_matmul_int8(_ptr(zq), rows, kw, _ptr(dq), n,
                                 INT8_INSTANCES.index(instance), split_words,
                                 _ptr(out), ctypes.c_void_p(stream)),
              "matmul_int8")
    return out


def matmul_int8(zq: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """B10: exact int32 decode(zq) @ D [rows, n].  ``zq`` int32 [rows, kw],
    ``d`` int8 digits [cols <= 16*kw, n] (rows past ``cols`` count as zero);
    the caller keeps 192 * 16 * kw < 2^31.  The digits are laid out as
    :func:`digit_quads` and go through :func:`matmul_int8_quads`."""
    with span("matmul_int8", zq=zq, b=d):
        _check(zq, "zq", torch.int32, 2)
        _check(d, "d", torch.int8, 2)
        kw = zq.shape[1]
        cols, n = d.shape
        if cols > 16 * kw or n < 1 or d.device != zq.device:
            raise ValueError(f"matmul_int8: digits {tuple(d.shape)} do not "
                             f"fit zq {tuple(zq.shape)}")
        return matmul_int8_quads(zq, digit_quads(d, kw), n)


def row_sq_stats(zq: torch.Tensor) -> torch.Tensor:
    """Exact per-row sum of z^2 over a planar16 packing, f32 [rows]: one read
    of ``zq`` int32 [rows, kw] (``csrc/row_sq_stats.cu``), on the current
    stream of zq's own card."""
    with span("row_sq_stats", zq=zq):
        _check(zq, "zq", torch.int32, 2)
        lib = _load()
        rows, kw = zq.shape
        if zq.numel() == 0:
            return torch.zeros(rows, dtype=torch.float32, device=zq.device)
        out = torch.empty(rows, dtype=torch.float32, device=zq.device)
        with torch.cuda.device(zq.device):
            stream = torch.cuda.current_stream(zq.device).cuda_stream
            LAUNCHES["row_sq_stats"] += 1
            _raise_if(lib.mx_row_sq_stats(_ptr(zq), rows, kw, _ptr(out),
                                          ctypes.c_void_p(stream)),
                      "row_sq_stats")
        return out
