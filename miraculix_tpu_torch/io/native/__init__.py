"""The port's native host codec: ``codec.cpp``, built at first use, through
ctypes.

At first use g++ compiles this directory's ``codec.cpp`` (``-O3
-march=native -fopenmp``) into ``miraculix_tpu_torch/_build/<hash of the
source and flags>/libmxcodec.so`` (a process-unique temporary file moved
into place, so concurrent builds see all or nothing) and ctypes loads it.
Nothing is built or loaded at import.

Each wrapper takes and returns numpy arrays with the signatures of the
reference's ``miraculix_tpu.io.native`` wrappers, adds one to its entry of
:data:`CALLS` when the native code runs, and returns None when the library
is unavailable: where g++ is missing or the build failed (which warns once,
with the compiler's messages), or inside :func:`disabled`.  The callers in
``io/codec.py``, ``geno.py`` and ``ops/grm.py`` then run their numpy
versions, which are the oracle the native code is tested against.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "codec.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")

# wrapper name -> native calls since the last reset_call_counts()
CALLS = {k: 0 for k in (
    "plink_to_dense", "payload_to_dense", "dense_to_plink", "pack_planar16",
    "allele_freq", "count_missing", "transpose_u8", "bed_ingest",
    "bed_colstats", "inbreeding", "ld_prune", "ld_prune_mask")}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_off = 0   # depth of disabled() contexts


def reset_call_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


@contextlib.contextmanager
def disabled():
    """Run the numpy versions inside this context (the oracle runs)."""
    global _off
    _off += 1
    try:
        yield
    finally:
        _off -= 1


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / h.hexdigest()[:16] / "libmxcodec.so"


def build() -> Path:
    """Compile ``codec.cpp`` unless the library of this source exists;
    raises RuntimeError with g++'s messages if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"g++ did not run: {exc}") from exc
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, u8p, u32p, f64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_double))
    i64p, f32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
    lib.mx_plink_to_dense.argtypes = [u8p, i64, i64, i64, u8p]
    lib.mx_payload_to_dense.argtypes = [u8p, i64, i64, i64, u8p]
    lib.mx_dense_to_plink.argtypes = [u8p, i64, i64, u8p]
    lib.mx_pack_planar16.argtypes = [u8p, i64, i64, i64, i64, i64, i64, u32p]
    lib.mx_allele_freq.argtypes = [u8p, i64, i64, f64p]
    lib.mx_count_missing.argtypes = [u8p, i64, i64]
    lib.mx_count_missing.restype = i64
    lib.mx_transpose_u8.argtypes = [u8p, i64, i64, u8p]
    lib.mx_bed_ingest.argtypes = [u8p, i64, i64, i64, i64, i64, i64, u32p,
                                  u32p, f64p, f64p]
    lib.mx_bed_colstats.argtypes = [u8p, i64, i64, i64p, i64p]
    lib.mx_inbreeding.argtypes = [i64p, i64p, i64, f64p]
    lib.mx_ld_prune.argtypes = [f32p, f64p, ctypes.c_double, i64, i64, u8p]
    lib.mx_ld_prune_mask.argtypes = [u8p, f64p, i64, i64, u8p]
    lib.mx_codec_version.argtypes = []
    lib.mx_codec_version.restype = ctypes.c_int
    for name in ("mx_plink_to_dense", "mx_payload_to_dense",
                 "mx_dense_to_plink", "mx_pack_planar16", "mx_allele_freq",
                 "mx_transpose_u8", "mx_bed_ingest", "mx_bed_colstats",
                 "mx_inbreeding", "mx_ld_prune", "mx_ld_prune_mask"):
        getattr(lib, name).restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (building it if needed), or None where it is
    unavailable or inside :func:`disabled`."""
    global _lib, _tried
    if _off:
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as exc:
                warnings.warn(f"native codec unavailable, numpy runs "
                              f"instead: {exc}", RuntimeWarning, stacklevel=2)
    return _lib


def codec_version() -> Optional[int]:
    lib = get_lib()
    return None if lib is None else int(lib.mx_codec_version())


def _ptr(a: Optional[np.ndarray], ctype):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _check_payload(payload, snps: int, indiv: int) -> np.ndarray:
    payload = _u8(payload)
    if payload.shape != (snps, (indiv + 3) // 4):
        raise ValueError(f"payload {payload.shape} is not {snps} SNPs of "
                         f"{(indiv + 3) // 4} bytes")
    return payload


def _check_within(n_within: int, nbytes: int) -> None:
    if not 0 <= n_within <= 4 * nbytes:
        raise ValueError(f"{nbytes} bytes cannot hold {n_within} genotypes")


def _lib_for(name: str) -> Optional[ctypes.CDLL]:
    lib = get_lib()
    if lib is not None:
        CALLS[name] += 1
    return lib


# ---------------------------------------------------------------------------
# numpy-signature wrappers (None where the library is unavailable)
# ---------------------------------------------------------------------------

def plink_to_dense(plink: np.ndarray, n_within: int) -> Optional[np.ndarray]:
    """PLINK bytes [ceil(n_within/4), n_major] -> uint8 [n_within, n_major]."""
    lib = _lib_for("plink_to_dense")
    if lib is None:
        return None
    plink = _u8(plink)
    nbytes, nmajor = plink.shape
    _check_within(n_within, nbytes)
    out = np.empty((n_within, nmajor), dtype=np.uint8)
    lib.mx_plink_to_dense(_ptr(plink, ctypes.c_uint8), nbytes, nmajor,
                          n_within, _ptr(out, ctypes.c_uint8))
    return out


def payload_to_dense(payload: np.ndarray,
                     n_within: int) -> Optional[np.ndarray]:
    """SNP-major payload [n_major, ceil(n_within/4)] -> uint8
    [n_major, n_within]."""
    lib = _lib_for("payload_to_dense")
    if lib is None:
        return None
    payload = _u8(payload)
    nmajor, nbytes = payload.shape
    _check_within(n_within, nbytes)
    out = np.empty((nmajor, n_within), dtype=np.uint8)
    lib.mx_payload_to_dense(_ptr(payload, ctypes.c_uint8), nmajor, nbytes,
                            n_within, _ptr(out, ctypes.c_uint8))
    return out


def dense_to_plink(geno: np.ndarray) -> Optional[np.ndarray]:
    """Genotypes [n_within, n_major] -> PLINK bytes [ceil(n_within/4),
    n_major]."""
    lib = _lib_for("dense_to_plink")
    if lib is None:
        return None
    geno = _u8(geno)
    n_within, nmajor = geno.shape
    out = np.empty(((n_within + 3) // 4, nmajor), dtype=np.uint8)
    lib.mx_dense_to_plink(_ptr(geno, ctypes.c_uint8), n_within, nmajor,
                          _ptr(out, ctypes.c_uint8))
    return out


def pack_planar16(geno: np.ndarray, rp: int, kw: int) -> Optional[np.ndarray]:
    """Strided pack of uint8 genotypes (missing zeroed) into uint32 words
    [rp, kw]: C-contiguous arrays and transposed views alike (no host copy
    of the view).  None also for other dtypes or strides that are not whole
    elements."""
    if geno.dtype != np.uint8 or any(s % geno.itemsize for s in geno.strides):
        return None
    lib = _lib_for("pack_planar16")
    if lib is None:
        return None
    rows, cols = geno.shape
    if rp < rows or 16 * kw < cols:
        raise ValueError(f"[{rp}, {kw}] words cannot hold {rows} x {cols}")
    s0, s1 = (s // geno.itemsize for s in geno.strides)
    out = np.empty((rp, kw), dtype=np.uint32)
    lib.mx_pack_planar16(_ptr(geno, ctypes.c_uint8), rows, cols, s0, s1, rp,
                         kw, _ptr(out, ctypes.c_uint32))
    return out


def allele_freq(geno: np.ndarray) -> Optional[np.ndarray]:
    """Per-column allele frequencies of uint8 [rows, cols] (float64)."""
    lib = _lib_for("allele_freq")
    if lib is None:
        return None
    geno = _u8(geno)
    rows, cols = geno.shape
    out = np.empty(cols, dtype=np.float64)
    lib.mx_allele_freq(_ptr(geno, ctypes.c_uint8), rows, cols,
                       _ptr(out, ctypes.c_double))
    return out


def count_missing(geno: np.ndarray) -> Optional[int]:
    lib = _lib_for("count_missing")
    if lib is None:
        return None
    geno = _u8(geno)
    rows, cols = geno.shape
    return int(lib.mx_count_missing(_ptr(geno, ctypes.c_uint8), rows, cols))


def transpose_u8(geno: np.ndarray) -> Optional[np.ndarray]:
    """Blocked byte-matrix transpose -> C-contiguous [cols, rows]."""
    lib = _lib_for("transpose_u8")
    if lib is None:
        return None
    geno = _u8(geno)
    rows, cols = geno.shape
    out = np.empty((cols, rows), dtype=np.uint8)
    lib.mx_transpose_u8(_ptr(geno, ctypes.c_uint8), rows, cols,
                        _ptr(out, ctypes.c_uint8))
    return out


def bed_ingest(payload: np.ndarray, snps: int, indiv: int, spad: int,
               kwi: int, ipad: int, kws: int, want_t: bool = True,
               want_n: bool = True, want_pfreq: bool = True):
    """Fused .bed -> planar16 packings of both orientations and the
    frequency caches, with no dense matrix: ``payload`` uint8 [snps,
    ceil(indiv/4)] (the SNP-major stream after the magic bytes).  Returns
    (zq_t [spad, kwi], zq_n [ipad, kws], freq [snps], pseudo_freq [indiv])
    with None for each output not wanted (freq is always computed), or None
    where the library is unavailable."""
    lib = _lib_for("bed_ingest")
    if lib is None:
        return None
    payload = _check_payload(payload, snps, indiv)
    if spad < snps or ipad < indiv or 16 * kwi < indiv or 16 * kws < snps:
        raise ValueError("padded dims smaller than the panel")
    zqt = np.empty((spad, kwi), dtype=np.uint32) if want_t else None
    zqn = np.empty((ipad, kws), dtype=np.uint32) if want_n else None
    freq = np.empty(snps, dtype=np.float64)
    pfreq = np.empty(indiv, dtype=np.float64) if want_pfreq else None
    lib.mx_bed_ingest(_ptr(payload, ctypes.c_uint8), snps, indiv, spad, kwi,
                      ipad, kws, _ptr(zqt, ctypes.c_uint32),
                      _ptr(zqn, ctypes.c_uint32), _ptr(freq, ctypes.c_double),
                      _ptr(pfreq, ctypes.c_double))
    return zqt, zqn, freq, pfreq


def bed_colstats(payload: np.ndarray, snps: int, indiv: int):
    """Per-individual (genotype sum, called count), int64 [indiv] each,
    over a raw SNP-major payload: the exact ingredients of whole-panel
    pseudo-frequencies summed over SNP chunks."""
    lib = _lib_for("bed_colstats")
    if lib is None:
        return None
    payload = _check_payload(payload, snps, indiv)
    out_sum = np.empty(indiv, dtype=np.int64)
    out_called = np.empty(indiv, dtype=np.int64)
    lib.mx_bed_colstats(_ptr(payload, ctypes.c_uint8), snps, indiv,
                        _ptr(out_sum, ctypes.c_int64),
                        _ptr(out_called, ctypes.c_int64))
    return out_sum, out_called


def inbreeding(sire: np.ndarray, dam: np.ndarray) -> Optional[np.ndarray]:
    """Meuwissen & Luo inbreeding coefficients, float64 [n], of a pedigree
    with 1-based parents (0 = unknown) that precede their offspring (the
    caller validates it)."""
    lib = _lib_for("inbreeding")
    if lib is None:
        return None
    s64 = np.ascontiguousarray(sire, np.int64)
    d64 = np.ascontiguousarray(dam, np.int64)
    own = np.arange(s64.shape[0])    # animal i's parents are among 1..i
    if (s64.shape != d64.shape or s64.ndim != 1 or
            ((s64 < 0) | (s64 > own) | (d64 < 0) | (d64 > own)).any()):
        raise ValueError("sire and dam must be 1-D, of one length, with "
                         "parents (1-based, 0 = unknown) before offspring")
    f = np.empty(s64.shape[0], np.float64)
    lib.mx_inbreeding(_ptr(s64, ctypes.c_int64), _ptr(d64, ctypes.c_int64),
                      s64.shape[0], _ptr(f, ctypes.c_double))
    return f


def _check_maf(maf, snps: int) -> np.ndarray:
    maf = np.ascontiguousarray(maf, dtype=np.float64)
    if maf.shape != (snps,):
        raise ValueError(f"maf {maf.shape} does not match {snps} SNPs")
    return maf


def ld_prune(band2: np.ndarray, maf: np.ndarray,
             r2_threshold: float) -> Optional[np.ndarray]:
    """Greedy banded LD prune over r^2 [snps, window] (offending pairs
    r^2 > threshold); returns the keep mask [snps] bool."""
    lib = _lib_for("ld_prune")
    if lib is None:
        return None
    band2 = np.ascontiguousarray(band2, dtype=np.float32)
    maf = _check_maf(maf, band2.shape[0])
    snps, window = band2.shape
    keep = np.empty(snps, dtype=np.uint8)
    lib.mx_ld_prune(_ptr(band2, ctypes.c_float), _ptr(maf, ctypes.c_double),
                    float(r2_threshold), snps, window,
                    _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


def ld_prune_mask(mask: np.ndarray, maf: np.ndarray) -> Optional[np.ndarray]:
    """The same scan over a thresholded uint8 offender mask [snps, window]
    (nonzero = offending); returns the keep mask [snps] bool."""
    lib = _lib_for("ld_prune_mask")
    if lib is None:
        return None
    mask = _u8(mask)
    maf = _check_maf(maf, mask.shape[0])
    snps, window = mask.shape
    keep = np.empty(snps, dtype=np.uint8)
    lib.mx_ld_prune_mask(_ptr(mask, ctypes.c_uint8),
                         _ptr(maf, ctypes.c_double), snps, window,
                         _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)
