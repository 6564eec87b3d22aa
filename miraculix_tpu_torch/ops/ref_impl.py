"""Dense float64 oracle implementations (numpy).

Test-time ground truth, playing the role of the reference's OneByte coding
comparisons (src/miraculix/main.cc:583-760) and the dense-BLAS oracles in its
Julia tests (tests/dgemm_compressed/test.jl:96-105,
tests/crossproduct/test_grm.jl:114-142).
"""
from __future__ import annotations

import numpy as np


def _clean(geno: np.ndarray) -> np.ndarray:
    g = np.asarray(geno, dtype=np.float64)
    return np.where(g == 3, 0.0, g)  # missing -> 0 (ignore_missings path)


def dgemm_oracle(
    geno: np.ndarray,
    b: np.ndarray,
    freq: np.ndarray,
    trans: str = "n",
    center: bool = True,
    normalize: bool = False,
    respect_missings: bool = False,
    pseudo_freq: np.ndarray = None,
) -> np.ndarray:
    """C = (Z - M) @ B  /  its transpose; Z = geno [indiv, snps].

    ``center``: True/"rowmeans" -> M = 2·1fᵀ; "colmeans" -> M = 2·pf·1ᵀ;
    an array u -> M = 1uᵀ; False -> 0.  ``normalize`` divides by
    sqrt(2Σp(1-p)) (SNP freqs for 't', per-individual pseudo-freqs for 'n')
    — GlobalNormalizing, reference Vector.matrix.D.cc:213-222.
    """
    z = _clean(geno)
    f = np.asarray(freq, dtype=np.float64)
    if pseudo_freq is None:
        pseudo_freq = allele_freq_oracle(geno, axis=1)
    pf = np.asarray(pseudo_freq, dtype=np.float64)
    if center is True or (isinstance(center, str) and center == "rowmeans"):
        zc = z - 2.0 * f[None, :]
    elif isinstance(center, str) and center == "colmeans":
        zc = z - 2.0 * pf[:, None]
    elif center is False or center is None:
        zc = z
    else:  # user vector
        zc = z - np.asarray(center, np.float64)[None, :]
    if respect_missings and (center is not False and center is not None):
        zc = np.where(np.asarray(geno) == 3, 0.0, zc)
    c = zc @ b if trans.lower() == "n" else zc.T @ b
    if normalize:
        s2 = (2.0 * np.sum(f * (1.0 - f)) if trans.lower() == "t"
              else 2.0 * np.sum(pf * (1.0 - pf)))
        c = c / np.sqrt(s2)
    return c


def allele_freq_oracle(geno: np.ndarray, axis: int = 0) -> np.ndarray:
    """Missing-aware allele frequency along ``axis``."""
    g = np.asarray(geno)
    miss = g == 3
    vals = np.where(miss, 0, g).astype(np.float64)
    called = np.maximum((~miss).sum(axis=axis), 1)
    return vals.sum(axis=axis) / (2.0 * called)


def crossprod_oracle(geno: np.ndarray, snpmajor_output: bool = False) -> np.ndarray:
    z = _clean(geno)
    return (z.T @ z) if snpmajor_output else (z @ z.T)


def grm_oracle(geno: np.ndarray, freq: np.ndarray, scale: bool = True) -> np.ndarray:
    """Centered GRM directly from the definition G = P Z Zᵀ Pᵀ / 2Σp(1-p)
    with P = I - 11ᵀ/n (docs/grm.md:1-10)."""
    z = _clean(geno)
    n = z.shape[0]
    zc = z - z.mean(axis=0, keepdims=True)
    gmat = zc @ zc.T
    if scale:
        f = np.asarray(freq, dtype=np.float64)
        gmat = gmat / (2.0 * np.sum(f * (1.0 - f)))
    return gmat


def ld_oracle(geno: np.ndarray, freq: np.ndarray) -> np.ndarray:
    z = _clean(geno)
    n = z.shape[0]
    f = np.asarray(freq, dtype=np.float64)
    m = z.T @ z - 4.0 * n * np.outer(f, f)
    sigma = np.sqrt(np.diag(m))
    return m / sigma[:, None] / sigma[None, :]
