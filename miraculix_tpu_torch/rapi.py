"""R-API compatibility surface: the reference's 30 `.Call` entries
(src/miraculix/zzzR.c:84-131) as named Python functions.

Each function documents which reference entry it mirrors and routes to the
port's implementation: products run on the device a call names (the CUDA
card unless named) and come back as numpy arrays.  (scan/sumscan/windower
are legacy CRAN-era statistics absent from the reference snapshot itself —
SURVEY.md §2.2 — and are intentionally out of scope.)
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dgemm as _dgemm_op
from . import from_dense, snp_crossprod
from .api import _numpy, _resolve_device
from .formats import Coding, CodedMatrix, encode
from .formats import transform as _transform
from .formats import zero_geno as _zero_geno
from .formats.haplo import rhaplomatrix as _rhaplomatrix
from .io import codec
from .mobps import (code_origins, compute_relationship,  # noqa: F401
                    compute_snps, decode_origins)
from .solve.dense import solve_relmat as _solve_relmat


# ---------------------------------------------------------------------------
# matrix creation / filling  (haplogeno.R.cc)
# ---------------------------------------------------------------------------

def create_snp_matrix(snps: int, indiv: int,
                      coding: Coding = Coding.TWO_BIT) -> CodedMatrix:
    """``createSNPmatrix``: empty coded container (CreateEmptyCodeVector,
    haplogeno.cc:492)."""
    dense = np.zeros((indiv, snps), dtype=np.uint8)
    return CodedMatrix(encode(dense, coding), coding, snps, indiv)


def fill_snp_matrix(m: CodedMatrix, dense: np.ndarray) -> CodedMatrix:
    """``fillSNPmatrix``: overwrite a container's genotypes."""
    dense = np.asarray(dense, dtype=np.uint8)
    if dense.shape != (m.indiv, m.snps):
        raise ValueError("shape mismatch")
    return CodedMatrix(encode(dense, m.coding), m.coding, m.snps, m.indiv,
                       m.is_haplo)


def vector012matrix(v: np.ndarray, m: CodedMatrix) -> np.ndarray:
    """``vector012matrix``: vᵀ · M for a 0/1/2-coded matrix
    (kleinkram.R.cc)."""
    dense = m.dense().astype(np.float64)
    return np.asarray(v, np.float64) @ dense


def matrixvector012(m: CodedMatrix, v: np.ndarray) -> np.ndarray:
    """``matrixvector012``: M · v."""
    return m.dense().astype(np.float64) @ np.asarray(v, np.float64)


# ---------------------------------------------------------------------------
# products  (Vector.matrix.R.cc, haplogeno.cc)
# ---------------------------------------------------------------------------

def _as_geno(m: CodedMatrix, device=None):
    """Decode+pack a CodedMatrix on ``device`` (the card unless named),
    cached by content hash and device: repeated R-API calls on the same
    matrix reuse the packed panel instead of paying a full re-pack per call
    (reference motivation: the direct-PLINK kernel exists to avoid
    conversion cost, plink256.cc:54-61)."""
    from .formats.codings import HAPLO_CODINGS, haplo_to_geno
    from .utils import panel_cache

    dev = _resolve_device(device)
    if m.coding in HAPLO_CODINGS:
        # haplo dense values are allele PAIRS a1+2·a2 in {0..3}; packing
        # them as genotypes would treat 3 = (1,1) as MISSING and silently
        # zero those sites — convert to genotype dosages a1+a2 first
        # (the reference's haplo2geno step, transform() enforces the same)
        key = ("rapi-h", m.coding, m.snps, m.indiv,
               panel_cache.digest_array(m.buf), str(dev))
        return panel_cache.get_or_build(
            key, lambda: from_dense(haplo_to_geno(m.dense()), device=dev))
    key = ("rapi", m.coding, m.snps, m.indiv,
           panel_cache.digest_array(m.buf), str(dev))
    return panel_cache.get_or_build(
        key, lambda: from_dense(m.dense(), device=dev))


def _f32(v, g) -> torch.Tensor:
    """``v`` as a float32 tensor on the panel's device."""
    return torch.as_tensor(np.asarray(v), dtype=torch.float32,
                           device=g.device)


def geno_vector(m: CodedMatrix, v: np.ndarray, centered: bool = False, *,
                device=None):
    """``genoVector``: Z · v (Z [indiv, snps]), on ``device``."""
    g = _as_geno(m, device)
    return _numpy(_dgemm_op(g, _f32(v, g), trans="n", center=centered))


def vector_geno(m: CodedMatrix, v: np.ndarray, centered: bool = False, *,
                device=None):
    """``vectorGeno``: Zᵀ · v, on ``device``."""
    g = _as_geno(m, device)
    return _numpy(_dgemm_op(g, _f32(v, g), trans="t", center=centered))


def crossprod(m: CodedMatrix, *, device=None) -> np.ndarray:
    """``crossprod``: the SNP-matrix crossproduct ZᵀZ... note the R entry
    returns the *relationship-direction* product matching the coding's
    storage; we expose both via snpmajor.  Exact int32, computed on
    ``device``."""
    return _numpy(snp_crossprod(_as_geno(m, device), snpmajor_output=False))


def crossprod_int(m: CodedMatrix, *, device=None) -> np.ndarray:
    """``crossprodInt``: exact integer crossproduct (int64)."""
    return crossprod(m, device=device).astype(np.int64)


def vector_rel_matrix(m: CodedMatrix, v: np.ndarray, *,
                      device=None) -> np.ndarray:
    """``VectorRelMatrix`` (Vector.matrix.Uint.cc:283+): v ↦ (Z Zᵀ) v, the
    relationship-matrix action used by the standalone driver, computed
    on ``device`` without materializing Z Zᵀ."""
    from .solve.cg import grm_matvec

    v = np.asarray(v, np.float32)
    if v.ndim == 1:
        v = v[:, None]
    g = _as_geno(m, device)
    return _numpy(grm_matvec(g, _f32(v, g), center=False))


def allele_freq(m: CodedMatrix) -> np.ndarray:
    """``allele_freq``: per-SNP frequencies (haplogeno.cc getFreq)."""
    return codec.allele_freq(m.dense(), axis=0)


def substract_centered(m: CodedMatrix) -> np.ndarray:
    """``substract_centered``: the centered real matrix Z - 2·1fᵀ."""
    dense = m.dense().astype(np.float64)
    f = codec.allele_freq(m.dense(), axis=0)
    return dense - 2.0 * f[None, :]


def transpose(m: CodedMatrix) -> CodedMatrix:
    """``transpose``: transposed container in the same coding."""
    return _transform(m, m.coding, transpose=True)


# re-exports matching the remaining .Call names
Transform = _transform
zeroGeno = _zero_geno
rhaplomatrix = _rhaplomatrix
solveRelMat = _solve_relmat
computeSNPS = compute_snps
compute = compute_relationship
codeOrigins = code_origins
decodeOrigins = decode_origins


# ---------------------------------------------------------------------------
# options / debug / user centering state (``copyoptions``, ``Debug``,
# ``StopDebug``, ``get_centered`` — zzzR.c:93,111-112,116)
# ---------------------------------------------------------------------------

_USER_CENTERING: Optional[np.ndarray] = None


def copy_options():
    """``copyoptions``: snapshot of the latched global options."""
    import dataclasses

    from .options import get_global_options

    return dataclasses.replace(get_global_options())


def debug() -> None:
    """``Debug``: raise verbosity (reference toggles Cprintlevel)."""
    import os

    os.environ["MIRACULIX_TPU_PRINT_LEVEL"] = "3"


def stop_debug() -> None:
    """``StopDebug``."""
    import os

    os.environ["MIRACULIX_TPU_PRINT_LEVEL"] = "0"


def set_centered(vector: Optional[np.ndarray]) -> None:
    """Store the User centering vector (reference RFoptions
    genetics.centered=User path, options.R.cc:203)."""
    global _USER_CENTERING
    _USER_CENTERING = None if vector is None else np.asarray(vector,
                                                             np.float64)


def get_centered() -> Optional[np.ndarray]:
    """``get_centered``: the stored User centering vector."""
    return _USER_CENTERING


# ---------------------------------------------------------------------------
# introspection (``exists*`` entries, options.cc:78-120)
# ---------------------------------------------------------------------------

def exists_coding(coding: Coding) -> bool:
    """``existsCoding``-style introspection: is this coding implemented?"""
    from .formats.codings import _CODECS

    return coding in _CODECS


def exists_variant(variant: int) -> bool:
    """``exists_variant`` (options.cc:78-120): reference variants select
    SIMD widths; the CUDA kernels have a single variant each and ignore
    the id, so any non-negative variant id is valid."""
    return variant >= 0


def exists_crossprod(coding: Coding) -> bool:
    return exists_coding(coding)


def exists_allele_freq(coding: Coding) -> bool:
    """``existsAllelefreq``: every decodable coding supports freq here."""
    return exists_coding(coding)


def exists_tiling(rows: int, preferred: int = 512, minimum: int = 8) -> bool:
    """``existsTiling`` analogue: can the kernels tile this axis?
    (reference gates coding x variant tiling combos, options.cc).  The
    CUDA kernels pad any row count (rows to 256, words to 128), so every
    row count tiles; a requested tile below the minimum does not, as in
    the JAX package."""
    return preferred >= minimum and rows >= 0
