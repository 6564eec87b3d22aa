"""Global/typed options mirroring the reference option store.

The reference latches process-global options via ``setOptions_compressed``
(src/miraculix/5codesAPI.c:43-70, option struct src/miraculix/options.h:26-81)
before preprocessing.  Here options are an explicit dataclass: the functional
API takes keyword arguments, while the C-shaped facade
(miraculix_tpu_torch.api) keeps a module-global instance to match the
reference's latch-then-call usage.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Options:
    """Execution options.

    Fields map 1:1 to ``setOptions_compressed(use_gpu, cores, floatLoop,
    meanSubstract, ignore_missings, do_not_center, do_normalize,
    use_miraculix_freq, variant, print_details)`` — reference
    src/miraculix/5codesAPI.c:43-70:

    - use_gpu: use the GPU compute path.  Advisory, as in the reference's
      C API: the device a panel lives on decides where its products run
      (the card unless a call names another device).
    - precision: "fast"  = bf16-split RHS, f32 accumulate (default; exact for
                  the genotype operand, ~f32 overall),
                 "bf16"  = ONE bf16 pass, ~2e-3 relative (for iterative
                  solvers and screening),
                 "f32"   = three bf16 passes of the RHS, f32 grade,
                 "f64"   = exact integer digit products recombined in
                  float64 (for 1e-4-grade tolerances on >100k-SNP axes).
      Replaces ``floatLoop`` (0 == doubles; reference 5codesChar.cc:188-204).
    - ignore_missings: missings enter as genotype 0 with NO post-correction
      (the reference default in the Julia binding, dgemm_compressed.jl:45).
      If False, centering corrections for recorded missing positions are
      applied (reference Vector.matrix.D.cc:179-208).
    - center: subtract 2f per SNP (``do_not_center`` inverted; RowMeans
      semantics, reference 5codesChar.cc:127-143).
    - normalize: divide the centered product by sigma = sqrt(2*sum p(1-p))
      (``do_normalize`` -> GlobalNormalizing, reference
      Vector.matrix.D.cc:213-222; SNP freqs for 't', per-individual
      pseudo-frequencies for 'n').
    - use_internal_freq: compute allele frequencies from the data instead of
      requiring externally supplied ones (``use_miraculix_freq``).
    - variant: kernel variant selector; 0 = auto.  Kept for API parity with
      the reference's 32/128/256/512 SIMD-width variants (options.h:113-119);
      accepted and without effect here, as the CUDA kernels have no tile
      presets to choose from.
    - verbose: print details (``print_details``).
    """

    use_gpu: bool = True
    cores: int = 0                      # accepted for parity; unused
    precision: str = "fast"             # "fast" | "bf16" | "f32" | "f64"
    mean_subtract: bool = False         # meanSubstract numerical trick
    ignore_missings: bool = True
    center: bool = True
    normalize: bool = False
    use_internal_freq: bool = False
    variant: int = 0
    verbose: int = 0
    max_n: int = 0                      # max RHS columns hint (GPU parity)

    def resolve_cores(self) -> int:
        if self.cores > 0:
            return self.cores
        env = os.environ.get("OMP_NUM_THREADS")
        if env:
            return int(env)
        return os.cpu_count() or 4


_GLOBAL: Optional[Options] = None


def set_global_options(opts: Options) -> None:
    global _GLOBAL
    _GLOBAL = opts


def get_global_options() -> Options:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Options()
    return _GLOBAL
