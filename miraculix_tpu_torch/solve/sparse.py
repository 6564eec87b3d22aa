"""Sparse triangular solves (the MiXBLUP single-step path), O(nnz) storage.

Torch twin of ``miraculix_tpu.solve.sparse``.  A COO triangular factor is
analysed once, then serves repeated solves L x = b, L^T x = b and
L (L^T x) = b with an optional row permutation, as the reference's
``sparse2gpu`` / ``dcsrtrsv_solve_gpu`` / ``free_sparse_gpu`` lifecycle.

The solve is blocked substitution: the unknowns split into contiguous blocks
of ``bs`` rows; the factor's dense ``bs x bs`` diagonal blocks are inverted
once at analysis (a triangular inverse, so applying one is one small
matmul), and its off-diagonal entries are kept as flat COO grouped per block
for each sweep direction.  One Python loop over the blocks substitutes: a
step gathers the entries of x it depends on, subtracts their contribution
with one ``index_add_``, multiplies by the inverted diagonal block and
writes block i of x.  On the card every step is a handful of launches, so
the loop is bound by the host's launch rate.

float64 solves run where the device has float64 (the CPU by default);
float32 solvers invert the diagonal blocks on their own device (block
doubling over batched ``torch.linalg.inv`` bases, then one Newton step) and
reach float64 grade by mixed-precision refinement against host float64
residuals (:meth:`SparseTriangularSolver.solve_f64`).  Every float32 product
here runs at full float32 precision, TF32 off, whatever the caller's global
setting.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..geno import _device


@contextlib.contextmanager
def _full_f32():
    """float32 cuBLAS products at float32 precision (no TF32) inside the
    block, whatever the caller set; the caller's flag is restored after.
    Only the cuBLAS flag is read and written: torch refuses to report one
    global precision once the caller has set flags of different
    backends."""
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = was


def _invert_tri_batched(t: np.ndarray, lower: bool,
                        base: int = 32) -> np.ndarray:
    """Invert a batch of triangular matrices [nb, bs, bs] with batched
    LAPACK at a small ``base`` block size, then bottom-up block doubling
    where every level is one stacked matmul over all sub-blocks of all
    batch members at once.

    For lower-triangular [[A, 0], [C, D]] the inverse is
    [[A^-1, 0], [-D^-1 C A^-1, D^-1]]; ``np.linalg.inv`` on the batched
    ``base x base`` diagonal sub-blocks seeds the recursion and
    log2(bs/base) doubling levels build the full inverse.  A ``bs`` that is
    not a power of two is padded with identity tails."""
    nb, bs, _ = t.shape
    p2 = 1 << (bs - 1).bit_length()
    if p2 != bs:  # pad to the next power of two with identity tails
        tp = np.zeros((nb, p2, p2), t.dtype)
        tp[:, :bs, :bs] = t
        idx = np.arange(bs, p2)
        tp[:, idx, idx] = 1.0
        return _invert_tri_batched(tp, lower, base)[:, :bs, :bs]
    if not lower:
        # upper triangle: invert the transposed-lower batch, transpose back
        return _invert_tri_batched(
            np.ascontiguousarray(t.transpose(0, 2, 1)), True, base
        ).transpose(0, 2, 1)
    base = min(base, bs)
    out = np.zeros_like(t)
    ns0 = bs // base
    tv0 = t.reshape(nb, ns0, base, ns0, base)
    ov0 = out.reshape(nb, ns0, base, ns0, base)
    i0 = np.arange(ns0)
    # advanced indexing moves the sub-block axis first: (ns0, nb, b, b)
    ov0[:, i0, :, i0, :] = np.linalg.inv(tv0[:, i0, :, i0, :])
    h = base
    while h < bs:
        ns = bs // (2 * h)
        # diagonal 2h x 2h sub-blocks as [nb, ns, 2h, 2h]: rows of
        # sub-block i are i*2h + r, a pure reshape of the last two axes
        tv = t.reshape(nb, ns, 2 * h, ns, 2 * h)
        ov = out.reshape(nb, ns, 2 * h, ns, 2 * h)
        i = np.arange(ns)
        c = tv[:, i, h:, i, :h]
        ai = ov[:, i, :h, i, :h]
        di = ov[:, i, h:, i, h:]
        ov[:, i, h:, i, :h] = -np.matmul(di, np.matmul(c, ai))
        h *= 2
    return out


def _diag_blocks(t: torch.Tensor, ns: int, w: int) -> torch.Tensor:
    """The ``ns`` diagonal ``w x w`` sub-blocks of t [nb, ns*w, ns*w], as a
    view [nb, ns, w, w]."""
    nb = t.shape[0]
    return torch.diagonal(t.view(nb, ns, w, ns, w), dim1=1,
                          dim2=3).movedim(-1, 1)


def _assemble_invert_tri_device(dr, dc, dv, pad_idx, *, nb, bs, lower,
                                base=32):
    """Assemble and invert the diagonal blocks on the tensors' device, in
    float32: only the diagonal COO triplets (torch tensors) travel.  A
    scatter builds the [nb, bs, bs] blocks (padding rows get a unit
    diagonal), batched ``torch.linalg.inv`` inverts their ``base x base``
    diagonal sub-blocks, block doubling builds the whole inverses, and one
    Newton step X <- X(2I - TX) squares the doubling's forward error toward
    the float32 storage floor (~kappa * u), which matters for
    ill-conditioned blocks.  Products at full float32 precision."""
    with _full_f32():
        t = dv.new_zeros((nb, bs, bs))
        t.view(-1).index_add_(0, (dr // bs) * bs * bs + (dr % bs) * bs
                              + dc % bs, dv)
        t.view(-1)[(pad_idx // bs) * bs * bs + (pad_idx % bs) * (bs + 1)] = 1.0
        if not lower:
            t = t.transpose(1, 2)
        p2 = 1 << (bs - 1).bit_length()
        if p2 != bs:  # pad to a power of two with identity tails
            tp = t.new_zeros((nb, p2, p2))
            tp[:, :bs, :bs] = t
            i = torch.arange(bs, p2, device=t.device)
            tp[:, i, i] = 1.0
            t = tp
        else:
            t = t.contiguous()
        base = min(base, p2)
        ns0 = p2 // base
        x = torch.linalg.inv(_diag_blocks(t, ns0, base).reshape(
            nb * ns0, base, base)).reshape(nb, ns0, base, base)
        h = base
        while h < p2:
            ns = p2 // (2 * h)
            cblk = _diag_blocks(t, ns, 2 * h)[:, :, h:, :h]
            xp = x.view(nb, ns, 2, h, h)
            ai, di = xp[:, :, 0], xp[:, :, 1]
            low = -torch.matmul(di, torch.matmul(cblk, ai))
            top = torch.cat([ai, torch.zeros_like(ai)], dim=-1)
            bot = torch.cat([low, di], dim=-1)
            x = torch.cat([top, bot], dim=-2)
            h *= 2
        x = x.reshape(nb, p2, p2)
        tx = torch.matmul(t, x)
        del t
        tx.neg_().diagonal(dim1=1, dim2=2).add_(2.0)      # 2I - T X
        x = torch.matmul(x, tx)
        del tx
    x = x[:, :bs, :bs]
    return (x.transpose(1, 2) if not lower else x).contiguous()


def _analyze(rows, cols, vals, n, bs, lower, dtype, device,
             device_invert=False):
    """Init-once analysis: the inverted diagonal blocks and, for each sweep
    direction, the off-diagonal COO grouped per block and padded to the
    largest group, as tensors on ``device``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    nb = -(-n // bs)
    npad = nb * bs
    rb, cb = rows // bs, cols // bs

    # --- dense diagonal blocks, inverted once ----------------------------
    diag_mask = rb == cb
    dr, dc, dv = rows[diag_mask], cols[diag_mask], vals[diag_mask]
    # singular check on the coalesced diagonal (duplicates sum, as the
    # scatter-add assembly sums every entry)
    dsum = np.zeros(n, np.float64)
    np.add.at(dsum, dr[dr == dc], dv[dr == dc])
    if (np.abs(dsum) < np.finfo(np.float64).tiny).any():
        raise np.linalg.LinAlgError("singular diagonal block")
    pad_idx = np.arange(n, npad)
    if device_invert:
        def on(a, dt):
            return torch.as_tensor(a, dtype=dt, device=device)

        dinv = _assemble_invert_tri_device(
            on(dr, torch.int64), on(dc, torch.int64),
            on(dv, torch.float32), on(pad_idx, torch.int64),
            nb=nb, bs=bs, lower=lower).to(dtype)
    else:
        # assemble and invert in float64 on the host, cast once at the end:
        # the stored inverse is then the correctly rounded one even for
        # ill-conditioned relationship-factor blocks
        dblocks = np.zeros((nb, bs, bs), np.float64)
        np.add.at(dblocks, (dr // bs, dr % bs, dc % bs), dv)
        dblocks[pad_idx // bs, pad_idx % bs, pad_idx % bs] = 1.0
        dinv = torch.as_tensor(np.ascontiguousarray(
            _invert_tri_batched(dblocks, lower), dtype=np_dtype),
            device=device)

    # --- off-diagonal entries, grouped per block for each sweep ----------
    off_mask = ~diag_mask
    orows, ocols, ovals = rows[off_mask], cols[off_mask], vals[off_mask]

    def group(block_of_entry, local_axis_idx, gather_idx):
        """Pad per-block entry lists to the largest count; padding entries
        gather x[0] with value 0 (harmless)."""
        order = np.argsort(block_of_entry, kind="stable")
        blk = block_of_entry[order]
        counts = np.bincount(blk, minlength=nb)
        mmax = max(int(counts.max()) if counts.size else 0, 1)
        loc = np.zeros((nb, mmax), np.int64)
        gat = np.zeros((nb, mmax), np.int64)
        val = np.zeros((nb, mmax), np_dtype)
        starts = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(len(blk)) - starts[blk]
        loc[blk, within] = local_axis_idx[order]
        gat[blk, within] = gather_idx[order]
        val[blk, within] = ovals[order]
        return tuple(torch.as_tensor(a, device=device)
                     for a in (loc, gat, val))

    # trans='n' sweep: block-row i consumes x at column indices
    fwd = group(orows // bs, orows % bs, ocols)
    # trans='t' sweep: block-col i consumes x at row indices
    bwd = group(ocols // bs, ocols % bs, orows)
    return nb, npad, dinv, fwd, bwd


def _block_sweep(b, dinv, loc, gat, val, *, bs, transpose_diag, reverse):
    """One substitution sweep over the blocks of b [npad, ncol]: step i
    gathers the already computed entries of x it depends on, subtracts
    their contribution from block i of b with one ``index_add_``, applies
    the inverted diagonal block and writes block i of x.  ``reverse`` runs
    the blocks last to first (upper-triangular systems: dependencies point
    at later blocks, which that order has already produced)."""
    nb = dinv.shape[0]
    x = torch.zeros_like(b)
    steps = zip(range(nb), b.view(nb, bs, -1).unbind(0), dinv.unbind(0),
                loc.unbind(0), gat.unbind(0), val.unbind(0))
    for i, b_i, dinv_i, loc_i, gat_i, val_i in (
            reversed(list(steps)) if reverse else steps):
        rhs = torch.index_add(b_i, 0, loc_i, val_i[:, None] * x[gat_i],
                              alpha=-1)
        torch.mm(dinv_i.T if transpose_diag else dinv_i, rhs,
                 out=x[i * bs:(i + 1) * bs])
    return x


class SparseTriangularSolver:
    """Init-once / solve-many triangular solver (the lifecycle of
    ``sparse2gpu`` / ``dcsrtrsv_solve_gpu`` / ``free_sparse_gpu``).

    COO triplets (1-based indices by default, as the Fortran callers supply
    them), matrix size, an optional row permutation in :meth:`solve_lltx`.
    ``bs`` is the substitution block size (any value >= 1 is correct; the
    inverted diagonal blocks take n * bs elements, 2 GB at n = 1e6, bs = 512
    in float32).  The analysis and the solves run on ``device`` (the card
    unless named).  ``dtype=None`` is float64 on the CPU and float32 on
    CUDA; a float32 solver inverts its diagonal blocks on the device unless
    ``device_analysis=False``, a float64 one on the host in float64.
    """

    def __init__(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n: int,
        index_base: int = 1,
        lower: bool = True,
        bs: int = 512,
        dtype=None,
        device_analysis: Optional[bool] = None,
        device=None,
    ):
        rows = np.asarray(rows, dtype=np.int64).ravel() - index_base
        cols = np.asarray(cols, dtype=np.int64).ravel() - index_base
        vals = np.asarray(vals, dtype=np.float64).ravel()
        if len(rows) == 0:
            raise ValueError("empty factor")
        if (rows.min() < 0 or rows.max() >= n or cols.min() < 0
                or cols.max() >= n):
            raise ValueError("COO indices out of range")
        outside = (cols > rows) if lower else (cols < rows)
        if (vals[outside] != 0).any():
            raise ValueError("matrix has entries outside the "
                             f"{'lower' if lower else 'upper'} triangle")
        diag_present = np.zeros(n, bool)
        diag_mask = rows == cols
        diag_present[rows[diag_mask][vals[diag_mask] != 0]] = True
        if not diag_present.all():
            raise ValueError("triangular factor has zero diagonal")

        self.device = _device(device)
        if dtype is None:
            dtype = (torch.float64 if self.device.type == "cpu"
                     else torch.float32)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        bs = max(1, min(bs, n))
        self.n = n
        self.lower = lower
        self.bs = bs
        self.nnz = int(len(vals))
        if device_analysis is None:
            device_analysis = dtype == torch.float32
        nb, npad, dinv, fwd, bwd = _analyze(
            rows, cols, vals, n, bs, lower, dtype, self.device,
            device_invert=device_analysis)
        self.nb, self.npad = nb, npad
        self._dinv, self._fwd, self._bwd = dinv, fwd, bwd
        # flat COO for the O(nnz) matvec / residual refinement
        self._rows = torch.as_tensor(rows, device=self.device)
        self._cols = torch.as_tensor(cols, device=self.device)
        self._vals = torch.as_tensor(vals, dtype=dtype, device=self.device)
        self._dtype = dtype
        # the original float64 triplets, kept on the host for the f64-grade
        # refinement residuals (residuals against a rounded matrix would
        # floor at the rounding), lazily assembled into CSR on first use
        self._host64 = (rows, cols, vals)
        self._csr_cache = {}

    def _tensor(self, b) -> torch.Tensor:
        return torch.as_tensor(b, dtype=self._dtype, device=self.device)

    # -- O(nnz) sparse matvec (for residuals / refinement) ----------------
    def matvec(self, x, trans: str = "n") -> torch.Tensor:
        """y = L x ('n') or L^T x ('t'), one ``index_add_`` over the COO."""
        x = self._tensor(x)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[:, None]
        r, c = (self._rows, self._cols) if trans == "n" else (self._cols,
                                                              self._rows)
        y = x.new_zeros((self.n, x.shape[1])).index_add_(
            0, r, self._vals[:, None] * x[c])
        return y[:, 0] if squeeze else y

    def _pad(self, b: torch.Tensor) -> torch.Tensor:
        if self.npad == self.n:
            return b.contiguous()
        out = b.new_zeros((self.npad, b.shape[1]))
        out[: self.n] = b
        return out

    def solve(self, b, trans: str = "n", refine: int = 0) -> torch.Tensor:
        """Solve L x = b ('n') or L^T x = b ('t').

        ``refine`` adds iterative-refinement sweeps (x += solve(b - L x)),
        at one extra substitution and one O(nnz) matvec each."""
        trans = trans.lower()
        if trans not in ("n", "t"):
            raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
        b = self._tensor(b)
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        x = self._solve_padded(self._pad(b), trans)[: self.n]
        for _ in range(refine):
            r = b - self.matvec(x, trans=trans)
            x = x + self._solve_padded(self._pad(r), trans)[: self.n]
        return x[:, 0] if squeeze else x

    def _solve_padded(self, bpad: torch.Tensor, trans: str) -> torch.Tensor:
        # trans='n' consumes entries by block-row (fwd grouping), trans='t'
        # by block-column (bwd grouping, the diagonal blocks transposed).
        # 'n' on lower / 't' on upper substitute first to last; the other
        # two combinations are upper-triangular systems: reverse.
        loc, gat, val = self._fwd if trans == "n" else self._bwd
        with _full_f32():
            return _block_sweep(bpad, self._dinv, loc, gat, val, bs=self.bs,
                                transpose_diag=trans == "t",
                                reverse=(not self.lower) if trans == "n"
                                else self.lower)

    def solve_lltx(self, b, perm: Optional[np.ndarray] = None,
                   index_base: int = 1, refine: int = 0) -> torch.Tensor:
        """Full normal-equation solve L L^T x = b with optional symmetric row
        permutation (the Fortran layer's ``c_solve_gpu_perm`` /
        ``_noperm``)."""
        b = self._tensor(b)
        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        if perm is not None:
            p = torch.as_tensor(np.asarray(perm, dtype=np.int64) - index_base,
                                device=self.device)
            b = b[p]
        y = self.solve(b, trans="n", refine=refine)
        x = self.solve(y, trans="t", refine=refine)
        if perm is not None:
            x = torch.zeros_like(x).index_copy_(0, p, x)
        return x[:, 0] if squeeze else x

    # -- f64-grade solves: mixed-precision iterative refinement -----------
    def _host_csr(self, trans: str):
        if trans not in self._csr_cache:
            from scipy import sparse

            # lazy per orientation: solve_f64(trans='n') never needs the
            # transpose (an extra full sort and copy, ~nnz*12 bytes)
            if trans == "n":
                r, c, v = self._host64
                self._csr_cache["n"] = sparse.csr_matrix(
                    (v, (r, c)), shape=(self.n, self.n))
            else:
                self._csr_cache["t"] = self._host_csr("n").T.tocsr()
        return self._csr_cache[trans]

    def _solve64(self, rhs: np.ndarray, fn) -> np.ndarray:
        x = fn(self._tensor(rhs)).cpu().numpy().astype(np.float64)
        return x[:, None] if x.ndim == 1 else x

    def solve_f64(self, b, trans: str = "n", tol: float = 1e-12,
                  max_sweeps: int = 20, inner_refine: int = 2):
        """Solve to float64 grade on a float32 solver: the blocked
        substitution (sharpened by ``inner_refine`` device refinement
        steps) is the preconditioner, and the residuals are computed
        exactly in host float64 against the original COO triplets (classic
        mixed-precision iterative refinement).  Returns (x float64,
        relative residual)."""
        if self._dtype == torch.float64:
            inner_refine = 0      # float64 solver: already exact grade
        b64 = np.asarray(b, np.float64)
        squeeze = b64.ndim == 1
        if squeeze:
            b64 = b64[:, None]
        a = self._host_csr(trans)

        def dev_solve(rhs):
            return self._solve64(rhs, lambda t: self.solve(
                t, trans=trans, refine=inner_refine))

        x = dev_solve(b64)
        bnorm = max(float(np.linalg.norm(b64)), np.finfo(np.float64).tiny)
        rel = float("inf")
        for _ in range(max_sweeps):
            r = b64 - a @ x
            rel = float(np.linalg.norm(r)) / bnorm
            if rel <= tol:
                break
            x = x + dev_solve(r)
        return (x[:, 0] if squeeze else x), rel

    def solve_lltx_f64(self, b, perm: Optional[np.ndarray] = None,
                       index_base: int = 1, tol: float = 1e-12,
                       max_sweeps: int = 20, inner_refine: int = 2):
        """L L^T x = b to float64 grade (see :meth:`solve_f64`): refinement
        on the composed operator, residuals r = b - L(L^T x) by two exact
        host float64 CSR matvecs a sweep.  ``inner_refine`` (default 2)
        device refinement steps sharpen each triangular substitution, so
        fewer host sweeps are needed.  Returns (x float64, rel residual)."""
        if self._dtype == torch.float64:
            inner_refine = 0      # float64 solver: already exact grade
        b64 = np.asarray(b, np.float64)
        squeeze = b64.ndim == 1
        if squeeze:
            b64 = b64[:, None]
        if perm is not None:
            p = np.asarray(perm, np.int64) - index_base
            b64 = b64[p]
        ln = self._host_csr("n")
        lt = self._host_csr("t")

        def dev_solve(rhs):
            return self._solve64(rhs, lambda t: self.solve(
                self.solve(t, trans="n", refine=inner_refine), trans="t",
                refine=inner_refine))

        x = dev_solve(b64)
        bnorm = max(float(np.linalg.norm(b64)), np.finfo(np.float64).tiny)
        rel = float("inf")
        for _ in range(max_sweeps):
            r = b64 - ln @ (lt @ x)
            rel = float(np.linalg.norm(r)) / bnorm
            if rel <= tol:
                break
            x = x + dev_solve(r)
        if perm is not None:
            xout = np.zeros_like(x)
            xout[p] = x
            x = xout
        return (x[:, 0] if squeeze else x), rel

    def free(self) -> None:
        """Release the device memory (``free_sparse_gpu``)."""
        for name in ("_dinv", "_fwd", "_bwd", "_rows", "_cols", "_vals",
                     "_host64"):
            setattr(self, name, None)
        self._csr_cache = {}


def simulate_pedigree_factor(
    n: int,
    avg_offdiag: int = 9,
    bandwidth: Optional[int] = None,
    seed: int = 0,
    index_base: int = 1,
):
    """Simulate a diagonally dominant sparse lower-triangular factor with the
    shape of a pedigree/mixed-model Cholesky factor (~``avg_offdiag``
    below-diagonal entries a row within ``bandwidth`` of the diagonal).
    Returns COO (rows, cols, vals) including the diagonal, ``index_base``-
    based."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.poisson(avg_offdiag, n), np.arange(n))
    rows = np.repeat(np.arange(n), counts)
    lo = rows - (bandwidth or n)
    cols = rng.integers(np.maximum(lo, 0), rows)  # in [max(r-bw,0), r)
    vals = rng.standard_normal(len(rows)) * 0.1
    # diagonal dominance: diag = 1 + sum |offdiag| per row
    diag = np.ones(n)
    np.add.at(diag, rows, np.abs(vals))
    r = np.concatenate([rows, np.arange(n)]) + index_base
    c = np.concatenate([cols, np.arange(n)]) + index_base
    v = np.concatenate([vals, diag])
    return r, c, v
