"""Pedigree algebra for single-step genomic evaluations.

Torch twin of ``miraculix_tpu.pedigree``: exact inbreeding coefficients
(Meuwissen & Luo 1992) through the port's native codec, Henderson's rules
for the sparse A-inverse (accounting for inbreeding), the dense tabular A
for oracles, a pedigree reader and simulator, all numpy on the host and
equal to the reference's bit for bit; and :class:`SparseCOO`, a COO
operator on a torch device whose matvec is one gather and one
``index_add_``.

Pedigree convention: animals are 1..n, topologically ordered (every
parent id is smaller than its offspring id); 0 = unknown parent.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from .geno import _device
from .io import native


def check_pedigree(sire: np.ndarray, dam: np.ndarray) -> int:
    """Validate the 1..n / parents-first convention; returns n."""
    sire = np.asarray(sire)
    dam = np.asarray(dam)
    if sire.shape != dam.shape or sire.ndim != 1:
        raise ValueError("sire/dam must be equal-length 1-D arrays")
    n = len(sire)
    ids = np.arange(1, n + 1)
    for name, p in (("sire", sire), ("dam", dam)):
        if p.min(initial=0) < 0 or p.max(initial=0) > n:
            raise ValueError(f"{name} ids must be in [0, n]")
        if np.any(p >= ids):
            bad = int(np.argmax(p >= ids)) + 1
            raise ValueError(
                f"animal {bad}: {name} {int(p[bad - 1])} is not older — "
                "pedigree must be topologically ordered (parents first)")
    return n


def inbreeding(sire: np.ndarray, dam: np.ndarray) -> np.ndarray:
    """Inbreeding coefficients F[0..n-1] by Meuwissen & Luo (1992):
    a_ii = sum_j L_ij^2 * D_j over the ancestors j of i, tracing each
    animal's ancestor paths once (no n x n table).

    Runs the native codec's ``mx_inbreeding`` (the same algorithm with
    full-sib memoization; counted in ``native.CALLS["inbreeding"]``) and
    :func:`_inbreeding_py`, its oracle, only where the library is
    unavailable.  Cost is O(sum of ancestor-set sizes): a deep, fully
    interconnected pedigree degrades toward O(n^2); at that scale pass
    ``f=np.zeros(n)`` to :func:`a_inverse` (the classical rules)."""
    check_pedigree(sire, dam)
    f = native.inbreeding(sire, dam)
    return _inbreeding_py(sire, dam) if f is None else f


def _inbreeding_py(sire: np.ndarray, dam: np.ndarray) -> np.ndarray:
    """Pure-Python Meuwissen & Luo: the oracle of the native path."""
    n = check_pedigree(sire, dam)
    s = np.concatenate([[0], np.asarray(sire, np.int64)])  # 1-based access
    d = np.concatenate([[0], np.asarray(dam, np.int64)])
    f = np.zeros(n + 1)
    f[0] = -1.0  # unknown-parent convention: D = 0.5 - 0.25*(F_s + F_d)
    dvar = np.zeros(n + 1)
    for i in range(1, n + 1):
        dvar[i] = 0.5 - 0.25 * (f[s[i]] + f[d[i]])
        if s[i] == 0 or d[i] == 0:
            continue  # one/both parents unknown -> unrelated -> F = 0
        # trace ancestors youngest-first; parents < child makes a max-heap
        # emit each ancestor after all its path weights have accumulated
        lw = np.zeros(i + 1)
        lw[i] = 1.0
        heap = [-i]
        inheap = np.zeros(i + 1, bool)
        inheap[i] = True
        aii = 0.0
        while heap:
            j = -heapq.heappop(heap)
            inheap[j] = False
            w = lw[j]
            lw[j] = 0.0
            aii += w * w * dvar[j]
            for p in (s[j], d[j]):
                if p > 0:
                    lw[p] += 0.5 * w
                    if not inheap[p]:
                        heapq.heappush(heap, -p)
                        inheap[p] = True
        f[i] = aii - 1.0
    return f[1:]


def a_matrix(sire: np.ndarray, dam: np.ndarray) -> np.ndarray:
    """Dense numerator relationship matrix A [n, n] by the tabular method
    (O(n^2) memory: oracles and small pedigrees; the scalable object is
    :func:`a_inverse`, which never forms A)."""
    n = check_pedigree(sire, dam)
    a = np.zeros((n + 1, n + 1))
    s = np.concatenate([[0], np.asarray(sire, np.int64)])
    d = np.concatenate([[0], np.asarray(dam, np.int64)])
    for i in range(1, n + 1):
        a[i, 1:i] = a[1:i, i] = 0.5 * (a[1:i, s[i]] + a[1:i, d[i]])
        a[i, i] = 1.0 + 0.5 * a[s[i], d[i]]
    return a[1:, 1:]


def a_inverse(
    sire: np.ndarray,
    dam: np.ndarray,
    f: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse A^-1 by Henderson's rules with inbreeding: for each animal i
    with Mendelian-sampling variance m_i = 0.5 - 0.25*(F_s + F_d) (the
    unknown-parent convention F_unknown = -1 folds in the 0.75 / 1.0
    cases), alpha = 1/m_i contributes alpha * delta delta' with
    delta = e_i - (e_s + e_d)/2.  Returns coalesced 0-based symmetric COO
    (rows, cols, vals) with BOTH triangles present.  O(n) entries: <= 9
    per animal.

    ``f`` overrides the inbreeding coefficients (pass ``np.zeros(n)`` for
    the classical no-inbreeding approximation)."""
    n = check_pedigree(sire, dam)
    if f is None:
        f = inbreeding(sire, dam)
    fpad = np.concatenate([[-1.0], np.asarray(f, np.float64)])
    s = np.concatenate([[0], np.asarray(sire, np.int64)])
    d = np.concatenate([[0], np.asarray(dam, np.int64)])
    ids = np.arange(1, n + 1)
    alpha = 1.0 / (0.5 - 0.25 * (fpad[s[1:]] + fpad[d[1:]]))

    rows, cols, vals = [], [], []

    def emit(r, c, v, mask):
        rows.append(r[mask])
        cols.append(c[mask])
        vals.append(v[mask])

    both = np.ones(n, bool)
    emit(ids, ids, alpha, both)                         # (i, i) += alpha
    for p in (s[1:], d[1:]):
        known = p > 0
        emit(ids, p, -0.5 * alpha, known)               # (i, p) and (p, i)
        emit(p, ids, -0.5 * alpha, known)
        emit(p, p, 0.25 * alpha, known)                 # (p, p)
    ks, kd = s[1:] > 0, d[1:] > 0
    cross = ks & kd
    emit(s[1:], d[1:], 0.25 * alpha, cross)             # (s, d) and (d, s)
    emit(d[1:], s[1:], 0.25 * alpha, cross)

    r = np.concatenate(rows) - 1
    c = np.concatenate(cols) - 1
    v = np.concatenate(vals)
    # coalesce duplicate coordinates
    key = r * n + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    first = np.concatenate([[True], key[1:] != key[:-1]])
    out_idx = np.cumsum(first) - 1
    vv = np.zeros(int(out_idx[-1]) + 1)
    np.add.at(vv, out_idx, v)
    return r[first], c[first], vv


def simulate_pedigree(
    n: int,
    n_founders: int = 50,
    seed: int = 0,
    unknown_rate: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random topologically-ordered pedigree: the first ``n_founders``
    animals have unknown parents; each later animal draws its parents
    from the preceding generation window (overlapping generations), with
    ``unknown_rate`` of parent slots unknown."""
    rng = np.random.default_rng(seed)
    sire = np.zeros(n, np.int64)
    dam = np.zeros(n, np.int64)
    for i in range(n_founders, n):
        lo = max(0, i - 3 * n_founders)
        pair = rng.integers(lo, i, size=2) + 1
        if rng.random() >= unknown_rate:
            sire[i] = pair[0]
        if rng.random() >= unknown_rate:
            dam[i] = pair[1]
    return sire, dam


def read_pedigree(path: str):
    """Read a whitespace-separated pedigree file (animal, sire, dam per
    line; '0', 'NA', '.', '-' or empty = unknown parent; '#' comments) with
    arbitrary string labels, and recode to the 1..n parents-first
    convention by a stable topological sort (file order preserved where
    the pedigree allows).  Parents that never appear as animals are added
    as founders.  Returns ``(sire, dam, labels)`` where ``labels[i]`` is
    the original label of recoded animal i+1.  Raises on cycles and on
    animals listed twice with conflicting parents."""
    missing = {"0", "NA", "na", ".", "-", ""}
    parents = {}
    order = []
    with open(path) as fh:
        for lineno, ln in enumerate(fh, 1):
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            parts = ln.split()
            if len(parts) < 3:
                raise ValueError(f"{path}:{lineno}: need animal sire dam")
            a, s, d = parts[0], parts[1], parts[2]
            s = None if s in missing else s
            d = None if d in missing else d
            if a in parents and parents[a] != (s, d):
                raise ValueError(f"{path}:{lineno}: animal {a!r} listed "
                                 "twice with different parents")
            if a not in parents:
                order.append(a)
            parents[a] = (s, d)
    for a in list(parents):
        for p in parents[a]:
            if p is not None and p not in parents:
                parents[p] = (None, None)
                order.append(p)
    # Kahn's algorithm, stable in file order
    n = len(order)
    children = {a: [] for a in order}
    indeg = {a: 0 for a in order}
    for a, (s, d) in parents.items():
        for p in (s, d):
            if p is not None:
                children[p].append(a)
                indeg[a] += 1
    ready = deque(a for a in order if indeg[a] == 0)
    labels = []
    while ready:
        a = ready.popleft()
        labels.append(a)
        for c in children[a]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(labels) != n:
        cyc = [a for a in order if indeg[a] > 0]
        raise ValueError(f"pedigree has a cycle involving {cyc[:5]}")
    code = {a: i + 1 for i, a in enumerate(labels)}
    sire = np.array([code[parents[a][0]] if parents[a][0] else 0
                     for a in labels], np.int64)
    dam = np.array([code[parents[a][1]] if parents[a][1] else 0
                    for a in labels], np.int64)
    return sire, dam, labels


class SparseCOO:
    """Sparse matrix in coalesced COO on a torch device (the card unless
    ``device`` names another), entries sorted by row.  ``matvec`` is one
    gather and one ``index_add_``; symmetric matrices store both triangles
    so 'n' and 't' are the same operation.  ``index_add_`` on CUDA sums in
    no fixed order: card results agree with the CPU's to rounding, not bit
    for bit."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int],
                 dtype=torch.float32, device=None):
        self.shape = (int(shape[0]), int(shape[1]))
        self.device = _device(device)
        order = np.argsort(np.asarray(rows), kind="stable")
        self.rows = torch.as_tensor(np.asarray(rows, np.int64)[order],
                                    device=self.device)
        self.cols = torch.as_tensor(np.asarray(cols, np.int64)[order],
                                    device=self.device)
        self.vals = torch.as_tensor(np.asarray(vals)[order], dtype=dtype,
                                    device=self.device)
        self.nnz = int(self.vals.shape[0])

    def matvec(self, v, trans: str = "n") -> torch.Tensor:
        """A @ v (or A.T @ v): v [k] or [k, m] -> [r] or [r, m]."""
        v = torch.as_tensor(v, dtype=self.vals.dtype, device=self.device)
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        r, c = (self.rows, self.cols) if trans == "n" else (self.cols,
                                                            self.rows)
        nout = self.shape[0] if trans == "n" else self.shape[1]
        out = vv.new_zeros((nout, vv.shape[1])).index_add_(
            0, r, self.vals[:, None] * vv[c])
        return out[:, 0] if squeeze else out

    def diag(self) -> torch.Tensor:
        if self.shape[0] != self.shape[1]:
            raise ValueError("diag of a non-square matrix")
        on = torch.where(self.rows == self.cols, self.vals,
                         torch.zeros_like(self.vals))
        return self.vals.new_zeros(self.shape[0]).index_add_(0, self.rows, on)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        np.add.at(out, (self.rows.cpu().numpy(), self.cols.cpu().numpy()),
                  self.vals.cpu().numpy().astype(np.float64))
        return out
