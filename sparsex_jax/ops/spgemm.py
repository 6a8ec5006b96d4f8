"""SpGEMM: sparse x sparse -> sparse (C = A @ B).

The reference has no SpGEMM (its API stops at SpMV,
``include/sparsex/matvec.h``); the BASELINE north star asks for one built
on the same kernels.  Design: **symbolic once on the host, numeric
wherever it pays**.

- ``spgemm``: the full product.  The flop expansion (one entry per
  A(i,k)*B(k,j) pair) is vectorized NumPy over the sorted COO forms; the
  reduction groups by output coordinate.  The result is returned as a
  tuned ``CsxMatrix`` — so downstream SpMV/SpMM immediately runs on the
  device execution classes, which is where repeated work lives.
- ``spgemm_panel``: a device-resident variant for moderate widths — B is
  densified in column panels on device and C's panels come from the SpMM
  path; useful when C is nearly dense or B is a tall
  thin operator.

Numerically-cancelled entries (exact 0 after summation) are dropped along
with structural zeros — documented deviation from structure-preserving
SpGEMMs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.errors import ErrorCode, seterror


def _coo_sorted(mat: CsxMatrix):
    r, c, v = mat.tocoo()
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def spgemm_coo(ar, ac, av, br, bc, bv, nrows_a: int, ncols_a: int,
               ncols_b: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C = A @ B on sorted COO triplets; returns sorted COO of C.

    Gustavson expansion, vectorized: every (A(i,k), B(k,j)) flop becomes
    one product entry, then entries are merged by output coordinate.
    O(flops) memory; flops = sum over A entries of B-row lengths.
    """
    # CSR view of B: row starts/lengths
    b_rowptr = np.searchsorted(br, np.arange(ncols_a + 1))
    starts = b_rowptr[ac]
    lens = (b_rowptr[ac + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=av.dtype)
    out_row = np.repeat(ar, lens)
    a_val = np.repeat(av, lens)
    base = np.repeat(starts, lens)
    run0 = np.repeat(np.cumsum(lens) - lens, lens)
    bidx = base + (np.arange(total) - run0)
    out_col = bc[bidx]
    prod = a_val * bv[bidx]

    key = out_row * np.int64(ncols_b) + out_col
    uniq, inv = np.unique(key, return_inverse=True)
    vals = np.bincount(inv, weights=prod, minlength=uniq.size)
    rows = (uniq // ncols_b).astype(np.int64)
    cols = (uniq % ncols_b).astype(np.int64)
    nz = vals != 0.0
    return rows[nz], cols[nz], vals[nz].astype(av.dtype)


def spgemm(A: CsxMatrix, B: CsxMatrix, *,
           config: Optional[Config] = None) -> CsxMatrix:
    """C = A @ B, returned as a tuned CsxMatrix."""
    if A.ncols != B.nrows:
        seterror(ErrorCode.SPX_ERR_VEC_DIM,
                 f"spgemm: A is {A.nrows}x{A.ncols}, B is "
                 f"{B.nrows}x{B.ncols}")
    ar, ac, av = _coo_sorted(A)
    br, bc, bv = _coo_sorted(B)
    rows, cols, vals = spgemm_coo(ar, ac, av, br, bc, bv,
                                  A.nrows, A.ncols, B.ncols)
    if rows.size == 0:
        # empty product: a single explicit zero keeps the pipeline happy
        rows = np.zeros(1, dtype=np.int64)
        cols = np.zeros(1, dtype=np.int64)
        vals = np.zeros(1, dtype=av.dtype)
    return CsxMatrix.from_coo(A.nrows, B.ncols, rows, cols, vals,
                              config=config)


def spgemm_panel(A: CsxMatrix, B: CsxMatrix, panel: int = 512):
    """Device-resident paneled product: yields (j0, C_panel) dense panels.

    B's columns are densified panel-by-panel on device (one scatter per
    panel over B's COO), and each C panel is one SpMM.  Callers keep or sparsify panels as they stream.
    """
    import jax.numpy as jnp

    if A.ncols != B.nrows:
        seterror(ErrorCode.SPX_ERR_VEC_DIM,
                 f"spgemm: A is {A.nrows}x{A.ncols}, B is "
                 f"{B.nrows}x{B.ncols}")
    br, bc, bv = _coo_sorted(B)
    corder = np.lexsort((br, bc))
    br, bc, bv = br[corder], bc[corder], bv[corder]
    bounds = np.searchsorted(bc, np.arange(0, B.ncols + panel, panel))
    dtype = A.shards[0].delta.vals.dtype if A.shards[0].delta else bv.dtype
    for pi, j0 in enumerate(range(0, B.ncols, panel)):
        lo, hi = bounds[pi], bounds[pi + 1]
        p = min(panel, B.ncols - j0)
        Bp = jnp.zeros((B.nrows, p), dtype=dtype).at[
            (jnp.asarray(br[lo:hi]), jnp.asarray(bc[lo:hi] - j0))].set(
            jnp.asarray(bv[lo:hi], dtype=dtype))
        yield j0, A.matmat(Bp)
