"""Public API.

1:1 parity with the reference C API (``include/sparsex/matvec.h:39-535``,
``src/api/matvec.c``), in Python naming (drop the ``spx_`` prefix):

=====================================  =====================================
reference                               sparsex_jax
=====================================  =====================================
``spx_init / spx_finalize``             ``init() / finalize()``
``spx_input_load_csr``                  ``input_load_csr``
``spx_input_load_mmf``                  ``input_load_mmf``
``spx_input_destroy``                   ``input_destroy``
``spx_mat_tune``                        ``mat_tune``
``spx_mat_get_entry / set_entry``       ``mat_get_entry / mat_set_entry``
``spx_mat_save / restore``              ``mat_save / mat_restore``
``spx_mat_get_partition``               ``mat_get_partition``
``spx_matvec_mult``                     ``matvec_mult``
``spx_matvec_kernel``                   ``matvec_kernel``
``spx_matvec_kernel_csr``               ``matvec_kernel_csr``
``spx_partition_csr``                   ``partition_csr``
``spx_option_set``                      ``option_set`` (config module)
``spx_vec_*``                           ``sparsex_jax.ops.vector``
=====================================  =====================================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.errors import ErrorCode, seterror, setwarning
from sparsex_jax.io.csr import CSR
from sparsex_jax.io.mmf import MMF, load_mmf
from sparsex_jax.logger import log_info
from sparsex_jax.parallel.partition import RowPartition

# Flags mirroring the reference's option macros.
OP_REORDER = "reorder"  # SPX_MAT_REORDER
INDEX_ZERO_BASED = 0    # SPX_INDEX_ZERO_BASED
INDEX_ONE_BASED = 1     # SPX_INDEX_ONE_BASED


def init() -> None:
    """``spx_init`` parity (ref ``src/api/common.c:85-93``): enable the
    default console error/warning reporting.  Idempotent."""
    Config.instance()


def finalize() -> None:
    """``spx_finalize`` parity: release process-wide state."""
    # Executors and tables are garbage-collected; nothing persistent to free.
    pass


@dataclass
class Input:
    """``spx_input_t`` parity: a loaded, not-yet-tuned matrix."""

    kind: str  # "csr" or "mmf"
    mmf: Optional[MMF] = None
    csr: Optional[CSR] = None

    @property
    def nrows(self) -> int:
        src = self.mmf if self.kind == "mmf" else self.csr
        return src.nrows

    @property
    def ncols(self) -> int:
        src = self.mmf if self.kind == "mmf" else self.csr
        return src.ncols

    def tocoo(self):
        src = self.mmf if self.kind == "mmf" else self.csr
        return src.tocoo()


@dataclass
class Matrix:
    """``spx_matrix_t`` parity: the tuned handle."""

    csx: CsxMatrix
    permutation: Optional[np.ndarray] = None

    @property
    def nrows(self) -> int:
        return self.csx.nrows

    @property
    def ncols(self) -> int:
        return self.csx.ncols

    @property
    def nnz(self) -> int:
        return self.csx.nnz


@dataclass
class Partition:
    """``spx_partition_t`` parity: row ranges per shard."""

    parts: RowPartition
    nrows: int


def input_load_csr(rowptr, colind, values, nrows: int, ncols: int,
                   indexing: int = INDEX_ZERO_BASED) -> Input:
    """``spx_input_load_csr`` parity (ref ``src/api/matvec.c:163``)."""
    csr = CSR(nrows, ncols, rowptr, colind, values,
              zero_based=(indexing == INDEX_ZERO_BASED))
    return Input(kind="csr", csr=csr)


def input_load_mmf(filename: str) -> Input:
    """``spx_input_load_mmf`` parity (ref ``src/api/matvec.c:217``)."""
    cfg = Config.instance()
    mmf = load_mmf(filename, keep_lower=cfg.symmetric,
                   index_dtype=cfg.index_dtype, value_dtype=cfg.value_dtype)
    if cfg.symmetric and not mmf.symmetric:
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 "spx.matrix.symmetric set but input is not symmetric")
    return Input(kind="mmf", mmf=mmf)


def input_destroy(input_: Input) -> None:
    """``spx_input_destroy`` parity (no-op; GC owns the arrays)."""
    input_.mmf = None
    input_.csr = None


def mat_tune(input_: Input, *flags: str) -> Matrix:
    """``spx_mat_tune`` parity (ref ``src/api/matvec.c:259``): run the CSX
    preprocessing pipeline.  Pass ``OP_REORDER`` to RCM-reorder first."""
    cfg = Config.instance()
    if cfg.value_dtype == np.float64:
        import jax
        if not jax.config.jax_enable_x64:
            setwarning(ErrorCode.SPX_WARN_TUNING_OPT,
                       "spx.jax.value_dtype=float64 but jax_enable_x64 is "
                       "off: the device computes in float32")
    rows, cols, vals = input_.tocoo()
    nrows, ncols = input_.nrows, input_.ncols

    permutation = None
    if OP_REORDER in flags:
        from sparsex_jax.reorder import reorder_rcm
        rows, cols, vals, permutation = reorder_rcm(
            nrows, ncols, rows, cols, vals)

    symmetric = cfg.symmetric
    if symmetric:
        from sparsex_jax.symmetric import build_symmetric_csx
        lower_only = input_.kind == "mmf" and input_.mmf.stored_lower_only
        csx = build_symmetric_csx(nrows, ncols, rows, cols, vals,
                                  already_lower=lower_only, config=cfg)
    else:
        csx = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals, config=cfg,
                                 permutation=permutation)
    log_info("tuned matrix: %dx%d nnz=%d csx_size=%dB",
             nrows, ncols, csx.nnz, csx.csx_size())
    return Matrix(csx=csx, permutation=permutation)


def mat_get_entry(mat: Matrix, row: int, col: int) -> float:
    return mat.csx.get_entry(row, col)


def mat_set_entry(mat: Matrix, row: int, col: int, value: float) -> None:
    mat.csx.set_entry(row, col, value)


def mat_save(mat: Matrix, filename: str) -> None:
    from sparsex_jax.persist import save_csx
    save_csx(mat.csx, filename, permutation=mat.permutation)


def mat_restore(filename: str) -> Matrix:
    from sparsex_jax.persist import restore_csx
    csx, permutation = restore_csx(filename)
    return Matrix(csx=csx, permutation=permutation)


def mat_get_partition(mat: Matrix) -> Partition:
    """``spx_mat_get_partition`` parity (ref ``src/api/matvec.c:485``)."""
    return Partition(parts=mat.csx.partition, nrows=mat.nrows)


def mat_destroy(mat: Matrix) -> None:
    mat.csx = None


def partition_csr(rowptr, nrows: int, nparts: int) -> Partition:
    """``spx_partition_csr`` parity (ref ``src/api/matvec.c:689``)."""
    from sparsex_jax.parallel.partition import split_rows_by_nnz
    counts = np.diff(np.asarray(rowptr, dtype=np.int64))
    return Partition(parts=split_rows_by_nnz(counts, nparts), nrows=nrows)


def matvec_mult(alpha: float, mat: Matrix, x):
    """``spx_matvec_mult`` parity: y = alpha*A*x (y zeroed first,
    ref ``src/api/matvec.c:551``)."""
    return mat.csx.mult(x, alpha=alpha)


def matvec_kernel(alpha: float, mat: Matrix, x, beta: float, y):
    """``spx_matvec_kernel`` parity: y = alpha*A*x + beta*y
    (ref ``src/api/matvec.c:586``)."""
    return mat.csx.matvec(x, alpha=alpha, beta=beta, y=y)


def matmat_mult(alpha: float, mat: Matrix, X):
    """SpMM: Y = alpha*A*X with X of shape (ncols, k).

    Multi-RHS extension of ``spx_matvec_mult`` (the reference API stops at
    single vectors, ``include/sparsex/matvec.h:39-535``; the k axis
    amortizes every index load over k values)."""
    return mat.csx.matmat(X, alpha=alpha, beta=0.0)


def matmat_kernel(alpha: float, mat: Matrix, X, beta: float, Y):
    """SpMM: Y = alpha*A*X + beta*Y (multi-RHS ``spx_matvec_kernel``)."""
    return mat.csx.matmat(X, alpha=alpha, beta=beta, Y=Y)


def spgemm(a: Matrix, b: Matrix) -> Matrix:
    """C = A @ B as a new tuned matrix (see ``sparsex_jax/spgemm.py``)."""
    from sparsex_jax.ops.spgemm import spgemm as _spgemm
    return Matrix(csx=_spgemm(a.csx, b.csx))


from collections import OrderedDict as _OrderedDict

_csr_cache = _OrderedDict()
_CSR_CACHE_MAX = 16


def matvec_kernel_csr(rowptr, colind, values, nrows, ncols,
                      alpha: float, x, beta: float, y):
    """``spx_matvec_kernel_csr`` parity (ref ``src/api/matvec.c:622``):
    tunes lazily on first call for the given CSR buffers, then delegates.

    The cache keys on buffer identity like the reference (whose C callers
    keep the buffers alive); to make that safe in Python — where ``id()``
    values are recycled after GC — the cache entry holds strong references
    to the keyed buffers, so a cached id can never alias a freed matrix.
    LRU-bounded at ``_CSR_CACHE_MAX`` tuned matrices so a long-running
    process churning through matrices does not leak them; call
    :func:`matvec_kernel_csr_invalidate` to drop entries eagerly (the
    role of the reference's destroy path).
    """
    key = (id(rowptr), id(colind), id(values), nrows, ncols)
    entry = _csr_cache.get(key)
    if entry is None:
        inp = input_load_csr(rowptr, colind, values, nrows, ncols)
        entry = (mat_tune(inp), rowptr, colind, values)
        _csr_cache[key] = entry
        while len(_csr_cache) > _CSR_CACHE_MAX:
            _csr_cache.popitem(last=False)
    else:
        _csr_cache.move_to_end(key)
    return matvec_kernel(alpha, entry[0], x, beta, y)


def matvec_kernel_csr_invalidate(rowptr=None, colind=None, values=None):
    """Drop cached tuned matrices for the given CSR buffers (all three
    None = clear the whole cache)."""
    if rowptr is None and colind is None and values is None:
        _csr_cache.clear()
        return
    ids = (id(rowptr), id(colind), id(values))
    for key in [k for k in _csr_cache
                if (k[0], k[1], k[2]) == ids]:
        del _csr_cache[key]
