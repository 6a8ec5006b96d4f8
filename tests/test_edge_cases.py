"""Edge cases: empty matrices, empty rows (the reference's row-jump
machinery, ``CsxManager::UpdateNewRow``), tiny shapes, rectangular."""

import numpy as np
import pytest

import sparsex_jax as spx
from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.ops.oracle import max_rel_error


def test_empty_matrix():
    mat = CsxMatrix.from_coo(5, 7, np.zeros(0, np.int64),
                             np.zeros(0, np.int64), np.zeros(0))
    y = np.asarray(mat.matvec(np.ones(7)))
    np.testing.assert_array_equal(y, np.zeros(5))
    assert mat.csx_size() >= 0


def test_single_element():
    mat = CsxMatrix.from_coo(4, 4, np.array([2]), np.array([1]),
                             np.array([3.5]))
    y = np.asarray(mat.matvec(np.array([1.0, 2.0, 3.0, 4.0])))
    np.testing.assert_allclose(y, [0, 0, 7.0, 0])
    assert mat.get_entry(2, 1) == 3.5


def test_many_empty_rows():
    """Rows 100..899 empty (the reference encodes row jumps for these)."""
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    n = 1000
    rows = np.concatenate([np.arange(100), np.arange(900, 1000)])
    cols = (rows * 7 + 3) % n
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = np.arange(1.0, rows.size + 1)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    x = np.random.default_rng(0).standard_normal(n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    assert max_rel_error(np.asarray(mat.matvec(x)), dense @ x) < 1e-10


def test_rectangular():
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    nr, nc = 30, 90
    rng = np.random.default_rng(1)
    rows = rng.integers(0, nr, 200)
    cols = rng.integers(0, nc, 200)
    _, u = np.unique(rows * nc + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size)
    mat = CsxMatrix.from_coo(nr, nc, rows, cols, vals)
    x = rng.standard_normal(nc)
    dense = np.zeros((nr, nc))
    dense[rows, cols] = vals
    assert max_rel_error(np.asarray(mat.matvec(x)), dense @ x) < 1e-10
    # wide rectangular + diagonal runs beyond the square part
    rows2 = np.arange(nr, dtype=np.int64)
    cols2 = rows2 + 50
    mat2 = CsxMatrix.from_coo(nr, nc, rows2, cols2, np.ones(nr))
    y2 = np.asarray(mat2.matvec(np.arange(nc, dtype=np.float64)))
    np.testing.assert_allclose(y2, np.arange(50, 50 + nr, dtype=np.float64))


def test_empty_rows_multishard():
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "4")
    n = 64
    rows = np.array([0, 63], dtype=np.int64)
    cols = np.array([63, 0], dtype=np.int64)
    vals = np.array([1.0, 2.0])
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    x = np.arange(n, dtype=np.float64)
    y = np.asarray(mat.matvec(x))
    want = np.zeros(n)
    want[0], want[63] = 63.0, 0.0
    np.testing.assert_allclose(y, want)


def test_duplicate_get_entry_not_found():
    mat = CsxMatrix.from_coo(4, 4, np.array([0]), np.array([0]),
                             np.array([1.0]))
    with pytest.raises(spx.SparsexError):
        mat.get_entry(1, 1)
    with pytest.raises(spx.SparsexError):
        mat.get_entry(9, 0)


def test_index_width_narrowing():
    """Partitions whose coordinates fit int16 store int16 indices
    (VERDICT r2 #7; ref GetDeltaSize CsxManager.hpp:635-682)."""
    import numpy as np

    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.ops.oracle import coo_spmv, max_rel_error

    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    rng = np.random.default_rng(0)
    n = 2000
    rows = rng.integers(0, n, 4000)
    cols = rng.integers(0, n, 4000)
    k = np.unique(rows * n + cols)
    rows, cols = k // n, k % n
    vals = rng.standard_normal(rows.size)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    t = mat.shards[0]
    if t.delta is not None and t.delta.nnz:
        assert t.delta.cols.dtype == np.int16
    for rt in t.runs:
        assert rt.cols.dtype == np.int16
    x = rng.standard_normal(n)
    got = np.asarray(mat.mult(x))
    want = coo_spmv(n, rows, cols, vals, x)
    assert max_rel_error(got, want) <= 1e-6
