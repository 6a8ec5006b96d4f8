"""Native C++ kernels vs their NumPy fallbacks.

The native library (``sparsex_jax/native/kernels.cpp``) re-implements the
host-side hot paths the reference keeps in compiled C/C++ (MMF parsing,
DRLE segment scan, CSR baseline SpMV, coordinate sort); these tests pin the
native results to the pure-NumPy reference implementations.
"""

import numpy as np
import pytest

from sparsex_jax import native
from sparsex_jax.preprocess.mining import _segment_runs_np

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _random_sorted_coords(m, nrows, ncols, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nrows, size=m)
    cols = rng.integers(0, ncols, size=m)
    key = rows * ncols + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    return rows[order].astype(np.int64), cols[order].astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_runs_matches_numpy(seed):
    rows, cols = _random_sorted_coords(5000, 100, 60, seed)
    nj, nf, nd, na = native.segment_runs(rows, cols)
    pj, pf, pd, pa = _segment_runs_np(rows, cols)
    np.testing.assert_array_equal(nj, pj)
    np.testing.assert_array_equal(nf, pf)
    np.testing.assert_array_equal(nd, pd)
    np.testing.assert_array_equal(na, pa)


def test_segment_runs_dense_rows():
    # long runs + adjacency chains
    rows = np.repeat(np.arange(10, dtype=np.int64), 20)
    cols = np.concatenate([
        np.concatenate([np.arange(7), 10 + 2 * np.arange(7),
                        40 + 5 * np.arange(6)])
        for _ in range(10)]).astype(np.int64)
    nj, nf, nd, na = native.segment_runs(rows, cols)
    pj, pf, pd, pa = _segment_runs_np(rows, cols)
    np.testing.assert_array_equal(nj, pj)
    np.testing.assert_array_equal(nf, pf)
    np.testing.assert_array_equal(nd, pd)
    np.testing.assert_array_equal(na, pa)


@pytest.mark.parametrize("m,nrows,ncols", [(10, 5, 5), (100000, 3000, 70000)])
def test_lexsort_rc_matches_numpy(m, nrows, ncols):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, nrows, size=m).astype(np.int64)
    cols = rng.integers(0, ncols, size=m).astype(np.int64)
    order = native.lexsort_rc(rows, cols)
    # permutations may differ on ties (duplicate coords); compare sorted pairs
    np.testing.assert_array_equal(
        np.stack([rows[order], cols[order]]),
        np.stack([rows[np.lexsort((cols, rows))],
                  cols[np.lexsort((cols, rows))]]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csr_spmv_matches_numpy(dtype):
    rng = np.random.default_rng(3)
    nrows, ncols, m = 500, 400, 6000
    rows, cols = _random_sorted_coords(m, nrows, ncols, 3)
    vals = rng.standard_normal(rows.size).astype(dtype)
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    x = rng.standard_normal(ncols).astype(dtype)
    y0 = rng.standard_normal(nrows).astype(dtype)
    got = native.csr_spmv(nrows, rowptr, cols, vals, x,
                          alpha=1.5, beta=0.25, y=y0)
    dense = np.zeros((nrows, ncols), dtype=np.float64)
    dense[rows, cols] = vals
    want = 1.5 * dense @ x.astype(np.float64) + 0.25 * y0.astype(np.float64)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=tol,
                               atol=tol)


def test_parse_mmf_body():
    text = "1 1 0.5\n2 3 -1.25e2\n% comment\n4 5 7\n"
    rows, cols, vals, n = native.parse_mmf_body(text, 3)
    assert n == 3
    np.testing.assert_array_equal(rows, [1, 2, 4])
    np.testing.assert_array_equal(cols, [1, 3, 5])
    np.testing.assert_allclose(vals, [0.5, -125.0, 7.0])


def test_parse_mmf_body_counts_extra_entries():
    text = "1 1 0.5\n2 3 1.0\n3 3 1.0\n"
    *_, n = native.parse_mmf_body(text, 2)
    assert n == 3  # caller rejects: more entries than declared


def test_parse_mmf_body_malformed():
    *_, n = native.parse_mmf_body("1 1 0.5\n2 x 1.0\n", 2)
    assert n < 0


def test_mark_covered():
    start = np.array([2, 8], dtype=np.int64)
    count = np.array([3, 4], dtype=np.int64)
    got = native.mark_covered(start, count, 15)
    want = np.zeros(15, dtype=bool)
    want[2:5] = True
    want[8:12] = True
    np.testing.assert_array_equal(got, want)


def test_mmf_loader_uses_native(tmp_path):
    """End-to-end: the loader must produce identical results either way."""
    import sparsex_jax.io.mmf as mmf_mod
    text = ("%%MatrixMarket matrix coordinate real general\n"
            "3 4 5\n1 1 1.0\n1 3 2.0\n2 2 3.0\n3 1 4.0\n3 4 5.0\n")
    a = mmf_mod.load_mmf(text)
    import os
    os.environ["SPARSEX_NO_NATIVE"] = "1"
    try:
        # force fallback by reloading module state
        import sparsex_jax.native as nat
        saved = nat._lib, nat._tried
        nat._lib, nat._tried = None, False
        b = mmf_mod.load_mmf(text)
        nat._lib, nat._tried = saved
    finally:
        del os.environ["SPARSEX_NO_NATIVE"]
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)


@pytest.mark.parametrize("seed,minl,maxl,allowed", [
    (0, 4, 255, None), (1, 4, 16, None), (2, 3, 255, [1, 2]),
    (3, 2, 8, None), (4, 5, 255, [1]),
])
def test_select_units_matches_numpy(seed, minl, maxl, allowed, monkeypatch):
    """Native run->unit selection vs the vectorized NumPy path."""
    from sparsex_jax.preprocess import mining

    rng = np.random.default_rng(seed)
    n = 3000
    rows = np.sort(rng.integers(0, 60, n)).astype(np.int64)
    cols = rng.integers(0, 300, n).astype(np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.concatenate([[True], np.diff(rows * 300 + cols) != 0])
    rows, cols = rows[keep], cols[keep]

    res_nat = mining.mine_runs(rows, cols, min_limit=minl, max_limit=maxl,
                               allowed_deltas=allowed, presorted=True)

    monkeypatch.setattr(native, "select_units", lambda *a, **k: None)
    res_np = mining.mine_runs(rows, cols, min_limit=minl, max_limit=maxl,
                              allowed_deltas=allowed, presorted=True)

    np.testing.assert_array_equal(res_nat.covered, res_np.covered)
    key = lambda r: r.delta
    for a, b in zip(sorted(res_nat.runs, key=key),
                    sorted(res_np.runs, key=key)):
        assert a.delta == b.delta
        np.testing.assert_array_equal(a.heads, b.heads)
        np.testing.assert_array_equal(a.sizes, b.sizes)
    assert len(res_nat.runs) == len(res_np.runs)
