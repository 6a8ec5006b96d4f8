"""End-to-end numeric verification against the CSR oracle.

Mirrors the reference test driver matrix (``test/scripts/test-sparsex.sh.in``:
deltas-only, horizontal, vertical, all, all+sampling, multithreaded,
symmetric variants, expected failures) at the reference tolerance of 1e-6
(``src/internals/Vector.cpp:51-56``).
"""

import numpy as np
import pytest

import sparsex_jax as spx
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.ops.oracle import coo_spmv, max_rel_error
from tests import fixtures

TOL = 1e-6

MATRICES = {
    "pattern10": fixtures.pattern10(),
    "random": fixtures.random_coo(),
    "banded": fixtures.banded_coo(),
    "blocky": fixtures.blocky_coo(),
}

XFORMS = [
    "none",       # deltas only
    "h",
    "v",
    "d",
    "ad",
    "br2",
    "bc2",
    "br,bc",
    "all",
]


def _check(nrows, ncols, rows, cols, vals, *, seed=0, alpha=1.3, beta=0.7):
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ncols)
    y0 = rng.standard_normal(nrows)
    got = np.asarray(mat.matvec(x, alpha=alpha, beta=beta, y=y0))
    want = alpha * coo_spmv(nrows, rows, cols, vals, x) + beta * y0
    assert max_rel_error(got, want) <= TOL
    # encoded content must round-trip exactly
    rr, cc, vv = mat.tocoo()
    assert rr.tolist() == rows.tolist()
    assert cc.tolist() == cols.tolist()
    np.testing.assert_allclose(vv, vals, rtol=1e-12)
    return mat


@pytest.mark.parametrize("mname", list(MATRICES))
@pytest.mark.parametrize("xform", XFORMS)
def test_matvec_vs_oracle(mname, xform):
    spx.option_set("spx.preproc.xform", xform)
    spx.option_set("spx.preproc.sampling", "none")
    _check(*MATRICES[mname])


@pytest.mark.parametrize("mname", ["random", "banded"])
def test_matvec_with_sampling(mname):
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.preproc.sampling", "portion")
    spx.option_set("spx.preproc.sampling.portion", "0.3")
    spx.option_set("spx.preproc.sampling.nr_samples", "4")
    _check(*MATRICES[mname])


@pytest.mark.parametrize("nthreads", [2, 3])
def test_multishard(nthreads):
    spx.option_set("spx.rt.nr_threads", str(nthreads))
    spx.option_set("spx.preproc.xform", "all")
    mat = _check(*MATRICES["banded"])
    assert len(mat.shards) == nthreads


def test_explicit_delta_sequence():
    spx.option_set("spx.preproc.xform", "h{1,2},v{1}")
    _check(*MATRICES["pattern10"])


def test_ratio_heuristic():
    spx.option_set("spx.preproc.heuristic", "ratio")
    spx.option_set("spx.preproc.xform", "all")
    _check(*MATRICES["banded"])


def test_pattern10_finds_patterns():
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.preproc.sampling", "none")
    spx.option_set("spx.matrix.min_coverage", "0.05")
    mat = _check(*MATRICES["pattern10"])
    tables = mat.shards[0]
    assert tables.pattern_nnz() > 0


def test_get_set_entry():
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.matrix.min_coverage", "0.05")
    nrows, ncols, rows, cols, vals = MATRICES["pattern10"]
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    for r, c, v in zip(rows, cols, vals):
        assert mat.get_entry(int(r), int(c)) == pytest.approx(float(v))
    # set every entry to 2x and re-check via matvec
    for r, c, v in zip(rows, cols, vals):
        mat.set_entry(int(r), int(c), 2.0 * float(v))
    x = np.ones(ncols)
    got = np.asarray(mat.mult(x))
    want = 2.0 * coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(got, want) <= TOL
    with pytest.raises(spx.SparsexError):
        mat.get_entry(0, 6)  # structural zero


def test_save_restore_roundtrip(tmp_path):
    spx.option_set("spx.preproc.xform", "all")
    nrows, ncols, rows, cols, vals = MATRICES["banded"]
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    path = str(tmp_path / "mat.npz")
    from sparsex_jax.persist import restore_csx, save_csx
    save_csx(mat, path)
    mat2, _ = restore_csx(path)
    x = np.random.default_rng(1).standard_normal(ncols)
    np.testing.assert_allclose(np.asarray(mat.mult(x)),
                               np.asarray(mat2.mult(x)), rtol=1e-12)


def test_rcm_reorder():
    from sparsex_jax.reorder import bandwidth, reorder_rcm
    nrows, ncols, rows, cols, vals = fixtures.symmetric_coo(n=80, seed=7)
    r2, c2, v2, perm = reorder_rcm(nrows, ncols, rows, cols, vals)
    assert bandwidth(r2, c2) <= bandwidth(rows, cols)
    # permuted SpMV equals original with reordered vectors
    x = np.random.default_rng(2).standard_normal(ncols)
    y_orig = coo_spmv(nrows, rows, cols, vals, x)
    y_perm = coo_spmv(nrows, r2, c2, v2, x[np.argsort(perm)])
    assert max_rel_error(y_perm[perm], y_orig) <= TOL
