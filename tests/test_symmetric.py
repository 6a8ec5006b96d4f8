"""Symmetric CSX tests (ref CSX-Sym: csx_sym_spmv_tmpl.c + reduction map)."""

import numpy as np
import pytest

import sparsex_jax as spx
from sparsex_jax.ops.oracle import coo_spmv, max_rel_error
from sparsex_jax.symmetric import build_symmetric_csx
from tests import fixtures

TOL = 1e-6


def _check_sym(nthreads=1, xform="all", n=60, seed=3):
    spx.option_set("spx.rt.nr_threads", str(nthreads))
    spx.option_set("spx.preproc.xform", xform)
    nrows, ncols, rows, cols, vals = fixtures.symmetric_coo(n=n, seed=seed)
    mat = build_symmetric_csx(nrows, ncols, rows, cols, vals)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ncols)
    y0 = rng.standard_normal(nrows)
    got = np.asarray(mat.matvec(x, alpha=1.1, beta=0.4, y=y0))
    want = 1.1 * coo_spmv(nrows, rows, cols, vals, x) + 0.4 * y0
    assert max_rel_error(got, want) <= TOL
    return mat, rows, cols, vals


@pytest.mark.parametrize("xform", ["none", "h", "v", "all"])
def test_symmetric_spmv(xform):
    _check_sym(xform=xform)


@pytest.mark.parametrize("nthreads", [2, 4])
def test_symmetric_multishard(nthreads):
    mat, *_ = _check_sym(nthreads=nthreads)
    assert len(mat.shards) == nthreads


def test_symmetric_very_sparse():
    # fewer off-diagonals than rows (like symmetric-very-sparse fixture)
    _check_sym(n=40, seed=11, xform="all")


def test_symmetric_get_set():
    mat, rows, cols, vals = _check_sym()
    for r, c, v in zip(rows[:50], cols[:50], vals[:50]):
        assert mat.get_entry(int(r), int(c)) == pytest.approx(float(v))
    # symmetric set updates the mirrored entry too
    r, c = int(rows[0]), int(cols[0])
    mat.set_entry(r, c, 123.0)
    assert mat.get_entry(c, r) == pytest.approx(123.0)


@pytest.mark.parametrize("nthreads", [1, 3])
@pytest.mark.parametrize("xform", ["none", "all"])
def test_symmetric_full_expansion(nthreads, xform):
    """sym_full=on: the mirrored full-expansion executor must match the
    oracle exactly like the per-shard path (mirror_full_tables)."""
    spx.option_set("spx.jax.sym_full", "on")
    _check_sym(nthreads=nthreads, xform=xform)


def test_symmetric_full_expansion_banded():
    """DIA mirroring: banded symmetric (diag offsets + main diagonal)."""
    spx.option_set("spx.jax.sym_full", "on")
    spx.option_set("spx.preproc.xform", "all")
    n = 150
    rows, cols = [], []
    for b in (0, 1, 5):
        r = np.arange(b, n, dtype=np.int64)
        rows.append(r)
        cols.append(r - b)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    rng = np.random.default_rng(8)
    vals_l = rng.standard_normal(rows.size) + 1.0
    strict = rows > cols
    rf = np.concatenate([rows, cols[strict]])
    cf = np.concatenate([cols, rows[strict]])
    vf = np.concatenate([vals_l, vals_l[strict]])
    order = np.lexsort((cf, rf))
    rf, cf, vf = rf[order], cf[order], vf[order]
    mat = build_symmetric_csx(n, n, rf, cf, vf)
    assert mat._full_active()
    x = rng.standard_normal(n)
    got = np.asarray(mat.matvec(x))
    want = coo_spmv(n, rf, cf, vf, x)
    assert max_rel_error(got, want) <= TOL
    # the mirror must preserve DIA structure (no delta-ization of bands)
    ft = mat._full_executor().tables
    assert ft.dias and ft.dias[0].offsets.tolist() == [-5, -1, 0, 1, 5]


def test_symmetric_full_expansion_structure():
    """Each lower-triangle pattern class maps onto a first-class mirrored
    pattern (run<->run, block<->block) — no structure is lost."""
    from sparsex_jax.preprocess.encodings import EncType
    from sparsex_jax.symmetric import mirror_full_tables

    spx.option_set("spx.preproc.xform", "all")
    n = 64
    entries = set()
    # horizontal run in the lower triangle: row 40, cols 2..9
    entries |= {(40, c) for c in range(2, 10)}
    # 2x2 block at rows 50..51, cols 4..5
    entries |= {(r, c) for r in (50, 51) for c in (4, 5)}
    # anti-diagonal run: (30,10),(31,9),(32,8),(33,7),(34,6)
    entries |= {(30 + i, 10 - i) for i in range(5)}
    # singles
    entries |= {(20, 3), (60, 33)}
    rows = np.array(sorted(entries))[:, 0]
    cols = np.array(sorted(entries))[:, 1]
    vals_l = np.arange(1.0, rows.size + 1.0)
    rf = np.concatenate([rows, cols])
    cf = np.concatenate([cols, rows])
    vf = np.concatenate([vals_l, vals_l])
    mat = build_symmetric_csx(n, n, rf, cf, vf)
    ft = mirror_full_tables(mat.shards, mat.dvalues, n, n)
    encs = {t.enc for t in ft.runs}
    # horizontal mirror -> vertical, anti-diag mirror -> anti-diag
    if EncType.HORIZONTAL in encs:
        assert EncType.VERTICAL in encs
    kinds = {(t.br, t.bc) for t in ft.blocks}
    for br, bc in list(kinds):
        assert (bc, br) in kinds
    # numeric identity of the mirrored tables
    from sparsex_jax.ops.exec import CsxExecutor
    x = np.random.default_rng(0).standard_normal(n)
    got = np.asarray(CsxExecutor(ft)(x))
    want = coo_spmv(n, rf, cf, vf, x)
    assert max_rel_error(got, want) <= TOL


def test_symmetric_full_spmm():
    spx.option_set("spx.jax.sym_full", "on")
    nrows, ncols, rows, cols, vals = fixtures.symmetric_coo(n=70, seed=6)
    mat = build_symmetric_csx(nrows, ncols, rows, cols, vals)
    rng = np.random.default_rng(6)
    X = rng.standard_normal((ncols, 5))
    got = np.asarray(mat.matmat(X, alpha=1.5))
    want = np.stack([1.5 * coo_spmv(nrows, rows, cols, vals, X[:, j])
                     for j in range(5)], axis=1)
    assert max_rel_error(got, want) <= TOL


def test_symmetric_full_set_entry_invalidates():
    spx.option_set("spx.jax.sym_full", "on")
    mat, rows, cols, vals = _check_sym()
    r, c = int(rows[0]), int(cols[0])
    mat.set_entry(r, c, 77.0)
    x = np.random.default_rng(1).standard_normal(mat.ncols)
    vals2 = vals.copy()
    m = ((rows == r) & (cols == c)) | ((rows == c) & (cols == r))
    vals2[m] = 77.0
    got = np.asarray(mat.matvec(x))
    want = coo_spmv(mat.nrows, rows, cols, vals2, x)
    assert max_rel_error(got, want) <= TOL


def test_unsymmetric_input_rejected():
    # expected-failure parity: symmetric flag on unsymmetric input must fail
    # gracefully (ref test-sparsex.sh.in:199-222)
    nrows, ncols, rows, cols, vals = fixtures.random_coo(40, 40, seed=5)
    with pytest.raises(spx.SparsexError):
        build_symmetric_csx(nrows, ncols, rows, cols, vals)


def test_symmetric_tocoo_roundtrip():
    mat, rows, cols, vals = _check_sym()
    rr, cc, vv = mat.tocoo()
    assert rr.tolist() == rows.tolist()
    assert cc.tolist() == cols.tolist()
    np.testing.assert_allclose(vv, vals, rtol=1e-12)
