"""Dense-diagonal (DIA) folding and execution.

DIA tables are the device execution class for diagonal/anti-diagonal
runs (elementwise windows instead of gather/scatter, see
``preprocess/tables.py`` ``DiagTable``); these tests pin folding decisions,
numerical results vs the dense oracle, get/set/tocoo behavior, persistence
and the sharded path.
"""

import numpy as np
import pytest

import sparsex_jax as spx
from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.ops.oracle import max_rel_error


def banded(n=96, bands=(0, 1, -3), anti=False, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b in bands:
        if anti:
            # anti-diagonal band: r + c = n - 1 + b
            r = np.arange(max(0, b), min(n, n + b), dtype=np.int64)
            c = (n - 1 + b) - r
            keep = (c >= 0) & (c < n)
            rows.append(r[keep])
            cols.append(c[keep])
        else:
            r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
            rows.append(r)
            cols.append(r + b)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    key = rows * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size) + 2.0
    return n, rows, cols, vals


def dense_of(n, rows, cols, vals):
    d = np.zeros((n, n))
    d[rows, cols] = vals
    return d


@pytest.mark.parametrize("anti", [False, True])
def test_dia_folding_and_result(anti):
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "ad" if anti else "d")
    cfg.set("spx.preproc.sampling", "none")
    n, rows, cols, vals = banded(anti=anti)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    t = mat.shards[0]
    assert t.dias, "expected diagonal runs to fold into a DiagTable"
    assert all(d.anti == anti for d in t.dias)
    assert sum(d.nnz for d in t.dias) > 0.9 * rows.size
    x = np.random.default_rng(1).standard_normal(n)
    y = np.asarray(mat.matvec(x))
    assert max_rel_error(y, dense_of(n, rows, cols, vals) @ x) < 1e-10


def test_dia_fill_threshold():
    """Sparse diagonals (below dia_min_fill): the device heuristic keeps them
    on the (faster) delta path entirely; the reference-parity heuristics
    still encode them as RunTables; lowering the threshold folds to DIA."""
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "d")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.matrix.min_coverage", "0.0")
    cfg.set("spx.jax.dia_min_fill", "0.5")
    n = 400
    # one short diagonal run (fill 10/400 < 0.5)
    rows = np.arange(10, 20, dtype=np.int64)
    cols = rows + 3
    vals = np.ones(10)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    t = mat.shards[0]
    assert not t.dias and not t.runs and t.delta.nnz == 10

    cfg.set("spx.preproc.heuristic", "ratio")  # reference-style selection
    mat_r = CsxMatrix.from_coo(n, n, rows, cols, vals)
    tr = mat_r.shards[0]
    assert not tr.dias
    assert tr.runs and sum(r.nnz for r in tr.runs) == 10

    # lower the threshold: same input folds to DIA (device heuristic again)
    cfg.set("spx.preproc.heuristic", "device")
    cfg.set("spx.jax.dia_min_fill", "0.01")
    mat2 = CsxMatrix.from_coo(n, n, rows, cols, vals)
    assert mat2.shards[0].dias
    x = np.random.default_rng(2).standard_normal(n)
    for m in (mat, mat_r, mat2):
        y = np.asarray(m.matvec(x))
        assert max_rel_error(y, dense_of(n, rows, cols, vals) @ x) < 1e-12


def test_dia_strided_delta_runs_fold():
    """delta>1 diagonal runs still live on one offset and fold."""
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "d{2}")
    cfg.set("spx.preproc.sampling", "none")
    n = 64
    rows = np.arange(0, 40, 2, dtype=np.int64)
    cols = rows + 5
    vals = np.arange(1.0, rows.size + 1)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    t = mat.shards[0]
    assert t.dias and t.dias[0].offsets.tolist() == [5]
    x = np.random.default_rng(3).standard_normal(n)
    y = np.asarray(mat.matvec(x))
    assert max_rel_error(y, dense_of(n, rows, cols, vals) @ x) < 1e-12


def test_dia_get_set_tocoo():
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "d")
    cfg.set("spx.preproc.sampling", "none")
    n, rows, cols, vals = banded()
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    assert mat.shards[0].dias
    k = 17
    r, c = int(rows[k]), int(cols[k])
    assert mat.get_entry(r, c) == pytest.approx(float(vals[k]))
    mat.set_entry(r, c, -123.0)
    assert mat.get_entry(r, c) == -123.0
    x = np.random.default_rng(4).standard_normal(n)
    vals2 = vals.copy()
    vals2[k] = -123.0
    y = np.asarray(mat.matvec(x))
    assert max_rel_error(y, dense_of(n, rows, cols, vals2) @ x) < 1e-10
    rr, cc, vv = mat.tocoo()
    d2 = dense_of(n, rr, cc, vv)
    np.testing.assert_allclose(d2, dense_of(n, rows, cols, vals2))


def test_dia_persist_roundtrip(tmp_path):
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    n, rows, cols, vals = banded()
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    assert mat.shards[0].dias
    from sparsex_jax.persist import restore_csx, save_csx
    path = str(tmp_path / "dia.npz")
    save_csx(mat, path)
    mat2, _ = restore_csx(path)
    x = np.random.default_rng(5).standard_normal(n)
    np.testing.assert_allclose(np.asarray(mat2.matvec(x)),
                               np.asarray(mat.matvec(x)), rtol=1e-12)
    # structure preserved (mask roundtrips)
    assert mat2.get_entry(int(rows[3]), int(cols[3])) == pytest.approx(
        float(vals[3]))


def test_symmetric_persist_roundtrip(tmp_path):
    """Symmetric save/restore keeps dvalues and the SymCsxMatrix type."""
    from tests.fixtures import symmetric_coo
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    n, _, rows, cols, vals = symmetric_coo(n=40)
    from sparsex_jax.symmetric import SymCsxMatrix, build_symmetric_csx
    mat = build_symmetric_csx(n, n, rows, cols, vals)
    from sparsex_jax.persist import restore_csx, save_csx
    path = str(tmp_path / "sym.npz")
    save_csx(mat, path)
    mat2, _ = restore_csx(path)
    assert isinstance(mat2, SymCsxMatrix)
    x = np.random.default_rng(6).standard_normal(n)
    np.testing.assert_allclose(np.asarray(mat2.matvec(x)),
                               np.asarray(mat.matvec(x)), rtol=1e-12)


def test_symmetric_banded_with_dias():
    """Symmetric matrix whose lower triangle folds to DIA: both the direct
    and the transposed (dense-window) contributions must be right."""
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "2")
    n = 80
    rng = np.random.default_rng(7)
    # symmetric banded: diagonal + bands +-2, +-5
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [rng.standard_normal(n)]
    for b in (2, 5):
        r = np.arange(b, n)
        v = rng.standard_normal(r.size)
        rows += [r, r - b]
        cols += [r - b, r]
        vals += [v, v]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]
    from sparsex_jax.symmetric import build_symmetric_csx
    mat = build_symmetric_csx(n, n, rows, cols, vals)
    assert any(t.dias for t in mat.shards)
    x = rng.standard_normal(n)
    y = np.asarray(mat.matvec(x))
    assert max_rel_error(y, dense_of(n, rows, cols, vals) @ x) < 1e-10


def test_sharded_with_dias():
    import jax
    from jax.sharding import Mesh
    from sparsex_jax.parallel.shard import ShardedCsx
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "4")
    n, rows, cols, vals = banded(n=128, bands=(0, 1, -1, 7))
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    assert any(t.dias for t in mat.shards)
    mesh = Mesh(np.array(jax.devices()[:4]), ("shards",))
    sh = ShardedCsx(mat, mesh=mesh)
    x = np.random.default_rng(8).standard_normal(n)
    y = np.asarray(sh.matvec(x))
    assert max_rel_error(y, dense_of(n, rows, cols, vals) @ x) < 1e-10


DIA_SETS = [((0,), 1000, 1000),
            ((0, 1, -1, 8, -13), 700, 1100),
            ((-700, -3, 0, 5, 300, 900), 1000, 1000)]


@pytest.mark.parametrize("anti", [False, True], ids=["diag", "anti"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("offsets,nrows,ncols", DIA_SETS,
                         ids=["one", "band", "wide"])
def test_dia_kernel_vs_oracle(offsets, nrows, ncols, dtype, anti):
    """The static-offset DIA kernel against a loop oracle: diagonals
    ``y[r] += dv[k, r] x[r + o]``, anti-diagonals (s = ncols - 1 + o)
    ``y[r] += dv[k, r] x[s - r]``; out-of-matrix lanes hold zeros."""
    import jax.numpy as jnp

    from sparsex_jax.ops.kernels import dia_contrib

    rng = np.random.default_rng(len(offsets) + nrows)
    offs = tuple(ncols - 1 + o for o in offsets) if anti else offsets
    r = np.arange(nrows)
    dv = rng.standard_normal((len(offs), nrows)).astype(dtype)
    cols = [(o - r) if anti else (r + o) for o in offs]
    for k, c in enumerate(cols):
        dv[k, (c < 0) | (c >= ncols)] = 0
    x = rng.standard_normal(ncols).astype(dtype)
    y, _ = dia_contrib(((anti, offs, len(offs)),), [{"vals": jnp.asarray(dv)}],
                       jnp.asarray(x), nrows, 0,
                       jnp.zeros(nrows, dtype=dtype), ncols=ncols)
    want = np.zeros(nrows)
    for k, c in enumerate(cols):
        ok = (c >= 0) & (c < ncols)
        want[ok] += dv[k, ok].astype(np.float64) * x[c[ok]]
    tol = 1e-5 if dtype == "float32" else 1e-13
    np.testing.assert_allclose(np.asarray(y), want, rtol=tol, atol=tol)
