"""SpMM (multi-RHS SpMV) tests — every kernel class against the dense
oracle, plus block-CG.

BASELINE.json configs[4] calls for CSX SpMV + SpMM; the reference API
stops at single vectors (``include/sparsex/matvec.h:39-535``) — SpMM is
the extension where the k axis amortizes the gathers.
"""

import numpy as np
import pytest

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from tests import fixtures


def _mk(n, seed, kinds=("dia", "h", "v", "block", "rand")):
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    if "dia" in kinds:
        for b in (0, 2, -3):
            r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
            rows_l.append(r)
            cols_l.append(r + b)
    if "h" in kinds:
        hr = rng.integers(0, n, 60)
        hc = rng.integers(0, n - 8, 60)
        rows_l.append(np.repeat(hr, 8))
        cols_l.append((hc[:, None] + np.arange(8)[None]).ravel())
    if "v" in kinds:
        vr = rng.integers(0, n - 6, 40)
        vc = rng.integers(0, n, 40)
        rows_l.append((vr[:, None] + np.arange(6)[None]).ravel())
        cols_l.append(np.repeat(vc, 6))
    if "block" in kinds:
        br0 = rng.integers(0, (n - 4) // 4, 40) * 4
        bc0 = rng.integers(0, (n - 2) // 2, 40) * 2
        ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
        rows_l.append((br0[:, None, None] + ii[None]).ravel())
        cols_l.append((bc0[:, None, None] + jj[None]).ravel())
    if "rand" in kinds:
        rows_l.append(rng.integers(0, n, 400))
        cols_l.append(rng.integers(0, n, 400))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    key = rows * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(rows.size)
    return rows, cols, vals


def _dense(n, rows, cols, vals):
    A = np.zeros((n, n))
    A[rows, cols] = vals
    return A


@pytest.mark.parametrize("xform,k", [
    ("all", 1), ("all", 4), ("all", 16), ("none", 8),
    ("h,v", 8), ("br4", 8), ("d,ad", 8),
])
def test_spmm_oracle(xform, k):
    cfg = Config.reset()
    cfg.set("spx.preproc.xform", xform)
    n = 512
    rows, cols, vals = _mk(n, seed=1)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, k))
    Y = np.asarray(mat.matmat(X))
    ref = _dense(n, rows, cols, vals) @ X
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-10


def test_spmm_alpha_beta():
    cfg = Config.reset()
    cfg.set("spx.preproc.xform", "all")
    n = 256
    rows, cols, vals = _mk(n, seed=3)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((n, 5))
    Y0 = rng.standard_normal((n, 5))
    Y = np.asarray(mat.matmat(X, alpha=2.5, beta=-0.5, Y=Y0))
    ref = 2.5 * (_dense(n, rows, cols, vals) @ X) - 0.5 * Y0
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-10


def test_spmm_api_and_dim_errors():
    import sparsex_jax as spx
    from sparsex_jax.errors import SparsexError

    cfg = Config.reset()
    n = 128
    rows, cols, vals = _mk(n, seed=5, kinds=("dia", "rand"))
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    handle = spx.Matrix(csx=mat)
    X = np.random.default_rng(0).standard_normal((n, 3))
    Y = np.asarray(spx.matmat_mult(1.0, handle, X))
    ref = _dense(n, rows, cols, vals) @ X
    assert np.allclose(Y, ref, rtol=1e-10, atol=1e-12)
    Y2 = np.asarray(spx.matmat_kernel(1.0, handle, X, 1.0, Y))
    assert np.allclose(Y2, 2 * ref, rtol=1e-10, atol=1e-12)
    with pytest.raises(SparsexError):
        mat.matmat(X[: n // 2])
    with pytest.raises(SparsexError):
        mat.matmat(X, Y=np.zeros((n, 7)))


def test_spmm_symmetric():
    from sparsex_jax.symmetric import build_symmetric_csx

    cfg = Config.reset()
    cfg.set("spx.rt.nr_threads", "2")
    n = 300
    rng = np.random.default_rng(6)
    m = 1200
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    lo = np.minimum(r, c), np.maximum(r, c)
    rows, cols = lo[1], lo[0]  # lower triangle (row >= col)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    key = rows * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(rows.size)
    mat = build_symmetric_csx(n, n, rows, cols, vals, already_lower=True)
    A = np.zeros((n, n))
    A[rows, cols] = vals
    A = A + np.tril(A, -1).T
    X = rng.standard_normal((n, 6))
    Y = np.asarray(mat.matmat(X))
    ref = A @ X
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-10


def test_block_cg():
    from sparsex_jax.solvers import block_cg, cg

    cfg = Config.reset()
    cfg.set("spx.preproc.xform", "all")
    n = 400
    rng = np.random.default_rng(7)
    # s.p.d.: tridiagonal diagonally dominant
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    B = rng.standard_normal((n, 4))
    X, iters, res = block_cg(lambda P: mat.matmat(P), B, tol=1e-10)
    A = _dense(n, rows, cols, vals)
    assert np.abs(A @ np.asarray(X) - B).max() < 1e-6
    # matches per-column plain CG
    x0, _, _ = cg(lambda v: mat.matvec(v), B[:, 0], tol=1e-10)
    assert np.allclose(np.asarray(X)[:, 0], np.asarray(x0), atol=1e-6)


def test_spgemm_oracle():
    from sparsex_jax.ops.spgemm import spgemm

    cfg = Config.reset()
    cfg.set("spx.preproc.xform", "all")
    n = 300
    ra, ca, va = _mk(n, seed=8, kinds=("dia", "h", "rand"))
    rb, cb, vb = _mk(n, seed=9, kinds=("dia", "v", "rand"))
    A = CsxMatrix.from_coo(n, n, ra, ca, va)
    B = CsxMatrix.from_coo(n, n, rb, cb, vb)
    C = spgemm(A, B)
    ref = _dense(n, ra, ca, va) @ _dense(n, rb, cb, vb)
    x = np.random.default_rng(10).standard_normal(n)
    y = np.asarray(C.matvec(x))
    err = np.abs(y - ref @ x).max() / np.abs(ref @ x).max()
    assert err < 1e-10
    # structure: every stored entry matches the dense product
    rc, cc, vc = C.tocoo()
    assert np.allclose(ref[rc, cc], vc, rtol=1e-12, atol=1e-12)


def test_spgemm_rectangular_and_api():
    import sparsex_jax as spx
    from sparsex_jax.errors import SparsexError
    from sparsex_jax.ops.spgemm import spgemm

    cfg = Config.reset()
    rng = np.random.default_rng(11)
    # A (100 x 200), B (200 x 80)
    ra = rng.integers(0, 100, 600); ca = rng.integers(0, 200, 600)
    rb = rng.integers(0, 200, 500); cb = rng.integers(0, 80, 500)
    def mk(r, c, nr, nc):
        key = r * nc + c
        _, u = np.unique(key, return_index=True)
        r, c = r[u], c[u]
        o = np.lexsort((c, r))
        return r[o], c[o], rng.standard_normal(r.size)
    ra, ca, va = mk(ra, ca, 100, 200)
    rb, cb, vb = mk(rb, cb, 200, 80)
    A = CsxMatrix.from_coo(100, 200, ra, ca, va)
    B = CsxMatrix.from_coo(200, 80, rb, cb, vb)
    C = spx.spgemm(spx.Matrix(csx=A), spx.Matrix(csx=B))
    assert (C.nrows, C.ncols) == (100, 80)
    Ad = np.zeros((100, 200)); Ad[ra, ca] = va
    Bd = np.zeros((200, 80)); Bd[rb, cb] = vb
    x = rng.standard_normal(80)
    y = np.asarray(spx.matvec_mult(1.0, C, x))
    ref = (Ad @ Bd) @ x
    assert np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30) < 1e-10
    with pytest.raises(SparsexError):
        spgemm(B, B)  # 80 != 200


def test_spgemm_panel_stream():
    from sparsex_jax.ops.spgemm import spgemm_panel

    cfg = Config.reset()
    cfg.set("spx.jax.value_dtype", "float32")
    n = 256
    ra, ca, va = _mk(n, seed=12, kinds=("dia", "rand"))
    rb, cb, vb = _mk(n, seed=13, kinds=("dia", "rand"))
    A = CsxMatrix.from_coo(n, n, ra, ca, va.astype(np.float32))
    B = CsxMatrix.from_coo(n, n, rb, cb, vb.astype(np.float32))
    ref = (_dense(n, ra, ca, va.astype(np.float32))
           @ _dense(n, rb, cb, vb.astype(np.float32)))
    C = np.zeros((n, n), np.float32)
    for j0, panel in spgemm_panel(A, B, panel=96):
        C[:, j0: j0 + panel.shape[1]] = np.asarray(panel)
    assert np.abs(C - ref).max() / np.abs(ref).max() < 1e-5


def test_spmm_sharded():
    """Sharded SpMM (one sharded SpMV per column under lax.map)."""
    import jax
    from jax.sharding import Mesh
    from sparsex_jax.parallel.shard import ShardedCsx

    cfg = Config.reset()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.rt.nr_threads", "4")
    n = 1024
    rows, cols, vals = _mk(n, seed=20, kinds=("dia", "rand"))
    vals = vals.astype(np.float32)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    mesh = Mesh(np.array(jax.devices()[:4]), ("shards",))
    sh = ShardedCsx(mat, mesh=mesh)
    X = np.random.default_rng(21).standard_normal((n, 5)).astype(np.float32)
    Y = np.asarray(sh.matmat(X, alpha=2.0))
    ref = 2.0 * (_dense(n, rows, cols, vals) @ X)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-4


def test_spmm_dia_slab_hybrid():
    """SpMM with alpha/beta on DIA tables + singles: the DIA windows run
    as (rows, k) slabs beside the k-wide delta gather."""
    import jax.numpy as jnp
    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix

    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.jax.dia_min_fill", "0.5")

    rng = np.random.default_rng(5)
    n = 1 << 13
    rows_l, cols_l = [], []
    for o in (0, 3, -70):
        r = np.arange(max(0, -o), min(n, n - o))
        rows_l.append(r)
        cols_l.append(r + o)
    rows_l.append(rng.integers(0, n, n))
    cols_l.append(rng.integers(0, n, n))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    key = rows.astype(np.int64) * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    o_ = np.lexsort((cols, rows))
    rows, cols = rows[o_], cols[o_]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    ex = mat.executors[0]
    assert mat.shards[0].dias, "diagonals not folded to DIA"
    k = 5
    X = rng.standard_normal((n, k)).astype(np.float32)
    Y0 = rng.standard_normal((n, k)).astype(np.float32)
    Y = np.asarray(ex(jnp.asarray(X), alpha=1.7, beta=0.5,
                      y=jnp.asarray(Y0)))
    ref = 0.5 * Y0.astype(np.float64)
    np.add.at(ref, rows, 1.7 * vals[:, None].astype(np.float64)
              * X.astype(np.float64)[cols])
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-5


def _dot_generals(jaxpr):
    """Every dot_general equation of a jaxpr, nested ones included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    out += _dot_generals(getattr(inner, "jaxpr", inner))
    return out


@pytest.mark.parametrize("symmetric,dtype,n_dots", [
    (False, "float32", 1), (False, "float64", 1), (True, "float32", 2)])
def test_block_products_use_highest_precision(symmetric, dtype, n_dots):
    """SpMM block products (and the symmetric transposed one) ask for
    HIGHEST precision, so a float32 product never drops to TF32."""
    import jax
    import jax.numpy as jnp

    from sparsex_jax.ops.kernels import (local_contrib, static_meta,
                                         tables_to_arrays)

    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "br4")
    cfg.set("spx.preproc.sampling", "none")
    n, _, rows, cols, vals = fixtures.blocky_coo(n=96, bs=4, nblocks=40)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    tables = mat.shards[0]
    assert tables.blocks, "no block table mined"
    meta, arrs = static_meta(tables), tables_to_arrays(tables)
    X = jnp.zeros((n, 3), dtype=dtype)
    jaxpr = jax.make_jaxpr(lambda X: local_contrib(
        meta, arrs, X, nrows_part=n, ncols=n, symmetric=symmetric,
        nrows_glob=n))(X)
    dots = _dot_generals(jaxpr.jaxpr)
    assert len(dots) == n_dots
    for eqn in dots:
        assert "HIGHEST" in str(eqn.params["precision"]), eqn.params
