"""CG solver on top of the CSX executors (the BASELINE's solver flow)."""

import numpy as np
import pytest

import jax

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.solvers import cg
from sparsex_jax.symmetric import build_symmetric_csx


def spd_coo(n=80, seed=0):
    """Banded s.p.d. matrix (diagonally dominant, symmetric)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [np.full(n, 6.0)]
    for b in (1, 4):
        r = np.arange(b, n)
        v = rng.random(r.size)
        rows += [r, r - b]
        cols += [r - b, r]
        vals += [v, v]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    o = np.lexsort((cols, rows))
    return rows[o], cols[o], vals[o]


def test_cg_on_general_csx():
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    n = 80
    rows, cols, vals = spd_coo(n)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    b = np.random.default_rng(1).standard_normal(n)
    x, it, res = cg(mat.mult, b, tol=1e-10, maxiter=500)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    want = np.linalg.solve(dense, b)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-6, atol=1e-8)
    assert int(it) < 500


def test_cg_on_symmetric_csx():
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "2")
    n = 64
    rows, cols, vals = spd_coo(n, seed=2)
    mat = build_symmetric_csx(n, n, rows, cols, vals)
    b = np.random.default_rng(3).standard_normal(n)
    x, it, res = cg(lambda v: mat.matvec(v), b, tol=1e-10, maxiter=500)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    want = np.linalg.solve(dense, b)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-6, atol=1e-8)


def test_cg_on_sharded():
    from jax.sharding import Mesh
    from sparsex_jax.parallel.shard import ShardedCsx
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "4")
    n = 128
    rows, cols, vals = spd_coo(n, seed=4)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    sh = ShardedCsx(mat, mesh=Mesh(np.array(jax.devices()[:4]), ("shards",)))
    b = np.random.default_rng(5).standard_normal(n)
    x, it, res = cg(lambda v: sh.matvec(v), b, tol=1e-10, maxiter=500)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    want = np.linalg.solve(dense, b)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-6, atol=1e-8)


def test_bfloat16_value_dtype_smoke():
    """spx.jax.value_dtype=bfloat16 builds tables and computes at bf16
    tolerance."""
    import jax.numpy as jnp
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "bfloat16")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    n = 64
    rows, cols, vals = spd_coo(n, seed=6)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    x = np.random.default_rng(7).standard_normal(n)
    y = np.asarray(mat.matvec(jnp.asarray(x, dtype=jnp.bfloat16)),
                   dtype=np.float64)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    want = dense @ x
    err = np.max(np.abs(y - want)) / np.max(np.abs(want))
    assert err < 0.05  # bf16 has ~3 decimal digits
