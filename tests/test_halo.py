"""Halo-exchange sharded execution (x sharded + ppermute ring).

The narrow exchange: instead of replicating x (the reference's
shared-memory read), each device holds one chunk and fetches only the
``halo_k`` neighbor chunks its column span references
(``parallel/shard.py`` ``device_fn_halo``).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.ops.oracle import max_rel_error
from sparsex_jax.parallel.shard import ShardedCsx, _col_span


def banded_random(n, bands, extra, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b in bands:
        r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
        rows.append(r)
        cols.append(r + b)
    if extra:
        rows.append(rng.integers(0, n, extra))
        cols.append(rng.integers(0, n, extra))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size) + 2.0
    return rows, cols, vals


def dense_of(n, rows, cols, vals):
    d = np.zeros((n, n))
    d[rows, cols] = vals
    return d


def make_sharded(n, bands, extra, ndev, x_mode="auto", seed=0):
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", str(ndev))
    cfg.set("spx.jax.x_mode", x_mode)
    rows, cols, vals = banded_random(n, bands, extra, seed)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("shards",))
    return ShardedCsx(mat, mesh=mesh), dense_of(n, rows, cols, vals)


def test_auto_selects_halo_for_banded():
    sh, dense = make_sharded(256, (0, 1, -1, 5), extra=0, ndev=8)
    assert sh.x_mode == "halo"
    assert sh.halo_k <= 1
    x = np.random.default_rng(1).standard_normal(256)
    assert max_rel_error(np.asarray(sh.matvec(x)), dense @ x) < 1e-10


def test_auto_falls_back_for_wide_span():
    # random cols force a full-width span -> replicated
    sh, dense = make_sharded(128, (0,), extra=400, ndev=8)
    assert sh.x_mode == "replicated"
    x = np.random.default_rng(2).standard_normal(128)
    assert max_rel_error(np.asarray(sh.matvec(x)), dense @ x) < 1e-10


def test_forced_halo_wide_window_still_correct():
    # forcing halo with a wide span grows the window but stays correct
    sh, dense = make_sharded(128, (0, 3), extra=300, ndev=4,
                             x_mode="halo")
    assert sh.x_mode == "halo"
    x = np.random.default_rng(3).standard_normal(128)
    assert max_rel_error(np.asarray(sh.matvec(x)), dense @ x) < 1e-10


@pytest.mark.parametrize("ndev", [2, 8])
def test_halo_vs_replicated_identical(ndev):
    x = np.random.default_rng(4).standard_normal(192)
    outs = []
    for mode in ("halo", "replicated"):
        Config.reset()
        sh, dense = make_sharded(192, (0, 2, -7), extra=24, ndev=ndev,
                                 x_mode=mode, seed=5)
        outs.append(np.asarray(sh.matvec(x)))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-12, atol=1e-12)
    assert max_rel_error(outs[0], dense @ x) < 1e-10


def test_col_span_covers_all_tables():
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    rows, cols, vals = banded_random(96, (0, 1, -3), extra=30, seed=6)
    mat = CsxMatrix.from_coo(96, 96, rows, cols, vals)
    lo, hi = _col_span(mat.shards[0])
    assert lo <= int(cols.min()) and hi >= int(cols.max()) + 1


def test_forced_halo_on_symmetric_correct():
    """x_mode=halo on a symmetric matrix (supported since r3: window-
    rebased tables, z_off global destinations) must include D*x and
    L^T*x — the exact contributions the pre-r3 code would have dropped."""
    from sparsex_jax.ops.oracle import coo_spmv
    from sparsex_jax.symmetric import build_symmetric_csx
    cfg = Config.instance()
    cfg.set("spx.jax.x_mode", "halo")
    cfg.set("spx.rt.nr_threads", "2")
    r = np.array([0, 1, 1, 2, 3])
    c = np.array([0, 0, 1, 2, 3])
    v = np.array([2.0, 1.0, 2.0, 2.0, 2.0])
    mat = build_symmetric_csx(4, 4, r, c, v, already_lower=True)
    mesh = Mesh(np.array(jax.devices()[:2]), ("shards",))
    sh = ShardedCsx(mat, mesh=mesh)
    assert sh.x_mode == "halo"
    x = np.array([1.0, 2.0, 3.0, 4.0])
    got = np.asarray(sh.matvec(x))
    rows = np.concatenate([r, c[r != c]])
    cols = np.concatenate([c, r[r != c]])
    vals = np.concatenate([v, v[r != c]])
    want = coo_spmv(4, rows, cols, vals, x)
    assert max_rel_error(got, want) <= 1e-6


def test_halo_symmetric_matches_replicated():
    """Symmetric halo mode: window-rebased tables + z_off global
    destinations + psum_scatter reduction, checked against the replicated
    output and the oracle."""
    import jax.numpy as jnp

    from sparsex_jax.symmetric import build_symmetric_csx

    cfg = Config.reset()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.rt.nr_threads", "4")
    cfg.set("spx.preproc.xform", "all")

    # banded symmetric: lower-triangle band + diagonal (halo-friendly)
    n = 4096
    rng = np.random.default_rng(5)
    r = rng.integers(0, n, 5000)
    off = rng.integers(0, 200, 5000)
    rs = np.concatenate([r, np.arange(n)])
    cs = np.concatenate([np.maximum(r - off, 0), np.arange(n)])
    k = np.unique(rs * n + cs)
    rs, cs = k // n, k % n
    vs = rng.standard_normal(rs.size)
    m = rs != cs
    rows = np.concatenate([rs, cs[m]])
    cols = np.concatenate([cs, rs[m]])
    vals = np.concatenate([vs, vs[m]]).astype(np.float32)
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]

    mat = build_symmetric_csx(n, n, rows, cols, vals)
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("shards",))
    x = np.random.default_rng(6).standard_normal(n).astype(np.float32)

    cfg.set("spx.jax.x_mode", "halo")
    sh_halo = ShardedCsx(mat, mesh=mesh)
    assert sh_halo.x_mode == "halo"
    y_halo = np.asarray(sh_halo.matvec(jnp.asarray(x)))
    cfg.set("spx.jax.x_mode", "replicated")
    y_rep = np.asarray(ShardedCsx(mat, mesh=mesh).matvec(jnp.asarray(x)))

    ref = np.zeros(n, np.float64)
    np.add.at(ref, rows, vals.astype(np.float64) *
              x.astype(np.float64)[cols])
    assert max_rel_error(y_halo, ref) < 1e-4
    assert max_rel_error(y_halo, y_rep) < 1e-4
