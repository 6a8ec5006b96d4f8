"""Multi-device SPMD tests on the 8-device virtual CPU mesh
(SURVEY §4: the reference's nr_threads=2 pthread tests map to
--xla_force_host_platform_device_count sharding tests)."""

import jax
import numpy as np
import pytest

import sparsex_jax as spx
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.ops.oracle import coo_spmv, max_rel_error
from sparsex_jax.parallel.shard import ShardedCsx
from sparsex_jax.symmetric import build_symmetric_csx
from tests import fixtures

TOL = 1e-6
NDEV = len(jax.devices())


def _mesh(n):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("shards",))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_matvec(ndev):
    if NDEV < ndev:
        pytest.skip("not enough devices")
    spx.option_set("spx.rt.nr_threads", str(ndev))
    spx.option_set("spx.preproc.xform", "all")
    nrows, ncols, rows, cols, vals = fixtures.banded_coo(n=257)
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    sh = ShardedCsx(mat, mesh=_mesh(ndev))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(ncols)
    y0 = rng.standard_normal(nrows)
    got = np.asarray(sh.matvec(x, alpha=1.2, beta=-0.3, y=y0))
    want = 1.2 * coo_spmv(nrows, rows, cols, vals, x) - 0.3 * y0
    assert max_rel_error(got, want) <= TOL


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_symmetric(ndev):
    if NDEV < ndev:
        pytest.skip("not enough devices")
    spx.option_set("spx.rt.nr_threads", str(ndev))
    spx.option_set("spx.preproc.xform", "all")
    nrows, ncols, rows, cols, vals = fixtures.symmetric_coo(n=90, seed=8)
    mat = build_symmetric_csx(nrows, ncols, rows, cols, vals)
    sh = ShardedCsx(mat, mesh=_mesh(ndev))
    x = np.random.default_rng(1).standard_normal(ncols)
    got = np.asarray(sh.matvec(x))
    want = coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(got, want) <= TOL


def test_sharded_matches_loop_executor():
    if NDEV < 4:
        pytest.skip("not enough devices")
    spx.option_set("spx.rt.nr_threads", "4")
    nrows, ncols, rows, cols, vals = fixtures.blocky_coo(n=128)
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    sh = ShardedCsx(mat, mesh=_mesh(4))
    x = np.random.default_rng(2).standard_normal(ncols)
    np.testing.assert_allclose(np.asarray(sh.matvec(x)),
                               np.asarray(mat.matvec(x)), rtol=1e-12)


def test_shard_count_mismatch_rejected():
    spx.option_set("spx.rt.nr_threads", "2")
    nrows, ncols, rows, cols, vals = fixtures.random_coo(40, 40, seed=3)
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    if NDEV < 4:
        pytest.skip("not enough devices")
    with pytest.raises(ValueError):
        ShardedCsx(mat, mesh=_mesh(4))


def test_mixed_shards_some_without_dias():
    """Union stacking when only some shards have DIA tables."""
    import jax
    from jax.sharding import Mesh
    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.ops.oracle import max_rel_error
    from sparsex_jax.parallel.shard import ShardedCsx

    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "2")
    n = 128
    rng = np.random.default_rng(11)
    # top half: dense diagonal (folds to DIA); bottom half: random singles
    rows = [np.arange(n // 2)]
    cols = [np.arange(n // 2)]
    rows.append(rng.integers(n // 2, n, 120))
    cols.append(rng.integers(0, n, 120))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    has_dias = [bool(t.dias) for t in mat.shards]
    assert True in has_dias and False in has_dias, has_dias
    sh = ShardedCsx(mat, mesh=Mesh(np.array(jax.devices()[:2]), ("shards",)))
    x = rng.standard_normal(n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    assert max_rel_error(np.asarray(sh.matvec(x)), dense @ x) < 1e-10


def test_restore_then_shard():
    """mat_restore output feeds ShardedCsx directly."""
    import jax
    from jax.sharding import Mesh
    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.ops.oracle import max_rel_error
    from sparsex_jax.parallel.shard import ShardedCsx
    from sparsex_jax.persist import restore_csx, save_csx
    import tempfile, os

    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "4")
    n = 96
    rng = np.random.default_rng(12)
    rows = np.arange(n - 1)
    cols = rows + 1
    vals = rng.standard_normal(n - 1)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.npz")
        save_csx(mat, path)
        mat2, _ = restore_csx(path)
    sh = ShardedCsx(mat2, mesh=Mesh(np.array(jax.devices()[:4]),
                                    ("shards",)))
    x = rng.standard_normal(n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    assert max_rel_error(np.asarray(sh.matvec(x)), dense @ x) < 1e-10
