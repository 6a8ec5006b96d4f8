"""Public API walkthrough (ref test/src/sparsex_test.c and examples)."""

import numpy as np
import pytest

import sparsex_jax as spx
from sparsex_jax.io.csr import csr_from_coo
from sparsex_jax.ops.oracle import coo_spmv, max_rel_error
from tests import fixtures

TOL = 1e-6


def test_full_api_walkthrough_mmf(tmp_path):
    """load MMF -> tune -> repeated matvec_mult -> check vs oracle
    (mirrors test/src/sparsex_test.c)."""
    spx.init()
    nrows, ncols, rows, cols, vals = fixtures.random_coo(50, 50, seed=9)
    path = str(tmp_path / "m.mtx")
    fixtures.write_mmf(path, nrows, ncols, rows, cols, vals)

    inp = spx.input_load_mmf(path)
    mat = spx.mat_tune(inp)
    assert (mat.nrows, mat.ncols, mat.nnz) == (nrows, ncols, rows.size)

    rng = np.random.default_rng(0)
    x = rng.standard_normal(ncols)
    y = np.zeros(nrows)
    for _ in range(8):
        y = spx.matvec_mult(2.0, mat, x)
    want = 2.0 * coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(np.asarray(y), want) <= TOL
    spx.input_destroy(inp)
    spx.mat_destroy(mat)
    spx.finalize()


def test_csr_input_and_partition():
    nrows, ncols, rows, cols, vals = fixtures.banded_coo()
    csr = csr_from_coo(nrows, ncols, rows, cols, vals)
    inp = spx.input_load_csr(csr.rowptr, csr.colind, csr.values, nrows, ncols)
    mat = spx.mat_tune(inp)
    x = np.arange(ncols, dtype=np.float64) / ncols
    y0 = np.ones(nrows)
    got = np.asarray(spx.matvec_kernel(1.5, mat, x, -0.5, y0))
    want = 1.5 * coo_spmv(nrows, rows, cols, vals, x) - 0.5 * y0
    assert max_rel_error(got, want) <= TOL

    part = spx.partition_csr(csr.rowptr, nrows, 4)
    assert part.parts.nparts == 4
    assert part.parts.row_start[0] == 0
    assert part.parts.row_end[-1] == nrows
    assert sum(part.parts.nnz_per_part) == rows.size


def test_matvec_kernel_csr_lazy_tune():
    nrows, ncols, rows, cols, vals = fixtures.random_coo(30, 30, seed=2)
    csr = csr_from_coo(nrows, ncols, rows, cols, vals)
    x = np.random.default_rng(1).standard_normal(ncols)
    y = np.zeros(nrows)
    got = np.asarray(spx.matvec_kernel_csr(
        csr.rowptr, csr.colind, csr.values, nrows, ncols, 1.0, x, 0.0, y))
    want = coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(got, want) <= TOL


def test_mat_save_restore_api(tmp_path):
    nrows, ncols, rows, cols, vals = fixtures.blocky_coo()
    csr = csr_from_coo(nrows, ncols, rows, cols, vals)
    inp = spx.input_load_csr(csr.rowptr, csr.colind, csr.values, nrows, ncols)
    mat = spx.mat_tune(inp)
    path = str(tmp_path / "cache.npz")
    spx.mat_save(mat, path)
    mat2 = spx.mat_restore(path)
    x = np.random.default_rng(3).standard_normal(ncols)
    np.testing.assert_allclose(np.asarray(spx.matvec_mult(1.0, mat, x)),
                               np.asarray(spx.matvec_mult(1.0, mat2, x)),
                               rtol=1e-12)
    # set_entry on the restored matrix (ref BinaryTest_p2)
    r, c = int(rows[0]), int(cols[0])
    spx.mat_set_entry(mat2, r, c, 7.5)
    assert spx.mat_get_entry(mat2, r, c) == pytest.approx(7.5)


def test_reorder_flag(tmp_path):
    spx.option_set("spx.preproc.xform", "all")
    nrows, ncols, rows, cols, vals = fixtures.symmetric_coo(n=50, seed=13)
    path = str(tmp_path / "s.mtx")
    fixtures.write_mmf(path, nrows, ncols, rows, cols, vals)
    inp = spx.input_load_mmf(path)
    mat = spx.mat_tune(inp, spx.api.OP_REORDER)
    perm = mat.permutation
    assert perm is not None
    x = np.random.default_rng(4).standard_normal(ncols)
    got = np.asarray(spx.matvec_mult(1.0, mat, spx.vec.reorder(x, perm)))
    got = np.asarray(spx.vec.inv_reorder(got, perm))
    want = coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(got, want) <= TOL


def test_vector_ops():
    v1 = spx.vec.create(5)
    assert np.all(np.asarray(v1) == 0)
    v1 = spx.vec.init(v1, 2.0)
    v2 = spx.vec.create_random(5, seed=0)
    assert spx.vec.compare(spx.vec.add(v1, v2),
                           2.0 + np.asarray(v2))
    assert spx.vec.compare(spx.vec.sub(v1, v1), np.zeros(5))
    assert float(spx.vec.mul(v1, v1)) == pytest.approx(20.0)
    assert spx.vec.compare(spx.vec.scale(v1, 3.0), 6.0 * np.ones(5))
    s = spx.vec.scale_add(v1, v2, 0.5)
    assert spx.vec.compare(s, 2.0 + 0.5 * np.asarray(v2))
    perm = np.array([2, 0, 1, 4, 3])
    r = spx.vec.reorder(v2, perm)
    assert spx.vec.compare(spx.vec.inv_reorder(r, perm), v2)


def test_symmetric_mmf_api(tmp_path):
    """Symmetric option + MMF symmetric file end-to-end."""
    text = fixtures.symmetric_mmf_text(n=8, seed=4)
    path = str(tmp_path / "sym.mtx")
    with open(path, "w") as fp:
        fp.write(text)
    spx.option_set("spx.matrix.symmetric", "true")
    inp = spx.input_load_mmf(path)
    mat = spx.mat_tune(inp)
    # oracle from the mirrored load
    from sparsex_jax.io.mmf import load_mmf
    full = load_mmf(path)
    x = np.random.default_rng(5).standard_normal(8)
    got = np.asarray(spx.matvec_mult(1.0, mat, x))
    want = coo_spmv(8, full.rows, full.cols, full.vals, x)
    assert max_rel_error(got, want) <= TOL


def test_symmetric_flag_on_unsymmetric_mmf_fails(tmp_path):
    nrows, ncols, rows, cols, vals = fixtures.random_coo(20, 20, seed=6)
    path = str(tmp_path / "g.mtx")
    fixtures.write_mmf(path, nrows, ncols, rows, cols, vals)
    spx.option_set("spx.matrix.symmetric", "true")
    with pytest.raises(spx.SparsexError):
        inp = spx.input_load_mmf(path)
        spx.mat_tune(inp)


def test_vector_part_ops_and_copy():
    """spx_vec_{add,sub,mul}_part, copy, init_rand_range parity
    (ref src/api/matvec.c:849-1001)."""
    import numpy as np
    from sparsex_jax.ops import vector as vec

    a = np.arange(10, dtype=np.float64)
    b = np.full(10, 2.0)
    out = vec.add_part(a, b, 2, 5)
    assert np.allclose(out[2:5], a[2:5] + 2.0)
    assert np.allclose(out[:2], a[:2]) and np.allclose(out[5:], a[5:])
    out = vec.sub_part(a, b, 0, 3)
    assert np.allclose(out[:3], a[:3] - 2.0) and np.allclose(out[3:], a[3:])
    assert vec.mul_part(a, b, 1, 4) == float(np.dot(a[1:4], b[1:4]))
    c = vec.copy(a)
    c[0] = 99
    assert a[0] == 0
    v = np.zeros(100)
    vec.init_rand_range(v, 3.0, 7.0, seed=1)
    assert v.min() >= 3.0 and v.max() < 7.0
    w = vec.create_interleaved(16)
    assert w.shape == (16,) and np.all(np.asarray(w) == 0)


def test_measure_load_imbalance():
    """Runtime per-shard secs report (ref SpmvTest.cpp:35-60)."""
    import numpy as np
    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix

    cfg = Config.reset()
    cfg.set("spx.rt.nr_threads", "2")
    rng = np.random.default_rng(0)
    n = 1024
    rows = rng.integers(0, n, 4000)
    cols = rng.integers(0, n, 4000)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    mat = CsxMatrix.from_coo(n, n, rows, cols,
                             rng.standard_normal(rows.size))
    secs, imb = mat.measure_load_imbalance(loops=8)
    assert len(secs) == 2 and all(s > 0 for s in secs)
    assert imb >= 0.0


def test_float64_without_x64_warns_once():
    """mat_tune says through the logger that float64 values will run in
    float32 when jax_enable_x64 is off."""
    import jax

    from sparsex_jax.logger import Level, LoggingHandler

    msgs = []
    handler = LoggingHandler.instance()
    old = dict(handler.sinks)
    try:
        handler.set_sink(Level.WARNING, msgs.append)
        n, _, rows, cols, vals = fixtures.random_coo(40, 40, seed=3)
        rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                            minlength=n))])
        inp = spx.input_load_csr(rowptr, cols, vals, n, n)
        with jax.enable_x64(False):
            spx.mat_tune(inp)
        spx.mat_tune(inp)          # x64 on (the test harness): no warning
    finally:
        handler.sinks.clear()
        handler.sinks.update(old)
    hits = [m for m in msgs if "jax_enable_x64" in m]
    assert len(hits) == 1, msgs
