"""Seeded fuzz: random matrices x option combinations vs the dense oracle.

Mirrors the spirit of the reference driver's option sweep but with random
structure mixes (bands, blocks, runs, singles) — the widest net for
interaction bugs between mining, table packing, DIA folding and the
executors.
"""

import itertools

import numpy as np
import pytest

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.ops.oracle import max_rel_error


def random_structured(seed, nrows, ncols):
    """A random mix of structure classes."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    # bands
    for _ in range(rng.integers(0, 4)):
        b = int(rng.integers(-nrows // 2, ncols // 2))
        r = np.arange(max(0, -b), min(nrows, ncols - b), dtype=np.int64)
        if r.size:
            rows.append(r)
            cols.append(r + b)
    # anti-diagonal segments
    for _ in range(rng.integers(0, 3)):
        s = int(rng.integers(0, nrows + ncols - 2))
        r = np.arange(max(0, s - ncols + 1), min(nrows, s + 1),
                      dtype=np.int64)
        if r.size > 3:
            rows.append(r)
            cols.append(s - r)
    # horizontal runs
    for _ in range(rng.integers(0, 6)):
        r0 = int(rng.integers(0, nrows))
        c0 = int(rng.integers(0, max(1, ncols - 20)))
        w = int(rng.integers(4, 20))
        rows.append(np.full(min(w, ncols - c0), r0, dtype=np.int64))
        cols.append(np.arange(c0, min(c0 + w, ncols), dtype=np.int64))
    # blocks
    for _ in range(rng.integers(0, 5)):
        br, bc = int(rng.integers(2, 5)), int(rng.integers(2, 5))
        r0 = int(rng.integers(0, max(1, nrows - br)))
        c0 = int(rng.integers(0, max(1, ncols - bc)))
        rr, cc = np.meshgrid(np.arange(br), np.arange(bc), indexing="ij")
        rows.append((r0 + rr).ravel())
        cols.append((c0 + cc).ravel())
    # singles
    m = int(rng.integers(5, nrows))
    rows.append(rng.integers(0, nrows, m))
    cols.append(rng.integers(0, ncols, m))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * ncols + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size) + 0.5
    return rows, cols, vals


CASES = list(itertools.product(
    range(6),                                   # seeds
    ["all", "h,v", "d,ad,br2,bc3", "none"],     # xform
    [1, 3],                                     # shards
))


@pytest.mark.parametrize("seed,xform,nshards", CASES,
                         ids=[f"s{s}-{x}-p{p}" for s, x, p in CASES])
def test_fuzz_vs_oracle(seed, xform, nshards):
    cfg = Config.instance()
    cfg.set("spx.preproc.xform", xform)
    cfg.set("spx.preproc.sampling", "none" if seed % 2 else "portion")
    cfg.set("spx.rt.nr_threads", str(nshards))
    cfg.set("spx.matrix.min_coverage", "0.0")
    nrows, ncols = 150 + 17 * seed, 140 + 23 * seed
    rows, cols, vals = random_structured(seed, nrows, ncols)
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    rng = np.random.default_rng(seed + 1000)
    x = rng.standard_normal(ncols)
    y0 = rng.standard_normal(nrows)
    y = np.asarray(mat.matvec(x, alpha=1.3, beta=-0.4, y=y0))
    dense = np.zeros((nrows, ncols))
    dense[rows, cols] = vals
    want = 1.3 * dense @ x - 0.4 * y0
    err = max_rel_error(y, want)
    assert err < 1e-9, (seed, xform, nshards, err)
    # round-trip through tocoo must reproduce the matrix exactly
    rr, cc, vv = mat.tocoo()
    d2 = np.zeros((nrows, ncols))
    d2[rr, cc] = vv
    np.testing.assert_allclose(d2, dense, atol=1e-12)


SYM_CASES = list(itertools.product(range(4), [1, 2]))


@pytest.mark.parametrize("seed,nshards", SYM_CASES,
                         ids=[f"s{s}-p{p}" for s, p in SYM_CASES])
def test_fuzz_symmetric(seed, nshards):
    """Random symmetric structure mixes vs the mirrored dense oracle,
    plus a save/restore roundtrip."""
    from sparsex_jax.persist import restore_csx, save_csx
    from sparsex_jax.symmetric import build_symmetric_csx
    import tempfile, os

    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", str(nshards))
    n = 120 + 31 * seed
    rng = np.random.default_rng(seed + 77)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    # random lower-triangle entries + a lower band
    r = rng.integers(1, n, 4 * n)
    c = (r * 0 + rng.integers(0, n, 4 * n)) % r
    rows.append(r)
    cols.append(c)
    b = int(rng.integers(1, 6))
    rr = np.arange(b, n)
    rows.append(rr)
    cols.append(rr - b)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size) + 0.1
    mat = build_symmetric_csx(n, n, rows, cols, vals, already_lower=True)

    off = rows != cols
    fr = np.concatenate([rows, cols[off]])
    fc = np.concatenate([cols, rows[off]])
    fv = np.concatenate([vals, vals[off]])
    dense = np.zeros((n, n))
    dense[fr, fc] = fv
    x = rng.standard_normal(n)
    err = max_rel_error(np.asarray(mat.matvec(x, alpha=0.7)),
                        0.7 * dense @ x)
    assert err < 1e-9, (seed, nshards, err)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.npz")
        save_csx(mat, path)
        mat2, _ = restore_csx(path)
    err2 = max_rel_error(np.asarray(mat2.matvec(x, alpha=0.7)),
                         0.7 * dense @ x)
    assert err2 < 1e-9, (seed, nshards, err2)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_reorder_persist_roundtrip(seed, tmp_path):
    """Public API: tune with RCM reorder, save, restore, solve — the
    permutation must survive the roundtrip."""
    import os
    import sparsex_jax as spx
    from sparsex_jax.ops import vector as vec
    from sparsex_jax.ops.oracle import coo_spmv

    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.preproc.sampling", "none")
    rng = np.random.default_rng(seed + 50)
    n = 90 + 13 * seed
    # symmetric-pattern band + random (RCM needs a square graph)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    b = 1 + seed
    r = np.arange(b, n)
    rows += [r, r - b]
    cols += [r - b, r]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size)
    rowptr = np.zeros(n + 1, np.int64)
    np.add.at(rowptr, rows + 1, 1)
    A = spx.mat_tune(
        spx.input_load_csr(np.cumsum(rowptr), cols, vals, n, n),
        spx.OP_REORDER)
    assert A.permutation is not None

    path = str(tmp_path / "m.npz")
    spx.mat_save(A, path)
    B = spx.mat_restore(path)
    assert B.permutation is not None
    np.testing.assert_array_equal(A.permutation, B.permutation)

    x = rng.standard_normal(n)
    want = coo_spmv(n, rows, cols, vals, x, alpha=1.0)
    for M in (A, B):
        xp = vec.reorder(x, M.permutation)
        yp = np.asarray(spx.matvec_mult(1.0, M, xp))
        y = np.asarray(vec.inv_reorder(yp, M.permutation))
        err = np.max(np.abs(y - want)) / max(np.max(np.abs(want)), 1e-30)
        assert err < 1e-9, (seed, err)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_all_classes_f32(seed):
    """Fuzz every table class at once (runs of each direction, blocks,
    bands, singles) in float32 on the XLA path, at sizes the tiny-matrix
    fuzz above never reaches."""
    import jax.numpy as jnp

    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", "1")
    nrows = ncols = 4096 + 512 * seed
    rng = np.random.default_rng(seed + 77)
    rows_l, cols_l = [], []
    # runs of every class
    for w, sr, sc in ((8, 0, 1), (4, 0, 1), (8, 1, 0), (16, 1, 1),
                      (16, 1, -1)):
        nu = int(rng.integers(100, 400))
        r0 = rng.integers(0, nrows - 16 * max(sr, 1) - 1, nu)
        c0 = rng.integers(16, ncols - 16, nu)
        j = np.arange(w)
        rows_l.append((r0[:, None] + sr * j[None]).ravel())
        cols_l.append((c0[:, None] + sc * j[None]).ravel())
    # blocks
    nb = int(rng.integers(50, 200))
    br, bc = 2, 4
    r0 = rng.integers(0, nrows - br, nb)
    c0 = rng.integers(0, ncols - bc, nb)
    rr, cc = np.meshgrid(np.arange(br), np.arange(bc), indexing="ij")
    rows_l.append((r0[:, None] + rr.ravel()[None]).ravel())
    cols_l.append((c0[:, None] + cc.ravel()[None]).ravel())
    # bands + singles
    for b in (0, 7):
        r = np.arange(0, nrows - b, dtype=np.int64)
        rows_l.append(r)
        cols_l.append(r + b)
    m = int(rng.integers(4000, 12000))
    rows_l.append(rng.integers(0, nrows, m))
    cols_l.append(rng.integers(0, ncols, m))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keep = (rows >= 0) & (rows < nrows) & (cols >= 0) & (cols < ncols)
    rows, cols = rows[keep], cols[keep]
    _, u = np.unique(rows.astype(np.int64) * ncols + cols,
                     return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = (rng.standard_normal(rows.size) + 0.5).astype(np.float32)

    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    x = rng.standard_normal(ncols).astype(np.float32)
    y = np.asarray(mat.matvec(jnp.asarray(x)))
    prod = vals.astype(np.float64) * x.astype(np.float64)[cols]
    want = np.zeros(nrows)
    np.add.at(want, rows, prod)
    # f32 compute vs f64 oracle: per-element |want| cancels to ~1e-4
    # on rows whose terms nearly cancel, so normalize the error by the
    # row's L1 mass (the f32 rounding scale) instead of max_rel_error.
    mass = np.zeros(nrows)
    np.add.at(mass, rows, np.abs(prod))
    err = float(np.max(np.abs(y - want) / np.maximum(mass, 1e-30)))
    assert err < 1e-5, (seed, err)
