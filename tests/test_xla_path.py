"""The XLA table kernels against the oracle on matrices that stress each
access pattern: delta singles, skewed and clustered destination rows, run
tables of every direction, blocks, DIA and anti-DIA folds, rectangular
shapes, symmetric and sharded layouts, and SpMM.

Each case builds one matrix, tunes it through the public path and
compares the executor's result with a float64 COO oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.parallel.shard import ShardedCsx
from sparsex_jax.symmetric import build_symmetric_csx


def _dedup(rows, cols, ncols, seed, dtype=np.float32):
    """Unique, row-major sorted COO with random values."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    _, u = np.unique(rows * ncols + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    vals = np.random.default_rng(seed).standard_normal(rows.size)
    return rows[o], cols[o], vals.astype(dtype)


def _bands(n, offsets):
    rows, cols = [], []
    for b in offsets:
        r = np.arange(max(0, -b), min(n, n - b))
        rows.append(r)
        cols.append(r + b)
    return rows, cols


def _anti(n, s):
    r = np.arange(max(0, s - n + 1), min(n, s + 1))
    return r, s - r


def _hruns(rng, n, nu, w):
    hr = rng.integers(0, n, nu)
    hc = rng.integers(0, n - w, nu)
    return np.repeat(hr, w), (hc[:, None] + np.arange(w)[None]).ravel()


def _blocks(rng, n, nb, br=4, bc=2):
    r0 = rng.integers(0, (n - br) // br, nb) * br
    c0 = rng.integers(0, (n - bc) // bc, nb) * bc
    ii, jj = np.meshgrid(np.arange(br), np.arange(bc), indexing="ij")
    return ((r0[:, None, None] + ii[None]).ravel(),
            (c0[:, None, None] + jj[None]).ravel())


def _diagc(rng, n, nd, singles):
    j16 = np.arange(16)
    dr, dc = rng.integers(0, n - 16, nd), rng.integers(0, n - 16, nd)
    ar, ac = rng.integers(0, n - 16, nd), rng.integers(16, n, nd)
    vr, vc = rng.integers(0, n - 8, nd), rng.integers(0, n, nd)
    rows = [(dr[:, None] + j16[None]).ravel(), (ar[:, None] + j16[None]).ravel(),
            (vr[:, None] + np.arange(8)[None]).ravel(),
            rng.integers(0, n, singles)]
    cols = [(dc[:, None] + j16[None]).ravel(), (ac[:, None] - j16[None]).ravel(),
            np.repeat(vc, 8), rng.integers(0, n, singles)]
    return rows, cols


# ---------------------------------------------------------------------------
# single-device executor cases: name -> (build, xform, dtype)
# build(rng) -> (nrows, ncols, rows_list, cols_list)
# ---------------------------------------------------------------------------
def _c_singles_square(rng):
    n = 1 << 15
    return n, n, [rng.integers(0, n, 12000)], [rng.integers(0, n, 12000)]


def _c_singles_ragged(rng):
    n, nc = 100000, 90000
    return n, nc, [rng.integers(0, n, 20000)], [rng.integers(0, nc, 20000)]


def _c_dias_and_anti(rng):
    n = 1 << 15
    rows, cols = _bands(n, (0, 5, -7))
    for s in (n - 1, n + 3):
        r, c = _anti(n, s)
        rows.append(r)
        cols.append(c)
    rows.append(rng.integers(0, n, 9000))
    cols.append(rng.integers(0, n, 9000))
    return n, n, rows, cols


def _c_hot_rows(rng):
    n = 1 << 14
    hot = np.repeat(np.arange(16), 12)
    rows = [hot, rng.integers(0, n, 4000)]
    return n, n, rows, [rng.integers(0, n, r.size) for r in rows]


def _c_hot_pages(rng):
    n, pages, per = 1 << 14, 40, 280
    hot = (np.repeat(np.arange(pages), per) * 128
           + rng.integers(0, 128, pages * per))
    return n, n, [hot, rng.integers(pages * 128, n, 6000)], [
        rng.integers(0, 4096, pages * per), rng.integers(0, n, 6000)]


def _c_bands_anti_singles(rng):
    n = 8192
    rows, cols = _bands(n, (0, 3, -2))
    r, c = _anti(n, n)
    rows.append(r)
    cols.append(c)
    rows.append(rng.integers(0, n, 9000))
    cols.append(rng.integers(0, n, 9000))
    return n, n, rows, cols


def _c_hruns(rng):
    n = 1 << 14
    r, c = _hruns(rng, n, 1200, 8)
    return n, n, [r], [c]


def _c_blocks(rng):
    n = 1 << 15
    r, c = _blocks(rng, n, 8000)
    return n, n, [r], [c]


def _c_blocks_runs_singles(rng):
    n = 1 << 15
    br, bc = _blocks(rng, n, 8000)
    hr, hc = _hruns(rng, n, 2000, 8)
    return n, n, [br, hr, rng.integers(0, n, 12000)], [
        bc, hc, rng.integers(0, n, 12000)]


def _c_run_per_head(w):
    def build(rng):
        n = 1 << 13
        heads = np.arange(n - w)
        rng.shuffle(heads)
        rows_u = rng.integers(0, n, n - w)
        return n, n, [np.repeat(rows_u, w)], [
            (heads[:, None] + np.arange(w)[None]).ravel()]
    return build


def _c_runs_one_lane(rng):
    n = 1 << 13
    heads = rng.integers(0, n // 128 - 1, 600) * 128
    rows_u = rng.integers(0, n, 600)
    return n, n, [np.repeat(rows_u, 8)], [
        (heads[:, None] + np.arange(8)[None]).ravel()]


def _c_spaced_runs(seed):
    def build(rng):
        rng = np.random.default_rng(seed)
        n, nu = 1 << 14, 3000
        hr = rng.integers(0, n, nu)
        hc = (np.arange(nu, dtype=np.int64) * 8) % (n - 8)
        return n, n, [np.repeat(hr, 8), rng.integers(0, n, 40000)], [
            (hc[:, None] + np.arange(8)[None]).ravel(),
            rng.integers(0, n, 40000)]
    return build


def _c_diag_classes(rng):
    n = 1 << 14
    rows, cols = _diagc(rng, n, 400, 8000)
    return n, n, rows, cols


def _c_hot_page_overflow(rng):
    n = 1 << 14
    return n, n, [rng.integers(384, 512, 520), rng.integers(512, n, 9000)], [
        rng.integers(0, 4096, 520), rng.integers(0, n, 9000)]


def _c_vertical_clumps(rng):
    n, nu = 1 << 15, 1500
    vr, vc = rng.integers(0, n - 8, nu), rng.integers(0, n, nu)
    return n, n, [(vr[:, None] + np.arange(8)[None]).ravel(),
                  rng.integers(0, n, 6000)], [
        np.repeat(vc, 8), rng.integers(0, n, 6000)]


def _c_hv_blocks(rng):
    n = 4096
    hr, hc = _hruns(rng, n, 600, 8)
    vr, vc = rng.integers(0, n - 6, 300), rng.integers(0, n, 300)
    br, bc = _blocks(rng, n, 300)
    return n, n, [hr, (vr[:, None] + np.arange(6)[None]).ravel(), br], [
        hc, np.repeat(vc, 6), bc]


def _c_singles_4096(rng):
    n = 4096
    return n, n, [rng.integers(0, n, 6000)], [rng.integers(0, n, 6000)]


def _c_hruns_w20(rng):
    n = 4096
    r, c = _hruns(rng, n - 20, 600, 20)
    return n, n, [r], [c]


def _c_small_bands(rng):
    n = 600
    rows, cols = _bands(n, (0, 2, -5))
    return n, n, rows, cols


EXEC_CASES = {
    "singles_square": (_c_singles_square, "none", "float32"),
    "singles_ragged_rect": (_c_singles_ragged, "none", "float32"),
    "dias_and_anti": (_c_dias_and_anti, "all", "float32"),
    "hot_rows": (_c_hot_rows, "none", "float32"),
    "hot_pages": (_c_hot_pages, "none", "float32"),
    "bands_anti_singles": (_c_bands_anti_singles, "all", "float32"),
    "horizontal_runs": (_c_hruns, "h", "float32"),
    "blocks_4x2": (_c_blocks, "all", "float32"),
    "blocks_4x2_f64": (_c_blocks, "all", "float64"),
    "blocks_runs_singles": (_c_blocks_runs_singles, "all", "float32"),
    "run_per_head_w8": (_c_run_per_head(8), "h", "float32"),
    "run_per_head_w4": (_c_run_per_head(4), "h", "float32"),
    "runs_one_lane": (_c_runs_one_lane, "h", "float32"),
    "spaced_runs_a": (_c_spaced_runs(14), "h", "float32"),
    "spaced_runs_b": (_c_spaced_runs(15), "h", "float32"),
    "diag_classes": (_c_diag_classes, "v,d,ad", "float32"),
    "hot_page_overflow": (_c_hot_page_overflow, "none", "float32"),
    "vertical_clumps": (_c_vertical_clumps, "all", "float32"),
    "hv_blocks": (_c_hv_blocks, "h,v,br4", "float32"),
    "singles_4096": (_c_singles_4096, "none", "float32"),
    "hruns_w20_f64": (_c_hruns_w20, "h", "float64"),
    "small_bands_f64": (_c_small_bands, "all", "float64"),
}


@pytest.mark.parametrize("case", list(EXEC_CASES))
def test_executor_vs_oracle(case):
    build, xform, dtype = EXEC_CASES[case]
    rng = np.random.default_rng(sorted(EXEC_CASES).index(case))
    nrows, ncols, rl, cl = build(rng)
    rows, cols, vals = _dedup(np.concatenate(rl), np.concatenate(cl),
                              ncols, seed=1, dtype=dtype)
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", dtype)
    cfg.set("spx.preproc.xform", xform)
    mat = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    x = rng.standard_normal(ncols).astype(dtype)
    y0 = rng.standard_normal(nrows).astype(dtype)
    got = np.asarray(mat.matvec(jnp.asarray(x), alpha=2.5, beta=0.5,
                                y=jnp.asarray(y0)))
    ref = 0.5 * y0.astype(np.float64)
    np.add.at(ref, rows, 2.5 * vals.astype(np.float64)
              * x.astype(np.float64)[cols])
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert np.abs(got - ref).max() / np.abs(ref).max() < tol


def test_bfloat16_matrix_vs_rounded_oracle():
    """A bfloat16 matrix computes on the XLA path in bfloat16."""
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "bfloat16")
    cfg.set("spx.preproc.xform", "all")
    rng = np.random.default_rng(8)
    n = 4096
    rows, cols, vals = _dedup(
        np.concatenate([np.arange(n), rng.integers(0, n, 5000)]),
        np.concatenate([np.arange(n), rng.integers(0, n, 5000)]), n, seed=8)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(mat.matvec(jnp.asarray(x, dtype=jnp.bfloat16))
                   .astype(jnp.float32))
    vb = np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = np.zeros(n, np.float32)
    np.add.at(ref, rows, vb * xb[cols])
    assert np.abs(y - ref).max() / np.abs(ref).max() < 2e-2


def test_archive_with_layouts_entry_restores(tmp_path):
    """Archives that still carry a "layouts" entry restore their tables
    and run on the XLA path; new archives hold no layouts."""
    import json

    from sparsex_jax.persist import _COMPAT_MAGICS, restore_csx, save_csx

    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "float32")
    rng = np.random.default_rng(9)
    n = 4096
    rows, cols, vals = _dedup(
        np.concatenate([np.arange(n), rng.integers(0, n, 5000)]),
        np.concatenate([np.arange(n), rng.integers(0, n, 5000)]), n, seed=9)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    path = str(tmp_path / "cached.npz")
    save_csx(mat, path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
    assert "layouts" not in meta
    meta["magic"] = _COMPAT_MAGICS[0]
    meta["layouts"] = [{"meta": {"__arr__": "s0_Lm"}, "arrays": None}]
    arrays["s0_Lm"] = np.zeros(3)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **arrays)
    mat2, _ = restore_csx(old)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(mat2.matvec(jnp.asarray(x)))
    ref = np.zeros(n)
    np.add.at(ref, rows, vals.astype(np.float64) * x[cols])
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


# ---------------------------------------------------------------------------
# symmetric executor cases
# ---------------------------------------------------------------------------
def _sym_lower(rng, n, m, band=None):
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m) if band is None else np.maximum(
        r - rng.integers(0, band, m), 0)
    lo_r, lo_c = np.maximum(r, c), np.minimum(r, c)
    rows = np.concatenate([lo_r, np.arange(n)])
    cols = np.concatenate([lo_c, np.arange(n)])
    return _dedup(rows, cols, n, seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("n,m,sym_full", [(4096, 8000, "auto"),
                                          (2048, 3000, "off"),
                                          (2048, 3000, "on")])
def test_symmetric_vs_oracle(n, m, sym_full):
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "none")
    cfg.set("spx.jax.sym_full", sym_full)
    rng = np.random.default_rng(n + m)
    rows, cols, vals = _sym_lower(rng, n, m)
    mat = build_symmetric_csx(n, n, rows, cols, vals, already_lower=True)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(mat.matvec(jnp.asarray(x)))
    A = np.zeros((n, n))
    A[rows, cols] = vals
    A = A + np.tril(A, -1).T
    ref = A @ x.astype(np.float64)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


# ---------------------------------------------------------------------------
# sharded cases (virtual CPU mesh)
# ---------------------------------------------------------------------------
def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("shards",))


def _s_skewed(rng):
    n = 8192
    rows = [rng.integers(0, 200, 4000), rng.integers(n // 4, 3 * n // 4, 6000),
            rng.integers(3 * n // 4, n, 40)]
    return n, rows, [rng.integers(0, n, r.size) for r in rows]


def _s_singles(m, n=4096):
    def build(rng):
        return n, [rng.integers(0, n, m)], [rng.integers(0, n, m)]
    return build


def _s_banded(rng):
    n = 4096
    rows, cols = _bands(n, (0, 1, -1, 7))
    rows.append(rng.integers(0, n, 3000))
    cols.append(rng.integers(0, n, 3000))
    return n, rows, cols


def _s_near_diag(rng):
    n = 8192
    rows, cols = _bands(n, (0, 1))
    r = rng.integers(0, n, 40000)
    rows.append(r)
    cols.append(np.clip(r + rng.integers(-700, 700, 40000), 0, n - 1))
    return n, rows, cols


def _s_diag_classes(rng):
    n = 8192
    rows, cols = _diagc(rng, n, 300, 20000)
    return n, rows[:1] + rows[2:], cols[:1] + cols[2:]


def _s_blocks4x4(rng):
    n = 2048
    r, c = _blocks(rng, n, 300, 4, 4)
    return n, [r], [c]


SHARD_CASES = {
    "skewed_rows": (_s_skewed, "none", 4, "replicated", "float32"),
    "singles_6000": (_s_singles(6000), "none", 4, "replicated", "float64"),
    "singles_9000": (_s_singles(9000), "none", 4, "replicated", "float32"),
    "singles_40000": (_s_singles(40000, 8192), "none", 4, "replicated",
                      "float32"),
    "banded_halo": (_s_banded, "all", 4, "halo", "float32"),
    "near_diag_halo": (_s_near_diag, "none", 4, "halo", "float32"),
    "diag_classes": (_s_diag_classes, "v,d", 4, "replicated", "float32"),
    "blocks_4x4": (_s_blocks4x4, "br4", 2, "replicated", "float64"),
}


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_sharded_vs_oracle(case):
    build, xform, ndev, x_mode, dtype = SHARD_CASES[case]
    rng = np.random.default_rng(sorted(SHARD_CASES).index(case) + 100)
    n, rl, cl = build(rng)
    rows, cols, vals = _dedup(np.concatenate(rl), np.concatenate(cl), n,
                              seed=3, dtype=dtype)
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", dtype)
    cfg.set("spx.preproc.xform", xform)
    cfg.set("spx.preproc.sampling", "none")
    cfg.set("spx.rt.nr_threads", str(ndev))
    cfg.set("spx.jax.x_mode", x_mode)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    sh = ShardedCsx(mat, mesh=_mesh(ndev))
    assert sh.x_mode == x_mode
    x = rng.standard_normal(n).astype(dtype)
    y = np.asarray(sh.matvec(jnp.asarray(x)))
    ref = np.zeros(n)
    np.add.at(ref, rows, vals.astype(np.float64) * x.astype(np.float64)[cols])
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert np.abs(y - ref).max() / np.abs(ref).max() < tol


def test_sharded_symmetric_vs_oracle():
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.rt.nr_threads", "4")
    cfg.set("spx.preproc.xform", "all")
    n = 3000
    rng = np.random.default_rng(9)
    rs, cs, vs = _sym_lower(rng, n, 6000)
    off = rs != cs
    rows = np.concatenate([rs, cs[off]])
    cols = np.concatenate([cs, rs[off]])
    vals = np.concatenate([vs, vs[off]])
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]
    mat = build_symmetric_csx(n, n, rows, cols, vals)
    sh = ShardedCsx(mat, mesh=_mesh(4))
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(sh.matvec(jnp.asarray(x)))
    ref = np.zeros(n)
    np.add.at(ref, rows, vals.astype(np.float64) * x.astype(np.float64)[cols])
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4


# ---------------------------------------------------------------------------
# SpMM: k right-hand sides at once, against the oracle and the columns
# ---------------------------------------------------------------------------
def _mm_matrix(n, rng, runs):
    rows, cols = _bands(n, (0, 3, -2))
    if runs:
        r, c = _hruns(rng, n, n // 8, 8)
        rows.append(r)
        cols.append(c)
    rows.append(rng.integers(0, n, n))
    cols.append(rng.integers(0, n, n))
    return _dedup(np.concatenate(rows), np.concatenate(cols), n, seed=1)


@pytest.mark.parametrize("n,k,runs,dia_min_fill", [
    (8192, 5, False, "0.01"), (8192, 11, True, "0.01"),
    (16384, 6, True, "0.9")])
def test_spmm_vs_oracle_and_columns(n, k, runs, dia_min_fill):
    cfg = Config.instance()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.jax.dia_min_fill", dia_min_fill)
    rng = np.random.default_rng(31 + k)
    rows, cols, vals = _mm_matrix(n, rng, runs)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    X = rng.standard_normal((n, k)).astype(np.float32)
    Y0 = rng.standard_normal((n, k)).astype(np.float32)
    Y = np.asarray(mat.matmat(jnp.asarray(X)))
    Yab = np.asarray(mat.matmat(jnp.asarray(X), alpha=1.7, beta=0.5,
                                Y=jnp.asarray(Y0)))
    ys = np.stack([np.asarray(mat.matvec(jnp.asarray(X[:, j])))
                   for j in range(k)], axis=1)
    ref = np.zeros((n, k))
    np.add.at(ref, rows, vals[:, None].astype(np.float64)
              * X.astype(np.float64)[cols])
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-5
    assert np.abs(Y - ys).max() / np.abs(ref).max() < 1e-5
    refab = 1.7 * ref + 0.5 * Y0
    assert np.abs(Yab - refab).max() / np.abs(refab).max() < 1e-5
