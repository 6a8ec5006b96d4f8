#!/usr/bin/env python
"""End-to-end soak: every major execution path on the current backend.

Runs mixed-structure SpMV, symmetric, sharded (replicated + halo), SpMM,
SpGEMM, CG, save/restore — each against an independent oracle
at the dtype's tolerance.  Exit code 0 = all green.  Used at the end of a
build round on the real chip; also runs on CPU.

    python tools/soak.py [--n 262144] [--nnz 2400000]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sparsex_jax.platform import (  # noqa: E402
    enable_compile_cache, honor_jax_platforms_env)

honor_jax_platforms_env()  # JAX_PLATFORMS=cpu pins the backend
enable_compile_cache()


def check(tag, got, want, tol):
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max() / (
        np.abs(want).max() + 1e-30)
    status = "ok" if err < tol else "FAIL"
    print(f"  {tag:34s} rel_err={err:.2e}  [{status}]")
    return err < tol


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--nnz", type=int, default=2_400_000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.ops.spgemm import spgemm
    from sparsex_jax.parallel.shard import ShardedCsx
    from sparsex_jax.persist import restore_csx, save_csx
    from sparsex_jax.solvers import block_cg, cg
    from sparsex_jax.symmetric import build_symmetric_csx

    print(f"backend: {jax.default_backend()}  devices: {len(jax.devices())}")
    cfg = Config.reset()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    tol = 5e-4  # f32 accumulation across millions of terms
    ok = True
    n, m = args.n, args.nnz
    rng = np.random.default_rng(0)

    # mixed structure: diagonals + h-runs + blocks + randoms
    rows_l = [np.arange(n), np.arange(n - 1)]
    cols_l = [np.arange(n), np.arange(1, n)]
    hr = rng.integers(0, n, m // 40)
    hc = rng.integers(0, n - 8, m // 40)
    rows_l.append(np.repeat(hr, 8))
    cols_l.append((hc[:, None] + np.arange(8)[None]).ravel())
    br0 = rng.integers(0, (n - 4) // 4, m // 64) * 4
    bc0 = rng.integers(0, (n - 2) // 2, m // 64) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    rows_l.append((br0[:, None, None] + ii[None]).ravel())
    cols_l.append((bc0[:, None, None] + jj[None]).ravel())
    rows_l.append(rng.integers(0, n, m // 4))
    cols_l.append(rng.integers(0, n, m // 4))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    _, u = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = (rng.standard_normal(rows.size) * 0.1).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    ref = np.zeros(n, np.float64)
    np.add.at(ref, rows, vals.astype(np.float64) * x[cols])

    t0 = time.perf_counter()
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    print(f"mixed matrix {n}x{n} nnz={rows.size} pt={time.perf_counter()-t0:.1f}s")
    ok &= check("single-chip SpMV", mat.matvec(jnp.asarray(x)), ref, tol)

    # SpMM
    X = rng.standard_normal((n, 4)).astype(np.float32)
    refM = np.zeros((n, 4))
    np.add.at(refM, rows, vals[:, None].astype(np.float64) * X[cols])
    ok &= check("SpMM k=4", mat.matmat(jnp.asarray(X)), refM, tol)

    # save/restore
    save_csx(mat, "/tmp/soak_cache.npz")
    mat2, _ = restore_csx("/tmp/soak_cache.npz")
    ok &= check("restore SpMV", mat2.matvec(jnp.asarray(x)),
                ref, tol)

    # sharded: replicated + halo (as many shards as devices, min 1)
    ndev = min(4, len(jax.devices()))
    cfg.set("spx.rt.nr_threads", str(ndev))
    matS = CsxMatrix.from_coo(n, n, rows, cols, vals)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("shards",))
    cfg.set("spx.jax.x_mode", "replicated")
    ok &= check(f"sharded x{ndev} replicated",
                ShardedCsx(matS, mesh=mesh).matvec(jnp.asarray(x)), ref, tol)
    cfg.set("spx.jax.x_mode", "halo")
    sh = ShardedCsx(matS, mesh=mesh)
    ok &= check(f"sharded x{ndev} halo(k={sh.halo_k})",
                sh.matvec(jnp.asarray(x)), ref, tol)
    cfg.set("spx.jax.x_mode", "auto")
    cfg.set("spx.rt.nr_threads", "1")

    # symmetric
    r2 = rng.integers(0, n, m // 4)
    c2 = rng.integers(0, n, m // 4)
    sr, sc = np.maximum(r2, c2), np.minimum(r2, c2)
    sr = np.concatenate([sr, np.arange(n)])
    sc = np.concatenate([sc, np.arange(n)])
    _, u = np.unique(sr.astype(np.int64) * n + sc, return_index=True)
    sr, sc = sr[u], sc[u]
    o = np.lexsort((sc, sr))
    sr, sc = sr[o], sc[o]
    sv = (rng.standard_normal(sr.size) * 0.1).astype(np.float32)
    sym = build_symmetric_csx(n, n, sr, sc, sv, already_lower=True)
    refS = np.zeros(n, np.float64)
    np.add.at(refS, sr, sv.astype(np.float64) * x[sc])
    low = sr != sc
    np.add.at(refS, sc[low], sv[low].astype(np.float64) * x[sr[low]])
    ok &= check("symmetric SpMV", sym.matvec(jnp.asarray(x)), refS, tol)

    # CG on an s.p.d. system
    nn = 1 << 14
    rr = np.concatenate([np.arange(nn), np.arange(nn - 1), np.arange(1, nn)])
    cc = np.concatenate([np.arange(nn), np.arange(1, nn), np.arange(nn - 1)])
    vv = np.concatenate([np.full(nn, 4.0), np.full(nn - 1, -1.0),
                         np.full(nn - 1, -1.0)]).astype(np.float32)
    o = np.lexsort((cc, rr))
    spd = CsxMatrix.from_coo(nn, nn, rr[o], cc[o], vv[o])
    b = rng.standard_normal(nn).astype(np.float32)
    xs, iters, res = cg(lambda v: spd.matvec(v), jnp.asarray(b), tol=1e-6)
    Ax = np.asarray(spd.matvec(xs))
    ok &= check(f"CG ({int(iters)} iters)", Ax, b.astype(np.float64), 1e-3)
    Xb, itb, _ = block_cg(lambda P: spd.matmat(P),
                          jnp.asarray(np.tile(b[:, None], (1, 3))), tol=1e-6)
    ok &= check(f"block-CG ({int(itb)} iters)",
                np.asarray(spd.matmat(Xb))[:, 0], b.astype(np.float64), 1e-3)

    # SpGEMM on a small slice
    ns = 4096
    sel = (rows < ns) & (cols < ns)
    A = CsxMatrix.from_coo(ns, ns, rows[sel], cols[sel], vals[sel])
    C = spgemm(A, A)
    xs2 = rng.standard_normal(ns).astype(np.float32)
    ok &= check("SpGEMM (C x vs A(A x))", C.matvec(jnp.asarray(xs2)),
                np.asarray(A.matvec(A.matvec(jnp.asarray(xs2))),
                           dtype=np.float64), 1e-3)

    print("SOAK", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
