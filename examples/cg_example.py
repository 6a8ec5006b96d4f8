#!/usr/bin/env python
"""Conjugate-gradient solve on symmetric CSX.

The BASELINE configuration's flagship flow: tune a symmetric matrix
(CSX-Sym: lower triangle + diagonal, transposed contributions fused into
the same trace), then run CG entirely on device (`solvers.cg` is a
``lax.while_loop`` — one jit for the whole solve).

    python examples/cg_example.py [N]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx
from sparsex_jax.solvers import cg
from sparsex_jax.symmetric import build_symmetric_csx


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    spx.init()
    spx.option_set("spx.preproc.xform", "all")

    # s.p.d.: diagonally dominant symmetric banded matrix (lower triangle)
    rng = np.random.default_rng(0)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 8.0)]
    for b in (1, 5, 64):
        r = np.arange(b, n)
        rows.append(r)
        cols.append(r - b)
        vals.append(rng.random(r.size))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]

    t0 = time.perf_counter()
    A = build_symmetric_csx(n, n, rows, cols, vals, already_lower=True)
    print(f"tuned {n}x{n} (lower nnz={rows.size}) "
          f"in {time.perf_counter() - t0:.2f}s")

    import jax
    b = rng.standard_normal(n)
    # jit the whole solve so the warm call hits the compile cache
    solve = jax.jit(lambda bv: cg(lambda v: A.matvec(v), bv,
                                  tol=1e-8, maxiter=2000))
    x, iters, res = solve(b)
    np.asarray(x)  # compile + first run
    t0 = time.perf_counter()
    x, iters, res = solve(b)
    np.asarray(x)
    dt = time.perf_counter() - t0
    print(f"CG converged in {int(iters)} iterations, "
          f"residual {float(res):.2e}, {dt:.3f}s warm "
          f"({int(iters) / max(dt, 1e-9):.0f} it/s)")

    # verify
    r = b - np.asarray(A.matvec(x))
    print("||b - Ax|| / ||b|| =",
          float(np.linalg.norm(r) / np.linalg.norm(b)))


if __name__ == "__main__":
    main()
