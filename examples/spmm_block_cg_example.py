"""SpMM + block-CG example.

Multi-RHS extension of the reference's CG workflow (the reference API
stops at single vectors, ``include/sparsex/matvec.h``): one SpMM per
iteration amortizes the sparse index loads over all right-hand sides —
the win of the k axis.

Run: python examples/spmm_block_cg_example.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import sparsex_jax as spx  # noqa: E402
from sparsex_jax.csx import CsxMatrix  # noqa: E402
from sparsex_jax.solvers import block_cg  # noqa: E402


def main():
    n, k = 4096, 8
    # s.p.d. 2-D Poisson-like pentadiagonal system
    rows, cols, vals = [], [], []
    for off, v in ((0, 4.0), (1, -1.0), (-1, -1.0), (64, -1.0), (-64, -1.0)):
        r = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(r.size, v))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    spx.option_set("spx.preproc.xform", "all")
    A = CsxMatrix.from_coo(n, n, rows, cols, vals)
    B = np.random.default_rng(0).standard_normal((n, k))

    X, iters, res = block_cg(lambda P: A.matmat(P), B, tol=1e-8)
    X = np.asarray(X)
    print(f"block-CG: {k} systems solved in {int(iters)} iterations; "
          f"max residual {float(np.max(np.asarray(res))):.2e}")

    # verify against one SpMM
    R = B - np.asarray(A.matmat(X))
    print(f"check: max |B - A X| = {np.abs(R).max():.2e}")


if __name__ == "__main__":
    main()
