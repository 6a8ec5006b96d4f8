#!/usr/bin/env python
"""SpGEMM example: C = A @ B as a new tuned matrix.

The reference library stops at SpMV; SpGEMM is part of this build's
north star.  The symbolic work (structure of C) runs once on the host;
the result is a regular tuned CsxMatrix, so downstream SpMV/SpMM runs on
the full device execution classes.

Run: python examples/spgemm_example.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sparsex_jax.csx import CsxMatrix  # noqa: E402
from sparsex_jax.ops.spgemm import spgemm  # noqa: E402


def main():
    rng = np.random.default_rng(0)
    n = 2048

    def random_mat(seed, m):
        r = rng.integers(0, n, m)
        c = rng.integers(0, n, m)
        _, u = np.unique(r * n + c, return_index=True)
        r, c = r[u], c[u]
        o = np.lexsort((c, r))
        return CsxMatrix.from_coo(
            n, n, r[o], c[o], rng.standard_normal(r.size)), (r[o], c[o])

    A, _ = random_mat(1, 20000)
    B, _ = random_mat(2, 20000)
    C = spgemm(A, B)
    print(f"A: {A.nnz} nnz, B: {B.nnz} nnz -> C = A@B: {C.nnz} nnz "
          f"({C.csx_size() / 1e3:.0f} kB compressed)")

    # C is a first-class tuned matrix: SpMV on it directly
    x = rng.standard_normal(n)
    y = np.asarray(C.matvec(x))
    y2 = np.asarray(A.matvec(B.matvec(x)))
    print(f"check |C x - A (B x)| = {np.abs(y - y2).max():.2e}")


if __name__ == "__main__":
    main()
