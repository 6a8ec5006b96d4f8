#!/usr/bin/env python
"""RCM reordering, with a symmetric matrix.

Parity with the reference ``src/examples/reordering_example.c``: tune with
``OP_REORDER`` (RCM bandwidth reduction), then run kernels on the permuted
matrix — input/output vectors are permuted with ``vec.reorder`` /
``vec.inv_reorder`` like the reference example.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx
from sparsex_jax.ops import vector as vec
from sparsex_jax.ops.oracle import coo_spmv, max_rel_error


def main():
    matrix = os.path.join(os.path.dirname(__file__), "..", "tests",
                          "matrices", "symmetric.mtx.sorted")
    spx.init()
    spx.option_set("spx.matrix.symmetric", "true")
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.log.level", "info")  # prints the bandwidth change

    A = spx.mat_tune(spx.input_load_mmf(matrix), spx.OP_REORDER)

    x = np.random.default_rng(0).random(A.ncols)
    x_perm = vec.reorder(x, A.permutation)
    y_perm = spx.matvec_mult(1.0, A, x_perm)
    y = np.asarray(vec.inv_reorder(np.asarray(y_perm), A.permutation))

    # check vs the unpermuted oracle
    from sparsex_jax.io.mmf import load_mmf
    oracle = load_mmf(matrix)
    want = coo_spmv(oracle.nrows, *oracle.tocoo(), x)
    print("rel err vs oracle:", max_rel_error(y, want))
    print("y[:5] =", y[:5])


if __name__ == "__main__":
    main()
