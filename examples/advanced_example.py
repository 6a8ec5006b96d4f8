#!/usr/bin/env python
"""Vector tuning and runtime options.

Parity with the reference ``src/examples/advanced_example.c``: create
vectors from user buffers in AS_IS vs TUNE mode (``SPX_VEC_TUNE`` re-places
the buffer for the tuned layout; here TUNE copies into a device-shardable
array), set runtime options by mnemonic, and run kernels.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx
from sparsex_jax.ops import vector as vec


def main():
    matrix = os.path.join(os.path.dirname(__file__), "..", "tests",
                          "matrices", "test2.mtx.sorted")
    spx.init()
    # runtime options by mnemonic (ref spx_option_set, matvec.c:753-761)
    spx.option_set("spx.rt.nr_threads", "2")
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.preproc.sampling", "none")

    A = spx.mat_tune(spx.input_load_mmf(matrix))

    # user buffers wrapped AS_IS vs TUNE-copied (ref SPX_VEC_TUNE)
    xbuf = np.random.default_rng(0).random(A.ncols)
    ybuf = np.zeros(A.nrows)
    x = vec.create_from_buff(xbuf, copy=False)   # SPX_VEC_AS_IS
    y = vec.create_from_buff(ybuf, copy=True)    # SPX_VEC_TUNE

    y = spx.matvec_kernel(0.7, A, x, 0.2, y)

    # vector algebra (spx_vec_*)
    norm = float(vec.mul(y, y)) ** 0.5
    y2 = vec.scale(y, 1.0 / norm)
    print("||y|| =", norm)
    print("normalized y[:4] =", np.asarray(y2)[:4])
    print("compare(y, y) ->", vec.compare(np.asarray(y), np.asarray(y)))


if __name__ == "__main__":
    main()
