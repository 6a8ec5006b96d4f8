#!/usr/bin/env python
"""Load a MatrixMarket file, tune, run an SpMV kernel loop, report MFLOPS.

Parity with the reference ``src/examples/mmf_example.c``: load -> tune ->
128x ``matvec_kernel`` -> MFLOPS = 2*loops*nnz / (1e6*elapsed)
(ref ``mmf_example.c:74-79``).

    python examples/mmf_example.py [MATRIX.mtx]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx

LOOPS = 128


def main():
    matrix = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "tests", "matrices",
        "test3.mtx.sorted")

    spx.init()
    spx.option_set("spx.preproc.xform", "all")

    inp = spx.input_load_mmf(matrix)
    print(f"loaded {matrix}: {inp.nrows}x{inp.ncols}")

    t0 = time.perf_counter()
    A = spx.mat_tune(inp)
    print(f"tuned in {time.perf_counter() - t0:.3f}s "
          f"(csx size {A.csx.csx_size()} bytes)")

    rng = np.random.default_rng(0)
    x = rng.random(A.ncols)
    y = np.zeros(A.nrows)

    t0 = time.perf_counter()
    for _ in range(LOOPS):
        y = spx.matvec_kernel(1.5, A, x, 0.0, y)
    np.asarray(y)
    elapsed = time.perf_counter() - t0
    mflops = 2.0 * LOOPS * A.nnz / (1e6 * elapsed)
    print(f"{LOOPS} kernels in {elapsed:.4f}s -> {mflops:.1f} MFLOPS")
    print("y[:5] =", np.asarray(y)[:5])


if __name__ == "__main__":
    main()
