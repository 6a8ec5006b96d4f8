#!/usr/bin/env python
"""Matrix caching, part 2: restore and run.

Parity with the reference ``src/examples/matrix_caching_example_p2.c``:
restore the tuned matrix saved by part 1 (re-tracing replaces the
reference's re-JIT from the saved id_map) and run kernels immediately,
skipping preprocessing.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx

CACHE = os.environ.get("SPX_CACHE_FILE", os.path.join(
    tempfile.gettempdir(), "sparsex_jax_cache.npz"))


def main():
    if not os.path.exists(CACHE):
        print(f"run matrix_caching_example_p1.py first ({CACHE} missing)")
        return 1
    spx.init()
    t0 = time.perf_counter()
    A = spx.mat_restore(CACHE)
    print(f"restored in {time.perf_counter() - t0:.3f}s "
          f"({A.nrows}x{A.ncols}, nnz={A.nnz})")

    x = np.random.default_rng(0).random(A.ncols)
    y = spx.matvec_mult(1.0, A, x)
    print("y[:5] =", np.asarray(y)[:5])

    # entries can be inspected and updated on the restored matrix
    rr, cc, _ = A.csx.tocoo()
    r, c = int(rr[0]), int(cc[0])
    print(f"entry ({r},{c}) =", spx.mat_get_entry(A, r, c))
    spx.mat_set_entry(A, r, c, 42.0)
    print(f"entry ({r},{c}) =", spx.mat_get_entry(A, r, c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
