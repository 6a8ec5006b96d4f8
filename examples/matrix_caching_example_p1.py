#!/usr/bin/env python
"""Matrix caching, part 1: tune and save.

Parity with the reference ``src/examples/matrix_caching_example_p1.c``:
tune a matrix (the expensive preprocessing step) and save the result so a
later process can skip it (see ``matrix_caching_example_p2.py``).
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx

CACHE = os.environ.get("SPX_CACHE_FILE", os.path.join(
    tempfile.gettempdir(), "sparsex_jax_cache.npz"))


def main():
    matrix = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "tests", "matrices",
        "test3.mtx.sorted")
    spx.init()
    spx.option_set("spx.preproc.xform", "all")

    t0 = time.perf_counter()
    A = spx.mat_tune(spx.input_load_mmf(matrix))
    print(f"tuned in {time.perf_counter() - t0:.3f}s")

    spx.mat_save(A, CACHE)
    print(f"saved tuned matrix to {CACHE} "
          f"({os.path.getsize(CACHE)} bytes)")


if __name__ == "__main__":
    main()
