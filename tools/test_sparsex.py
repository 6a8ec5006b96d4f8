#!/usr/bin/env python
"""API integration test — ``test_sparsex`` parity.

Mirrors the reference integration test binary (``test/src/sparsex_test.c``):
load an MMF, tune (optionally reorder), random x, LOOPS x ``matvec_mult``,
compare against the serial CSR oracle built from the same file at 1e-6
relative tolerance (ref ``test/src/CsxCheck.cpp:28-53``,
``src/internals/Vector.cpp:51-56``).

    python tools/test_sparsex.py MATRIX.mtx [-o key=value]... [-r] [-t]

``-o`` sets runtime options by mnemonic (like ``spx_option_set``), ``-r``
enables RCM reordering, ``-t`` prints timing/MFLOPS.  Exit code 0 on PASS,
1 on numerical FAILURE, 2 on usage/load errors — never a signal.
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

LOOPS = int(os.environ.get("LOOPS", "128"))
TOLERANCE = 1e-6  # ref src/internals/Vector.cpp:51-56


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrix")
    ap.add_argument("-o", "--option", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("-r", "--reorder", action="store_true")
    ap.add_argument("-t", "--timing", action="store_true")
    args = ap.parse_args(argv)

    import sparsex_jax as spx
    from sparsex_jax.errors import SparsexError
    from sparsex_jax.ops.oracle import coo_spmv, max_rel_error

    spx.init()
    try:
        for opt in args.option:
            key, _, value = opt.partition("=")
            spx.option_set(key, value)

        inp = spx.input_load_mmf(args.matrix)
        # Oracle COO straight from the file (mirrored when symmetric).
        cfg = spx.config.Config.instance()
        from sparsex_jax.io.mmf import load_mmf
        oracle = load_mmf(args.matrix, keep_lower=False)
        nrows, ncols = oracle.nrows, oracle.ncols

        t0 = time.perf_counter()
        mat = spx.mat_tune(inp, *( [spx.OP_REORDER] if args.reorder else [] ))
        pt = time.perf_counter() - t0
    except SparsexError as e:
        print(f"LOAD/TUNE ERROR: {e}", file=sys.stderr)
        return 2

    rng = np.random.default_rng(0)
    x = rng.random(ncols).astype(cfg.value_dtype)
    x_run = x
    perm = mat.permutation
    if perm is not None:
        from sparsex_jax.ops import vector as vec
        x_run = vec.reorder(x, perm)

    t0 = time.perf_counter()
    for _ in range(LOOPS):
        y = spx.matvec_mult(2.0, mat, x_run)
    y = np.asarray(y, dtype=np.float64)
    secs = time.perf_counter() - t0
    if perm is not None:
        from sparsex_jax.ops import vector as vec
        y = np.asarray(vec.inv_reorder(y, perm), dtype=np.float64)

    want = coo_spmv(nrows, *oracle.tocoo(), x, alpha=2.0)
    err = max_rel_error(y, want)
    if args.timing:
        mflops = 2.0 * LOOPS * oracle.nnz / (1e6 * secs)
        print(f"m:{os.path.basename(args.matrix)} pt:{pt:.3f} t:{secs:.4f} "
              f"r:{mflops:.1f} MFLOPS")
    if err <= TOLERANCE:
        print(f"PASSED (rel_err={err:.2e})")
        return 0
    print(f"FAILED (rel_err={err:.2e} > {TOLERANCE})")
    return 1


if __name__ == "__main__":
    sys.exit(main())
