"""The 15 named driver tests — ``test-sparsex.sh`` parity.

Mirrors the reference test driver (``test/scripts/test-sparsex.sh.in:40-56,
199-222``): 13 option-combination runs of the integration test plus two
expected-failure runs that must fail *gracefully* (no signal/crash —
here: a SparsexError, not an unhandled exception).  Each run drives the
full API (load MMF -> tune -> 128x matvec_mult -> compare vs CSR oracle at
1e-6), via the same code path as ``tools/test_sparsex.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
MAT = os.path.join(HERE, "matrices")
ROOT = os.path.dirname(HERE)

DEMOPATT = os.path.join(MAT, "demopatt.mtx.sorted")
DEMOPATT_UNSORTED = os.path.join(MAT, "demopatt.mtx.unsorted")
SYMMETRIC = os.path.join(MAT, "symmetric.mtx.sorted")
SYM_SPARSE = os.path.join(MAT, "symmetric-very-sparse.mtx.sorted")
TEST3 = os.path.join(MAT, "test3.mtx.sorted")

# (name, matrix, options, reorder) — ref test-sparsex.sh.in:40-56
DRIVER_TESTS = [
    ("deltas_only", DEMOPATT, {"spx.preproc.xform": "none"}, False),
    ("horizontal", DEMOPATT, {"spx.preproc.xform": "h"}, False),
    ("vertical", DEMOPATT, {"spx.preproc.xform": "v"}, False),
    ("all", DEMOPATT, {"spx.preproc.xform": "all"}, False),
    ("all_sampling", TEST3, {"spx.preproc.xform": "all",
                             "spx.preproc.sampling": "portion",
                             "spx.preproc.sampling.portion": "0.5",
                             "spx.preproc.sampling.nr_samples": "4"}, False),
    ("all_mt", DEMOPATT, {"spx.preproc.xform": "all",
                          "spx.rt.nr_threads": "2"}, False),
    ("all_mt_sampling", TEST3, {"spx.preproc.xform": "all",
                                "spx.rt.nr_threads": "2",
                                "spx.preproc.sampling": "portion",
                                "spx.preproc.sampling.portion": "0.5"},
     False),
    ("symmetric_all", SYMMETRIC, {"spx.preproc.xform": "all",
                                  "spx.matrix.symmetric": "true"}, False),
    ("symmetric_reordering", SYMMETRIC, {"spx.preproc.xform": "all",
                                         "spx.matrix.symmetric": "true"},
     True),
    ("symmetric_very_sparse", SYM_SPARSE, {"spx.preproc.xform": "all",
                                           "spx.matrix.symmetric": "true"},
     False),
    ("symmetric_sampling", SYMMETRIC, {"spx.preproc.xform": "all",
                                       "spx.matrix.symmetric": "true",
                                       "spx.preproc.sampling": "portion",
                                       "spx.preproc.sampling.portion": "0.5"},
     False),
    ("symmetric_mt", SYMMETRIC, {"spx.preproc.xform": "all",
                                 "spx.matrix.symmetric": "true",
                                 "spx.rt.nr_threads": "2"}, False),
    ("symmetric_mt_sampling", SYMMETRIC,
     {"spx.preproc.xform": "all", "spx.matrix.symmetric": "true",
      "spx.rt.nr_threads": "2", "spx.preproc.sampling": "portion",
      "spx.preproc.sampling.portion": "0.5"}, False),
]


def run_one(matrix, options, reorder):
    import sparsex_jax as spx
    from sparsex_jax.io.mmf import load_mmf
    from sparsex_jax.ops import vector as vec
    from sparsex_jax.ops.oracle import coo_spmv, max_rel_error

    for k, v in options.items():
        spx.option_set(k, v)
    inp = spx.input_load_mmf(matrix)
    oracle = load_mmf(matrix, keep_lower=False)
    mat = spx.mat_tune(inp, *([spx.OP_REORDER] if reorder else []))
    rng = np.random.default_rng(0)
    x = rng.random(oracle.ncols)
    x_run = vec.reorder(x, mat.permutation) if mat.permutation is not None \
        else x
    for _ in range(16):
        y = spx.matvec_mult(2.0, mat, x_run)
    y = np.asarray(y, dtype=np.float64)
    if mat.permutation is not None:
        y = np.asarray(vec.inv_reorder(y, mat.permutation))
    want = coo_spmv(oracle.nrows, *oracle.tocoo(), x, alpha=2.0)
    return max_rel_error(y, want)


@pytest.mark.parametrize("name,matrix,options,reorder",
                         DRIVER_TESTS, ids=[t[0] for t in DRIVER_TESTS])
def test_driver(name, matrix, options, reorder):
    err = run_one(matrix, options, reorder)
    assert err <= 1e-6, f"{name}: rel_err {err}"


# --- the two expected-failure tests (ref test-sparsex.sh.in:199-222) ------

def test_symmetric_flag_on_unsymmetric_input_fails_gracefully():
    import sparsex_jax as spx
    from sparsex_jax.errors import SparsexError
    spx.option_set("spx.matrix.symmetric", "true")
    with pytest.raises(SparsexError):
        inp = spx.input_load_mmf(DEMOPATT)
        spx.mat_tune(inp)


def test_unsorted_mmf_fails_gracefully():
    import sparsex_jax as spx
    from sparsex_jax.errors import SparsexError
    with pytest.raises(SparsexError):
        spx.input_load_mmf(DEMOPATT_UNSORTED)


# --- the driver tool end-to-end (subprocess, checks exit codes/signals) ---

@pytest.mark.parametrize("args,want", [
    ([DEMOPATT, "-o", "spx.preproc.xform=all", "-t"], 0),
    ([DEMOPATT_UNSORTED], 2),
    ([SYMMETRIC, "-o", "spx.matrix.symmetric=true",
      "-o", "spx.preproc.xform=all"], 0),
])
def test_tool_exit_codes(args, want):
    env = dict(os.environ, JAX_PLATFORMS="cpu", LOOPS="4")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "test_sparsex.py")]
        + args, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == want, (proc.stdout, proc.stderr)
    assert proc.returncode >= 0, "killed by signal"
