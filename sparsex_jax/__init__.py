"""sparsex_jax — a sparse linear-algebra framework in JAX.

Re-implements the capabilities of SparseX (cslab-ntua/sparsex) — the CSX
compressed sparse format with substructure mining and per-pattern specialized
SpMV kernels — designed from scratch for accelerators with JAX/XLA.

Public API parity map (reference ``include/sparsex/sparsex.h``):

- matrix/vector ops (``include/sparsex/matvec.h``)  -> :mod:`sparsex_jax.api`
- init/logging       (``include/sparsex/common.h``) -> :mod:`sparsex_jax.api`,
  :mod:`sparsex_jax.logger`
- errors             (``include/sparsex/error.h``)  -> :mod:`sparsex_jax.errors`
- timing             (``include/sparsex/timing.h``) -> :mod:`sparsex_jax.timing`
"""

from sparsex_jax.config import Config, option_set, option_get, options_set_from_env
from sparsex_jax.errors import SparsexError, ErrorCode, set_error_handler
from sparsex_jax import timing
from sparsex_jax.api import (
    OP_REORDER,
    INDEX_ZERO_BASED,
    INDEX_ONE_BASED,
    init,
    finalize,
    input_load_csr,
    input_load_mmf,
    input_destroy,
    mat_tune,
    mat_get_entry,
    mat_set_entry,
    mat_save,
    mat_restore,
    mat_get_partition,
    mat_destroy,
    matvec_mult,
    matvec_kernel,
    matvec_kernel_csr,
    matvec_kernel_csr_invalidate,
    matmat_mult,
    matmat_kernel,
    spgemm,
    partition_csr,
    Matrix,
    Input,
    Partition,
)
from sparsex_jax.ops import vector as vec
from sparsex_jax import api, config

__version__ = "0.1.0"

__all__ = [
    "Config", "option_set", "option_get", "options_set_from_env",
    "SparsexError", "ErrorCode", "set_error_handler",
    "timing", "vec",
    "OP_REORDER", "INDEX_ZERO_BASED", "INDEX_ONE_BASED",
    "init", "finalize",
    "input_load_csr", "input_load_mmf", "input_destroy",
    "mat_tune", "mat_get_entry", "mat_set_entry", "mat_save", "mat_restore",
    "mat_get_partition", "mat_destroy",
    "matvec_mult", "matvec_kernel", "matvec_kernel_csr",
    "matvec_kernel_csr_invalidate", "matmat_mult", "matmat_kernel",
    "spgemm",
    "partition_csr",
    "Matrix", "Input", "Partition",
]
