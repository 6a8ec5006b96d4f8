"""Device execution of CSX tables (single-device executor).

The JAX replacement for the reference JIT subsystem (``include/sparsex/
internals/CsxJit.hpp:59-107``, ``src/templates/*.c``): instead of
Clang/LLVM-compiling a specialized C routine per thread from the set of
encoded patterns, the set of tables present *is* the specialization — the
jitted function's trace contains exactly one vectorized kernel per table
(see ``ops/kernels.py`` for the kernel classes).

The jitted function takes the table arrays as arguments (a pytree), so the
compiled executable is cached per table *signature* (shapes + static
pattern metadata), mirroring how the reference caches one compiled routine
per pattern set.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from sparsex_jax.ops.kernels import local_contrib, static_meta, tables_to_arrays
from sparsex_jax.preprocess.tables import CsxTables

# Re-exported for backward compatibility.
_static_meta = static_meta


@functools.lru_cache(maxsize=128)
def _compiled(meta: Tuple, dtype_str: str, apply_alpha: bool = True,
              apply_beta: bool = True):
    """Build + jit the executor for one static table signature.

    ``apply_alpha``/``apply_beta`` elide the epilogue when the dispatcher
    knows alpha == 1 / beta == 0: the generic ``alpha*acc + beta*y0``
    costs three extra full passes over y.
    """
    import jax

    nrows, ncols = meta[0], meta[1]

    def fn(arrs, x, alpha, beta, y0):
        acc, _ = local_contrib(meta, arrs, x, nrows_part=nrows, ncols=ncols)
        if apply_alpha:
            acc = alpha * acc
        if apply_beta:
            acc = acc + beta * y0
        return acc

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _compiled_multi(metas: Tuple, dtype_str: str):
    """One jitted program covering ALL shards of a single-device matrix.

    The reference releases its thread pool once per kernel call
    (``MatVecKernel`` barriers, ``CsxKernels.cpp:35-55``); the analogue of
    that single synchronized dispatch is one XLA program that evaluates
    every shard's kernel composition and concatenates — instead of one
    dispatch per shard from Python.
    """
    import jax
    import jax.numpy as jnp

    def fn(arrs_list, x, alpha, beta, y0):
        parts = []
        for meta, arrs in zip(metas, arrs_list):
            acc, _ = local_contrib(meta, arrs, x, nrows_part=meta[0],
                                   ncols=meta[1])
            parts.append(acc)
        acc = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return alpha * acc + beta * y0

    return jax.jit(fn)


class CsxExecutor:
    """Callable SpMV/SpMM executor for one encoded partition."""

    def __init__(self, tables: CsxTables):
        self.tables = tables
        self.meta = static_meta(tables)
        self.arrays = tables_to_arrays(tables)
        self._dtype = str(np.dtype(tables.delta.vals.dtype)
                          if tables.delta is not None else "float64")
        self._dev = None
        self._tracing = False

    def _device(self):
        """Device-resident copy of the table arrays (transferred once).

        Passing host numpy into the jitted call would re-upload the tables
        on EVERY invocation (JAX does not dedupe numpy args) — the device
        copy is the per-device memory placement the reference gets from
        NUMA onnode allocation (``numa_util.c``).  Inside an ambient user
        trace the host arrays are returned directly (embedded as
        constants); caching there would leak tracers."""
        import jax
        if self._dev is not None:
            return self._dev
        if self._tracing:
            return self.arrays
        self._dev = jax.device_put(self.arrays)
        return self._dev

    def invalidate_value_caches(self) -> None:
        """Drop the device-resident copy; the plain HOST arrays are views
        of the tables and stay current.  Called by ``CsxMatrix.set_entry``
        so value writes stay O(1) + a lazy re-upload."""
        self._dev = None

    def __call__(self, x, alpha=1.0, beta=0.0, y=None):
        import jax
        import jax.numpy as jnp
        x = jnp.asarray(x)
        # under an ambient user trace, skip the device-copy caching
        self._tracing = isinstance(x, jax.core.Tracer)
        arrays = self._device()
        shape = self.meta[0] if x.ndim == 1 else (self.meta[0], x.shape[1])
        # dispatch-time epilogue elision: alpha/beta arrive as Python
        # scalars on the hot API path
        apply_alpha = not (isinstance(alpha, (int, float))
                           and float(alpha) == 1.0)
        apply_beta = not (y is None or (isinstance(beta, (int, float))
                                        and float(beta) == 0.0))
        y0 = (jnp.zeros(shape, dtype=x.dtype)
              if y is None else jnp.asarray(y))
        fn = _compiled(self.meta, self._dtype, apply_alpha=apply_alpha,
                       apply_beta=apply_beta)
        return fn(arrays, x, x.dtype.type(alpha), x.dtype.type(beta), y0)
