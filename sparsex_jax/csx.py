"""CsxMatrix: the tuned matrix handle.

Plays the role of the reference's ``spm_mt`` + per-thread ``CsxMatrix``
(``include/sparsex/internals/SpmMt.hpp:31-63``, ``Csx.hpp:29-81``) and the
build orchestration of ``BuildCsx`` (``include/sparsex/internals/
CsxBuild.hpp:290-341``): nnz-balanced row partitioning into shards, one
encoding pipeline per shard, and one trace-time-specialized executor per
shard (the reference JITs one SpMV routine per thread).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from sparsex_jax.config import Config
from sparsex_jax.errors import ErrorCode, seterror, setwarning
from sparsex_jax.logger import log_info
from sparsex_jax.ops.exec import CsxExecutor
from sparsex_jax.parallel.partition import (
    RowPartition, row_counts_from_coo, split_rows_by_nnz,
)
from sparsex_jax.preprocess.encoder import Encoder
from sparsex_jax.preprocess.mining import is_sorted_rc, lexsort_rc, take1
from sparsex_jax.preprocess.tables import CsxTables
from sparsex_jax.preprocess.xform import run_step
from sparsex_jax.timing import TimerCollection


@dataclass
class CsxMatrix:
    nrows: int
    ncols: int
    nnz: int
    symmetric: bool = False
    shards: List[CsxTables] = field(default_factory=list)
    executors: List[CsxExecutor] = field(default_factory=list)
    partition: Optional[RowPartition] = None
    permutation: Optional[np.ndarray] = None
    timers: TimerCollection = field(default_factory=TimerCollection)

    # ------------------------------------------------------------------
    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 config: Optional[Config] = None,
                 permutation: Optional[np.ndarray] = None) -> "CsxMatrix":
        """Tune: partition + mine + encode + build executors
        (``spx_mat_tune`` parity, ref ``src/api/matvec.c:259``)."""
        cfg = config or Config.instance()
        if cfg._typed("spx.jax.host_malloc_tune"):
            from sparsex_jax.platform import tune_host_allocator
            tune_host_allocator()   # recycle big host temporaries (see doc)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=cfg.value_dtype)

        mat = cls(nrows=int(nrows), ncols=int(ncols), nnz=int(rows.size),
                  permutation=permutation)
        mat.timers.start_timer("preproc")

        nparts = max(1, cfg.nr_threads)
        part = split_rows_by_nnz(row_counts_from_coo(rows, nrows), nparts)
        mat.partition = part

        if not is_sorted_rc(rows, cols):
            # MMF/CSR inputs usually arrive row-major already; the check
            # is 2 passes vs a full radix sort + 3 random permutes
            order = lexsort_rc(rows, cols)
            rows, cols = take1(rows, order), take1(cols, order)
            vals = take1(vals, order)
        bounds = np.searchsorted(rows, part.row_start + [nrows])

        # Per-shard encoding fans out over a thread pool, mirroring the
        # reference's PreprocessThread-per-partition design
        # (``CsxBuild.hpp:290-341``); the hot loops are native C++ and
        # NumPy, which release the GIL, so pt stays ~flat in shard count.
        def _encode(i):
            lo, hi = bounds[i], bounds[i + 1]
            r0 = part.row_start[i]
            enc = Encoder(part.row_end[i] - r0, ncols,
                          rows[lo:hi] - r0, cols[lo:hi], vals[lo:hi],
                          config=cfg)
            enc.encode()
            tables = enc.finalize(row_start=r0)
            return i, lo, hi, r0, enc, tables

        if nparts == 1:
            results = [_encode(0)]
        else:
            from concurrent.futures import ThreadPoolExecutor
            import os as _os
            workers = min(nparts, max(1, _os.cpu_count() or 1))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(_encode, range(nparts)))
        for i, lo, hi, r0, enc, tables in results:
            mat.shards.append(tables)
            mat.executors.append(CsxExecutor(tables))
            log_info("shard %d: rows [%d,%d) nnz=%d encodings=%s "
                     "csx_size=%dB", i, r0, part.row_end[i], hi - lo,
                     ",".join(enc.encoding_log) or "none",
                     tables.csx_size())
        mat.timers.pause_timer("preproc")
        return mat

    # ------------------------------------------------------------------
    def matvec(self, x, alpha=1.0, beta=0.0, y=None):
        """y = alpha*A*x + beta*y (``spx_matvec_kernel`` semantics,
        ref ``src/api/matvec.c:586``)."""
        import jax.numpy as jnp
        x = jnp.asarray(x)
        if x.shape[0] != self.ncols:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"x has {x.shape[0]} entries, expected {self.ncols}")
        if y is not None and np.shape(y)[0] != self.nrows:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"y has {np.shape(y)[0]} entries, expected {self.nrows}")
        if len(self.shards) == 1 or x.ndim == 2:
            parts = []
            for tables, ex in zip(self.shards, self.executors):
                r0 = tables.row_start
                y_part = None
                if y is not None:
                    y_part = jnp.asarray(y)[r0: r0 + tables.nrows]
                parts.append(ex(x, alpha=alpha, beta=beta, y=y_part))
            return jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        # multi-shard 1-D: ONE jitted program for all shards (the
        # reference's single synchronized kernel dispatch,
        # CsxKernels.cpp:35-55) instead of a Python loop of dispatches.
        from sparsex_jax.ops.exec import _compiled_multi
        import jax
        tracing = isinstance(x, jax.core.Tracer)
        arrs_list = []
        for ex in self.executors:
            ex._tracing = tracing
            arrs_list.append(ex._device())
        fn = _compiled_multi(tuple(ex.meta for ex in self.executors),
                             str(x.dtype))
        y0 = (jnp.zeros(self.nrows, dtype=x.dtype) if y is None
              else jnp.asarray(y))
        return fn(arrs_list, x, x.dtype.type(alpha), x.dtype.type(beta),
                  y0)

    def mult(self, x, alpha=1.0):
        """y = alpha*A*x (``spx_matvec_mult`` parity: y zeroed first)."""
        return self.matvec(x, alpha=alpha, beta=0.0)

    def measure_load_imbalance(self, x=None, loops: int = 32):
        """Measured per-shard kernel seconds and ``(max-min)/min``.

        Parity with the reference's per-thread ``spm_mt_thread_t.secs``
        report (``include/sparsex/internals/SpmMt.hpp:31-63``,
        ``test/src/SpmvTest.cpp:35-60``) — here each shard's executor is
        timed separately with a chained two-point slope (which cancels
        the dispatch and host-sync constants).  Logged at INFO as the runtime complement of the static nnz-based
        ``parallel.partition.load_imbalance``.
        """
        import time

        import jax
        import jax.numpy as jnp

        if x is None:
            dt = (self.shards[0].delta.vals.dtype
                  if self.shards[0].delta is not None else np.float32)
            x = np.random.default_rng(0).standard_normal(
                self.ncols).astype(dt)
        x = jnp.asarray(x)

        def _sync(a):
            return float(np.asarray(a).ravel()[0])

        secs = []
        for ex in self.executors:
            def make(k, ex=ex):
                def run():
                    def body(c, _):
                        # chained with a data dependency so nothing can
                        # be elided; lax.scan keeps the trace size
                        # constant in `loops` (bench.py's own pattern).
                        y = ex(x * c)
                        c = (c * jnp.asarray(0.9999, dtype=x.dtype)
                             + y[0] * jnp.asarray(1e-9, dtype=x.dtype))
                        return c, ()
                    c, _ = jax.lax.scan(body, jnp.ones((), dtype=x.dtype),
                                        None, length=k)
                    return c
                return jax.jit(run)
            f1, f2 = make(max(loops // 4, 1)), make(loops)
            _sync(f1())
            _sync(f2())
            t0 = time.perf_counter()
            _sync(f1())
            t1 = time.perf_counter()
            _sync(f2())
            t2 = time.perf_counter()
            per = max((t2 - t1) - (t1 - t0), 1e-9) / (loops - loops // 4)
            secs.append(per)
        mn, mx = min(secs), max(secs)
        imb = (mx - mn) / mn if mn > 0 else 0.0
        log_info("==== RUNTIME LOAD BALANCE ====")
        for i, s in enumerate(secs):
            log_info("shard %d: %.3e s/SpMV", i, s)
        log_info("load imbalance (max-min)/min = %.3f", imb)
        return secs, imb

    def matmat(self, X, alpha=1.0, beta=0.0, Y=None):
        """SpMM: Y = alpha*A*X + beta*Y with X (ncols, k).

        Same per-shard composition as matvec — ``local_contrib`` widens
        every kernel class to (rows, k) slabs (DIA windows become row
        slabs, gathers/scatters move k-vectors, blocks run a urc,uck->urk
        einsum).  Every index load amortizes over the k values it feeds.
        """
        import jax.numpy as jnp
        X = jnp.asarray(X)
        if X.ndim != 2 or X.shape[0] != self.ncols:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"X must be ({self.ncols}, k), got {X.shape}")
        if Y is not None and np.shape(Y) != (self.nrows, X.shape[1]):
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"Y must be ({self.nrows}, {X.shape[1]})")
        return self.matvec(X, alpha=alpha, beta=beta, y=Y)

    # ------------------------------------------------------------------
    def csx_size(self) -> int:
        return sum(t.csx_size() for t in self.shards)

    def _find_shard(self, row: int) -> int:
        assert self.partition is not None
        for i in range(self.partition.nparts):
            s, e = self.partition.bounds(i)
            if s <= row < e:
                return i
        seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, f"row {row} out of bounds")
        return -1

    def _locate(self, row: int, col: int):
        """Find (kind, table, flat_index) of entry (row, col) or None.

        The reference walks the ctl stream decoding each unit
        (``CsxGetSet.hpp:83-200``); here each table kind admits a closed-form
        membership test, evaluated vectorized per table.
        """
        si = self._find_shard(row)
        tables = self.shards[si]
        r = row - tables.row_start
        for t in tables.dias:
            o = (r + col) if t.anti else (col - r)
            hits = np.nonzero(t.offsets == o)[0]
            if hits.size and t.mask is not None and t.mask[int(hits[0]), r]:
                return ("dia", t, (int(hits[0]), r))
        d = tables.delta
        if d is not None and d.nnz:
            lo, hi = int(d.rowptr[r]), int(d.rowptr[r + 1])
            hits = np.nonzero(d.cols[lo:hi] == col)[0]
            if hits.size:
                return ("delta", d, lo + int(hits[0]))
        for t in tables.runs:
            sr, sc = run_step(t.enc)
            dr, dc = sr * t.delta, sc * t.delta
            rows64 = t.rows.astype(np.int64)
            cols64 = t.cols.astype(np.int64)
            if dr == 0:
                cand = rows64 == r
                j = np.where(dc != 0, (col - cols64), -1)
            else:
                num = r - rows64
                cand = (num % dr == 0) & (num >= 0)
                j = num // dr
            with np.errstate(divide="ignore", invalid="ignore"):
                if dc != 0:
                    jc = (col - cols64) // dc
                    okc = ((col - cols64) % dc == 0) & (jc >= 0)
                    if dr == 0:
                        j, cand = jc, cand & okc
                    else:
                        cand = cand & okc & (jc == j)
                else:
                    cand = cand & (cols64 == col)
            cand = cand & (j >= 0) & (j < t.sizes.astype(np.int64))
            hits = np.nonzero(cand)[0]
            if hits.size:
                u = int(hits[0])
                return ("run", t, (u, int(j[u])))
        for t in tables.blocks:
            rows64 = t.rows.astype(np.int64)
            cols64 = t.cols.astype(np.int64)
            cand = ((rows64 <= r) & (r < rows64 + t.br)
                    & (cols64 <= col) & (col < cols64 + t.bc))
            hits = np.nonzero(cand)[0]
            if hits.size:
                u = int(hits[0])
                return ("block", t, (u, r - int(rows64[u]),
                                     col - int(cols64[u])))
        return None

    def get_entry(self, row: int, col: int) -> float:
        """``spx_mat_get_entry`` parity (ref ``src/api/matvec.c:324``)."""
        if not (0 <= row < self.nrows and 0 <= col < self.ncols):
            seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, "entry out of bounds")
        if self.symmetric and col > row:
            row, col = col, row
        loc = self._locate(row, col)
        if loc is None:
            seterror(ErrorCode.SPX_ERR_ENTRY_NOT_FOUND,
                     f"entry ({row},{col}) not found")
        kind, t, idx = loc
        if kind == "delta":
            return float(t.vals[idx])
        if kind == "dia":
            k, r = idx
            return float(t.vals[k, r])
        if kind == "run":
            u, j = idx
            return float(t.vals[u, j])
        u, i, j = idx
        return float(t.vals[u, i, j])

    def set_entry(self, row: int, col: int, value: float) -> None:
        """``spx_mat_set_entry`` parity (ref ``src/api/matvec.c:366``).
        Only existing entries can be set (structure is immutable)."""
        if not (0 <= row < self.nrows and 0 <= col < self.ncols):
            seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, "entry out of bounds")
        if self.symmetric and col > row:
            row, col = col, row
        loc = self._locate(row, col)
        if loc is None:
            setwarning(ErrorCode.SPX_WARN_ENTRY_NOT_SET,
                       f"entry ({row},{col}) not found; not set")
            return
        kind, t, idx = loc
        if kind == "delta":
            t.vals[idx] = value
        elif kind == "dia":
            k, r = idx
            t.vals[k, r] = value
        elif kind == "run":
            u, j = idx
            t.vals[u, j] = value
        else:
            u, i, j = idx
            t.vals[u, i, j] = value
        self._refresh_executors(self._find_shard(row))

    def _refresh_executors(self, shard: Optional[int] = None) -> None:
        """Invalidate executor state after a value mutation.

        The executors' host arrays are views of the table buffers, so an
        in-place value write is already visible; only the device-resident
        copy must be dropped — and only for the affected shard, keeping a
        set_entry sweep O(nnz) overall (ref ``test/src/BinaryTest_p2.cpp:40-60`` sets half the entries).
        """
        targets = (self.executors if shard is None
                   else [self.executors[shard]])
        for ex in targets:
            ex.invalidate_value_caches()

    def tocoo(self):
        """Expand all tables back to COO (for checks and persistence)."""
        out_r, out_c, out_v = [], [], []
        for tables in self.shards:
            r0 = tables.row_start
            d = tables.delta
            if d is not None and d.nnz:
                out_r.append(d.row_ids.astype(np.int64) + r0)
                out_c.append(d.cols.astype(np.int64))
                out_v.append(np.asarray(d.vals))
            for t in tables.runs:
                sr, sc = run_step(t.enc)
                lane = np.arange(t.width, dtype=np.int64)
                mask = lane[None, :] < t.sizes[:, None].astype(np.int64)
                rr = (t.rows[:, None].astype(np.int64)
                      + sr * t.delta * lane[None, :] + r0)
                cc = (t.cols[:, None].astype(np.int64)
                      + sc * t.delta * lane[None, :])
                out_r.append(rr[mask])
                out_c.append(cc[mask])
                out_v.append(np.asarray(t.vals)[mask])
            for t in tables.dias:
                kidx, ridx = np.nonzero(t.mask)
                offs = t.offsets[kidx]
                if t.anti:
                    cc = offs - ridx
                else:
                    cc = offs + ridx
                out_r.append(ridx.astype(np.int64) + r0)
                out_c.append(cc.astype(np.int64))
                out_v.append(np.asarray(t.vals)[kidx, ridx])
            for t in tables.blocks:
                br_i = np.arange(t.br, dtype=np.int64)
                bc_i = np.arange(t.bc, dtype=np.int64)
                rr = (t.rows[:, None, None].astype(np.int64)
                      + br_i[None, :, None] + r0)
                cc = (t.cols[:, None, None].astype(np.int64)
                      + bc_i[None, None, :])
                U = t.rows.size
                out_r.append(np.broadcast_to(rr, (U, t.br, t.bc)).ravel())
                out_c.append(np.broadcast_to(cc, (U, t.br, t.bc)).ravel())
                out_v.append(np.asarray(t.vals).ravel())
        if not out_r:
            e = np.zeros(0, dtype=np.int64)
            return e, e, np.zeros(0)
        rows = np.concatenate(out_r)
        cols = np.concatenate(out_c)
        vals = np.concatenate(out_v)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]
