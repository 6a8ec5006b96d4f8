"""Symmetric CSX (CSX-Sym).

Parity with the reference symmetric pipeline: storage of the strict lower
triangle + diagonal per shard (``SparsePartitionSym``, ``include/sparsex/
internals/SparsePartition.hpp:358-497``), mining/encoding the lower triangle
with the same machinery, and an SpMV that computes both the direct (lower)
contribution and the transposed (upper-mirror) contribution
(``src/templates/csx_sym_spmv_tmpl.c:62-105``).

Cross-shard reduction: a shard's transposed contributions land at column
positions that may belong to earlier shards.  The reference zeroes a local
buffer per thread, runs, then applies a reduction map under barriers
(``VecInitFromMap``/``VecAddFromMap``, ``src/internals/CsxSpmv.cpp:66-85``).
Here every shard scatter-adds its transposed contribution into a partial
vector, and the partials are summed — a ``psum_scatter`` over the mesh in
the sharded executor, a plain sum in the single-device program.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from sparsex_jax.config import Config
from sparsex_jax.csx import CsxMatrix
from sparsex_jax.errors import ErrorCode, seterror
from sparsex_jax.logger import log_info
from sparsex_jax.ops.exec import CsxExecutor
from sparsex_jax.ops.kernels import local_contrib, static_meta, tables_to_arrays
from sparsex_jax.parallel.partition import row_counts_from_coo, split_rows_by_nnz
from sparsex_jax.preprocess.encoder import Encoder
from sparsex_jax.preprocess.mining import lexsort_rc, take1
from sparsex_jax.preprocess.tables import CsxTables


@functools.lru_cache(maxsize=64)
def _compiled_sym_multi(metas, row_starts):
    """One jitted program for ALL symmetric shards: per-shard lower
    triangle + diagonal, transposed partials summed in-trace (the
    reference's single barrier-synchronized dispatch + VecAddFromMap
    reduction, ``CsxKernels.cpp:57-80``)."""
    import jax
    import jax.numpy as jnp

    def fn(arrs_list, dvals_list, x, alpha):
        nrows_glob = metas[0][1]
        z_total = None
        parts = []
        for meta, rs, arrs, dvals in zip(metas, row_starts, arrs_list,
                                         dvals_list):
            acc, z = local_contrib(meta, arrs, x, nrows_part=meta[0],
                                   ncols=meta[1], row_start=rs,
                                   symmetric=True, dvals=dvals,
                                   nrows_glob=nrows_glob)
            parts.append(acc)
            z_total = z if z_total is None else z_total + z
        out = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return alpha * (out + z_total)

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _compiled_sym(meta, row_start: int):
    """Jitted symmetric shard kernel: returns (y_own, z_partial).

    ``y_own``: dense over the shard's rows = L_s x + D_s x_own.
    ``z_partial``: dense over all rows = L_s^T x_own-range scatter.
    Kernel composition lives in ``ops/kernels.py``.
    """
    import jax

    nrows_part, ncols = meta[0], meta[1]

    def fn(arrs, dvals, x, alpha):
        acc, z = local_contrib(meta, arrs, x, nrows_part=nrows_part,
                               ncols=ncols, row_start=row_start,
                               symmetric=True, dvals=dvals,
                               nrows_glob=ncols)
        return alpha * acc, alpha * z

    return jax.jit(fn)


@dataclass
class SymShard:
    tables: CsxTables  # strict lower triangle, partition-local rows
    dvalues: np.ndarray  # diagonal values for the shard's rows


def mirror_full_tables(shards: List[CsxTables],
                       dvalues: List[np.ndarray],
                       nrows: int, ncols: int) -> CsxTables:
    """Full-matrix execution tables mirrored from the lower-triangle shards.

    The reference reads each lower-triangle value once and applies it
    twice, buying the halved traffic at the price of a second scatter per
    unit (``csx_sym_spmv_tmpl.c:62-105``).  The opposite trade mirrors
    every table at build time, so the symmetric SpMV runs the unsymmetric
    executor with no transposed scatter into z, at twice the value
    traffic.  Storage/persist stay lower-triangle (``csx_size``,
    ``save_csx``); only the device working set is expanded.  Selected by
    ``spx.jax.sym_full=on``.

    Structure is preserved under the mirror — each pattern maps onto
    another first-class pattern, so no encoding information is lost:
      horizontal run    -> vertical run   (same delta, same values)
      vertical run      -> horizontal run
      diagonal run      -> diagonal run   (head swapped)
      anti-diag run     -> anti-diag run  (re-anchored, values reversed)
      (br, bc) block    -> (bc, br) block (values transposed)
      DIA offset o      -> DIA offset -o  (values shifted by o)
      anti-DIA s        -> anti-DIA s     (values reversed around s)
      main diagonal     -> DIA offset 0
    """
    from sparsex_jax.preprocess.encodings import EncType
    from sparsex_jax.preprocess.tables import (BlockTable, DeltaTable,
                                               DiagTable, RunTable)

    val_dtype = None
    dr_l, dc_l, dv_l = [], [], []          # delta triples (dest, col, val)
    runs_acc: dict = {}                     # (enc, delta, width) -> lists
    blocks_acc: dict = {}                   # (br, bc) -> (enc, lists)
    dia_acc: dict = {}                      # (anti, offset) -> dense vec
    dia_cnt = {False: 0, True: 0}

    def _dia_add(anti: bool, off: int, lo: int, vec: np.ndarray):
        # clip to [0, nrows): out-of-range positions hold only the zeros
        # the encoder guarantees outside the matrix (a stored element's
        # column is always in range, and placement index = that column)
        a, b = max(0, -lo), min(vec.size, nrows - lo)
        if b <= a or not np.any(vec[a:b]):
            return
        dst = dia_acc.get((anti, int(off)))
        if dst is None:
            dst = dia_acc[(anti, int(off))] = np.zeros(
                nrows, dtype=vec.dtype)
        dst[lo + a: lo + b] += vec[a:b]
        dia_cnt[anti] += int(np.count_nonzero(vec[a:b]))

    for tables in shards:
        r0 = tables.row_start
        d = tables.delta
        if d is not None and d.nnz:
            val_dtype = d.vals.dtype
            rg = np.asarray(d.row_ids, dtype=np.int64) + r0
            c = np.asarray(d.cols, dtype=np.int64)
            dr_l += [rg, c]
            dc_l += [c, rg]
            dv_l += [d.vals, d.vals]
        for t in tables.runs:
            val_dtype = t.vals.dtype
            rg = np.asarray(t.rows, dtype=np.int64) + r0
            c = np.asarray(t.cols, dtype=np.int64)
            W = t.width
            key = (t.enc, t.delta, W)
            runs_acc.setdefault(key, []).append((rg, c, t.sizes, t.vals))
            if t.enc == EncType.HORIZONTAL:
                tkey = (EncType.VERTICAL, t.delta, W)
                runs_acc.setdefault(tkey, []).append((c, rg, t.sizes,
                                                      t.vals))
            elif t.enc == EncType.VERTICAL:
                tkey = (EncType.HORIZONTAL, t.delta, W)
                runs_acc.setdefault(tkey, []).append((c, rg, t.sizes,
                                                      t.vals))
            elif t.enc == EncType.DIAGONAL:
                runs_acc.setdefault(key, []).append((c, rg, t.sizes,
                                                     t.vals))
            else:  # ANTI_DIAGONAL: re-anchor at the last element and
                #    reverse each unit's values (element j of the mirror
                #    is element S-1-j of the original)
                S = np.asarray(t.sizes, dtype=np.int64)
                dlt = t.delta
                hr = c - (S - 1) * dlt
                hc = rg + (S - 1) * dlt
                idx = S[:, None] - 1 - np.arange(W, dtype=np.int64)[None]
                vrev = np.where(idx >= 0,
                                np.take_along_axis(
                                    t.vals, np.maximum(idx, 0), axis=1),
                                np.zeros((), t.vals.dtype))
                runs_acc.setdefault(key, []).append((hr, hc, t.sizes,
                                                     vrev))
        for t in tables.blocks:
            val_dtype = t.vals.dtype
            rg = np.asarray(t.rows, dtype=np.int64) + r0
            c = np.asarray(t.cols, dtype=np.int64)
            blocks_acc.setdefault((t.br, t.bc), [t.enc, []])[1].append(
                (rg, c, t.vals))
            blocks_acc.setdefault((t.bc, t.br), [t.enc, []])[1].append(
                (c, rg, np.ascontiguousarray(t.vals.transpose(0, 2, 1))))
        for t in tables.dias:
            val_dtype = t.vals.dtype
            np_ = tables.nrows
            for k, o in enumerate(t.offsets):
                o = int(o)
                if not t.anti:
                    og = o - r0          # global offset col - row
                    _dia_add(False, og, r0, t.vals[k])
                    # transposed: z[r+og] += dv[r]*x[r]  ->  offset -og
                    # with values shifted to global rows r+og
                    _dia_add(False, -og, r0 + og, t.vals[k])
                else:
                    sg = o + r0          # global anti index row + col
                    _dia_add(True, sg, r0, t.vals[k])
                    # transposed: z[sg-r] += av[r]*x[r] -> same sg,
                    # values reversed onto rows sg-r
                    _dia_add(True, sg, sg - (r0 + np_ - 1),
                             t.vals[k][::-1])
    # main diagonal -> DIA offset 0
    for tables, dv in zip(shards, dvalues):
        if np.any(dv):
            val_dtype = val_dtype if val_dtype is not None else dv.dtype
            _dia_add(False, 0, tables.row_start,
                     np.asarray(dv, dtype=val_dtype
                                if val_dtype is not None else dv.dtype))

    if val_dtype is None:
        val_dtype = np.float64
    index_dtype = shards[0].delta.cols.dtype if shards[0].delta \
        else np.int32

    # --- delta table (sorted by (row, col)) ---
    delta = None
    total_d = 0
    if dr_l:
        dr = np.concatenate(dr_l)
        dc = np.concatenate(dc_l)
        dv = np.concatenate(dv_l)
        order = np.lexsort((dc, dr))
        dr, dc, dv = dr[order], dc[order], dv[order]
        rowptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(np.bincount(dr, minlength=nrows), out=rowptr[1:])
        delta = DeltaTable(rowptr=rowptr,
                           cols=dc.astype(index_dtype),
                           vals=dv.astype(val_dtype),
                           row_ids=dr.astype(index_dtype))
        total_d = dr.size

    runs = []
    for (enc, dlt, W), parts in sorted(runs_acc.items()):
        runs.append(RunTable(
            enc=enc, delta=int(dlt),
            rows=np.concatenate([p[0] for p in parts]).astype(index_dtype),
            cols=np.concatenate([p[1] for p in parts]).astype(index_dtype),
            sizes=np.concatenate([p[2] for p in parts]).astype(index_dtype),
            vals=np.concatenate([p[3] for p in parts]).astype(val_dtype)))
    blocks = []
    for (br, bc), (enc, parts) in sorted(blocks_acc.items()):
        blocks.append(BlockTable(
            enc=enc,
            rows=np.concatenate([p[0] for p in parts]).astype(index_dtype),
            cols=np.concatenate([p[1] for p in parts]).astype(index_dtype),
            vals=np.concatenate([p[2] for p in parts]).astype(val_dtype)))
    dias = []
    for anti in (False, True):
        offs = sorted(o for (a, o) in dia_acc if a == anti)
        if offs:
            vals = np.stack([dia_acc[(anti, o)] for o in offs])
            dias.append(DiagTable(
                anti=anti,
                offsets=np.asarray(offs, dtype=np.int64),
                vals=vals.astype(val_dtype), mask=None,
                nnz_count=dia_cnt[anti]))
    nnz_full = (total_d + sum(t.nnz for t in runs)
                + sum(t.nnz for t in blocks) + sum(t.nnz for t in dias))
    return CsxTables(nrows=nrows, ncols=ncols, nnz=int(nnz_full),
                     row_start=0, delta=delta, runs=runs, blocks=blocks,
                     dias=dias)


class SymCsxMatrix(CsxMatrix):
    """Symmetric tuned matrix: lower triangle + diagonal per shard."""

    def __init__(self, nrows, ncols, nnz, **kw):
        super().__init__(nrows=nrows, ncols=ncols, nnz=nnz, symmetric=True,
                         **kw)
        self.dvalues: List[np.ndarray] = []
        self._full_exec: Optional[CsxExecutor] = None

    def _full_active(self) -> bool:
        """Whether SpMV runs on the mirrored full-expansion executor
        (``spx.jax.sym_full=on``); "auto" and "off" keep the per-shard
        lower-triangle kernels with the transposed z-scatter."""
        return Config.instance().sym_full == "on"

    def _full_executor(self) -> CsxExecutor:
        if self._full_exec is None:
            ft = mirror_full_tables(self.shards, self.dvalues,
                                    self.nrows, self.ncols)
            log_info("sym full-expansion tables: nnz=%d sig=%s",
                     ft.nnz, ft.signature())
            self._full_exec = CsxExecutor(ft)
        return self._full_exec

    def matvec(self, x, alpha=1.0, beta=0.0, y=None):
        import jax
        import jax.numpy as jnp
        x = jnp.asarray(x)
        if x.shape[0] != self.ncols:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"x has {x.shape[0]} entries, expected {self.ncols}")
        if self._full_active():
            # mirrored full-expansion tables on the unsymmetric executor
            # (see mirror_full_tables); covers SpMV and SpMM
            return self._full_executor()(x, alpha=alpha, beta=beta, y=y)
        if not hasattr(self, "_sym_plain"):
            self._sym_plain = [(static_meta(t), tables_to_arrays(t))
                               for t in self.shards]
        variants = self._sym_plain
        # device-resident copies (transferred once; numpy args would
        # re-upload per call, constants embed poorly — see exec._device).
        tracing = isinstance(x, jax.core.Tracer)
        dev = getattr(self, "_sym_dev_plain", None)
        if dev is None and not tracing:
            dev = self._sym_dev_plain = [jax.device_put(arrs)
                                         for _, arrs in variants]
        # dvalues cache is keyed on the call dtype: a cached f64 copy fed
        # an f32 x would silently promote the output dtype.
        dkey = str(x.dtype)
        dcache = getattr(self, "_sym_dev_dvals", None)
        if dcache is None:
            dcache = self._sym_dev_dvals = {}
        if dkey not in dcache and not tracing:
            dcache[dkey] = jax.device_put(
                [np.asarray(d, dtype=x.dtype) for d in self.dvalues])
        if dev is not None:  # device arrays close over safely under trace
            variants = [(meta, a) for (meta, _), a in zip(variants, dev)]
        if x.ndim == 1:
            # one jitted program for all shards (single synchronized
            # dispatch; z partials summed in-trace)
            metas = tuple(meta for meta, _ in variants)
            row_starts = tuple(t.row_start for t in self.shards)
            fn = _compiled_sym_multi(metas, row_starts)
            dvals = (dcache[dkey] if dkey in dcache
                     else [jnp.asarray(d, dtype=x.dtype)
                           for d in self.dvalues])
            out = fn([arrs for _, arrs in variants], dvals,
                     x, x.dtype.type(alpha))
        else:
            y_parts = []
            z_total = jnp.zeros((self.nrows, x.shape[1]), dtype=x.dtype)
            for tables, dvals, (meta, arrs) in zip(self.shards,
                                                   self.dvalues, variants):
                fn = _compiled_sym(meta, tables.row_start)
                y_own, z = fn(arrs, jnp.asarray(dvals, dtype=x.dtype), x,
                              x.dtype.type(alpha))
                y_parts.append(y_own)
                z_total = z_total + z
            out = (jnp.concatenate(y_parts) if len(y_parts) > 1
                   else y_parts[0])
            out = out + z_total
        if y is not None and beta != 0.0:
            out = out + x.dtype.type(beta) * jnp.asarray(y)
        return out

    def _locate(self, row: int, col: int):
        """Lower-triangle lookup; the diagonal lives in ``dvalues``."""
        si = self._find_shard(row)
        if row == col:
            return ("diag", si, row - self.shards[si].row_start)
        return super()._locate(row, col)

    def get_entry(self, row: int, col: int) -> float:
        if self.symmetric and col > row:
            row, col = col, row
        if row == col:
            si = self._find_shard(row)
            return float(self.dvalues[si][row - self.shards[si].row_start])
        return super().get_entry(row, col)

    def set_entry(self, row: int, col: int, value: float) -> None:
        self._full_exec = None   # mirrored copies go stale on any write
        if col > row:
            row, col = col, row
        if row == col:
            si = self._find_shard(row)
            self.dvalues[si][row - self.shards[si].row_start] = value
            if hasattr(self, "_sym_dev_dvals"):  # drop stale device copy
                del self._sym_dev_dvals
            return
        super().set_entry(row, col, value)
        for key in ("_sym_dev_plain", "_sym_dev_dvals"):
            if hasattr(self, key):
                delattr(self, key)

    def tocoo(self):
        """Expand to full (mirrored) COO."""
        r, c, v = super().tocoo()
        # add global row offset handled by parent; add diagonal + mirror
        dr = []
        dv = []
        for tables, dvals in zip(self.shards, self.dvalues):
            idx = np.arange(tables.nrows, dtype=np.int64) + tables.row_start
            nzmask = dvals != 0
            dr.append(idx[nzmask])
            dv.append(dvals[nzmask])
        rows = np.concatenate([r, c] + dr)
        cols = np.concatenate([c, r] + dr)
        vals = np.concatenate([v, v] + dv)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]


def build_symmetric_csx(nrows: int, ncols: int, rows, cols, vals, *,
                        already_lower: bool = False,
                        config: Optional[Config] = None) -> SymCsxMatrix:
    """Build a symmetric CSX from COO input.

    ``already_lower=True`` when the input carries only the lower triangle
    (MMF symmetric file loaded with ``keep_lower``); otherwise the strict
    upper triangle is dropped after verifying symmetry is plausible.
    """
    cfg = config or Config.instance()
    if nrows != ncols:
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 "symmetric matrices must be square")
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=cfg.value_dtype)
    if not already_lower:
        # Verify the pattern is symmetric (cheap hash check), then keep L+D.
        k_fwd = np.sort(rows * ncols + cols)
        k_bwd = np.sort(cols * ncols + rows)
        if not np.array_equal(k_fwd, k_bwd):
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     "matrix marked symmetric but pattern is not symmetric")
        keep = rows >= cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    total_nnz = int(rows.size)  # lower-triangle count (incl. diagonal)
    mat = SymCsxMatrix(nrows=int(nrows), ncols=int(ncols), nnz=total_nnz)
    mat.timers.start_timer("preproc")

    nparts = max(1, cfg.nr_threads)
    # Balance on (nnz + n) / 2 like the reference symmetric load
    # (ref SparseInternal.hpp:72-95).
    part = split_rows_by_nnz(row_counts_from_coo(rows, nrows), nparts)
    mat.partition = part

    order = lexsort_rc(rows, cols)
    rows, cols = take1(rows, order), take1(cols, order)
    vals = take1(vals, order)
    bounds = np.searchsorted(rows, part.row_start + [nrows])

    # Thread-parallel per-shard encode (PreprocessThreadSym parity,
    # ref ``CsxBuild.hpp:290-341``); see CsxMatrix.from_coo.
    def _encode(i):
        lo, hi = bounds[i], bounds[i + 1]
        r0 = part.row_start[i]
        nr = part.row_end[i] - r0
        pr = rows[lo:hi] - r0
        pc = cols[lo:hi]
        pv = vals[lo:hi]
        diag_mask = (pr + r0) == pc
        dvalues = np.zeros(nr, dtype=cfg.value_dtype)
        dvalues[pr[diag_mask]] = pv[diag_mask]
        enc = Encoder(nr, ncols, pr[~diag_mask], pc[~diag_mask],
                      pv[~diag_mask], config=cfg)
        enc.encode()
        tables = enc.finalize(row_start=r0)
        return i, r0, diag_mask, dvalues, enc, tables

    if nparts == 1:
        results = [_encode(0)]
    else:
        from concurrent.futures import ThreadPoolExecutor
        import os as _os
        workers = min(nparts, max(1, _os.cpu_count() or 1))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(_encode, range(nparts)))
    for i, r0, diag_mask, dvalues, enc, tables in results:
        mat.shards.append(tables)
        mat.dvalues.append(dvalues)
        mat.executors.append(CsxExecutor(tables))
        log_info("sym shard %d: rows [%d,%d) lower-nnz=%d encodings=%s",
                 i, r0, part.row_end[i], int((~diag_mask).sum()),
                 ",".join(enc.encoding_log) or "none")
    mat.timers.pause_timer("preproc")
    return mat
