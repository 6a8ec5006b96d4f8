"""Multi-device SPMD execution over a JAX mesh.

This is the JAX replacement for the reference's entire parallel
runtime (``ThreadPool``/``Barrier``/``CsxSpmv``/NUMA placement, SURVEY §2.7):

- per-thread row partitions            -> per-device row shards on a 1-D
  ``jax.sharding.Mesh`` (nnz-balanced, same splitting algorithm);
- NUMA interleaved allocation          -> ``NamedSharding`` placement of each
  shard's tables in its device's memory;
- shared read of x + futex barrier     -> x replicated over the mesh, or a
  **halo exchange**: x stays sharded, each device ring-``ppermute``s only
  the ``halo_k`` neighbor chunks its column span references, and the
  own-chunk ("local") contribution is computed against its resident x
  chunk with NO dependency on the ring, so XLA may overlap the
  collective with that compute;
- CSX-Sym local buffers + reduction map-> per-shard transposed partials
  reduced with ``lax.psum_scatter`` (each device receives only its own row
  block; ref ``VecInitFromMap``/``VecAddFromMap``,
  ``src/internals/CsxSpmv.cpp:66-85``).

Shards generally have different table sets and sizes; to keep the SPMD
program static they are stacked into uniform arrays: the union of table
signatures across shards, each padded to the max unit count (padding units
carry zero values, contributing nothing).  For halo mode every shard's tables are **rebased at build time**:
local tables into own-chunk coordinates, halo tables into window
coordinates — no per-call index arithmetic.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sparsex_jax.csx import CsxMatrix
from sparsex_jax.preprocess.tables import (
    BlockTable, CsxTables, DeltaTable, DiagTable, RunTable,
)
from sparsex_jax.preprocess.xform import run_step


def stack_shards(shards: List[CsxTables], nrows: int, ncols: int,
                 value_dtype=None):
    """Stack per-shard tables into uniform arrays with a leading shard axis.

    Returns (arrays, static_meta).  ``arrays`` is a pytree whose every leaf
    has leading dimension n_shards; ``static_meta`` carries the union table
    signature, per-shard row offsets/counts and padding info.
    """
    n = len(shards)
    vdt = value_dtype
    if vdt is None:
        for t in shards:
            for src in ([t.delta] if t.delta is not None else []) + \
                    list(t.dias) + list(t.runs) + list(t.blocks):
                vdt = src.vals.dtype
                break
            if vdt is not None:
                break
        if vdt is None:
            vdt = np.float32
    max_rows = max(t.nrows for t in shards)

    # --- delta tables ---
    dn = max(t.delta.nnz if t.delta else 0 for t in shards)
    d_cols = np.zeros((n, dn), dtype=np.int32)
    d_vals = np.zeros((n, dn), dtype=vdt)
    d_rowids = np.zeros((n, dn), dtype=np.int32)
    for i, t in enumerate(shards):
        if t.delta and t.delta.nnz:
            m = t.delta.nnz
            d_cols[i, :m] = t.delta.cols
            d_vals[i, :m] = t.delta.vals
            d_rowids[i, :m] = t.delta.row_ids
            # keep segment ids sorted: padding lands on the last local row
            d_rowids[i, m:] = max(0, t.nrows - 1)
        else:
            d_rowids[i, :] = max(0, t.nrows - 1)

    # --- run tables: union of (enc, delta, width) ---
    run_keys = sorted({(int(rt.enc), rt.delta, rt.width)
                       for t in shards for rt in t.runs})
    run_arrays = []
    for key in run_keys:
        enc_i, delta, width = key
        umax = max((rt.rows.size for t in shards for rt in t.runs
                    if (int(rt.enc), rt.delta, rt.width) == key), default=0)
        rows = np.zeros((n, umax), dtype=np.int32)
        cols = np.zeros((n, umax), dtype=np.int32)
        vals = np.zeros((n, umax, width), dtype=vdt)
        for i, t in enumerate(shards):
            for rt in t.runs:
                if (int(rt.enc), rt.delta, rt.width) == key:
                    u = rt.rows.size
                    rows[i, :u] = rt.rows
                    cols[i, :u] = rt.cols
                    vals[i, :u] = rt.vals
                    # dummy units repeat the last real column (vals are 0)
                    if u:
                        cols[i, u:] = rt.cols[u - 1]
        run_arrays.append({"rows": rows, "cols": cols, "vals": vals})

    # --- block tables: union of (enc, br, bc) ---
    block_keys = sorted({(int(bt.enc), bt.br, bt.bc)
                         for t in shards for bt in t.blocks})
    block_arrays = []
    for key in block_keys:
        enc_i, br, bc = key
        umax = max((bt.rows.size for t in shards for bt in t.blocks
                    if (int(bt.enc), bt.br, bt.bc) == key), default=0)
        rows = np.zeros((n, umax), dtype=np.int32)
        cols = np.zeros((n, umax), dtype=np.int32)
        vals = np.zeros((n, umax, br, bc), dtype=vdt)
        for i, t in enumerate(shards):
            for bt in t.blocks:
                if (int(bt.enc), bt.br, bt.bc) == key:
                    u = bt.rows.size
                    rows[i, :u] = bt.rows
                    cols[i, :u] = bt.cols
                    vals[i, :u] = bt.vals
                    if u:
                        cols[i, u:] = bt.cols[u - 1]
        block_arrays.append({"rows": rows, "cols": cols, "vals": vals})

    # --- DIA tables: union over the anti flag, padded to max diag count ---
    dia_keys = []
    dia_arrays = []
    for anti in (False, True):
        dmax = max((dt.ndiags for t in shards for dt in t.dias
                    if dt.anti == anti), default=0)
        if dmax == 0:
            continue
        offs = np.zeros((n, dmax), dtype=np.int32)
        vals = np.zeros((n, dmax, max_rows), dtype=vdt)
        for i, t in enumerate(shards):
            for dt in t.dias:
                if dt.anti == anti:
                    d = dt.ndiags
                    offs[i, :d] = dt.offsets
                    vals[i, :d, : dt.vals.shape[1]] = dt.vals
        dia_keys.append((anti, None, dmax))
        dia_arrays.append({"offsets": offs, "vals": vals})

    row_start = np.array([t.row_start for t in shards], dtype=np.int32)
    nrows_loc = np.array([t.nrows for t in shards], dtype=np.int32)
    arrays = {
        "delta": {"cols": d_cols, "vals": d_vals, "row_ids": d_rowids},
        "runs": run_arrays,
        "blocks": block_arrays,
        "dias": dia_arrays,
        "row_start": row_start[:, None],  # (n, 1) so it shards cleanly
    }
    meta = {
        "n": n,
        "nrows": nrows,
        "ncols": ncols,
        "max_rows": max_rows,
        "run_keys": tuple(run_keys),
        "block_keys": tuple(block_keys),
        "dia_keys": tuple(dia_keys),
        "row_start": tuple(int(r) for r in row_start),
        "nrows_loc": tuple(int(r) for r in nrows_loc),
    }
    return arrays, meta


def _gather_index(meta) -> np.ndarray:
    """Flat index mapping global row -> position in the stacked (n, max_rows)
    output (for trimming away row padding)."""
    idx = np.zeros(meta["nrows"], dtype=np.int32)
    for i in range(meta["n"]):
        r0, nr = meta["row_start"][i], meta["nrows_loc"][i]
        idx[r0: r0 + nr] = i * meta["max_rows"] + np.arange(nr)
    return idx


def _local_spmv(meta, tbl, x, axis_name=None, symmetric=False,
                dvals=None, z_off=0):
    """One shard's SpMV given its (squeezed) local tables.  Delegates to
    the shared kernel composition (``ops/kernels.py``) with the stacked
    union signature: every shard runs the same program over the union of
    table kinds, padding units contributing exactly zero."""
    from sparsex_jax.ops.kernels import local_contrib

    kmeta = (meta["max_rows"], meta["ncols"], meta["run_keys"],
             meta["block_keys"], meta["dia_keys"])
    arrs = {"delta": tbl["delta"], "runs": tbl["runs"],
            "blocks": tbl["blocks"], "dias": tbl["dias"]}
    return local_contrib(
        kmeta, arrs, x, nrows_part=meta["max_rows"], ncols=meta["ncols"],
        row_start=tbl["row_start"][0], symmetric=symmetric, dvals=dvals,
        nrows_glob=meta["nrows"], z_off=z_off)


def _col_span(t: CsxTables) -> Tuple[int, int]:
    """[lo, hi) range of x indices one shard's tables reference."""
    lo, hi = t.ncols, 0
    d = t.delta
    if d is not None and d.nnz:
        lo = min(lo, int(d.cols.min()))
        hi = max(hi, int(d.cols.max()) + 1)
    for rt in t.runs:
        if rt.rows.size == 0:
            continue
        sr, sc = run_step(rt.enc)
        reach = sc * rt.delta * (rt.vals.shape[1] - 1)
        c0 = int(rt.cols.min()) + min(0, reach)
        c1 = int(rt.cols.max()) + max(0, reach)
        lo, hi = min(lo, c0), max(hi, c1 + 1)
    for bt in t.blocks:
        if bt.rows.size:
            lo = min(lo, int(bt.cols.min()))
            hi = max(hi, int(bt.cols.max()) + bt.bc)
    for dt in t.dias:
        if not dt.ndiags:
            continue
        if dt.anti:
            # x idx = s - r, r in [0, nrows)
            lo = min(lo, int(dt.offsets.min()) - (t.nrows - 1))
            hi = max(hi, int(dt.offsets.max()) + 1)
        else:
            # x idx = r + o
            lo = min(lo, int(dt.offsets.min()))
            hi = max(hi, int(dt.offsets.max()) + t.nrows)
    lo = max(0, min(lo, t.ncols))
    hi = max(lo, min(hi, t.ncols))
    return lo, hi


# ---------------------------------------------------------------------------
# halo split: build-time rebasing into own-chunk / window coordinates
# ---------------------------------------------------------------------------
def _mk_delta(nrows: int, rows, cols, vals) -> Optional[DeltaTable]:
    if rows.size == 0:
        return None
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rowptr = np.searchsorted(rows, np.arange(nrows + 1)).astype(np.int64)
    return DeltaTable(rowptr=rowptr, cols=cols.astype(np.int64),
                      vals=vals, row_ids=rows.astype(np.int64))


def _split_tables_for_halo(t: CsxTables, i: int, k: int, chunk: int):
    """Split one shard's tables into (local, halo) sets, rebased at build
    time: local = units whose whole x span lies in the shard's own chunk,
    in own-chunk coordinates [0, chunk); halo = the rest, in window
    coordinates [0, (2k+1)*chunk).  DIA diagonals stay local — their few
    out-of-chunk edge elements spill into the halo delta table, so the
    dominant DIA stream is never duplicated."""
    own_lo, own_hi = i * chunk, (i + 1) * chunk
    base_h = (i - k) * chunk
    win = (2 * k + 1) * chunk

    dl_r, dl_c, dl_v = [], [], []   # local delta
    dh_r, dh_c, dh_v = [], [], []   # halo delta (incl. DIA/unit spills)

    d = t.delta
    if d is not None and d.nnz:
        cols = np.asarray(d.cols, dtype=np.int64)
        rows = np.asarray(d.row_ids, dtype=np.int64)
        vals = np.asarray(d.vals)
        m = (cols >= own_lo) & (cols < own_hi)
        dl_r.append(rows[m]); dl_c.append(cols[m] - own_lo)
        dl_v.append(vals[m])
        dh_r.append(rows[~m]); dh_c.append(cols[~m] - base_h)
        dh_v.append(vals[~m])

    runs_l, runs_h = [], []
    for rt in t.runs:
        if rt.rows.size == 0:
            continue
        sr, sc = run_step(rt.enc)
        reach = sc * rt.delta * (rt.vals.shape[1] - 1)
        c0 = rt.cols + min(0, reach)
        c1 = rt.cols + max(0, reach)
        m = (c0 >= own_lo) & (c1 < own_hi)
        for sel, base, out in ((m, own_lo, runs_l), (~m, base_h, runs_h)):
            if sel.any():
                out.append(RunTable(
                    enc=rt.enc, delta=rt.delta, rows=rt.rows[sel],
                    cols=rt.cols[sel] - base, sizes=rt.sizes[sel],
                    vals=rt.vals[sel]))

    blocks_l, blocks_h = [], []
    for bt in t.blocks:
        if bt.rows.size == 0:
            continue
        m = (bt.cols >= own_lo) & (bt.cols + bt.bc - 1 < own_hi)
        for sel, base, out in ((m, own_lo, blocks_l), (~m, base_h, blocks_h)):
            if sel.any():
                out.append(BlockTable(
                    enc=bt.enc, rows=bt.rows[sel], cols=bt.cols[sel] - base,
                    vals=bt.vals[sel]))

    dias_l = []
    for dt in t.dias:
        if not dt.ndiags:
            continue
        vals = dt.vals.copy()
        mask = (dt.mask if dt.mask is not None else vals != 0)
        r = np.arange(t.nrows, dtype=np.int64)
        for j, o in enumerate(np.asarray(dt.offsets, dtype=np.int64)):
            xi = (o - r) if dt.anti else (r + o)
            out = mask[j] & ((xi < own_lo) | (xi >= own_hi))
            if out.any():
                rr = r[out]
                dh_r.append(rr)
                dh_c.append(xi[out] - base_h)
                dh_v.append(vals[j, out].copy())
                vals[j, out] = 0
        offs = np.asarray(dt.offsets, dtype=np.int64) - own_lo
        dias_l.append(DiagTable(anti=dt.anti, offsets=offs, vals=vals,
                                mask=None, nnz_count=dt.nnz_count))

    def cat(parts, dtype=None):
        if not parts:
            return np.zeros(0, dtype=dtype if dtype is not None else np.int64)
        return np.concatenate(parts)

    vdt = (t.delta.vals.dtype if t.delta is not None
           else (t.dias[0].vals.dtype if t.dias else np.float32))
    delta_l = _mk_delta(t.nrows, cat(dl_r), cat(dl_c), cat(dl_v, vdt))
    delta_h = _mk_delta(t.nrows, cat(dh_r), cat(dh_c), cat(dh_v, vdt))

    local = CsxTables(nrows=t.nrows, ncols=chunk, nnz=t.nnz,
                      row_start=t.row_start, delta=delta_l, runs=runs_l,
                      blocks=blocks_l, dias=dias_l)
    halo = CsxTables(nrows=t.nrows, ncols=win, nnz=0,
                     row_start=t.row_start, delta=delta_h, runs=runs_h,
                     blocks=blocks_h, dias=[])
    return local, halo


def _rebase_tables_window(t: CsxTables, base_h: int) -> CsxTables:
    """Copy of one symmetric shard's tables with every x-side coordinate
    rebased into the halo window frame (col' = col - base_h): delta/run/
    block cols shift; DIA offsets shift (diag o = col - row_local, anti
    s = row_local + col — both linear in col).  Row coordinates and
    ``row_start`` stay GLOBAL; the kernels re-add ``z_off = base_h`` to
    every z destination derived from a column."""
    d = t.delta
    if d is not None:
        d = DeltaTable(rowptr=d.rowptr, cols=d.cols - base_h,
                       vals=d.vals, row_ids=d.row_ids)
    runs = [RunTable(enc=rt.enc, delta=rt.delta, rows=rt.rows,
                     cols=rt.cols - base_h, sizes=rt.sizes, vals=rt.vals)
            for rt in t.runs]
    blocks = [BlockTable(enc=bt.enc, rows=bt.rows, cols=bt.cols - base_h,
                         vals=bt.vals) for bt in t.blocks]
    dias = [DiagTable(anti=dt.anti, offsets=dt.offsets - base_h,
                      vals=dt.vals, mask=dt.mask, nnz_count=dt.nnz_count)
            for dt in t.dias]
    return CsxTables(nrows=t.nrows, ncols=t.ncols, nnz=t.nnz,
                     row_start=t.row_start, delta=d, runs=runs,
                     blocks=blocks, dias=dias)


class ShardedCsx:
    """SPMD SpMV executor over a 1-D device mesh.

    ``mat`` must have been tuned with as many shards (``spx.rt.nr_threads``)
    as there are devices on the mesh axis.

    x placement (``spx.jax.x_mode``):

    - ``replicated``: x lives replicated on every device (the reference's
      shared read of x, ``CsxKernels.cpp``; XLA broadcasts once).
    - ``halo``: x stays sharded in chunks; each device fetches only the
      ``halo_k`` neighbor chunks its column span actually references via a
      ``ppermute`` ring.  Tables are split at BUILD time into a local set
      (own-chunk coordinates — computed straight off the resident x chunk,
      independent of the ring, so XLA can overlap the exchange with it)
      and a halo set (window coordinates).
    - ``auto`` (default): halo for unsymmetric matrices whose spans need
      fewer than all chunks, replicated otherwise.
    """

    def __init__(self, mat: CsxMatrix, mesh=None, axis: Optional[str] = None):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from sparsex_jax.config import Config
        cfg = Config.instance()
        # axis may be a tuple for multi-host meshes, e.g. ("host", "dev"):
        # shards lay out host-major, so ring neighbors share a host and
        # the halo exchange crosses hosts only at host boundaries.  All
        # collectives (ppermute ring, psum_scatter) take the tuple as one
        # flattened axis.
        self.axis = axis or cfg.mesh_axis
        if mesh is None:
            if isinstance(self.axis, tuple):
                raise ValueError("pass an explicit mesh for tuple axes")
            devs = np.array(jax.devices())
            mesh = Mesh(devs, (self.axis,))
        self.mesh = mesh
        n_dev = mesh.devices.size
        if len(mat.shards) != n_dev:
            raise ValueError(
                f"matrix has {len(mat.shards)} shards but mesh has "
                f"{n_dev} devices; tune with spx.rt.nr_threads={n_dev}")
        self.mat = mat
        self.symmetric = mat.symmetric
        shards = mat.shards

        # x placement mode + halo width (static, from the column spans the
        # shards actually reference).
        self.chunk = -(-mat.ncols // n_dev)
        spans = [_col_span(t) for t in shards]
        k = 0
        for i, (lo, hi) in enumerate(spans):
            if hi > lo:
                k = max(k, i - lo // self.chunk,
                        (hi - 1) // self.chunk - i)
        self.halo_k = k
        if self.symmetric:
            # the window must also cover each shard's OWN row range (the
            # transposed contribution gathers x at global rows; row
            # partitions need not align with column chunks)
            for i, t in enumerate(shards):
                r1 = t.row_start + max(t.nrows, 1)
                k = max(k, i - t.row_start // self.chunk,
                        (r1 - 1) // self.chunk - i)
            self.halo_k = k
        mode = cfg.x_mode
        if mode == "auto":
            mode = "halo" if 2 * k + 1 < n_dev else "replicated"
        self.x_mode = mode

        if mode == "halo" and self.symmetric:
            # symmetric halo: ONE table set per shard in window coords
            # (cols - base_h); z destinations stay global via z_off =
            # base_h (ref CsxSpmv.cpp:66-85 — the reference's m1/m2 split
            # reads shared x; here the window IS the shared region)
            win = (2 * k + 1) * self.chunk
            base_hs = [(i - k) * self.chunk for i in range(n_dev)]
            rebased = [_rebase_tables_window(t, b)
                       for t, b in zip(shards, base_hs)]
            self.arrays, self.meta = stack_shards(rebased, mat.nrows, win)
            gather_off = [t.row_start - b
                          for t, b in zip(shards, base_hs)]
            # per-shard x-frame row offsets + z rebase constants
            self.arrays["row_start"] = np.asarray(
                gather_off, dtype=np.int32)[:, None]
            self.arrays["z_base"] = np.asarray(
                base_hs, dtype=np.int32)[:, None]
            self.h_arrays = self.h_meta = None
        elif mode == "halo":
            locs, halos = [], []
            for i, t in enumerate(shards):
                lt, ht = _split_tables_for_halo(t, i, k, self.chunk)
                locs.append(lt)
                halos.append(ht)
            self.arrays, self.meta = stack_shards(locs, mat.nrows,
                                                  self.chunk)
            win = (2 * k + 1) * self.chunk
            h_arrays, h_meta = stack_shards(
                halos, mat.nrows, win,
                value_dtype=self.arrays["delta"]["vals"].dtype)
            self.h_arrays, self.h_meta = h_arrays, h_meta
            self.arrays = {"local": self.arrays, "halo": h_arrays}
        else:
            self.arrays, self.meta = stack_shards(shards, mat.nrows,
                                                  mat.ncols)
            self.h_arrays = self.h_meta = None
        self.gather_idx = _gather_index(self.meta)
        if self.symmetric:
            max_rows = self.meta["max_rows"]
            dv = np.zeros((n_dev, max_rows),
                          dtype=self.arrays["delta"]["vals"].dtype)
            for i, d in enumerate(mat.dvalues):
                dv[i, : d.size] = d
            self.arrays["dvalues"] = dv

        # Place each shard's tables in its device's memory (the reference's
        # NUMA onnode placement, numa_util.c); log the placement like the
        # reference's allocation checks (CsxBuild.hpp:182-199).
        shard1 = NamedSharding(mesh, P(self.axis))
        self.arrays = jax.tree.map(
            lambda a: jax.device_put(a, shard1), self.arrays)
        from sparsex_jax.logger import log_info
        for i, d in enumerate(mesh.devices.flat):
            log_info("shard %d -> %s (rows [%d,%d), x_mode=%s)", i, d,
                     self.meta["row_start"][i],
                     self.meta["row_start"][i] + self.meta["nrows_loc"][i],
                     self.x_mode)
        self._fn = self._build()

    def _build(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        shard_map = jax.shard_map

        meta = self.meta
        h_meta = self.h_meta
        axis = self.axis
        symmetric = self.symmetric
        # uniform shards lay out contiguously: a reshape+trim replaces the
        # nrows-sized gather
        uniform = all(nl == meta["max_rows"] for nl in meta["nrows_loc"][:-1])
        gather_idx = None if uniform else jnp.asarray(self.gather_idx)

        def reduce_z(acc, z):
            # Cross-shard reduction of transposed partials (ref
            # VecAddFromMap, src/internals/CsxSpmv.cpp:66-85): a
            # reduce-scatter delivers each device only its own row
            # block — half the collective bytes of the full psum.
            # Re-layout z (global rows) into shard-aligned padded
            # blocks first; the pieces are static slices (bandwidth,
            # not gather).
            pieces = []
            for i in range(meta["n"]):
                r0 = meta["row_start"][i]
                nl = meta["nrows_loc"][i]
                piece = jax.lax.slice(z, (r0,), (r0 + nl,))
                if nl < meta["max_rows"]:
                    piece = jnp.pad(piece, (0, meta["max_rows"] - nl))
                pieces.append(piece)
            zp = jnp.concatenate(pieces)
            z_own = jax.lax.psum_scatter(zp, axis, scatter_dimension=0,
                                         tiled=True)
            return acc + z_own

        def device_fn(tbl, x):
            # leading shard axis is size 1 inside shard_map: squeeze it
            tbl = jax.tree.map(lambda a: a[0], tbl)
            dvals = tbl.pop("dvalues") if symmetric else None
            acc, z = _local_spmv(meta, tbl, x, axis_name=axis,
                                 symmetric=symmetric, dvals=dvals)
            if symmetric:
                acc = reduce_z(acc, z)
            return acc[None]

        n = meta["n"]
        chunk = self.chunk
        k = self.halo_k

        def _ring_window(xloc):
            # Ring-exchange the k neighbor chunks each way.
            parts = [xloc]
            left = right = xloc
            fwd = [(j, (j + 1) % n) for j in range(n)]
            bwd = [(j, (j - 1) % n) for j in range(n)]
            for _ in range(k):
                left = jax.lax.ppermute(left, axis, fwd)
                right = jax.lax.ppermute(right, axis, bwd)
                parts = [left] + parts + [right]
            return jnp.concatenate(parts) if k else xloc

        def device_fn_halo(tbl, xloc):
            # xloc: this device's (chunk,) slice of x.  The LOCAL
            # contribution depends only on xloc, so XLA overlaps it with
            # the ring exchange.
            tbl = jax.tree.map(lambda a: a[0], tbl)
            acc, _ = _local_spmv(meta, tbl["local"], xloc)
            xwin = _ring_window(xloc)
            acc_h, _ = _local_spmv(h_meta, tbl["halo"], xwin)
            return (acc + acc_h)[None]

        def device_fn_halo_sym(tbl, xloc):
            # symmetric halo: one table set in window coordinates; z
            # destinations are rebased back to global rows via z_off
            # and reduce-scattered exactly like the replicated path.
            tbl = jax.tree.map(lambda a: a[0], tbl)
            dvals = tbl.pop("dvalues")
            zb = tbl.pop("z_base")[0]
            xwin = _ring_window(xloc)
            acc, z = _local_spmv(meta, tbl, xwin, axis_name=axis,
                                 symmetric=True, dvals=dvals, z_off=zb)
            acc = reduce_z(acc, z)
            return acc[None]

        if self.x_mode == "halo":
            smapped = shard_map(
                device_fn_halo_sym if symmetric else device_fn_halo,
                mesh=self.mesh,
                in_specs=(jax.tree.map(lambda _: P(axis), self.arrays),
                          P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )

            def spmv(arrays, x, alpha, beta, y0):
                xp = jnp.pad(x, (0, n * chunk - x.shape[0]))
                stacked = smapped(arrays, xp)
                flat = stacked.reshape(-1)
                yflat = (flat[: meta["nrows"]] if gather_idx is None
                         else flat[gather_idx])
                return alpha * yflat + beta * y0
        else:
            smapped = shard_map(
                device_fn, mesh=self.mesh,
                in_specs=(jax.tree.map(lambda _: P(axis), self.arrays),
                          P()),
                out_specs=P(axis),
                check_vma=False,
            )

            def spmv(arrays, x, alpha, beta, y0):
                stacked = smapped(arrays, x)  # (n, max_rows), row-sharded
                flat = stacked.reshape(-1)
                yflat = (flat[: meta["nrows"]] if gather_idx is None
                         else flat[gather_idx])
                return alpha * yflat + beta * y0

        return jax.jit(spmv)

    def matvec(self, x, alpha=1.0, beta=0.0, y=None):
        import jax.numpy as jnp
        x = jnp.asarray(x)
        y0 = (jnp.zeros(self.meta["nrows"], dtype=x.dtype)
              if y is None else jnp.asarray(y))
        return self._fn(self.arrays, x, x.dtype.type(alpha),
                        x.dtype.type(beta), y0)

    def matmat(self, X, alpha=1.0, beta=0.0, Y=None):
        """Sharded SpMM: one sharded SpMV per RHS column under ``lax.map``
        (one SPMD pipeline instance in the trace; see the single-chip
        rationale in ``ops/exec.py``)."""
        import jax
        import jax.numpy as jnp
        X = jnp.asarray(X)
        if X.ndim != 2 or X.shape[0] != self.mat.ncols:
            raise ValueError(f"X must be ({self.mat.ncols}, k), "
                             f"got {X.shape}")
        a = X.dtype.type(alpha)
        b0 = X.dtype.type(0.0)
        zeros = jnp.zeros(self.meta["nrows"], dtype=X.dtype)
        fn = self._fn

        @jax.jit
        def mm(arrays, XT):
            return jax.lax.map(lambda c: fn(arrays, c, a, b0, zeros), XT)

        out = mm(self.arrays, X.T).T
        if Y is not None and beta != 0.0:
            out = out + X.dtype.type(beta) * jnp.asarray(Y)
        return out
