"""Device kernel composition — shared by every SpMV execution path.

The JAX replacement for the reference JIT subsystem (``include/sparsex/
internals/CsxJit.hpp:59-107``, ``src/templates/*.c``): the set of tables
present *is* the specialization — one vectorized kernel per table, composed
into a single traced function that XLA compiles for the device.  Used by
the single-device executor (``ops/exec.py``), the symmetric executor
(``symmetric.py``) and the sharded SPMD program (``parallel/shard.py``).

Execution classes, one per memory-access pattern:

- **DIA tables** (diagonal / anti-diagonal runs folded onto dense offsets):
  one shifted window of x per offset and a fused multiply-add — no
  gathers; XLA fuses all windows of a table into one elementwise pass.
  This replaces the reference's ``diag_tmpl.c``/``rdiag_tmpl.c`` ctl walk.
- **delta table** (leftover singles; ref ``delta_tmpl.c``): x gather +
  sorted segment-sum.
- **run tables** (horizontal/vertical + low-fill diagonals; ref
  ``horiz_tmpl.c``/``vert_tmpl.c``): 2-D x gather, FMA with padded unit
  values, row reduce; horizontal scatter-adds one partial per *unit*,
  strided types scatter-add per element.
- **block tables** (ref ``block_row_tmpl.c``/``block_col_tmpl.c``): per-unit
  (br,bc)x(bc) products + per-(unit,row) scatter-add.

Padded lanes carry zero values and clamped indices, contributing exactly 0.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from sparsex_jax.preprocess.encodings import EncType
from sparsex_jax.preprocess.tables import CsxTables
from sparsex_jax.preprocess.xform import run_step


def static_meta(tables: CsxTables) -> Tuple:
    """Static trace signature of one partition's tables.

    DIA offsets are part of the signature: baking them in lets every
    diagonal lower to a *statically sliced* fused multiply-add (no dynamic
    slices, no padding) — trace-time specialization per matrix, exactly the
    reference's JIT-per-pattern-set design (``CsxJit.hpp``).  The sharded
    executor instead passes ``(anti, None, D)`` (offsets as data) because
    one SPMD program covers shards with different offsets.
    """
    runs = tuple((int(t.enc), t.delta, t.width) for t in tables.runs)
    blocks = tuple((int(t.enc), t.br, t.bc) for t in tables.blocks)
    dias = tuple((t.anti, tuple(int(o) for o in t.offsets), t.ndiags)
                 for t in tables.dias)
    return (tables.nrows, tables.ncols, runs, blocks, dias)


def tables_to_arrays(tables: CsxTables) -> Dict[str, Any]:
    """Extract the array pytree (host numpy; device transfer on first call)."""
    arrs: Dict[str, Any] = {"delta": None, "runs": [], "blocks": [],
                            "dias": []}
    if tables.delta is not None and tables.delta.nnz:
        arrs["delta"] = {
            "row_ids": tables.delta.row_ids,
            "cols": tables.delta.cols,
            "vals": tables.delta.vals,
        }
    for t in tables.runs:
        arrs["runs"].append({"rows": t.rows, "cols": t.cols, "vals": t.vals})
    for t in tables.blocks:
        arrs["blocks"].append({"rows": t.rows, "cols": t.cols, "vals": t.vals})
    for t in tables.dias:
        arrs["dias"].append({"offsets": t.offsets.astype(np.int32),
                             "vals": t.vals})
    return arrs


def _dia_contrib_static(meta_dias, dias, x, nrows_part: int, ncols: int,
                        acc, z=None, x_own=None, nrows_glob: int = 0,
                        z_off: int = 0):
    """DIA contributions with trace-time-static offsets.

    Every diagonal becomes a statically-bounded fused multiply-add over its
    exact valid row range — XLA fuses all diagonals of a table into one
    elementwise pass (one x read + one y write + the dv stream).
    DIAGONAL: ``y[r] += dv[r] * x[r + o]`` for r in [max(0,-o),
    min(nrows, ncols-o)); ANTI: ``y[r] += av[r] * x[s - r]`` for r in
    [max(0, s-ncols+1), min(nrows, s+1)).  Symmetric transposed
    contributions are the mirrored static windows of ``z``.
    """
    import jax
    import jax.numpy as jnp

    mm = x.ndim == 2  # SpMM: x is (ncols, k); windows become row slabs

    def _win(xp, s0, length):
        if mm:
            return jax.lax.slice(xp, (s0, 0), (s0 + length, xp.shape[1]))
        return jax.lax.slice(xp, (s0,), (s0 + length,))

    def _bcast(dvk):
        return dvk[:, None] if mm else dvk

    def _pad(v, lo, hi):
        if not (lo or hi):
            return v
        return jnp.pad(v, ((lo, hi), (0, 0)) if mm else (lo, hi))

    for (anti, offsets, _nd), t in zip(meta_dias, dias):
        dv = t["vals"]
        if not anti:
            # One zero-padded x frame; each diagonal is a static full-length
            # window of it.  Summing full-length windows (instead of
            # chaining .at[r0:r1].add updates) lets XLA fuse all D
            # multiply-adds into a single elementwise pass over the rows.
            # dv is zero wherever no element is stored, so out-of-matrix
            # lanes contribute exactly 0.
            pad_lo = max(0, max((-o for o in offsets), default=0))
            pad_hi = max(0, max((o + nrows_part - ncols for o in offsets),
                                default=0))
            xp = _pad(x, pad_lo, pad_hi)
            total = acc
            for k, o in enumerate(offsets):
                s0 = o + pad_lo
                total = total + _bcast(dv[k]) * _win(xp, s0, nrows_part)
            acc = total
            if z is not None:
                # transposed: z[r + o] += dv[r] * x_own[r] — each diagonal
                # is a static window of the padded product vector.
                for k, o in enumerate(offsets):
                    prod = _bcast(dv[k]) * x_own
                    oz = o + z_off   # halo-sym: cols rebased, z global
                    z0 = max(0, oz)
                    z1 = min(nrows_glob, nrows_part + oz)
                    if z1 > z0:
                        z = z.at[z0:z1].add(prod[z0 - oz: z1 - oz])
        else:
            # anti-diagonal s = r + c: x[s - r] = reversed-x window.
            xr = x[::-1]  # xr[i] = x[ncols-1-i] (row-flip for SpMM)
            pad_lo = max(0, max((s - (ncols - 1) for s in offsets),
                                default=0))
            pad_hi = max(0, max(((nrows_part - 1) - s for s in offsets),
                                default=0))
            xrp = _pad(xr, pad_lo, pad_hi)
            total = acc
            for k, s in enumerate(offsets):
                # x[s - r] for r in [0, nrows) = xr[ncols-1-s+r]
                s0 = ncols - 1 - s + pad_lo
                total = total + _bcast(dv[k]) * _win(xrp, s0, nrows_part)
            acc = total
            if z is not None:
                for k, s in enumerate(offsets):
                    prod = (_bcast(dv[k]) * x_own)[::-1]  # r -> nrows-1-r
                    sz = s + z_off
                    # z[sz - r] += prod_rev[nrows-1-r]: start sz-nrows+1
                    z0 = max(0, sz - nrows_part + 1)
                    z1 = min(nrows_glob, sz + 1)
                    if z1 > z0:
                        p0 = z0 - (sz - nrows_part + 1)
                        z = z.at[z0:z1].add(prod[p0: p0 + (z1 - z0)])
    return acc, z


def dia_contrib(meta_dias, dias, x, nrows_part: int, row_start,
                acc, z=None, x_own=None, nrows_glob: int = 0,
                ncols: Optional[int] = None, z_off: int = 0):
    """Dense-diagonal contributions (and transposed ones when symmetric).

    ``offsets`` are partition-local: DIAGONAL ``o = col - row_local`` (x
    window starts at o), ANTI_DIAGONAL ``s = row_local + col`` (reversed x
    window).  Transposed (symmetric) contributions are dense windows of the
    global partial ``z``: diag mirrors onto ``z[row_local + o]``, anti onto
    ``z[s - row_local]``.

    Dispatches to the static-offset fast path when the meta signature
    carries the offsets (single-device executor); the dynamic ``lax.scan``
    path below serves the sharded SPMD program, whose offsets are per-shard
    data.
    """
    import jax
    import jax.numpy as jnp

    if meta_dias and meta_dias[0][1] is not None:
        return _dia_contrib_static(
            meta_dias, dias, x, nrows_part,
            ncols if ncols is not None else x.shape[0],
            acc, z=z, x_own=x_own, nrows_glob=nrows_glob, z_off=z_off)

    pad = nrows_part
    xp = jnp.pad(x, (pad, pad))
    zp = zrp = None
    if z is not None:
        zp = jnp.pad(z, (pad, pad))
        zrp = jnp.flip(zp)
        Lz = nrows_glob + 2 * pad
    xr = jnp.flip(xp)
    L = x.shape[0] + 2 * pad

    for (anti, _offs, _nd), t in zip(meta_dias, dias):
        offs, dv = t["offsets"], t["vals"]

        if not anti:
            def body(carry, od):
                a, zpl = carry
                o, v = od
                win = jax.lax.dynamic_slice(xp, (o + pad,), (nrows_part,))
                a = a + v * win
                if zpl is not None:
                    # transposed: z[r + o + z_off] += v[r] * x_own[r]
                    zwin = jax.lax.dynamic_slice(zpl, (o + z_off + pad,),
                                                 (nrows_part,))
                    zpl = jax.lax.dynamic_update_slice(
                        zpl, zwin + v * x_own, (o + z_off + pad,))
                return (a, zpl), ()
            (acc, zp), _ = jax.lax.scan(body, (acc, zp), (offs, dv))
        else:
            def body_a(carry, od):
                a, zrpl = carry
                s, v = od
                # x[s - r] for r in [0, nrows_part): reversed window
                start = (L - 1 - pad) - s
                win = jax.lax.dynamic_slice(xr, (start,), (nrows_part,))
                a = a + v * win
                if zrpl is not None:
                    # transposed: z[s + z_off - r] += v[r]*x_own[r] (rev)
                    zstart = (Lz - 1 - pad) - (s + z_off)
                    zwin = jax.lax.dynamic_slice(zrpl, (zstart,),
                                                 (nrows_part,))
                    zrpl = jax.lax.dynamic_update_slice(
                        zrpl, zwin + v * x_own, (zstart,))
                return (a, zrpl), ()
            (acc, zrp), _ = jax.lax.scan(body_a, (acc, zrp), (offs, dv))

    if z is not None:
        z = zp[pad: pad + nrows_glob] + jnp.flip(zrp)[pad: pad + nrows_glob]
        return acc, z
    return acc, None


def local_contrib(meta, arrs, x, *, nrows_part: int, ncols: int,
                  row_start=0, symmetric: bool = False,
                  dvals=None, nrows_glob: Optional[int] = None,
                  z_off: int = 0):
    """One partition's SpMV contribution.

    Returns ``(acc, z)``: ``acc`` dense over the partition's ``nrows_part``
    rows; ``z`` (symmetric only) dense over all ``nrows_glob`` rows with the
    transposed (upper-mirror) contributions, else None.

    ``meta`` is the tuple from :func:`static_meta`; ``arrs`` the pytree from
    :func:`tables_to_arrays`.  ``row_start`` may be a traced scalar (the
    sharded path passes a per-device value).  ``z_off``: halo-symmetric
    rebasing — x-side coordinates (cols, DIA offsets) are in WINDOW
    coordinates while z destinations stay GLOBAL; every z index derived
    from a column adds z_off.
    """
    import jax
    import jax.numpy as jnp

    _nr, _nc, run_meta, block_meta, dia_meta = meta
    dtype = x.dtype
    mm = x.ndim == 2  # SpMM: x is (ncols, k)
    kdim = x.shape[1] if mm else None
    # float32 block products must not drop to TF32 on the GPU
    highest = jax.lax.Precision.HIGHEST
    acc = jnp.zeros((nrows_part, kdim) if mm else nrows_part, dtype=dtype)
    z = None
    x_own = None
    if symmetric:
        nrows_glob = int(nrows_glob if nrows_glob is not None else ncols)
        z = jnp.zeros((nrows_glob, kdim) if mm else nrows_glob, dtype=dtype)
        if mm:
            x_own = jax.lax.dynamic_slice(
                jnp.pad(x, ((0, nrows_part), (0, 0))), (row_start, 0),
                (nrows_part, kdim))
            if dvals is not None:
                acc = acc + dvals[:, None] * x_own
        else:
            x_own = jax.lax.dynamic_slice(
                jnp.pad(x, (0, nrows_part)), (row_start,), (nrows_part,))
            if dvals is not None:
                acc = acc + dvals * x_own

    # --- dense diagonals (elementwise, bandwidth-bound) ---
    if dia_meta:
        acc, z2 = dia_contrib(dia_meta, arrs["dias"], x, nrows_part,
                              row_start, acc,
                              z=z if symmetric else None,
                              x_own=x_own, nrows_glob=nrows_glob or 0,
                              ncols=ncols, z_off=z_off)
        if symmetric:
            z = z2

    # --- delta singles: gather + sorted segment-sum ---
    def _vb(v):
        """values broadcast against a gathered-x block (adds a k axis)."""
        return v[..., None] if mm else v

    def _take_x(idx):
        """x rows/scalars at idx (any idx shape; SpMM appends the k axis)."""
        if mm:
            return jnp.take(x, jnp.clip(idx, 0, ncols - 1), axis=0)
        return jnp.take(x, idx, mode="clip")

    d = arrs["delta"]
    if d is not None and d["cols"].shape[0]:
        prod = _vb(d["vals"]) * _take_x(d["cols"])
        acc = acc + jax.ops.segment_sum(
            prod, d["row_ids"], num_segments=nrows_part,
            indices_are_sorted=True)
        if symmetric:
            # transposed leftovers: z[c] += v * x[r]; row_ids are
            # partition-local and row_start maps them into the x frame
            xg = _take_x(d["row_ids"] + row_start)
            z = z.at[d["cols"] + z_off].add(_vb(d["vals"]) * xg,
                                            mode="drop")

    # --- run tables ---
    for (enc_i, delta, width), t in zip(run_meta, arrs["runs"]):
        sr, sc = run_step(EncType(enc_i))
        lane = jnp.arange(width, dtype=jnp.int32)
        gidx = t["cols"][:, None] + ((sc * delta) * lane)[None, :]
        contrib = _vb(t["vals"]) * _take_x(jnp.clip(gidx, 0, ncols - 1))
        if sr == 0:
            # horizontal: one partial per unit
            partial = jnp.sum(contrib, axis=1)
            acc = acc.at[t["rows"]].add(partial, mode="drop")
        else:
            ridx = t["rows"][:, None] + (sr * delta) * lane[None, :]
            flatidx = jnp.clip(ridx, 0, nrows_part - 1).ravel()
            flat = contrib.reshape(-1, kdim) if mm else contrib.ravel()
            acc = acc.at[flatidx].add(flat, mode="drop")
        if symmetric:
            ridx_g = (t["rows"][:, None] + (sr * delta) * lane[None, :]
                      + row_start)
            zc = _vb(t["vals"]) * _take_x(ridx_g)
            z = z.at[jnp.clip(gidx + z_off, 0,
                              nrows_glob - 1).ravel()].add(
                zc.reshape(-1, kdim) if mm else zc.ravel(), mode="drop")

    # --- block tables ---
    for (enc_i, br, bc), t in zip(block_meta, arrs["blocks"]):
        cidx = t["cols"][:, None] + jnp.arange(bc, dtype=jnp.int32)[None, :]
        ridx = t["rows"][:, None] + jnp.arange(br, dtype=jnp.int32)[None, :]
        xg = _take_x(jnp.clip(cidx, 0, ncols - 1))   # (U, bc[, k])
        if mm:
            contrib = jnp.einsum("urc,uck->urk", t["vals"], xg,
                                 precision=highest,
                                 preferred_element_type=dtype).astype(dtype)
        else:
            # bc is tiny and static: an elementwise multiply-sum, which
            # also keeps float32 exact (no tensor-core product)
            contrib = jnp.sum(t["vals"] * xg[:, None, :], axis=2)
        flat = contrib.reshape(-1, kdim) if mm else contrib.ravel()
        acc = acc.at[jnp.clip(ridx, 0, nrows_part - 1).ravel()].add(
            flat, mode="drop")
        if symmetric:
            xgr = _take_x(jnp.clip(ridx + row_start, 0, ncols - 1))
            if mm:
                tcontrib = jnp.einsum(
                    "urc,urk->uck", t["vals"], xgr, precision=highest,
                    preferred_element_type=dtype).astype(dtype)
                tflat = tcontrib.reshape(-1, kdim)
            else:
                tflat = jnp.sum(t["vals"] * xgr[:, :, None], axis=1).ravel()
            z = z.at[jnp.clip(cidx + z_off, 0,
                              nrows_glob - 1).ravel()].add(tflat,
                                                           mode="drop")

    return acc, z
