"""CSX physical format: per-pattern SoA unit tables.

This is the device replacement for the reference's ``ctl`` byte stream
(``include/sparsex/internals/Csx.hpp:29-81``, ``CtlUtil.hpp:46-67``).  The
ctl stream is a sequential, branchy decode — hostile to wide vector
hardware — so the same *logical* content (pattern type, head coordinates, unit size,
delta, values) is stored as dense structure-of-arrays tables, one table per
pattern instantiation, each of which lowers to a single vectorized kernel:

- ``DeltaTable``  — leftover singletons, CSR-style (ref ``delta_tmpl.c``);
- ``RunTable``    — horizontal / vertical / diagonal / anti-diagonal units
  with stride ``delta`` (ref ``horiz_tmpl.c``/``vert_tmpl.c``/``diag_tmpl.c``
  /``rdiag_tmpl.c``), value rows padded to the table width;
- ``BlockTable``  — dense ``br x bc`` blocks (ref ``block_row_tmpl.c``,
  ``block_col_tmpl.c``) executed as a batched per-unit product.

Units inside a ``RunTable`` are bucketed by padded width (next power of two)
to cap padding waste; padded lanes hold zero values and clamped indices so
they contribute exactly zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from sparsex_jax.preprocess.encodings import EncType
from sparsex_jax.preprocess.xform import run_step


@dataclass
class DeltaTable:
    """Leftover singles: CSR arrays over the partition's rows."""

    rowptr: np.ndarray  # (nrows_part + 1,)
    cols: np.ndarray    # (nnz,)
    vals: np.ndarray    # (nnz,)
    row_ids: np.ndarray  # (nnz,) expanded row index (sorted) — segment ids

    @property
    def nnz(self) -> int:
        return int(self.cols.size)

    def nbytes(self) -> int:
        return self.cols.nbytes + self.vals.nbytes + self.rowptr.nbytes


@dataclass
class RunTable:
    """Constant-stride run units for one (type, delta, padded width)."""

    enc: EncType
    delta: int
    rows: np.ndarray   # (U,) head row
    cols: np.ndarray   # (U,) head col
    sizes: np.ndarray  # (U,) true unit sizes (<= width)
    vals: np.ndarray   # (U, width) zero-padded values

    @property
    def width(self) -> int:
        return int(self.vals.shape[1]) if self.vals.size else 0

    @property
    def nnz(self) -> int:
        return int(self.sizes.sum())

    def nbytes(self) -> int:
        return (self.rows.nbytes + self.cols.nbytes + self.sizes.nbytes
                + self.vals.nbytes)


@dataclass
class BlockTable:
    """Dense br x bc block units (row-extent br, col-extent bc)."""

    enc: EncType
    rows: np.ndarray  # (U,) top row
    cols: np.ndarray  # (U,) left col
    vals: np.ndarray  # (U, br, bc)

    @property
    def br(self) -> int:
        return int(self.vals.shape[1])

    @property
    def bc(self) -> int:
        return int(self.vals.shape[2])

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0] * self.br * self.bc)

    def nbytes(self) -> int:
        return self.rows.nbytes + self.cols.nbytes + self.vals.nbytes


@dataclass
class DiagTable:
    """Dense diagonal storage (DIA) for high-fill diagonal/anti-diagonal
    substructure.

    Device replacement for diagonal run units: a dense shifted window
    needs no index stream and no gather, so it streams at memory
    bandwidth — so every DIAGONAL run (any delta)
    folds onto its constant offset ``o = col - row_local`` and executes as
    ``y[r] += vals[k, r] * x[r + offset_k]``, and every ANTI_DIAGONAL run
    onto ``s = row_global + col`` as ``y[r] += avals[k, r] * x[s_k - r_g]``
    (a reversed window).  Folding happens when a diagonal's fill fraction
    exceeds ``spx.jax.dia_min_fill`` (storage is dense over the partition's
    rows); sparse diagonals stay in their RunTable.

    ``offsets`` for DIAGONAL hold ``col - row_local``; for ANTI_DIAGONAL
    they hold ``row_local + col`` (the anti-diagonal index).
    """

    anti: bool
    offsets: np.ndarray  # (D,) int64
    vals: np.ndarray     # (D, nrows_part) dense values, zeros where absent
    mask: np.ndarray = None  # (D, nrows_part) bool occupancy (host-only;
    #   distinguishes stored zeros from absent entries for get/set/tocoo)
    nnz_count: int = 0   # true stored nonzeros

    @property
    def ndiags(self) -> int:
        return int(self.offsets.size)

    @property
    def nnz(self) -> int:
        return self.nnz_count

    def nbytes(self) -> int:
        return self.offsets.nbytes + self.vals.nbytes


@dataclass
class CsxTables:
    """The complete encoded partition: one delta table + pattern tables.

    Plays the role of the per-thread ``CsxMatrix`` (ref ``Csx.hpp:29-81``).
    ``row_start``/``nr_rows`` delimit the owned row range in the global
    matrix (rows in the tables are partition-local).
    """

    nrows: int
    ncols: int
    nnz: int
    row_start: int
    delta: Optional[DeltaTable]
    runs: List[RunTable] = field(default_factory=list)
    blocks: List[BlockTable] = field(default_factory=list)
    dias: List[DiagTable] = field(default_factory=list)

    def csx_size(self) -> int:
        """Compressed footprint in bytes (ref ``CsxUtil.hpp:117-180``)."""
        total = self.delta.nbytes() if self.delta else 0
        for t in self.runs:
            total += t.nbytes()
        for t in self.blocks:
            total += t.nbytes()
        for t in self.dias:
            total += t.nbytes()
        return total

    def signature(self) -> tuple:
        """Static trace signature: table kinds/shapes determine compiled code."""
        sig = [("delta", self.delta.nnz if self.delta else 0)]
        for t in self.runs:
            sig.append(("run", int(t.enc), t.delta, t.width, t.rows.size))
        for t in self.blocks:
            sig.append(("block", int(t.enc), t.br, t.bc, t.rows.size))
        for t in self.dias:
            sig.append(("dia", t.anti, t.ndiags))
        return tuple(sig)

    def pattern_nnz(self) -> int:
        return (sum(t.nnz for t in self.runs)
                + sum(t.nnz for t in self.blocks)
                + sum(t.nnz for t in self.dias))


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def pack_run_units(enc: EncType, delta: int, heads_r: np.ndarray,
                   heads_c: np.ndarray, sizes: np.ndarray,
                   unit_vals: List[np.ndarray], *, value_dtype,
                   index_dtype, bucket: bool = True) -> List[RunTable]:
    """Pad run units into width-bucketed tables.

    ``unit_vals`` is a single (U, S_max) zero-padded array or a list of 1-D
    arrays; bucketing groups units by next-power-of-two of their size.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.size == 0:
        return []
    if isinstance(unit_vals, np.ndarray):
        padded = unit_vals
    else:
        smax = int(sizes.max())
        padded = np.zeros((sizes.size, smax), dtype=value_dtype)
        for i, v in enumerate(unit_vals):
            padded[i, : v.size] = v
    tables: List[RunTable] = []
    if bucket:
        # Power-of-two width buckets starting at 4 (vectorized).
        buckets = 4 << np.arange(0, 16, dtype=np.int64)
        widths = buckets[np.searchsorted(buckets, sizes, side="left")]
        # Never bucket wider than the largest true size.
        widths = np.minimum(widths, int(sizes.max()))
    else:
        widths = np.full(sizes.shape, int(sizes.max()))
    uniq = np.unique(widths)
    for w in uniq:
        mask = widths == w
        w = int(min(w, padded.shape[1]))
        # One value copy per bucket: fancy-index only the first w columns
        # (``padded[mask][:, :w]`` copied the full smax width first — the
        # dominant pt cost on run-heavy matrices), and let
        # ascontiguousarray do any dtype conversion in the same pass.
        if uniq.size == 1:
            sel = padded if w == padded.shape[1] else padded[:, :w]
            hr, hc, sz = heads_r, heads_c, sizes
        else:
            sel = padded[mask, :w]
            hr, hc, sz = heads_r[mask], heads_c[mask], sizes[mask]
        tables.append(RunTable(
            enc=enc, delta=int(delta),
            rows=np.ascontiguousarray(hr, dtype=index_dtype),
            cols=np.ascontiguousarray(hc, dtype=index_dtype),
            sizes=np.ascontiguousarray(sz, dtype=index_dtype),
            vals=np.ascontiguousarray(sel, dtype=value_dtype),
        ))
    return tables


def fold_diagonals(run_tables: List[RunTable], nrows_part: int, *,
                   min_fill: float, value_dtype) -> Tuple[List[RunTable],
                                                          List[DiagTable]]:
    """Fold diagonal/anti-diagonal run units onto dense DIA arrays.

    A DIAGONAL unit (head r, c, delta d) has all elements on offset
    ``o = c - r``; an ANTI_DIAGONAL unit on ``s = r + c``.  Offsets whose
    accumulated nnz reaches ``min_fill * nrows_part`` are stored densely
    (elementwise execution at memory bandwidth); the rest keep their RunTable
    (gather/scatter execution).  Returns (remaining_runs, dia_tables).
    """
    keep: List[RunTable] = []
    per_offset: Dict[Tuple[bool, int], int] = {}
    # pass 1: per-offset nnz across all diagonal-ish tables (vectorized
    # per unique offset, not per unit)
    diag_tables = []
    for t in run_tables:
        if t.enc == EncType.DIAGONAL:
            offs = t.cols.astype(np.int64) - t.rows.astype(np.int64)
            anti = False
        elif t.enc == EncType.ANTI_DIAGONAL:
            offs = t.rows.astype(np.int64) + t.cols.astype(np.int64)
            anti = True
        else:
            keep.append(t)
            continue
        diag_tables.append((t, anti, offs))
        uo, inv = np.unique(offs, return_inverse=True)
        pernnz = np.bincount(inv, weights=t.sizes.astype(np.float64))
        for o, s in zip(uo, pernnz):
            per_offset[(anti, int(o))] = (per_offset.get((anti, int(o)), 0)
                                          + int(s))
    thresh = max(1.0, min_fill * nrows_part)
    eligible = {k for k, n in per_offset.items() if n >= thresh}
    if not eligible:
        return run_tables, []

    dense: Dict[bool, Dict[int, np.ndarray]] = {False: {}, True: {}}
    dmask: Dict[bool, Dict[int, np.ndarray]] = {False: {}, True: {}}
    counts: Dict[bool, int] = {False: 0, True: 0}
    for t, anti, offs in diag_tables:
        uo, inv = np.unique(offs, return_inverse=True)
        elig_uo = np.array([(anti, int(o)) in eligible for o in uo])
        elig_mask = elig_uo[inv]
        if not elig_mask.any():
            keep.append(t)
            continue
        lane = np.arange(t.width, dtype=np.int64)
        # one vectorized scatter per (offset, table) group: all units on
        # one offset write disjoint row ranges of the same dense array
        for oi in np.flatnonzero(elig_uo):
            o = int(uo[oi])
            dv = dense[anti].get(o)
            if dv is None:
                dv = dense[anti][o] = np.zeros(nrows_part, dtype=value_dtype)
                dmask[anti][o] = np.zeros(nrows_part, dtype=bool)
            sel = np.flatnonzero(inv == oi)
            szs = t.sizes[sel].astype(np.int64)
            valid = lane[None, :] < szs[:, None]
            ridx = (t.rows[sel].astype(np.int64)[:, None]
                    + t.delta * lane[None, :])[valid]
            dv[ridx] = t.vals[sel][valid]
            dmask[anti][o][ridx] = True
            counts[anti] += int(szs.sum())
        if not elig_mask.all():
            m = ~elig_mask
            keep.append(RunTable(enc=t.enc, delta=t.delta, rows=t.rows[m],
                                 cols=t.cols[m], sizes=t.sizes[m],
                                 vals=t.vals[m]))
    dias: List[DiagTable] = []
    for anti in (False, True):
        if dense[anti]:
            offs = np.array(sorted(dense[anti].keys()), dtype=np.int64)
            vals = np.stack([dense[anti][int(o)] for o in offs])
            mask = np.stack([dmask[anti][int(o)] for o in offs])
            dias.append(DiagTable(anti=anti, offsets=offs,
                                  vals=vals.astype(value_dtype),
                                  mask=mask, nnz_count=counts[anti]))
    return keep, dias


def run_unit_coords(enc: EncType, delta: int, width: int):
    """(dr, dc) per-lane offsets: lane j of a unit touches
    (row + dr*j, col + dc*j)."""
    sr, sc = run_step(enc)
    j = np.arange(width, dtype=np.int64)
    return sr * delta * j, sc * delta * j
