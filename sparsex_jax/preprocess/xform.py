"""Coordinate transforms between iteration orders.

Parity with the reference Xform bijections (``include/sparsex/internals/
Xform.hpp:106-222,420-443``), re-expressed 0-based and vectorized over NumPy
arrays.  ``to_xform`` maps original (row, col) to transformed (trow, tcol)
such that a substructure run of the given type is a constant-stride run in
``tcol`` within one ``trow``; ``from_xform`` inverts.

- HORIZONTAL      : (r, c)
- VERTICAL        : (c, r)
- DIAGONAL        : (nrows-1 + c - r, r)          — run step (r+1, c+1)
- ANTI_DIAGONAL   : (r + c, r)                    — run step (r+1, c-1)
- BLOCK_ROW_R     : (r // R, (r % R) + R*c)       — aligned tcol-runs of
                    length R*k are dense R×k blocks (ref ``Xform.hpp:180-187``)
- BLOCK_COL_C     : (c // C, (c % C) + C*r)

The reference keeps secondary diagonal coordinates as ``min(r, c)``; using
``r`` instead is an equivalent bijection (monotone within each diagonal) with
the same run/delta semantics.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sparsex_jax.preprocess.encodings import EncType


def to_xform(t: EncType, rows: np.ndarray, cols: np.ndarray,
             nrows: int, ncols: int) -> Tuple[np.ndarray, np.ndarray]:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if t in (EncType.HORIZONTAL, EncType.NONE):
        return rows, cols
    if t == EncType.VERTICAL:
        return cols, rows
    if t == EncType.DIAGONAL:
        return (nrows - 1) + cols - rows, rows
    if t == EncType.ANTI_DIAGONAL:
        return rows + cols, rows
    a = t.block_alignment
    if t.is_block_row:
        return rows // a, (rows % a) + a * cols
    if t.is_block_col:
        return cols // a, (cols % a) + a * rows
    raise ValueError(f"no transform for {t}")


def from_xform(t: EncType, trows: np.ndarray, tcols: np.ndarray,
               nrows: int, ncols: int) -> Tuple[np.ndarray, np.ndarray]:
    trows = np.asarray(trows, dtype=np.int64)
    tcols = np.asarray(tcols, dtype=np.int64)
    if t in (EncType.HORIZONTAL, EncType.NONE):
        return trows, tcols
    if t == EncType.VERTICAL:
        return tcols, trows
    if t == EncType.DIAGONAL:
        return tcols, trows - (nrows - 1) + tcols
    if t == EncType.ANTI_DIAGONAL:
        return tcols, trows - tcols
    a = t.block_alignment
    if t.is_block_row:
        return trows * a + (tcols % a), tcols // a
    if t.is_block_col:
        return tcols // a, trows * a + (tcols % a)
    raise ValueError(f"no transform for {t}")


def run_step(t: EncType) -> Tuple[int, int]:
    """(dr, dc): original-coordinate step per unit tcol increment for
    run types (non-block).  A run with delta d steps (dr*d, dc*d)."""
    if t in (EncType.HORIZONTAL, EncType.NONE):
        return 0, 1
    if t == EncType.VERTICAL:
        return 1, 0
    if t == EncType.DIAGONAL:
        return 1, 1
    if t == EncType.ANTI_DIAGONAL:
        return 1, -1
    raise ValueError(f"{t} is a block type")
