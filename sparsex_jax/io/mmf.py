"""MatrixMarket (MMF) loader.

Parity with the reference MMF parser (``include/sparsex/internals/Mmf.hpp:
58-195,364-478``, ``src/internals/Mmf.cpp:27-79``):

- standard banner ``%%MatrixMarket matrix coordinate real {general|symmetric}``
  plus the reference's nonstandard extensions ``0-base``/``1-base`` and
  ``row``/``column`` (ordering of the coordinate stream);
- banner-less files whose first non-comment line is the ``nrows ncols nnz``
  size line are accepted (like ``test/matrices/demopatt.mtx.sorted``);
- symmetric files store only the lower triangle; loading mirrors the
  off-diagonal entries and sorts (ref ``DoLoadMmfMatrix``, ``Mmf.hpp:445-478``)
  unless the caller asks to keep the lower triangle (symmetric CSX);
- general row-wise files must be sorted; out-of-order coordinates raise
  ``SPX_ERR_INPUT_MAT`` (the reference's streaming iterator enforces the same,
  ``Mmf.hpp:197-290``).

The loader is vectorized NumPy end-to-end (no per-element Python loop).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from sparsex_jax.errors import ErrorCode, seterror


@dataclass
class MMF:
    """A loaded MatrixMarket matrix in COO form (0-based, row-major sorted)."""

    nrows: int
    ncols: int
    nnz: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    symmetric: bool = False  # file declared `symmetric`
    stored_lower_only: bool = False  # True when mirroring was skipped
    filename: Optional[str] = None

    def tocoo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.rows, self.cols, self.vals


def _parse_header(first_line: str):
    """Parse the banner line; returns (symmetric, zero_based, colwise, pattern)."""
    toks = first_line.strip().split()
    # toks[0] == '%%MatrixMarket'
    if len(toks) < 5:
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 f"invalid MatrixMarket banner: {first_line!r}")
    obj, fmt, field_, symtok = (t.lower() for t in toks[1:5])
    if obj != "matrix" or fmt != "coordinate":
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 f"unsupported MatrixMarket object/format: {obj}/{fmt}")
    if field_ not in ("real", "integer", "double", "pattern"):
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 f"unsupported MatrixMarket field: {field_}")
    if symtok not in ("general", "symmetric"):
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 f"unsupported MatrixMarket symmetry: {symtok}")
    symmetric = symtok == "symmetric"
    zero_based = False
    colwise = False
    for tok in (t.lower() for t in toks[5:]):
        if tok == "0-base":
            zero_based = True
        elif tok == "1-base":
            zero_based = False
        elif tok == "column":
            colwise = True
        elif tok == "row":
            colwise = False
        else:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     f"unknown MatrixMarket banner token: {tok!r}")
    return symmetric, zero_based, colwise, field_ == "pattern"


def load_mmf(source, *, keep_lower: bool = False,
             index_dtype=np.int32, value_dtype=np.float64) -> MMF:
    """Load a MatrixMarket file (path, file object, or string contents).

    ``keep_lower=True`` keeps only the stored lower triangle of a symmetric
    file (used by the symmetric CSX pipeline); otherwise off-diagonal entries
    are mirrored like the reference's default load.
    """
    filename = None
    if isinstance(source, str) and "\n" not in source:
        filename = source
        try:
            with open(source, "r") as fp:
                text = fp.read()
        except OSError as e:
            seterror(ErrorCode.SPX_ERR_FILE_OPEN, f"cannot open {source!r}: {e}")
    elif isinstance(source, str):
        text = source
    else:
        text = source.read()

    lines = text.splitlines()
    pos = 0
    symmetric = zero_based = colwise = pattern = False
    has_banner = False
    # Skip comments, find banner + size line.
    while pos < len(lines) and (not lines[pos].strip() or
                                lines[pos].lstrip().startswith("%")):
        stripped = lines[pos].strip()
        if stripped.startswith("%%MatrixMarket"):
            symmetric, zero_based, colwise, pattern = _parse_header(stripped)
            has_banner = True
        pos += 1
    if pos >= len(lines):
        seterror(ErrorCode.SPX_ERR_INPUT_MAT, "empty MatrixMarket file")

    size_toks = lines[pos].split()
    if len(size_toks) != 3:
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 f"invalid size line: {lines[pos]!r}")
    nrows, ncols, nnz = (int(t) for t in size_toks)
    pos += 1

    body = "\n".join(lines[pos:])
    ncols_per_line = 2 if pattern else 3
    rows = cols = vals = None
    from sparsex_jax import native
    parsed = native.parse_mmf_body(body, nnz, with_vals=not pattern) \
        if body.strip() else None
    if parsed is not None:
        nr_, nc_, nv_, count = parsed
        if count != nnz:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     f"expected {nnz} entries, found "
                     f"{count if count >= 0 else 'malformed input'}")
        rows, cols = nr_, nc_
        vals = (np.ones(nnz, dtype=value_dtype) if pattern
                else nv_.astype(value_dtype, copy=False))
    else:
        clean = "\n".join(l for l in lines[pos:] if l.strip() and
                          not l.lstrip().startswith("%"))
        data = np.loadtxt(_io.StringIO(clean), dtype=np.float64,
                          ndmin=2) if clean else np.zeros((0, ncols_per_line))
        if data.shape[0] != nnz:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     f"expected {nnz} entries, found {data.shape[0]}")
        if data.shape[0] and data.shape[1] != ncols_per_line:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     f"expected {ncols_per_line} columns per entry, "
                     f"found {data.shape[1]}")
        rows = data[:, 0].astype(np.int64)
        cols = data[:, 1].astype(np.int64)
        vals = (np.ones(nnz, dtype=value_dtype) if pattern
                else data[:, 2].astype(value_dtype))
    if not zero_based:
        rows -= 1
        cols -= 1
    # "column" means the stream is column-major ORDERED; coordinates stay
    # (row, col) — the reference just loads and sorts (Mmf.hpp:359,445-478)

    if rows.size and (rows.min() < 0 or cols.min() < 0 or
                      rows.max() >= nrows or cols.max() >= ncols):
        seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS,
                 "MatrixMarket coordinates out of bounds")

    needs_sort = symmetric or colwise
    if symmetric:
        if np.any(rows < cols):
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     "symmetric MatrixMarket file has upper-triangle entries")
        if not keep_lower:
            off = rows != cols
            r0, c0, v0 = rows, cols, vals
            rows = np.concatenate([r0, c0[off]])
            cols = np.concatenate([c0, r0[off]])
            vals = np.concatenate([v0, v0[off]])
    if needs_sort:
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    else:
        # General row-wise stream must already be sorted (ref Mmf.hpp:197-290
        # raises on out-of-order elements during streaming).
        key = rows * ncols + cols
        if key.size > 1 and np.any(np.diff(key) < 0):
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     "MatrixMarket file is not sorted")

    return MMF(
        nrows=nrows,
        ncols=ncols,
        nnz=int(rows.size),
        rows=rows.astype(index_dtype),
        cols=cols.astype(index_dtype),
        vals=vals,
        symmetric=symmetric,
        stored_lower_only=symmetric and keep_lower,
        filename=filename,
    )


def save_mmf(path: str, nrows: int, ncols: int, rows, cols, vals,
             symmetric: bool = False) -> None:
    """Write a (sorted) COO matrix as a 1-based MatrixMarket file."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    with open(path, "w") as fp:
        sym = "symmetric" if symmetric else "general"
        fp.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
        fp.write(f"{nrows} {ncols} {rows.size}\n")
        for r, c, v in zip(rows, cols, vals):
            fp.write(f"{int(r) + 1} {int(c) + 1} {float(v)!r}\n")
