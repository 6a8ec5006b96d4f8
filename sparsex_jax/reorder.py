"""RCM (reverse Cuthill-McKee) bandwidth reordering.

Parity with the reference reordering (``include/sparsex/internals/Rcm.hpp``:
``FindPerm`` :116-153, ``DoReorder_RCM`` :219-240/:318-340): build the
symmetrized adjacency graph of the nonzero pattern, run Cuthill-McKee from a
minimum-degree start vertex per component, reverse the order, report the
bandwidth before/after, and permute the matrix (rows and columns).  On
failure the reference warns and returns the identity permutation; same here.

Implemented as a level-by-level BFS over a NumPy CSR adjacency (no
boost::graph / scipy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sparsex_jax.errors import ErrorCode, setwarning
from sparsex_jax.logger import log_info


def _adjacency(n: int, rows: np.ndarray, cols: np.ndarray):
    """Symmetrized CSR adjacency of the pattern (no self loops)."""
    mask = rows != cols
    r = np.concatenate([rows[mask], cols[mask]])
    c = np.concatenate([cols[mask], rows[mask]])
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    # dedupe
    if r.size:
        keep = np.concatenate([[True], (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
        r, c = r[keep], c[keep]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr, c


def cuthill_mckee(n: int, ptr: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """Returns ordering ``order`` (old indices in CM visit order)."""
    degree = np.diff(ptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # Process components in order of minimum degree start vertices.
    deg_order = np.argsort(degree, kind="stable")
    di = 0
    while pos < n:
        while di < n and visited[deg_order[di]]:
            di += 1
        start = deg_order[di]
        visited[start] = True
        order[pos] = start
        pos += 1
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            # Gather all unvisited neighbors of the frontier, sorted by
            # (frontier position, degree) — the classic CM level order.
            nbr_lists = []
            for v in frontier:
                nb = adj[ptr[v]: ptr[v + 1]]
                nb = nb[~visited[nb]]
                if nb.size:
                    nb = nb[np.argsort(degree[nb], kind="stable")]
                    visited[nb] = True
                    nbr_lists.append(nb)
            if not nbr_lists:
                break
            nxt = np.concatenate(nbr_lists)
            order[pos: pos + nxt.size] = nxt
            pos += nxt.size
            frontier = nxt
    return order


def bandwidth(rows: np.ndarray, cols: np.ndarray) -> int:
    if rows.size == 0:
        return 0
    return int(np.max(np.abs(rows.astype(np.int64) - cols.astype(np.int64))))


def reorder_rcm(nrows: int, ncols: int, rows, cols, vals
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Permute A -> P A P^T with the RCM permutation.

    Returns (rows', cols', vals', perm) with ``perm[old] = new`` — apply to
    vectors with ``vec.reorder``/``vec.inv_reorder`` like the reference
    examples (``src/examples/reordering_example.c``).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if nrows != ncols:
        setwarning(ErrorCode.SPX_WARN_REORDER,
                   "RCM requires a square matrix; keeping original order")
        return rows, cols, vals, np.arange(nrows, dtype=np.int64)
    try:
        ptr, adj = _adjacency(nrows, rows, cols)
        order = cuthill_mckee(nrows, ptr, adj)[::-1]  # reverse CM
        perm = np.empty(nrows, dtype=np.int64)
        perm[order] = np.arange(nrows, dtype=np.int64)
    except Exception as e:  # parity: warn + identity on failure
        setwarning(ErrorCode.SPX_WARN_REORDER, f"RCM failed: {e}")
        return rows, cols, vals, np.arange(nrows, dtype=np.int64)

    bw_before = bandwidth(rows, cols)
    new_r, new_c = perm[rows], perm[cols]
    o = np.lexsort((new_c, new_r))
    new_r, new_c, new_v = new_r[o], new_c[o], vals[o]
    log_info("RCM bandwidth: %d -> %d", bw_before, bandwidth(new_r, new_c))
    return new_r, new_c, new_v, perm
