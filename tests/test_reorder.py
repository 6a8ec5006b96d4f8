"""RCM reordering unit tests (ref ``include/sparsex/internals/Rcm.hpp``)."""

import numpy as np
import pytest

from sparsex_jax.reorder import bandwidth, cuthill_mckee, reorder_rcm


def band_after(nrows, rows, cols, vals):
    r2, c2, v2, perm = reorder_rcm(nrows, nrows, rows, cols, vals)
    return bandwidth(r2, c2), perm, (r2, c2, v2)


def test_rcm_reduces_bandwidth():
    """A ring graph laid out badly: RCM must shrink the bandwidth a lot."""
    n = 200
    rng = np.random.default_rng(0)
    relabel = rng.permutation(n)  # scramble a path graph's labels
    src = relabel[np.arange(n - 1)]
    dst = relabel[np.arange(1, n)]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = np.ones(rows.size)
    bw0 = bandwidth(rows, cols)
    bw1, perm, _ = band_after(n, rows, cols, vals)
    assert bw1 <= 2  # a path graph renumbers to bandwidth 1 (2 worst case)
    assert bw1 < bw0
    # perm is a permutation
    assert sorted(perm.tolist()) == list(range(n))


def test_rcm_disconnected_components():
    n = 30
    # two separate chains + isolated vertices
    rows = np.concatenate([np.arange(0, 9), np.arange(1, 10),
                           np.arange(15, 19), np.arange(16, 20)])
    cols = np.concatenate([np.arange(1, 10), np.arange(0, 9),
                           np.arange(16, 20), np.arange(15, 19)])
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = np.arange(1.0, rows.size + 1)
    bw1, perm, (r2, c2, v2) = band_after(n, rows, cols, vals)
    assert sorted(perm.tolist()) == list(range(n))
    # values follow their coordinates: dense matrices must be permutation-
    # equivalent
    d0 = np.zeros((n, n))
    d0[rows, cols] = vals
    d2 = np.zeros((n, n))
    d2[r2, c2] = v2
    np.testing.assert_allclose(d2, d0[np.argsort(perm)][:, np.argsort(perm)])


def test_rcm_rectangular_warns_identity():
    rows = np.array([0, 1])
    cols = np.array([1, 2])
    vals = np.array([1.0, 2.0])
    r2, c2, v2, perm = reorder_rcm(3, 5, rows, cols, vals)
    np.testing.assert_array_equal(perm, np.arange(3))
    np.testing.assert_array_equal(r2, rows)


def test_cuthill_mckee_visits_everything():
    n = 50
    rng = np.random.default_rng(1)
    rows = rng.integers(0, n, 120)
    cols = rng.integers(0, n, 120)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    from sparsex_jax.reorder import _adjacency
    ptr, adj = _adjacency(n, np.concatenate([rows, cols]),
                          np.concatenate([cols, rows]))
    order = cuthill_mckee(n, ptr, adj)
    assert sorted(order.tolist()) == list(range(n))
