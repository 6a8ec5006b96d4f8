"""MMF loader tests (ref Mmf.hpp parser semantics)."""

import numpy as np
import pytest

from sparsex_jax.errors import SparsexError
from sparsex_jax.io.mmf import load_mmf
from tests.fixtures import symmetric_mmf_text


def test_bannerless_sorted():
    text = "3 4 4\n1 1 1.0\n1 3 2.0\n2 2 3.0\n3 4 4.0\n"
    m = load_mmf(text)
    assert (m.nrows, m.ncols, m.nnz) == (3, 4, 4)
    assert m.rows.tolist() == [0, 0, 1, 2]
    assert m.cols.tolist() == [0, 2, 1, 3]
    assert m.vals.tolist() == [1.0, 2.0, 3.0, 4.0]


def test_unsorted_rejected():
    text = "3 3 3\n2 2 3.0\n1 1 1.0\n3 3 4.0\n"
    with pytest.raises(SparsexError):
        load_mmf(text)


def test_symmetric_mirrored():
    text = ("%%MatrixMarket matrix coordinate real symmetric\n"
            "3 3 4\n1 1 1.0\n2 1 2.0\n3 2 3.0\n3 3 4.0\n")
    m = load_mmf(text)
    assert m.nnz == 6  # two off-diagonals mirrored
    dense = np.zeros((3, 3))
    dense[m.rows, m.cols] = m.vals
    assert np.allclose(dense, dense.T)


def test_symmetric_keep_lower():
    text = ("%%MatrixMarket matrix coordinate real symmetric\n"
            "3 3 4\n1 1 1.0\n2 1 2.0\n3 2 3.0\n3 3 4.0\n")
    m = load_mmf(text, keep_lower=True)
    assert m.nnz == 4
    assert np.all(m.rows >= m.cols)


def test_symmetric_upper_entry_rejected():
    text = ("%%MatrixMarket matrix coordinate real symmetric\n"
            "3 3 2\n1 2 1.0\n3 3 4.0\n")
    with pytest.raises(SparsexError):
        load_mmf(text)


def test_nonstandard_banner_tokens():
    m = load_mmf(symmetric_mmf_text())
    assert m.symmetric
    assert m.nrows == 8


def test_zero_base_and_column_wise():
    text = ("%%MatrixMarket matrix coordinate real general 0-base column\n"
            "3 3 3\n0 0 1.0\n2 0 2.0\n1 2 3.0\n")
    # 'column' = stream column-major ordered; coordinates stay (row, col)
    # and the loader sorts (ref Mmf.hpp:359,445-478)
    m = load_mmf(text)
    pairs = set(zip(m.rows.tolist(), m.cols.tolist()))
    assert pairs == {(0, 0), (2, 0), (1, 2)}


def test_wrong_count_rejected():
    with pytest.raises(SparsexError):
        load_mmf("3 3 5\n1 1 1.0\n2 2 2.0\n")


def test_two_column_real_file_rejected():
    """A 'real' file whose lines lack the value column must be rejected,
    not re-tokenized across lines (code-review regression)."""
    import pytest
    from sparsex_jax.errors import SparsexError
    from sparsex_jax.io.mmf import load_mmf
    text = ("%%MatrixMarket matrix coordinate real general\n"
            "3 3 2\n1 1\n2 2\n")
    with pytest.raises(SparsexError):
        load_mmf(text)


def test_extra_column_rejected():
    import pytest
    from sparsex_jax.errors import SparsexError
    from sparsex_jax.io.mmf import load_mmf
    text = ("%%MatrixMarket matrix coordinate real general\n"
            "2 2 2\n1 1 1.0 9\n2 2 1.0\n")
    with pytest.raises(SparsexError):
        load_mmf(text)


def test_mmf_property_roundtrip_fuzz():
    """Random COO -> save_mmf -> load_mmf roundtrips exactly, across banner
    variants; native and NumPy parsers agree."""
    import numpy as np
    from sparsex_jax.io.mmf import load_mmf, save_mmf
    import tempfile, os

    rng = np.random.default_rng(0)
    for seed in range(6):
        r2 = np.random.default_rng(seed + 10)
        nrows = int(r2.integers(1, 40))
        ncols = int(r2.integers(1, 40))
        m = int(r2.integers(0, nrows * ncols // 2 + 1))
        rows = r2.integers(0, nrows, m)
        cols = r2.integers(0, ncols, m)
        _, u = np.unique(rows * ncols + cols, return_index=True)
        rows, cols = rows[u], cols[u]
        o = np.lexsort((cols, rows))
        rows, cols = rows[o], cols[o]
        vals = np.round(r2.standard_normal(rows.size), 6)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "f.mtx")
            save_mmf(path, nrows, ncols, rows, cols, vals)
            mm = load_mmf(path)
        assert (mm.nrows, mm.ncols, mm.nnz) == (nrows, ncols, rows.size)
        np.testing.assert_array_equal(mm.rows, rows)
        np.testing.assert_array_equal(mm.cols, cols)
        np.testing.assert_allclose(mm.vals, vals)


def test_mmf_zero_base_and_column_banner():
    """'column' = the stream is column-major ordered (coordinates stay
    (row, col)); the loader sorts instead of rejecting unsorted input
    (ref Mmf.hpp:359,445-478)."""
    from sparsex_jax.io.mmf import load_mmf
    import numpy as np
    # column-major enumeration of [[1,0],[2,3]], 0-based (row col val)
    text = ("%%MatrixMarket matrix coordinate real general 0-base column\n"
            "2 2 3\n0 0 1.0\n1 0 2.0\n1 1 3.0\n")
    mm = load_mmf(text)
    d = np.zeros((2, 2))
    d[mm.rows, mm.cols] = mm.vals
    np.testing.assert_allclose(d, [[1.0, 0.0], [2.0, 3.0]])
    # out-of-row-order stream is accepted (sorted) under 'column'
    text2 = ("%%MatrixMarket matrix coordinate real general column\n"
             "2 2 2\n2 1 5.0\n1 2 7.0\n")
    mm2 = load_mmf(text2)
    np.testing.assert_array_equal(mm2.rows, [0, 1])
    np.testing.assert_array_equal(mm2.cols, [1, 0])
