"""Miner unit tests (ref EncodingManager UpdateStats/DoEncode semantics)."""

import numpy as np

from sparsex_jax.preprocess.mining import mine_blocks, mine_runs, split_block_runs


def _mine(rows, cols, **kw):
    kw.setdefault("min_limit", 4)
    kw.setdefault("max_limit", 255)
    return mine_runs(np.asarray(rows), np.asarray(cols), **kw)


def test_simple_horizontal_run():
    # one row, cols 2,4,6,8 -> one delta-2 run of 4 elements
    res = _mine([0, 0, 0, 0], [2, 4, 6, 8])
    assert len(res.runs) == 1
    ru = res.runs[0]
    assert ru.delta == 2
    assert ru.sizes.tolist() == [4]
    assert res.tcols[ru.heads[0]] == 2
    assert res.covered.all()


def test_short_run_not_pattern():
    # 3 elements with equal gaps: below min_unit_size=4
    res = _mine([0, 0, 0], [1, 2, 3])
    assert res.runs == []
    assert not res.covered.any()


def test_absorb_previous_single():
    # cols 0, 10, 11, 12, 13: run of gap-1 has 3 deltas + absorbed anchor = 4
    res = _mine([0] * 5, [0, 10, 11, 12, 13])
    assert len(res.runs) == 1
    ru = res.runs[0]
    assert ru.delta == 1
    assert ru.sizes.tolist() == [4]
    # element at col 0 stays a single
    assert res.covered.sum() == 4


def test_adjacent_runs_claim_anchor():
    # run A: 0,1,2,3,4 (gap1); run B continues 4,6,8,10 (gap2, anchor col 4
    # claimed by A) -> B has 3 deltas and cannot absorb: not a pattern.
    cols = [0, 1, 2, 3, 4, 6, 8, 10]
    res = _mine([0] * len(cols), cols)
    assert len(res.runs) == 1
    assert res.runs[0].delta == 1
    assert res.runs[0].sizes.tolist() == [5]
    assert res.covered.sum() == 5


def test_adjacent_runs_second_long_enough():
    # B has 4 deltas -> pattern even without the anchor.
    cols = [0, 1, 2, 3, 4, 6, 8, 10, 12]
    res = _mine([0] * len(cols), cols)
    deltas = sorted(ru.delta for ru in res.runs)
    assert deltas == [1, 2]
    sizes = {ru.delta: ru.sizes.tolist() for ru in res.runs}
    assert sizes[1] == [5]
    assert sizes[2] == [4]
    assert res.covered.all()


def test_max_limit_split_and_remainder():
    # 23 consecutive elements with max_limit 8: units of 8,8,7
    cols = list(range(23))
    res = _mine([0] * 23, cols, max_limit=8)
    assert len(res.runs) == 1
    assert sorted(res.runs[0].sizes.tolist()) == [7, 8, 8]
    # remainder of 2 (<min 4) is dropped back to singles
    res2 = _mine([0] * 18, list(range(18)), max_limit=8)
    assert sorted(res2.runs[0].sizes.tolist()) == [8, 8]
    assert res2.covered.sum() == 16


def test_rows_do_not_merge():
    # same cols in two rows: each row run independently
    rows = [0, 0, 0, 0, 1, 1, 1, 1]
    cols = [5, 6, 7, 8, 5, 6, 7, 8]
    res = _mine(rows, cols)
    assert len(res.runs) == 1
    assert res.runs[0].sizes.tolist() == [4, 4]


def test_allowed_deltas_filter():
    cols = [0, 2, 4, 6, 20, 21, 22, 23, 24]
    res = _mine([0] * 9, cols, allowed_deltas=np.array([1]))
    assert len(res.runs) == 1
    assert res.runs[0].delta == 1


def test_block_mining_aligned():
    # dense 2x3 block rows 4..5, cols 7..9 in BlockRow2 space:
    # trow = r//2, tcol = (r%2) + 2*c — 6 consecutive tcols, aligned
    rows = np.repeat([4, 5], 3)
    cols = np.tile([7, 8, 9], 2)
    trow = rows // 2
    tcol = (rows % 2) + 2 * cols
    res = mine_blocks(trow, tcol, align=2)
    assert res.block_runs is not None
    assert res.block_runs.other_dims.tolist() == [3]
    heads, sizes, k = split_block_runs(res.block_runs, kmax=64)
    assert k == 3
    assert sizes.tolist() == [6]


def test_block_misaligned_start_skipped():
    # rows 3..4 not aligned to 2: only the aligned sub-block (row 4) won't
    # form a 2-row block; expect no block runs
    rows = np.repeat([3, 4], 4)
    cols = np.tile([0, 1, 2, 3], 2)
    trow = rows // 2
    tcol = (rows % 2) + 2 * cols
    res = mine_blocks(trow, tcol, align=2)
    # rows 3 and 4 are in different trows; each trow has a gap-1 run of 4
    # tcols but misaligned coverage -> other_dim per trow = 2 at best
    if res.block_runs is not None:
        assert (res.block_runs.other_dims >= 2).all()


def test_explicit_block_second_dim():
    """'br2{4}' must emit only 2x4 blocks (explicit instantiation parity)."""
    import numpy as np
    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.ops.oracle import max_rel_error

    cfg = Config.instance()
    cfg.set("spx.preproc.xform", "br2{4}")
    cfg.set("spx.preproc.sampling", "none")
    n = 64
    # one 2x8 dense block: with k forced to 4 it must split into two 2x4s
    rr, cc = np.meshgrid(np.arange(2), np.arange(8), indexing="ij")
    rows = (10 + rr).ravel().astype(np.int64)
    cols = (20 + cc).ravel().astype(np.int64)
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = np.arange(1.0, rows.size + 1)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    t = mat.shards[0]
    assert t.blocks and all(b.br == 2 and b.bc == 4 for b in t.blocks)
    assert sum(b.vals.shape[0] for b in t.blocks) == 2
    x = np.random.default_rng(0).standard_normal(n)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    assert max_rel_error(np.asarray(mat.matvec(x)), dense @ x) < 1e-12
