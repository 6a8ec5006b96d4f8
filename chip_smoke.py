#!/usr/bin/env python
"""Run the CSX SpMV main path once on the GPU, at real sizes, and check it.

Every phase goes through the public API (``input_load_csr`` /
``input_load_mmf`` -> ``mat_tune`` -> ``matvec_kernel`` / ``matmat_kernel``,
the symmetric executor, ``solvers.cg`` and ``ShardedCsx``) and compares the
result with scipy's float64 CSR SpMV:

- ``unsym``: the headline generator (diagonals 0, +-1, 8, -13 + n/2 random
  singles) at n = 2^22, float32 and float64, alpha != 1 and beta != 0;
- ``classes``: the blocky and diag-class generators at n = 2^21, float64,
  tuned by the device heuristic and by the reference's "ratio" one (which
  keeps blocks and diagonal runs as tables);
- ``spmm``: blocky at n = 2^21 through ``matmat_kernel`` with k = 8, both
  heuristics;
- ``hpcg_cg``: HPCG's 27-point stencil on its default 104^3 local grid,
  tuned symmetric, solved by CG in float64 to a relative residual of 1e-8;
- ``mmf``: ``tests/matrices/test3.mtx.sorted`` through the MMF loader;
- ``costs``: XLA's per-element gather, sorted segment-sum, scatter-add and
  streaming multiply-add at the ``unsym`` size (the encoder's cost model).

``--chips 4`` runs only the sharded phase on four cards: the headline at
n = 2^23 and the HPCG stencil, each in ``x_mode`` replicated and halo.

Usage::

    python chip_smoke.py              # one GPU, every single-card phase
    python chip_smoke.py --chips 4    # four GPUs, the sharded phase only

It exits non-zero, printing no result, when JAX finds no GPU.  Its last
line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench  # noqa: E402  (the matrix generators and the error measure)
import sparsex_jax as spx  # noqa: E402
from sparsex_jax.config import Config  # noqa: E402
from sparsex_jax.platform import (  # noqa: E402
    enable_compile_cache, gpu_name_power)

# Tolerances against scipy's float64 CSR SpMV: the reference cross-checks
# an independent library at 1e-7 in double (src/bench/Bench.cpp:256-263);
# float32 sums run in another order (and atomics in a varying one).
TOL = {"float64": 1e-7, "float32": 2e-4}
CG_TOL = 1e-8          # CG stopping rule: ||r|| <= 1e-8 ||b||
CG_CHECK = 1e-7        # the true residual ||b - A x|| / ||b|| must hold
REPS = 20


def card_tag() -> str:
    """The card's name and power limit, for every printed time."""
    cards = gpu_name_power()
    return cards[0] if cards else "no nvidia-smi"


def say(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(devices) -> None:
    """Exit non-zero unless JAX's first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found {plat!r}")


def _configure(dtype: str, **opts) -> None:
    cfg = Config.reset()
    cfg.set("spx.jax.value_dtype", dtype)
    for k, v in opts.items():
        cfg.set(k.replace("__", "."), str(v))


def _csr(n, rows, cols, vals):
    """scipy CSR (float64) of COO arrays."""
    import scipy.sparse as sp
    return _csr_of(sp.coo_matrix((np.asarray(vals, np.float64),
                                  (rows, cols)), shape=(n, n)))


def _csr_of(m):
    import scipy.sparse as sp
    a = sp.csr_matrix(m, dtype=np.float64)
    a.sort_indices()
    return a


def _tune_csr(a, dtype):
    """input_load_csr -> mat_tune on a scipy CSR matrix."""
    t0 = time.perf_counter()
    inp = spx.input_load_csr(a.indptr.astype(np.int64),
                             a.indices.astype(np.int64),
                             a.data.astype(dtype), a.shape[0], a.shape[1])
    mat = spx.mat_tune(inp)
    return mat, time.perf_counter() - t0


def _median_us(fn, reps: int = REPS) -> float:
    """Host-clock µs per call: median of ``reps`` after a warm-up."""
    fn().block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def _device_us(fn) -> str:
    """Device busy µs of one call from a profiler trace (min of three);
    "not measured" off the GPU, whose trace has no device plane."""
    import jax
    if jax.devices()[0].platform != "gpu":
        return "device busy not measured"
    return f"device busy {bench._device_time_per_iter(fn, 1) * 1e6:.1f} us"


def _tables(mat) -> str:
    t = mat.csx.shards[0]
    parts = [f"delta={t.delta.nnz if t.delta is not None else 0}"]
    parts += [f"{r.enc.name}(d={r.delta},w={r.width})x{r.rows.size}"
              for r in t.runs]
    parts += [f"BLOCK{b.br}x{b.bc}x{b.rows.size}" for b in t.blocks]
    parts += [f"{'ANTI_' if d.anti else ''}DIA x{d.ndiags}" for d in t.dias]
    return " ".join(parts)


def _check(name: str, got, want, tol: float) -> float:
    err = bench._mixed_rel_err(got, want)
    say(f"[{name}] mixed rel err vs scipy f64 = {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"[{name}] error {err:.3e} above {tol:g}")
    return err


def _memory_analysis(mat, x, alpha, beta, y) -> str:
    """The compiled SpMV program's memory analysis (one-shard matrix)."""
    from sparsex_jax.ops.exec import _compiled
    ex = mat.csx.executors[0]
    fn = _compiled(ex.meta, ex._dtype, apply_alpha=True, apply_beta=True)
    ma = fn.lower(ex._device(), x, x.dtype.type(alpha), x.dtype.type(beta),
                  y).compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k}={getattr(ma, k, None)}" for k in keys)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_unsym(n: int = 1 << 22, dtypes=("float32", "float64")) -> dict:
    """Headline matrix: CSR loader -> mat_tune -> matvec_kernel."""
    import jax.numpy as jnp

    rows, cols, vals = bench.build_matrix(n)
    a = _csr(n, rows, cols, vals)
    say(f"[unsym] n={n} nnz={a.nnz} csr_f64_bytes="
        f"{a.nnz * 12 + (n + 1) * 8}")
    rng = np.random.default_rng(1)
    x64, y64 = rng.standard_normal(n), rng.standard_normal(n)
    alpha, beta = 1.5, -0.5
    out = {}
    tag = card_tag()
    for dt in dtypes:
        _configure(dt)
        mat, pt = _tune_csr(a, dt)
        say(f"[unsym/{dt}] mat_tune {pt:.2f} s [{tag}]; tables: "
            f"{_tables(mat)}")
        x, y = jnp.asarray(x64.astype(dt)), jnp.asarray(y64.astype(dt))
        got = np.asarray(spx.matvec_kernel(alpha, mat, x, beta, y))
        want = (alpha * (a @ x64.astype(dt).astype(np.float64))
                + beta * y64.astype(dt).astype(np.float64))
        err = _check(f"unsym/{dt}", got, want, TOL[dt])
        run = lambda: spx.matvec_kernel(alpha, mat, x, beta, y)  # noqa
        us = _median_us(run)
        say(f"[unsym/{dt}] {us:.1f} us/SpMV host clock (median of {REPS}),"
            f" {_device_us(run)} [{tag}]")
        say(f"[unsym/{dt}] SpMV program memory: "
            f"{_memory_analysis(mat, x, alpha, beta, y)}")
        out[dt] = {"err": err, "us": us}
    return out


def phase_classes(n: int = 1 << 21) -> dict:
    """Blocky and diag-class matrices (every run class, blocks, delta)."""
    import jax.numpy as jnp

    out = {}
    tag = card_tag()
    x64 = np.random.default_rng(2).standard_normal(n)
    # the device heuristic turns blocky's 4x2 blocks into vertical runs
    # and leaves diagc's short diagonal runs as singles; the reference's
    # "ratio" heuristic keeps them as block and diagonal run tables
    for name, gen, heuristic in (
            ("blocky", bench.build_blocky_matrix, "device"),
            ("blocky/ratio", bench.build_blocky_matrix, "ratio"),
            ("diagc", bench.build_diagc_matrix, "device"),
            ("diagc/ratio", bench.build_diagc_matrix, "ratio")):
        rows, cols, vals = gen(n)
        a = _csr(n, rows, cols, vals)
        _configure("float64", spx__preproc__heuristic=heuristic)
        mat, pt = _tune_csr(a, "float64")
        say(f"[classes/{name}] n={n} nnz={a.nnz} mat_tune {pt:.2f} s "
            f"[{tag}]; "
            f"tables: {_tables(mat)}")
        x = jnp.asarray(x64)
        got = np.asarray(spx.matvec_mult(1.0, mat, x))
        err = _check(f"classes/{name}", got, a @ x64, TOL["float64"])
        run = lambda: spx.matvec_mult(1.0, mat, x)  # noqa: E731
        us = _median_us(run)
        say(f"[classes/{name}] {us:.1f} us/SpMV host clock (median of "
            f"{REPS}), {_device_us(run)} [{tag}]")
        out[name] = {"err": err, "us": us}
    return out


def phase_spmm(n: int = 1 << 21, k: int = 8,
               dtypes=("float32", "float64")) -> dict:
    """Blocky matrix through matmat_kernel (SpMM, k right-hand sides),
    tuned by the device heuristic (runs) and by "ratio" (4x2 blocks, whose
    products run as einsums at HIGHEST precision)."""
    import jax.numpy as jnp

    rows, cols, vals = bench.build_blocky_matrix(n)
    a = _csr(n, rows, cols, vals)
    rng = np.random.default_rng(3)
    X64, Y64 = rng.standard_normal((n, k)), rng.standard_normal((n, k))
    out = {}
    tag = card_tag()
    for heuristic in ("device", "ratio"):
        for dt in dtypes:
            name = f"spmm/{heuristic}/{dt}"
            _configure(dt, spx__preproc__heuristic=heuristic)
            mat, pt = _tune_csr(a, dt)
            X, Y = jnp.asarray(X64.astype(dt)), jnp.asarray(Y64.astype(dt))
            got = np.asarray(spx.matmat_kernel(2.0, mat, X, 0.5, Y))
            want = (2.0 * (a @ X64.astype(dt).astype(np.float64))
                    + 0.5 * Y64.astype(dt).astype(np.float64))
            err = _check(name, got, want, TOL[dt])
            run = lambda: spx.matmat_kernel(2.0, mat, X, 0.5, Y)  # noqa
            us = _median_us(run)
            say(f"[{name}] k={k} {us:.1f} us/SpMM host clock (median of "
                f"{REPS}), {_device_us(run)} [{tag}]; tables: "
                f"{_tables(mat)}")
            out[name] = {"err": err, "us": us}
    return out


def hpcg_stencil(nx: int):
    """HPCG's 27-point operator on an nx^3 grid: diagonal 26, every
    neighbour (including the diagonal ones) -1; sorted COO."""
    idx = np.arange(nx ** 3, dtype=np.int64).reshape(nx, nx, nx)
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                src = idx[max(0, -dz): nx - max(0, dz),
                          max(0, -dy): nx - max(0, dy),
                          max(0, -dx): nx - max(0, dx)]
                rows.append(src.ravel())
                cols.append((src + (dz * nx + dy) * nx + dx).ravel())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 26.0, -1.0)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def phase_hpcg_cg(nx: int = 104) -> dict:
    """Symmetric 27-point stencil: mat_tune (symmetric) -> CG to 1e-8."""
    import jax
    import jax.numpy as jnp

    from sparsex_jax.solvers import cg

    n = nx ** 3
    rows, cols, vals = hpcg_stencil(nx)
    a = _csr(n, rows, cols, vals)
    tag = card_tag()
    _configure("float64", spx__matrix__symmetric="true")
    mat, pt = _tune_csr(a, "float64")
    say(f"[hpcg] grid {nx}^3: n={n} nnz={a.nnz} mat_tune {pt:.2f} s "
        f"[{tag}]; "
        f"lower-triangle tables: {_tables(mat)}")
    b64 = a @ np.ones(n)                    # HPCG's exact solution is 1
    b = jnp.asarray(b64)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(n))
    csx = mat.csx
    out = {}
    # both symmetric variants: per-shard z-scatter (the default) and the
    # mirrored full tables (spx.jax.sym_full=on)
    for mode in ("auto", "on"):
        Config.instance().set("spx.jax.sym_full", mode)
        got = np.asarray(csx.matvec(x))
        _check(f"hpcg/spmv sym_full={mode}", got, a @ np.asarray(x),
               TOL["float64"])
        run = lambda: csx.matvec(x)  # noqa: E731
        us = _median_us(run)
        say(f"[hpcg] symmetric SpMV sym_full={mode}: {us:.1f} us host "
            f"clock (median of {REPS}), {_device_us(run)} "
            f"[{tag}]")
        out[f"spmv_us_sym_full_{mode}"] = us
    Config.instance().set("spx.jax.sym_full", "auto")
    solve = jax.jit(lambda rhs: cg(csx.matvec, rhs, tol=CG_TOL,
                                   maxiter=5000))
    xs, it, _res = solve(b)
    xs.block_until_ready()                  # compile + first solve
    t0 = time.perf_counter()
    xs, it, _res = solve(b)
    xs.block_until_ready()
    secs = time.perf_counter() - t0
    true_res = float(np.linalg.norm(b64 - a @ np.asarray(xs))
                     / np.linalg.norm(b64))
    say(f"[hpcg] CG: {int(it)} iterations, {secs:.3f} s, true residual "
        f"{true_res:.3e} (tol {CG_CHECK:g}) [{tag}]")
    if not true_res <= CG_CHECK:
        raise AssertionError(f"[hpcg] CG residual {true_res:.3e}")
    out.update(iterations=int(it), seconds=secs, residual=true_res)
    return out


def phase_mmf(path: str = os.path.join(HERE, "tests", "matrices",
                                       "test3.mtx.sorted")) -> dict:
    """The MatrixMarket loader entry path."""
    import scipy.io

    _configure("float64")
    mat = spx.mat_tune(spx.input_load_mmf(path))
    a = _csr_of(scipy.io.mmread(path))
    x64 = np.random.default_rng(5).standard_normal(a.shape[1])
    got = np.asarray(spx.matvec_mult(1.0, mat, x64))
    return {"err": _check("mmf", got, a @ x64, TOL["float64"])}


def phase_costs(n: int = 1 << 22) -> dict:
    """Per-element device ns of XLA's gather, sorted segment-sum,
    scatter-add and streaming multiply-add over the unsym phase's element
    count (float32): the constants of ``Encoder._device_exec_ns``."""
    import jax
    import jax.numpy as jnp

    m = 11 * n // 2                         # ~nnz of the headline matrix
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, n, m).astype(np.int32))
    seg = jnp.asarray(np.sort(rng.integers(0, n, m)).astype(np.int32))
    # operands are arguments, not closed-over constants, so XLA cannot
    # fold the work away at compile time
    ops = {
        "gather": (lambda x, i: jnp.take(x, i, mode="clip"), (x, idx)),
        "segsum": (lambda v, s: jax.ops.segment_sum(
            v, s, num_segments=n, indices_are_sorted=True), (v, seg)),
        "scatter": (lambda v, i: jnp.zeros(n, jnp.float32).at[i].add(
            v, mode="drop"), (v, idx)),
        "stream": (lambda v, w: v * w + v, (v, w)),
    }
    tag = card_tag()
    out = {}
    for name, (f, args) in ops.items():
        fj = jax.jit(f)
        ns = bench._device_time_per_iter(lambda: fj(*args), 1) * 1e9 / m
        say(f"[costs] {name}: {ns:.4f} ns/element (device busy) over {m} "
            f"elements [{tag}]")
        out[name] = ns
    return out


def phase_sharded(n: int = 1 << 23, nx: int = 104, ndev: int = 4) -> dict:
    """ShardedCsx on ndev devices: headline + HPCG stencil, x_mode
    replicated and halo, each against scipy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sparsex_jax.parallel.shard import ShardedCsx

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("shards",))
    tag = card_tag()
    out = {}
    mats = {"headline": (n, bench.build_matrix(n), False),
            "hpcg": (nx ** 3, hpcg_stencil(nx), True)}
    for name, (nn, (rows, cols, vals), sym) in mats.items():
        a = _csr(nn, rows, cols, vals)
        x64 = np.random.default_rng(7).standard_normal(nn)
        x = jnp.asarray(x64)
        want = a @ x64
        for mode in ("replicated", "halo"):
            _configure("float64", spx__rt__nr_threads=ndev,
                       spx__jax__x_mode=mode,
                       spx__matrix__symmetric="true" if sym else "false")
            mat, pt = _tune_csr(a, "float64")
            sh = ShardedCsx(mat.csx, mesh=mesh)
            assert sh.x_mode == mode
            got = np.asarray(sh.matvec(x))
            err = _check(f"sharded/{name}/{mode}", got, want,
                         TOL["float64"])
            run = lambda: sh.matvec(x)  # noqa: E731
            us = _median_us(run)
            say(f"[sharded/{name}/{mode}] n={nn} nnz={a.nnz} on {ndev} "
                f"devices (halo_k={sh.halo_k}): {us:.1f} us/SpMV host clock "
                f"(median of {REPS}), {_device_us(run)} "
                f"[{tag}]")
            out[f"{name}/{mode}"] = {"err": err, "us": us}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4 runs only the sharded phase on four GPUs")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    require_gpu(jax.devices())
    say(f"compile cache: {enable_compile_cache()}")
    cards = gpu_name_power()
    for line in cards:
        say(f"card: {line}")
    tag = card_tag()
    t0 = time.perf_counter()
    if args.chips == 4:
        if len(jax.devices()) < 4:
            raise SystemExit(f"chip_smoke: --chips 4 needs four GPUs, JAX "
                             f"found {len(jax.devices())}")
        phase_sharded()
    else:
        for phase in (phase_unsym, phase_classes, phase_spmm, phase_hpcg_cg,
                      phase_mmf, phase_costs):
            t1 = time.perf_counter()
            phase()
            say(f"== {phase.__name__} done in "
                f"{time.perf_counter() - t1:.1f} s [{tag}]")
    dev = jax.devices()[0]
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s [{tag}]")
    say(", ".join(cards) if cards else "no nvidia-smi")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
