"""SpMV benchmark — SparseX measurement protocol on the GPU.

Protocol parity (ref ``src/bench/SparsexModule.cpp:66-88``,
``src/bench/main.cpp:51-77``): LOOPS=128 kernel invocations per timing,
median; throughput = nnz*LOOPS/secs (and MFLOPS = 2x that / 1e6).
Environment overrides LOOPS like the reference bench tool.

Timing: the chained kernel runs K iterations inside one jit (a
``lax.scan`` with a data dependency between iterations so nothing can be
elided), traced by ``jax.profiler``; per-iteration time is the device's
busy time (the union of kernel intervals on the GPU stream lines of the
trace) over K.  With no GPU in the trace the bench fails; it never falls
back to host clocks or to the CPU.

Workloads, so every execution class is captured:
- **headline**: banded diagonals + random singles (DIA + delta path).
- **blocky**: dense 4x2 blocks + horizontal runs + singles (block tables +
  unit gathers + delta).
- **symmetric**, **diagc** (diagonal/anti-diagonal/vertical runs), SpMM at
  k=8 and SpGEMM.

``vs_baseline`` is measured against the BASELINE.md target: >= 85% of the
device-memory speed-of-light nnz/s for the *compressed footprint* (SoL =
ideal_bytes / measured triad bandwidth).  1.0 means the target is met.
"""

import json
import os
import signal
import sys
import time

import numpy as np


LOOPS = int(os.environ.get("LOOPS", "128"))
N = int(os.environ.get("BENCH_N", str(1 << 20)))
N_BLOCKY = int(os.environ.get("BENCH_N_BLOCKY", str(1 << 19)))
N_SYM = int(os.environ.get("BENCH_N_SYM", str(1 << 20)))
N_DIAGC = int(os.environ.get("BENCH_N_DIAGC", str(1 << 19)))
SECTION_TIMEOUT_S = int(os.environ.get("BENCH_SECTION_TIMEOUT_S", "1200"))
# f32 accumulation-order tolerance for the in-run oracle cross-check
# (ref checks 1e-7 in f64, Bench.cpp:256-263; f32 SpMV reorders sums)
CHECK_TOL = float(os.environ.get("BENCH_CHECK_TOL", "2e-4"))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(value, vs_baseline, extra):
    """The ONE structured JSON line the driver records."""
    print(json.dumps({
        "metric": "csx_spmv_nnz_per_s",
        "value": value,
        "unit": "nnz/s",
        "vs_baseline": vs_baseline,
        "extra": extra,
    }))
    sys.stdout.flush()


class HardwareUnavailable(RuntimeError):
    pass


def _mixed_rel_err(a, b) -> float:
    """max |a-b| / (|b| + 1e-3*max|b|): relative where |b| is large, scaled
    absolute near zero rows (f32 cancellation makes pure relative error
    meaningless for y entries summing to ~0)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not a.size:
        return 0.0
    scale = 1e-3 * float(np.max(np.abs(b))) + 1e-30
    return float(np.max(np.abs(a - b) / (np.abs(b) + scale)))


class _Watchdog:
    """SIGALRM guard around one bench section: an in-process hang turns
    into an error record instead of an outer timeout that loses the
    output."""

    def __init__(self, name, seconds=SECTION_TIMEOUT_S):
        self.name, self.seconds = name, seconds

    def __enter__(self):
        def fire(signum, frame):
            raise HardwareUnavailable(
                f"section '{self.name}' exceeded {self.seconds}s")
        self._old = signal.signal(signal.SIGALRM, fire)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def build_matrix(n):
    """Headline: 5 dense diagonals + ~10% random singles."""
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for b in (0, 1, -1, 8, -13):
        r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
        rows.append(r)
        cols.append(r + b)
    m = n // 2
    rows.append(rng.integers(0, n, size=m))
    cols.append(rng.integers(0, n, size=m))
    return _dedup_sort(np.concatenate(rows), np.concatenate(cols), n)


def build_blocky_matrix(n):
    """Blocky: 4x2 dense blocks + horizontal runs (w=8) + singles."""
    rng = np.random.default_rng(7)
    rows, cols = [], []
    # 4x2 blocks at random aligned anchors
    nb = n // 8
    br0 = rng.integers(0, (n - 4) // 4, size=nb) * 4
    bc0 = rng.integers(0, (n - 2) // 2, size=nb) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    rows.append((br0[:, None, None] + ii[None]).ravel())
    cols.append((bc0[:, None, None] + jj[None]).ravel())
    # horizontal runs of length 8
    nh = n // 4
    hr = rng.integers(0, n, size=nh)
    hc = rng.integers(0, n - 8, size=nh)
    rows.append(np.repeat(hr, 8))
    cols.append((hc[:, None] + np.arange(8)[None]).ravel())
    # singles
    m = n // 4
    rows.append(rng.integers(0, n, size=m))
    cols.append(rng.integers(0, n, size=m))
    return _dedup_sort(np.concatenate(rows), np.concatenate(cols), n)


def build_symmetric_matrix(n):
    """Symmetric: banded diagonals (0, ±1, ±8, ±13) + mirrored singles —
    the CSX-Sym flagship configuration (ref csx_sym_spmv_tmpl.c)."""
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for b in (0, 1, 8, 13):     # lower half; mirror below
        r = np.arange(b, n, dtype=np.int64)
        rows.append(r)
        cols.append(r - b)
    m = n // 4
    sr = rng.integers(0, n, size=m)
    sc = rng.integers(0, n, size=m)
    lo, hi = np.minimum(sr, sc), np.maximum(sr, sc)
    rows.append(hi)
    cols.append(lo)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    # mirror the strict lower triangle to build the full COO
    strict = rows > cols
    rows_f = np.concatenate([rows, cols[strict]])
    cols_f = np.concatenate([cols, rows[strict]])
    rows_f, cols_f, _ = _dedup_sort(rows_f, cols_f, n)
    # VALUE symmetry: derive v from the unordered pair so v(r,c) == v(c,r)
    lo = np.minimum(rows_f, cols_f).astype(np.uint64)
    hi = np.maximum(rows_f, cols_f).astype(np.uint64)
    key = lo * np.uint64(n) + hi
    h = (key * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
    vals = (h.astype(np.float32) / np.float32(1 << 24) - 0.5) * 0.2
    return rows_f, cols_f, vals


def build_diagc_matrix(n):
    """Diag-class: PARTIAL diagonal runs, anti-diagonal runs and vertical
    runs + singles — exercises the diag/rdiag/vert kernel classes
    (ref diag_tmpl.c, rdiag_tmpl.c, vert_tmpl.c), which the other
    workloads never touch."""
    rng = np.random.default_rng(9)
    rows, cols = [], []
    j16 = np.arange(16)
    # partial diagonal segments (length 16, scattered offsets)
    nd = n // 24
    dr = rng.integers(0, n - 16, size=nd)
    dc = rng.integers(0, n - 16, size=nd)
    rows.append((dr[:, None] + j16[None]).ravel())
    cols.append((dc[:, None] + j16[None]).ravel())
    # anti-diagonal segments (length 16)
    ar = rng.integers(0, n - 16, size=nd)
    ac = rng.integers(16, n, size=nd)
    rows.append((ar[:, None] + j16[None]).ravel())
    cols.append((ac[:, None] - j16[None]).ravel())
    # vertical runs (length 8)
    j8 = np.arange(8)
    nv = n // 12
    vr = rng.integers(0, n - 8, size=nv)
    vc = rng.integers(0, n, size=nv)
    rows.append((vr[:, None] + j8[None]).ravel())
    cols.append(np.repeat(vc, 8))
    # singles
    m = n // 8
    rows.append(rng.integers(0, n, size=m))
    cols.append(rng.integers(0, n, size=m))
    return _dedup_sort(np.concatenate(rows), np.concatenate(cols), n)


def _dedup_sort(rows, cols, n):
    key = rows * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = np.random.default_rng(1).standard_normal(
        rows.size).astype(np.float32) * 0.1
    return rows, cols, vals


def _sync(arr):
    """Wait for the device and fetch one element."""
    return float(arr.ravel()[0])


def device_busy_ns(profile) -> float:
    """Device busy time of a ``jax.profiler.ProfileData`` trace: the union
    of the event intervals on the stream lines of every GPU device plane
    (overlapping kernels on two streams count once).  Raises when the
    trace holds no GPU kernel event."""
    spans = []
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                spans += [(e.start_ns, e.end_ns) for e in line.events]
    if not spans:
        raise RuntimeError("trace holds no GPU kernel event")
    busy, end = 0.0, float("-inf")
    for s0, s1 in sorted(spans):
        if s1 <= end:
            continue
        busy += s1 - max(s0, end)
        end = s1
    return busy


def _device_time_per_iter(fn, iters: int, reps: int = 3):
    """Per-iteration device busy seconds via jax.profiler (min of reps)."""
    import glob
    import tempfile

    import jax

    best = None
    for _ in range(reps):
        with tempfile.TemporaryDirectory() as td:
            with jax.profiler.trace(td):
                _sync(fn())
            files = glob.glob(td + "/**/*.xplane.pb", recursive=True)
            if not files:
                raise RuntimeError("profiler wrote no trace")
            prof = jax.profiler.ProfileData.from_file(sorted(files)[-1])
            t = device_busy_ns(prof) * 1e-9 / iters
        best = t if best is None else min(best, t)
    return best


def measure_hbm_bw():
    """Peak achievable HBM bandwidth via a chained triad (read 2, write 1)."""
    import jax
    import jax.numpy as jnp

    nbytes = 256 * 1024 * 1024
    n = nbytes // 4
    a = jnp.ones(n, dtype=jnp.float32)
    b = jnp.full(n, 2.0, dtype=jnp.float32)

    def make(k):
        @jax.jit
        def rep(a, b):
            def body(c, _):
                return c * 0.5 + 1.5 * b, ()
            c, _ = jax.lax.scan(body, a, None, length=k)
            return c
        return lambda: rep(a, b)

    fn = make(16)
    _sync(fn())
    per_iter = _device_time_per_iter(fn, 16)
    return 3 * nbytes / per_iter


def bench_workload(name, n, rows, cols, vals, save_restore=False):
    """Tune + time one matrix; returns a metrics dict."""
    import jax
    import jax.numpy as jnp

    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.ops.exec import _compiled

    nnz = rows.size
    log(f"[{name}] matrix: {n}x{n}, nnz={nnz}")
    t0 = time.perf_counter()
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    pt = time.perf_counter() - t0
    tables = mat.shards[0]
    ex = mat.executors[0]
    meta, arrays = ex.meta, ex.arrays
    restore_pt = None
    if save_restore:
        # matrix-caching story (ref CsxSaveRestore.hpp:161-369): archive
        # the tuned tables, restore, and report restore-pt — the
        # amortize-preprocessing claim, measured in the perf loop
        import tempfile
        from sparsex_jax.persist import restore_csx, save_csx
        with tempfile.TemporaryDirectory() as td:
            fn_path = os.path.join(td, "bench.spx")
            save_csx(mat, fn_path)
            t0 = time.perf_counter()
            mat2, _perm = restore_csx(fn_path)
            restore_pt = time.perf_counter() - t0
            log(f"[{name}] restore-pt={restore_pt:.2f}s (pt={pt:.2f}s)")
            del mat2
    csx_bytes = mat.csx_size()
    log(f"[{name}] pt={pt:.2f}s csx_size={csx_bytes / 1e6:.1f}MB "
        f"({csx_bytes / nnz:.2f} B/nnz; csr would be "
        f"{(8 * nnz + 4 * (n + 1)) / nnz:.2f} B/nnz in f32+i32)")
    log(f"[{name}] tables: delta_nnz={tables.delta.nnz} "
        f"runs={[(t.enc.name, t.delta, t.width, t.rows.size) for t in tables.runs]} "
        f"blocks={[(t.enc.name, t.br, t.bc, t.rows.size) for t in tables.blocks]}")
    arrays = jax.device_put(arrays)
    spmv = _compiled(meta, "float32", apply_alpha=False, apply_beta=False)
    zeros = jnp.zeros(n, dtype=jnp.float32)

    def make(k):
        @jax.jit
        def chained(arrays, x):
            def body(carry, _):
                y = spmv(arrays, carry, jnp.float32(1.0), jnp.float32(0.0),
                         zeros)
                # renormalize to keep f32 finite (data dependency between
                # iterations; costs ~12B/row extra traffic, accounted below)
                y = y * jax.lax.rsqrt(jnp.mean(y * y) + 1e-20)
                return y, ()
            y, _ = jax.lax.scan(body, x, None, length=k)
            return y
        return lambda: chained(arrays, x)

    x_np = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x = jnp.asarray(x_np)

    # --- in-run numeric cross-check vs the COO oracle (ref
    # Bench.cpp:256-263: every bench run verifies before it times) ---
    from sparsex_jax.ops.oracle import coo_spmv
    y_dev = np.asarray(spmv(arrays, x, jnp.float32(1.0), jnp.float32(0.0),
                            zeros))
    y_ref = coo_spmv(n, rows, cols, vals, x_np)
    rel = _mixed_rel_err(y_dev, y_ref)
    log(f"[{name}] oracle cross-check: max rel err {rel:.2e} "
        f"(tol {CHECK_TOL:g})")
    if not rel < CHECK_TOL:
        raise AssertionError(
            f"[{name}] SpMV result diverges from the oracle: "
            f"rel={rel:.3e} > {CHECK_TOL:g}")

    fn1 = make(LOOPS // 4)
    t0 = time.perf_counter()
    _sync(fn1())   # compile before tracing
    compile_s = time.perf_counter() - t0
    log(f"[{name}] first-call compile+run: {compile_s:.1f}s "
        f"(the reference's pt includes JIT, SparsexModule.cpp:45-50)")
    per_iter = _device_time_per_iter(fn1, LOOPS // 4)
    log(f"[{name}] timing (device trace, min of 3): "
        f"{per_iter * 1e6:.1f} us/SpMV")
    out = {
        "nnz": nnz,
        "nnz_per_s": nnz / per_iter,
        "mflops": 2 * nnz / (1e6 * per_iter),
        "us_per_spmv": per_iter * 1e6,
        "pt_s": pt,
        "compile_s": compile_s,
        "check_rel_err": rel,
        "csx_bytes": csx_bytes,
        # ideal one-pass traffic: compressed tables + x read + y write +
        # the renormalization chain (2 extra row passes)
        "ideal_bytes": csx_bytes + 4 * n * 4,
    }
    if restore_pt is not None:
        out["restore_pt_s"] = restore_pt
    return out


def bench_symmetric(name, n, rows, cols, vals):
    """Tune + time the symmetric (CSX-Sym) SpMV on full-COO input.

    Throughput counts the FULL matrix nnz (the work a symmetric SpMV
    performs), matching the reference MFLOPS accounting for symmetric
    matrices.  Returns a metrics dict like :func:`bench_workload`."""
    import jax
    import jax.numpy as jnp

    from sparsex_jax.ops.oracle import coo_spmv
    from sparsex_jax.symmetric import build_symmetric_csx

    nnz = rows.size          # full (mirrored) nonzero count
    log(f"[{name}] symmetric matrix: {n}x{n}, nnz_full={nnz}")
    t0 = time.perf_counter()
    mat = build_symmetric_csx(n, n, rows, cols, vals)
    # pt = host-side preprocessing ONLY, measured like bench_workload's
    # pt; the first matvec below is the XLA compile + device transfer,
    # reported separately (ref SparsexModule.cpp:45-50 includes its LLVM
    # JIT in pt, reported here as compile_s).
    pt = time.perf_counter() - t0
    x_np = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    x = jnp.asarray(x_np)
    t0 = time.perf_counter()
    # warmup OUTSIDE any trace: compiles + builds device caches
    y_dev = np.asarray(mat.matvec(x))
    compile_s = time.perf_counter() - t0
    csx_bytes = mat.csx_size()
    log(f"[{name}] pt={pt:.2f}s compile+transfer={compile_s:.2f}s "
        f"csx_size={csx_bytes / 1e6:.1f}MB "
        f"({csx_bytes / nnz:.2f} B/nnz vs full)")

    y_ref = coo_spmv(n, rows, cols, vals, x_np)
    rel = _mixed_rel_err(y_dev, y_ref)
    log(f"[{name}] oracle cross-check: max rel err {rel:.2e}")
    if not rel < CHECK_TOL:
        raise AssertionError(
            f"[{name}] symmetric SpMV diverges from the oracle: "
            f"rel={rel:.3e} > {CHECK_TOL:g}")

    def make(k):
        @jax.jit
        def chained(x):
            def body(carry, _):
                y = mat.matvec(carry)
                y = y * jax.lax.rsqrt(jnp.mean(y * y) + 1e-20)
                return y, ()
            y, _ = jax.lax.scan(body, x, None, length=k)
            return y
        return lambda: chained(x)

    fn1 = make(LOOPS // 4)
    _sync(fn1())
    per_iter = _device_time_per_iter(fn1, LOOPS // 4)
    log(f"[{name}] timing (device trace, min of 3): "
        f"{per_iter * 1e6:.1f} us/SpMV")
    return {
        "nnz": nnz,
        "nnz_per_s": nnz / per_iter,
        "mflops": 2 * nnz / (1e6 * per_iter),
        "us_per_spmv": per_iter * 1e6,
        "pt_s": pt,
        "compile_s": compile_s,
        "check_rel_err": rel,
        "csx_bytes": csx_bytes,
        "ideal_bytes": csx_bytes + 4 * n * 4,
    }


def bench_spmm(name, n, rows, cols, vals, k=8):
    """Time SpMM at width k on an already-built matrix (nnz*k/s)."""
    import jax
    import jax.numpy as jnp

    from sparsex_jax.csx import CsxMatrix

    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    nnz = rows.size

    def make(kk):
        @jax.jit
        def chained(X):
            def body(carry, _):
                Y = mat.matmat(carry)
                Y = Y * jax.lax.rsqrt(jnp.mean(Y * Y) + 1e-20)
                return Y, ()
            Y, _ = jax.lax.scan(body, X, None, length=kk)
            return Y
        return lambda: chained(X)

    X = jnp.asarray(np.random.default_rng(3).standard_normal((n, k)),
                    dtype=jnp.float32)
    fn = make(max(LOOPS // 16, 2))
    _sync(fn())
    per_iter = _device_time_per_iter(fn, max(LOOPS // 16, 2), reps=2)
    log(f"[{name}] SpMM k={k}: {per_iter * 1e6:.1f} us -> "
        f"{nnz * k / per_iter / 1e9:.2f} Gnnz*k/s")
    return nnz * k / per_iter


def bench_spgemm(n=1 << 13, nnz_per_row=16):
    """C = A*A on a random matrix; reports effective MFLOPS (2*flops/t).

    SpGEMM's numeric phase is host/device mixed (ops/spgemm.py); this
    keeps the north-star claim measurable (ref BASELINE north star)."""
    import time as _t

    from sparsex_jax.ops.spgemm import spgemm_coo

    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = rng.integers(0, n, rows.size)
    key = rows * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    # flops = 2 * sum over k of nnz_row(A, k) for each nonzero (i, k)
    row_nnz = np.bincount(rows, minlength=n)
    flops = 2 * int(row_nnz[cols].sum())
    t0 = _t.perf_counter()
    spgemm_coo(rows, cols, vals, rows, cols, vals, n, n, n)
    dt = _t.perf_counter() - t0
    log(f"[spgemm] {n}x{n} nnz={rows.size} -> {flops / 1e6:.1f} MFLOP "
        f"in {dt:.2f}s = {flops / dt / 1e6:.1f} MFLOPS")
    return flops / dt / 1e6


def run_benches():
    import jax

    from sparsex_jax.platform import enable_compile_cache, gpu_name_power

    log(f"compile cache: {enable_compile_cache()}")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise HardwareUnavailable(
            f"no GPU: JAX found platform {dev.platform!r}")
    card = gpu_name_power()
    log(f"device: {dev} kind={dev.device_kind} card={card}")

    from sparsex_jax.config import Config

    cfg = Config.reset()
    cfg.set("spx.jax.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")

    with _Watchdog("headline"):
        head = bench_workload("headline", N, *build_matrix(N),
                              save_restore=True)
    with _Watchdog("blocky"):
        blocky = bench_workload("blocky", N_BLOCKY,
                                *build_blocky_matrix(N_BLOCKY))
    with _Watchdog("symmetric"):
        sym = bench_symmetric("symmetric", N_SYM,
                              *build_symmetric_matrix(N_SYM))
    with _Watchdog("diagc"):
        diagc = bench_workload("diagc", N_DIAGC,
                               *build_diagc_matrix(N_DIAGC))
    with _Watchdog("spmm"):
        spmm_rate = bench_spmm("blocky", N_BLOCKY,
                               *build_blocky_matrix(N_BLOCKY), k=8)
    with _Watchdog("spgemm"):
        spgemm_mflops = bench_spgemm()

    with _Watchdog("hbm_bw"):
        bw = measure_hbm_bw()

    def sol_frac(w):
        return w["nnz_per_s"] / (w["nnz"] / (w["ideal_bytes"] / bw))

    frac = sol_frac(head)
    bfrac = sol_frac(blocky)
    sfrac = sol_frac(sym)
    dfrac = sol_frac(diagc)
    log(f"measured HBM BW (triad): {bw / 1e9:.0f} GB/s")
    log(f"headline:  {head['nnz_per_s'] / 1e9:.2f} Gnnz/s "
        f"({head['mflops']:.0f} MFLOPS) -> {100 * frac:.1f}% of HBM SoL")
    log(f"blocky:    {blocky['nnz_per_s'] / 1e9:.2f} Gnnz/s "
        f"({blocky['mflops']:.0f} MFLOPS) -> {100 * bfrac:.1f}% of its SoL")
    log(f"symmetric: {sym['nnz_per_s'] / 1e9:.2f} Gnnz/s "
        f"({sym['mflops']:.0f} MFLOPS) -> {100 * sfrac:.1f}% of its SoL")
    log(f"diagc:     {diagc['nnz_per_s'] / 1e9:.2f} Gnnz/s "
        f"({diagc['mflops']:.0f} MFLOPS) -> {100 * dfrac:.1f}% of its SoL")

    emit(head["nnz_per_s"],
         # BASELINE.md: >= 85% of HBM-only speed-of-light nnz/s
         frac / 0.85,
         {
             "headline_us_per_spmv": head["us_per_spmv"],
             "headline_pt_s": head["pt_s"],
             "headline_restore_pt_s": head.get("restore_pt_s"),
             "headline_compile_s": head.get("compile_s"),
             "headline_hbm_sol_frac": frac,
             "headline_check_rel_err": head["check_rel_err"],
             "blocky_nnz_per_s": blocky["nnz_per_s"],
             "blocky_us_per_spmv": blocky["us_per_spmv"],
             "blocky_pt_s": blocky["pt_s"],
             "blocky_hbm_sol_frac": bfrac,
             "blocky_check_rel_err": blocky["check_rel_err"],
             "symmetric_nnz_per_s": sym["nnz_per_s"],
             "symmetric_us_per_spmv": sym["us_per_spmv"],
             "symmetric_pt_s": sym["pt_s"],
             "symmetric_compile_s": sym["compile_s"],
             "symmetric_hbm_sol_frac": sfrac,
             "symmetric_check_rel_err": sym["check_rel_err"],
             "diagc_nnz_per_s": diagc["nnz_per_s"],
             "diagc_us_per_spmv": diagc["us_per_spmv"],
             "diagc_hbm_sol_frac": dfrac,
             "diagc_check_rel_err": diagc["check_rel_err"],
             "spmm_k8_nnzk_per_s": spmm_rate,
             "spgemm_mflops": spgemm_mflops,
             "hbm_bw_gbps": bw / 1e9,
             "platform": dev.platform,
             "device_kind": dev.device_kind,
             "device_count": len(jax.devices()),
             "card_name_power_limit": card,
         })


def _is_hardware_error(exc) -> bool:
    s = f"{type(exc).__name__}: {exc}"
    return any(k in s for k in ("UNAVAILABLE", "Unavailable",
                                "DEADLINE", "DeadlineExceeded",
                                "INTERNAL: Failed to connect",
                                "socket closed", "connection reset"))


def main():
    try:
        run_benches()
    except HardwareUnavailable as e:
        log(f"HARDWARE UNAVAILABLE: {e}")
        emit(0.0, 0.0, {"error": "device_unavailable",
                        "detail": str(e)[-800:]})
        sys.exit(1)
    except Exception as e:  # noqa: BLE001 - classify then re-raise
        if _is_hardware_error(e):
            log(f"HARDWARE ERROR mid-bench: {e}")
            emit(0.0, 0.0, {"error": "device_unavailable_midrun",
                            "detail": str(e)[-800:]})
            sys.exit(1)
        emit(0.0, 0.0, {"error": "bench_exception",
                        "detail": f"{type(e).__name__}: {e}"[-800:]})
        raise


if __name__ == "__main__":
    main()
