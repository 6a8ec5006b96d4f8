#!/usr/bin/env python
"""Weak-scaling harness: nnz grows with the device count.

BASELINE.md target: >= 80% weak-scaling efficiency at 2+ devices.  With
``--cpu`` the harness runs the full sharded program on an N-device
*virtual CPU mesh* to validate the machinery (shardings, halo ring,
reduce-scatter); on real GPUs the same flags measure true efficiency:

    python tools/weak_scaling.py --devices 1 2 4 --mode halo
    python tools/weak_scaling.py --devices 4 --mesh 2x2   # (host, dev)

Efficiency = t(1 device, base problem) / t(N devices, N x base problem).
CPU-mesh numbers are NOT device performance: on a single-core host the
virtual devices serialize, so efficiency reads ~1/N there by construction.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build(n, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b in (0, 1, -1, 8):
        r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
        rows.append(r)
        cols.append(r + b)
    rows.append(rng.integers(0, n, n // 2))
    cols.append(rng.integers(0, n, n // 2))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = (rng.standard_normal(rows.size) * 0.1).astype(np.float32)
    return rows, cols, vals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--base-n", type=int, default=1 << 15,
                    help="rows per device (weak scaling)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "replicated", "halo"])
    ap.add_argument("--mesh", default="",
                    help="HxD for a 2-D (host, dev) mesh, e.g. 2x2")
    ap.add_argument("--loops", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", default=None,
                    help="force the virtual CPU mesh (default when fewer "
                         "real devices than requested)")
    ap.add_argument("--json", default="",
                    help="write structured results to this path")
    args = ap.parse_args()

    # The platform must be decided BEFORE the first backend-initializing
    # call (jax.devices()): on jax 0.9 a later jax.config.update is a
    # silent no-op, so probing real devices first would lock us out of the
    # virtual CPU mesh.
    from sparsex_jax.platform import (enable_compile_cache, force_cpu,
                                      honor_jax_platforms_env)
    want = max(args.devices)
    if args.cpu or os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        force_cpu(min_devices=want)
    else:
        honor_jax_platforms_env()
    enable_compile_cache()
    import jax
    if len(jax.devices()) < want:
        print(f"ERROR: {len(jax.devices())} device(s) available but "
              f"--devices requests {want}; re-run with --cpu (and "
              f"XLA_FLAGS=--xla_force_host_platform_device_count={want} "
              "if a CPU backend already initialized) for the virtual mesh",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sparsex_jax.config import Config
    from sparsex_jax.csx import CsxMatrix
    from sparsex_jax.parallel.shard import ShardedCsx

    results = []
    for nd in args.devices:
        cfg = Config.reset()
        cfg.set("spx.jax.value_dtype", "float32")
        cfg.set("spx.preproc.xform", "all")
        cfg.set("spx.rt.nr_threads", str(nd))
        cfg.set("spx.jax.x_mode", args.mode)
        n = args.base_n * nd
        rows, cols, vals = build(n)
        mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
        devs = jax.devices()[:nd]
        if args.mesh and nd == int(args.mesh.split("x")[0]) * int(
                args.mesh.split("x")[1]):
            d, i = (int(v) for v in args.mesh.split("x"))
            mesh = Mesh(np.array(devs).reshape(d, i), ("host", "dev"))
            sh = ShardedCsx(mat, mesh=mesh, axis=("host", "dev"))
        else:
            mesh = Mesh(np.array(devs), ("shards",))
            sh = ShardedCsx(mat, mesh=mesh)
        x_np = np.random.default_rng(1).standard_normal(n).astype(
            np.float32)
        x = jnp.asarray(x_np)

        # correctness at every N vs the COO oracle (f32 sum-order tol)
        from sparsex_jax.ops.oracle import coo_spmv
        y = np.asarray(sh.matvec(x), dtype=np.float64)
        y_ref = coo_spmv(n, rows, cols, vals, x_np)
        scale = 1e-3 * float(np.max(np.abs(y_ref))) + 1e-30
        rel = float(np.max(np.abs(y - y_ref) / (np.abs(y_ref) + scale)))
        if not rel < 2e-4:
            print(f"ERROR: devices={nd} rel err {rel:.3e}",
                  file=sys.stderr)
            return 1

        @jax.jit
        def chained(arrays, x, k=args.loops):
            def body(c, _):
                y = sh._fn(arrays, c, jnp.float32(1.0), jnp.float32(0.0),
                           c * 0)
                return y * jax.lax.rsqrt(jnp.mean(y * y) + 1e-20), ()
            c, _ = jax.lax.scan(body, x, None, length=k)
            return c

        float(np.asarray(chained(sh.arrays, x))[0])  # compile+run
        t0 = time.perf_counter()
        float(np.asarray(chained(sh.arrays, x))[0])
        dt = (time.perf_counter() - t0) / args.loops
        results.append((nd, mat.nnz, dt, sh.x_mode, rel))
        print(f"devices={nd:2d} nnz={mat.nnz:>9d} x_mode={sh.x_mode:10s} "
              f"{dt * 1e6:9.1f} us/SpMV rel={rel:.1e}")

    t1 = results[0][2]
    for nd, nnz, dt, mode, _rel in results[1:]:
        eff = t1 / dt
        print(f"weak-scaling efficiency @ {nd} devices: {100 * eff:.0f}%")

    if args.json:
        import jax as _jax
        plat = _jax.devices()[0].platform
        out = {
            "platform": plat,
            "note": ("virtual CPU mesh: validates sharded build/run/"
                     "numerics; efficiency is NOT device performance "
                     "(single-core host serializes the devices)"
                     if plat == "cpu" else "real devices"),
            "mode": args.mode,
            "base_n": args.base_n,
            "points": [
                {"devices": nd, "nnz": int(nnz), "us_per_spmv": dt * 1e6,
                 "x_mode": mode, "rel_err": rel,
                 "efficiency_vs_1dev": results[0][2] / dt}
                for nd, nnz, dt, mode, rel in results
            ],
        }
        with open(args.json, "w") as fp:
            json.dump(out, fp, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    sys.exit(main())
