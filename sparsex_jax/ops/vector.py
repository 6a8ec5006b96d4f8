"""Vector algebra (BLAS-1 parity API).

Parity with the reference vector layer (``include/sparsex/internals/Vector.hpp:
38-81``, ``src/internals/Vector.cpp``; public surface ``spx_vec_*`` in
``src/api/matvec.c:763-1001``): create (std / from user buffer / random),
set/get entry, scale, scale-add, add, sub, multiply (dot), reorder /
inverse-reorder by a permutation, compare at 1e-6 relative tolerance, print.

On the device these are jnp one-liners fused by XLA; the module keeps a thin
functional namespace so the public API surface matches the reference 1:1.
Functions accept and return either numpy or jax arrays (``xp`` dispatch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sparsex_jax.errors import ErrorCode, seterror

COMPARE_TOLERANCE = 1e-6  # ref src/internals/Vector.cpp:51-56


def _xp(*arrays):
    """Pick the array namespace: jnp if any input is a jax array."""
    for a in arrays:
        if type(a).__module__.startswith(("jax", "jaxlib")):
            import jax.numpy as jnp
            return jnp
    return np


def create(size: int, dtype=np.float64):
    """spx_vec_create: a zero vector of the given size."""
    return np.zeros(size, dtype=dtype)


def create_from_buff(buff, copy: bool = False):
    """spx_vec_create_from_buff: wrap (SPX_VEC_AS_IS) or copy (SPX_VEC_TUNE).

    The reference's TUNE mode re-places the buffer NUMA-interleaved; the
    device analogue is copying into a device-shardable array, done at dispatch time
    by the executor — here TUNE simply takes ownership of a copy.
    """
    buff = np.asarray(buff)
    return buff.copy() if copy else buff


def create_random(size: int, low: float = 0.0, high: float = 1.0,
                  dtype=np.float64, seed: Optional[int] = None):
    """spx_vec_create_random: uniform in [low, high)."""
    rng = np.random.default_rng(seed)
    return (low + (high - low) * rng.random(size)).astype(dtype)

def init(v, val):
    """spx_vec_init: fill with a scalar."""
    xp = _xp(v)
    return xp.full_like(v, val)


def init_part(v, val, start: int, end: int):
    """spx_vec_init_part: fill [start, end)."""
    out = np.array(v, copy=True)
    out[start:end] = val
    return out


def set_entry(v, idx: int, val) -> None:
    """spx_vec_set_entry (1-based in the reference C API; 0-based here)."""
    if idx < 0 or idx >= len(v):
        seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, "vector index out of bounds")
    v[idx] = val


def scale(v, s):
    """spx_vec_scale: s * v."""
    return _xp(v).asarray(v) * s


def scale_add(v1, v2, s):
    """spx_vec_scale_add: v1 + s * v2."""
    return _xp(v1, v2).asarray(v1) + s * _xp(v1, v2).asarray(v2)


def scale_add_part(v1, v2, s, start: int, end: int):
    """spx_vec_scale_add_part: v1[start:end] += s*v2[start:end]."""
    out = np.array(v1, copy=True)
    out[start:end] = out[start:end] + s * np.asarray(v2)[start:end]
    return out


def add(v1, v2):
    """spx_vec_add."""
    return _xp(v1, v2).asarray(v1) + _xp(v1, v2).asarray(v2)


def add_part(v1, v2, start: int, end: int):
    """spx_vec_add_part (ref ``src/api/matvec.c:903``): out = v1 with
    [start, end) replaced by v1+v2 over that range."""
    out = np.array(v1, copy=True)
    out[start:end] = out[start:end] + np.asarray(v2)[start:end]
    return out


def sub(v1, v2):
    """spx_vec_sub."""
    return _xp(v1, v2).asarray(v1) - _xp(v1, v2).asarray(v2)


def sub_part(v1, v2, start: int, end: int):
    """spx_vec_sub_part (ref ``src/api/matvec.c:914``)."""
    out = np.array(v1, copy=True)
    out[start:end] = out[start:end] - np.asarray(v2)[start:end]
    return out


def mul(v1, v2):
    """spx_vec_mul: dot product."""
    xp = _xp(v1, v2)
    return xp.dot(xp.asarray(v1), xp.asarray(v2))


def mul_part(v1, v2, start: int, end: int):
    """spx_vec_mul_part (ref ``src/api/matvec.c:926``): partial dot."""
    a = np.asarray(v1)[start:end]
    b = np.asarray(v2)[start:end]
    return float(np.dot(a, b))


def copy(v):
    """spx_vec_copy (ref ``src/api/matvec.c:983``)."""
    return np.array(v, copy=True)


def init_rand_range(v, low: float, high: float,
                    seed: Optional[int] = None):
    """spx_vec_init_rand_range (ref ``src/api/matvec.c:849``): fill v
    in-place with uniform values in [low, high)."""
    v = np.asarray(v)
    rng = np.random.default_rng(seed)
    v[:] = (low + (high - low) * rng.random(v.size)).astype(v.dtype)
    return v


def create_interleaved(size: int, partition=None, dtype=np.float64):
    """Partition-aware creation (ref ``VecCreateInterleaved``
    ``Vector.hpp:41`` / ``spx_vec_create`` with a partition handle,
    ``matvec.c:763-837``).  The NUMA-interleaved placement maps to a
    row-sharded device array when a mesh is active; on the host side the
    partition only documents intent, so this returns a zero vector plus
    the partition for callers that shard it (``parallel/shard.py``)."""
    v = np.zeros(size, dtype=dtype)
    if partition is not None:
        try:
            import jax
            from jax.sharding import (Mesh, NamedSharding,
                                      PartitionSpec as P)
            devs = jax.devices()
            nparts = len(getattr(partition, "row_start", [])) or 1
            if len(devs) >= nparts > 1 and size % nparts == 0:
                mesh = Mesh(np.array(devs[:nparts]), ("rows",))
                return jax.device_put(v, NamedSharding(mesh, P("rows")))
        except Exception:
            pass
    return v


def reorder(v, perm):
    """spx_vec_reorder: out[perm[i]] = v[i]."""
    xp = _xp(v)
    out = xp.zeros_like(xp.asarray(v))
    if xp is np:
        out[np.asarray(perm)] = v
        return out
    return out.at[xp.asarray(perm)].set(xp.asarray(v))


def inv_reorder(v, perm):
    """spx_vec_inv_reorder: out[i] = v[perm[i]]."""
    xp = _xp(v)
    return xp.asarray(v)[xp.asarray(perm)]


def compare(v1, v2, tol: float = COMPARE_TOLERANCE) -> bool:
    """spx_vec_compare: relative comparison at 1e-6."""
    a = np.asarray(v1, dtype=np.float64)
    b = np.asarray(v2, dtype=np.float64)
    if a.shape != b.shape:
        return False
    denom = np.maximum(np.abs(b), 1e-30)
    return bool(np.all(np.abs(a - b) / denom <= tol))


def print_vec(v) -> str:
    """spx_vec_print."""
    s = " ".join(f"{float(x):.6g}" for x in np.asarray(v))
    print(s)
    return s


def init_from_map(buffers, val, idx_map) -> None:
    """spx internal ``VecInitFromMap`` parity (ref ``src/internals/
    CsxSpmv.cpp:66-85``): set only the cross-shard slots listed in the
    reduction map.  ``idx_map`` is a sequence of (buffer_index, element)
    pairs.  The sharded executor replaces this whole mechanism with a ``psum``
    over the mesh (``parallel/shard.py``); this shim exists for API parity
    and host-side testing.
    """
    for b, i in idx_map:
        buffers[b][i] = val


def add_from_map(dst, buffers, idx_map):
    """spx internal ``VecAddFromMap`` parity: accumulate the cross-shard
    slots of every partial buffer into ``dst`` (the reference's symmetric
    reduction; on the mesh this is ``lax.psum``)."""
    out = np.array(dst, copy=True)
    for b, i in idx_map:
        out[i] += buffers[b][i]
    return out
