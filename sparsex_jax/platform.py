"""Backend and compile-cache helpers for entry points (tools, bench, smoke).

Tests and tools pin the backend from ``JAX_PLATFORMS`` with
``jax.config.update`` issued after ``import jax`` but **before the first
backend-initializing call** (on jax 0.9 the update is a silent no-op once a
backend exists).  Every tool calls :func:`honor_jax_platforms_env` first
thing so that ``JAX_PLATFORMS=cpu python tools/...`` behaves as documented
— mirroring how the reference test driver must run identically everywhere
(ref ``test/scripts/test-sparsex.sh.in:40-56``).  Importing the library
sets neither a backend nor a cache.
"""

from __future__ import annotations

import os

# the checkout root: the directory that holds the package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def honor_jax_platforms_env() -> None:
    """Apply ``JAX_PLATFORMS`` via jax.config before backend init."""
    plat = os.environ.get("JAX_PLATFORMS", "").strip()
    if plat:
        import jax
        jax.config.update("jax_platforms", plat)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads that directory
    itself and no other is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, so a later run of the same
    checkout finds what an earlier one compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    import jax
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_power() -> list:
    """One ``"name, power limit"`` line per card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them;
    empty when nvidia-smi is absent or fails."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    if r.returncode != 0:
        return []
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def force_cpu(min_devices: int = 0) -> None:
    """Switch to the host CPU backend (virtual multi-device mesh).

    Must run before any backend-initializing jax call.  ``min_devices``
    additionally requests a virtual device count via XLA_FLAGS when the
    flag is absent (effective only if no CPU backend exists yet).
    """
    if min_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{min_devices}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


_ALLOCATOR_TUNED = False


def tune_host_allocator() -> bool:
    """Raise glibc's mmap/trim thresholds so large preprocessing temporaries
    are recycled from the heap instead of mmap'd and munmap'd per array.

    On this class of VM (firecracker, demand paging) the first touch of a
    fresh mmap costs far more than the copy itself: repeat ``mat_tune``
    calls measured 4.8 s wall vs 0.9 s with recycled buffers.  The
    reference tunes its allocator too (NUMA-aware pools,
    ``src/internals/numa_util.c``); the equivalent concern here is
    host-allocator behavior, since device placement is XLA's.

    Returns True when mallopt was applied.  Idempotent; no-op on
    non-glibc platforms.
    """
    global _ALLOCATOR_TUNED
    if _ALLOCATOR_TUNED:
        return True
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        ok = libc.mallopt(M_MMAP_THRESHOLD, 32 * 1024 * 1024)
        ok &= libc.mallopt(M_TRIM_THRESHOLD, 512 * 1024 * 1024)
        _ALLOCATOR_TUNED = bool(ok)
    except Exception:
        return False
    return _ALLOCATOR_TUNED
