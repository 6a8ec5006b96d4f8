"""Iterative solvers built on the CSX SpMV kernels.

The reference ships SpMV as the terminal kernel plus the vector algebra
needed to write solvers on top (``spx_vec_*``); the BASELINE configs call
for a CG loop on symmetric CSX.  ``cg`` works with any of the library's
executors (CsxMatrix, SymCsxMatrix, ShardedCsx) — the loop is a
``lax.while_loop`` so the whole solve stays on device inside one jit.
"""

from __future__ import annotations

from typing import Callable, Tuple


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
       maxiter: int = 1000) -> Tuple:
    """Conjugate gradients: solve A x = b for s.p.d. A.

    ``matvec(x) -> A @ x``.  Returns (x, iterations, final residual norm).
    """
    import jax
    import jax.numpy as jnp

    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - matvec(x)
    p = r
    rs = jnp.vdot(r, r)
    tol2 = jnp.asarray(tol, dtype=b.dtype) ** 2 * jnp.vdot(b, b)

    def cond(state):
        _x, _r, _p, rs_, it = state
        return (rs_ > tol2) & (it < maxiter)

    def body(state):
        x, r, p, rs_, it = state
        ap = matvec(p)
        alpha = rs_ / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs_) * p
        return (x, r, p, rs_new, it + 1)

    x, r, p, rs, it = jax.lax.while_loop(cond, body, (x, r, p, rs, 0))
    return x, it, jnp.sqrt(rs)


def block_cg(matmat: Callable, B, X0=None, *, tol: float = 1e-8,
             maxiter: int = 1000) -> Tuple:
    """Block conjugate gradients: solve A X = B for s.p.d. A, B (n, k).

    Each right-hand side runs its own CG recurrence, but every iteration
    issues ONE SpMM (``matmat(P) -> A @ P``) — the k axis amortizes the
    sparse index loads over k values.  The
    loop is a ``lax.while_loop``; columns that have converged keep
    iterating with alpha = 0 (numerically inert) until all are done.
    Returns (X, iterations, per-column residual norms).
    """
    import jax
    import jax.numpy as jnp

    B = jnp.asarray(B)
    X = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0)
    R = B - matmat(X)
    P = R
    rs = jnp.sum(R * R, axis=0)                      # (k,)
    tol2 = jnp.asarray(tol, dtype=B.dtype) ** 2 * jnp.sum(B * B, axis=0)

    def cond(state):
        _X, _R, _P, rs_, it = state
        return jnp.any(rs_ > tol2) & (it < maxiter)

    def body(state):
        X, R, P, rs_, it = state
        AP = matmat(P)
        live = rs_ > tol2
        denom = jnp.sum(P * AP, axis=0)
        alpha = jnp.where(live, rs_ / jnp.where(denom == 0, 1, denom), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        rs_new = jnp.sum(R * R, axis=0)
        beta = jnp.where(live, rs_new / jnp.where(rs_ == 0, 1, rs_), 0.0)
        P = R + beta[None, :] * P
        return (X, R, P, rs_new, it + 1)

    X, R, P, rs, it = jax.lax.while_loop(cond, body, (X, R, P, rs, 0))
    return X, it, jnp.sqrt(rs)
