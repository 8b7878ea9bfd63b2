"""Dense and banded solver kit (jittable).

Counterpart of the reference's LinearSolvers.F90 (not compiled into its
binary, but part of the documented solver inventory: solver_gauss :40,
solver_Thomas :387, solver_BlockThomas :352, fact_PLU/solver_PLU :502,482)
and of matrices.F90's FINDInv Gauss-Jordan inverse (:1618-1716).

Small dense solves go through jnp.linalg (LAPACK-grade, batched);
the tridiagonal and block-tridiagonal solvers are sequential recurrences
expressed with lax.scan so they jit into single fused loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _gj_eliminate(M: jax.Array, n: int) -> jax.Array:
    """Gauss-Jordan elimination with partial pivoting on an augmented
    (n, n + k) matrix — one fori_loop step per pivot column.

    This is the real elimination loop of the reference's FINDInv
    (matrices.F90:1618-1716, incl. its row-swap pivoting :1636-1656) and
    of solver_GaussP (LinearSolvers.F90:132), written as compiler-friendly
    whole-row rank-1 updates instead of scalar inner loops.
    """
    rows = jnp.arange(n)

    def col(k, M):
        # partial pivot: strongest |M[i, k]| among rows i >= k
        cand = jnp.where(rows >= k, jnp.abs(M[:, k]), -jnp.inf)
        p = jnp.argmax(cand)
        # swap rows k <-> p (gather by a permuted row index)
        perm = rows.at[k].set(p).at[p].set(k)
        M = M[perm]
        pivot_row = M[k] / M[k, k]
        # eliminate column k from every other row, set row k normalized
        M = M - jnp.where(rows[:, None] == k, 0.0,
                          M[:, k][:, None] * pivot_row[None, :])
        return M.at[k].set(pivot_row)

    return jax.lax.fori_loop(0, n, col, M)


def gauss_solve(A: jax.Array, b: jax.Array) -> jax.Array:
    """Dense solve by Gauss-Jordan with partial pivoting (solver_gauss /
    solver_GaussP, LinearSolvers.F90:40,132).

    A (..., n, n); b (..., n) or (..., n, k); leading batch dims vmap
    over the elimination loop.
    """
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    b2 = b[..., None] if vec else b

    def single(Ai, bi):
        M = _gj_eliminate(
            jnp.concatenate([Ai, bi.astype(Ai.dtype)], axis=1), n)
        return M[:, n:]

    if A.ndim == 2:
        x = single(A, b2)
    else:
        k = b2.shape[-1]
        flat = jax.vmap(single)(A.reshape(-1, n, n), b2.reshape(-1, n, k))
        x = flat.reshape(b2.shape)
    return x[..., 0] if vec else x


def invert(A: jax.Array) -> jax.Array:
    """Dense inverse by Gauss-Jordan (replaces FINDInv,
    matrices.F90:1618); leading batch dimensions vmap over the loop."""
    n = A.shape[-1]

    def single(Ai):
        M = jnp.concatenate([Ai, jnp.eye(n, dtype=Ai.dtype)], axis=1)
        return _gj_eliminate(M, n)[:, n:]

    if A.ndim == 2:
        return single(A)
    flat = A.reshape((-1, n, n))
    return jax.vmap(single)(flat).reshape(A.shape)


def lu_factor(A: jax.Array):
    """PLU factorization with partial pivoting (fact_PLU,
    LinearSolvers.F90:502) as a fori_loop of whole-column updates.

    Returns (LU, piv): LU packs unit-lower L below the diagonal and U on/
    above it; piv[k] is the row swapped into position k at step k.
    """
    n = A.shape[-1]
    rows = jnp.arange(n)

    def step(k, state):
        M, piv = state
        cand = jnp.where(rows >= k, jnp.abs(M[:, k]), -jnp.inf)
        p = jnp.argmax(cand)
        perm = rows.at[k].set(p).at[p].set(k)
        M = M[perm]
        piv = piv.at[k].set(p)
        below = rows > k
        l = jnp.where(below, M[:, k] / M[k, k], 0.0)
        # rank-1 update of the TRAILING submatrix only — columns < k hold
        # already-stored L factors and must not be touched
        upd = below[:, None] & (rows[None, :] > k)
        M = M - jnp.where(upd, l[:, None] * M[k][None, :], 0.0)
        M = M.at[:, k].set(jnp.where(below, l, M[:, k]))
        return M, piv

    M, piv = jax.lax.fori_loop(0, n, step,
                               (A, jnp.zeros((n,), rows.dtype)))
    return M, piv


def lu_solve(factors, b: jax.Array) -> jax.Array:
    """Forward/backward substitution against lu_factor's packed output
    (solver_PLU + Forward/Backward, LinearSolvers.F90:482,559,582)."""
    M, piv = factors
    n = M.shape[-1]
    rows = jnp.arange(n)

    def apply_piv(k, x):
        p = piv[k]
        xk, xp = x[k], x[p]
        return x.at[k].set(xp).at[p].set(xk)

    y = jax.lax.fori_loop(0, n, apply_piv, b.astype(M.dtype))

    def fwd(i, y):
        Lrow = jnp.where(rows < i, M[i], 0.0)
        return y.at[i].set(y[i] - Lrow @ y)

    y = jax.lax.fori_loop(0, n, fwd, y)

    def bwd(j, y):
        i = n - 1 - j
        Urow = jnp.where(rows > i, M[i], 0.0)
        return y.at[i].set((y[i] - Urow @ y) / M[i, i])

    return jax.lax.fori_loop(0, n, bwd, y)


def thomas(lower: jax.Array, diag: jax.Array, upper: jax.Array,
           rhs: jax.Array) -> jax.Array:
    """Tridiagonal solve via the Thomas algorithm (solver_Thomas :387).

    Args:
      lower: (n,) sub-diagonal (lower[0] unused)
      diag:  (n,) main diagonal
      upper: (n,) super-diagonal (upper[-1] unused)
      rhs:   (n,) or (n, k)
    """
    n = diag.shape[0]
    rhs2 = rhs if rhs.ndim > 1 else rhs[:, None]

    def fwd(carry, x):
        cp_prev, dp_prev = carry
        a, b, c, d = x
        denom = b - a * cp_prev
        cp = c / denom
        dp = (d - a * dp_prev) / denom
        return (cp, dp), (cp, dp)

    xs = (lower, diag, upper, rhs2)
    init = (jnp.zeros((), diag.dtype), jnp.zeros((rhs2.shape[1],),
                                                 rhs2.dtype))
    _, (cps, dps) = jax.lax.scan(fwd, init, xs)

    def bwd(x_next, x):
        cp, dp = x
        xcur = dp - cp * x_next
        return xcur, xcur

    _, sol = jax.lax.scan(bwd, jnp.zeros((rhs2.shape[1],), rhs2.dtype),
                          (cps, dps), reverse=True)
    return sol if rhs.ndim > 1 else sol[:, 0]


def block_thomas(lower: jax.Array, diag: jax.Array, upper: jax.Array,
                 rhs: jax.Array) -> jax.Array:
    """Block-tridiagonal solve (solver_BlockThomas :352).

    Args:
      lower/diag/upper: (n, b, b) block bands (lower[0], upper[-1] unused)
      rhs: (n, b)
    """
    def fwd(carry, x):
        Cp_prev, Dp_prev = carry
        A, B, C, D = x
        denom = B - A @ Cp_prev
        Cp = jnp.linalg.solve(denom, C)
        Dp = jnp.linalg.solve(denom, D - A @ Dp_prev)
        return (Cp, Dp), (Cp, Dp)

    b = diag.shape[-1]
    init = (jnp.zeros((b, b), diag.dtype), jnp.zeros((b,), rhs.dtype))
    _, (Cps, Dps) = jax.lax.scan(fwd, init, (lower, diag, upper, rhs))

    def bwd(x_next, x):
        Cp, Dp = x
        xcur = Dp - Cp @ x_next
        return xcur, xcur

    _, sol = jax.lax.scan(bwd, jnp.zeros((b,), rhs.dtype), (Cps, Dps),
                          reverse=True)
    return sol
