"""Relaxation smoothers over abstract operators.

The reference's solver menu (transport_tri_semi.F90:491-518): weighted
Jacobi (omega=0.8, :140), "Gauss-Seidel" (in-place element sweep) and
Richardson.  Sequential GS does not map to SIMD hardware; the data-parallel
replacements are:

- ``jacobi``: damped Jacobi, identical fixed point;
- ``colored_gs``: two-color Gauss-Seidel using the up/down orientation as
  the coloring (neighbors of an up child are down children inside a macro
  element); across macro-element boundaries the sweep is block-Jacobi
  (processor-block GS — the standard distributed-memory variant);
- ``block_jacobi``: exact per-element nloc x nloc solve (DG blocks are tiny
  and dense, so inverting them exactly is cheaper than iterating).

Each smoother takes ``apply_A: (x) -> A x`` (an affine operator is fine —
Dirichlet ghost contributions may be folded in), a right-hand side and a
preconditioner (scalar diagonal or dense blocks).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp


def chebyshev_roots(lam_max: float, degree: int,
                    lower: float = 0.1) -> list[float]:
    """Chebyshev roots of the smoothing interval [lower*lam, lam] for the
    product-form sweep x <- x + (1/r_k) M^-1 (b - A x), interleaved
    large/small so intermediate amplification stays bounded in f32.

    This is THE Chebyshev schedule of every solver in the package (serial
    and distributed smoothers both consume it) — measured
    two-grid rho ~0.36 vs ~0.67 for damped block-Jacobi at equal cost.
    """
    a_, b_ = lower * lam_max, lam_max
    ks = np.arange(1, degree + 1)
    roots = (0.5 * (b_ + a_)
             + 0.5 * (b_ - a_) * np.cos(np.pi * (2 * ks - 1) / (2 * degree)))
    order: list[float] = []
    lo, hi = 0, degree - 1
    while lo <= hi:
        order.append(float(roots[lo]))
        lo += 1
        if lo <= hi:
            order.append(float(roots[hi]))
            hi -= 1
    return order


def chebyshev(apply_A: Callable, b: jax.Array, x: jax.Array,
              solve_prec: Callable, roots: list[float],
              sweeps: int = 1) -> jax.Array:
    """Chebyshev-accelerated relaxation: for each root r_k,
    x <- x + (1/r_k) P^-1 (b - A x), with P the (block-)preconditioner
    applied by ``solve_prec``."""
    def body(x, _):
        for r in roots:
            x = x + solve_prec(b - apply_A(x)) / r
        return x, None
    x, _ = jax.lax.scan(body, x, None, length=sweeps)
    return x


def block_jacobi_inv(apply_A: Callable, b: jax.Array, x: jax.Array,
                     inv_blocks: jax.Array, omega: float = 1.0,
                     sweeps: int = 1) -> jax.Array:
    """block_jacobi with PRE-INVERTED diagonal blocks (a setup-time
    inverse instead of a linalg.solve in every sweep)."""
    def body(x, _):
        r = b - apply_A(x)
        return x + omega * jnp.einsum("...ij,...j->...i", inv_blocks, r), None
    x, _ = jax.lax.scan(body, x, None, length=sweeps)
    return x


def jacobi(apply_A: Callable, b: jax.Array, x: jax.Array, diag: jax.Array,
           omega: float = 0.8, sweeps: int = 1) -> jax.Array:
    def body(x, _):
        x = x + omega / diag * (b - apply_A(x))
        return x, None
    x, _ = jax.lax.scan(body, x, None, length=sweeps)
    return x


def richardson(apply_A: Callable, b: jax.Array, x: jax.Array,
               omega: float = 0.8, sweeps: int = 1) -> jax.Array:
    def body(x, _):
        return x + omega * (b - apply_A(x)), None
    x, _ = jax.lax.scan(body, x, None, length=sweeps)
    return x


def block_jacobi(apply_A: Callable, b: jax.Array, x: jax.Array,
                 diag_blocks: jax.Array, omega: float = 1.0,
                 sweeps: int = 1) -> jax.Array:
    """x <- x + omega * D^{-1} (b - A x) with exact dense block solves.

    diag_blocks: (..., nloc, nloc) matching x (..., nloc).
    """
    def body(x, _):
        r = b - apply_A(x)
        dx = jnp.linalg.solve(diag_blocks, r[..., None])[..., 0]
        return x + omega * dx, None
    x, _ = jax.lax.scan(body, x, None, length=sweeps)
    return x


def colored_gs(apply_A: Callable, b: jax.Array, x: jax.Array,
               diag: jax.Array, color_masks: tuple[jax.Array, ...],
               omega: float = 0.8, sweeps: int = 1) -> jax.Array:
    """Multi-color Gauss-Seidel: update one color at a time, each color seeing
    the freshly updated values of previously swept colors.

    color_masks: boolean masks (broadcastable to x) partitioning the rows.
    """
    def body(x, _):
        for mask in color_masks:
            x = jnp.where(mask, x + omega / diag * (b - apply_A(x)), x)
        return x, None
    x, _ = jax.lax.scan(body, x, None, length=sweeps)
    return x
