"""Fixed-degree block-sparse matrices (ELL layout) for DG operators.

The reference stores its operators in a hand-rolled CSR with *preallocated
fixed sparsity* — a diagonal nloc x nloc block per element plus at most one
block per face (`make_sparse_matrix*` /root/reference/matrices.F90:333-1411,
fill via `add_to_CSR[_flux]` :1412-1451 which scans a <=9-entry window and
silently drops out-of-pattern entries).  The equivalent here is an
ELL/BSR layout with a static degree K = 1 + nface: every block row holds
exactly K column blocks (self first, then faces, padded with zero blocks
pointing at the row itself).  Fixed degree means SpMV is a dense gather +
batched small matmul — fully regular, no atomics — and the "scatter" of
assembly becomes pure array construction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class BSR(NamedTuple):
    """Block row e couples to block columns cols[e, :] with blocks vals."""
    cols: jax.Array   # (E, K) int32 — padded entries point at row e
    vals: jax.Array   # (E, K, b, b)

    @property
    def num_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def block_size(self) -> int:
        return self.vals.shape[-1]

    def spmv(self, x: jax.Array) -> jax.Array:
        """y = A @ x with x (E, b) -> (E, b)."""
        xg = x[self.cols]                              # (E, K, b)
        return jnp.einsum("ekij,ekj->ei", self.vals, xg)

    def diag_blocks(self) -> jax.Array:
        """(E, b, b) diagonal blocks (stored in slot 0 by convention)."""
        return self.vals[:, 0]

    def diagonal(self) -> jax.Array:
        """(E, b) scalar diagonal."""
        d = self.diag_blocks()
        return jnp.diagonal(d, axis1=-2, axis2=-1)

    def to_dense(self) -> jax.Array:
        E, K = self.cols.shape
        b = self.block_size
        dense = jnp.zeros((E, b, E, b), self.vals.dtype)
        rows = jnp.arange(E)[:, None].repeat(K, 1)     # (E, K)
        # advanced indices (rows, cols) broadcast to (E, K); the sliced block
        # axes trail, giving (E, K, b, b) — exactly vals' shape.
        dense = dense.at[rows, :, self.cols, :].add(self.vals)
        return dense.reshape(E * b, E * b)


def build(diag: jax.Array, face_blocks: jax.Array,
          neigh: np.ndarray | jax.Array) -> BSR:
    """Assemble from a diagonal block and per-face neighbor blocks.

    Args:
      diag:        (E, b, b)
      face_blocks: (E, nface, b, b) — coupling to the neighbor across each
                   face; rows with no neighbor must carry zero blocks.
      neigh:       (E, nface) int, -1 for boundary faces.
    """
    E, nface = neigh.shape
    neigh = jnp.asarray(neigh)
    self_col = jnp.arange(E, dtype=neigh.dtype)[:, None]
    cols = jnp.concatenate(
        [self_col, jnp.where(neigh < 0, self_col, neigh)], axis=1)
    mask = jnp.concatenate(
        [jnp.ones((E, 1), bool), neigh >= 0], axis=1)
    vals = jnp.concatenate([diag[:, None], face_blocks], axis=1)
    vals = jnp.where(mask[:, :, None, None], vals, 0.0)
    return BSR(cols=cols.astype(jnp.int32), vals=vals)


def to_dense_numpy(A: BSR) -> np.ndarray:
    """Dense (E*b, E*b) matrix for verification / direct solves."""
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    E, K = cols.shape
    b = vals.shape[-1]
    dense = np.zeros((E, b, E, b), vals.dtype)
    for e in range(E):
        for k in range(K):
            dense[e, :, cols[e, k], :] += vals[e, k]
    return dense.reshape(E * b, E * b)
