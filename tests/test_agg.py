"""Aggregation hierarchy units: the block row-operator, the scaled bottom
inverse, and hierarchy contraction."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from p_a_multigrids_tpu.config import SemiConfig
from p_a_multigrids_tpu.mesh import splitting, structured, topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.ops import agg as magg


def _random_rows(n_out, n_src, D, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_src, size=(n_out, D))
    vals = rng.normal(size=(n_out, D, 3, 3))
    return cols, vals


@pytest.mark.parametrize("shape", [(96, 96), (48, 96), (96, 48)])
def test_rowop_matches_definition(shape):
    """The padded block-row operator (level operators AND rectangular
    transfers) in the transposed contract (3, S) -> (3, N) == its
    definition y[n] = sum_d vals[n, d] @ x[cols[n, d]]."""
    n_out, n_src = shape
    cols, vals = _random_rows(n_out, n_src, D=5)
    x = np.random.default_rng(1).normal(size=(n_src, 3))
    want = np.zeros((n_out, 3))
    for n in range(n_out):
        for d in range(cols.shape[1]):
            want[n] += vals[n, d] @ x[cols[n, d]]
    got = magg._rowop_t(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.asarray(x.T))
    np.testing.assert_allclose(np.asarray(got).T, want, rtol=1e-12,
                               atol=1e-12)


def test_hierarchy_correct_contracts():
    """One SA correction must reduce the residual of a smooth error."""
    mesh = topology.rcm_reorder(structured.tri_mesh(8, 8, 0.125, 0.125))
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=1e8, dtype="float64")
    s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    coords = splitting.child_coords(mesh.X, 2)
    h = magg.build_hierarchy(s._stencil[0]._data, coords,
                             max_dense_dof=1024, dtype=np.float64,
                             strength=0.4, always=True)
    assert h.levels and h.coarse_inv is not None
    U, C = mesh.num_elements, 16
    rng = np.random.default_rng(3)
    x_true = jnp.asarray(rng.normal(size=(3, C, U)))
    b = s._stencil[0].apply(x_true, False)
    x = jnp.zeros_like(x_true)
    op = s._stencil[0]

    def resid(x):
        return float(jnp.abs(b - op.apply(x, False)).max())

    r0 = resid(x)
    for _ in range(4):
        x = op.smooth_jacobi(x, b, 0.6, 2, False)
        r_t = b - op.apply(x, False)
        e = magg.correct(h, jnp.transpose(r_t, (2, 1, 0)).reshape(U * C, 3))
        x = x + jnp.transpose(e.reshape(U, C, 3), (2, 1, 0))
        x = op.smooth_jacobi(x, b, 0.6, 2, False)
    assert resid(x) < 1e-2 * r0


def test_scaled_bottom_inverse_accurate():
    """The Jacobi-scaled dense bottom inverse solves its own system to
    near machine precision even for badly scaled matrices."""
    rng = np.random.default_rng(4)
    n = 60
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    scales = 10.0 ** rng.uniform(-4, 4, n)
    A_np = (Q @ np.diag(rng.uniform(1, 5, n)) @ Q.T) * np.outer(scales,
                                                                scales)
    from scipy import sparse
    A = sparse.csr_matrix(A_np)
    s_vec = 1.0 / np.sqrt(np.abs(A.diagonal()))
    As = (A.toarray() * s_vec[None, :]) * s_vec[:, None]
    inv = np.linalg.inv(As)
    r = rng.normal(size=n)
    e = s_vec * (inv @ (s_vec * r))
    assert np.linalg.norm(A_np @ e - r) < 1e-8 * np.linalg.norm(r)


def test_factored_fine_transfers_match_stored():
    """The factored transfer path (P_tent + one stencil apply per side,
    models/semi._agg_correct_t) == the stored smoothed-transfer tables:
    P = (I - w D^-1 A) P_tent exactly, so both must agree to roundoff."""
    import jax.numpy as jnp
    mesh = topology.rcm_reorder(structured.tri_mesh(8, 8, 0.125, 0.125))
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=1e8, dtype="float64",
                     amg=True, agg_strength=0.4)
    s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    h = s._agg
    assert h is not None and h.fine is not None
    U, C = mesh.num_elements, 16
    rng = np.random.default_rng(7)
    r_t = jnp.asarray(rng.normal(size=(3, C, U)))
    x0 = jnp.zeros_like(r_t)
    # factored path (the default for symmetric physics)
    e_fact = np.asarray(s._agg_correct_t(0, x0, r_t))
    # stored path: force it by hiding the factored tables
    fine, h.fine = h.fine, None
    try:
        e_stored = np.asarray(s._agg_correct_t(0, x0, r_t))
    finally:
        h.fine = fine
    np.testing.assert_allclose(e_fact, e_stored, rtol=1e-9, atol=1e-10)
