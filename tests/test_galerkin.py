"""Galerkin R.A.P coarse operator (ops/galerkin.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from p_a_multigrids_tpu.config import Physics, SemiConfig
from p_a_multigrids_tpu.mesh import topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.ops import galerkin, stencil as mstencil

def _datas(mesh, phys, n_split=2, levels=2):
    cfg = SemiConfig(n_split=n_split, multi_levels=levels, dt=0.05,
                     physics=phys, dtype="float64")
    problem = msemi.build_problem(mesh, cfg)
    return [mstencil.build_stencil(L, phys, cfg.dt, cfg.theta)
            for L in problem.levels], problem


@pytest.mark.parametrize("name", ["test_sn2.msh", "untitled8.msh"])
def test_galerkin_equals_geometric_for_scale_invariant_physics(name,
                                                              mesh_dir):
    """Nested P1 spaces: P^T (M/dt + theta(D - K)) P == the rescaled coarse
    assembly exactly when no surface terms are present."""
    mesh = topology.from_msh(f"{mesh_dir}/{name}")
    phys = Physics(advection=True, u=(0.3, 0.7), surface_terms=False)
    datas, problem = _datas(mesh, phys)
    gal = galerkin.galerkin_coarse(datas[0], problem.levels[1]["s"],
                                   datas[1])
    np.testing.assert_allclose(gal.self_blocks, datas[1].self_blocks,
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(gal.face_blocks, datas[1].face_blocks,
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(gal.cross_blocks, datas[1].cross_blocks,
                               rtol=1e-12, atol=1e-13)


def test_galerkin_matches_dense_triple_product(mesh_dir):
    """Full SIP physics: the stencil R.A.P equals the dense P^T A P."""
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    phys = Physics()
    datas, problem = _datas(mesh, phys)
    n_c = problem.levels[1]["s"]
    gal = galerkin.galerkin_coarse(datas[0], n_c, datas[1])

    A_f = mstencil.to_dense(datas[0])
    U = mesh.num_elements
    Cf, Cc = 4 ** (n_c + 1), 4 ** n_c
    _, parent, pw = msemi._transfer_tables(n_c)
    P = np.zeros((U * Cf * 3, U * Cc * 3))
    for u in range(U):
        for fc in range(Cf):
            rows = (u * Cf + fc) * 3
            cols = (u * Cc + parent[fc]) * 3
            P[rows:rows + 3, cols:cols + 3] = pw[fc]
    want = P.T @ A_f @ P
    got = mstencil.to_dense(gal)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("name", ["test_sn2.msh", "untitled8.msh"])
def test_galerkin_vcycle_converges_at_least_as_fast(name, mesh_dir):
    """rho(galerkin) <= rho(geometric) * 1.05 with full SIP."""
    mesh = topology.from_msh(f"{mesh_dir}/{name}")

    def rho(coarse_op):
        cfg = SemiConfig(n_split=2, multi_levels=2, dt=1e8, dtype="float64",
                         coarse_operator=coarse_op)
        solver = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
        T = solver.initial_condition()
        b = solver._rhs(T)

        @jax.jit
        def seq(x):
            norms = []
            for _ in range(8):
                x = solver._vcycle(0, x, b)
                norms.append(jnp.max(jnp.abs(
                    solver.residual(0, x, b, True))))
            return jnp.stack(norms)
        n = np.asarray(seq(T), np.float64)
        return float((n[-1] / n[2]) ** (1.0 / 5.0))

    r_geo, r_gal = rho("geometric"), rho("galerkin")
    assert r_gal <= r_geo * 1.05, (r_gal, r_geo)
