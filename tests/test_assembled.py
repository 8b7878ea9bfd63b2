import jax.numpy as jnp
import numpy as np
import pytest

from p_a_multigrids_tpu.config import Physics, SemiConfig, Solver
from p_a_multigrids_tpu.mesh import structured, topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.models import semi_assembled as ma


@pytest.fixture(scope="module")
def mesh(mesh_dir):
    return topology.from_msh(f"{mesh_dir}/test_sn2.msh")


@pytest.mark.parametrize("phys", [
    Physics(diffusion=True, advection=False),
    Physics(diffusion=True, advection=True, u=(0.7, -0.3)),
    Physics(diffusion=False, advection=True, u=(1.0, 0.5)),
    Physics(diffusion=True, sip_consistency=False),
])
def test_assembled_matches_matrix_free(mesh, phys):
    """BSR-assembled operator == matrix-free apply_A (homogeneous BCs)."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.3, physics=phys,
                     dtype="float64")
    p = msemi.build_problem(mesh, cfg)
    solver = ma.AssembledSemiSolver(p)
    rng = np.random.default_rng(0)
    T = jnp.asarray(rng.normal(size=(mesh.num_elements, 16, 3)))
    y_mf = msemi.apply_A(p.levels[0], phys, cfg.dt, cfg.theta, T, False)
    y_as = solver.apply_assembled(T, with_bc=False)
    assert np.abs(np.asarray(y_mf - y_as)).max() < 1e-11


def test_assembled_affine_matches(mesh):
    """With Dirichlet ghosts: A_bsr x + offset == affine apply_A."""
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.3, dtype="float64")
    p = msemi.build_problem(mesh, cfg)
    solver = ma.AssembledSemiSolver(p)
    rng = np.random.default_rng(1)
    T = jnp.asarray(rng.normal(size=(mesh.num_elements, 4, 3)))
    y_mf = msemi.apply_A(p.levels[0], cfg.physics, cfg.dt, cfg.theta, T,
                         True)
    y_as = solver.apply_assembled(T, with_bc=True)
    assert np.abs(np.asarray(y_mf - y_as)).max() < 1e-11


def test_direct_solve_matches_iterative(mesh):
    """Mode 8 (dense direct) and mode 9 (multigrid iterative) agree."""
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.5, ntime=2,
                     n_multigrid=1, krylov=True, krylov_tol=1e-12,
                     dtype="float64")
    _, T_direct = ma.direct_solve(mesh, cfg)
    s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    T_iter = s.run()
    assert np.abs(np.asarray(T_direct - T_iter)).max() < 1e-8


def test_mode10_sweep_equals_stencil_jacobi(mesh):
    """One assembled block-Jacobi sweep == the stencil smoother's sweep:
    the mode-10 time loop iterates the SAME fixed point as mode 9's
    smoother, but through the BSR SpMV."""
    from p_a_multigrids_tpu.ops import fused
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.3, ntime=1,
                     n_multigrid=1, n_smooth=1, dtype="float64")
    p = msemi.build_problem(mesh, cfg)
    s = ma.AssembledSemiSolver(p)
    T = s.initial_condition()
    # assembled step: 1 sweep on A x = b - offset starting from T
    x_asm = s._step(T)
    # stencil path: smooth_jacobi on the same premultiplied system
    op = s._stencil[0]
    b_t = fused.to_t(s._rhs(T))
    x_st = fused.from_t(op.smooth_jacobi(fused.to_t(T), b_t, cfg.omega, 1,
                                         True))
    assert np.abs(np.asarray(x_asm - x_st)).max() < 1e-11


def test_mode10_iterates_bsr_and_converges(mesh):
    """The mode-10 time loop (a) actually drives the BSR SpMV and (b)
    converges to the direct (mode 8) solution on a diagonally dominant
    step (small dt)."""
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=1e-5, ntime=1,
                     n_multigrid=10, n_smooth=10, dtype="float64")
    p = msemi.build_problem(mesh, cfg)
    s = ma.AssembledSemiSolver(p)
    traced = []
    orig = s._spmv
    s._spmv = lambda v: (traced.append(1), orig(v))[1]
    import jax
    s._step = jax.jit(s._make_assembled_step())
    T = s.initial_condition()
    x10 = s._step(T)
    assert traced, "mode-10 step never applied the assembled operator"
    _, x8 = ma.direct_solve(mesh, cfg)
    assert np.abs(np.asarray(x10 - x8)).max() < 1e-9


def test_semi_explicit_mode7(mesh):
    """Mode 7 semi_explicit: theta=0 on the hierarchy, stable bounded run."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=2e-6, ntime=5, theta=0.0,
                     n_multigrid=1, n_smooth=1, omega=1.0,
                     solver=Solver.BLOCK_JACOBI, dtype="float64")
    s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    T = s.run()
    assert np.isfinite(np.asarray(T)).all()
    assert np.abs(np.asarray(T)).max() < 5.0
