import jax.numpy as jnp
import numpy as np
import pytest

from p_a_multigrids_tpu.config import Physics, SemiConfig
from p_a_multigrids_tpu.mesh import topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.ops import fused


@pytest.fixture(scope="module")
def mesh(mesh_dir):
    return topology.from_msh(f"{mesh_dir}/test_sn2.msh")


@pytest.mark.parametrize("phys", [
    Physics(diffusion=True, advection=False),
    Physics(diffusion=True, advection=True, u=(0.7, -0.3)),
    Physics(diffusion=False, advection=True, u=(1.0, 0.5)),
    Physics(diffusion=True, sip_consistency=False),
    Physics(diffusion=True, surface_terms=False),
])
@pytest.mark.parametrize("with_bc", [False, True])
def test_fused_matches_reference_operator(mesh, phys, with_bc):
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.3, physics=phys,
                     dtype="float64")
    p = msemi.build_problem(mesh, cfg)
    L = p.levels[0]
    op = fused.FusedOperator(L, phys, cfg.dt, cfg.theta)
    rng = np.random.default_rng(0)
    T = jnp.asarray(rng.normal(size=(mesh.num_elements, 16, 3)))
    y_ref = msemi.apply_A(L, phys, cfg.dt, cfg.theta, T, with_bc)
    y_fused = fused.from_t(op.apply(fused.to_t(T), with_bc))
    assert np.abs(np.asarray(y_ref - y_fused)).max() < 1e-11


def test_fused_with_neumann(mesh):
    import numpy as np
    from p_a_multigrids_tpu.config import ProblemFns
    fns = ProblemFns(
        bc=lambda x, y: np.sin(x + y),
        neumann=lambda x, y: np.asarray(x) > 0.5)
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.3, fns=fns,
                     dtype="float64")
    p = msemi.build_problem(mesh, cfg)
    L = p.levels[0]
    op = fused.FusedOperator(L, cfg.physics, cfg.dt, cfg.theta)
    rng = np.random.default_rng(1)
    T = jnp.asarray(rng.normal(size=(mesh.num_elements, 4, 3)))
    for with_bc in (False, True):
        y_ref = msemi.apply_A(L, cfg.physics, cfg.dt, cfg.theta, T, with_bc)
        y_fused = fused.from_t(op.apply(fused.to_t(T), with_bc))
        assert np.abs(np.asarray(y_ref - y_fused)).max() < 1e-11
