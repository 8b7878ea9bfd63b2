"""StencilOperator must reproduce apply_A exactly (probed from it)."""

import numpy as np
import pytest

import jax.numpy as jnp

from p_a_multigrids_tpu.config import Physics, SemiConfig
from p_a_multigrids_tpu.mesh import topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.ops import stencil as mstencil
from p_a_multigrids_tpu.ops.fused import from_t, to_t



def _physics(name):
    if name == "diffusion":
        return Physics()
    if name == "advect_diffuse":
        return Physics(advection=True, u=(0.7, -0.3))
    if name == "no_surface":
        return Physics(surface_terms=False)
    if name == "penalty_only":
        return Physics(sip_consistency=False)
    raise KeyError(name)


@pytest.mark.parametrize("builder", ["probe", "analytic"])
@pytest.mark.parametrize("phys_name", ["diffusion", "advect_diffuse",
                                       "no_surface", "penalty_only"])
@pytest.mark.parametrize("n_split", [1, 2])
def test_stencil_matches_apply_A(phys_name, n_split, builder, mesh_dir):
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                     physics=_physics(phys_name), dtype="float64")
    if phys_name in ("diffusion", "advect_diffuse"):
        # exercise the Neumann-mirror self coupling too
        cfg.fns.neumann = lambda x, y: x < 0.2
    problem = msemi.build_problem(mesh, cfg)
    L = problem.levels[0]

    build = (mstencil.probe_stencil if builder == "probe"
             else mstencil.build_stencil)
    data = build(L, cfg.physics, cfg.dt, cfg.theta)
    op = mstencil.StencilOperator(data, jnp.float64)

    rng = np.random.default_rng(3)
    U, C = mesh.num_elements, 4 ** n_split
    x = jnp.asarray(rng.normal(size=(U, C, 3)))

    ref_hom = msemi.apply_A(L, cfg.physics, cfg.dt, cfg.theta, x, False,
                            msemi.structured_gather)
    ref_bc = msemi.apply_A(L, cfg.physics, cfg.dt, cfg.theta, x, True,
                           msemi.structured_gather)
    got_hom = from_t(op.apply(to_t(x), False))
    got_bc = from_t(op.apply(to_t(x), True))
    np.testing.assert_allclose(np.asarray(got_hom), np.asarray(ref_hom),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_bc), np.asarray(ref_bc),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("phys_name", ["diffusion", "advect_diffuse",
                                       "no_surface", "penalty_only"])
def test_analytic_blocks_equal_probed_blocks(phys_name, mesh_dir):
    """build_stencil (closed form) == probe_stencil (numerical) blockwise."""
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05,
                     physics=_physics(phys_name), dtype="float64")
    if phys_name == "advect_diffuse":
        cfg.fns.neumann = lambda x, y: y > 0.8
    problem = msemi.build_problem(mesh, cfg)
    L = problem.levels[0]
    probed = mstencil.probe_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    exact = mstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    for field in ("self_blocks", "face_blocks", "cross_blocks", "c_aff"):
        np.testing.assert_allclose(
            getattr(exact, field), getattr(probed, field),
            rtol=1e-11, atol=1e-12, err_msg=field)
    for field in ("halo_src", "bnd_c", "bnd_f", "intra_onehot",
                  "cross_onehot"):
        np.testing.assert_array_equal(getattr(exact, field),
                                      getattr(probed, field))


def test_premultiplied_sweep_matches_block_jacobi(mesh_dir):
    """One smoother sweep equals x + w D^-1 (b - A x) with exact D blocks."""
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.05, dtype="float64")
    problem = msemi.build_problem(mesh, cfg)
    L = problem.levels[0]
    data = mstencil.probe_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    op = mstencil.StencilOperator(data, jnp.float64)

    rng = np.random.default_rng(5)
    U, C = mesh.num_elements, 4
    x = jnp.asarray(rng.normal(size=(U, C, 3)))
    b = jnp.asarray(rng.normal(size=(U, C, 3)))

    got = from_t(op.smooth_jacobi(to_t(x), to_t(b), 0.8, 1, True))

    A_bc = msemi.apply_A(L, cfg.physics, cfg.dt, cfg.theta, x, True,
                         msemi.structured_gather)
    r = np.asarray(b - A_bc)
    Dinv = mstencil.inv3x3(data.self_blocks)
    want = np.asarray(x) + 0.8 * np.einsum("ucij,ucj->uci", Dinv, r)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-11,
                               atol=1e-12)


def test_lam_max_close_to_device_estimate(mesh_dir):
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05, dtype="float64")
    problem = msemi.build_problem(mesh, cfg)
    L = problem.levels[0]
    data = mstencil.probe_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    op = mstencil.StencilOperator(data, jnp.float64)
    lam = op.lam_max_estimate()
    # D^-1 A of an SPD-dominant operator: top eigenvalue is O(1)
    assert 1.0 < lam < 5.0
