import jax
import numpy as np
import pytest

from p_a_multigrids_tpu.config import SemiConfig, Solver
from p_a_multigrids_tpu.mesh import structured, topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.parallel import halo, partition
from p_a_multigrids_tpu.parallel.solver import DistributedSemiSolver


def test_bfs_partition_properties():
    mesh = structured.tri_mesh(8, 8, 0.125, 0.125)
    part = partition.partition_mesh(mesh, 8)
    assert part.mesh.num_elements % 8 == 0
    assert part.n_active == 128
    # BFS blocks keep most faces local
    assert partition.cut_fraction(part.mesh, 8) < 0.35


def test_pad_mesh_isolated():
    mesh = structured.tri_mesh(3, 1, 1.0, 1.0)   # 6 elements
    padded, n_active = partition.pad_mesh(mesh, 4)
    assert padded.num_elements == 8 and n_active == 6
    assert (padded.neig[6:] == -1).all()


def test_halo_plan_consistency():
    mesh = structured.tri_mesh(4, 2, 0.25, 0.25)
    grid_cfg = SemiConfig(n_split=1, multi_levels=1)
    p = msemi.build_problem(mesh, grid_cfg)
    neigh = np.asarray(p.levels[0]["neigh_elem"])
    plan = halo.build_halo_plan(neigh, 4)
    U, C = neigh.shape[:2]
    U_loc = U // 4
    block = U_loc * C
    # every remote reference resolves to the right global element
    for d in range(4):
        blk = neigh[d * U_loc:(d + 1) * U_loc]
        for (u, c, f) in zip(*np.nonzero(plan.is_remote[d])):
            g = blk[u, c, f]
            o = plan.src_dev[d, u, c, f]
            slot = plan.src_slot[d, u, c, f]
            assert plan.export_idx[o, slot] + o * block == g


@pytest.mark.parametrize("solver_kind", [Solver.CHEBYSHEV,
                                         Solver.BLOCK_JACOBI])
def test_distributed_matches_serial(mesh_dir, solver_kind):
    """shard_map solver over 8 CPU devices reproduces the serial solver to
    machine precision (the 'same-values-as-serial' multi-node assertion,
    SURVEY.md section 4)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = topology.from_msh(f"{mesh_dir}/test_sn2.msh")
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.05, ntime=2,
                     n_multigrid=2, solver=solver_kind, dtype="float64")
    dist = DistributedSemiSolver(mesh, cfg)
    Td = dist.run()
    ser = msemi.SemiSolver(msemi.build_problem(dist.part.mesh, cfg))
    Ts = ser.run()
    diff = np.abs(dist.active(Td)
                  - np.asarray(Ts)[: dist.part.n_active]).max()
    assert diff < 1e-12


def test_distributed_structured_bigger():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = structured.tri_mesh(8, 4, 0.125, 0.25)    # 64 macro elements
    cfg = SemiConfig(n_split=1, multi_levels=2, dt=0.1, ntime=1,
                     n_multigrid=1, dtype="float64")
    dist = DistributedSemiSolver(mesh, cfg)
    Td = dist.run()
    ser = msemi.SemiSolver(msemi.build_problem(dist.part.mesh, cfg))
    Ts = ser.run()
    assert np.abs(dist.active(Td) - np.asarray(Ts)).max() < 1e-12


def test_stencil_solver_matches_serial():
    """Fast distributed path (ppermute windows) == serial stencil solver."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from p_a_multigrids_tpu.mesh import topology as topo
    from p_a_multigrids_tpu.models import semi as msemi
    from p_a_multigrids_tpu.ops import fused
    from p_a_multigrids_tpu.parallel import partition as mpart
    from p_a_multigrids_tpu.parallel.stencil_solver import (
        DistributedStencilSolver)

    mesh = structured.tri_mesh(16, 4, 0.25, 0.25)      # U = 128
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.05, ntime=2,
                     n_multigrid=2, dtype="float64")
    dist = DistributedStencilSolver(mesh, cfg, devices=jax.devices()[:8])

    # serial reference on the SAME (reordered+padded) mesh
    serial = dist.serial
    T0_t = dist.initial_condition()
    out_d = dist.run(T0_t)
    T = fused.from_t(jnp.asarray(T0_t))
    for _ in range(cfg.ntime):
        T = serial._step(T)
    np.testing.assert_allclose(dist.to_std(out_d),
                               np.asarray(T)[: dist.n_active],
                               rtol=1e-11, atol=1e-12)


def test_stencil_solver_gate():
    """Distributed manufactured-solution gate on 8 devices."""
    import jax
    from p_a_multigrids_tpu.parallel.stencil_solver import (
        DistributedStencilSolver)

    mesh = structured.tri_mesh(16, 4, 0.25, 0.25)
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=1e8, ntime=2,
                     n_multigrid=4, dtype="float64")
    dist = DistributedStencilSolver(mesh, cfg, devices=jax.devices()[:8])
    out = dist.run()
    assert dist.error(out).mean() < 0.01


def _stencil_parity(cfg, mesh=None, n_dev=8, atol=1e-12, rtol=1e-11,
                    mesh_shape=None):
    """Run DistributedStencilSolver vs its serial twin; assert bit-match."""
    import jax
    import jax.numpy as jnp
    from p_a_multigrids_tpu.ops import fused
    from p_a_multigrids_tpu.parallel.stencil_solver import (
        DistributedStencilSolver)

    if len(jax.devices()) < n_dev:
        pytest.skip(f"needs {n_dev} devices")
    mesh = mesh if mesh is not None else structured.tri_mesh(
        16, 4, 0.25, 0.25)
    dist = DistributedStencilSolver(mesh, cfg,
                                    devices=jax.devices()[:n_dev],
                                    mesh_shape=mesh_shape)
    serial = dist.serial
    T0_t = dist.initial_condition()
    out_d = dist.run(T0_t)
    T = fused.from_t(jnp.asarray(T0_t))
    for _ in range(cfg.ntime):
        T = serial._step(T)
    np.testing.assert_allclose(dist.to_std(out_d),
                               np.asarray(T)[: dist.n_active],
                               rtol=rtol, atol=atol)
    return dist


def test_stencil_solver_krylov_matches_serial():
    """Distributed V-cycle-preconditioned PCG (psum dots) == serial Krylov
    path: the cfg.krylov flag is honored inside shard_map."""
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     krylov=True, krylov_tol=1e-10, dtype="float64")
    # iteration counts can differ by one due to reduction order; compare
    # at the Krylov tolerance, not bit-exactness
    _stencil_parity(cfg, atol=1e-8, rtol=1e-8)


def test_stencil_solver_coarse_krylov_matches_serial():
    """cfg.coarse_krylov drives the distributed coarsest-level CG."""
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     n_multigrid=2, coarse_krylov=True,
                     coarse_direct_max_dof=0, dtype="float64")
    _stencil_parity(cfg, atol=1e-9, rtol=1e-9)


def test_stencil_solver_wcycle_matches_serial():
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     n_multigrid=2, cycle_type="w", dtype="float64")
    _stencil_parity(cfg)


def test_stencil_solver_deep_split_rowgather():
    """n_split=4 (C=256) exercises the O(C) row-gather in the distributed
    _planes (the one-hot einsum path is O(C^2) there)."""
    cfg = SemiConfig(n_split=4, multi_levels=2, dt=0.5, ntime=1,
                     n_multigrid=1, dtype="float64")
    _stencil_parity(cfg, mesh=structured.tri_mesh(16, 2, 0.25, 0.25),
                    n_dev=4)


def test_stencil_solver_amg_matches_serial():
    """amg=True inside shard_map: partial-product + psum restriction,
    row-sharded aggregation levels.  psum changes the
    level-0 restriction's summation order, so compare at 1e-9, not
    bit-exactness."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.5, ntime=1,
                     n_multigrid=2, amg=True, agg_strength=0.3,
                     dtype="float64")
    _stencil_parity(cfg, n_dev=4, atol=1e-9, rtol=1e-9)


def test_stencil_solver_coarse_agg_matches_serial():
    """coarse_agg (SA below the geometric coarsest) sharded: hierarchy is
    engaged by forcing the dense-inverse cap to zero."""
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     n_multigrid=2, coarse_agg=True,
                     coarse_direct_max_dof=0, dtype="float64")
    _stencil_parity(cfg, n_dev=4, atol=1e-9, rtol=1e-9)


def test_stencil_solver_wide_window_many_devices():
    """W > U_loc: k-hop ring halos cover any window.  8 devices on a
    24-macro mesh leaves U_loc=3 << W."""
    mesh = structured.tri_mesh(4, 3, 0.25, 0.25)       # U = 24
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.5, ntime=1,
                     n_multigrid=1, dtype="float64")
    _stencil_parity(cfg, mesh=mesh, n_dev=8)


def test_stencil_solver_2d_mesh_bitexact():
    """2-D (hosts, chips) device mesh — the multi-host axis of SURVEY §5
    (reference partitioning seam: Generic.F90:387-405).  The
    RCM ring flattens row-major over ("host", "dp") and every collective
    runs over the axis tuple; the result must be BIT-identical to both
    the serial solver and the 1-D mesh (geometric config: no psum
    reduction-order caveat)."""
    import jax
    from p_a_multigrids_tpu.parallel.stencil_solver import (
        DistributedStencilSolver)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = structured.tri_mesh(16, 4, 0.25, 0.25)
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=2,
                     n_multigrid=2, dtype="float64")
    d2 = _stencil_parity(cfg, mesh=mesh, n_dev=8, mesh_shape=(2, 4))
    d1 = DistributedStencilSolver(mesh, cfg, devices=jax.devices()[:8])
    out1 = d1.run(d1.initial_condition())
    out2 = d2.run(d2.initial_condition())
    np.testing.assert_array_equal(d1.to_std(out1), d2.to_std(out2))


def test_stencil_solver_2d_mesh_production_amg():
    """The production configuration (sharded SA correction) on the
    (2, 4) mesh."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=1e8, ntime=2,
                     n_multigrid=2, amg=True, agg_strength=0.3,
                     dtype="float64")
    _stencil_parity(cfg, n_dev=8, mesh_shape=(2, 4), atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("case", [
    # two-level geometric cycle on a 4-device ring
    dict(cfg=dict(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                  n_multigrid=2), n_dev=4),
    # W-cycle on a 2-device ring
    dict(cfg=dict(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                  n_multigrid=1, cycle_type="w"), n_dev=2),
    # steady amg over two time steps (psum restriction order -> 1e-9)
    dict(cfg=dict(n_split=2, multi_levels=1, dt=1e8, ntime=2,
                  n_multigrid=2, amg=True, agg_strength=0.3), n_dev=4,
         tol=1e-9),
    # halo windows spanning several shards: U_loc = 4 on 8 devices
    dict(cfg=dict(n_split=1, multi_levels=1, dt=0.5, ntime=1,
                  n_multigrid=1, n_smooth=2, cheb_degree=2), n_dev=8,
         mesh=(8, 2)),
    # Krylov on a 4-device ring (iteration counts may differ by one)
    dict(cfg=dict(n_split=2, multi_levels=2, dt=0.5, ntime=1, krylov=True,
                  krylov_tol=1e-10), n_dev=4, tol=1e-8),
    # the production implicit path: amg-preconditioned PCG, sharded
    dict(cfg=dict(n_split=2, multi_levels=1, dt=0.05, ntime=1, amg=True,
                  agg_strength=0.5, cheb_degree=16, cheb_lower=0.05,
                  krylov=True, krylov_tol=1e-10), n_dev=4, tol=1e-8),
], ids=["geometric-4dev", "wcycle-2dev", "amg-steady-4dev",
        "multihop-halo-8dev", "krylov-4dev", "amg-pcg-4dev"])
def test_stencil_solver_parity_configs(case):
    """Distinct sharded configurations == the serial solver."""
    mesh = (structured.tri_mesh(*case["mesh"], 0.25, 0.25)
            if "mesh" in case else None)
    tol = case.get("tol")
    kw = dict(atol=tol, rtol=tol) if tol else {}
    _stencil_parity(SemiConfig(dtype="float64", **case["cfg"]), mesh=mesh,
                    n_dev=case["n_dev"], **kw)
