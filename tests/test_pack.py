"""Macro-packed coarse levels (ops.stencil.pack_stencil, cfg.coarse_pack).

Packing re-indexes a level as (U/p packs) x (p*C children) — a pure
relabeling of the same operator.  These tests pin the relabeling's
exactness: operator application is BIT-identical under packing, and the
full solver (coarse_pack=4) reproduces the unpacked solver.
"""

import jax
import numpy as np
import pytest

import jax.numpy as jnp

from p_a_multigrids_tpu.config import SemiConfig
from p_a_multigrids_tpu.mesh import structured, topology
from p_a_multigrids_tpu.models import semi as msemi
from p_a_multigrids_tpu.ops import stencil as st


def _coarse_pair(p=4):
    mesh = topology.rcm_reorder(structured.tri_mesh(16, 4, 0.25, 0.25))
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     dtype="float64")
    s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    data = s._stencil[1]._data
    op_u = s._stencil[1]
    op_p = st.StencilOperator(st.pack_stencil(data, p), np.float64)
    return s, op_u, op_p


def test_pack_roundtrip_layout():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(3, 4, 128)))
    back = msemi.unpack_x_t(msemi.pack_x_t(x, 4), 4)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_pack_apply_bitexact():
    _, op_u, op_p = _coarse_pair()
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(3, 4, 128)))
    y_u = np.asarray(op_u.apply(x, True))
    y_p = np.asarray(msemi.unpack_x_t(op_p.apply(msemi.pack_x_t(x, 4),
                                                 True), 4))
    np.testing.assert_array_equal(y_p, y_u)


def test_pack_lam_max_identical():
    """The power-iteration seed flattens identically under the pack order
    (u*C + c == q*Cn + j*C + c), so the Chebyshev interval — and with it
    every smoothing coefficient — is exactly preserved."""
    _, op_u, op_p = _coarse_pair()
    assert op_u.lam_max_estimate() == op_p.lam_max_estimate()


def test_pack_rejects_bad_shapes():
    _, op_u, _ = _coarse_pair()
    with pytest.raises(ValueError):
        st.pack_stencil(op_u._data, 5)       # 128 % 5 != 0
    packed = st.pack_stencil(op_u._data, 4)
    with pytest.raises(ValueError):
        st.pack_stencil(packed, 2)           # no double packing


@pytest.mark.parametrize("extra", [
    {}, {"coarse_cheb_degree": 8, "coarse_cheb_lower": 0.02},
    {"cycle_type": "w"},
    {"multi_levels": 3, "n_split": 3}, {"coarse_krylov": True}])
def test_pack_solver_end_to_end(extra):
    """coarse_pack=4 solver == unpacked solver (same Chebyshev roots by
    test_pack_lam_max_identical; remaining diffs are transfer-fusion
    reassociation at machine epsilon)."""
    mesh = topology.rcm_reorder(structured.tri_mesh(16, 4, 0.25, 0.25))
    kw = dict(n_split=2, multi_levels=2, dt=1e8, ntime=2, n_multigrid=3,
              dtype="float64", coarse_direct_max_dof=0)
    kw.update(extra)
    outs = {}
    for pk in (1, 4):
        cfg = SemiConfig(coarse_pack=pk, **kw)
        s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
        if pk == 4:
            assert s._pack[1] == 4, "packing must engage at level 1"
        outs[pk] = np.asarray(s.run())
    np.testing.assert_allclose(outs[4], outs[1], rtol=0, atol=1e-13)


def test_pack_skips_protected_levels():
    """Levels the dense coarse inverse or SA correction consume stay
    unpacked (their builders assume the splitting lattice)."""
    mesh = topology.rcm_reorder(structured.tri_mesh(16, 4, 0.25, 0.25))
    # dense coarse inverse engages (1536 dof <= default cap)
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     dtype="float64", coarse_pack=4)
    s = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    assert s._pack == [1, 1]
    assert s._coarse_inv is not None


def test_pack_distributed_rejected():
    from p_a_multigrids_tpu.parallel.stencil_solver import (
        DistributedStencilSolver)
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    mesh = structured.tri_mesh(16, 4, 0.25, 0.25)
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                     coarse_pack=4, dtype="float64")
    with pytest.raises(ValueError, match="coarse_pack"):
        DistributedStencilSolver(mesh, cfg, devices=jax.devices()[:2])
