"""Assembled-operator (block-sparse) variant of the semi-structured solver.

The reference's mode 10 ``Semi_implicit_iterative_P``
(/root/reference/transport_tri_semi.F90:908-1365) assembles the operator
into its fixed-sparsity CSR (make_sparse_matrix_flux_semi,
matrices.F90:997-1411) and smooths with Jacobi over `csr_mul_array`; mode 8
``Semi_implicit_direct`` (:1366-1786) densifies it and calls FINDInv.  Here
the same operator is assembled ONCE into the fixed-degree ELL/BSR layout of
ops.bsr — one diagonal block plus one block per face — as a batched einsum
over the whole mesh, and applied with the regular gather+batched-matmul
SpMV (the nnz/s benchmark kernel).

``assemble_operator`` is verified against the matrix-free ``apply_A`` to
machine precision (tests/test_assembled.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Physics, SemiConfig
from ..ops import bsr
from . import semi


def _face_blocks(L: dict, phys: Physics, theta: float) -> jax.Array:
    """Off-diagonal (neighbor-coupling) blocks -> (U, C, 3, nloc, nloc).

    Columns are in the NEIGHBOR's local node numbering; rows in mine.
    Derivation mirrors apply_spatial's t2-dependent terms.
    """
    U = L["M"].shape[0]
    C = L["updown"].shape[0]
    dtype = L["M"].dtype
    B = jnp.zeros((U, C, 3, 3, 3), dtype)
    if not phys.surface_terms:
        return B
    # one-hot of the neighbor-node permutation: P[u,c,f,k,j] = 1 where the
    # neighbor's node j sits at my k-th face node
    Pm = jax.nn.one_hot(L["neigh_perm"], 3, dtype=dtype)   # (U,C,3,2,3)
    sdet = L["sdet"][:, None]                              # (U,1,3,sngi)
    snorm = L["snorm"][:, None] * L["updown"][None, :, None, None, None]
    # S2[u,c,f,i,k] = sum_g face_sn[f,g,i] sn[g,k] sdet[u,f,g]
    S2 = jnp.einsum("fgi,gk,ucfg->ucfik", L["face_sn"], L["sn"],
                    jnp.broadcast_to(sdet, (U, C, 3, L["sn"].shape[0])))
    if phys.diffusion:
        k = jnp.asarray(phys.k, dtype)
        dif = L["diff_on"]
        # penalty: -eta k/dx * S2 (perm to neighbor columns)
        pen = -(phys.penalty_factor * k
                * jnp.einsum("ucf,ucfik,ucfkj->ucfij",
                             L["inv_dx"] * dif, S2, Pm))
        B = B + theta * pen
        if phys.sip_consistency:
            nxc = (L["nx1"][:, None] * (2.0 ** L["s"])
                   * L["updown"][None, :, None, None])     # (U,C,2,nloc)
            # neighbor's gradient coefficients, gathered across each face
            nxc2 = semi.flat_gather(L, nxc.reshape(U, C, 6)).reshape(
                U, C, 3, 2, 3)                             # (U,C,3f,2,nloc)
            # consistency (neighbor-gradient half): -k/2 sum_g face_sn_i
            # sdet (n . nxc2_j)
            nn2 = jnp.einsum("ucfgd,ucfdj->ucfgj", snorm, nxc2)
            cons = -0.5 * k * jnp.einsum(
                "fgi,ucfg,ucfgj->ucfij", L["face_sn"],
                jnp.broadcast_to(sdet, nn2.shape[:4]) * dif[..., None], nn2)
            B = B + theta * cons
            # symmetry (t2 half): +w k (nxc . n)_i sum_g sn_k sdet
            nxn = jnp.einsum("ucdi,ucfgd->ucfgi", nxc, snorm)
            w = 0.5 * dif                                  # interior faces
            sym = k * jnp.einsum(
                "ucf,ucfgi,gk,ucfg,ucfkj->ucfij", w, nxn, L["sn"],
                jnp.broadcast_to(sdet, nxn.shape[:4]), Pm)
            B = B + theta * sym
    if phys.advection:
        u_const = jnp.asarray(np.asarray(phys.u), dtype)
        un = jnp.einsum("ucfgd,d->ucfg", snorm, u_const)
        income = 0.5 + 0.5 * jnp.sign(-un)
        adv = jnp.einsum("fgi,ucfg,gk,ucfkj->ucfij", L["face_sn"],
                         un * jnp.broadcast_to(sdet, un.shape) * income,
                         L["sn"], Pm)
        B = B + theta * adv
    return B


def assemble_operator(L: dict, phys: Physics, dt: float,
                      theta: float) -> bsr.BSR:
    """Assemble A as a fixed-degree BSR matrix over flat child elements."""
    diag = semi.diag_blocks_A(L, phys, dt, theta)
    face = _face_blocks(L, phys, theta)
    U, C = diag.shape[:2]
    neigh = np.asarray(L.get("_np", L)["neigh_elem"]).reshape(U * C, 3)
    return bsr.build(diag.reshape(U * C, 3, 3),
                     face.reshape(U * C, 3, 3, 3), neigh)


def affine_offset(L: dict, phys: Physics, dt: float,
                  theta: float) -> jax.Array:
    """c with A_affine(x) = A_bsr x + c (the Dirichlet-ghost load)."""
    z = jnp.zeros_like(L["bc_dense"][..., 0])
    return semi.apply_A(L, phys, dt, theta, z, True)


class AssembledSemiSolver(semi.SemiSolver):
    """SemiSolver whose TIME LOOP iterates on the assembled BSR operator.

    Mode-10 parity (``Semi_implicit_iterative_P``, transport_tri_semi.F90:
    908-1365): the reference assembles the CSR system once and then smooths
    it with damped Jacobi over ``csr_mul_array`` (:1095-1170, solve_Jacobi
    :491-497).  Here ``_step`` runs ``n_multigrid * n_smooth`` damped
    block-Jacobi sweeps whose residuals come from the BSR SpMV
    (ops/bsr.BSR.spmv) — exact 3x3 block solves instead of the reference's lumped point diagonal
    (get_diagonal :481-486), same omega damping.  Verified equal to the
    stencil path's smooth_jacobi in f64 (tests/test_assembled.py)."""

    def __init__(self, problem: semi.SemiProblem):
        # SLIM setup — deliberately NOT super().__init__: mode 10 iterates
        # only on the assembled fine operator, so the flagship's agg/AMG
        # hierarchy, coarse dense inverse and spectral estimates are all
        # dead weight here.  Only
        # the level-0 analytic stencil is built (host numpy) — it supplies
        # the exact block diagonal and backs convergence()/diagnostics.
        self.p = problem
        self.cfg = cfg = problem.cfg
        self._gather = semi.structured_gather
        self._fused = None
        self._agg = None
        self._agg_li = None
        self._coarse_inv = self._coarse_inv_t = None
        from ..ops import stencil as _st
        dtype = jnp.dtype(cfg.dtype)
        data0 = _st.build_stencil(problem.levels[0], cfg.physics, cfg.dt,
                                  cfg.theta)
        self._stencil = [_st.StencilOperator(data0, dtype)]
        from ..ops import fused as _fused
        self._fmod = _fused

        self.A_bsr = assemble_operator(problem.levels[0], cfg.physics,
                                       cfg.dt, cfg.theta)
        self.offset = affine_offset(problem.levels[0], cfg.physics, cfg.dt,
                                    cfg.theta)
        self._spmv = self.A_bsr.spmv
        self._step = jax.jit(self._make_assembled_step())

    def run(self, T=None, ntime: int | None = None):
        """Time loop on the assembled step (the slim init builds no
        transposed-cycle machinery, so bypass SemiSolver.run's fast path)."""
        if T is None:
            T = self.initial_condition()
        for _ in range(ntime or self.cfg.ntime):
            T = self._step(T)
        return T

    def apply_assembled(self, T: jax.Array, with_bc: bool = True):
        U, C, n = T.shape
        y = self._spmv(T.reshape(U * C, n)).reshape(U, C, n)
        return y + self.offset if with_bc else y

    def _make_assembled_step(self):
        """theta-implicit step: n_multigrid*n_smooth damped block-Jacobi
        sweeps on the assembled system A x = b - c."""
        cfg = self.cfg
        dtype = self.offset.dtype
        # the stencil operator's premultiplied inverse diagonal IS the
        # block diagonal of the assembled operator (same diag_blocks_A)
        if self._stencil is not None:
            Dinv = jnp.asarray(self._stencil[0]._dinv_np, dtype)
        else:
            from ..ops.stencil import inv3x3
            Dinv = jnp.asarray(inv3x3(np.asarray(semi.diag_blocks_A(
                self.p.levels[0], cfg.physics, cfg.dt, cfg.theta),
                np.float64)), dtype)                          # (U, C, 3, 3)
        sweeps = max(1, cfg.n_multigrid * cfg.n_smooth)
        omega = jnp.asarray(cfg.omega, dtype)

        def step(T):
            b = self._rhs(T) - self.offset
            U, C, n = T.shape
            bf = b.reshape(U * C, n)
            Df = Dinv.reshape(U * C, n, n)

            def sweep(x, _):
                r = bf - self._spmv(x)
                z = jnp.einsum("eij,ej->ei", Df, r)
                return x + omega * z, None

            x, _ = jax.lax.scan(sweep, T.reshape(U * C, n), None,
                                length=sweeps)
            return x.reshape(T.shape)
        return step


def direct_solve(mesh, cfg: SemiConfig | None = None):
    """Mode 8 ``Semi_implicit_direct``: assemble, densify, factorize once,
    and time-step with the precomputed inverse (the FINDInv replacement)."""
    cfg = cfg or SemiConfig()
    problem = semi.build_problem(mesh, cfg)
    solver = AssembledSemiSolver(problem)
    A = bsr.to_dense_numpy(solver.A_bsr)
    Ainv = jnp.asarray(np.linalg.inv(A), A.dtype)
    c = solver.offset

    @jax.jit
    def step(T):
        b = solver._rhs(T) - c
        x = (Ainv @ b.reshape(-1)).reshape(T.shape)
        return x

    T = solver.initial_condition()
    for _ in range(cfg.ntime):
        T = step(T)
    return solver, T
