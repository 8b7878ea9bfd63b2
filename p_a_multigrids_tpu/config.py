"""Run configuration (replaces the reference's hard-coded mode dispatch).

The reference has no runtime config: an integer ``mode`` and literal
argument tuples in /root/reference/main.F90:16-51, with mesh path, n_split,
ntime, theta, k etc. hard-coded inside each driver
(transport_tri_semi.F90:99,117-140).  Here every knob is an explicit
dataclass; drivers take a config and a mesh.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

# scalar field callables take numpy arrays (x, y) and return an array
FieldFn = Callable


@dataclasses.dataclass
class ProblemFns:
    """Optional problem-defining callables (evaluated host-side at setup).

    When unset and ``manufactured`` is on, the sin(x+y) manufactured
    solution supplies all of them (splitting.F90:1401-1405).
    """
    bc: FieldFn | None = None          # Dirichlet ghost values g(x, y)
    source: FieldFn | None = None      # volume source s(x, y)
    analytical: FieldFn | None = None  # exact solution for error fields
    ic: FieldFn | None = None          # initial condition T0(x, y)
    # (x, y) of a boundary-face midpoint -> True where the face is no-flux
    # (homogeneous Neumann) instead of weak Dirichlet.  None = all Dirichlet.
    neumann: FieldFn | None = None


class Solver(enum.Enum):
    JACOBI = "jacobi"              # solve_Jacobi (transport_tri_semi.F90:491)
    RICHARDSON = "richardson"      # solve_Richardson (:511)
    GAUSS_SEIDEL = "gauss_seidel"  # colored GS replacing :501
    BLOCK_JACOBI = "block_jacobi"  # exact 3x3 block solves
    CHEBYSHEV = "chebyshev"        # Chebyshev-accelerated block-Jacobi
    DIRECT = "direct"              # dense factorization (FINDInv replacement)


@dataclasses.dataclass
class Physics:
    """Term toggles (transport_tri_semi.F90:55-57 activate_* flags)."""
    advection: bool = False
    diffusion: bool = True
    # upwind advection flux + interior-penalty diffusion on faces; the
    # reference's active mode 9 has these commented out (:619-688) — set
    # False for reference-parity runs, True for the full physics.
    surface_terms: bool = True
    # full symmetric-interior-penalty consistency/symmetry terms.  The
    # reference penalizes jumps only (add_diffusion_surf,
    # matrices.F90:113-115), which is inconsistent for P1 DG (face nodes
    # carry the trace, so jumps vanish at the exact solution and nothing
    # approximates the diffusive flux); SIP restores optimal convergence.
    # False reproduces the reference's penalty-only scheme.
    sip_consistency: bool = True
    # SIP eta (reference effectively 1.0).  3.0 = the P1 trace-constant
    # bound with the |F|/|E| face scaling — coercive with margin (eta ~ 1
    # is where coercivity is lost on the zoo meshes) and measurably easier
    # on the multigrid: over-penalization stiffens the jump modes the
    # smoother must damp (two-grid rho 0.27 @ eta 2.5 vs 0.51 @ eta 4 on
    # the strip family) while leaving the discretization error unchanged
    # (L1 gates identical to 3 digits across eta in [2.5, 4]).
    penalty_factor: float = 3.0
    k: float = 1.0                 # diffusion coefficient (:136)
    u: tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass
class SemiConfig:
    """Flagship semi-structured multigrid transport solve (modes 7-10)."""
    n_split: int = 1
    multi_levels: int = 1
    n_multigrid: int = 2           # V-cycles per time step (main.F90:46)
    n_smooth: int = 4              # pre/post smooth sweeps
    coarse_sweeps: int = 15        # coarsest-level smoother iterations (:351)
    ntime: int = 2
    dt: float = 1.25e-5            # CFL*dx of the mode-9 call
    theta: float = 1.0
    omega: float = 0.8             # relaxation weight (:140)
    solver: Solver = Solver.CHEBYSHEV
    # Chebyshev smoothing interval [cheb_lower*lam_max, lam_max] of the
    # block-preconditioned operator; degree = operator applications per
    # smoothing phase.  Measured two-grid rho ~0.36 vs ~0.67 for 4 damped
    # block-Jacobi sweeps at equal cost.
    cheb_degree: int = 6
    cheb_lower: float = 0.1
    # coarsest-level treatment: exact dense solve (precomputed inverse,
    # applied as one matmul) when the coarsest system has at most this
    # many DOF; otherwise `coarse_sweeps` smoother applications.  Replaces
    # the reference's 15 Gauss-Seidel sweeps / FINDInv Gauss-Jordan
    # (transport_tri_semi.F90:351-359, matrices.F90:1618-1716).
    coarse_direct_max_dof: int = 4096
    # aggregation coarse levels BELOW the geometric hierarchy
    # (ops/agg.py): when the geometric coarsest still exceeds the dense
    # cap, continue coarsening algebraically (groups of ~4 elements, 3
    # locally-linear DOFs per aggregate, Galerkin P^T A P) down to a dense
    # direct solve.  The reference never needs this (its macro meshes have
    # 14-224 triangles); at 8k+ macro elements it is what keeps the
    # V-cycle contracting instead of stalling on `coarse_sweeps`
    # stationary sweeps.  Stencil-path (block-Jacobi/Chebyshev) only.
    coarse_agg: bool = True
    agg_sweeps: int = 2            # block-Jacobi sweeps per agg level
    agg_cycles: int = 1            # agg V-cycles per coarse correction
    # dense-direct cap for the BOTTOM of the aggregation hierarchy
    # (separate from coarse_direct_max_dof, which also sizes the geometric
    # coarse inverse).  A larger cap truncates the deep tail of tiny agg
    # levels into one matmul, but the inverse is embedded in the compiled
    # graph as a constant (4096 DOF = 64 MB in f32), which lengthens the
    # compile.
    agg_dense_max_dof: int = 4096
    # SA filtering of the Galerkin level operators: blocks below
    # drop_tol * sqrt(|diag_i||diag_j|) are dropped (ops/agg
    # _padded_operator).  The levels are approximate coarse solvers, so
    # moderate filtering (up to ~0.02) trades a few points of rho for a
    # substantially narrower (faster) device operator.
    agg_drop_tol: float = 1e-4
    # elements per aggregate (BFS target).  4 is classical SA; 8 halves
    # every level's row count (the device cycle cost) at some rho cost —
    # worthwhile when the correction is the cycle's dominant term.
    agg_target: int = 4
    # strength-of-connection threshold for the aggregation (0 = aggregate
    # on the raw adjacency).  Dropping weak couplings before aggregating
    # semicoarsens along anisotropy — on stretched-element meshes
    # (untitled8192: 3:1 triangles) it is the difference between a
    # correction that works (rho ~ 0.24) and one that stalls (~0.7);
    # block smoothers cannot damp weak-direction oscillation and no
    # isotropically-coarsened space can represent it.
    agg_strength: float = 0.4
    # FULL algebraic mode: the finest level is corrected directly by the
    # strength-filtered smoothed-aggregation hierarchy (geometric coarse
    # levels are bypassed).  This is the robust choice on anisotropic
    # meshes, where the geometric two-grid pair caps at rho ~ 0.6 no
    # matter how hard it smooths (measured, untitled8192 with an EXACT
    # coarse solve); on uniform meshes the geometric hierarchy is cheaper.
    amg: bool = False
    # multigrid cycle shape: "v" visits each coarse level once per cycle;
    # "w" recurses twice at the top two level pairs — those coarse systems
    # are solved much more accurately for <2x fine-level cost (levels
    # shrink 4x per depth), keeping the multi-level contraction near the
    # two-grid rate.  (The W-recursion is capped at depth 2: a full W
    # unrolls 2^levels coarse visits into the compiled graph.)
    cycle_type: str = "v"
    # when the coarsest level exceeds the dense-direct cap, solve it with
    # `coarse_sweeps` iterations of block-Jacobi-preconditioned CG instead
    # of `coarse_sweeps` smoother applications (same cost per iteration,
    # spectrally adaptive — an upgrade over the reference's 15 fixed
    # Gauss-Seidel sweeps, transport_tri_semi.F90:351-359; measured
    # two-grid rho 0.86 -> 0.57 on 900_ele at n_split=3).  Opt-in: the
    # distributed solver and the reference-parity paths keep the
    # stationary sweeps, and it must stay off when the V-cycle serves as
    # a Krylov preconditioner (krylov=True) — an inner CG makes the
    # preconditioner nonlinear across outer iterations.
    coarse_krylov: bool = False
    # Krylov-accelerated implicit solves: each time step runs PCG (SPD
    # diffusion) or BiCGStab (advective) with the V-cycle/smoother as
    # preconditioner, instead of bare V-cycle iteration.  This is the
    # replacement for the reference's densify-and-FINDInv implicit path.
    krylov: bool = False
    krylov_tol: float = 1e-8
    krylov_maxiter: int = 200
    # transposed-layout fused operator (ops/fused.py), used above
    # `stencil_max_children`; False falls back to the reference-shaped
    # einsum-per-term implementation (useful for debugging)
    fast_operator: bool = True
    # exact block-stencil operator (ops/stencil.py): the operator probed
    # into fixed-degree (self + 3 faces) blocks at setup and applied as ~40
    # coefficient-plane FMAs plus neighbour gathers — the fast path.
    # Disabled automatically above `stencil_max_children` children per
    # macro element, where the probing/storage cost outgrows its benefit.
    stencil_operator: bool = True
    # build the stencil blocks by numerical basis probing of apply_A instead
    # of the closed-form assembly (ops/stencil.build_stencil).  Probing is
    # exact by construction but pays per-level XLA compiles (~seconds); it
    # exists as the self-validating cross-check of the analytic builder
    # (tests/test_stencil.py asserts they agree to machine precision).
    stencil_probe: bool = False
    stencil_max_children: int = 4096
    # macro-pack factor for coarse stencil levels (ops/stencil.pack_stencil):
    # level li >= 1 is re-indexed as (U/p packs) x (p*C children) when
    # U % p == 0 and p*C <= 64, so a small-C coarse level runs on p-fold
    # wider child planes.  Pure relabeling of the same operator; 1
    # disables.  Levels carrying the SA correction, the dense coarse
    # inverse, or a Galerkin rebuild below them are skipped.
    coarse_pack: int = 1
    # coarsest-level Chebyshev polynomial: by default the coarse phase
    # repeats the fine degree (cheb_degree) floor(coarse_sweeps/degree)
    # times — two stacked deg-6 polynomials target the same interval
    # twice.  Setting a degree here builds ONE polynomial of that degree
    # (with coarse_cheb_lower, defaulting to cheb_lower) for the coarse
    # phase instead: a deg-8 single sweep beats deg-6 x 2 on the interval
    # it actually needs, in 2/3 the operator applications.
    coarse_cheb_degree: int | None = None
    coarse_cheb_lower: float | None = None
    # coarse-level operator construction: "geometric" re-derives each level
    # from rescaled element integrals (reference parity,
    # transport_tri_semi.F90:319-379); "galerkin" forms the variational
    # P^T A P triple product on the block stencil (ops/galerkin.py) — equal
    # to geometric for scale-invariant physics, variationally consistent
    # for the SIP surface terms.
    coarse_operator: str = "geometric"
    # residual restriction: "linear" is the variational P^T transfer (exact
    # for the nested P1 spaces); "corner_average" reproduces the
    # reference's restrictor (splitting.F90:10-32 — coarse node k takes the
    # mean of the residual over the corner child at that node), which is
    # only stable for its active block-diagonal (surface_terms=False)
    # operator.
    restrictor: str = "linear"
    physics: Physics = dataclasses.field(default_factory=Physics)
    # manufactured solution: Dirichlet/source/analytical sin(x+y)
    # (splitting.F90:1401-1405, transport_tri_semi.F90:593)
    manufactured: bool = True
    fns: ProblemFns = dataclasses.field(default_factory=ProblemFns)
    dtype: str = "float32"
    # sanitizer mode (utils/debugging.py): instrument the jitted step with
    # checkify float + index checks — the device-side -fbounds-check
    # (reference Makefile:8).  NaN/Inf generation or an out-of-bounds
    # gather raises instead of propagating.  Debug-only: slower.
    debug: bool = False


@dataclasses.dataclass
class RectConfig:
    """Structured rectangular DG advection (mode 1, transport_rect.F90)."""
    no_ele_row: int = 200
    no_ele_col: int = 1
    x_length: float = 100.0
    y_length: float = 100.0
    cfl: float = 0.7
    time: float = 250.0
    nits: int = 2                  # nonlinearity iterations
    njac_its: int = 10
    u: tuple[float, float] = (2 * 0.01428571, 0.0)
    direct_solver: bool = False
    dtype: str = "float32"


@dataclasses.dataclass
class TransportConfig:
    """Triangular-mesh DG transport (modes 2-6)."""
    cfl: float = 0.7
    ntime: int = 2
    dt: float | None = None        # defaults to cfl*dx
    dx: float = 0.1
    nits: int = 2
    njac_its: int = 10
    theta: float = 0.5
    u: tuple[float, float] = (0.1, 0.0)
    k: float = 0.0                 # diffusion coefficient (mode 6: 1.0)
    diffusion: bool = False
    implicit: bool = False
    direct_solver: bool = False
    # Rannacher startup: take the first two implicit steps with theta=1
    # before switching to the configured theta.  Crank-Nicolson (theta=0.5)
    # is not L-stable, so an initial-data/BC discontinuity rings forever at
    # the boundary without it.
    rannacher: bool = True
    dtype: str = "float32"
