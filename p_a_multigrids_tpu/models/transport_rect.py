"""Structured rectangular DG advection (the reference's mode 1).

Re-design of ``trans_rec`` (/root/reference/transport_rect.F90:7-379):
bilinear-quad DG with upwind face fluxes and per-element mass solves,
validated against the translated-box analytical solution (:100-111).

Structure: the reference recomputes quad Jacobians, face geometry and the
upwind switch per element per face inside its triple time/nonlinearity/
element loop (:122-312).  Here geometry is computed once for the whole mesh
(it is static), neighbors are static index arrays, and one time step is a
handful of batched einsums under jit.  The element mass solve uses the
exact precomputed 4x4 inverse (the reference offers Gauss-Jordan FINDInv
per element, :280, or element-Jacobi sweeps, :293-309 — kept as an option).

NOTE the reference's volume advection term contracts against an
uninitialized `tnew_gi` buffer (the filling statement :158 is commented
out), so only its flux terms actually advect; we implement the complete DG
volume + flux form.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RectConfig
from ..mesh import geometry, structured
from ..utils import shape_functions
from ..validation import analytical as va

# my face f's two nodes match the neighbor's nodes NEIGH_PERM[f] (same
# physical corners; faces are 0=bottom, 1=right, 2=top, 3=left)
NEIGH_PERM = np.asarray([[2, 3], [0, 2], [1, 0], [3, 1]], np.int32)
OPP_FACE = np.asarray([2, 3, 0, 1], np.int32)


@dataclasses.dataclass
class RectProblem:
    cfg: RectConfig
    x_all: np.ndarray          # (E, 2, 4)
    face_ele: np.ndarray       # (E, 4)
    tables: dict               # device arrays


def build_problem(cfg: RectConfig) -> RectProblem:
    dtype = jnp.dtype(cfg.dtype)
    dx = cfg.x_length / cfg.no_ele_row
    dy = cfg.y_length / cfg.no_ele_col
    x_all, face_ele = structured.rect_mesh(cfg.no_ele_row, cfg.no_ele_col,
                                           dx, dy)
    n, nlx, w, ft = shape_functions.quad_bilinear(2)
    detwei, nx, _ = geometry.quad_det_nlx(
        jnp.asarray(x_all), jnp.asarray(nlx), jnp.asarray(w))

    E = x_all.shape[0]
    fn = ft["face_nodes"]
    sngi = 2
    sn1d, snlx1d, sw1d = shape_functions.edge_p1(sngi)
    centroid = x_all.mean(axis=2)
    sdet = np.zeros((E, 4, sngi))
    snorm = np.zeros((E, 4, sngi, 2))
    for f in range(4):
        a, b = fn[f]
        xsl = x_all[:, :, [a, b]]
        approx = xsl.mean(axis=2) - centroid
        sd, sn_ = geometry.det_snlx(jnp.asarray(xsl), jnp.asarray(snlx1d),
                                    jnp.asarray(sw1d), jnp.asarray(approx))
        sdet[:, f] = np.asarray(sd)
        snorm[:, f] = np.asarray(sn_)

    from ..ops import local_matrices as lm
    mass = lm.mass(n, np.asarray(detwei))
    minv = np.linalg.inv(mass)        # FINDInv replacement (batched, setup)
    ml = lm.lumped_mass(n, np.asarray(detwei))

    tables = dict(
        n=jnp.asarray(n, dtype),
        nx=jnp.asarray(nx, dtype),
        detwei=jnp.asarray(detwei, dtype),
        face_sn=jnp.asarray(ft["face_sn"], dtype),
        sn1d=jnp.asarray(sn1d, dtype),
        sdet=jnp.asarray(sdet, dtype),
        snorm=jnp.asarray(snorm, dtype),
        mass=jnp.asarray(mass, dtype),
        minv=jnp.asarray(minv, dtype),
        ml=jnp.asarray(ml, dtype),
        face_ele=jnp.asarray(face_ele),
        neigh_perm=jnp.asarray(NEIGH_PERM),
        u=jnp.asarray(np.asarray(cfg.u), dtype),
    )
    return RectProblem(cfg=cfg, x_all=x_all, face_ele=face_ele,
                       tables=tables)


def _rhs(tb: dict, T: jax.Array) -> jax.Array:
    """Volume advection + upwind face flux residual (E, 4)."""
    u = tb["u"]
    # velocity at volume quadrature points is constant; t at gi:
    t_gi = jnp.einsum("gi,ei->eg", tb["n"], T)
    rhs = jnp.einsum("egdi,d,eg,eg->ei", tb["nx"], u, t_gi, tb["detwei"])

    # neighbor values at my face nodes
    E = T.shape[0]
    safe = jnp.maximum(tb["face_ele"], 0)                # (E, 4)
    Tn = T[safe]                                         # (E, 4, 4nodes)
    T2 = jnp.take_along_axis(
        Tn, jnp.broadcast_to(tb["neigh_perm"][None], (E, 4, 2)), axis=-1)
    # boundary: t_bc = 0 (transport_rect.F90:79)
    T2 = jnp.where((tb["face_ele"] >= 0)[..., None], T2, 0.0)

    t_sgi = jnp.einsum("fgi,ei->efg", tb["face_sn"], T)
    t2_sgi = jnp.einsum("gk,efk->efg", tb["sn1d"], T2)
    un = jnp.einsum("efgd,d->efg", tb["snorm"], u)       # u constant both sides
    income = 0.5 + 0.5 * jnp.sign(-un)
    s_cont = un * tb["sdet"] * ((1.0 - income) * t_sgi + income * t2_sgi)
    rhs = rhs - jnp.einsum("fgi,efg->ei", tb["face_sn"], s_cont)
    return rhs


def make_step(problem: RectProblem):
    cfg = problem.cfg
    tb = problem.tables
    dx = cfg.x_length / cfg.no_ele_row
    dt = cfg.cfl * dx

    def step(T):
        told = T
        mass_told = jnp.einsum("eij,ej->ei", tb["mass"], told)
        for _ in range(cfg.nits):                        # nonlinearity loop
            rhs = _rhs(tb, T)
            b = mass_told + dt * rhs
            if cfg.direct_solver:
                T = jnp.einsum("eij,ej->ei", tb["minv"], b)
            else:                                        # element Jacobi
                x = T
                for _ in range(cfg.njac_its):
                    mx = jnp.einsum("eij,ej->ei", tb["mass"], x)
                    x = x + (b - mx) / tb["ml"]
                T = x
        return T

    return jax.jit(step), dt


def solve(cfg: RectConfig | None = None):
    """Run the moving-box advection problem; returns (problem, T, dt,
    nsteps)."""
    cfg = cfg or RectConfig()
    problem = build_problem(cfg)
    step, dt = make_step(problem)
    ntime = int(cfg.time / dt)

    # 1-D box initial condition (transport_rect.F90:82-83)
    E = problem.x_all.shape[0]
    T0 = np.zeros((E, 4))
    lo = cfg.no_ele_row // 5
    hi = cfg.no_ele_row // 2
    T0[lo - 1:hi, :] = 1.0
    T = jnp.asarray(T0, problem.tables["n"].dtype)
    for _ in range(ntime):
        T = step(T)
    return problem, T, dt, ntime


def analytical_comparison(problem: RectProblem, dt: float, ntime: int):
    """Translated-box reference values at the element nodes
    (transport_rect.F90:100-111)."""
    cfg = problem.cfg
    dx = cfg.x_length / cfg.no_ele_row
    x0 = (cfg.no_ele_row // 5 - 1) * dx
    x1 = (cfg.no_ele_row // 2) * dx
    xs = problem.x_all[:, 0, :]
    return va.moving_box(xs, dt * ntime, cfg.u[0], x0, x1, cfg.x_length)
