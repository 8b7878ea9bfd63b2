"""Semi-structured geometric-multigrid transport solver — the flagship.

Covers the reference's modes 7-10 (/root/reference/transport_tri_semi.F90):
theta-implicit advection-diffusion on an unstructured macro mesh whose every
triangle is split into 4**n_split children, smoothed with damped
Jacobi/colored-GS/Richardson and accelerated by a geometric V-cycle over the
nested hierarchy.

Structure (not a port):

- state is a dense tensor ``T[u, c, nloc]``; all child topology/geometry is
  closed-form (mesh.splitting), so the smoother is a handful of batched
  einsums + one neighbor gather — no per-element loops, no index math on
  device (the reference recomputes get_str_info/get_splitting inside its
  innermost loop, transport_tri_semi.F90:565-568);
- per-macro element stencils (mass/advection/diffusion) are assembled once
  per level at setup (the reference rebuilds them every smoothing sweep,
  :562) and children reuse them via the exact 4**-s / 2**s scalings
  (ShapFun.F90:1654-1682);
- surface coupling (upwind flux + interior-penalty diffusion) uses the flat
  neighbor tables of mesh.semi; the reference's active mode 9 has these
  terms disabled (:619-688 commented out) — ``Physics.surface_terms=False``
  reproduces that, True enables the full DG operator;
- the V-cycle is a standard correction scheme with linear-interpolation
  prolongation and corner-child averaging restriction (the reference's
  restrictor, splitting.F90:10-32; its prolongator :38-91 mixes state into
  the correction — deliberately not reproduced, see SURVEY.md section 7
  "hard parts").
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np

from ..config import Physics, SemiConfig, Solver
from ..mesh import geometry, semi, splitting
from ..mesh.topology import MacroMesh
from ..utils import shape_functions


def manufactured_solution(x, y):
    """boundary(x,y) = sin(x+y) (splitting.F90:1401-1405)."""
    return np.sin(x + y)


def manufactured_source(x, y, k):
    """+2k sin(x+y) = -k*laplace(sin(x+y)).

    The reference writes the source as -2k*sin (transport_tri_semi.F90:593),
    but with its own +diff_vol operator sign (:444) that choice is
    inconsistent with the strong form; in the active mode-9 configuration the
    surface terms are disabled so the discrepancy was invisible.  We use the
    sign for which the full DG operator converges to the manufactured
    solution (verified by tests/test_semi.py).
    """
    return 2.0 * k * manufactured_solution(x, y)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SemiProblem:
    grid: semi.SemiGrid
    cfg: SemiConfig
    levels: list[dict]          # device arrays per level (0 = finest)
    coords_fine: np.ndarray     # (U, C, 2, 3) finest child node coords
    analytical: jax.Array       # (U, C, 3)

    @property
    def num_macro(self):
        return self.grid.num_macro


def _face_geometry(mesh: MacroMesh, ngi: int, sngi: int):
    """Macro-element geometry in the *child-face* convention.

    Returns numpy arrays:
      detwei0 (U, ngi), nx0 (U, ngi, 2, 3),
      sdet0 (U, 3, sngi)  edge |J|*w for child-convention faces,
      snorm0 (U, 3, sngi, 2) outward unit normals (for an up child).
    """
    # pure NumPy: setup-time work must not pay XLA compiles
    n, nlx, w = shape_functions.tri_p1(ngi)
    jac = np.einsum("gal,ubl->ugab", nlx, mesh.X)
    detj = jac[..., 0, 0] * jac[..., 1, 1] - jac[..., 0, 1] * jac[..., 1, 0]
    detwei0 = 0.5 * np.abs(detj) * w                     # (U, ngi)
    inv = np.empty_like(jac)
    inv[..., 0, 0] = jac[..., 1, 1]
    inv[..., 0, 1] = -jac[..., 0, 1]
    inv[..., 1, 0] = -jac[..., 1, 0]
    inv[..., 1, 1] = jac[..., 0, 0]
    inv /= detj[..., None, None]
    nx0 = np.einsum("ugab,gbl->ugal", inv, nlx)          # (U, ngi, 2, 3)

    sn, snlx, sw = shape_functions.edge_p1(sngi)
    U = mesh.num_elements
    centroid = mesh.X.mean(axis=2)                       # (U, 2)
    sdet0 = np.zeros((U, 3, sngi))
    snorm0 = np.zeros((U, 3, sngi, 2))
    for f in range(3):
        a, b = splitting.CHILD_FACE_NODES[f]
        xsl = mesh.X[:, :, [a, b]]                       # (U, 2, 2)
        t = np.einsum("gl,ubl->ugb", snlx[:, 0, :], xsl)
        tnorm = np.linalg.norm(t, axis=-1)               # (U, sngi)
        sdet0[:, f] = tnorm * sw
        nrm = np.stack([t[..., 1], -t[..., 0]], axis=-1) / tnorm[..., None]
        approx = xsl.mean(axis=2) - centroid             # (U, 2)
        sign = np.sign(np.sum(nrm * approx[:, None, :], axis=-1))
        sign[sign == 0] = 1.0
        snorm0[:, f] = nrm * sign[..., None]
    return detwei0, nx0, sdet0, snorm0


def _penalty_dx(mesh: MacroMesh, lvl: semi.SemiLevel) -> np.ndarray:
    """Center-to-center distances for the k/dx penalty, per (u, c, face).

    Three cases (matrices.F90:100-110 add_diffusion_surf):
      intra-macro neighbor : child-centroid distance
      cross-macro neighbor : macro centroid distance / 2**s
      domain boundary      : (macro centroid to face midpoint) / 2**s
    """
    U = mesh.num_elements
    n = lvl.n
    C = 4 ** n
    coords = splitting.child_coords(mesh.X, n)           # (U, C, 2, 3)
    cent = coords.mean(axis=3)                           # (U, C, 2)
    cent_flat = cent.reshape(U * C, 2)
    neigh = lvl.neigh_elem                               # (U, C, 3)
    safe = np.maximum(neigh, 0)
    d_child = np.linalg.norm(
        cent[:, :, None, :] - cent_flat[safe], axis=-1)  # (U, C, 3)

    macro_cent = mesh.X.mean(axis=2)                     # (U, 2)
    # cross-macro: which macro face does child-face f touch
    cf2mf = splitting.CHILD2MACRO_FACE
    d_macro = np.zeros((U, 3))
    for mf in range(3):
        v = mesh.neig[:, mf]
        safe_v = np.maximum(v, 0)
        dd = np.linalg.norm(macro_cent - macro_cent[safe_v], axis=-1)
        a, b = splitting.MACRO_FACE_NODES[mf]
        mid = 0.5 * (mesh.X[:, :, a] + mesh.X[:, :, b])
        d_bnd = np.linalg.norm(macro_cent - mid, axis=-1)
        d_macro[:, mf] = np.where(v >= 0, dd, d_bnd) / (2 ** n)

    # classify each (u, c, f)
    intra = np.broadcast_to(
        (splitting.child_neighbors(n) >= 0)[None], (U, C, 3))
    dx = np.where(intra, d_child, d_macro[:, None, :][:, :, cf2mf])
    return np.maximum(dx, 1e-300)


def _penalty_face_over_area(mesh: MacroMesh, lvl: semi.SemiLevel,
                            sdet0: np.ndarray) -> np.ndarray:
    """Shape-robust SIP penalty scale: max over the two incident elements of
    |F| / |E| at child scale -> (U, C, 3).

    The reference's centroid-distance 1/dx (add_diffusion_surf,
    matrices.F90:100-110) under-penalizes stretched triangles, leaving the
    SIP operator indefinite at moderate eta; |F|/|E| adapts to anisotropy
    (standard SIP analysis).  Symmetric across each face by construction.
    """
    U = mesh.num_elements
    n = lvl.n
    C = 4 ** n
    area_macro = np.abs(geometry.tri_area(mesh.X))        # (U,)
    child_area = area_macro / (4.0 ** n)                  # (U,)
    face_len = sdet0.sum(axis=2) / (2.0 ** n)             # (U, 3) child scale
    my_ratio = face_len[:, None, :] / child_area[:, None, None]  # (U, 1, 3)
    my_ratio = np.broadcast_to(my_ratio, (U, C, 3)).copy()
    # neighbor's ratio: same face length, neighbor's child area
    neigh_u = np.maximum(lvl.neigh_elem, 0) // C          # (U, C, 3)
    nb_ratio = face_len[:, None, :] / child_area[neigh_u]
    nb_ratio = np.where(lvl.neigh_elem >= 0, nb_ratio, my_ratio)
    return np.maximum(my_ratio, nb_ratio)


def build_problem(mesh: MacroMesh, cfg: SemiConfig) -> SemiProblem:
    grid = semi.build_grid(mesh, cfg.n_split, cfg.multi_levels)
    dtype = jnp.dtype(cfg.dtype)
    ngi, sngi = 3, 2
    n_tab, nlx, w = shape_functions.tri_p1(ngi)
    sn_tab, _, sw = shape_functions.edge_p1(sngi)
    ft = shape_functions.tri_face_tables(ngi, sngi)
    detwei0, nx0, sdet0, snorm0 = _face_geometry(mesh, ngi, sngi)
    U = mesh.num_elements
    k = cfg.physics.k
    u_vec = np.asarray(cfg.physics.u)

    # macro-scale stencils (children reuse via scalings)
    from ..ops import local_matrices as lm
    M0 = lm.mass(n_tab, detwei0)
    ml0 = lm.lumped_mass(n_tab, detwei0)
    D0 = lm.diffusion_volume(nx0, detwei0, k)
    K0 = lm.advection_stiffness(
        n_tab, nx0, detwei0,
        np.broadcast_to(u_vec, detwei0.shape + (2,)))

    levels = []
    for i, lvl in enumerate(grid.levels):
        s = lvl.n
        C = 4 ** s
        scale_m = 1.0 / 4.0 ** s
        scale_k = 1.0 / 2.0 ** s
        if cfg.physics.sip_consistency:
            inv_dx = _penalty_face_over_area(mesh, lvl, sdet0)
            # Galerkin matching: a coarse function prolonged to the fine grid
            # is penalized with the FINE |F|/|E| coefficient on its (coarse-
            # face) jumps, which is 2**i times the coarse level's own ratio.
            # Using the geometric (unscaled) coarse penalty under-penalizes
            # the coarse operator and stalls the V-cycle.
            inv_dx = inv_dx * (2.0 ** i)
        else:
            inv_dx = 1.0 / _penalty_dx(mesh, lvl)
        # Dirichlet ghost endpoint values at boundary faces (finest level
        # only; coarse correction equations use homogeneous ghosts)
        bc_fn = cfg.fns.bc
        if bc_fn is None and cfg.manufactured:
            bc_fn = manufactured_solution
        bc_vals = np.zeros((len(lvl.bc_elem), 2))
        if bc_fn is not None and i == 0 and len(lvl.bc_elem):
            bc_vals = np.broadcast_to(np.asarray(
                bc_fn(lvl.bc_coords[:, :, 0], lvl.bc_coords[:, :, 1]),
                np.float64), (len(lvl.bc_elem), 2))
        # per-face BC type: diffusive surface terms are switched off on
        # no-flux faces; advective flux there uses the interior trace
        neu_mask = np.zeros((U, C, 3), bool)
        if cfg.fns.neumann is not None and len(lvl.bc_elem):
            mid = lvl.bc_coords.mean(axis=1)             # (nb, 2)
            is_neu = np.asarray(cfg.fns.neumann(mid[:, 0], mid[:, 1]), bool)
            flat = np.zeros((U * C, 3), bool)
            flat[lvl.bc_elem, lvl.bc_face] = is_neu
            neu_mask = flat.reshape(U, C, 3)
        diff_on = np.where(neu_mask, 0.0, 1.0)
        bc_dense = np.zeros((U * C, 3, 2))
        if len(lvl.bc_elem):
            bc_dense[lvl.bc_elem, lvl.bc_face] = bc_vals
        bc_dense = bc_dense.reshape(U, C, 3, 2)
        # host-side numpy mirrors of every table, pre-cast to the run dtype:
        # all setup-time consumers (analytic stencil build, halo planning,
        # fused-operator construction) read these instead of copying device
        # arrays back or paying dtype-conversion compiles.
        raw = dict(
            n=np.asarray(n_tab, dtype),
            sn=np.asarray(sn_tab, dtype),
            face_sn=np.asarray(ft["face_sn"], dtype),
            M=np.asarray(M0 * scale_m, dtype),
            ml=np.asarray(ml0 * scale_m, dtype),
            D=np.asarray(D0, dtype),
            K=np.asarray(K0 * scale_k, dtype),
            nx1=np.asarray(nx0[:, 0], dtype),    # (U, 2, nloc) P1 gradients

            sdet=np.asarray(sdet0 * scale_k, dtype),
            snorm=np.asarray(snorm0, dtype),
            updown=np.asarray(lvl.updown, dtype),
            neigh_elem=np.asarray(lvl.neigh_elem),
            neigh_perm=np.asarray(lvl.neigh_perm),
            bc_elem=np.asarray(lvl.bc_elem),
            bc_face=np.asarray(lvl.bc_face),
            bc_vals=np.asarray(bc_vals, dtype),
            bc_dense=np.asarray(bc_dense, dtype),
            inv_dx=np.asarray(inv_dx, dtype),
            neu_mask=np.asarray(neu_mask),
            diff_on=np.asarray(diff_on, dtype),
        )
        L = dict(jax.device_put(raw))
        L.update(C=C, s=s)
        # structured-gather tables: the intra-macro child adjacency is one
        # small static index set shared by every macro element, so the
        # neighbor gather decomposes into a tiny static gather plus a
        # boundary-strip gather (O(2**s) per macro) — far cheaper than one
        # random gather over all U*C*3 faces.
        cn = splitting.child_neighbors(s)                # (C, 3)
        intra_idx = np.where(cn >= 0, cn, np.arange(C)[:, None])
        bnd_c, bnd_f = np.nonzero(cn < 0)
        nb = len(bnd_c)
        slot_of = np.zeros((C, 3), np.int64)
        slot_of[bnd_c, bnd_f] = np.arange(nb)
        self_flat = (np.arange(U)[:, None] * C + bnd_c[None, :])
        halo_src = np.asarray(lvl.neigh_elem)[:, bnd_c, bnd_f]
        halo_src = np.where(halo_src >= 0, halo_src, self_flat)
        extra = dict(
            intra_idx=np.asarray(intra_idx),
            intra_mask=np.asarray(cn >= 0),
            slot_of=np.asarray(slot_of),
            halo_src=np.asarray(halo_src),
        )
        raw.update(extra)
        L.update(jax.device_put(extra))
        L["_np"] = raw
        levels.append(L)

    coords_fine = splitting.child_coords(mesh.X, cfg.n_split)
    xf, yf = coords_fine[:, :, 0], coords_fine[:, :, 1]
    src_fn = cfg.fns.source
    ana_fn = cfg.fns.analytical
    if cfg.manufactured:
        src_fn = src_fn or (lambda x, y: manufactured_source(x, y, k))
        ana_fn = ana_fn or manufactured_solution
    # broadcast_to: constant expressions (e.g. --source "0") evaluate to
    # scalars, which must still fill the field
    src = (np.broadcast_to(np.asarray(src_fn(xf, yf), np.float64),
                           xf.shape) if src_fn else np.zeros(xf.shape))
    ana = (np.broadcast_to(np.asarray(ana_fn(xf, yf), np.float64),
                           xf.shape) if ana_fn else np.zeros(xf.shape))
    levels[0]["_np"]["source"] = np.asarray(src, dtype)
    levels[0]["source"] = jnp.asarray(levels[0]["_np"]["source"])

    return SemiProblem(grid=grid, cfg=cfg, levels=levels,
                       coords_fine=coords_fine,
                       analytical=jnp.asarray(ana, dtype))


# ---------------------------------------------------------------------------
# operator
# ---------------------------------------------------------------------------


def flat_gather(L: dict, X: jax.Array) -> jax.Array:
    """Gather per-element data from across each face.

    X (U, C, D) -> (U, C, 3, D): entry [u, c, f] is X of the element across
    face f, or X of (u, c) itself on domain-boundary faces.  This is the
    single-device implementation; the distributed solver substitutes a
    shard_map/halo version with the same contract
    (p_a_multigrids_tpu.parallel.halo).
    """
    U, C = X.shape[:2]
    flat = X.reshape(U * C, *X.shape[2:])
    self_flat = jnp.arange(U * C).reshape(U, C, 1)
    safe = jnp.where(L["neigh_elem"] >= 0, L["neigh_elem"], self_flat)
    return flat[safe]


def structured_gather(L: dict, X: jax.Array) -> jax.Array:
    """flat_gather with the semi-structured decomposition.

    Intra-macro faces use the shared static child table (one gather with
    C*3 indices, independent of U); only the 3*2**s boundary-strip faces
    per macro need the cross-macro gather.  Identical results to
    flat_gather; much cheaper to lower.
    """
    U, C = X.shape[:2]
    trail = X.shape[2:]
    intra = X[:, L["intra_idx"]]                         # (U, C, 3, ...)
    flat = X.reshape(U * C, *trail)
    halo = flat[L["halo_src"]]                           # (U, nb, ...)
    cross = halo[:, L["slot_of"]]                        # (U, C, 3, ...)
    mask = L["intra_mask"].reshape((1, C, 3) + (1,) * len(trail))
    return jnp.where(mask, intra, cross)


def neighbor_trace(L: dict, T: jax.Array, with_bc: bool,
                   gather=flat_gather) -> jax.Array:
    """Neighbor DOF values at my two face nodes.

    Returns T2 (U, C, 3, 2): for each face f, the neighbor's values at the
    physical positions of my face nodes (a, b).  Domain-boundary faces get
    the Dirichlet ghost values (or zero for correction equations).

    This is the pure-functional replacement of update_overlaps
    (splitting.F90:1210-1398) + get_semi_sn2_implicit
    (ShapFun_unstruc.F90:282-300): one gather with a static permutation.
    """
    U, C, _ = T.shape
    Tn = gather(L, T)                                    # (U, C, 3, nloc)
    T2 = jnp.take_along_axis(Tn, L["neigh_perm"], axis=-1)  # (U, C, 3, 2)
    interior = (L["neigh_elem"] >= 0)[..., None]
    bc = (L["bc_dense"] if with_bc
          else jnp.zeros_like(L["bc_dense"]))            # (U, C, 3, 2)
    # no-flux faces mirror the interior trace (zero jump)
    own = T[:, :, jnp.asarray(splitting.CHILD_FACE_NODES)]   # (U, C, 3, 2)
    bc = jnp.where(L["neu_mask"][..., None], own, bc.astype(T.dtype))
    return jnp.where(interior, T2, bc)


def apply_spatial(L: dict, phys: Physics, T: jax.Array,
                  with_bc: bool, gather=flat_gather) -> jax.Array:
    """L(T): diffusion volume - advection stiffness + surface terms.

    Matches A_x minus the mass terms (transport_tri_semi.F90:443-447):
      L = -updown*K + D + flux + diff_surf
    """
    out = jnp.zeros_like(T)
    if phys.diffusion:
        out = out + jnp.einsum("uij,ucj->uci", L["D"], T)
    if phys.advection:
        Kt = jnp.einsum("uij,ucj->uci", L["K"], T)
        out = out - L["updown"][None, :, None] * Kt
    if phys.surface_terms:
        T2 = neighbor_trace(L, T, with_bc, gather)       # (U, C, 3, 2)
        # traces at surface quadrature points
        t_sgi = jnp.einsum("fgi,uci->ucfg", L["face_sn"], T)
        t2_sgi = jnp.einsum("gk,ucfk->ucfg", L["sn"], T2)
        sdet = L["sdet"][:, None]                        # (U, 1, 3, sngi)
        # outward normals of each child: updown flips the macro-edge normal
        snorm = L["snorm"][:, None] * L["updown"][None, :, None, None, None]
        if phys.diffusion:
            k = jnp.asarray(phys.k, T.dtype)
            # diffusive surface terms are disabled on no-flux faces (the
            # advective flux below keeps the plain sdet)
            sdet_d = sdet * L["diff_on"][..., None]
            jump = (t_sgi - t2_sgi) * sdet_d             # (U, C, 3, sngi)
            # penalty: eta (k/dx) sum_sg face_sn_i (t - t2) sdetwei
            pen = jnp.einsum("fgi,ucf,ucfg->uci", L["face_sn"],
                             phys.penalty_factor * k * L["inv_dx"], jump)
            out = out + pen
            if phys.sip_consistency:
                # piecewise-constant P1 gradients of every element, then the
                # neighbor's gradient by gather (one-sided at the boundary)
                nxc = (L["nx1"][:, None] * (2.0 ** L["s"])
                       * L["updown"][None, :, None, None])  # (U, C, 2, nloc)
                G = jnp.einsum("ucdl,ucl->ucd", nxc, T)     # (U, C, 2)
                boundary = L["neigh_elem"] < 0               # (U, C, 3)
                G2 = gather(L, G)                            # (U, C, 3, 2)
                gavg_n = 0.5 * jnp.einsum(
                    "ucfd,ucfgd->ucfg", G[:, :, None] + G2, snorm)
                # consistency: -sum_sg face_sn_i k {grad t . n} sdet
                out = out - k * jnp.einsum("fgi,ucfg->uci", L["face_sn"],
                                           gavg_n * sdet_d)
                # symmetry: -w k (grad N_i . n) sum_sg (t - t2) sdet with
                # w = 1/2 on interior faces ({grad N_i} average) and w = 1 on
                # boundary faces (Nitsche: the test function lives on one
                # side only) — matching the consistency term's weights.
                w_face = jnp.where(boundary, 1.0, 0.5).astype(T.dtype)
                nxn = jnp.einsum("ucdi,ucfgd->ucfgi", nxc, snorm)
                out = out - k * jnp.einsum("ucf,ucfgi,ucfg->uci", w_face,
                                           nxn, jump)
        if phys.advection:
            u_const = jnp.asarray(np.asarray(phys.u), T.dtype)
            un = jnp.einsum("ucfgd,d->ucfg", snorm, u_const)
            income = 0.5 + 0.5 * jnp.sign(-un)
            s_cont = un * sdet * ((1.0 - income) * t_sgi + income * t2_sgi)
            out = out + jnp.einsum("fgi,ucfg->uci", L["face_sn"], s_cont)
    return out


def apply_A(L: dict, phys: Physics, dt: float, theta: float, T: jax.Array,
            with_bc: bool, gather=flat_gather) -> jax.Array:
    """A(T) = M T / dt + theta * L(T)  (transport_tri_semi.F90:443-447)."""
    Mt = jnp.einsum("uij,ucj->uci", L["M"], T) / dt
    return Mt + theta * apply_spatial(L, phys, T, with_bc, gather)


def diag_blocks_A(L: dict, phys: Physics, dt: float, theta: float
                  ) -> jax.Array:
    """Exact per-element diagonal blocks of A -> (U, C, nloc, nloc).

    Includes every self-coupling: mass/dt, volume diffusion/advection, and
    the element's own side of the SIP surface terms (penalty + consistency +
    symmetry).  Used by the block-Jacobi smoother — exact 3x3 solves give a
    far stronger smoother than the reference's lumped-diagonal point
    relaxation (get_diagonal, transport_tri_semi.F90:481-486), which loses
    stability on stretched meshes.
    """
    U = L["M"].shape[0]
    C = L["updown"].shape[0]
    dtype = L["M"].dtype
    A = jnp.broadcast_to(L["M"][:, None] / dt, (U, C, 3, 3)).astype(dtype)
    ud = L["updown"][None, :, None, None]
    if phys.diffusion:
        A = A + theta * L["D"][:, None]
    if phys.advection:
        A = A - theta * ud * L["K"][:, None]
    if phys.surface_terms and phys.diffusion:
        k = jnp.asarray(phys.k, dtype)
        S0 = jnp.einsum("fgi,fgj,ufg->ufij", L["face_sn"], L["face_sn"],
                        L["sdet"])
        A = A + (theta * phys.penalty_factor * k
                 * jnp.einsum("ucf,ufij->ucij",
                              L["inv_dx"] * L["diff_on"], S0))
        if phys.sip_consistency:
            nxc = (L["nx1"][:, None] * (2.0 ** L["s"])
                   * L["updown"][None, :, None, None])
            snorm = (L["snorm"][:, None]
                     * L["updown"][None, :, None, None, None])
            nn = jnp.einsum("ucfgd,ucdj->ucfgj", snorm, nxc)
            w_face = (jnp.where(L["neigh_elem"] < 0, 1.0, 0.5).astype(dtype)
                      * L["diff_on"])
            cons = jnp.einsum("fgi,ufg,ucfgj,ucf->ucij", L["face_sn"],
                              L["sdet"], nn, w_face)
            A = A - theta * k * (cons + jnp.swapaxes(cons, -1, -2))
    if phys.surface_terms and phys.advection:
        snorm = L["snorm"][:, None] * L["updown"][None, :, None, None, None]
        u_const = jnp.asarray(np.asarray(phys.u), dtype)
        un = jnp.einsum("ucfgd,d->ucfg", snorm, u_const)
        income = 0.5 + 0.5 * jnp.sign(-un)
        sdet = jnp.broadcast_to(L["sdet"][:, None], un.shape)
        # my-side upwind flux: + sum_f,g face_sn_i un sdet (1-income) face_sn_j
        A = A + theta * jnp.einsum("fgi,ucfg,fgj->ucij", L["face_sn"],
                                   un * sdet * (1.0 - income), L["face_sn"])
    return A


def diag_A(L: dict, phys: Physics, dt: float, theta: float) -> jax.Array:
    """Approximate diagonal for point relaxation (get_diagonal, :481-486):
    lumped mass / dt + theta * (diag(D) + penalty diagonal)."""
    U = L["M"].shape[0]
    C = L["updown"].shape[0]
    d = jnp.broadcast_to(L["ml"][:, None] / dt, (U, C, 3)).astype(L["M"].dtype)
    if phys.diffusion:
        d = d + theta * jnp.diagonal(L["D"], axis1=-2, axis2=-1)[:, None]
    if phys.surface_terms and phys.diffusion:
        pen_diag = jnp.einsum("fgi,fgi,ufg->ufi", L["face_sn"], L["face_sn"],
                              L["sdet"])                  # (U, 3faces, nloc)
        d = d + (theta * phys.penalty_factor
                 * jnp.asarray(phys.k, d.dtype)
                 * jnp.einsum("ucf,ufi->uci",
                              L["inv_dx"] * L["diff_on"], pen_diag))
    return d


# ---------------------------------------------------------------------------
# multigrid transfer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _transfer_tables(n_coarse: int):
    """Restriction/prolongation gather tables between split depths
    n_coarse+1 (fine) and n_coarse (coarse).

    Returns:
      fine_of:  (Cc, 4) int32 — children of each coarse element (corner
                children at coarse nodes 0..2, then the central child)
      parent:   (Cf,) int32 — coarse parent of each fine element
      pweights: (Cf, 3, 3) float — prolongation weights: correction at fine
                node l = sum_k pweights[fc, l, k] * e_coarse[parent, k]
                (linear interpolation in the coarse element).
    """
    fine_of = splitting.element_conversion(n_coarse)
    Cc = fine_of.shape[0]
    Cf = 4 ** (n_coarse + 1)
    cv, _ = splitting.child_lattice(n_coarse)
    fv, _ = splitting.child_lattice(n_coarse + 1)
    parent = np.zeros((Cf,), np.int32)
    for cc in range(Cc):
        parent[fine_of[cc]] = cc
    pweights = np.zeros((Cf, 3, 3))
    for fc in range(Cf):
        cc = parent[fc]
        V = cv[cc].astype(float) * 2.0                   # coarse verts, fine units
        A = np.stack([V[0] - V[2], V[1] - V[2]], axis=1)  # (2, 2)
        for l in range(3):
            p = fv[fc, l].astype(float)
            ab = np.linalg.solve(A, p - V[2])
            pweights[fc, l] = [ab[0], ab[1], 1.0 - ab.sum()]
    return fine_of, parent, pweights


def restrict(r_fine: jax.Array, n_coarse: int) -> jax.Array:
    """Coarse RHS: transpose-of-prolongation restriction R = P^T.

    DG residual entries are integrals against basis functions, and the
    coarse P1 space is nested in the fine DG space, so P^T is the
    variationally exact residual transfer: with it the two-level iteration
    contracts for the full surface-coupled operator.  (The reference's
    corner-child averaging, splitting.F90:10-32, is only stable for its
    active block-diagonal operator; see restrict_corner_average.)
    """
    _, parent, pweights = _transfer_tables(n_coarse)
    U, Cf, nloc = r_fine.shape
    Cc = 4 ** n_coarse
    contrib = jnp.einsum("flk,ufl->ufk",
                         jnp.asarray(pweights, r_fine.dtype), r_fine)
    out = jnp.zeros((U, Cc, nloc), r_fine.dtype)
    return out.at[:, jnp.asarray(parent), :].add(contrib)


def restrict_corner_average(r_fine: jax.Array, n_coarse: int) -> jax.Array:
    """The reference's restrictor (splitting.F90:10-32): coarse node k takes
    the mean of the residual over the corner child at that node."""
    fine_of, _, _ = _transfer_tables(n_coarse)
    corners = jnp.asarray(fine_of[:, :3])                # (Cc, 3)
    return r_fine[:, corners, :].mean(axis=-1)           # (U, Cc, 3)


def restrict_corner_average_t(r_fine_t: jax.Array, n_coarse: int
                              ) -> jax.Array:
    """restrict_corner_average in transposed layout: (3, Cf, U)->(3, Cc, U)."""
    fine_of, _, _ = _transfer_tables(n_coarse)
    corners = jnp.asarray(fine_of[:, :3])                # (Cc, 3)
    return jnp.transpose(r_fine_t[:, corners, :].mean(axis=0), (1, 0, 2))


def prolong(e_coarse: jax.Array, n_coarse: int) -> jax.Array:
    """Fine correction by linear interpolation of the coarse correction."""
    _, parent, pweights = _transfer_tables(n_coarse)
    ec = e_coarse[:, jnp.asarray(parent), :]             # (U, Cf, 3)
    return jnp.einsum("clk,uck->ucl",
                      jnp.asarray(pweights, e_coarse.dtype), ec)


def _transfer_tables_t(n_coarse: int):
    """Transposed-layout transfer tables: parent one-hot (Cc, Cf) scatter
    matrix + pweights.  The one-hot turns the 4-children-per-parent
    reduction into a small matmul on (Cf, U) planes — no scatter-add."""
    _, parent, pweights = _transfer_tables(n_coarse)
    Cc, Cf = 4 ** n_coarse, 4 ** (n_coarse + 1)
    parent_oh = np.zeros((Cc, Cf))
    parent_oh[parent, np.arange(Cf)] = 1.0
    return parent_oh, pweights


def restrict_t(r_fine_t: jax.Array, n_coarse: int) -> jax.Array:
    """restrict() in transposed layout: (3, Cf, U) -> (3, Cc, U).

    Everything stays in the transposed layout (wide macro axis minor):
    the nodal mixing is a 3x3 contraction per child plane and the
    child->parent reduction is one (Cc, Cf) one-hot matmul.
    """
    parent_oh, pweights = _transfer_tables_t(n_coarse)
    dt_ = r_fine_t.dtype
    contrib = jnp.einsum("flk,lfu->kfu", jnp.asarray(pweights, dt_),
                         r_fine_t)
    return jnp.einsum("cf,kfu->kcu", jnp.asarray(parent_oh, dt_), contrib)


def pack_x_t(x_t: jax.Array, p: int) -> jax.Array:
    """(3, C, U) -> (3, p*C, U/p) in ops.stencil.pack_stencil order:
    macro u = q*p + j becomes child block j of pack q."""
    _, C, U = x_t.shape
    x = x_t.reshape(3, C, U // p, p)
    return jnp.transpose(x, (0, 3, 1, 2)).reshape(3, p * C, U // p)


def unpack_x_t(x_t: jax.Array, p: int) -> jax.Array:
    """Inverse of pack_x_t: (3, p*C, U/p) -> (3, C, U)."""
    _, Cp_, Un = x_t.shape
    C = Cp_ // p
    x = x_t.reshape(3, p, C, Un)
    return jnp.transpose(x, (0, 2, 3, 1)).reshape(3, C, Un * p)


def prolong_t(e_coarse_t: jax.Array, n_coarse: int) -> jax.Array:
    """prolong() in transposed layout: (3, Cc, U) -> (3, Cf, U)."""
    parent_oh, pweights = _transfer_tables_t(n_coarse)
    dt_ = e_coarse_t.dtype
    ec = jnp.einsum("cf,kcu->kfu", jnp.asarray(parent_oh, dt_), e_coarse_t)
    return jnp.einsum("flk,kfu->lfu", jnp.asarray(pweights, dt_), ec)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


class SemiSolver:
    """Jitted V-cycle transport solver over a SemiProblem."""

    def __init__(self, problem: SemiProblem):
        self.p = problem
        self.cfg = problem.cfg
        cfg = self.cfg
        if cfg.coarse_krylov:
            # inner CG makes the V-cycle a NONLINEAR preconditioner (see
            # config.SemiConfig.coarse_krylov); outer PCG/BiCGStab assume a
            # fixed linear operator, and the coarse CG assumes SPD
            if cfg.krylov:
                raise ValueError(
                    "coarse_krylov=True cannot be combined with krylov=True:"
                    " an inner CG makes the V-cycle preconditioner nonlinear"
                    " across outer Krylov iterations")
            if cfg.physics.advection:
                import warnings
                warnings.warn(
                    "coarse_krylov assumes an SPD coarse operator; advective"
                    " physics may misconverge — prefer stationary coarse"
                    " sweeps here", stacklevel=2)
        self._gather = structured_gather
        dtype = jnp.dtype(cfg.dtype)

        self._stencil = None
        self._pack = [1] * len(problem.levels)
        if (cfg.stencil_operator
                and 4 ** cfg.n_split <= cfg.stencil_max_children):
            from ..ops import fused as _fused
            from ..ops import stencil as _stencil
            self._fmod = _fused
            build = (_stencil.probe_stencil if cfg.stencil_probe
                     else _stencil.build_stencil)
            datas = [build(L, cfg.physics, cfg.dt, cfg.theta)
                     for L in problem.levels]
            if cfg.coarse_operator == "galerkin":
                # variational R A P coarse blocks (static-sparsity SpGEMM)
                # instead of the reference's per-level geometric re-assembly
                from ..ops import galerkin as _galerkin
                for i in range(1, len(datas)):
                    datas[i] = _galerkin.galerkin_coarse(
                        datas[i - 1], problem.levels[i]["s"], datas[i])
            elif cfg.coarse_operator != "geometric":
                raise ValueError(
                    f"unknown coarse_operator {cfg.coarse_operator!r}")
            # macro-packed coarse levels (ops/stencil.pack_stencil): same
            # operator relabeled as U/p macros of p*C children, so a small-C
            # level runs on wider child planes.  Skipped for levels the SA
            # correction or the dense coarse inverse consume (their builders
            # assume the splitting lattice / unpacked flat order).
            self._pack = [1] * len(datas)
            if cfg.coarse_pack > 1:
                pk = cfg.coarse_pack
                nlv = len(datas)
                for li in range(1, nlv):
                    U_l, C_l = datas[li].self_blocks.shape[:2]
                    N_l = U_l * C_l * 3
                    dense_last = (li == nlv - 1
                                  and N_l <= cfg.coarse_direct_max_dof)
                    # mirror of the agg-engagement condition below: the
                    # SA builder assumes the splitting lattice, so the
                    # level it will consume stays unpacked
                    agg_last = (li == nlv - 1 and cfg.coarse_agg
                                and not cfg.coarse_krylov
                                and not dense_last
                                and N_l > cfg.agg_dense_max_dof)
                    if (U_l % pk == 0 and C_l * pk <= 64
                            and not agg_last and not dense_last):
                        datas[li] = _stencil.pack_stencil(datas[li], pk)
                        self._pack[li] = pk
            self._stencil = [_stencil.StencilOperator(d, dtype)
                             for d in datas]

        if (self._stencil is None
                and cfg.solver in (Solver.BLOCK_JACOBI, Solver.CHEBYSHEV)):
            self._block_inv = [
                jnp.linalg.inv(diag_blocks_A(L, cfg.physics,
                                             cfg.dt, cfg.theta))
                for L in problem.levels]
        if cfg.solver == Solver.CHEBYSHEV:
            if self._stencil is not None:
                # numpy power iteration on the probed blocks — no compiles
                self._lam_max = [op.lam_max_estimate()
                                 for op in self._stencil]
            else:
                self._lam_max = [self._estimate_lam_max(li)
                                 for li in range(len(problem.levels))]
        self._fused = None
        if cfg.fast_operator and self._stencil is None:
            from ..ops import fused as _fused
            self._fmod = _fused
            self._fused = [
                _fused.FusedOperator(L, cfg.physics, cfg.dt, cfg.theta)
                for L in problem.levels]
            if hasattr(self, "_block_inv"):
                self._binv_t = [jnp.transpose(B, (2, 3, 1, 0))
                                for B in self._block_inv]
        self._coarse_inv = self._build_coarse_inverse()
        # aggregation hierarchy (ops/agg): in `amg` mode it corrects the
        # FINEST level directly (geometric levels bypassed — the robust
        # choice on anisotropic meshes); otherwise it continues below the
        # geometric coarsest when that is too large for the dense inverse
        self._agg = None
        self._agg_li = None
        if self._stencil is not None:
            from ..ops import agg as _agg
            li = None
            if cfg.amg:
                li = 0
            elif (cfg.coarse_agg and not cfg.coarse_krylov
                    and self._coarse_inv is None
                    and len(problem.levels) > 1):
                li = len(problem.levels) - 1
            if li is not None:
                Lc = problem.levels[li]
                coords = splitting.child_coords(problem.grid.macro.X,
                                                Lc["s"])
                h = _agg.build_hierarchy(
                    self._stencil[li]._data, coords,
                    max_dense_dof=cfg.agg_dense_max_dof,
                    omega=cfg.omega, sweeps=cfg.agg_sweeps, dtype=dtype,
                    strength=cfg.agg_strength, always=cfg.amg,
                    drop_tol=cfg.agg_drop_tol, target=cfg.agg_target)
                if h.levels:
                    self._agg = h
                    self._agg_li = li
                    if h.fine is not None:
                        # (3, E) -> (3, C, U) once, OUTSIDE any trace (a
                        # jnp op during tracing yields a tracer; caching
                        # that on self leaks it into later traces)
                        Uc = Lc["M"].shape[0]
                        Cc = Lc["updown"].shape[0]
                        self._agg_fine_dinv = jnp.swapaxes(
                            h.fine["dinv_t"].reshape(3, Uc, Cc), 1, 2)
        self._coarse_inv_t = None
        if self._coarse_inv is not None and self._stencil is not None:
            # permute the dense inverse into transposed-layout flat order
            # (i, c, u) so the in-cycle coarse solve needs no transposes
            Lc = self.p.levels[-1]
            Uc, Cc = Lc["M"].shape[0], Lc["updown"].shape[0]
            u_, c_, i_ = np.meshgrid(np.arange(Uc), np.arange(Cc),
                                     np.arange(3), indexing="ij")
            # perm[old_flat] = new_flat position of that entry
            old_to_new = (i_ * Cc * Uc + c_ * Uc + u_).reshape(-1)
            perm = np.argsort(old_to_new)
            Ainv = self._coarse_inv_np     # host copy: no device readback
            self._coarse_inv_t = jnp.asarray(Ainv[perm][:, perm],
                                             Ainv.dtype)
        step_fn = self._make_step()
        self._step = jax.jit(step_fn)
        if cfg.debug:
            # sanitizer mode: the same graphs, checkify-instrumented
            # (utils/debugging — the -fbounds-check equivalent)
            from ..utils import debugging
            self._step = debugging.checked(step_fn)
            if self._use_t_cycle:
                self._step_t = debugging.checked(self._step_t_raw)

    def _apply(self, li: int, T, with_bc: bool):
        """Operator application choosing the fastest available path."""
        if self._stencil is not None:
            f = self._fmod
            return f.from_t(self._stencil[li].apply(f.to_t(T), with_bc))
        if self._fused is not None:
            f = self._fmod
            return f.from_t(self._fused[li].apply(f.to_t(T), with_bc))
        L = self.p.levels[li]
        return apply_A(L, self.cfg.physics, self.cfg.dt, self.cfg.theta, T,
                       with_bc, self._gather)

    def _build_coarse_inverse(self):
        """Dense inverse of the coarsest-level operator (if small enough).

        The matrix is extracted by one vmapped application of A to the
        identity and inverted once at setup; the in-cycle coarse solve is
        then a single (N, N) x (N,) matmul — the replacement for the
        reference's FINDInv-based direct solves."""
        cfg = self.cfg
        self._coarse_inv_np = None
        if len(self.p.levels) == 1:
            return None
        L = self.p.levels[-1]
        U = L["M"].shape[0]
        C = L["updown"].shape[0]
        N = U * C * 3
        if N > cfg.coarse_direct_max_dof:
            return None
        if self._stencil is not None:
            from ..ops import stencil as _stencil
            A = _stencil.to_dense(self._stencil[-1]._data)
            self._coarse_inv_np = np.linalg.inv(A).astype(L["M"].dtype)
            return jnp.asarray(self._coarse_inv_np)
        eye = jnp.eye(N, dtype=L["M"].dtype).reshape(N, U, C, 3)
        cols = jax.vmap(
            lambda v: apply_A(L, cfg.physics, cfg.dt, cfg.theta, v,
                              False, self._gather))(eye)
        A = cols.reshape(N, N).T
        return jnp.linalg.inv(A)

    def _estimate_lam_max(self, li: int) -> float:
        """Power iteration on D^-1 A (homogeneous) with 10%% safety."""
        L = self.p.levels[li]
        cfg = self.cfg
        Ainv = self._block_inv[li]
        U, C = L["M"].shape[0], L["updown"].shape[0]
        rng = np.random.default_rng(li)
        v0 = jnp.asarray(rng.normal(size=(U, C, 3)), L["M"].dtype)

        @jax.jit
        def power(v):
            def it(_, v):
                w = jnp.einsum("ucij,ucj->uci", Ainv,
                               apply_A(L, cfg.physics, cfg.dt, cfg.theta, v,
                                       False, self._gather))
                return w / jnp.linalg.norm(w)
            v = jax.lax.fori_loop(0, 30, it, v)
            w = jnp.einsum("ucij,ucj->uci", Ainv,
                           apply_A(L, cfg.physics, cfg.dt, cfg.theta, v,
                                   False, self._gather))
            return jnp.linalg.norm(w)

        # generous safety: Chebyshev amplifies any eigenvalue beyond the
        # interval, so overestimating lam_max is cheap and underestimating
        # is fatal
        return 1.2 * float(power(v0))

    def _coarse_cheb_override(self, li: int) -> bool:
        return (self.cfg.coarse_cheb_degree is not None
                and len(self.p.levels) > 1
                and li == len(self.p.levels) - 1)

    def _cheb_roots(self, li: int):
        from ..ops import smoothers
        cfg = self.cfg
        deg, lower = cfg.cheb_degree, cfg.cheb_lower
        if self._coarse_cheb_override(li):
            deg = cfg.coarse_cheb_degree
            if cfg.coarse_cheb_lower is not None:
                lower = cfg.coarse_cheb_lower
        return smoothers.chebyshev_roots(self._lam_max[li], deg, lower)

    def _cheb_reps(self, li: int, sweeps: int, n_roots: int) -> int:
        """Polynomial repetitions: with a coarse-degree override the
        polynomial IS the coarse solve — exactly one rep regardless of
        coarse_sweeps (the knob that sized the default repetition)."""
        if self._coarse_cheb_override(li):
            return 1
        return max(1, sweeps // n_roots)

    def _smooth_fused_t(self, li: int, xt, bt, sweeps: int, with_bc: bool):
        """Chebyshev/block-Jacobi smoothing entirely in transposed layout:
        no transposes inside the iteration."""
        cfg = self.cfg
        op = self._fused[li]
        Binv = self._binv_t[li]                          # (3, 3, C, U)

        def solve_blocks(rt):
            return jnp.stack([
                Binv[i, 0] * rt[0] + Binv[i, 1] * rt[1] + Binv[i, 2] * rt[2]
                for i in range(3)])

        if cfg.solver == Solver.CHEBYSHEV:
            order = self._cheb_roots(li)

            def body(xt, _):
                for r in order:
                    z = solve_blocks(bt - op.apply(xt, with_bc))
                    xt = xt + z / jnp.asarray(r, xt.dtype)
                return xt, None
            sweeps = self._cheb_reps(li, sweeps, len(order))
        else:  # BLOCK_JACOBI
            def body(xt, _):
                z = solve_blocks(bt - op.apply(xt, with_bc))
                return xt + cfg.omega * z, None
        xt, _ = jax.lax.scan(body, xt, None, length=sweeps)
        return xt

    # -- smoothing ---------------------------------------------------------
    def _smooth(self, li: int, x, b, sweeps: int, with_bc: bool):
        cfg = self.cfg
        L = self.p.levels[li]
        phys = cfg.physics
        dt, theta, omega = cfg.dt, cfg.theta, cfg.omega
        if (self._stencil is not None
                and cfg.solver in (Solver.CHEBYSHEV, Solver.BLOCK_JACOBI)):
            f = self._fmod
            op = self._stencil[li]
            if cfg.solver == Solver.CHEBYSHEV:
                roots = self._cheb_roots(li)
                xt = op.smooth_chebyshev(
                    f.to_t(x), f.to_t(b), roots,
                    self._cheb_reps(li, sweeps, len(roots)), with_bc)
            else:
                xt = op.smooth_jacobi(f.to_t(x), f.to_t(b), omega, sweeps,
                                      with_bc)
            return f.from_t(xt)
        if (self._fused is not None
                and cfg.solver in (Solver.CHEBYSHEV, Solver.BLOCK_JACOBI)):
            f = self._fmod
            xt = self._smooth_fused_t(li, f.to_t(x), f.to_t(b), sweeps,
                                      with_bc)
            return f.from_t(xt)
        from ..ops import smoothers
        A = lambda t: self._apply(li, t, with_bc)
        d = diag_A(L, phys, dt, theta)
        if cfg.solver == Solver.CHEBYSHEV:
            Ainv = self._block_inv[li]
            solve = lambda r: jnp.einsum("ucij,ucj->uci", Ainv, r)
            roots = self._cheb_roots(li)
            return smoothers.chebyshev(A, b, x, solve, roots,
                                       self._cheb_reps(li, sweeps,
                                                       len(roots)))
        if cfg.solver == Solver.RICHARDSON:
            return smoothers.richardson(A, b, x, omega, sweeps)
        if cfg.solver == Solver.BLOCK_JACOBI:
            return smoothers.block_jacobi_inv(A, b, x, self._block_inv[li],
                                              omega, sweeps)
        if cfg.solver == Solver.GAUSS_SEIDEL and phys.surface_terms:
            # two-color GS: up/down orientation is a natural coloring of
            # the intra-macro adjacency (replaces the reference's
            # sequential sweep, transport_tri_semi.F90:501-507)
            up = (L["updown"] > 0)[None, :, None]
            return smoothers.colored_gs(A, b, x, d, (up, ~up), omega,
                                        sweeps)
        # Jacobi; also exact GS-equivalent when there is no inter-element
        # coupling (the reference's active mode 9 path)
        return smoothers.jacobi(A, b, x, d, omega, sweeps)

    def residual(self, li: int, x, b, with_bc: bool):
        return b - self._apply(li, x, with_bc)

    # -- transposed-layout V-cycle (the fast path) --------------------------
    # State (3, C, U) with the wide macro axis minor throughout: every
    # coefficient and state plane is a contiguous (C, U) slab, so the fused
    # elementwise sweeps read each plane once with unit stride.  The whole
    # cycle — smoothing, residual, transfers, coarse solve — runs transposed
    # and only run()/IO convert.

    @property
    def _use_t_cycle(self) -> bool:
        return (self._stencil is not None
                and self.cfg.solver in (Solver.CHEBYSHEV,
                                        Solver.BLOCK_JACOBI))

    def _smooth_t(self, li: int, x_t, b_t, sweeps: int, with_bc: bool):
        cfg = self.cfg
        op = self._stencil[li]
        if cfg.solver == Solver.CHEBYSHEV:
            roots = self._cheb_roots(li)
            return op.smooth_chebyshev(x_t, b_t, roots,
                                       self._cheb_reps(li, sweeps,
                                                       len(roots)),
                                       with_bc)
        return op.smooth_jacobi(x_t, b_t, cfg.omega, sweeps, with_bc)

    def _restrict(self, r, s_next):
        if self.cfg.restrictor == "corner_average":
            return restrict_corner_average(r, s_next)
        if self.cfg.restrictor != "linear":
            raise ValueError(f"unknown restrictor {self.cfg.restrictor!r}")
        return restrict(r, s_next)

    def _restrict_t(self, r_t, s_next):
        if self.cfg.restrictor == "corner_average":
            return restrict_corner_average_t(r_t, s_next)
        return restrict_t(r_t, s_next)

    def _phase_coefs(self, li: int, sweeps: int):
        """Per-round step sizes of one smoothing phase (the distributed
        solver's sweeps consume them as a flat list)."""
        cfg = self.cfg
        if cfg.solver == Solver.CHEBYSHEV:
            roots = self._cheb_roots(li)
            reps = self._cheb_reps(li, sweeps, len(roots))
            return [1.0 / r for r in roots] * reps
        return [cfg.omega] * sweeps

    def _coarse_cg_t(self, li: int, x_t, b_t):
        """Coarsest-level solve by block-Jacobi PCG (coarse_krylov=True):
        `coarse_sweeps` CG iterations — one operator apply each, like a
        smoother sweep, but spectrally adaptive where the Chebyshev
        interval's fixed lower cut (cheb_lower) gives up."""
        from ..ops import krylov
        op = self._stencil[li]
        x_sol, _, _ = krylov.pcg(
            lambda v: op.apply(v, False), b_t, x_t,
            precond=op.solve_diag, tol=0.0,
            maxiter=self.cfg.coarse_sweeps)
        return x_sol

    def _agg_correct_t(self, li: int, x_t, r_t):
        """Aggregation coarse-grid correction at the geometric coarsest:
        restrict the residual into the algebraic hierarchy (ops/agg),
        V-cycle there, prolong the correction back.  Stays in transposed
        vectors throughout.

        Fast path: the smoothed transfers factor as P = (I - w D^-1 A)
        P_tent, so for symmetric operators the wide smoothed-transfer
        gathers become a member-sum tentative transfer plus one application
        of the fine STENCIL operator on each side.
        """
        from ..ops import agg as _agg
        h = self._agg
        cfg = self.cfg
        C, U = r_t.shape[1], r_t.shape[2]
        to_flat = lambda v: jnp.swapaxes(v, 1, 2).reshape(3, U * C)
        from_flat = lambda v: jnp.swapaxes(v.reshape(3, U, C), 1, 2)
        if h.fine is not None and not cfg.physics.advection:
            f = h.fine
            w = jnp.asarray(f["w"], r_t.dtype)
            dinv = self._agg_fine_dinv
            # P^T r = P_tent^T (r - w A D^-1 r)   [A, D symmetric]
            y_t = r_t - w * self._stencil[li].apply(dinv * r_t, False)
            rc = _agg.tent_restrict(h, to_flat(y_t))
            e = _agg.vcycle_iter(h, rc, cfg.agg_cycles)
            ef = from_flat(_agg.tent_prolong(h, e))
            # P e = (I - w D^-1 A) P_tent e
            e_t = ef - w * (dinv * self._stencil[li].apply(ef, False))
            return x_t + e_t
        r_fine_t = to_flat(r_t)                               # e = u*C+c
        e_fine_t = _agg.correct_t(h, r_fine_t, cfg.agg_cycles)
        return x_t + from_flat(e_fine_t)

    def _vcycle_t(self, li: int, x_t, b_t, hom: bool = False):
        """Level-li V-cycle in the transposed layout.  Packed levels
        (cfg.coarse_pack) convert in/out here, so callers and the
        geometric transfers always see the unpacked (3, C, U) layout."""
        pk = self._pack[li]
        if pk == 1:
            return self._vcycle_t_body(li, x_t, b_t, hom)
        out = self._vcycle_t_body(li, pack_x_t(x_t, pk),
                                  pack_x_t(b_t, pk), hom)
        return unpack_x_t(out, pk)

    def _vcycle_t_body(self, li: int, x_t, b_t, hom: bool = False):
        cfg = self.cfg
        nl = len(self.p.levels)
        with_bc = li == 0 and not hom
        op = self._stencil[li]
        if self._agg is not None and li == self._agg_li:
            x_t = self._smooth_t(li, x_t, b_t, cfg.n_smooth, with_bc)
            r_t = b_t - op.apply(x_t, with_bc)
            x_t = self._agg_correct_t(li, x_t, r_t)
            return self._smooth_t(li, x_t, b_t, cfg.n_smooth, with_bc)
        if li == nl - 1:
            if nl > 1 and self._coarse_inv_t is not None:
                shape = x_t.shape
                return (self._coarse_inv_t @ b_t.reshape(-1)).reshape(shape)
            if cfg.coarse_krylov and nl > 1:
                return self._coarse_cg_t(li, x_t, b_t)
            return self._smooth_t(
                li, x_t, b_t,
                cfg.coarse_sweeps if nl > 1 else cfg.n_smooth, with_bc)
        x_t = self._smooth_t(li, x_t, b_t, cfg.n_smooth, with_bc)
        r_t = b_t - op.apply(x_t, with_bc)
        pk = self._pack[li]
        if pk > 1:                     # transfers run in the unpacked layout
            r_t = unpack_x_t(r_t, pk)
        bc_ = self._restrict_t(r_t, self.p.levels[li + 1]["s"])
        e_t = self._vcycle_t(li + 1, jnp.zeros_like(bc_), bc_, hom)
        if cfg.cycle_type == "w" and li < 2:
            e_t = self._vcycle_t(li + 1, e_t, bc_, hom)
        corr = prolong_t(e_t, self.p.levels[li + 1]["s"])
        x_t = x_t + (pack_x_t(corr, pk) if pk > 1 else corr)
        return self._smooth_t(li, x_t, b_t, cfg.n_smooth, with_bc)

    def _rhs_t(self, told_t):
        """_rhs in transposed layout: b = M told/dt + theta M s + ..."""
        cfg = self.cfg
        L = self.p.levels[0]
        M_t = jnp.transpose(L["M"], (1, 2, 0))           # (3, 3, U)
        s_t = jnp.transpose(L["source"], (2, 1, 0))      # (3, C, U)

        def mul_M(v_t):
            return jnp.stack([
                M_t[i, 0][None] * v_t[0] + M_t[i, 1][None] * v_t[1]
                + M_t[i, 2][None] * v_t[2] for i in range(3)])

        b_t = mul_M(told_t) / cfg.dt + mul_M(s_t)
        if cfg.theta < 1.0:
            from ..ops import fused as _f
            spat = apply_spatial(L, cfg.physics, _f.from_t(told_t), True,
                                 self._gather)
            b_t = b_t - (1.0 - cfg.theta) * _f.to_t(spat)
        return b_t

    # -- V-cycle -----------------------------------------------------------
    def _vcycle(self, li: int, x, b, hom: bool = False):
        """One V-cycle.  hom=True solves the homogeneous-BC (linear)
        problem — used when the cycle acts as a Krylov preconditioner."""
        cfg = self.cfg
        nl = len(self.p.levels)
        with_bc = li == 0 and not hom
        if self._use_t_cycle:
            f = self._fmod
            return f.from_t(self._vcycle_t(li, f.to_t(x), f.to_t(b), hom))
        if self._agg is not None and li == self._agg_li:
            from ..ops import agg as _agg
            x = self._smooth(li, x, b, cfg.n_smooth, with_bc)
            r = self.residual(li, x, b, with_bc)
            U, C = r.shape[:2]
            e = _agg.correct(self._agg, r.reshape(U * C, 3),
                             cfg.agg_cycles)
            x = x + e.reshape(U, C, 3)
            return self._smooth(li, x, b, cfg.n_smooth, with_bc)
        if li == nl - 1:
            if nl > 1 and self._coarse_inv is not None:
                shape = x.shape
                return (self._coarse_inv @ b.reshape(-1)).reshape(shape)
            if cfg.coarse_krylov and nl > 1:
                from ..ops import krylov
                pre = (lambda r: jnp.einsum(
                    "ucij,ucj->uci", self._block_inv[li], r)
                       if hasattr(self, "_block_inv") else r)
                x_sol, _, _ = krylov.pcg(
                    lambda v: self._apply(li, v, False), b, x,
                    precond=pre, tol=0.0, maxiter=cfg.coarse_sweeps)
                return x_sol
            return self._smooth(li, x, b,
                                cfg.coarse_sweeps if nl > 1 else cfg.n_smooth,
                                with_bc)
        x = self._smooth(li, x, b, cfg.n_smooth, with_bc)
        r = self.residual(li, x, b, with_bc)
        bc_ = self._restrict(r, self.p.levels[li + 1]["s"])
        e = jnp.zeros_like(bc_)
        e = self._vcycle(li + 1, e, bc_, hom)
        if cfg.cycle_type == "w" and li < 2:
            e = self._vcycle(li + 1, e, bc_, hom)
        x = x + prolong(e, self.p.levels[li + 1]["s"])
        x = self._smooth(li, x, b, cfg.n_smooth, with_bc)
        return x

    # -- time stepping -----------------------------------------------------
    def _rhs(self, told):
        """b = M told/dt + theta M s + (1-theta)(M s - L(told))."""
        cfg = self.cfg
        L = self.p.levels[0]
        phys = cfg.physics
        Ms = jnp.einsum("uij,ucj->uci", L["M"], L["source"])
        b = jnp.einsum("uij,ucj->uci", L["M"], told) / cfg.dt + Ms
        if cfg.theta < 1.0:
            b = b - (1.0 - cfg.theta) * apply_spatial(L, phys, told, True,
                                                      self._gather)
        return b

    def solve_system(self, b, x0):
        """Solve A x = b (with Dirichlet ghosts folded in) by a V-cycle-
        preconditioned Krylov method: PCG when the operator is symmetric
        (no advection), BiCGStab otherwise."""
        from ..ops import krylov

        cfg = self.cfg
        L = self.p.levels[0]
        phys = cfg.physics
        A_lin = lambda x: self._apply(0, x, False)
        # affine Dirichlet-ghost offset: A_affine(x) = A_lin(x) + c
        c = self._apply(0, jnp.zeros_like(b), True)
        b_lin = b - c
        precond = lambda r: self._vcycle(0, jnp.zeros_like(r), r, hom=True)
        method = krylov.pcg if not phys.advection else krylov.bicgstab
        x, _, _ = method(A_lin, b_lin, x0, precond=precond,
                         tol=cfg.krylov_tol, maxiter=cfg.krylov_maxiter)
        return x

    def krylov_t(self, b_lin_t, x0_t, tol: float, maxiter: int):
        """V-cycle-preconditioned PCG (BiCGStab with advection) on the
        LINEAR system A x = b (Dirichlet offset already removed), in
        transposed layout.  Returns (x, iterations, residual norm); the
        stop is ||r|| <= tol * ||b||."""
        from ..ops import krylov

        op = self._stencil[0]
        precond = lambda r: self._vcycle_t(0, jnp.zeros_like(r), r, hom=True)
        method = (krylov.pcg if not self.cfg.physics.advection
                  else krylov.bicgstab)
        return method(lambda x_t: op.apply(x_t, False), b_lin_t, x0_t,
                      precond=precond, tol=tol, maxiter=maxiter)

    def _solve_system_t(self, b_t, x0_t):
        """solve_system in transposed layout (stencil path)."""
        c = self._stencil[0].apply(jnp.zeros_like(b_t), True)
        x_t, _, _ = self.krylov_t(b_t - c, x0_t, self.cfg.krylov_tol,
                                  self.cfg.krylov_maxiter)
        return x_t

    def _make_step(self):
        if self._use_t_cycle:
            f = self._fmod

            def step_t(T_t):
                b_t = self._rhs_t(T_t)
                if self.cfg.krylov:
                    return self._solve_system_t(b_t, T_t)

                def cycle(T_t, _):
                    return self._vcycle_t(0, T_t, b_t), None
                T_t, _ = jax.lax.scan(cycle, T_t, None,
                                      length=self.cfg.n_multigrid)
                return T_t
            self._step_t_raw = step_t
            self._step_t = jax.jit(step_t)
            return lambda T: f.from_t(step_t(f.to_t(T)))

        def step(T):
            told = T
            b = self._rhs(told)
            if self.cfg.krylov:
                return self.solve_system(b, T)
            # scan over V-cycles: the graph is compiled once regardless of
            # n_multigrid
            def cycle(T, _):
                return self._vcycle(0, T, b), None
            T, _ = jax.lax.scan(cycle, T, None,
                                length=self.cfg.n_multigrid)
            return T
        return step

    def initial_condition(self) -> jax.Array:
        """ic callable if configured, else region_id == 4 painted to 1
        (transport_tri_semi.F90:249-252)."""
        U = self.p.num_macro
        C = self.p.levels[0]["C"]
        if self.cfg.fns.ic is not None:
            cf = self.p.coords_fine
            T = np.broadcast_to(
                np.asarray(self.cfg.fns.ic(cf[:, :, 0], cf[:, :, 1]),
                           np.float64), cf[:, :, 0].shape)
            return jnp.asarray(T, self.p.analytical.dtype)
        T = np.zeros((U, C, 3), self.p.analytical.dtype)
        T[self.p.grid.macro.region_id == 4] = 1.0
        return jnp.asarray(T)

    def run(self, T=None, ntime: int | None = None):
        if T is None:
            T = self.initial_condition()
        n = ntime or self.cfg.ntime
        if self._use_t_cycle:
            # keep the state transposed across steps: layout conversion
            # happens exactly twice per run, not per step
            f = self._fmod
            T_t = f.to_t(jnp.asarray(T))
            for _ in range(n):
                T_t = self._step_t(T_t)
            return f.from_t(T_t)
        for _ in range(n):
            T = self._step(T)
        return T

    def error(self, T) -> jax.Array:
        """|T - analytical| (get_error, transport_tri_semi.F90:531-540)."""
        return jnp.abs(T - self.p.analytical)

    def convergence(self, T) -> jax.Array:
        """L-inf norm of the residual (get_convergence, :876-889)."""
        r = self.residual(0, T, self._rhs(T), True)
        return jnp.max(jnp.abs(r))

    def convergence_t(self, T_t) -> jax.Array:
        """convergence() in transposed layout (no layout round trips) —
        the CLI's per-step monitor on the fast path."""
        r_t = self._rhs_t(T_t) - self._stencil[0].apply(T_t, True)
        return jnp.max(jnp.abs(r_t))


def solve(mesh: MacroMesh, cfg: SemiConfig | None = None):
    cfg = cfg or SemiConfig()
    problem = build_problem(mesh, cfg)
    solver = SemiSolver(problem)
    T = solver.run()
    return solver, T
