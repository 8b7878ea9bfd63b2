"""Exact fixed-degree block-stencil operator — the solver's fast path.

This is the ELL/BSR design of SURVEY.md section 7 realised for the
semi-structured hierarchy: every child element couples to itself and at
most 3 face neighbors through dense ``nloc x nloc`` blocks (the reference's
preallocated CSR sparsity, /root/reference/matrices.F90:997-1411), so the
whole theta-implicit DG operator ``A = M/dt + theta*L`` collapses to

    out[u, c] = S[u, c] @ x[u, c] + sum_f F[u, c, f] @ x[neighbor(u, c, f)]
                (+ affine Dirichlet-ghost vector when with_bc)

The blocks are extracted *numerically* from the reference-shaped operator
(models.semi.apply_A) by probing it with basis indicator fields under
masked gathers — intra-macro couplings and cross-macro (boundary-strip)
couplings separately — so the stencil is exact by construction for every
physics configuration (advection, SIP diffusion, Neumann mirrors, the lot)
and self-validating against the probed implementation
(tests/test_stencil.py).  Probing runs on the host CPU device in float64:
12*C+1 operator applications, no accelerator compiles.

Why this beats the term-by-term operator: one application is 36 fused
multiply-adds over (C, U) planes plus the neighbour gathers, about 40*C*U
floats of traffic in a few fusions instead of dozens of small kernels.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..mesh import splitting


def _probe_device():
    """The host CPU device when the platform list includes it (probing is
    host-side setup work), else the default device."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return jax.devices()[0]


@dataclasses.dataclass
class StencilData:
    """Probed blocks + static index sets for one level (all numpy f64)."""
    self_blocks: np.ndarray    # (U, C, 3, 3)
    face_blocks: np.ndarray    # (U, C, 3, 3, 3) [f, i, j] j = neighbor dof
    cross_blocks: np.ndarray   # (U, nb, 3, 3) coupling to halo source dofs
    c_aff: np.ndarray          # (U, C, 3) Dirichlet-ghost affine vector
    halo_src: np.ndarray       # (U, nb) flattened (u*C + c) source element
    bnd_c: np.ndarray          # (nb,) strip child of each slot
    bnd_f: np.ndarray          # (nb,) strip face of each slot
    intra_onehot: np.ndarray   # (3, C, C): xg[f] = intra_onehot[f] @ x-plane
    cross_onehot: np.ndarray   # (3, C, nb): + cross_onehot[f] @ strip
    # strip-slot face-group ids (nb,): slots of one group source the SAME
    # neighbor macro per row.  None = the standard 3 macro faces (derived
    # from bnd_f); macro-packed operators (pack_stencil) carry 3*p groups
    slot_mf: np.ndarray | None = None


def slot_groups(data: StencilData):
    """(mf_of, groups, F): the strip-slot face grouping.

    Every strip/phase consumer needs slots grouped so that all slots of a
    group source one neighbor macro per row (the banded-gather invariant).
    Plain levels have 3 groups (the macro faces); packed levels carry an
    explicit ``slot_mf`` with 3*p groups of equal size.
    """
    bnd_f = np.asarray(data.bnd_f)
    if getattr(data, "slot_mf", None) is not None:
        mf_of = np.asarray(data.slot_mf)
        F = int(mf_of.max()) + 1 if len(mf_of) else 3
    else:
        mf_of = splitting.CHILD2MACRO_FACE[bnd_f]
        F = 3
    groups = [np.nonzero(mf_of == mf)[0] for mf in range(F)]
    return mf_of, groups, F


def pack_stencil(data: StencilData, p: int) -> StencilData:
    """Re-index a level's stencil as (U/p packs) x (p*C children).

    A pure RELABELING of the same operator: macro u = q*p + j becomes
    child block j of pack q (new child c' = j*C + c), so the macro (minor)
    axis shrinks p-fold and the child axis grows p-fold.  Former
    cross-macro couplings STAY cross slots
    (their source may now be the pack itself — the banded strip gather
    covers self sources), grouped per (member, macro face): 3*p groups
    recorded in ``slot_mf``, each sourcing one pack per row, preserving
    the strip machinery's invariant.

    Replaces nothing in the reference: it is a layout choice only.
    """
    U, C = data.self_blocks.shape[:2]
    nb = data.cross_blocks.shape[1]
    if U % p:
        raise ValueError(f"pack_stencil: U={U} not divisible by p={p}")
    if getattr(data, "slot_mf", None) is not None:
        raise ValueError("pack_stencil: data is already packed")
    Un, Cn, nbn = U // p, p * C, p * nb

    intra = np.zeros((3, Cn, Cn))
    for j in range(p):
        intra[:, j * C:(j + 1) * C, j * C:(j + 1) * C] = data.intra_onehot

    bnd_c = (np.arange(p)[:, None] * C
             + np.asarray(data.bnd_c)[None, :]).reshape(-1)
    bnd_f = np.tile(np.asarray(data.bnd_f), p)
    cross_onehot = np.zeros((3, Cn, max(nbn, 1)))
    if nbn:
        cross_onehot[bnd_f, bnd_c, np.arange(nbn)] = 1.0

    hs = np.asarray(data.halo_src)                       # (U, nb) u*C + c
    u_src, c_src = hs // C, hs % C
    halo_src = ((u_src // p) * Cn + (u_src % p) * C
                + c_src).reshape(Un, nbn)

    mf_old = splitting.CHILD2MACRO_FACE[np.asarray(data.bnd_f)]
    slot_mf = (np.arange(p)[:, None] * 3 + mf_old[None, :]).reshape(-1)

    return StencilData(
        self_blocks=data.self_blocks.reshape(Un, Cn, 3, 3),
        face_blocks=data.face_blocks.reshape(Un, Cn, 3, 3, 3),
        cross_blocks=data.cross_blocks.reshape(Un, nbn, 3, 3),
        c_aff=data.c_aff.reshape(Un, Cn, 3),
        halo_src=halo_src,
        bnd_c=bnd_c.astype(np.int32), bnd_f=bnd_f.astype(np.int32),
        intra_onehot=intra, cross_onehot=cross_onehot,
        slot_mf=slot_mf.astype(np.int32))


def _distance2_coloring(cn: np.ndarray) -> np.ndarray:
    """Greedy distance-2 coloring of the child adjacency graph.

    Children sharing a color are pairwise non-adjacent AND share no common
    neighbor, so basis probes can light one whole color class at once and
    every operator response is still attributable to a unique source —
    the probe count becomes O(colors) ~ 10 instead of O(C).
    """
    C = cn.shape[0]
    adj = [set() for _ in range(C)]
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                adj[c].add(int(cn[c, f]))
    color = -np.ones(C, np.int64)
    for c in range(C):
        banned = set()
        # distance-1 and distance-2 neighbors
        for n1 in adj[c] | {c}:
            for n2 in adj[n1] | {n1}:
                if color[n2] >= 0:
                    banned.add(int(color[n2]))
        k = 0
        while k in banned:
            k += 1
        color[c] = k
    return color


def _static_tables(L: dict):
    """Static index sets shared by the analytic and probed builders."""
    H = L.get("_np", L)        # host table mirrors (no device readback)
    U = int(L["M"].shape[0])
    C = int(L["updown"].shape[0])
    cn = splitting.child_neighbors(L["s"])                  # (C, 3)
    bnd_c, bnd_f = np.nonzero(cn < 0)
    nb = len(bnd_c)
    intra_onehot = np.zeros((3, C, C))
    cross_onehot = np.zeros((3, C, nb))
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                intra_onehot[f, c, cn[c, f]] = 1.0
    for slot, (c, f) in enumerate(zip(bnd_c, bnd_f)):
        cross_onehot[f, c, slot] = 1.0
    halo_src = np.asarray(H["halo_src"])                    # (U, nb)
    return U, C, cn, bnd_c, bnd_f, halo_src, intra_onehot, cross_onehot


def build_stencil(L: dict, phys, dt: float, theta: float) -> StencilData:
    """Closed-form block stencil of apply_A — pure NumPy, zero XLA compiles.

    Assembles exactly the same blocks that ``probe_stencil`` extracts
    numerically (verified equal in tests/test_stencil.py), by transcribing
    the operator's term structure:

      self blocks   = models.semi.diag_blocks_A
                      + the Neumann-mirror advective income self-coupling
      face blocks   = models.semi_assembled._face_blocks (interior faces)
      c_aff         = theta * (Dirichlet-ghost terms of apply_spatial at T=0)

    This is the round-2 fix for the reference's 96%-setup disease
    (grofiling.txt:7-9) resurfacing as per-level probing compiles: the
    blocks were always available analytically.
    """
    U, C, cn, bnd_c, bnd_f, halo_src, intra_oh, cross_oh = _static_tables(L)
    nb = len(bnd_c)
    H = L.get("_np", L)        # host table mirrors (no device readback)
    # assemble in the level's own precision: f32 tables produce f32 blocks
    # (the operator is then exactly these blocks); f64 verification configs
    # keep everything f64 for the probe-equality test
    f64 = lambda key: np.asarray(H[key])
    ein = functools.partial(np.einsum, optimize=True)
    M, D, K = f64("M"), f64("D"), f64("K")
    face_sn, sn, sdet = f64("face_sn"), f64("sn"), f64("sdet")
    snorm, nx1, inv_dx = f64("snorm"), f64("nx1"), f64("inv_dx")
    diff_on, bc_dense = f64("diff_on"), f64("bc_dense")
    ud = f64("updown")                                      # (C,)
    neu = np.asarray(H["neu_mask"])                         # (U, C, 3) bool
    neigh = np.asarray(H["neigh_elem"])                     # (U, C, 3)
    interior = neigh >= 0
    fn = splitting.CHILD_FACE_NODES
    k = float(phys.k)
    eta = float(phys.penalty_factor)
    u_vec = np.asarray(phys.u, M.dtype)

    # geometry in child convention (matches apply_spatial)
    ud_b = ud[None, :, None, None]
    snorm_c = snorm[:, None] * ud_b[..., None]              # (U, C, 3f, g, 2)
    sdet_b = np.broadcast_to(sdet[:, None], (U, C, 3, sdet.shape[-1]))
    nxc = nx1[:, None] * (2.0 ** L["s"]) * ud_b             # (U, C, 2, nloc)

    # -- self blocks (diag_blocks_A transcription) ---------------------------
    A = np.broadcast_to(M[:, None] / dt, (U, C, 3, 3)).copy()
    if phys.diffusion:
        A += theta * D[:, None]
    if phys.advection:
        A -= theta * ud[None, :, None, None] * K[:, None]
    if phys.surface_terms and phys.diffusion:
        S0 = ein("fgi,fgj,ufg->ufij", face_sn, face_sn, sdet)
        A += (theta * eta * k
              * ein("ucf,ufij->ucij", inv_dx * diff_on, S0))
        if phys.sip_consistency:
            nn = ein("ucfgd,ucdj->ucfgj", snorm_c, nxc)
            w_face = np.where(interior, 0.5, 1.0) * diff_on
            cons = ein("fgi,ufg,ucfgj,ucf->ucij", face_sn, sdet, nn,
                             w_face)
            A -= theta * k * (cons + np.swapaxes(cons, -1, -2))
    if phys.surface_terms and phys.advection:
        un = ein("ucfgd,d->ucfg", snorm_c, u_vec)
        income = 0.5 + 0.5 * np.sign(-un)
        A += theta * ein("fgi,ucfg,fgj->ucij", face_sn,
                               un * sdet_b * (1.0 - income), face_sn)
        # Neumann mirror: t2 = own trace, so the income flux couples back
        # to my own face nodes (neighbor_trace's neu_mask branch)
        if neu.any():
            mir = ein("fgi,ucfg,gk->ucfik", face_sn,
                            un * sdet_b * income * neu[..., None], sn)
            for f in range(3):
                for kk in range(2):
                    A[:, :, :, fn[f, kk]] += theta * mir[:, :, f, :, kk]

    # -- neighbor blocks (_face_blocks transcription) ------------------------
    B = np.zeros((U, C, 3, 3, 3))
    if phys.surface_terms:
        perm = np.asarray(H["neigh_perm"])                  # (U, C, 3, 2)
        Pm = np.zeros((U, C, 3, 2, 3))
        for kk in range(2):
            np.put_along_axis(Pm[:, :, :, kk], perm[..., kk, None], 1.0,
                              axis=-1)
        S2 = ein("fgi,gk,ucfg->ucfik", face_sn, sn, sdet_b)
        if phys.diffusion:
            B -= (theta * eta * k
                  * ein("ucf,ucfik,ucfkj->ucfij", inv_dx * diff_on,
                              S2, Pm))
            if phys.sip_consistency:
                flat = nxc.reshape(U * C, 2, 3)
                safe = np.where(interior, neigh,
                                np.arange(U * C).reshape(U, C, 1))
                nxc2 = flat[safe]                           # (U, C, 3, 2, 3)
                nn2 = ein("ucfgd,ucfdj->ucfgj", snorm_c, nxc2)
                B -= 0.5 * theta * k * ein(
                    "fgi,ucfg,ucfgj->ucfij", face_sn,
                    sdet_b * diff_on[..., None], nn2)
                nxn = ein("ucdi,ucfgd->ucfgi", nxc, snorm_c)
                B += theta * k * ein(
                    "ucf,ucfgi,gk,ucfg,ucfkj->ucfij", 0.5 * diff_on, nxn,
                    sn, sdet_b, Pm)
        if phys.advection:
            un = ein("ucfgd,d->ucfg", snorm_c, u_vec)
            income = 0.5 + 0.5 * np.sign(-un)
            B += theta * ein("fgi,ucfg,gk,ucfkj->ucfij", face_sn,
                                   un * sdet_b * income, sn, Pm)
        B *= interior[..., None, None]

    face_blocks = B * (cn >= 0)[None, :, :, None, None]
    cross_blocks = (B[:, bnd_c, bnd_f] if nb
                    else np.zeros((U, 0, 3, 3)))

    # -- Dirichlet affine: theta * apply_spatial(0, with_bc=True) ------------
    c_aff = np.zeros((U, C, 3))
    if phys.surface_terms:
        dirich = (~interior) & (~neu)                       # (U, C, 3)
        t2b = np.where(dirich[..., None], bc_dense, 0.0)    # (U, C, 3, 2)
        t2_sgi = ein("gk,ucfk->ucfg", sn, t2b)
        if phys.diffusion:
            jump = -t2_sgi * sdet_b * diff_on[..., None]
            c_aff += eta * k * ein("fgi,ucf,ucfg->uci", face_sn,
                                         inv_dx, jump)
            if phys.sip_consistency:
                w_face = np.where(interior, 0.5, 1.0)
                nxn = ein("ucdi,ucfgd->ucfgi", nxc, snorm_c)
                c_aff -= k * ein("ucf,ucfgi,ucfg->uci", w_face, nxn,
                                       jump)
        if phys.advection:
            un = ein("ucfgd,d->ucfg", snorm_c, u_vec)
            income = 0.5 + 0.5 * np.sign(-un)
            c_aff += ein("fgi,ucfg->uci", face_sn,
                               un * sdet_b * income * t2_sgi)
        c_aff *= theta

    return StencilData(
        self_blocks=np.asarray(A), face_blocks=face_blocks,
        cross_blocks=cross_blocks, c_aff=c_aff, halo_src=halo_src,
        bnd_c=bnd_c.astype(np.int32), bnd_f=bnd_f.astype(np.int32),
        intra_onehot=intra_oh, cross_onehot=cross_oh)


def probe_stencil(L: dict, phys, dt: float, theta: float) -> StencilData:
    """Extract the exact block stencil of apply_A by basis probing."""
    from ..models import semi as msemi

    U = int(L["M"].shape[0])
    C = int(L["updown"].shape[0])
    cn = splitting.child_neighbors(L["s"])                  # (C, 3)
    intra_mask = cn >= 0
    bnd_c, bnd_f = np.nonzero(~intra_mask)
    nb = len(bnd_c)
    H = L.get("_np", L)        # host table mirrors (no device readback)
    neigh = np.asarray(H["neigh_elem"])                     # (U, C, 3)
    cross_mask_np = (~intra_mask)[None] & (neigh >= 0)      # (U, C, 3)
    color = _distance2_coloring(cn)
    ncol = int(color.max()) + 1

    # float64 CPU copies of the level tables (probing accuracy)
    cpu = _probe_device()
    Lp = {}
    for key, val in L.items():
        if key == "_np":
            continue
        if isinstance(val, (int, float)):
            Lp[key] = val
            continue
        arr = np.asarray(H.get(key, val))
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float64)
        Lp[key] = jax.device_put(arr, cpu)
    cross_mask = jax.device_put(cross_mask_np, cpu)

    def gather_intra(Ld, X):
        full = msemi.structured_gather(Ld, X)       # (U, C, 3, ...)
        m = cross_mask.reshape(cross_mask.shape + (1,) * (full.ndim - 3))
        return jnp.where(m, 0.0, full)

    def gather_cross(f0):
        def g(Ld, X):
            full = msemi.structured_gather(Ld, X)
            m = cross_mask[:, :, f0]
            m = m.reshape(m.shape + (1,) * (full.ndim - 3))
            take = jnp.zeros_like(full)
            return take.at[:, :, f0].set(
                jnp.where(m, full[:, :, f0], 0.0))
        return g

    def gather_zero(Ld, X):
        return jnp.zeros_like(msemi.structured_gather(Ld, X))

    # one probe per (color, dof): distance-2 coloring guarantees that every
    # response entry has a unique attributable source, so O(10) probes
    # suffice regardless of C (for cross couplings, each (target, face) has
    # a unique source element, so color classes work unconditionally)
    probes = np.zeros((3 * ncol, U, C, 3))
    for c0 in range(C):
        for j in range(3):
            probes[color[c0] * 3 + j, :, c0, j] = 1.0

    with jax.default_device(cpu):
        probes_d = jax.device_put(probes, cpu)

        def apply_with(gather):
            fn = lambda x: msemi.apply_A(Lp, phys, dt, theta, x, False,
                                         gather)
            return jax.jit(jax.vmap(fn))

        resp_intra = np.asarray(apply_with(gather_intra)(probes_d))
        resp_zero = np.asarray(apply_with(gather_zero)(probes_d))
        resp_cross = [
            np.asarray(apply_with(gather_cross(f))(probes_d)) - resp_zero
            for f in range(3)]
        zero = jax.device_put(np.zeros((U, C, 3)), cpu)
        c_aff = np.asarray(jax.jit(
            lambda x: msemi.apply_A(Lp, phys, dt, theta, x, True,
                                    gather_intra))(zero))

    # -- extraction --------------------------------------------------------
    self_blocks = np.zeros((U, C, 3, 3))
    face_blocks = np.zeros((U, C, 3, 3, 3))
    for c0 in range(C):
        for j in range(3):
            r = resp_intra[color[c0] * 3 + j]               # (U, C, 3)
            self_blocks[:, c0, :, j] = r[:, c0]
            for f in range(3):
                for c in np.nonzero(cn[:, f] == c0)[0]:
                    face_blocks[:, c, f, :, j] = r[:, c]

    # cross: slot (c, f) sources element halo_src with child id src_c
    halo_src = np.asarray(H["halo_src"])                    # (U, nb)
    src_c = halo_src % C                                    # (U, nb)
    cross_blocks = np.zeros((U, nb, 3, 3))
    u_all = np.arange(U)
    for slot in range(nb):
        c, f = int(bnd_c[slot]), int(bnd_f[slot])
        r = resp_cross[f][:, :, c, :]                       # (3*ncol, U, 3)
        for j in range(3):
            p = color[src_c[:, slot]] * 3 + j               # (U,)
            cross_blocks[:, slot, :, j] = r[p, u_all]
    # domain-boundary slots carry no linear cross coupling by construction
    # (cross_mask is False there).

    intra_onehot = np.zeros((3, C, C))
    cross_onehot = np.zeros((3, C, nb))
    for c in range(C):
        for f in range(3):
            if intra_mask[c, f]:
                intra_onehot[f, c, cn[c, f]] = 1.0
    for slot, (c, f) in enumerate(zip(bnd_c, bnd_f)):
        cross_onehot[f, c, slot] = 1.0

    return StencilData(
        self_blocks=self_blocks, face_blocks=face_blocks,
        cross_blocks=cross_blocks, c_aff=c_aff, halo_src=halo_src,
        bnd_c=bnd_c.astype(np.int32), bnd_f=bnd_f.astype(np.int32),
        intra_onehot=intra_onehot, cross_onehot=cross_onehot)


def to_dense(data: StencilData) -> np.ndarray:
    """Assemble the full (U*C*3, U*C*3) matrix from the probed blocks —
    host-side replacement for extracting the coarse operator by vmapped
    identity application (and for the reference's gen_global_matrix,
    /root/reference/matrices.F90:140-167)."""
    U, C = data.self_blocks.shape[:2]
    E = U * C
    cn = None
    A = np.zeros((E, 3, E, 3))
    e_all = np.arange(E)
    A[e_all, :, e_all, :] = data.self_blocks.reshape(E, 3, 3)
    eids = e_all.reshape(U, C)
    from ..mesh import splitting as _spl
    n = int(round(np.log(C) / np.log(4))) if C > 1 else 0
    cn = _spl.child_neighbors(n)
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                A[eids[:, c], :, eids[:, cn[c, f]], :] += \
                    data.face_blocks[:, c, f]
    for slot in range(len(data.bnd_c)):
        rows = eids[:, data.bnd_c[slot]]
        cols = data.halo_src[:, slot]
        A[rows, :, cols, :] += data.cross_blocks[:, slot]
    return A.reshape(E * 3, E * 3)


def inv3x3(A: np.ndarray) -> np.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det) — pure numpy, no
    device compile (replaces jnp.linalg.inv of tiny blocks at setup)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = np.empty_like(A)
    co[..., 0, 0] = e * i - f * h
    co[..., 0, 1] = c * h - b * i
    co[..., 0, 2] = b * f - c * e
    co[..., 1, 0] = f * g - d * i
    co[..., 1, 1] = a * i - c * g
    co[..., 1, 2] = c * d - a * f
    co[..., 2, 0] = d * h - e * g
    co[..., 2, 1] = b * g - a * h
    co[..., 2, 2] = a * e - b * d
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


class StencilOperator:
    """Device-side stencil application + fused relaxation sweeps.

    Transposed layout throughout: state ``x_t`` is (3, C, U) with the wide
    macro axis minor, coefficients are (.., C, U) planes, and the three
    intra-macro neighbor gathers are one-hot matmuls on (C, U) planes for
    small C and static row gathers above C = 64.
    """

    def __init__(self, data: StencilData, dtype):
        U, C = data.self_blocks.shape[:2]
        self.U, self.C = U, C
        nb = data.cross_blocks.shape[1]
        self.nb = nb
        self._data = data
        # cast on host (device-side conversion costs a compile each)
        t = lambda a: np.asarray(a, dtype)

        # premultiplied-smoother form: z = D^-1 (b - A x) with D = self
        # block; folding D^-1 into the neighbor blocks turns the diagonal
        # solve into the identity and removes D from the sweep entirely
        Dinv = inv3x3(data.self_blocks)                          # (U,C,3,3)
        Fp = np.einsum("ucik,ucfkj->ucfij", Dinv, data.face_blocks)
        if nb:
            Xp = np.einsum("usik,uskj->usij", Dinv[:, data.bnd_c],
                           data.cross_blocks)
        else:
            Xp = data.cross_blocks
        hs = np.asarray(data.halo_src)
        host = dict(
            S_t=t(data.self_blocks.transpose(2, 3, 1, 0)),       # (3,3,C,U)
            F_t=t(data.face_blocks.transpose(2, 3, 4, 1, 0)),    # (3,3,3,C,U)
            X_t=t(data.cross_blocks.transpose(2, 3, 1, 0)),      # (3,3,nb,U)
            c_aff_t=t(data.c_aff.transpose(2, 1, 0)),            # (3, C, U)
            intra_oh=t(data.intra_onehot),                       # (3, C, C)
            # every strip slot has exactly one (child, face): sum over faces
            # gives the total slot -> child scatter map
            cross_oh=t(data.cross_onehot.sum(axis=0)),           # (C, nb)
            Fp_t=t(Fp.transpose(2, 3, 4, 1, 0)),
            Xp_t=t(Xp.transpose(2, 3, 1, 0)),
            Dinv_t=t(Dinv.transpose(2, 3, 1, 0)),                # (3,3,C,U)
        )
        host.update(self._strip_tables(data, hs, dtype))
        for key, val in jax.device_put(host).items():
            setattr(self, key, val)
        self._dinv_np = Dinv
        # static intra-neighbor rows for the large-C gather path (the
        # (C, C) one-hot matmul costs O(C^2) FLOPs and constant-folding
        # pain at C >= 256; a static row gather is O(C)).  Packed child
        # axes are not the splitting lattice; they stay on the one-hot
        # path (small C by construction), so no row table is needed.
        if getattr(data, "slot_mf", None) is None:
            cn = splitting.child_neighbors(
                int(round(np.log(C) / np.log(4))) if C > 1 else 0)
            self._intra_rows = np.where(cn >= 0, cn,
                                        np.arange(C)[:, None]).T.astype(
                                            np.int32)        # (3f, C)
        else:
            assert C <= 64, "packed operators require the one-hot path"
            self._intra_rows = None

    def _strip_tables(self, data: StencilData, hs: np.ndarray, dtype):
        """Static tables turning the cross-macro strip exchange into a
        macro-axis ROW gather (+ a tiny static one-hot contraction).

        A plain gather would fetch nb*U scattered scalars from the (C*U)
        plane one element at a time.  But the strip sources have structure:
        every
        slot of a macro face sources the SAME neighbor macro, and the source
        child is one of the few strip children.  So: pack the strip-children
        rows once, gather whole rows by neighbor-macro index (contiguous,
        embedding-lookup shaped), and select the per-slot child with a
        static one-hot contraction.
        """
        U, C, nb = self.U, self.C, self.nb
        src_c, src_u = hs % C, hs // C                       # (U, nb)
        uniq_c = np.unique(data.bnd_c)                       # strip children
        nbc = len(uniq_c)
        qpos = np.zeros(C, np.int64)
        qpos[uniq_c] = np.arange(nbc)
        _, group_slots, F = slot_groups(data)
        m = nb // F
        assert all(len(g) == m for g in group_slots)
        face_src = np.zeros((F, U), np.int32)
        sel = np.zeros((F, U, m, nbc))
        for mf, g in enumerate(group_slots):
            # all slots of one group source the same neighbor macro
            assert (src_u[:, g] == src_u[:, g[:1]]).all()
            face_src[mf] = src_u[:, g[0]]
            u_idx = np.arange(U)[:, None]
            sel[mf][u_idx, np.arange(m)[None, :], qpos[src_c[:, g]]] = 1.0
        # canonical slot order: slot -> (group, position) inverse permutation
        order = np.concatenate(group_slots)
        inv_perm = np.argsort(order).astype(np.int32)
        self._nbc, self._m, self._F = nbc, m, F
        return dict(
            strip_pack_rows=uniq_c.astype(np.int32),         # (nbc,)
            strip_face_src=face_src,                         # (F, U)
            strip_sel=np.asarray(sel, dtype),                # (F, U, m, nbc)
            strip_inv_perm=inv_perm,                         # (nb,)
        )

    # -- helpers -----------------------------------------------------------
    def strip(self, x_t):
        """(3j, nb, U) strip planes: source-element dof values per slot.

        One static row-pack, one (3U, 3*nbc)-row gather over the macro axis,
        one static one-hot contraction — no element-wise gathers.
        """
        nbc, m, F = self._nbc, self._m, self._F
        sp = x_t[:, self.strip_pack_rows, :]                 # (3, nbc, U)
        rows = sp.reshape(3 * nbc, self.U).T                 # (U, 3*nbc)
        g = rows[self.strip_face_src]                        # (F, U, 3*nbc)
        g = g.reshape(F, self.U, 3, nbc)                     # (mf, u, j, q)
        sv = jnp.einsum("mujq,mukq->jmku", g, self.strip_sel)
        sv = sv.reshape(3, F * m, self.U)                    # grouped slots
        return sv[:, self.strip_inv_perm, :]                 # canonical order

    # -- application ---------------------------------------------------------
    def _apply_planes(self, x_t, F_t, X_t):
        """Neighbor contribution sum_f F[f] x_nb(f) as three (C, U) planes.

        Intra-macro faces: coefficient plane times a one-hot-matmul gather.
        Cross-macro strip slots: per-slot blocks applied to the strip
        values, scattered to their children by one one-hot matmul.
        """
        sv = self.strip(x_t) if self.nb else None
        if self.C > 64:
            # static row gather (j, f, C, U); neighbor blocks are zero at
            # boundary faces so the self-row placeholder never contributes
            xg = x_t[:, self._intra_rows.reshape(-1), :].reshape(
                3, 3, self.C, self.U)
        else:
            xg = jnp.einsum("fcd,jdu->jfcu", self.intra_oh, x_t)
        out = []
        for i in range(3):
            acc = None
            for f in range(3):
                for j in range(3):
                    term = F_t[f, i, j] * xg[j, f]
                    acc = term if acc is None else acc + term
            if self.nb:
                cs = X_t[i, 0] * sv[0]
                for j in range(1, 3):
                    cs = cs + X_t[i, j] * sv[j]              # (nb, U)
                acc = acc + self.cross_oh @ cs
            out.append(acc)
        return out

    def apply(self, x_t, with_bc: bool):
        """A x (+ Dirichlet affine when with_bc) in transposed layout."""
        nbr = self._apply_planes(x_t, self.F_t, self.X_t)
        out = []
        for i in range(3):
            acc = self.S_t[i, 0] * x_t[0]
            for j in range(1, 3):
                acc = acc + self.S_t[i, j] * x_t[j]
            acc = acc + nbr[i]
            if with_bc:
                acc = acc + self.c_aff_t[i]
            out.append(acc)
        return jnp.stack(out)

    def solve_diag(self, r_t):
        """D^-1 r in transposed layout."""
        return jnp.stack([
            self.Dinv_t[i, 0] * r_t[0] + self.Dinv_t[i, 1] * r_t[1]
            + self.Dinv_t[i, 2] * r_t[2] for i in range(3)])

    def _z(self, x_t, bp):
        """z = D^-1 (b - A x) = bp - x - D^-1 (A - D) x."""
        off = self._apply_planes(x_t, self.Fp_t, self.Xp_t)
        return jnp.stack([bp[i] - x_t[i] - off[i] for i in range(3)])

    def _bp(self, b_t, with_bc):
        return self.solve_diag(b_t - self.c_aff_t if with_bc else b_t)

    def smooth_chebyshev(self, x_t, b_t, roots, sweeps: int, with_bc: bool):
        bp = self._bp(b_t, with_bc)

        def body(x_t, _):
            for r in roots:
                x_t = x_t + self._z(x_t, bp) / jnp.asarray(r, x_t.dtype)
            return x_t, None
        x_t, _ = jax.lax.scan(body, x_t, None, length=sweeps)
        return x_t

    def smooth_jacobi(self, x_t, b_t, omega: float, sweeps: int,
                      with_bc: bool):
        bp = self._bp(b_t, with_bc)

        def body(x_t, _):
            return x_t + omega * self._z(x_t, bp), None
        x_t, _ = jax.lax.scan(body, x_t, None, length=sweeps)
        return x_t

    # -- spectral bound (numpy, setup-time) ----------------------------------
    def lam_max_estimate(self, iters: int = 12, seed: int = 0) -> float:
        """Power iteration on D^-1 A in numpy — no device compiles."""
        d = self._data
        U, C, nb = self.U, self.C, self.nb
        Sp = np.einsum("ucik,uckj->ucij", self._dinv_np, d.self_blocks)
        Fp = np.einsum("ucik,ucfkj->ucfij", self._dinv_np, d.face_blocks)
        Xp = (np.einsum("usik,uskj->usij", self._dinv_np[:, d.bnd_c],
                        d.cross_blocks) if nb else d.cross_blocks)
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(U, C, 3))

        oh_all = d.cross_onehot.sum(axis=0)                  # (C, nb)
        packed = getattr(d, "slot_mf", None) is not None
        if not packed:
            cn = splitting.child_neighbors(
                int(round(np.log(C) / np.log(4))) if C > 1 else 0)
            cn_safe = np.where(cn >= 0, cn, np.arange(C)[:, None])  # (C, 3)

        def apply_np(x):
            out = np.einsum("ucij,ucj->uci", Sp, x, optimize=True)
            for f in range(3):
                if packed:
                    # packed child axes are not the splitting lattice —
                    # the explicit intra one-hot is authoritative (small
                    # C only, so the O(C^2) einsum is fine here)
                    xg = np.einsum("cd,udj->ucj", d.intra_onehot[f], x,
                                   optimize=True)
                else:
                    xg = x[:, cn_safe[:, f], :]    # direct gather, not 1-hot
                    xg = np.where((cn[:, f] >= 0)[None, :, None], xg, 0.0)
                out += np.einsum("ucij,ucj->uci", Fp[:, :, f], xg,
                                 optimize=True)
            if nb:
                src = x.reshape(U * C, 3)[d.halo_src]        # (U, nb, 3)
                cs = np.einsum("usij,usj->usi", Xp, src)     # (U, nb, 3)
                out += np.einsum("cs,usi->uci", oh_all, cs)
            return out

        for _ in range(iters):
            w = apply_np(v)
            v = w / np.linalg.norm(w)
        return 1.2 * float(np.linalg.norm(apply_np(v)))
