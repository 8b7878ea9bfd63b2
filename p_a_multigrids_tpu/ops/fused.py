"""Transposed-layout fused operator — the fast path above the stencil cap.

Arrays shaped (U, C, 3) or (U, C, 3, sngi) put the tiny node/quadrature
axes minor, so every elementwise pass strides over 3-wide rows.

This module computes the identical operator in the transposed layout
``Tt[node, child, U]`` with the wide U axis minor: every contraction over
nodes/faces/quadrature points becomes a short static Python loop of
(C, U)-shaped fused multiply-adds (unit stride), the intra-macro
neighbor exchange is a static row gather from the (3C, U) plane, and only
the 3*2**s cross-macro strip values per macro element use per-U gathers.

``FusedOperator.apply`` matches models.semi.apply_A to float tolerance
(tests/test_fused.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import Physics
from ..mesh import splitting


def to_t(T: jax.Array) -> jax.Array:
    """(U, C, n) -> (n, C, U)."""
    return jnp.transpose(T, (2, 1, 0))


def from_t(Tt: jax.Array) -> jax.Array:
    return jnp.transpose(Tt, (2, 1, 0))


class FusedOperator:
    """A = M/dt + theta*L at one level, in transposed layout."""

    def __init__(self, L: dict, phys: Physics, dt: float, theta: float):
        self.phys = phys
        self.theta = theta
        U = L["M"].shape[0]
        C = L["updown"].shape[0]
        s = L["s"]
        dtype = L["M"].dtype
        self.U, self.C, self.s = U, C, s
        H = L.get("_np", L)        # host table mirrors (no device readback)
        np_ = np.asarray
        ud = np_(H["updown"]).astype(np.float64)          # (C,)

        # volume blocks: vol_const = M/dt + theta*D (3,3,U); vol_K = theta*K
        M = np_(H["M"]).transpose(1, 2, 0) / dt
        vol = M + (theta * np_(H["D"]).transpose(1, 2, 0)
                   if phys.diffusion else 0.0)
        self.vol_const = jnp.asarray(vol, dtype)
        self.vol_K = (jnp.asarray(theta * np_(H["K"]).transpose(1, 2, 0),
                                  dtype) if phys.advection else None)
        self.ud_c = jnp.asarray(ud[None, :, None], dtype)  # (1, C, 1)

        self.surface = phys.surface_terms
        if not self.surface:
            return

        nface, sngi = 3, int(L["sn"].shape[0])
        self.sngi = sngi
        # static shape-function tables as plain floats
        self.fsn = np_(H["face_sn"]).tolist()             # [f][g][i]
        self.sn1 = np_(H["sn"]).tolist()                  # [g][k]

        cn = splitting.child_neighbors(s)                 # (C, 3)
        perm_in = splitting.child_neighbor_nodeperm(s)    # (C, 3, 2)
        intra_rows = np.zeros((nface, 2, C), np.int32)
        for f in range(nface):
            for k in range(2):
                nb = np.where(cn[:, f] >= 0, cn[:, f], np.arange(C))
                node = np.where(cn[:, f] >= 0, perm_in[:, f, k], 0)
                intra_rows[f, k] = node * C + nb
        self.intra_rows = jnp.asarray(intra_rows)
        self.intra_mask = jnp.asarray((cn >= 0).T)[:, :, None]  # (3f, C, 1)
        self.grad_rows = jnp.asarray(
            np.where(cn >= 0, cn, np.arange(C)[:, None]).T.astype(np.int32))

        bnd_c, bnd_f = np.nonzero(cn < 0)
        nbs = len(bnd_c)
        self.nb = nbs
        self.bnd_c = jnp.asarray(bnd_c.astype(np.int32))
        slot_of = np.zeros((nface, C), np.int64)
        slot_of[bnd_f, bnd_c] = np.arange(nbs)
        self.slot_of = jnp.asarray(slot_of)
        neigh = np_(H["neigh_elem"])
        hsrc = neigh[:, bnd_c, bnd_f]                     # (U, nb)
        self_flat = np.arange(U)[:, None] * C + bnd_c[None, :]
        hsrc_safe = np.where(hsrc >= 0, hsrc, self_flat)
        self.halo_idx = jnp.asarray(
            ((hsrc_safe % C) * U + hsrc_safe // C).astype(np.int32))
        self.halo_perm = jnp.asarray(
            np_(H["neigh_perm"])[:, bnd_c, bnd_f]
            .transpose(2, 1, 0).astype(np.int32))         # (2, nb, U)
        self.interior_strip = jnp.asarray((hsrc >= 0).T[None])  # (1, nb, U)
        bc = np_(H["bc_dense"])[:, bnd_c, bnd_f]          # (U, nb, 2)
        self.bc_strip = jnp.asarray(bc.transpose(2, 1, 0), dtype)
        self.neu_strip = jnp.asarray(
            np_(H["neu_mask"])[:, bnd_c, bnd_f].T[None])  # (1, nb, U)
        # own-trace rows for Neumann mirror: my face node k of strip faces
        fn = splitting.CHILD_FACE_NODES
        self.own_rows = jnp.asarray(np.stack(
            [np_(fn)[bnd_f, k] * C + bnd_c for k in range(2)]
        ).astype(np.int32))                               # (2, nb)

        self.sdet = jnp.asarray(
            np_(H["sdet"]).transpose(1, 2, 0), dtype)     # (3f, sngi, U)
        self.snorm = jnp.asarray(
            np_(H["snorm"]).transpose(1, 2, 3, 0), dtype)  # (3f, sngi, 2, U)

        if phys.diffusion:
            k = phys.k
            pen = (theta * phys.penalty_factor * k
                   * np_(H["inv_dx"]) * np_(H["diff_on"]))
            self.pen_coef = jnp.asarray(pen.transpose(2, 1, 0), dtype)
            # theta*k*diff_on (consistency) and theta*k*w'*diff_on (symmetry)
            don = np_(H["diff_on"]).transpose(2, 1, 0)    # (3f, C, U)
            self.cons_coef = jnp.asarray(theta * k * don, dtype)
            bnd_t = (neigh < 0).transpose(2, 1, 0)
            self.sym_coef = jnp.asarray(
                theta * k * np.where(bnd_t, 1.0, 0.5) * don, dtype)
        if phys.sip_consistency and phys.diffusion:
            self.nx1 = jnp.asarray(
                np_(H["nx1"]).transpose(1, 2, 0) * (2.0 ** s), dtype)

    # -- neighbor values ---------------------------------------------------
    def _neighbor_nodes(self, Tt, with_bc):
        """T2[f][k] (C, U): neighbor value at my k-th face node of face f."""
        n, C, U = Tt.shape
        plane = Tt.reshape(n * C, U)
        plane_cu = Tt.reshape(n, C * U)
        halo = plane_cu[:, self.halo_idx]                # (3, U, nb)
        halo = jnp.transpose(halo, (0, 2, 1))            # (3, nb, U)
        h = [jnp.take_along_axis(halo, self.halo_perm[k][None],
                                 axis=0)[0] for k in range(2)]
        bc = (self.bc_strip if with_bc
              else jnp.zeros_like(self.bc_strip))        # (2, nb, U)
        own = plane[self.own_rows]                       # (2, nb, U)
        bc = jnp.where(self.neu_strip, own, bc)
        strip = [jnp.where(self.interior_strip[0], h[k], bc[k])
                 for k in range(2)]                      # each (nb, U)
        out = []
        for f in range(3):
            vals = []
            for k in range(2):
                intra = plane[self.intra_rows[f, k]]     # (C, U)
                cross = strip[k][self.slot_of[f]]        # (C, U)
                vals.append(jnp.where(self.intra_mask[f], intra, cross))
            out.append(vals)
        return out

    def _neighbor_grad(self, G):
        """G2[f] = [G2x, G2y] (C, U): neighbor P1 gradient across face f."""
        n2, C, U = G.shape
        plane_cu = G.reshape(2, C * U)
        ghalo = plane_cu[:, self.halo_idx]               # (2, U, nb)
        ghalo = jnp.transpose(ghalo, (0, 2, 1))          # (2, nb, U)
        gown = G[:, self.bnd_c, :]                       # (2, nb, U)
        gstrip = jnp.where(self.interior_strip, ghalo, gown)
        out = []
        for f in range(3):
            gin = G[:, self.grad_rows[f], :]             # (2, C, U)
            gcr = gstrip[:, self.slot_of[f], :]
            out.append(jnp.where(self.intra_mask[f][None], gin, gcr))
        return out

    # -- application -------------------------------------------------------
    def apply(self, Tt: jax.Array, with_bc: bool) -> jax.Array:
        phys = self.phys
        theta = self.theta
        out = []
        for i in range(3):
            acc = self.vol_const[i, 0][None] * Tt[0]
            for j in range(1, 3):
                acc = acc + self.vol_const[i, j][None] * Tt[j]
            if self.vol_K is not None:
                kacc = self.vol_K[i, 0][None] * Tt[0]
                for j in range(1, 3):
                    kacc = kacc + self.vol_K[i, j][None] * Tt[j]
                acc = acc - self.ud_c[0] * kacc
            out.append(acc)
        if not self.surface:
            return jnp.stack(out)

        T2 = self._neighbor_nodes(Tt, with_bc)
        sip = phys.sip_consistency and phys.diffusion
        if sip:
            G = jnp.stack([
                self.ud_c[0] * (self.nx1[d, 0][None] * Tt[0]
                                + self.nx1[d, 1][None] * Tt[1]
                                + self.nx1[d, 2][None] * Tt[2])
                for d in range(2)])                      # (2, C, U)
            G2 = self._neighbor_grad(G)

        for f in range(3):
            for g in range(self.sngi):
                w0, w1, w2 = self.fsn[f][g]
                t_sgi = w0 * Tt[0] + w1 * Tt[1] + w2 * Tt[2]
                t2_sgi = (self.sn1[g][0] * T2[f][0]
                          + self.sn1[g][1] * T2[f][1])
                sd = self.sdet[f, g][None]               # (1, U)
                if phys.diffusion:
                    jump = (t_sgi - t2_sgi) * sd         # (C, U)
                    pen = self.pen_coef[f] * jump
                    if sip:
                        n0 = self.snorm[f, g, 0][None]
                        n1 = self.snorm[f, g, 1][None]
                        gavg_n = 0.5 * self.ud_c[0] * (
                            (G[0] + G2[f][0]) * n0 + (G[1] + G2[f][1]) * n1)
                        cons = self.cons_coef[f] * gavg_n * sd
                        pen = pen - cons
                    for i, w in enumerate((w0, w1, w2)):
                        if w != 0.0:
                            out[i] = out[i] + w * pen
                    if sip:
                        # symmetry: - theta k w' (grad N_i . n) jump ;
                        # ud^2 = 1 cancels between nxc and the child normal
                        for i in range(3):
                            nxn_i = (self.nx1[0, i][None] * n0
                                     + self.nx1[1, i][None] * n1)
                            out[i] = out[i] - (self.sym_coef[f] * nxn_i
                                               * jump)
                if phys.advection:
                    n0 = self.snorm[f, g, 0][None]
                    n1 = self.snorm[f, g, 1][None]
                    un = self.ud_c[0] * (phys.u[0] * n0 + phys.u[1] * n1)
                    income = 0.5 + 0.5 * jnp.sign(-un)
                    s_cont = (theta * un * sd
                              * ((1.0 - income) * t_sgi + income * t2_sgi))
                    for i, w in enumerate((w0, w1, w2)):
                        if w != 0.0:
                            out[i] = out[i] + w * s_cont
        return jnp.stack(out)
