"""Distributed stencil V-cycle — the multi-device path.

Shards the transposed block-stencil operator (ops/stencil) over a 1-D
device mesh along the macro axis, after RCM-ordering the macro elements so
every element's cross-macro strip sources lie within a band of width W
(measured 63 on an 8192-macro unstructured mesh).  The halo exchange is
then a handful of neighbor ``ppermute``s per operator application — the
collective form of the reference's ``update_overlaps`` boundary-strip
writes (/root/reference/splitting.F90:1210-1398).

- **Smoothing inside shard_map**: every Chebyshev/block-Jacobi round and
  every residual evaluation exchanges a width-W strip halo with the ring
  neighbours, then runs the same plane arithmetic as the serial
  ``StencilOperator`` on the local U_loc macros.
- **Distributed smoothed-aggregation correction** (amg / coarse_agg): the
  level-0 restriction runs as per-device partial products reduced by one
  ``psum``; deeper (small) aggregation levels shard block rows and keep
  the iterate replicated via ``all_gather`` after each apply — 1-D
  row-parallel SpMV, no halo logic needed on the algebraic levels.
- **k-hop ring halos** (``_ring_halo``): halo windows wider than one shard
  are filled by ``ceil(H / U_loc)`` neighbor ppermutes (wrap-around blocks
  land only on positions that nothing reads).

Everything else is macro-local: multigrid transfers never communicate, and
the coarsest solve either runs replicated (dense inverse after one
all_gather) or smooths shard-locally.

Multi-host: pass ``mesh_shape=(hosts, chips)`` and the solver builds the
2-D ``Mesh(devices.reshape(h, c), ("host", "dp"))`` with the RCM ring
flattened row-major over both axes — contiguous RCM blocks per host,
per-chip blocks within a host.  All collectives run over the axis TUPLE
(ppermute/psum/all_gather/axis_index address the flattened ring), so every
ring exchange is nearest-neighbor: only the two block-boundary chips of
each host pair talk across hosts.  The numerics are mesh-shape-invariant
(tests assert 1-D vs 2-D bit equality).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SemiConfig, Solver
from ..mesh import splitting, topology
from ..models import semi
from . import partition

_AXIS = "dp"


def _level_tables(op, U_loc: int, dtype):
    """Shardable table dict + window strip indices for one level."""
    data = op._data
    U, C, nb = op.U, op.C, op.nb
    hs = np.asarray(data.halo_src)
    src_u = (hs // C).T                                  # (nb, U)
    # strip packing tables (same construction as StencilOperator)
    uniq_c = np.unique(data.bnd_c)
    nbc = len(uniq_c)
    qpos = np.zeros(C, np.int64)
    qpos[uniq_c] = np.arange(nbc)
    mf_of = splitting.CHILD2MACRO_FACE[data.bnd_f]
    groups = [np.nonzero(mf_of == mf)[0] for mf in range(3)]
    m = nb // 3
    face_src = np.stack([src_u[g[0]] for g in groups])   # (3, U)
    W = int(np.abs(face_src - np.arange(U)[None]).max())
    sel = np.zeros((3, U, m, nbc))
    src_c = (hs % C).T
    for mf, g in enumerate(groups):
        u_idx = np.arange(U)[:, None]
        sel[mf][u_idx, np.arange(m)[None, :], qpos[src_c[g].T]] = 1.0
    order = np.concatenate(groups)
    inv_perm = np.argsort(order).astype(np.int32)

    block_start = (np.arange(U) // U_loc) * U_loc
    win_src = (face_src - block_start[None]).astype(np.int32)  # +W at use

    t = lambda a: np.asarray(a, dtype)
    Dinv = op._dinv_np
    Fp = np.einsum("ucik,ucfkj->ucfij", Dinv, data.face_blocks)
    Xp = (np.einsum("usik,uskj->usij", Dinv[:, data.bnd_c],
                    data.cross_blocks) if nb else data.cross_blocks)
    cn = splitting.child_neighbors(
        int(round(np.log(C) / np.log(4))) if C > 1 else 0)
    intra_rows = np.where(cn >= 0, cn,
                          np.arange(C)[:, None]).T.astype(np.int32)
    tabs = dict(
        S_t=t(data.self_blocks.transpose(2, 3, 1, 0)),       # (3,3,C,U)
        F_t=t(data.face_blocks.transpose(2, 3, 4, 1, 0)),
        X_t=t(data.cross_blocks.transpose(2, 3, 1, 0)),
        Fp_t=t(Fp.transpose(2, 3, 4, 1, 0)),
        Xp_t=t(Xp.transpose(2, 3, 1, 0)),
        Dinv_t=t(Dinv.transpose(2, 3, 1, 0)),
        c_aff_t=t(data.c_aff.transpose(2, 1, 0)),            # (3, C, U)
        intra_oh=t(data.intra_onehot),                       # (3, C, C)
        intra_rows=intra_rows,                               # (3f, C)
        cross_oh=t(data.cross_onehot.sum(axis=0)),           # (C, nb)
        pack_rows=uniq_c.astype(np.int32),                   # (nbc,)
        strip_sel=t(sel),                                    # (3, U, m, nbc)
        inv_perm=inv_perm,                                   # (nb,)
        win_src=win_src,                                     # (3, U)
    )
    specs = dict(
        S_t=P(None, None, None, _AXIS), F_t=P(None, None, None, None, _AXIS),
        X_t=P(None, None, None, _AXIS),
        Fp_t=P(None, None, None, None, _AXIS),
        Xp_t=P(None, None, None, _AXIS), Dinv_t=P(None, None, None, _AXIS),
        c_aff_t=P(None, None, _AXIS), intra_oh=P(), intra_rows=P(),
        cross_oh=P(),
        pack_rows=P(), strip_sel=P(None, _AXIS), inv_perm=P(),
        win_src=P(None, _AXIS),
    )
    meta = dict(C=C, nb=nb, nbc=nbc, m=m, W=W)
    return tabs, specs, meta


def _ring_halo(x, H: int, n_dev: int, axis: int = -1, axes=_AXIS):
    """(left, right) width-H halos along ``axis`` via k-hop ring ppermutes.

    ``ceil(H / U_loc)`` neighbor hops per side; blocks that wrap around the
    ring carry garbage, but they land only on window positions that no
    strip source points at (sources lie within W of their row, inside the
    domain).

    ``axes`` is the mesh axis name — or a TUPLE of names for a 2-D
    (hosts, chips) mesh, over which ppermute indices address the
    row-major-flattened ring: chips within a host are ring neighbors and
    only the two host-boundary chips of each host pair exchange across
    the outer axis.
    """
    x = jnp.moveaxis(x, axis, -1)
    U_loc = x.shape[-1]
    hops = -(-H // U_loc)
    fwd = [(d, (d + 1) % n_dev) for d in range(n_dev)]
    bwd = [(d, (d - 1) % n_dev) for d in range(n_dev)]
    lt, rt = [], []
    cl = cr = x
    for _ in range(hops):
        cl = jax.lax.ppermute(cl, axes, fwd)       # block of d-1, d-2, ...
        lt.append(cl)
        cr = jax.lax.ppermute(cr, axes, bwd)       # block of d+1, d+2, ...
        rt.append(cr)
    left = jnp.concatenate(lt[::-1], axis=-1)[..., -H:]
    right = jnp.concatenate(rt, axis=-1)[..., :H]
    return (jnp.moveaxis(left, -1, axis), jnp.moveaxis(right, -1, axis))


def _strip(tab, meta, x_t, W: int, n_dev: int, axes=_AXIS):
    """Window halo exchange + local strip selection -> (3, nb, U_loc).

    Ring ppermutes of the packed strip rows; issued first so XLA can
    overlap the transfer with the interior compute that follows.
    """
    nbc, m = meta["nbc"], meta["m"]
    U_loc = x_t.shape[-1]
    sp = x_t[:, tab["pack_rows"], :]                     # (3, nbc, U_loc)
    rows = sp.reshape(3 * nbc, U_loc).T                  # (U_loc, 3*nbc)
    from_left, from_right = _ring_halo(rows, W, n_dev, axis=0, axes=axes)
    rows_ext = jnp.concatenate([from_left, rows, from_right], axis=0)
    g = rows_ext[tab["win_src"] + W]                     # (3, U_loc, 3nbc)
    g = g.reshape(3, U_loc, 3, nbc)
    sv = jnp.einsum("mujq,mukq->jmku", g, tab["strip_sel"])
    sv = sv.reshape(3, 3 * m, U_loc)
    return sv[:, tab["inv_perm"], :]


def _planes(tab, x_t, F_t, X_t, sv):
    C = x_t.shape[1]
    if C > 64:
        # static row gather, O(C) — the (C, C) one-hot einsum is O(C^2)
        # FLOPs and constant-folding pain at deep n_split (same switch as
        # ops.stencil.StencilOperator._apply_planes)
        rows = tab["intra_rows"]                     # (3f, C) int32
        xg = x_t[:, rows.reshape(-1), :].reshape(
            3, 3, C, x_t.shape[-1])                  # (j, f, C, U_loc)
        xg = jnp.swapaxes(xg, 0, 1)                  # (f, j, C, U_loc)
    else:
        xg = jnp.einsum("fcd,jdu->fjcu", tab["intra_oh"], x_t)
    out = []
    for i in range(3):
        acc = None
        for f in range(3):
            for j in range(3):
                term = F_t[f, i, j] * xg[f, j]
                acc = term if acc is None else acc + term
        cs = X_t[i, 0] * sv[0] + X_t[i, 1] * sv[1] + X_t[i, 2] * sv[2]
        out.append(acc + tab["cross_oh"] @ cs)
    return out


def _mul33(B, v_t):
    return jnp.stack([B[i, 0] * v_t[0] + B[i, 1] * v_t[1] + B[i, 2] * v_t[2]
                      for i in range(3)])


def _apply(tab, meta, x_t, with_bc: bool, W, n_dev, axes=_AXIS):
    sv = _strip(tab, meta, x_t, W, n_dev, axes)
    nbr = _planes(tab, x_t, tab["F_t"], tab["X_t"], sv)
    out = _mul33(tab["S_t"], x_t) + jnp.stack(nbr)
    return out + tab["c_aff_t"] if with_bc else out


def _sweep(tab, meta, x_t, bp_t, coefs, W, n_dev, axes=_AXIS):
    for coef in coefs:
        sv = _strip(tab, meta, x_t, W, n_dev, axes)
        off = _planes(tab, x_t, tab["Fp_t"], tab["Xp_t"], sv)
        z = jnp.stack([bp_t[i] - x_t[i] - off[i] for i in range(3)])
        x_t = x_t + coef * z
    return x_t


class DistributedStencilSolver:
    """Sharded counterpart of SemiSolver's transposed stencil V-cycle."""

    def __init__(self, mesh: topology.MacroMesh, cfg: SemiConfig,
                 devices=None, mesh_shape=None):
        """``mesh_shape=(hosts, chips)`` builds the 2-D device mesh of the
        multi-host deployment: the RCM ring is flattened row-major
        over ("host", "dp"), every collective runs over the axis tuple,
        and the table shardings shard the macro axis over both axes —
        contiguous RCM blocks per host, per-chip blocks within a host
        (SURVEY §2/§5; the reference's partitioning seam is
        ``getProcessor``, /root/reference/Generic.F90:387-405).  The
        numerics are mesh-shape-invariant: only which ppermute hops cross
        the outer axis changes."""
        if cfg.solver not in (Solver.CHEBYSHEV, Solver.BLOCK_JACOBI):
            raise ValueError("distributed stencil solver needs the "
                             "Chebyshev or block-Jacobi smoother")
        if cfg.coarse_pack > 1:
            raise ValueError(
                "coarse_pack is a single-device layout; the distributed "
                "level tables assume unpacked levels — run with "
                "coarse_pack=1")
        devices = devices if devices is not None else jax.devices()
        D = len(devices)
        if mesh_shape is not None:
            h, c = mesh_shape
            if h * c != D:
                raise ValueError(f"mesh_shape {mesh_shape} != {D} devices")
            self.jmesh = Mesh(np.asarray(devices).reshape(h, c),
                              axis_names=("host", _AXIS))
            self.axes = ("host", _AXIS)
        else:
            self.jmesh = Mesh(np.asarray(devices), axis_names=(_AXIS,))
            self.axes = (_AXIS,)
        self.mesh_shape = mesh_shape
        self.D = D
        # collective axis arg (plain name on the 1-D mesh for back-compat)
        self._ax = self.axes if len(self.axes) > 1 else _AXIS
        self._xspec = P(None, None, self._ax)

        mesh = topology.reorder_elements(mesh, topology.rcm_order(mesh))
        mesh, self.n_active = partition.pad_mesh(mesh, D)
        self.U = mesh.num_elements
        self.U_loc = self.U // D

        self.cfg = cfg
        self.p = semi.build_problem(mesh, cfg)
        # the serial twin builds the SAME algorithm (incl. the agg/AMG
        # hierarchy) — parity tests compare against it, and the
        # distributed tables below are derived from its stencil/agg data
        self.serial = semi.SemiSolver(self.p)
        if self.serial._stencil is None:
            raise ValueError("stencil operator disabled for this config")

        dtype = np.dtype(cfg.dtype)
        self.dtype = dtype
        built = [_level_tables(op, self.U_loc, dtype)
                 for op in self.serial._stencil]
        self.tabs = [b[0] for b in built]
        self.specs = [b[1] for b in built]
        self.meta = [b[2] for b in built]
        self.W = max(b[2]["W"] for b in built)
        # fine-level mass + source for the RHS
        L0np = self.p.levels[0]["_np"]
        self.tabs[0]["M_t"] = np.asarray(L0np["M"].transpose(1, 2, 0), dtype)
        self.tabs[0]["source_t"] = np.asarray(
            L0np["source"].transpose(2, 1, 0), dtype)
        self.specs[0]["M_t"] = P(None, None, _AXIS)
        self.specs[0]["source_t"] = P(None, None, _AXIS)
        if self.serial._coarse_inv_t is not None:
            self.tabs[-1]["coarse_inv"] = np.asarray(
                self.serial._coarse_inv_t)
            self.specs[-1]["coarse_inv"] = P()

        self._coefs = [self.serial._phase_coefs(li, cfg.n_smooth)
                       for li in range(len(self.tabs))]
        nl = len(self.tabs)
        self._coefs_coarse = self.serial._phase_coefs(
            nl - 1, cfg.coarse_sweeps if nl > 1 else cfg.n_smooth)

        self._agg_li = self.serial._agg_li
        self._atabs_host, self._aspecs, self._ameta = self._build_agg_dist()

        self._put_tables()
        self._step = self._build_step()

    # -- setup: distributed aggregation hierarchy ----------------------------
    def _build_agg_dist(self):
        """Per-device tables for the SA correction inside shard_map.

        Level-0 transfers: restriction as per-device partial products over
        local fine columns (compacted slots) reduced by psum; prolongation
        as a local fine-row slice reading the replicated coarse iterate.
        For symmetric physics these are the FACTORED tentative transfers
        of the serial solver (``SemiSolver._agg_correct_t``), whose
        smoothing factor runs through the sharded stencil apply; otherwise
        the stored smoothed ones.  Aggregation levels: block rows sharded
        (padded to D), iterate replicated via all_gather.
        """
        h = self.serial._agg
        if h is None:
            return None, None, None
        D = self.D
        dt = self.dtype
        li = self._agg_li
        C_li = self.meta[li]["C"]
        E = self.U * C_li
        E_loc = self.U_loc * C_li

        lvl0 = h.levels[0]
        factored = h.fine is not None and not self.cfg.physics.advection
        tr = h.fine if factored else dict(
            r_cols=lvl0.r_cols, r_vals=lvl0.r_vals, p_cols=lvl0.p_cols,
            p_vals=lvl0.p_vals)
        r_cols = np.asarray(tr["r_cols"])                # (na, Dr) fine ids
        r_vals = np.asarray(tr["r_vals"])
        na = lvl0.n
        N0 = len(np.asarray(lvl0.cols))
        # compacted per-device restriction slots (only local fine columns)
        own = r_cols // E_loc                            # (na, Dr) device of
        counts = np.stack([(own == d).sum(axis=1) for d in range(D)])
        Dr_c = max(int(counts.max()), 1)
        Npad0 = D * (-(-N0 // D))
        rc_cols = np.zeros((D, Npad0, Dr_c), np.int32)
        rc_vals = np.zeros((D, Npad0, Dr_c, 3, 3), dt)
        # vectorized slot packing (a Python loop over D x na x members
        # takes minutes at U=8192): stable-sort each row's slots by owning
        # device; the
        # within-group rank is arange minus the group start (cummax over
        # the change points), reproducing the loop's ascending-slot order
        Dr = own.shape[1]
        order = np.argsort(own, axis=1, kind="stable")       # (na, Dr)
        so = np.take_along_axis(own, order, axis=1)
        ar = np.broadcast_to(np.arange(Dr)[None, :], (na, Dr))
        change = np.empty((na, Dr), bool)
        change[:, 0] = True
        change[:, 1:] = so[:, 1:] != so[:, :-1]
        start = np.maximum.accumulate(np.where(change, ar, 0), axis=1)
        a_idx = np.repeat(np.arange(na), Dr)
        d_idx = so.ravel()
        p_idx = (ar - start).ravel()
        src = order.ravel()
        rc_cols[d_idx, a_idx, p_idx] = r_cols[a_idx, src] - d_idx * E_loc
        rc_vals[d_idx, a_idx, p_idx] = r_vals[a_idx, src]
        p_cols = np.asarray(tr["p_cols"])                # (E, Dp) agg ids
        p_vals = np.asarray(tr["p_vals"])
        l0 = dict(
            r_cols=rc_cols, r_vals=rc_vals,
            p_cols=p_cols.reshape(D, E_loc, -1).astype(np.int32),
            p_vals=p_vals.reshape(D, E_loc, *p_vals.shape[1:]).astype(dt))
        l0_specs = {k: P(_AXIS) for k in l0}
        if factored:
            # (3, C, U) fine block-diagonal inverse, sharded like the state
            l0["dinv_t"] = np.asarray(self.serial._agg_fine_dinv, dt)
            l0_specs["dinv_t"] = P(None, None, _AXIS)

        levels = []
        lvl_specs = []
        meta_lv = []
        for k, lvl in enumerate(h.levels):
            n = lvl.n
            N_loc = -(-n // D)
            Npad = D * N_loc
            cols = np.asarray(lvl.cols)
            vals = np.asarray(lvl.vals)
            dinv = np.asarray(lvl.dinv)

            def pad_rows(a):
                padded = np.zeros((Npad,) + a.shape[1:], a.dtype)
                padded[:n] = a
                return padded.reshape(D, N_loc, *a.shape[1:])

            t = dict(cols=pad_rows(cols).astype(np.int32),
                     vals=pad_rows(vals).astype(dt),
                     dinv=pad_rows(dinv).astype(dt))
            if k > 0:
                prev = h.levels[k - 1]
                n_prev = prev.n
                Np_loc = -(-n_prev // D)
                rr = np.asarray(lvl.r_cols)              # (n, Dr) prev ids
                rv = np.asarray(lvl.r_vals)
                t["r_cols"] = pad_rows(rr).astype(np.int32)
                t["r_vals"] = pad_rows(rv).astype(dt)
                pp = np.asarray(lvl.p_cols)              # (n_prev, Dp)
                pv = np.asarray(lvl.p_vals)
                padded = np.zeros((D * Np_loc,) + pp.shape[1:], pp.dtype)
                padded[:n_prev] = pp
                t["p_cols"] = padded.reshape(
                    D, Np_loc, *pp.shape[1:]).astype(np.int32)
                padded = np.zeros((D * Np_loc,) + pv.shape[1:], pv.dtype)
                padded[:n_prev] = pv
                t["p_vals"] = padded.reshape(
                    D, Np_loc, *pv.shape[1:]).astype(dt)
            levels.append(t)
            lvl_specs.append({key: P(_AXIS) for key in t})
            meta_lv.append(dict(n=n, N_loc=N_loc,
                                omega=min(lvl.omega, h.omega)))

        at = dict(l0=l0, levels=levels)
        specs = dict(l0=l0_specs, levels=lvl_specs)
        if h.coarse_inv is not None:
            at["coarse_inv"] = np.asarray(h.coarse_inv)
            at["coarse_scale"] = np.asarray(h.coarse_scale)
            specs["coarse_inv"] = P()
            specs["coarse_scale"] = P()
        meta = dict(levels=meta_lv, sweeps=h.sweeps,
                    w=float(h.fine["w"]) if factored else None,
                    cycles=self.cfg.agg_cycles, E_loc=E_loc, Npad0=Npad0)
        return at, specs, meta

    def _remap_specs(self, tree):
        """1-D specs (built with the _AXIS name) -> this mesh's specs: on
        a 2-D (host, dp) mesh every _AXIS entry becomes the axis tuple,
        sharding the same dimension over both axes in ring order."""
        if len(self.axes) == 1:
            return tree
        conv = lambda p: P(*[self.axes if e == _AXIS else e for e in p])
        return jax.tree.map(conv, tree,
                            is_leaf=lambda x: isinstance(x, P))

    def _put_tables(self):
        def shardings_of(specs):
            return jax.tree.map(
                lambda s: NamedSharding(self.jmesh, s),
                self._remap_specs(specs),
                is_leaf=lambda x: isinstance(x, P))

        payload = [self.tabs, self._atabs_host]
        specs = [self.specs, self._aspecs]
        self.tabs_dev, self.atabs_dev = jax.device_put(
            payload, shardings_of(specs))

    # -- numerics (inside shard_map) ----------------------------------------
    def _bp(self, tab, b_t, with_bc):
        b = b_t - tab["c_aff_t"] if with_bc else b_t
        return _mul33(tab["Dinv_t"], b)

    def _pdot(self, a, b):
        """Globally-reduced inner product (the psum dot for shard_map)."""
        return jax.lax.psum(jnp.vdot(a.reshape(-1), b.reshape(-1)),
                            self._ax)

    def _coarse_cg(self, tab, meta, x_t, b_t):
        """coarse_krylov inside shard_map: block-Jacobi PCG with psum
        dots — the distributed mirror of SemiSolver._coarse_cg_t."""
        from ..ops import krylov
        W, D, ax = self.W, self.D, self._ax
        x_sol, _, _ = krylov.pcg(
            lambda v: _apply(tab, meta, v, False, W, D, ax), b_t, x_t,
            precond=lambda r: _mul33(tab["Dinv_t"], r), tol=0.0,
            maxiter=self.cfg.coarse_sweeps, dot=self._pdot)
        return x_sol

    # -- distributed aggregation correction ----------------------------------
    def _ag(self, y_loc):
        return jax.lax.all_gather(y_loc, self._ax, axis=0, tiled=True)

    def _flat_idx(self):
        """This shard's position on the flattened ring (host-major)."""
        return jax.lax.axis_index(self._ax)

    @staticmethod
    def _rowop(cols, vals, x_rep):
        return jnp.einsum("ndij,ndj->ni", vals, x_rep[cols])

    def _agg_smooth(self, at, k, x_rep, b_rep, sweeps):
        lvl = at["levels"][k]
        mv = self._ameta["levels"][k]
        w = jnp.asarray(mv["omega"], x_rep.dtype)
        d = self._flat_idx()
        N_loc = mv["N_loc"]
        b_loc = jax.lax.dynamic_slice_in_dim(b_rep, d * N_loc, N_loc)
        for _ in range(sweeps):
            r_loc = b_loc - self._rowop(lvl["cols"][0], lvl["vals"][0],
                                        x_rep)
            z_loc = jnp.einsum("nij,nj->ni", lvl["dinv"][0], r_loc)
            x_rep = x_rep + w * self._ag(z_loc)
        return x_rep

    def _agg_smooth_from_zero(self, at, k, b_rep, sweeps):
        """_agg_smooth with x0 = 0: the first sweep's rowop apply of the
        zero iterate is skipped (mirror of ops.agg._smooth_from_zero)."""
        lvl = at["levels"][k]
        mv = self._ameta["levels"][k]
        w = jnp.asarray(mv["omega"], b_rep.dtype)
        d = self._flat_idx()
        N_loc = mv["N_loc"]
        b_loc = jax.lax.dynamic_slice_in_dim(b_rep, d * N_loc, N_loc)
        z_loc = jnp.einsum("nij,nj->ni", lvl["dinv"][0], b_loc)
        x = w * self._ag(z_loc)
        if sweeps > 1:
            x = self._agg_smooth(at, k, x, b_rep, sweeps - 1)
        return x

    def _agg_vcycle(self, at, k, b_rep):
        """Mirror of ops.agg.vcycle with sharded rows + replicated iterate."""
        lvl = at["levels"][k]
        mv = self._ameta["levels"][k]
        sweeps = self._ameta["sweeps"]
        x = self._agg_smooth_from_zero(at, k, b_rep, sweeps)
        d = self._flat_idx()
        N_loc = mv["N_loc"]
        b_loc = jax.lax.dynamic_slice_in_dim(b_rep, d * N_loc, N_loc)
        r_loc = b_loc - self._rowop(lvl["cols"][0], lvl["vals"][0], x)
        if k + 1 < len(at["levels"]):
            nxt = at["levels"][k + 1]
            r_rep = self._ag(r_loc)
            rc_loc = self._rowop(nxt["r_cols"][0], nxt["r_vals"][0], r_rep)
            ec = self._agg_vcycle(at, k + 1, self._ag(rc_loc))
            e_loc = self._rowop(nxt["p_cols"][0], nxt["p_vals"][0], ec)
            x = x + self._ag(e_loc)
        elif "coarse_inv" in at:
            n = mv["n"]
            r_rep = self._ag(r_loc)[:n]
            rs = at["coarse_scale"] * r_rep.reshape(-1)
            ec = (at["coarse_scale"] * (at["coarse_inv"] @ rs)).reshape(
                n, 3)
            x = x + jnp.zeros_like(x).at[:n].set(ec)
        return self._agg_smooth(at, k, x, b_rep, sweeps)

    def _agg_correct(self, tab, meta, at, x_t, r_t):
        """SA correction of this level's local residual (3, C, U_loc)."""
        if self.D == 1:
            # single device: the shard IS the mesh — run the serial fast
            # path (factored transfers) verbatim
            return self.serial._agg_correct_t(self._agg_li, x_t, r_t)
        C = r_t.shape[1]
        U_loc = r_t.shape[2]
        l0 = at["l0"]
        w = self._ameta["w"]
        if w is not None:
            # factored transfers: P^T r = P_tent^T (r - w A D^-1 r)
            A = lambda v: _apply(tab, meta, v, False, self.W, self.D,
                                 self._ax)
            r_t = r_t - w * A(l0["dinv_t"] * r_t)
        r_loc = jnp.transpose(r_t, (2, 1, 0)).reshape(U_loc * C, 3)
        part = self._rowop(l0["r_cols"][0], l0["r_vals"][0], r_loc)
        rc = jax.lax.psum(part, self._ax)                # (Npad0, 3) repl.
        e = self._agg_vcycle(at, 0, rc)
        for _ in range(self._ameta["cycles"] - 1):
            lvl0 = at["levels"][0]
            a_loc = self._rowop(lvl0["cols"][0], lvl0["vals"][0], e)
            e = e + self._agg_vcycle(at, 0, rc - self._ag(a_loc))
        e_loc = self._rowop(l0["p_cols"][0], l0["p_vals"][0], e)
        e_t = jnp.transpose(e_loc.reshape(U_loc, C, 3), (2, 1, 0))
        if w is not None:
            # P e = (I - w D^-1 A) P_tent e
            e_t = e_t - w * (l0["dinv_t"] * A(e_t))
        return x_t + e_t

    # -- V-cycle -------------------------------------------------------------
    def _vcycle(self, tabs, atabs, li, x_t, b_t, hom: bool = False):
        cfg = self.cfg
        nl = len(tabs)
        with_bc = li == 0 and not hom
        tab, meta = tabs[li], self.meta[li]
        W, D, ax = self.W, self.D, self._ax
        bp = self._bp(tab, b_t, with_bc)
        agg_here = atabs is not None and li == self._agg_li

        def smooth(x, coefs, want_z=False):
            x = _sweep(tab, meta, x, bp, coefs, W, D, ax)
            if want_z:
                return x, b_t - _apply(tab, meta, x, with_bc, W, D, ax)
            return x

        coefs = self._coefs[li]
        if agg_here:
            # algebraic correction (fine level in amg mode, else the
            # geometric coarsest): smooth - SA-correct - smooth
            x_t, r_t = smooth(x_t, coefs, want_z=True)
            x_t = self._agg_correct(tab, meta, atabs, x_t, r_t)
            return smooth(x_t, coefs)
        if li == nl - 1:
            if nl > 1 and "coarse_inv" in tab:
                full = jax.lax.all_gather(b_t, ax)       # (D, 3, C, U_loc)
                flat = jnp.transpose(full, (1, 2, 0, 3)).reshape(-1)
                x_full = (tab["coarse_inv"] @ flat).reshape(
                    3, meta["C"], D, self.U_loc)
                return x_full[:, :, self._flat_idx()]
            if cfg.coarse_krylov and nl > 1:
                return self._coarse_cg(tab, meta, x_t, b_t)
            return smooth(x_t, self._coefs_coarse)
        x_t, r_t = smooth(x_t, coefs, want_z=True)
        bc_ = semi.restrict_t(r_t, self.p.levels[li + 1]["s"])
        e_t = self._vcycle(tabs, atabs, li + 1, jnp.zeros_like(bc_), bc_,
                           hom)
        if cfg.cycle_type == "w" and li < 2:
            e_t = self._vcycle(tabs, atabs, li + 1, e_t, bc_, hom)
        x_t = x_t + semi.prolong_t(e_t, self.p.levels[li + 1]["s"])
        return smooth(x_t, coefs)

    def _build_step(self):
        cfg = self.cfg
        in_specs = (self._xspec,
                    self._remap_specs((tuple(self.specs), self._aspecs)))
        shard_map = jax.shard_map

        def step_local(T_t, all_tabs):
            tabs, atabs = all_tabs
            tab0, meta0 = tabs[0], self.meta[0]
            ax = self._ax
            b_t = (_mul33(tab0["M_t"], T_t) / cfg.dt
                   + _mul33(tab0["M_t"], tab0["source_t"]))
            if cfg.theta < 1.0:
                # spatial operator via the stencil: L = (A - M/dt) / theta
                Ax = _apply(tab0, meta0, T_t, True, self.W, self.D, ax)
                spat = (Ax - _mul33(tab0["M_t"], T_t) / cfg.dt) / cfg.theta
                b_t = b_t - (1.0 - cfg.theta) * spat

            if cfg.krylov:
                # V-cycle-preconditioned Krylov with psum-reduced dots —
                # the distributed mirror of SemiSolver._solve_system_t
                from ..ops import krylov

                def A_lin(x):
                    return _apply(tab0, meta0, x, False, self.W, self.D,
                                  ax)
                c = _apply(tab0, meta0, jnp.zeros_like(b_t), True,
                           self.W, self.D, ax)
                precond = lambda r: self._vcycle(
                    tabs, atabs, 0, jnp.zeros_like(r), r, hom=True)
                method = (krylov.pcg if not cfg.physics.advection
                          else krylov.bicgstab)
                T_new, _, _ = method(A_lin, b_t - c, T_t, precond=precond,
                                     tol=cfg.krylov_tol,
                                     maxiter=cfg.krylov_maxiter,
                                     dot=self._pdot)
                return T_new

            def cycle(x, _):
                return self._vcycle(tabs, atabs, 0, x, b_t), None
            T_t, _ = jax.lax.scan(cycle, T_t, None, length=cfg.n_multigrid)
            return T_t

        fn = shard_map(step_local, mesh=self.jmesh,
                       in_specs=in_specs, out_specs=self._xspec,
                       check_vma=False)
        return jax.jit(fn)

    # -- public API ----------------------------------------------------------
    def initial_condition(self):
        from ..ops import fused
        T = fused.to_t(self.serial.initial_condition())
        sh = NamedSharding(self.jmesh, self._xspec)
        return jax.device_put(T, sh)

    def step(self, T_t):
        return self._step(T_t, (tuple(self.tabs_dev), self.atabs_dev))

    def run(self, T_t=None, ntime=None):
        if T_t is None:
            T_t = self.initial_condition()
        for _ in range(ntime or self.cfg.ntime):
            T_t = self.step(T_t)
        return T_t

    def to_std(self, T_t):
        """(3, C, U) -> (U_active, C, 3) numpy, padding removed."""
        return np.asarray(jnp.transpose(T_t, (2, 1, 0)))[: self.n_active]

    # -- checkpoint / resume (io.checkpoint passthrough) ---------------------
    def save_checkpoint(self, path: str, T_t, step: int) -> None:
        """Persist the sharded state in the std (unpadded) layout so the
        checkpoint is interchangeable with the serial solver's."""
        from ..io import checkpoint as ckpt
        ckpt.save(path, self.to_std(T_t), step, self.cfg)

    def load_checkpoint(self, path: str):
        """(T_t sharded, step): resume from a serial- or distributed-
        written checkpoint (state re-padded + re-sharded)."""
        from ..io import checkpoint as ckpt
        T_np, step, _, _ = ckpt.load(path)
        C = 4 ** self.cfg.n_split
        full = np.zeros((self.U, C, T_np.shape[-1]), T_np.dtype)
        full[: self.n_active] = T_np
        T_t = jnp.transpose(jnp.asarray(full), (2, 1, 0))
        sh = NamedSharding(self.jmesh, self._xspec)
        return jax.device_put(T_t, sh), step

    def error(self, T_t):
        ana = np.asarray(self.p.analytical)[: self.n_active]
        return np.abs(self.to_std(T_t) - ana)
