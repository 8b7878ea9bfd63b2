"""Aggregation coarse levels below the geometric hierarchy.

The geometric hierarchy bottoms out at split depth 0 — one P1-DG element
per macro triangle — so on large macro meshes the coarsest level still has
O(U) elements and the reference's 15 stationary coarse sweeps
(/root/reference/transport_tri_semi.F90:344-359) leave the low-frequency
error untouched: the V-cycle stalls at rho ~ 0.86.  The
reference never hits this because its studies use tiny macro meshes (14-224
triangles); a framework meant for 8k+ macro elements must coarsen further.

This module continues the hierarchy ALGEBRAICALLY: macro/child elements are
aggregated in groups of ~4 on the element adjacency graph, each aggregate
keeps 3 coarse DOFs spanning the locally-linear near-nullspace [1, x, y]
(classical smoothed-aggregation with nodal blocks — the P1 functions a
diffusion operator must transfer exactly), and the coarse operator is the
variational P^T A P.  Levels repeat until the system is small enough for
the precomputed dense inverse (the FINDInv replacement,
matrices.F90:1618-1716).  All graph work and triple products run host-side
with scipy at setup; on device each level is a fixed-degree padded block
operator (gather + batched 3x3 einsum) — no dynamic sparsity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .stencil import StencilData, inv3x3


@dataclasses.dataclass
class AggLevel:
    """One aggregation level's device tables.

    The operator and both transfers are padded-fixed-degree block-row
    operators: row e couples to block-columns ``*_cols[e, :deg(e)]``
    through dense 3x3 ``*_vals`` blocks (zero-padded) — one gather plus a
    batched einsum each, no scatters on device.  ``agg``/``Pb`` keep the
    tentative (unsmoothed) transfer for diagnostics.
    """
    cols: jax.Array        # (N, D) int32 operator columns (self-padded)
    vals: jax.Array        # (N, D, 3, 3)
    dinv: jax.Array        # (N, 3, 3) inverse diagonal blocks
    agg: jax.Array         # (Ne_fine,) int32 aggregate of each fine element
    Pb: jax.Array          # (Ne_fine, 3, 3) tentative prolongation blocks
    p_cols: jax.Array      # (Ne_fine, Dp) prolongation: fine <- coarse
    p_vals: jax.Array      # (Ne_fine, Dp, 3, 3)
    r_cols: jax.Array      # (N, Dr) restriction: coarse <- fine
    r_vals: jax.Array      # (N, Dr, 3, 3)
    n: int                 # number of aggregates at this level
    # spectrally-safe Jacobi weight 4/(3 lam_max(D^-1 A)): a FIXED omega
    # (the reference's 0.8) diverges whenever lam_max > 2.5, which the
    # SIP-penalized Galerkin products routinely exceed on irregular
    # meshes — each "correction" then injects amplified error and the
    # enclosing V-cycle floors at rho ~ 0.76 no matter how hard the fine
    # levels smooth (measured on untitled8192)
    omega: float = 0.8


@dataclasses.dataclass
class AggHierarchy:
    levels: list[AggLevel]
    coarse_inv: jax.Array | None    # scaled dense inverse at the bottom
    coarse_scale: jax.Array | None  # D^-1/2 Jacobi scaling of that inverse
    omega: float
    sweeps: int
    # factored FINE transfers (round 4): P = (I - w D^-1 A) P_tent, so
    # P^T r = P_tent^T (r - w A D^-1 r) and P e = (I - w D^-1 A) P_tent e
    # for symmetric A — the smoothing factor runs through the fine-level
    # stencil fast path instead of the wide smoothed-transfer gathers.
    # dict(w, dinv_t (3, E), r_cols/r_vals tentative (na, m) member
    # tables, p_cols/p_vals (E, 1))
    fine: dict | None = None


# -- host-side construction --------------------------------------------------


def _csr_from_stencil(data: StencilData):
    """Block matrix + element adjacency of a stencil level (scipy CSR)."""
    from scipy import sparse

    U, C = data.self_blocks.shape[:2]
    E = U * C
    from ..mesh import splitting
    s = int(round(np.log(C) / np.log(4))) if C > 1 else 0
    cn = splitting.child_neighbors(s)

    rows, cols, vals = [], [], []
    e_all = np.arange(E)
    rows.append(e_all)
    cols.append(e_all)
    vals.append(data.self_blocks.reshape(E, 3, 3))
    eids = e_all.reshape(U, C)
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                rows.append(eids[:, c])
                cols.append(eids[:, cn[c, f]])
                vals.append(data.face_blocks[:, c, f])
    for slot in range(len(data.bnd_c)):
        blk = data.cross_blocks[:, slot]
        keep = np.abs(blk).max(axis=(1, 2)) > 0
        rows.append(eids[keep, data.bnd_c[slot]])
        cols.append(np.asarray(data.halo_src)[keep, slot])
        vals.append(blk[keep])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals, axis=0)                 # (nblk, 3, 3)
    i_, j_ = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    rs = (3 * r[:, None, None] + i_[None]).ravel()
    cs = (3 * c[:, None, None] + j_[None]).ravel()
    A = sparse.coo_matrix((v.ravel(), (rs, cs)),
                          shape=(3 * E, 3 * E)).tocsr()
    A.sum_duplicates()
    return A, E


def _element_graph(A, E: int, strength: float = 0.0):
    """Element adjacency (lists) from the 3x3-blocked CSR pattern.

    With ``strength`` > 0, only STRONG connections survive: the block
    coupling norm must reach ``strength`` times the row's strongest
    off-diagonal coupling.  Aggregating along strong connections only is
    the classical AMG answer to anisotropy (semicoarsening): on stretched
    elements the weak-direction couplings are dropped, so aggregates line
    up with the direction block smoothers cannot damp.
    """
    Ab = A.tobsr(blocksize=(3, 3))
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    norms = np.abs(data).max(axis=(1, 2))
    # vectorized strong-connection filter (the per-row Python loop cost
    # ~3 s at 131k elements — the reference's own setup disease)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(E), deg)
    off = indices != rows
    # per-row max off-diagonal norm via reduceat on the masked norms
    masked = np.where(off, norms, 0.0)
    row_max = np.zeros(E)
    nz_rows = deg > 0
    if nz_rows.any():
        red = np.maximum.reduceat(masked, indptr[:-1][nz_rows])
        row_max[nz_rows] = red
    keep = off & (norms >= strength * row_max[rows])
    adj_rows = rows[keep]
    adj_cols = indices[keep]
    counts = np.bincount(adj_rows, minlength=E)
    splits = np.cumsum(counts)[:-1]
    chunks = np.split(adj_cols, splits)
    return [c.tolist() for c in chunks]


def _aggregate(adj, E: int, target: int = 4) -> np.ndarray:
    """Greedy BFS aggregation into groups of ~``target`` elements."""
    agg = -np.ones(E, np.int64)
    na = 0
    for seed in range(E):
        if agg[seed] >= 0:
            continue
        members = [seed]
        agg[seed] = na
        frontier = [seed]
        while frontier and len(members) < target:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if agg[v] < 0 and len(members) < target:
                        agg[v] = na
                        members.append(v)
                        nxt.append(v)
            frontier = nxt
        na += 1
    # attach surviving singletons to a neighboring aggregate (keeps the
    # coarse blocks well-conditioned)
    sizes = np.bincount(agg, minlength=na)
    for e in range(E):
        if sizes[agg[e]] == 1:
            for v in adj[e]:
                if sizes[agg[v]] > 1:
                    sizes[agg[e]] -= 1
                    agg[e] = agg[v]
                    sizes[agg[e]] += 1
                    break
    # compact ids
    uniq, agg = np.unique(agg, return_inverse=True)
    return agg


def _tentative_P(agg: np.ndarray, B: np.ndarray):
    """Per-aggregate QR of the near-nullspace -> (Pb, B_coarse).

    B (E, 3, 3): near-nullspace values at each element's 3 dofs (last axis
    = the 3 nullspace vectors).  Returns Pb (E, 3, 3) orthonormal blocks
    and the coarse-level nullspace B_c (Na, 3, 3).

    Vectorized: aggregates are grouped by size and each size class runs
    one BATCHED np.linalg.qr (a per-aggregate Python loop costs tens of
    seconds at 100k+ elements).
    """
    E = B.shape[0]
    na = int(agg.max()) + 1
    Pb = np.zeros((E, 3, 3))
    Bc = np.zeros((na, 3, 3))
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=na)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    for sz in np.unique(sizes):
        aggs = np.nonzero(sizes == sz)[0]
        # (n_agg_of_size, sz) member rows in stable order
        rows = order[bounds[aggs][:, None] + np.arange(sz)[None, :]]
        Ba = B[rows].reshape(len(aggs), sz * 3, 3)
        Q, R = np.linalg.qr(Ba)                      # batched
        diag = np.abs(np.diagonal(R, axis1=-2, axis2=-1))
        bad = diag < 1e-12 * np.maximum(diag.max(axis=-1, keepdims=True),
                                        1e-30)
        if bad.any():
            Q = np.where(bad[:, None, :], 0.0, Q)
            fix = bad[:, :, None] | bad[:, None, :]
            R = np.where(fix, np.eye(3)[None], R)
        Pb[rows.reshape(-1)] = Q.reshape(len(aggs), sz, 3, 3).reshape(
            -1, 3, 3)
        Bc[aggs] = R
    return Pb, Bc


def _padded_operator(A, E: int, max_deg: int = 18, drop_tol: float = 1e-4):
    """CSR block matrix -> padded fixed-degree (cols, vals) numpy tables.

    Smoothed-aggregation Galerkin products grow long tails of tiny
    couplings; padding to the raw max degree makes the device tables (and
    every gather) pay for the worst row.  Standard SA filtering applies:
    blocks with norm below ``drop_tol * sqrt(|diag_i| |diag_j|)`` are
    dropped and each row keeps at most ``max_deg`` strongest couplings
    (the diagonal always survives) — the levels are approximate coarse
    solvers, not the fine discretization, so mild filtering trades nothing
    measurable for a several-fold smaller device footprint.
    """
    Ab = A.tobsr(blocksize=(3, 3))
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(E), deg)
    norms = np.abs(data).max(axis=(1, 2))
    is_diag = indices == rows
    dnorm = np.full(E, 1e-300)
    dnorm[rows[is_diag]] = np.maximum(norms[is_diag], 1e-300)
    diag = np.zeros((E, 3, 3))
    diag[rows[is_diag]] = data[is_diag]

    strong = (norms >= drop_tol * np.sqrt(dnorm[rows] * dnorm[indices])
              ) | is_diag
    # cap over-long rows at the max_deg strongest couplings (diagonal
    # always kept); only the offending rows loop in Python
    kdeg = np.zeros(E, np.int64)
    np.add.at(kdeg, rows[strong], 1)
    for e in np.nonzero(kdeg > max_deg)[0]:
        sl = slice(indptr[e], indptr[e + 1])
        idx = np.arange(sl.start, sl.stop)[strong[sl]]
        order = idx[np.argsort(-(norms[idx] + 1e30 * is_diag[idx]))]
        strong[order[max_deg:]] = False
    keep = np.nonzero(strong)[0]
    new_deg = np.zeros(E, np.int64)
    np.add.at(new_deg, rows[keep], 1)
    new_indptr = np.concatenate([[0], np.cumsum(new_deg)])
    cols, vals = _ragged_to_padded(new_indptr, indices[keep], data[keep], E)
    # zero slots (padding) become harmless self references
    pad = np.abs(vals).max(axis=(2, 3)) == 0
    cols = np.where(pad, np.arange(E)[:, None], cols)
    return cols, vals, diag


def build_hierarchy(data: StencilData, dof_coords: np.ndarray,
                    max_dense_dof: int = 4096, omega: float = 0.8,
                    sweeps: int = 2, dtype=np.float32,
                    max_levels: int = 12,
                    smooth_p: bool = True,
                    strength: float = 0.0,
                    always: bool = False,
                    drop_tol: float = 1e-4,
                    target: int = 4) -> AggHierarchy:
    """Aggregation hierarchy under one stencil level.

    Args:
      data: the (geometric) coarsest level's stencil blocks
      dof_coords: (U, C, 2, 3) node coordinates of that level's children
      max_dense_dof: stop and invert densely at/below this many DOF
      smooth_p: Jacobi-smooth the tentative prolongation (classical SA:
        P = (I - 4/(3 lam_max) D^-1 A) P_tent).  Unsmoothed aggregation
        contracts at ~0.7/cycle on SIP diffusion; smoothing restores
        mesh-independent rates at the cost of one extra ring of coarse
        couplings (still fixed degree).

    Note on the transfer layout: with smooth_p the true prolongation is no
    longer the block-diagonal (agg, Pb) pair, so each AggLevel additionally
    stores it as a padded row operator (p_cols/p_vals: fine dof -> coarse
    aggregates it interpolates from); restriction is its transpose, stored
    the same way (r_cols/r_vals).
    """
    A, E = _csr_from_stencil(data)
    U, C = data.self_blocks.shape[:2]
    xy = dof_coords.transpose(0, 1, 3, 2).reshape(E, 3, 2)
    B = np.concatenate([np.ones((E, 3, 1)), xy], axis=2)   # (E, 3dof, 3ns)

    levels: list[AggLevel] = []
    fine: dict | None = None
    from scipy import sparse
    for _ in range(max_levels):
        # ``always`` (amg mode) coarsens at least once even when the fine
        # system is already small — the caller wants a correction, and a
        # hierarchy with zero levels provides none
        if A.shape[0] <= max_dense_dof and (levels or not always):
            break
        adj = _element_graph(A, E, strength=strength)
        agg = _aggregate(adj, E, target=target)
        na = int(agg.max()) + 1
        if na >= E:              # no coarsening possible
            break
        Pb, Bc = _tentative_P(agg, B)
        # sparse tentative P: rows 3E, cols 3na
        rows = np.repeat(np.arange(E) * 3, 9) + np.tile(
            np.repeat(np.arange(3), 3), E)
        cols_p = np.repeat(agg * 3, 9) + np.tile(np.arange(3), 3 * E)
        P = sparse.csr_matrix((Pb.reshape(-1), (rows, cols_p)),
                              shape=(3 * E, 3 * na))
        w_smooth = 0.0
        if smooth_p:
            dinv_s = 1.0 / np.maximum(np.abs(A.diagonal()), 1e-300)
            DA = sparse.diags(dinv_s) @ A
            lam = _power_lam(DA)
            w_smooth = 4.0 / (3.0 * lam)
            P = (P - w_smooth * (DA @ P)).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.sum_duplicates()
        # relabel aggregates by MINIMUM member id: keeps the coarse order
        # ALIGNED with the fine (RCM) order, so the gathers of the level
        # operator AND both transfers stay local in memory.  (A
        # coarse-graph RCM tightens the operator band but decorrelates
        # coarse-vs-fine ids.)
        first = np.full(na, E, np.int64)
        np.minimum.at(first, agg, np.arange(E))
        perm = np.argsort(first, kind="stable")          # new k = old perm[k]
        inv_p = np.argsort(perm)
        perm3 = (3 * perm[:, None] + np.arange(3)).ravel()
        Ac = Ac[perm3][:, perm3].tocsr()
        P = P[:, perm3].tocsr()
        Bc = Bc[perm]
        agg = inv_p[agg]
        if not levels and smooth_p:
            # factored FINE transfers: member-sum tentative tables (pad
            # slots repeat the first member with zero blocks) + the Jacobi
            # smoothing weight/diagonal; the fine operator application the
            # factorization needs lives in the caller's stencil fast path
            sizes = np.bincount(agg, minlength=na)
            order = np.argsort(agg, kind="stable")
            bounds = np.concatenate([[0], np.cumsum(sizes)])
            a_of = agg[order]
            pos = np.arange(E) - bounds[a_of]
            m_max = int(sizes.max())
            tr_cols = np.zeros((na, m_max), np.int64)
            tr_vals = np.zeros((na, m_max, 3, 3))
            tr_cols[a_of, pos] = order
            tr_vals[a_of, pos] = Pb[order].swapaxes(-1, -2)
            fine = dict(w=w_smooth, _dinv=dinv_s, _E=E,
                        _r_cols=tr_cols, _r_vals=tr_vals,
                        _p_cols=agg[:, None].copy(), _p_vals=Pb[:, None])
        cols, vals, diag = _padded_operator(Ac, na, drop_tol=drop_tol)
        p_cols, p_vals = _padded_transfer(P, E, na)
        r_cols, r_vals = _padded_transfer(P.T.tocsr(), na, E)
        # spectrally-safe smoothing weight for THIS level's operator,
        # measured on the BLOCK-preconditioned system the smoother runs
        lam_c = _power_lam_blocks(cols, vals, inv3x3(diag))
        levels.append(AggLevel(
            cols=jnp.asarray(cols.astype(np.int32)),
            vals=jnp.asarray(vals.astype(dtype)),
            dinv=jnp.asarray(inv3x3(diag).astype(dtype)),
            agg=jnp.asarray(agg.astype(np.int32)),
            Pb=jnp.asarray(Pb.astype(dtype)),
            p_cols=jnp.asarray(p_cols.astype(np.int32)),
            p_vals=jnp.asarray(p_vals.astype(dtype)),
            r_cols=jnp.asarray(r_cols.astype(np.int32)),
            r_vals=jnp.asarray(r_vals.astype(dtype)),
            n=na,
            omega=min(float(4.0 / (3.0 * lam_c)), omega)))
        A, E, B = Ac, na, Bc

    if fine is not None and levels:
        fine = dict(
            w=fine["w"],
            dinv_t=jnp.asarray(
                fine["_dinv"].reshape(fine["_E"], 3).T.astype(dtype)),
            r_cols=jnp.asarray(fine["_r_cols"].astype(np.int32)),
            r_vals=jnp.asarray(fine["_r_vals"].astype(dtype)),
            p_cols=jnp.asarray(fine["_p_cols"].astype(np.int32)),
            p_vals=jnp.asarray(fine["_p_vals"].astype(dtype)))
    else:
        fine = None

    coarse_inv = None
    coarse_scale = None
    if levels and A.shape[0] <= max_dense_dof:
        # the SIP Galerkin coarse matrix conditions at ~1e6+, so a raw f32
        # inverse apply loses most digits.  Invert the SYMMETRICALLY
        # Jacobi-scaled matrix instead (f64 on host): D^-1/2 A D^-1/2 has
        # its scaling-induced conditioning stripped, the f32 matmuls stay
        # accurate, and vcycle() applies e = S (As)^-1 S r with S = D^-1/2
        s_vec = 1.0 / np.sqrt(np.maximum(np.abs(A.diagonal()), 1e-300))
        As = (A.toarray() * s_vec[None, :]) * s_vec[:, None]
        coarse_inv = jnp.asarray(np.linalg.inv(As).astype(dtype))
        coarse_scale = jnp.asarray(s_vec.astype(dtype))
    return AggHierarchy(levels=levels, coarse_inv=coarse_inv,
                        coarse_scale=coarse_scale,
                        omega=omega, sweeps=sweeps, fine=fine)


def _power_lam_blocks(cols, vals, dinv, iters: int = 15,
                      seed: int = 0) -> float:
    """lam_max(Dblock^-1 A) for the padded block operator (numpy)."""
    N = cols.shape[0]
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N, 3))

    def apply_(x):
        y = np.einsum("ndij,ndj->ni", vals, x[cols], optimize=True)
        return np.einsum("nij,nj->ni", dinv, y, optimize=True)

    for _ in range(iters):
        w = apply_(v)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        v = w / nw
    return max(float(np.linalg.norm(apply_(v))) * 1.1, 1e-12)


def _power_lam(DA, iters: int = 15, seed: int = 0) -> float:
    """lam_max(D^-1 A) by power iteration (scipy matvecs)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=DA.shape[0])
    for _ in range(iters):
        w = DA @ v
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        v = w / nw
    return max(float(np.linalg.norm(DA @ v)), 1e-12)


def _ragged_to_padded(indptr, indices, data, n_rows: int):
    """Vectorized CSR-blocks -> zero-padded (cols (N, D), vals (N, D, b, b))."""
    deg = np.diff(indptr)
    D = int(deg.max()) if len(deg) and deg.max() > 0 else 1
    b = data.shape[-1] if data.ndim == 3 else 1
    cols = np.zeros((n_rows, D), np.int64)
    vals = np.zeros((n_rows, D, b, b))
    if len(indices):
        rows = np.repeat(np.arange(n_rows), deg)
        pos = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
        cols[rows, pos] = indices
        vals[rows, pos] = data
    return cols, vals


def _padded_transfer(P, n_rows_blk: int, n_cols_blk: int):
    """Scalar CSR transfer -> padded block-row tables.

    Returns (cols (N, D) int32 block-column ids, vals (N, D, 3, 3)) such
    that y[e] = sum_d vals[e, d] @ x[cols[e, d]] reproduces P (or P^T).
    """
    Pb = P.tobsr(blocksize=(3, 3))
    return _ragged_to_padded(Pb.indptr, Pb.indices, Pb.data, n_rows_blk)


# -- device-side cycle -------------------------------------------------------
#
# Every block-row operator (the level operator AND both transfers) is one
# gather of the source rows plus a batched 3x3 einsum, in the transposed
# (3, N) vector contract the fine stencil path uses.


def _rowop_t(cols, vals, x_t):
    """Padded block-row operator in the transposed contract (3, S)->(3, N):
    y[:, n] = sum_d vals[n, d] @ x[:, cols[n, d]]."""
    xg = x_t.T[cols]                                  # (N, D, 3)
    return jnp.einsum("ndij,ndj->in", vals, xg)


def _apply(lvl: AggLevel, x_t):
    """A x for the padded block operator — transposed vectors (3, N)."""
    return _rowop_t(lvl.cols, lvl.vals, x_t)


def _restrict(lvl: AggLevel, r_fine_t):
    return _rowop_t(lvl.r_cols, lvl.r_vals, r_fine_t)


def _prolong(lvl: AggLevel, e_coarse_t):
    return _rowop_t(lvl.p_cols, lvl.p_vals, e_coarse_t)


def _smooth(lvl: AggLevel, x_t, b_t, omega, sweeps):
    # the level's spectral weight, never above the configured omega
    w = min(lvl.omega, omega)
    for _ in range(sweeps):
        r_t = b_t - _apply(lvl, x_t)
        x_t = x_t + w * jnp.einsum("nij,jn->in", lvl.dinv, r_t)
    return x_t


def _smooth_from_zero(lvl: AggLevel, b_t, omega, sweeps):
    """_smooth with x0 = 0: the first sweep's residual IS b, so its
    operator apply is skipped — one fewer rowop per level visit, same
    arithmetic to the last bit."""
    w = min(lvl.omega, omega)
    x_t = w * jnp.einsum("nij,jn->in", lvl.dinv, b_t)
    return _smooth(lvl, x_t, b_t, omega, sweeps - 1) if sweeps > 1 else x_t


def vcycle(h: AggHierarchy, k: int, b_t):
    """Homogeneous-start V-cycle over the aggregation levels.

    ``b_t`` is the fine residual restricted into level k's DOF layout,
    TRANSPOSED (3, N_k); returns the correction in the same layout.
    """
    lvl = h.levels[k]
    x_t = _smooth_from_zero(lvl, b_t, h.omega, h.sweeps)
    r_t = b_t - _apply(lvl, x_t)
    if k + 1 < len(h.levels):
        nxt = h.levels[k + 1]
        ec = vcycle(h, k + 1, _restrict(nxt, r_t))
        x_t = x_t + _prolong(nxt, ec)
    elif h.coarse_inv is not None:
        rs = h.coarse_scale * r_t.T.reshape(-1)
        ec = h.coarse_scale * (h.coarse_inv @ rs)
        x_t = x_t + ec.reshape(r_t.shape[1], 3).T
    x_t = _smooth(lvl, x_t, b_t, h.omega, h.sweeps)
    return x_t


def vcycle_iter(h: AggHierarchy, rc, ncycles: int = 1):
    """ncycles V-cycles on the level-0 aggregation system (transposed)."""
    e = vcycle(h, 0, rc)
    for _ in range(ncycles - 1):
        e = e + vcycle(h, 0, rc - _apply(h.levels[0], e))
    return e


def tent_restrict(h: AggHierarchy, y_fine_t):
    """Tentative (member-sum) restriction P_tent^T y: (3, E) -> (3, na)."""
    f = h.fine
    return _rowop_t(f["r_cols"], f["r_vals"], y_fine_t)


def tent_prolong(h: AggHierarchy, e_t):
    """Tentative prolongation P_tent e: (3, na) -> (3, E)."""
    f = h.fine
    return _rowop_t(f["p_cols"], f["p_vals"], e_t)


def correct_t(h: AggHierarchy, r_fine_t, ncycles: int = 1):
    """Correction for the GEOMETRIC coarsest level from its residual.

    r_fine_t (3, E) -> correction (3, E): restrict into the first
    aggregation level, run ``ncycles`` V-cycles there, prolong back.  A
    fixed linear operator (no inner Krylov), so the enclosing V-cycle
    stays a valid preconditioner.
    """
    lvl0 = h.levels[0]
    rc = _restrict(lvl0, r_fine_t)
    e = vcycle_iter(h, rc, ncycles)
    return _prolong(lvl0, e)


def correct(h: AggHierarchy, r_fine, ncycles: int = 1):
    """Std-layout compatibility wrapper: (E, 3) -> (E, 3)."""
    return correct_t(h, r_fine.T, ncycles).T
