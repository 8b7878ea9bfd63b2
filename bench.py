"""Benchmark of the semi-structured multigrid solver on one GPU.

    python bench.py            # end-to-end numbers: ONE JSON line on stdout
    python bench.py --layers   # per-layer device times from profiler traces

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device",
"extra"}; phase marks go to stderr.  Refuses to run without a GPU: a CPU
run measures nothing a user pays for.

- The mesh is generated: ``mesh.structured.stretched_mesh()``, 8,192
  macro triangles stretched 3:1 and RCM-ordered, the stand-in for the
  reference's ``untitled8192.msh``.
- Timings loop inside one jit (lax.scan / while_loop) and end in
  ``block_until_ready``; compilation happens before the timed calls.
- `rho` is the asymptotic per-cycle residual contraction of the PRODUCTION
  bare-iteration configuration (no Krylov): strength-filtered SA correction
  of the finest level (config.amg — stretched triangles cap the geometric
  two-grid pair at ~0.6 even with an exact coarse solve, see ops/agg.py).
  `geometric` reports the geometric V-cycle for comparison.
- `l1_err` is the sin(x+y) gate of the reference's validation scripts
  (/root/reference/Check_thermal_analytical_validation.py:25).

Baseline context (BASELINE.md): the reference's multigrid level sweep ran
294,912 DOF for ntime=2, n_multigrid=2 (~4 V-cycle equivalents) in 26.25 s
at its best level count — ~6.5 s per V-cycle, serial -O0 x86.  We run the
stand-in mesh at n_split=2 (393,216 DOF) and scale by DOF ratio.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

_T0 = time.time()


def _mark(msg: str) -> None:
    """Phase timing on stderr (stdout carries only the JSON line)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _device_info() -> dict:
    """Name the device every number below ran on; no GPU is an error."""
    import jax
    from p_a_multigrids_tpu.utils import profiling

    devs = profiling.require_gpu(jax.devices(), "bench.py")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": profiling.card_line()}


def _timed_scan(step, x0, n, reps=3):
    """Min-of-reps seconds per iteration of step, looped inside one jit."""
    import jax

    fn = jax.jit(lambda x: jax.lax.scan(
        lambda c, _: (step(c), None), x, None, length=n)[0].sum())
    jax.block_until_ready(fn(x0))      # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(x0))
        best = min(best, time.time() - t0)
    return best / n


# the production configuration on stretched meshes: strength-filtered SA
# correction of the finest level, deg-16 Chebyshev smoothing
PRODUCTION = dict(multi_levels=1, amg=True, agg_strength=0.5,
                  cheb_degree=16, cheb_lower=0.05)


def solver_for(mesh, dt, **kw):
    from p_a_multigrids_tpu.config import SemiConfig
    from p_a_multigrids_tpu.models import semi as msemi

    cfg = SemiConfig(dt=dt, ntime=1, n_multigrid=1, dtype="float32", **kw)
    problem = msemi.build_problem(mesh, cfg)
    return msemi.SemiSolver(problem)


def _vcycle_stats(solver, n_rho=10, skip=2, n_time=100):
    """(sec/cycle, rho, norms): wall time per V-cycle + ASYMPTOTIC residual
    contraction (geometric mean over cycles skip..n_rho — the first cycles
    flatter any smoother, which is exactly what hides the multigrid
    benefit)."""
    import jax
    import jax.numpy as jnp

    T = solver.initial_condition()
    b = solver._rhs(T)
    per_cycle = _timed_scan(lambda x: solver._vcycle(0, x, b), T, n=n_time)

    @jax.jit
    def resid_seq(x):
        # scan, not unroll: the V-cycle body compiles ONCE regardless of
        # n_rho
        def cycle(x, _):
            x = solver._vcycle(0, x, b)
            r = solver.residual(0, x, b, True)
            return x, jnp.max(jnp.abs(r))
        _, norms = jax.lax.scan(cycle, x, None, length=n_rho)
        return norms
    norms = np.asarray(resid_seq(T), np.float64)
    # plateau-aware f32 floor guard: once the residual sits on float32
    # rounding noise the per-cycle ratios jump to ~1 and no longer measure
    # the iteration.  Trim at the first cycle whose ratio exceeds 0.9.
    ratios = norms[1:] / np.maximum(norms[:-1], 1e-300)
    plateau = np.nonzero(ratios[skip:] > 0.9)[0]
    last = (skip + int(plateau[0])) if len(plateau) else n_rho - 1
    last = max(last, skip + 1)
    with np.errstate(divide="ignore"):
        rho = float((norms[last] / norms[skip]) ** (1.0 / (last - skip)))
    return per_cycle, rho, norms


def _t_to(per_cycle, rho, drop=1e-6):
    return (per_cycle * math.log(drop) / math.log(rho)
            if 0 < rho < 1 else float("inf"))


def _rho_linear(solver, n=8):
    """Spectral contraction of the LINEAR error-propagation operator:
    iterate x <- cycle(x, b=0) from a random unit vector, renormalizing
    every cycle.  Unlike residual histories this never sits on the f32
    rounding floor — each cycle runs at unit scale — so it measures the
    iteration, not the arithmetic."""
    import jax
    import jax.numpy as jnp

    T = solver.initial_condition()
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.normal(size=T.shape).astype(np.asarray(T).dtype))
    zero = jnp.zeros_like(T)

    @jax.jit
    def seq(x):
        def cyc(x, _):
            x = solver._vcycle(0, x, zero, hom=True)
            nrm = jnp.linalg.norm(x)
            return x / jnp.maximum(nrm, 1e-30), nrm
        return jax.lax.scan(cyc, x / jnp.linalg.norm(x), None, length=n)[1]
    factors = np.asarray(seq(x0), np.float64)
    # geometric mean of the post-transient factors
    return float(np.exp(np.mean(np.log(np.maximum(factors[2:], 1e-30)))))


def pcg_to_drop(solver, drop=1e-6, maxiter=40, reps=3):
    """The production IMPLICIT path: PCG preconditioned by the solver's
    V-cycle, from zero to a ``drop`` relative residual (tol is
    ||b||-relative and x0 = 0).  Returns (iterations, relative residual,
    best seconds of one solve, iteration count included)."""
    import jax
    import jax.numpy as jnp
    from p_a_multigrids_tpu.ops import fused

    op = solver._stencil[0]
    b_t = solver._rhs_t(fused.to_t(solver.initial_condition()))
    b_lin = b_t - op.apply(jnp.zeros_like(b_t), True)
    fn = jax.jit(lambda b: solver.krylov_t(b, jnp.zeros_like(b), drop,
                                           maxiter)[1:])
    its, rn = fn(b_lin)
    rel = float(rn) / float(jnp.linalg.norm(b_lin))
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(b_lin))
        best = min(best, time.time() - t0)
    return int(its), rel, best


def main():
    from p_a_multigrids_tpu.mesh import structured
    from p_a_multigrids_tpu.utils import compile_cache, profiling

    compile_cache.configure()
    device = _device_info()
    peak = profiling.peaks(device["kind"])
    _mark(f'device {device}')

    mesh = structured.stretched_mesh()

    # -- geometric V-cycle: 2-level V(4,4), ONE deg-8 coarse Chebyshev
    #    polynomial (lower cut 0.02), coarse level macro-packed 4x
    t0 = time.time()
    solver = solver_for(mesh, dt=0.05, n_split=2, multi_levels=2,
                         coarse_agg=False, coarse_cheb_degree=8,
                         coarse_cheb_lower=0.02, coarse_pack=4)
    setup_s = time.time() - t0
    _mark(f'setup done ({setup_s:.1f}s)')
    per_vcycle, rho_geo, norms_geo = _vcycle_stats(solver)
    _mark('geometric vcycle stats done')

    # -- production bare-iteration config: strength-filtered SA (amg) ------
    s_amg = solver_for(mesh, dt=0.05, n_split=2, **PRODUCTION)
    _mark('amg solver built')
    per_amg, rho_hist, norms_amg = _vcycle_stats(s_amg, n_time=30)
    rho_amg = _rho_linear(s_amg)
    its, _, pcg_s = pcg_to_drop(s_amg)
    amg = {"ms_per_cycle": round(per_amg * 1e3, 3),
           "rho": round(rho_amg, 4),
           "rho_from_history": round(rho_hist, 4),
           "ms_to_1e6": round(_t_to(per_amg, rho_amg) * 1e3, 2),
           "pcg_its_to_1e6": its,
           "pcg_ms_to_1e6": round(pcg_s * 1e3, 2),
           "residual_history": [float(f"{v:.4e}") for v in norms_amg]}
    _mark('amg stats done')

    U = mesh.num_elements
    C = 4 ** 2
    ndof = U * C * 3
    # block-nnz touched per fine operator application (self + 3 face blocks)
    nnz = U * C * 4 * 9
    # V(4,4), cheb degree 6: 12 fine sweeps + residual; coarse at C/4
    apps = 13 + 13 / 4
    op_nnz_s = nnz * apps / per_vcycle
    roof = profiling.operator_roofline(U, C, 3, per_vcycle / apps)

    # XLA gather SpMV on the assembled BSR operator (ops/bsr)
    from p_a_multigrids_tpu.models import semi_assembled
    import jax.numpy as jnp
    A = semi_assembled.assemble_operator(
        solver.p.levels[0], solver.cfg.physics, solver.cfg.dt,
        solver.cfg.theta)
    x0 = jnp.asarray(np.random.default_rng(0).normal(
        size=(U * C, 3)).astype(np.float32))
    spmv_s = _timed_scan(lambda v: A.spmv(v), x0, n=100)
    _mark('spmv bench done')

    # manufactured-solution L1 gate on the bench mesh (sin(x+y), k=1):
    # steady diffusion solved to convergence by V-cycle-preconditioned PCG
    gate_solver = solver_for(mesh, dt=1e8, n_split=2, multi_levels=3,
                              krylov=True, krylov_tol=1e-9)
    Tg = gate_solver.run()
    l1 = float(np.asarray(gate_solver.error(Tg)).mean())
    _mark('gate solve done')

    ref_per_vcycle = 6.5 * (ndof / 294912.0)
    result = {
        "metric": "time_per_vcycle_stretched8192_nsplit2",
        "value": round(per_vcycle * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(ref_per_vcycle / per_vcycle, 2),
        "device": device,
        "extra": {
            "ndof": ndof,
            "setup_s": round(setup_s, 2),
            # production bare-iteration contraction (amg config below)
            "rho": amg["rho"],
            "geometric": {
                "ms_per_cycle": round(per_vcycle * 1e3, 3),
                "rho": round(rho_geo, 4),
                "ms_to_1e6": round(_t_to(per_vcycle, rho_geo) * 1e3, 2),
                "residual_history": [float(f"{v:.4e}")
                                     for v in norms_geo],
            },
            "amg": amg,
            "l1_err": l1,
            "l1_gate_passed": bool(l1 < 0.01),
            "op_gnnz_s": round(op_nnz_s / 1e9, 2),
            "op_achieved_gbps": round(roof.achieved_gbps, 1),
            "op_hbm_share": round(roof.achieved_gbps / peak["hbm_gbps"], 4),
            "spmv_gnnz_s": round(nnz / spmv_s / 1e9, 2),
        },
    }
    print(json.dumps(result))


# -- per-layer device times ----------------------------------------------------


def _device_time(step, carry0, n: int, label: str) -> dict:
    """Device busy time per iteration of ``carry = step(carry)`` looped n
    times in one jit: the union of the kernel intervals in a profiler trace
    of one call, divided by n.  The whole carry feeds the next iteration,
    so XLA can neither hoist nor prune the work."""
    import jax
    from p_a_multigrids_tpu.utils import profiling

    run = jax.jit(lambda c0: jax.lax.scan(
        lambda c, _: (step(c), None), c0, None, length=n)[0])
    jax.block_until_ready(run(carry0))                 # compile + warm
    t0 = time.time()
    jax.block_until_ready(run(carry0))
    wall = time.time() - t0
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as d:
        with profiling.trace(d):
            jax.block_until_ready(run(carry0))
        busy = profiling.device_busy_ns(d)
    if not busy:
        raise RuntimeError(f"{label}: trace holds no device plane")
    plane = max(busy, key=lambda k: busy[k]["busy_ns"])
    dev_ns = busy[plane]["busy_ns"]
    if dev_ns <= 0:
        raise RuntimeError(f"{label}: no device events on {plane} "
                           f"({busy[plane]['lines']})")
    _mark(f"{label}: {plane} lines {busy[plane]['lines'][:6]}")
    return {"device_us": dev_ns / n / 1e3, "wall_us": wall / n * 1e6}


def _phase_bytes(op, rounds: int) -> int:
    """HBM bytes one Chebyshev phase must move, from shapes: every round
    reads the premultiplied neighbour planes (Fp_t, Xp_t), the strip
    selection table, x and bp, and writes x."""
    planes = sum(int(a.size) * a.dtype.itemsize
                 for a in (op.Fp_t, op.Xp_t, op.strip_sel))
    vec = 3 * op.C * op.U * op.Fp_t.dtype.itemsize
    return rounds * (planes + 3 * vec)


def layers():
    """Section measurements of the fine Chebyshev phase (n_split 2 and 4)
    and the aggregation correction level by level, each beside a plain
    device copy measured in the same process."""
    import jax
    import jax.numpy as jnp

    from p_a_multigrids_tpu.mesh import structured
    from p_a_multigrids_tpu.ops import agg
    from p_a_multigrids_tpu.utils import compile_cache, profiling

    compile_cache.configure()
    device = _device_info()
    peak = profiling.peaks(device["kind"])["hbm_gbps"]
    mesh = structured.stretched_mesh()
    out = {"device": device, "peak_hbm_gbps": peak}

    big = jnp.ones((256 * 2 ** 20,), jnp.float32)      # 1 GiB
    t = _device_time(lambda a: a + 1.0, big, 20, "copy")
    copy_gbps = 2 * big.nbytes / (t["device_us"] * 1e3)
    out["copy"] = dict(t, bytes=2 * big.nbytes, gbps=copy_gbps,
                       hbm_share=copy_gbps / peak)
    _mark(f"copy {out['copy']}")
    del big

    rng = np.random.default_rng(0)
    for n_split in (2, 4):
        s = solver_for(mesh, dt=0.05, n_split=n_split, multi_levels=1,
                        cheb_degree=16, cheb_lower=0.05, coarse_agg=False)
        op = s._stencil[0]
        roots = s._cheb_roots(0)
        x = jnp.asarray(rng.normal(size=(3, op.C, op.U)), jnp.float32)
        b = jnp.asarray(rng.normal(size=(3, op.C, op.U)), jnp.float32)
        t = _device_time(
            lambda v: op.smooth_chebyshev(v, b, roots, 1, True), x, 20,
            f"phase{n_split}")
        nbytes = _phase_bytes(op, len(roots))
        gbps = nbytes / (t["device_us"] * 1e3)
        out[f"fine_phase_nsplit{n_split}"] = dict(
            t, rounds=len(roots), dof=3 * op.C * op.U, bytes=nbytes,
            gbps=gbps, hbm_share=gbps / peak, copy_share=gbps / copy_gbps)
        _mark(f"fine phase n_split {n_split}: "
              f"{out[f'fine_phase_nsplit{n_split}']}")
        del s, op

    s = solver_for(mesh, dt=0.05, n_split=2, **PRODUCTION)
    h = s._agg
    C, U = 16, mesh.num_elements
    r = jnp.asarray(rng.normal(size=(3, C, U)), jnp.float32)
    x0 = jnp.zeros_like(r)
    t = _device_time(lambda v: s._agg_correct_t(0, x0, v), r, 20, "agg")
    out["agg_correction"] = t
    _mark(f"agg correction {t}")

    def rowop_entry(name, cols, vals, n_src):
        cols_b = int(cols.size) * cols.dtype.itemsize
        vals_b = int(vals.size) * vals.dtype.itemsize
        xv = jnp.asarray(rng.normal(size=(3, n_src)), jnp.float32)
        y0 = jnp.zeros((3, cols.shape[0]), jnp.float32)
        # the carried output scales the input, so every row is live
        tt = _device_time(
            lambda y: y + agg._rowop_t(cols, vals, xv * (1 + 1e-30 * y[0, 0])),
            y0, 50, name)
        nbytes = cols_b + vals_b + 4 * 3 * (n_src + cols.shape[0])
        gbps = nbytes / (tt["device_us"] * 1e3)
        return dict(tt, rows=int(cols.shape[0]), width=int(cols.shape[1]),
                    bytes=nbytes, gbps=gbps, hbm_share=gbps / peak)

    E = C * U
    levels = [{"tent_restrict": rowop_entry(
                   "tent_r", h.fine["r_cols"], h.fine["r_vals"], E),
               "tent_prolong": rowop_entry(
                   "tent_p", h.fine["p_cols"], h.fine["p_vals"],
                   h.levels[0].n)}]
    for k, lvl in enumerate(h.levels):
        ent = {"operator": rowop_entry(f"A{k}", lvl.cols, lvl.vals, lvl.n)}
        if k > 0:
            prev = h.levels[k - 1].n
            ent["restrict"] = rowop_entry(f"R{k}", lvl.r_cols, lvl.r_vals,
                                          prev)
            ent["prolong"] = rowop_entry(f"P{k}", lvl.p_cols, lvl.p_vals,
                                         lvl.n)
        levels.append(ent)
        _mark(f"agg level {k}: {ent}")
    out["agg_levels"] = levels
    print(json.dumps(out))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", action="store_true",
                    help="per-layer device times instead of end to end")
    if ap.parse_args().layers:
        layers()
    else:
        main()
