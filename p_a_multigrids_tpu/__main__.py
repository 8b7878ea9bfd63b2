"""CLI entry point — the replacement for the reference's hard-coded mode
dispatch (/root/reference/main.F90:16-51).

    python -m p_a_multigrids_tpu --mode 9 --mesh path/to.msh [options]

Modes mirror the reference:
  1  rect DG advection (trans_rec)
  2  structured-tri explicit   3  structured-tri implicit
  4  unstructured explicit     5  unstructured implicit
  6  advection-diffusion (amin.F90)
  7  semi explicit  8  semi implicit direct
  9  semi implicit iterative multigrid (flagship)
  10 semi implicit assembled (CSR/BSR path)
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="p_a_multigrids_tpu")
    ap.add_argument("--mode", type=int, default=9)
    ap.add_argument("--mesh", type=str, default=None,
                    help=".msh path (modes 4-10); generated mesh otherwise")
    ap.add_argument("--rows", type=int, default=20)
    ap.add_argument("--cols", type=int, default=20)
    ap.add_argument("--n-split", type=int, default=2)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--ntime", type=int, default=2)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--theta", type=float, default=1.0)
    ap.add_argument("--k", type=float, default=1.0)
    ap.add_argument("--u", type=float, nargs=2, default=(0.0, 0.0))
    ap.add_argument("--vtu", type=str, default=None,
                    help="write the final Tracer field to this .vtu")
    ap.add_argument("--curves", type=str, default=None, metavar="PREFIX",
                    help="mode 1: write plain-text curve files "
                         "<PREFIX> and <PREFIX>_analytical (the "
                         "reference's DG-rectangular_structured outputs, "
                         "transport_rect.F90:320-353)")
    ap.add_argument("--vtk-interval", type=int, default=0, metavar="N",
                    help="semi modes: write Tracer/error/analytical VTUs "
                         "every N steps (reference vtk_interval, "
                         "transport_tri_semi.F90:301-312); files are "
                         "<--vtu base>_NNNN.vtu")
    ap.add_argument("--checkpoint", type=str, default=None, metavar="NPZ",
                    help="semi modes: checkpoint the run to this .npz and "
                         "RESUME from it when it already exists")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--ic", type=str, default=None, metavar="EXPR",
                    help="initial condition as an expression of x, y "
                         "(e.g. 'sin(pi*x)*sin(pi*y)')")
    ap.add_argument("--bc", type=str, default=None, metavar="EXPR",
                    help="Dirichlet boundary value expression of x, y")
    ap.add_argument("--source", type=str, default=None, metavar="EXPR",
                    help="volume source expression of x, y")
    ap.add_argument("--analytical", type=str, default=None, metavar="EXPR",
                    help="exact solution expression (for the error field)")
    ap.add_argument("--debug", action="store_true",
                    help="semi modes: checkify sanitizer mode — NaN/Inf "
                         "generation or out-of-bounds indexing raises "
                         "(utils/debugging; the -fbounds-check equivalent, "
                         "reference Makefile:8)")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="wrap the solve in a jax.profiler trace written "
                         "to DIR (view with TensorBoard; the gprof/"
                         "callgrind equivalent, reference Makefile:4-8)")
    # -- production solver surface (semi modes) -----------------------------
    ap.add_argument("--solver", type=str, default=None,
                    choices=["jacobi", "richardson", "gauss_seidel",
                             "block_jacobi", "chebyshev", "direct"],
                    help="smoother/solver kind (default chebyshev)")
    ap.add_argument("--krylov", action="store_true",
                    help="V-cycle-preconditioned PCG/BiCGStab per step")
    ap.add_argument("--krylov-tol", type=float, default=1e-8)
    ap.add_argument("--amg", action="store_true",
                    help="strength-filtered smoothed-aggregation correction "
                         "of the finest level (the production configuration "
                         "on anisotropic meshes)")
    ap.add_argument("--agg-strength", type=float, default=0.4)
    ap.add_argument("--cheb-degree", type=int, default=6)
    ap.add_argument("--cheb-lower", type=float, default=0.1)
    ap.add_argument("--coarse-cheb-degree", type=int, default=None,
                    help="build ONE coarse-level Chebyshev polynomial of "
                         "this degree instead of repeating the fine one "
                         "(config.coarse_cheb_degree)")
    ap.add_argument("--coarse-cheb-lower", type=float, default=None)
    ap.add_argument("--coarse-pack", type=int, default=1,
                    help="macro-pack factor for coarse stencil levels "
                         "(bit-exact relabeling; single-device only)")
    ap.add_argument("--cycle-type", type=str, default="v",
                    choices=["v", "w"])
    ap.add_argument("--restrictor", type=str, default="linear",
                    choices=["linear", "corner_average"])
    ap.add_argument("--no-surface-terms", action="store_true",
                    help="disable DG face terms (the reference's active "
                         "mode-9 configuration, transport_tri_semi.F90:"
                         "619-688 commented out)")
    ap.add_argument("--omega", type=float, default=0.8)
    ap.add_argument("--n-smooth", type=int, default=4)
    ap.add_argument("--n-multigrid", type=int, default=2)
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="mode 9: shard the solve over N devices with the "
                         "distributed stencil solver (0 = serial)")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend even when an accelerator "
                         "is present")
    args = ap.parse_args(argv)

    import jax

    from .utils import compile_cache
    compile_cache.configure()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from .config import Physics, RectConfig, SemiConfig, Solver, \
        TransportConfig
    from .mesh import structured, topology

    dtype = "float64" if args.f64 else "float32"
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    def load_mesh():
        if args.mesh and args.mesh.endswith(".geo"):
            from .mesh import geo
            return geo.mesh_geo(args.mesh)
        if args.mesh:
            return topology.from_msh(args.mesh)
        return structured.tri_mesh(args.rows, args.cols, 1.0 / args.rows,
                                   1.0 / args.cols)

    def problem_fns():
        """--ic/--bc/--source/--analytical strings -> ProblemFns (the
        runtime role of the reference's evaluate.F90 expression engine)."""
        from .config import ProblemFns
        from .utils.expressions import Expression

        def comp(text):
            return Expression(text) if text else None
        return ProblemFns(ic=comp(args.ic), bc=comp(args.bc),
                          source=comp(args.source),
                          analytical=comp(args.analytical))

    t0 = time.time()
    out = {"mode": args.mode}
    import contextlib
    prof_ctx = contextlib.nullcontext()
    if args.profile:
        from .utils import profiling
        prof_ctx = profiling.trace(args.profile)
        out["profile_dir"] = args.profile
    ctx_stack = contextlib.ExitStack()
    ctx_stack.enter_context(prof_ctx)
    try:
        out, coords, vals = _dispatch(args, out, dtype, load_mesh,
                                      problem_fns)
    finally:
        # the profiler trace must close even when a solve raises, or the
        # trace directory is left incomplete
        ctx_stack.close()
    out["wall_s"] = round(time.time() - t0, 3)
    if args.vtu:
        from .io import vtu as vtu_io
        fields = {"Tracer": vals}
        vtu_io.write_vtu(args.vtu, coords, fields,
                         cell_type=9 if args.mode == 1 else 5)
        out["vtu"] = args.vtu
    print(json.dumps(out))


def _dispatch(args, out, dtype, load_mesh, problem_fns):
    import dataclasses

    import numpy as np

    from .config import Physics, RectConfig, SemiConfig, Solver, \
        TransportConfig
    if args.mode == 1:
        from .models import transport_rect
        cfg = RectConfig(no_ele_row=args.rows, no_ele_col=args.cols,
                         u=tuple(args.u) if any(args.u) else
                         (2 * 0.01428571, 0.0), dtype=dtype)
        problem, T, dt, ntime = transport_rect.solve(cfg)
        out.update(ntime=ntime, dt=dt,
                   t_range=[float(np.asarray(T).min()),
                            float(np.asarray(T).max())])
        coords, vals = problem.x_all, np.asarray(T)
        if args.curves:
            from .io import curves as curves_io
            curves_io.write_curve(args.curves, coords, vals, two_d=False)
            ana = transport_rect.analytical_comparison(problem, dt, ntime)
            curves_io.write_curve(f"{args.curves}_analytical", coords,
                                  np.asarray(ana), two_d=False)
            out["curves"] = [args.curves, f"{args.curves}_analytical"]
    elif args.mode in (2, 3, 4, 5, 6):
        from .mesh import splitting
        from .models import transport
        mesh = load_mesh()
        cfg = TransportConfig(
            ntime=args.ntime, dt=args.dt, u=tuple(args.u), k=args.k,
            diffusion=args.mode == 6 or args.k != 0.0,
            implicit=args.mode in (3, 5, 6), theta=args.theta, dtype=dtype)
        solver, T = transport.solve(mesh, cfg)
        coords = splitting.child_coords(mesh.X, 0).reshape(-1, 2, 3)
        vals = np.asarray(T).reshape(-1, 3)
        out.update(elements=mesh.num_elements)
    elif args.mode in (7, 8, 9, 10):
        from .io import vtu as vtu_io
        from .models import semi, semi_assembled
        mesh = load_mesh()
        fns = problem_fns()
        cfg = SemiConfig(
            n_split=args.n_split, multi_levels=args.levels,
            ntime=args.ntime, dt=args.dt or 1.25e-5, theta=args.theta,
            n_multigrid=args.n_multigrid, n_smooth=args.n_smooth,
            omega=args.omega, cheb_degree=args.cheb_degree,
            cheb_lower=args.cheb_lower, cycle_type=args.cycle_type,
            restrictor=args.restrictor, krylov=args.krylov,
            krylov_tol=args.krylov_tol, amg=args.amg,
            agg_strength=args.agg_strength,
            coarse_cheb_degree=args.coarse_cheb_degree,
            coarse_cheb_lower=args.coarse_cheb_lower,
            coarse_pack=args.coarse_pack,
            physics=Physics(k=args.k, u=tuple(args.u),
                            advection=any(args.u),
                            surface_terms=not args.no_surface_terms),
            fns=fns, manufactured=all(
                v is None for v in (args.ic, args.bc, args.source)),
            dtype=dtype, debug=args.debug)
        if args.solver:
            cfg = dataclasses.replace(cfg, solver=Solver(args.solver))
        if args.devices and args.mode == 9:
            return _run_distributed(args, out, mesh, cfg)
        if args.mode == 7:
            cfg = dataclasses.replace(
                cfg, theta=0.0, multi_levels=1, n_multigrid=1, n_smooth=1,
                omega=1.0, solver=Solver.BLOCK_JACOBI)
        coords = vtu_io.semi_coords(mesh.X, args.n_split)

        if args.mode == 8:
            solver, T = semi_assembled.direct_solve(mesh, cfg)
        else:
            problem = semi.build_problem(mesh, cfg)
            cls = (semi_assembled.AssembledSemiSolver if args.mode == 10
                   else semi.SemiSolver)
            solver = cls(problem)

            def write_series(T_now, step):
                """Tracer + error + analytical point fields, the
                get_vtk_files.F90:44-84 set, every vtk_interval steps."""
                base = (args.vtu or "out.vtu")[: -4]
                fields = {
                    "Tracer": np.asarray(T_now).reshape(-1, 3),
                    "error": np.asarray(
                        solver.error(T_now)).reshape(-1, 3),
                    "analytical": np.asarray(
                        solver.p.analytical).reshape(-1, 3),
                }
                vtu_io.write_vtu(f"{base}_{step:04d}.vtu", coords, fields,
                                 cell_type=5)
                out.setdefault("vtu_series", []).append(
                    f"{base}_{step:04d}.vtu")

            import os

            import jax
            import jax.numpy as jnp

            from .io import checkpoint as ckpt
            T = solver.initial_condition()
            start = 0
            if args.checkpoint and os.path.exists(args.checkpoint):
                T_np, start, _, _ = ckpt.load(args.checkpoint)
                T = jnp.asarray(T_np)
                out["resumed_from_step"] = start
            hist = []
            # transposed fast path (mode 9): the state stays in the
            # transposed layout across steps; layout conversion happens
            # only for IO events, not per step (SemiSolver.run's strategy)
            use_t = args.mode == 9 and getattr(solver, "_use_t_cycle",
                                               False)
            if use_t:
                from .ops import fused
                conv_t = jax.jit(solver.convergence_t)
                T_t = fused.to_t(T)
                for step in range(start, cfg.ntime):
                    if args.vtk_interval and step % args.vtk_interval == 0:
                        write_series(fused.from_t(T_t), step)
                    T_t = solver._step_t(T_t)
                    hist.append(float(conv_t(T_t)))
                    if args.checkpoint and (
                            (step + 1) % args.checkpoint_every == 0
                            or step + 1 == cfg.ntime):
                        ckpt.save(args.checkpoint, fused.from_t(T_t),
                                  step + 1, cfg)
                T = fused.from_t(T_t)
            else:
                for step in range(start, cfg.ntime):
                    if args.vtk_interval and step % args.vtk_interval == 0:
                        write_series(T, step)
                    T = solver._step(T)
                    hist.append(float(solver.convergence(T)))
                    if args.checkpoint and (
                            (step + 1) % args.checkpoint_every == 0
                            or step + 1 == cfg.ntime):
                        ckpt.save(args.checkpoint, T, step + 1, cfg)
            if args.vtk_interval:
                write_series(T, cfg.ntime)
            out["residual_history"] = hist
        err = np.asarray(solver.error(T))
        out.update(elements=mesh.num_elements,
                   children=4 ** args.n_split,
                   L1_error=float(err.mean()),
                   residual=float(solver.convergence(T)))
        vals = np.asarray(T).reshape(-1, 3)
    else:
        raise SystemExit(f"unknown mode {args.mode}")
    return out, coords, vals


def _run_distributed(args, out, mesh, cfg):
    """--devices N entry: mode 9 through DistributedStencilSolver.

    The raw mesh is passed straight through: DistributedStencilSolver
    RCM-reorders it itself in __init__ (stencil_solver.py, the
    ``reorder_elements(mesh, rcm_order(mesh))`` line) — the CLI path gets
    the same banded layout (and therefore the same halo widths) as the
    library path.  The solver also pads the macro axis, so
    VTU/error output goes through its own to_std()/error() helpers.
    """
    import numpy as np

    import jax

    from .io import vtu as vtu_io
    from .parallel.stencil_solver import DistributedStencilSolver

    devices = jax.devices()[: args.devices]
    if len(devices) < args.devices:
        raise SystemExit(f"--devices {args.devices}: only {len(devices)} "
                         f"available")
    solver = DistributedStencilSolver(mesh, cfg, devices=devices)
    T_t = solver.initial_condition()
    start = 0
    import os
    if args.checkpoint and os.path.exists(args.checkpoint):
        T_t, start = solver.load_checkpoint(args.checkpoint)
        out["resumed_from_step"] = start
    for step in range(start, cfg.ntime):
        T_t = solver.step(T_t)
        if args.checkpoint and ((step + 1) % args.checkpoint_every == 0
                                or step + 1 == cfg.ntime):
            solver.save_checkpoint(args.checkpoint, T_t, step + 1)
    err = solver.error(T_t)
    out.update(devices=len(devices), elements=mesh.num_elements,
               children=4 ** cfg.n_split, L1_error=float(err.mean()))
    # coords in the SOLVER's (reordered, padding-stripped) macro order so
    # they match the returned values row for row
    coords = vtu_io.semi_coords(solver.p.grid.macro.X, cfg.n_split)
    coords = coords[: solver.n_active * 4 ** cfg.n_split]
    vals = solver.to_std(T_t).reshape(-1, 3)
    return out, coords, vals


if __name__ == "__main__":
    main()
