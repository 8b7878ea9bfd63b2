"""Smoke run of the semi-structured multigrid solver on one GPU.

    python chip_smoke.py              # phases 1-4 on one card
    python chip_smoke.py --devices 4  # only the four-card phase (5)

Drives the solver's main path through the entry points a user calls, at
the benchmark width (393,216 DOF; 6,291,456 at n_split = 4), and checks
every result by the repository's own means:

1. the CLI (``python -m p_a_multigrids_tpu --mode 9``), in process;
2. the production implicit path through the library (strength-filtered
   aggregation + deg-16 Chebyshev, PCG to a 1e6 residual drop) and the
   manufactured-solution L1 gate;
3. the fine-level operator and one V-cycle in float32 on the GPU against
   the plain einsum reference (``models.semi.apply_A``) in float64 on the
   host CPU device of the same process;
4. the same macro mesh at n_split = 4 (the large-C row-gather path);
5. (``--devices 4``) the distributed solver on a 1-D mesh of four cards
   against the serial solve on one of them, plus the CLI's ``--devices``
   route.

Meshes are generated, never read: the benchmark mesh is a stand-in for
the reference's ``untitled8192.msh`` (8,192 macro triangles stretched
3:1, RCM-ordered).  Times printed here are smoke timings, not benchmark
results.  The last line of stdout is one JSON object naming the device;
any failed check raises, so the script exits non-zero and prints no
result.  Without a GPU it refuses to run.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

from bench import PRODUCTION, pcg_to_drop, solver_for

_T0 = time.time()


def log(msg: str) -> None:
    print(f"[smoke +{time.time() - _T0:7.1f}s] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    log(f"PASS {what}")


def rel_l2(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def run_cli(argv):
    """p_a_multigrids_tpu.__main__.main in process -> its JSON result."""
    from p_a_multigrids_tpu import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# -- phases ------------------------------------------------------------------


def phase_cli(card, rows=64):
    argv = ["--mode", "9", "--rows", str(rows), "--cols", str(rows),
            "--n-split", "2", "--levels", "3", "--ntime", "2", "--dt", "1e8",
            "--krylov", "--krylov-tol", "1e-6"]
    log(f"phase 1: CLI {' '.join(argv)}")
    out = run_cli(argv)
    dof = out["elements"] * out["children"] * 3
    log(f"phase 1: {dof} DOF, L1 {out['L1_error']:.3e}, residual history "
        f"{out['residual_history']}, wall {out['wall_s']} s (smoke timing, "
        f"{card})")
    check(all(v == v and abs(v) != float("inf")
              for v in [out["L1_error"], out["residual"]]),
          "phase 1 result finite")
    check(out["L1_error"] < 0.01, "phase 1 L1 < 0.01")
    return dof


def phase_library(mesh, card):
    import numpy as np

    log("phase 2: production amg + deg-16 Chebyshev on the stand-in mesh "
        "(n_split 2)")
    t0 = time.time()
    s = solver_for(mesh, 0.05, n_split=2, **PRODUCTION)
    log(f"phase 2: setup {time.time() - t0:.2f} s, agg levels "
        f"{[lv.n for lv in s._agg.levels]} (smoke timing, {card})")
    its, rel, secs = pcg_to_drop(s)
    log(f"phase 2: PCG {its} iterations to relative residual {rel:.3e} in "
        f"{secs * 1e3:.2f} ms (smoke timing, {card})")
    check(rel <= 1e-6 and its < 40, "phase 2 PCG reached the 1e6 drop")

    t0 = time.time()
    g = solver_for(mesh, 1e8, n_split=2, multi_levels=3, krylov=True,
                   krylov_tol=1e-9)
    T = g.run()
    l1 = float(np.asarray(g.error(T)).mean())
    log(f"phase 2: gate solve L1 {l1:.3e}, {time.time() - t0:.2f} s with "
        f"setup and compile (smoke timing, {card})")
    check(np.isfinite(np.asarray(T)).all(), "phase 2 gate solution finite")
    check(l1 < 0.01, "phase 2 gate L1 < 0.01")
    return s


def phase_reference(mesh, s_amg):
    """float32 GPU stencil path vs the float64 einsum reference on CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from p_a_multigrids_tpu.config import SemiConfig
    from p_a_multigrids_tpu.models import semi
    from p_a_multigrids_tpu.ops import fused

    log("phase 3: float32 GPU vs float64 CPU reference "
        "(jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision})")
    cpu = jax.devices("cpu")[0]
    cfg = s_amg.cfg
    U, C = mesh.num_elements, 4 ** cfg.n_split
    rng = np.random.default_rng(0)
    x = rng.normal(size=(U, C, 3))

    op = s_amg._stencil[0]
    got = {bc: np.asarray(jax.jit(
        lambda v, bc=bc: fused.from_t(op.apply(fused.to_t(v), bc)))(
            jnp.asarray(x, jnp.float32))) for bc in (False, True)}

    # geometric V-cycle whose coarse solve is the same stationary sweeps on
    # both paths (no dense inverse, no aggregation below)
    vkw = dict(n_split=2, multi_levels=2, coarse_agg=False,
               coarse_direct_max_dof=0)
    s_v = solver_for(mesh, 0.05, **vkw)
    b = s_v._rhs(s_v.initial_condition())
    got_v = np.asarray(jax.jit(lambda v: s_v._vcycle(0, v, b))(
        jnp.asarray(x, jnp.float32)))
    b32 = np.asarray(b)

    with jax.enable_x64(True), jax.default_device(cpu):
        cfg64 = SemiConfig(dt=0.05, ntime=1, n_multigrid=1,
                           dtype="float64", stencil_operator=False,
                           fast_operator=False, **vkw)
        p64 = semi.build_problem(mesh, cfg64)
        L = p64.levels[0]
        x64 = jax.device_put(x, cpu)
        want = {bc: np.asarray(jax.jit(
            lambda v, bc=bc: semi.apply_A(L, cfg.physics, cfg.dt, cfg.theta,
                                          v, bc, semi.structured_gather))(
                x64)) for bc in (False, True)}
        ref = semi.SemiSolver(p64)
        # same Chebyshev intervals as the GPU solver: the comparison is of
        # the arithmetic, not of two spectral estimates
        ref._lam_max = list(s_v._lam_max)
        b64 = ref._rhs(ref.initial_condition())
        want_v = np.asarray(jax.jit(lambda v: ref._vcycle(0, v, b64))(x64))
    e_rhs = rel_l2(b32, np.asarray(b64))
    e_hom, e_bc = rel_l2(got[False], want[False]), rel_l2(got[True],
                                                            want[True])
    e_v = rel_l2(got_v, want_v)
    log(f"phase 3: {U * C * 3} DOF; operator rel L2 {e_hom:.3e} "
        f"(homogeneous), {e_bc:.3e} (with Dirichlet); rhs {e_rhs:.3e}; "
        f"V-cycle {e_v:.3e}")
    check(e_hom <= 1e-5 and e_bc <= 1e-5, "phase 3 operator rel L2 <= 1e-5")
    check(e_v <= 1e-4, "phase 3 V-cycle rel L2 <= 1e-4")


def phase_deep(mesh, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    log("phase 4: stand-in mesh at n_split 4 (C = 256, row-gather path)")
    t0 = time.time()
    s = solver_for(mesh, 1e8, n_split=4, multi_levels=5)
    dof = mesh.num_elements * 256 * 3
    log(f"phase 4: {dof} DOF, setup {time.time() - t0:.2f} s (smoke "
        f"timing, {card})")
    T = s.initial_condition()
    b = s._rhs(T)
    ncyc = 4

    def cycles(x):
        def cyc(x, _):
            x = s._vcycle(0, x, b)
            return x, jnp.max(jnp.abs(s.residual(0, x, b, True)))
        return jax.lax.scan(cyc, x, None, length=ncyc)[1]

    t0 = time.time()
    compiled = jax.jit(cycles).lower(T).compile()
    log(f"phase 4: compile {time.time() - t0:.2f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    r0 = float(jnp.max(jnp.abs(s.residual(0, T, b, True))))
    t0 = time.time()
    norms = np.asarray(jax.block_until_ready(compiled(T)))
    secs = time.time() - t0
    stats = jax.devices()[0].memory_stats() or {}
    log(f"phase 4: residual {r0:.3e} -> {norms.tolist()}; {ncyc} V-cycles "
        f"in {secs * 1e3:.1f} ms (smoke timing, {card}); peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}")
    check(bool(np.isfinite(norms).all()) and norms[-1] < 0.1 * r0
          and bool((np.diff(norms) < 0).all()),
          "phase 4 residual falls every cycle")
    return dof


def phase_four(mesh, devices, card, cli_rows=64):
    import jax
    import numpy as np
    from p_a_multigrids_tpu.config import SemiConfig
    from p_a_multigrids_tpu.ops import fused
    from p_a_multigrids_tpu.parallel.stencil_solver import (
        DistributedStencilSolver)

    n = len(devices)
    log(f"phase 5: DistributedStencilSolver on {n} cards, production amg + "
        "PCG")
    # an implicit step of dt/h^2 ~ 4, solved by PCG to the bench's 1e6
    # drop.  Two f32 solves that sum their dot products in different
    # orders agree only to ~cond(A) * eps: at dt = 0.05 that floor alone is
    # ~2e-5 (serial vs sharded on virtual CPU devices, any tolerance)
    cfg = SemiConfig(n_split=2, dt=1e-3, ntime=1, krylov=True,
                     krylov_tol=1e-6, krylov_maxiter=40, dtype="float32",
                     **PRODUCTION)
    t0 = time.time()
    dist = DistributedStencilSolver(mesh, cfg, devices=devices)
    log(f"phase 5: setup {time.time() - t0:.2f} s (smoke timing, {card})")
    T0_t = dist.initial_condition()
    step = dist.serial._step_t
    T0_one = jax.device_put(T0_t, devices[0])
    out_s = jax.block_until_ready(step(T0_one))
    out_d = jax.block_until_ready(dist.run(T0_t))
    t0 = time.time()
    out_d = jax.block_until_ready(dist.run(T0_t))
    t_d = time.time() - t0
    t0 = time.time()
    out_s = jax.block_until_ready(step(T0_one))
    t_s = time.time() - t0
    a = dist.to_std(out_d)
    b = np.asarray(fused.from_t(out_s))[: dist.n_active]
    err = float(np.abs(a - b).max() / np.abs(b).max())
    log(f"phase 5: PCG to {cfg.krylov_tol:g}, max rel diff {err:.3e}; step {t_d * 1e3:.2f} ms on {n} cards vs "
        f"{t_s * 1e3:.2f} ms on one (smoke timing, {card})")
    check(np.isfinite(a).all(), "phase 5 distributed result finite")
    check(err <= 1e-5, "phase 5 distributed vs serial max rel diff <= 1e-5")

    argv = ["--mode", "9", "--rows", str(cli_rows), "--cols", str(cli_rows),
            "--n-split", "2", "--levels", "1", "--ntime", "2", "--dt", "1e8",
            "--amg",
            "--agg-strength", "0.5", "--cheb-degree", "16", "--cheb-lower",
            "0.05", "--krylov", "--krylov-tol", "1e-6", "--devices", str(n)]
    log(f"phase 5: CLI {' '.join(argv)}")
    out = run_cli(argv)
    log(f"phase 5: CLI L1 {out['L1_error']:.3e}, wall {out['wall_s']} s "
        f"(smoke timing, {card})")
    check(out["devices"] == n, f"phase 5 CLI ran on {n} devices")
    check(np.isfinite(out["L1_error"]) and out["L1_error"] < 0.01,
          "phase 5 CLI L1 < 0.01")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card distributed phase")
    args = ap.parse_args(argv)

    # the f64 reference runs on the host CPU device of this same process,
    # so keep the CPU platform when the platform list is restricted
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    from p_a_multigrids_tpu.utils import compile_cache, profiling

    cache = compile_cache.configure()
    devices = profiling.require_gpu(jax.devices(), "chip_smoke")
    card = profiling.card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}: platform {devices[0].platform}, "
        f"device_kind {devices[0].device_kind!r}, {len(devices)} device(s); "
        f"compile cache {cache}")

    from p_a_multigrids_tpu.mesh import structured
    from p_a_multigrids_tpu.utils import native

    t0 = time.time()
    in_use = native.build(force=True)
    log(f"native library rebuilt from native/ in {time.time() - t0:.1f} s; "
        f"native reader in use: {in_use}")

    mesh = structured.stretched_mesh()
    log(f"mesh: generated stand-in for untitled8192.msh — "
        f"{mesh.num_elements} macro triangles stretched 3:1, RCM-ordered")

    if args.devices == 4:
        if len(devices) < 4:
            raise SystemExit(f"--devices 4: only {len(devices)} visible")
        phase_four(mesh, devices[:4], card)
    else:
        check(phase_cli(card) == 393_216, "phase 1 width is 393,216 DOF")
        s_amg = phase_library(mesh, card)
        phase_reference(mesh, s_amg)
        check(phase_deep(mesh, card) == 6_291_456,
              "phase 4 width is 6,291,456 DOF")
    log(f"all phases passed; card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
