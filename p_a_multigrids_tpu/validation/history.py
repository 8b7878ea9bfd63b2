"""Residual-history parity harness.

Records per-V-cycle residual Linf histories (the reference's
``get_convergence``, /root/reference/transport_tri_semi.F90:876-889) for
the reference-ACTIVE mode-9 configuration — damped Jacobi omega=0.8,
corner-average restrictor, surface terms disabled (the :619-688 commented
block), manufactured sin(x+y) problem — across the mesh zoo and level
counts.  The committed ``HISTORY.json`` (scripts/record_history.py) pins
the contraction behavior across rounds; tests/test_history.py asserts the
multigrid-benefit SHAPE of the reference's level-sweep studies
(BASELINE.md: 3.4-3.7x from adding levels) and guards against regressions.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import Physics, SemiConfig, Solver


def reference_active_config(n_split: int, levels: int,
                            dt: float = 1.25e-5, **kw) -> SemiConfig:
    """The reference's active mode-9 numerical configuration.

    main.F90:43-47: solver=3 (point relaxation), omega=0.8
    (transport_tri_semi.F90:140), n_smooth=4, corner-average restrictor
    (splitting.F90:10-32), volume-diffusion-only operator (surface flux
    loop commented out, :619-688), dt = CFL*dx of the mode-9 call
    (transport_tri_semi.F90:117-140) — the operator is mass-dominated;
    with surface terms off and dt -> inf the element blocks are singular
    and point relaxation has nothing to converge to.
    """
    phys = Physics(diffusion=True, advection=False, surface_terms=False)
    return SemiConfig(n_split=n_split, multi_levels=levels, dt=dt,
                      ntime=1, n_multigrid=1, solver=Solver.JACOBI,
                      omega=0.8, n_smooth=4, restrictor="corner_average",
                      physics=phys, manufactured=True, **kw)


def record_history(mesh, cfg: SemiConfig, ncycles: int = 12) -> dict:
    """Run ncycles V-cycles; return the residual Linf per cycle + rho."""
    import jax
    import jax.numpy as jnp

    from ..models import semi as msemi

    solver = msemi.SemiSolver(msemi.build_problem(mesh, cfg))
    T = solver.initial_condition()
    b = solver._rhs(T)

    @jax.jit
    def seq(x):
        def cyc(x, _):
            x = solver._vcycle(0, x, b)
            r = solver.residual(0, x, b, True)
            return x, jnp.max(jnp.abs(r))
        return jax.lax.scan(cyc, x, None, length=ncycles)[1]

    norms = np.asarray(seq(T), np.float64)
    pos = norms[norms > 0]
    skip = min(2, len(pos) - 2) if len(pos) > 3 else 0
    rho = float((pos[-1] / pos[skip]) ** (1.0 / max(len(pos) - 1 - skip, 1)))
    return {"residual_linf": norms.tolist(), "rho": rho}


def production_config(n_split: int, **kw) -> SemiConfig:
    """The PRODUCTION numerical configuration (round 4): full SIP physics,
    Chebyshev block-Jacobi smoothing, strength-filtered smoothed-
    aggregation correction of the finest level (config.amg)."""
    return SemiConfig(n_split=n_split, multi_levels=1, dt=1e8, ntime=1,
                      n_multigrid=1, amg=True, agg_strength=0.4,
                      manufactured=True, **kw)


def record_zoo(mesh_specs, ncycles: int = 12) -> dict:
    """Histories over (mesh_path, n_split, levels) specs -> JSON dict.

    ``levels`` may also be the string "amg": the production SA-corrected
    configuration instead of the reference-active geometric one (key
    suffix ``:amg``).
    """
    from ..mesh import topology

    out = {}
    for path, n_split, levels in mesh_specs:
        mesh = topology.rcm_reorder(topology.from_msh(path))
        if levels == "amg":
            cfg = production_config(n_split, dtype="float64")
            key = f"{path.rsplit('/', 1)[-1]}:s{n_split}:amg"
        else:
            cfg = reference_active_config(n_split, levels, dtype="float64")
            key = f"{path.rsplit('/', 1)[-1]}:s{n_split}:l{levels}"
        out[key] = record_history(mesh, cfg, ncycles)
        out[key]["num_macro"] = mesh.num_elements
    return out


DEFAULT_SPECS = [
    # the mode-9 default fixture (transport_tri_semi.F90:99)
    ("/root/reference/Mesh_files/test_sn2.msh", 3, 1),
    ("/root/reference/Mesh_files/test_sn2.msh", 3, 2),
    ("/root/reference/Mesh_files/test_sn2.msh", 3, 4),
    # the level-sweep study family (multigrid_meshes Performance.ods)
    ("/root/reference/Mesh_files/multigrid_meshes/2_split.msh", 4, 1),
    ("/root/reference/Mesh_files/multigrid_meshes/2_split.msh", 4, 2),
    ("/root/reference/Mesh_files/multigrid_meshes/2_split.msh", 4, 4),
    # the bench mesh
    ("/root/reference/Mesh_files/untitled8192.msh", 2, 1),
    ("/root/reference/Mesh_files/untitled8192.msh", 2, 2),
    # PRODUCTION configuration pins (full SIP + Chebyshev + SA correction)
    ("/root/reference/Mesh_files/test_sn2.msh", 3, "amg"),
    ("/root/reference/Mesh_files/multigrid_meshes/2_split.msh", 4, "amg"),
]


def load_committed(path: str = None) -> dict:
    import os
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "HISTORY.json")
    with open(path) as f:
        return json.load(f)
