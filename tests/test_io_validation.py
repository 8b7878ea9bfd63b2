import os

import numpy as np

from p_a_multigrids_tpu.io import curves, vtu
from p_a_multigrids_tpu.mesh import splitting, structured
from p_a_multigrids_tpu.ops import krylov
from p_a_multigrids_tpu.validation import analytical, gates, probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vtu_writer_roundtrip(tmp_path):
    mesh = structured.tri_mesh(2, 2, 1.0, 1.0)
    coords = splitting.child_coords(mesh.X, 1).reshape(-1, 2, 3)
    E = coords.shape[0]
    vals = np.arange(E * 3, dtype=float).reshape(E, 3)
    path = str(tmp_path / "out.vtu")
    vtu.write_vtu(path, coords, {"Tracer": vals, "error": vals * 0})
    text = open(path).read()
    assert text.count("<DataArray") == text.count("</DataArray>")
    assert f'NumberOfCells="{E}"' in text
    assert "Tracer" in text and "error" in text


def test_vtk_legacy_writer(tmp_path):
    mesh = structured.tri_mesh(2, 1, 1.0, 1.0)
    coords = splitting.child_coords(mesh.X, 0).reshape(-1, 2, 3)
    path = str(tmp_path / "out.vtk")
    vtu.write_vtk_legacy(path, coords, "Tracer",
                         np.zeros((coords.shape[0], 3)))
    text = open(path).read()
    assert "DATASET UNSTRUCTURED_GRID" in text
    assert "SCALARS Tracer" in text


def test_curve_writer(tmp_path):
    coords = np.zeros((2, 2, 3))
    coords[:, 0, :] = [[0, 1, 2], [3, 4, 5]]
    path = str(tmp_path / "curve")
    curves.write_curve(path, coords, np.ones((2, 3)), two_d=False)
    lines = open(path).read().strip().split("\n")
    assert len(lines) == 6


def test_probe_samples_linear_exactly():
    mesh = structured.tri_mesh(4, 4, 0.25, 0.25)
    coords = splitting.child_coords(mesh.X, 0).reshape(-1, 2, 3)
    f = lambda x, y: 2 * x - y + 0.3
    vals = f(coords[:, 0, :], coords[:, 1, :])
    pts = np.asarray([[0.1, 0.2], [0.5, 0.5], [0.93, 0.11]])
    out = probe.sample_points(coords, vals, pts)
    assert np.allclose(out, f(pts[:, 0], pts[:, 1]), atol=1e-12)


def test_breakthrough_formula_limits():
    # at x=0 the solution is 1 for all t > 0 (Dirichlet inlet)
    assert np.isclose(analytical.breakthrough_erfc(0.0, 0.1), 1.0, atol=1e-6)
    # mid-column it vanishes at early time (near x=2 the reference
    # formula's image terms leave a small outlet artifact — it is only
    # ever probed on x in [0, 1])
    assert analytical.breakthrough_erfc(1.5, 0.001) < 1e-10


def test_gates():
    g = gates.check([1.0, 1.005], [1.0, 1.0])
    assert g.passed and "works OK" in str(g)
    g2 = gates.check([1.0, 2.0], [1.0, 1.0])
    assert not g2.passed


def test_pcg_and_bicgstab():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    n = 40
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.normal(size=(n,))
    x, it, res = krylov.pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                            jnp.zeros(n), tol=1e-10)
    assert np.allclose(A @ np.asarray(x), b, atol=1e-6)
    N = A + 5 * np.triu(rng.normal(size=(n, n)), 1)   # nonsymmetric
    x2, _, _ = krylov.bicgstab(lambda v: jnp.asarray(N) @ v, jnp.asarray(b),
                               jnp.zeros(n), tol=1e-12, maxiter=400)
    assert np.allclose(N @ np.asarray(x2), b, atol=1e-5)


def test_cli_vtk_interval_series(tmp_path, mesh_dir):
    """--vtk-interval writes Tracer/error/analytical VTUs per interval
    (reference vtk_interval, transport_tri_semi.F90:301-312)."""
    import json
    import os
    import subprocess
    import sys

    base = os.path.join(tmp_path, "series.vtu")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "p_a_multigrids_tpu", "--mode", "9",
         "--mesh", f"{mesh_dir}/test_sn2.msh",
         "--n-split", "1", "--levels", "1", "--ntime", "4", "--cpu",
         "--vtk-interval", "2", "--vtu", base],
        capture_output=True, text=True, env=env, cwd=ROOT)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    series = out["vtu_series"]
    assert len(series) == 3          # steps 0, 2 and the final state
    for path in series:
        text = open(path).read()
        for field in ("Tracer", "error", "analytical"):
            assert f'Name="{field}"' in text
    assert len(out["residual_history"]) == 4
