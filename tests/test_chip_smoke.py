"""chip_smoke.py and bench.py helpers that need no card: the stand-in mesh,
the refusal to run without a GPU, the compile-cache rule, the peak table
and the trace reduction.  The phases themselves run here at a tiny size
(their checks are the same as on the card)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from p_a_multigrids_tpu.mesh import structured
from p_a_multigrids_tpu.utils import compile_cache, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stretched_mesh_shape_and_aspect():
    mesh = structured.stretched_mesh()
    assert mesh.num_elements == 8192
    # right triangles with legs 3h (x) by h (y), h = 1/64
    ext = mesh.X.max(axis=2) - mesh.X.min(axis=2)          # (U, 2)
    np.testing.assert_allclose(ext[:, 0], 3.0 / 64)
    np.testing.assert_allclose(ext[:, 1], 1.0 / 64)
    np.testing.assert_allclose(mesh.X[:, 0].max(), 3.0)
    np.testing.assert_allclose(mesh.X[:, 1].max(), 1.0)
    # RCM keeps every cross-macro neighbour within a narrow index band
    u = np.arange(mesh.num_elements)[:, None]
    assert np.abs(mesh.neig - u)[mesh.neig >= 0].max() <= 128


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        profiling.require_gpu(jax.devices("cpu"), "chip_smoke")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compile_cache_rule(monkeypatch, tmp_path):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert compile_cache.configure() == want
    assert jax.config.jax_compilation_cache_dir == want
    # a set variable wins, and the config is left to JAX's own reading
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == want


def test_peak_table():
    h100 = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_gbps"] == 3350.0
    assert "datasheet" in h100["source"]
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks("cpu")


def test_union_ns():
    assert profiling.union_ns([]) == 0.0
    assert profiling.union_ns([(0, 10), (5, 10), (20, 5)]) == 20.0
    assert profiling.union_ns([(0, 100), (10, 5), (50, 10)]) == 100.0


def test_phases_rehearse_at_tiny_size(capsys):
    """Phases 2 and 3 (production PCG, gate, f32-vs-f64 reference) and 4
    (deep split) pass their own checks on a tiny stand-in mesh."""
    mesh = structured.stretched_mesh(8, 8)
    s = chip_smoke.phase_library(mesh, "cpu")
    chip_smoke.phase_reference(mesh, s)
    dof = chip_smoke.phase_deep(structured.stretched_mesh(4, 4), "cpu")
    assert dof == 32 * 256 * 3
    out = capsys.readouterr().out
    assert out.count("PASS") == 6


def test_four_device_phase_rehearses():
    """Phase 5 (sharded production PCG vs serial + the CLI --devices
    route) on four virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    chip_smoke.phase_four(structured.stretched_mesh(8, 8),
                          jax.devices()[:4], "cpu", cli_rows=8)


@pytest.mark.gpu
def test_gpu_operator_matches_f64_reference(gpu):
    """Phase 3 on the card at a small width: float32 stencil operator and
    V-cycle on the GPU vs the float64 einsum reference on the CPU."""
    mesh = structured.stretched_mesh(8, 8)
    s = chip_smoke.solver_for(mesh, 0.05, n_split=2,
                              **chip_smoke.PRODUCTION)
    assert s._stencil[0].S_t.devices() == {gpu}
    chip_smoke.phase_reference(mesh, s)

