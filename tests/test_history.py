"""Residual-history parity harness (validation/history.py + HISTORY.json).

Pins the contraction behavior of the reference-ACTIVE mode-9 configuration
(Jacobi omega=0.8, corner-average restrictor, surface terms off) across
rounds, and asserts the multigrid-benefit SHAPE of the reference's
level-sweep studies (BASELINE.md: adding levels improves convergence,
3.4-3.7x wall-clock in the reference's tables)."""

import numpy as np
import pytest

from p_a_multigrids_tpu.mesh import topology
from p_a_multigrids_tpu.validation import history


@pytest.fixture(scope="module")
def committed():
    return history.load_committed()


def test_committed_covers_default_specs(committed):
    for path, n_split, levels in history.DEFAULT_SPECS:
        suffix = "amg" if levels == "amg" else f"l{levels}"
        key = f"{path.rsplit('/', 1)[-1]}:s{n_split}:{suffix}"
        assert key in committed, f"HISTORY.json missing {key}"
        assert len(committed[key]["residual_linf"]) >= 10


def test_history_reproduces_committed(committed, mesh_dir):
    """Re-run one fixture and match the committed history (regression
    pin: same solver, same mesh, same f64 arithmetic).  The mesh is the
    generated stand-in for test_sn2.msh (key prefix ``gen_``)."""
    mesh = topology.rcm_reorder(
        topology.from_msh(f"{mesh_dir}/test_sn2.msh"))
    cfg = history.reference_active_config(3, 2, dtype="float64")
    got = history.record_history(mesh, cfg)
    want = committed["gen_test_sn2.msh:s3:l2"]
    np.testing.assert_allclose(got["residual_linf"],
                               want["residual_linf"], rtol=1e-4)
    assert abs(got["rho"] - want["rho"]) < 1e-3


def test_multigrid_benefit_shape(committed):
    """Adding levels must improve (or preserve) the contraction factor on
    every recorded mesh family — the shape behind the reference's 3.4-3.7x
    level-sweep speedups."""
    fams = {}
    for key, rec in committed.items():
        name, s, lv = key.split(":")
        if lv == "amg":          # production pins are not a level family
            continue
        fams.setdefault((name, s), []).append((int(lv[1:]), rec["rho"]))
    assert fams
    for (name, s), entries in fams.items():
        entries.sort()
        rhos = [r for _, r in entries]
        for a, b in zip(rhos, rhos[1:]):
            assert b <= a * 1.05, (
                f"{name} {s}: adding levels worsened rho {a} -> {b}")
        if len(rhos) >= 3:
            # deepest hierarchy materially better than single level
            assert rhos[-1] < rhos[0], (name, s, rhos)


def test_histories_contract(committed):
    """Every recorded history must actually converge (rho < 1)."""
    for key, rec in committed.items():
        assert 0 < rec["rho"] < 1, f"{key}: rho={rec['rho']}"
        r = np.asarray(rec["residual_linf"])
        assert r[-1] < r[0]


def test_production_amg_history_reproduces_committed(committed,
                                                     mesh_dir):
    """Regression pin for the PRODUCTION configuration (full SIP +
    Chebyshev + strength-filtered SA correction of the finest level)."""
    mesh = topology.rcm_reorder(
        topology.from_msh(f"{mesh_dir}/test_sn2.msh"))
    cfg = history.production_config(3, dtype="float64")
    got = history.record_history(mesh, cfg)
    want = committed["gen_test_sn2.msh:s3:amg"]
    np.testing.assert_allclose(got["residual_linf"],
                               want["residual_linf"], rtol=1e-4)
    assert abs(got["rho"] - want["rho"]) < 1e-3
