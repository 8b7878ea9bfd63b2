"""CLI surface tests: every mode path the reference's main.F90 dispatches
(mode dispatch /root/reference/main.F90:16-51) driven through
``python -m p_a_multigrids_tpu`` in-process."""

import json
import os

import numpy as np
import pytest

from p_a_multigrids_tpu import __main__ as cli


def _run(capsys, argv):
    cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_mode1_with_curves(tmp_path, capsys):
    prefix = str(tmp_path / "DG-rect")
    out = _run(capsys, ["--mode", "1", "--rows", "24", "--cols", "1",
                        "--curves", prefix])
    assert out["mode"] == 1
    assert os.path.exists(prefix)
    assert os.path.exists(prefix + "_analytical")
    # reference curve format: "x value" rows (transport_rect.F90:320-353)
    with open(prefix) as f:
        first = f.readline().split()
    assert len(first) == 2
    float(first[0]), float(first[1])


def test_mode9_fast_path_vtk_series(tmp_path, capsys, mesh_dir):
    vtu = str(tmp_path / "trace.vtu")
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "1", "--levels", "1", "--ntime", "2",
        "--dt", "100000.0", "--vtu", vtu, "--vtk-interval", "1"])
    assert out["mode"] == 9
    assert len(out["residual_history"]) == 2
    assert out["residual_history"][-1] <= out["residual_history"][0]
    # Tracer/error/analytical series + final
    assert len(out["vtu_series"]) == 3
    for p in out["vtu_series"]:
        assert os.path.exists(p)


def test_mode9_checkpoint_resume(tmp_path, capsys, mesh_dir):
    ck = str(tmp_path / "state.npz")
    argv = ["--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
            "--n-split", "1", "--levels", "1", "--ntime", "3",
            "--checkpoint", ck, "--checkpoint-every", "1"]
    base = _run(capsys, argv)
    # interrupt after step 2: rewrite the checkpoint as step-2 state and
    # resume — history continues from there
    from p_a_multigrids_tpu.io import checkpoint as ckpt
    T, step, _, _ = ckpt.load(ck)
    assert step == 3
    resumed = _run(capsys, argv)
    assert resumed["resumed_from_step"] == 3
    assert resumed["residual_history"] == []   # nothing left to do


def test_mode10_runs(capsys, mesh_dir):
    out = _run(capsys, ["--mode", "10", "--mesh",
                        f"{mesh_dir}/test_sn2.msh", "--n-split", "1",
                        "--levels", "1", "--ntime", "1",
                        "--dt", "0.0001"])
    assert out["mode"] == 10
    assert np.isfinite(out["residual"])


def test_mode9_production_config(capsys, mesh_dir):
    """The production solver surface through the CLI: Krylov-accelerated
    implicit steps with W-cycles, explicit smoother knobs (every benched
    production configuration must be CLI-reachable)."""
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "2", "--levels", "2", "--ntime", "2",
        "--dt", "100000.0", "--krylov", "--krylov-tol", "1e-9",
        "--cycle-type", "w", "--cheb-degree", "4", "--n-smooth", "4",
        "--omega", "0.9"])
    assert out["mode"] == 9
    # Krylov-converged steps sit near the requested tolerance immediately
    assert out["residual_history"][-1] < 1e-5
    assert out["L1_error"] < 0.02


def test_mode9_amg_flag(capsys, mesh_dir):
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "2", "--levels", "1", "--ntime", "3",
        "--dt", "100000.0", "--amg", "--agg-strength", "0.3",
        "--n-multigrid", "2"])
    assert out["residual_history"][-1] < out["residual_history"][0]


def test_mode9_distributed_devices(capsys, mesh_dir):
    """--devices 2 routes mode 9 through DistributedStencilSolver on the
    virtual CPU mesh."""
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "2", "--levels", "2", "--ntime", "2",
        "--dt", "100000.0", "--devices", "2"])
    assert out["devices"] == 2
    assert np.isfinite(out["L1_error"])
    assert out["L1_error"] < 0.05


def test_mode9_distributed_amg_combo(capsys, mesh_dir):
    """--devices with --amg: the sharded production configuration through
    the CLI (SA correction + ring halos inside shard_map)."""
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "2", "--levels", "1", "--ntime", "2",
        "--dt", "100000.0", "--devices", "2", "--amg",
        "--agg-strength", "0.3"])
    assert out["devices"] == 2
    assert np.isfinite(out["L1_error"]) and out["L1_error"] < 0.05


def test_mode9_expression_flags(capsys):
    """--ic/--bc/--source/--analytical plumbing (incl. scalar constants
    broadcasting to fields); a few smoothing-only steps move the state
    toward the manufactured solution."""
    out = _run(capsys, [
        "--mode", "9", "--rows", "6", "--cols", "6", "--n-split", "1",
        "--levels", "1", "--ntime", "6", "--dt", "100000.0",
        "--ic", "0", "--bc", "sin(x+y)", "--source", "2*sin(x+y)",
        "--analytical", "sin(x+y)"])
    assert np.isfinite(out["L1_error"])
    assert out["L1_error"] < 0.5
    assert out["residual_history"][-1] < out["residual_history"][0]


def test_mode9_round5_knobs(capsys, mesh_dir):
    """--coarse-pack/--coarse-cheb-degree plumb through to SemiConfig.
    On this tiny mesh the dense coarse inverse engages, so
    packing auto-skips (protected level) and the run must still converge
    — the flags' engagement itself is pinned by tests/test_pack.py."""
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "2", "--levels", "2", "--ntime", "2",
        "--dt", "100000.0", "--n-multigrid", "4",
        "--coarse-pack", "2", "--coarse-cheb-degree", "10",
        "--coarse-cheb-lower", "0.02"])
    assert np.isfinite(out["L1_error"]) and out["L1_error"] < 0.05


def test_mode9_distributed_krylov(capsys, mesh_dir):
    """--devices with --krylov: PCG with psum-reduced dots inside
    shard_map, through the CLI."""
    out = _run(capsys, [
        "--mode", "9", "--mesh", f"{mesh_dir}/test_sn2.msh",
        "--n-split", "2", "--levels", "2", "--ntime", "1",
        "--dt", "100000.0", "--devices", "2", "--krylov",
        "--krylov-tol", "1e-6"])
    assert out["devices"] == 2
    assert np.isfinite(out["L1_error"]) and out["L1_error"] < 0.05
