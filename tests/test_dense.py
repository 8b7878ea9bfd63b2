"""Dense/banded solver kit (ops/dense.py) vs numpy references, and the
checkpoint round trip (io/checkpoint.py) — the LinearSolvers.F90 /
restartability inventory items."""

import os

import numpy as np

import jax.numpy as jnp

from p_a_multigrids_tpu.io import checkpoint
from p_a_multigrids_tpu.ops import dense

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tridiag(rng, n):
    lower = rng.normal(size=n)
    upper = rng.normal(size=n)
    diag = np.abs(rng.normal(size=n)) + 4.0   # diagonally dominant
    A = np.diag(diag) + np.diag(lower[1:], -1) + np.diag(upper[:-1], 1)
    return lower, diag, upper, A


def test_thomas_matches_dense_solve():
    rng = np.random.default_rng(0)
    lower, diag, upper, A = _tridiag(rng, 17)
    b = rng.normal(size=17)
    got = np.asarray(dense.thomas(jnp.asarray(lower), jnp.asarray(diag),
                                  jnp.asarray(upper), jnp.asarray(b)))
    np.testing.assert_allclose(got, np.linalg.solve(A, b), rtol=1e-10)


def test_thomas_multiple_rhs():
    rng = np.random.default_rng(1)
    lower, diag, upper, A = _tridiag(rng, 9)
    B = rng.normal(size=(9, 4))
    got = np.asarray(dense.thomas(jnp.asarray(lower), jnp.asarray(diag),
                                  jnp.asarray(upper), jnp.asarray(B)))
    np.testing.assert_allclose(got, np.linalg.solve(A, B), rtol=1e-10)


def test_block_thomas_matches_dense_solve():
    rng = np.random.default_rng(2)
    n, b = 6, 3
    lower = rng.normal(size=(n, b, b)) * 0.2
    upper = rng.normal(size=(n, b, b)) * 0.2
    diag = rng.normal(size=(n, b, b)) * 0.2 + 3.0 * np.eye(b)
    rhs = rng.normal(size=(n, b))
    A = np.zeros((n * b, n * b))
    for i in range(n):
        A[i * b:(i + 1) * b, i * b:(i + 1) * b] = diag[i]
        if i > 0:
            A[i * b:(i + 1) * b, (i - 1) * b:i * b] = lower[i]
        if i < n - 1:
            A[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = upper[i]
    got = np.asarray(dense.block_thomas(
        jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper),
        jnp.asarray(rhs))).reshape(-1)
    np.testing.assert_allclose(got, np.linalg.solve(A, rhs.reshape(-1)),
                               rtol=1e-9)


def test_gauss_invert_lu_agree():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 7, 7)) + 7 * np.eye(7)
    b = rng.normal(size=(5, 7))
    want = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(
        np.asarray(dense.gauss_solve(jnp.asarray(A),
                                     jnp.asarray(b[..., None])))[..., 0],
        want, rtol=1e-8)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", np.asarray(dense.invert(jnp.asarray(A))),
                  b), want, rtol=1e-8)
    f = dense.lu_factor(jnp.asarray(A[0]))
    np.testing.assert_allclose(np.asarray(dense.lu_solve(f, b[0])), want[0],
                               rtol=1e-8)


def test_checkpoint_roundtrip(tmp_path):
    from p_a_multigrids_tpu.config import SemiConfig

    rng = np.random.default_rng(4)
    T = rng.normal(size=(5, 4, 3)).astype(np.float32)
    path = os.path.join(tmp_path, "ck.npz")
    checkpoint.save(path, T, step=7, cfg=SemiConfig(),
                    extra={"residual": np.asarray([1.0, 0.5])})
    T2, step, meta, extras = checkpoint.load(path)
    np.testing.assert_array_equal(T2, T)
    assert step == 7
    assert meta["cfg"]["n_split"] == 1
    np.testing.assert_array_equal(extras["residual"], [1.0, 0.5])


def test_checkpoint_resume_matches_straight_run(tmp_path, mesh_dir):
    """CLI --checkpoint: run 4 steps; rerun resuming from step 2 -> equal."""
    import json
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ck = os.path.join(tmp_path, "run.npz")
    base = [sys.executable, "-m", "p_a_multigrids_tpu", "--mode", "9",
            "--mesh", f"{mesh_dir}/test_sn2.msh",
            "--n-split", "1", "--levels", "1", "--cpu"]
    full = subprocess.run(base + ["--ntime", "4"], capture_output=True,
                          text=True, env=env, cwd=ROOT)
    r_full = json.loads(full.stdout.strip().splitlines()[-1])
    subprocess.run(base + ["--ntime", "2", "--checkpoint", ck,
                           "--checkpoint-every", "2"],
                   capture_output=True, text=True, env=env, cwd=ROOT)
    resumed = subprocess.run(
        base + ["--ntime", "4", "--checkpoint", ck, "--checkpoint-every",
                "2"], capture_output=True, text=True, env=env,
        cwd=ROOT)
    r_res = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert r_res["resumed_from_step"] == 2
    np.testing.assert_allclose(r_res["L1_error"], r_full["L1_error"],
                               rtol=1e-5)
    np.testing.assert_allclose(r_res["residual"], r_full["residual"],
                               rtol=1e-4)
