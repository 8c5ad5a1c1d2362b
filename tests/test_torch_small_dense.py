"""The small dense routes of the GMRES family against gmres_tpu, on the CPU:
``ops/tri.py:solve_small`` and ``ops/hessenberg_eig.py``'s ``eig_select``
and ``smallest_invariant_subspace``.

Tolerances: solves within 1e-12 relative of JAX's elimination (a singular
input NaN in both); eigenvalues within 1e-10 relative of JAX's in-jit QR
iteration, eigenvectors compared as spans (|⟨u, v⟩| = 1 within 1e-8, since
their phases differ); invariant subspaces as spans (every singular value of
Z_jᵀZ_t within 1e-10 of 1) with JAX's start block patched into the seam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.ops import hessenberg_eig as jhe
from gmres_tpu.ops.tri import solve_small as jax_solve_small
from gmres_tpu_torch.ops import hessenberg_eig as the
from gmres_tpu_torch.ops.tri import solve_small
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _jax_start(n, k, dtype):
    """JAX's start block, PRNGKey(7), for the port's seam."""
    return to_torch(jax.random.normal(jax.random.PRNGKey(7), (n, k), jnp.float64)).to(dtype)


def _nonsymmetric(seed, n):
    """A well-separated nonsymmetric test matrix with complex pairs."""
    a = seeded(seed, (n, n)) + np.diag(np.arange(1.0, n + 1.0))
    return a


@pytest.mark.parametrize("n,rhs", [(1, "vector"), (7, "vector"), (24, "block"), (64, "vector")])
def test_solve_small_matches_jax(n, rhs):
    a = seeded(1, (n, n)) + n * np.eye(n)
    b = seeded(2, (n,) if rhs == "vector" else (n, 5))
    xj = jax_solve_small(jnp.asarray(a), jnp.asarray(b))
    xt = solve_small(to_torch(a), to_torch(b))
    assert xt.shape == tuple(xj.shape)
    assert rel_err(xt, xj) < 1e-12


def test_solve_small_singular_is_nan_in_both():
    a = seeded(3, (6, 6))
    a[4] = 0.0  # an exactly zero row: an exactly zero pivot
    b = seeded(4, (6,))
    assert np.all(np.isnan(to_np(jax_solve_small(jnp.asarray(a), jnp.asarray(b)))))
    assert torch.isnan(solve_small(to_torch(a), to_torch(b))).all()


def test_solve_small_float32_rhs_takes_matrix_dtype():
    a = seeded(5, (5, 5)) + 5 * np.eye(5)
    x = solve_small(to_torch(a), to_torch(seeded(6, (5,)), "cpu").float())
    assert x.dtype == torch.float64


@pytest.mark.parametrize("which", ["smallest", "largest"])
@pytest.mark.parametrize("n", [12, 40])
def test_eig_select_matches_jax(which, n):
    a = _nonsymmetric(7 + n, n)
    nvec = 5
    vj, uj, okj = jhe.eig_select(jnp.asarray(a), nvec, which=which)
    vt, ut, okt = the.eig_select(to_torch(a), nvec, which=which)
    assert bool(okj) and bool(okt)
    assert vt.dtype == torch.complex128 and ut.shape == (n, nvec)
    vj, vt = to_np(vj), to_np(vt)
    mods = np.abs(vt)
    assert np.all(np.diff(mods) >= 0) if which == "smallest" else np.all(np.diff(mods) <= 0)
    # Sorted by modulus in both; a conjugate pair may come in either order.
    np.testing.assert_allclose(np.abs(vt), np.abs(vj), rtol=1e-10)
    gaps = np.abs(vt[:, None] - vj[None, :]).min(axis=1)
    assert np.all(gaps <= 1e-10 * np.abs(vt))
    ut = to_np(ut)
    np.testing.assert_allclose(np.linalg.norm(ut, axis=0), 1.0, rtol=1e-12)
    # Each column an eigenvector of its value, and the span of JAX's.
    np.testing.assert_allclose(a @ ut, ut * vt[None, :nvec], atol=1e-9 * np.abs(a).max())
    uj = to_np(uj)
    for i in range(nvec):
        j = int(np.argmin(np.abs(vj[:nvec] - vt[i])))
        assert abs(abs(np.vdot(uj[:, j], ut[:, i])) - 1.0) < 1e-8


def test_eig_select_bad_selection_and_nonfinite_input():
    with pytest.raises(ValueError, match="unknown selection"):
        the.eig_select(torch.eye(3, dtype=torch.float64), 1, which="middle")
    a = torch.eye(4, dtype=torch.float64)
    a[1, 2] = float("nan")
    _, _, ok = the.eig_select(a, 2)
    assert not bool(ok)


def test_eig_select_float32_returns_complex64():
    a = to_torch(_nonsymmetric(30, 10)).float()
    vals, vecs, ok = the.eig_select(a, 3)
    assert vals.dtype == vecs.dtype == torch.complex64 and bool(ok)


@pytest.mark.parametrize("n,k", [(12, 4), (30, 10)])
def test_invariant_subspace_with_jax_start_matches_jax(n, k, monkeypatch):
    a = _nonsymmetric(40 + n, n)
    zj, okj = jhe.smallest_invariant_subspace(jnp.asarray(a), k)
    monkeypatch.setattr(the, "_subspace_start", _jax_start)
    zt, okt = the.smallest_invariant_subspace(to_torch(a), k)
    assert bool(okj) and bool(okt)
    sv = np.linalg.svd(to_np(zj).T @ to_np(zt), compute_uv=False)
    np.testing.assert_allclose(sv, 1.0, atol=1e-10)
    assert rel_err(zt, zj) < 1e-10  # the same QR convention: the same columns


def test_invariant_subspace_own_start_is_orthonormal_and_invariant():
    n, k = 30, 6
    # Real eigenvalues 1..n behind a nonsymmetric similarity: the iteration
    # converges at (6/7)^200 ≈ 4e-14.
    s_mat = np.eye(n) + 0.1 * seeded(77, (n, n))
    a = s_mat @ np.diag(np.arange(1.0, n + 1.0)) @ np.linalg.inv(s_mat)
    z, ok = the.smallest_invariant_subspace(to_torch(a), k, iters=200)
    z = to_np(z)
    assert bool(ok)
    np.testing.assert_allclose(z.T @ z, np.eye(k), atol=1e-12)
    # Converged far enough to be invariant: A Z stays in span(Z).
    az = a @ z
    assert np.linalg.norm(az - z @ (z.T @ az)) < 1e-8 * np.linalg.norm(az)
    # Its start block comes from a torch.Generator seeded 7, on the CPU.
    s1, s2 = the._subspace_start(n, k, torch.float64), the._subspace_start(n, k, torch.float64)
    assert torch.equal(s1, s2) and s1.device.type == "cpu"


def test_invariant_subspace_singular_is_zero_and_not_ok():
    a = np.zeros((8, 8))
    z, ok = the.smallest_invariant_subspace(to_torch(a), 3)
    assert not bool(ok) and torch.count_nonzero(z) == 0
