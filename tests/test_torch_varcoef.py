"""The variable-coefficient model, its multigrid cycle and the coarse-space
(deflation) preconditioner in the PyTorch port against gmres_tpu on the
same numpy inputs, on the CPU, float64.

The face coefficients, the operator, its diagonal and ``varcoef_matrix``
are JAX's bit for bit (the same operations in the same order); one cycle
application and one deflated application within 1e-13 of JAX's relative
to max|z|. ``dirichlet_poisson_modes``: the port orders the modes by
(λ, i, j) in one numpy sort where JAX loops over the N² pairs; at 12²
(every λ(i, j) = λ(j, i), and the first 20 modes hold such pairs) the
first 20 modes match JAX's in order within 1e-14. CG (iterations and
status equal, x within 1e-9 relative): Jacobi and Jacobi with the two
inclusion indicators on a 32² high-contrast field (the deflation cut,
tests/test_deflation.py:43), the cycle with and without them, and exact
Poisson modes at 32², where the count falls as k grows
(tests/test_deflation.py:14). P·A acts as the identity on span(W) for
exact modes (1e-12).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.varcoef import varcoef_faces as jax_faces
from gmres_tpu_torch.models.varcoef import varcoef_faces
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _field(n, contrast=1e5):
    """Two square inclusions (the varcoef program's shape) and their
    normalised indicators."""
    c = np.ones((n, n))
    a1 = (slice(n // 6, 5 * n // 12), slice(n // 6, 5 * n // 12))
    a2 = (slice(7 * n // 12, 7 * n // 8), slice(13 * n // 24, 5 * n // 6))
    c[a1] = c[a2] = contrast
    w = np.zeros((2, n, n))
    w[0][a1] = 1.0
    w[1][a2] = 1.0
    return c, w / np.linalg.norm(w.reshape(2, -1), axis=1)[:, None, None]


def _smooth(n, amp=0.9):
    g = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    return 1.0 + amp * np.sin(2 * np.pi * xx) * np.cos(np.pi * yy) ** 2


@pytest.mark.parametrize("kind", ["smooth", "inclusions"])
def test_model_matches_jax(kind):
    n = 16
    c = _smooth(n) if kind == "smooth" else _field(n)[0]
    x = seeded(120, (n, n))
    for ft, fj in zip(varcoef_faces(to_torch(c)), jax_faces(jnp.asarray(c))):
        np.testing.assert_array_equal(to_np(ft), np.asarray(fj))
    np.testing.assert_array_equal(to_np(tt.varcoef_apply(to_torch(c), to_torch(x))),
                                  np.asarray(gt.varcoef_apply(jnp.asarray(c), jnp.asarray(x))))
    np.testing.assert_array_equal(to_np(tt.varcoef_operator(to_torch(c))(to_torch(x))),
                                  np.asarray(gt.varcoef_operator(jnp.asarray(c))(
                                      jnp.asarray(x))))
    np.testing.assert_array_equal(to_np(tt.varcoef_diagonal(to_torch(c))),
                                  np.asarray(gt.varcoef_diagonal(jnp.asarray(c))))
    a = to_np(tt.varcoef_matrix(to_torch(c)))
    np.testing.assert_array_equal(a, np.asarray(gt.varcoef_matrix(jnp.asarray(c))))
    np.testing.assert_allclose(a @ x.reshape(-1), to_np(tt.varcoef_apply(
        to_torch(c), to_torch(x))).reshape(-1), rtol=1e-12, atol=1e-12)


def test_a_field_must_be_a_tensor():
    with pytest.raises(TypeError, match="tensor"):
        tt.varcoef_operator(np.ones((8, 8)))


@pytest.mark.parametrize("kind", ["smooth", "inclusions"])
def test_cycle_matches_jax(kind):
    n = 64
    c = _smooth(n) if kind == "smooth" else _field(n)[0]
    r = seeded(121, (n, n))
    mt = tt.varcoef_multigrid_preconditioner(to_torch(c))
    mj = gt.varcoef_multigrid_preconditioner(jnp.asarray(c))
    assert rel_err(mt(to_torch(r)), mj(jnp.asarray(r))) <= 1e-13


@functools.lru_cache(maxsize=None)
def _varcoef_cg(pkg_name, precond):
    """CG on the 32² inclusion field, tol 1e-10·‖b‖ (the program's
    problem at a test's size)."""
    pkg = gt if pkg_name == "jax" else tt
    conv = jnp.asarray if pkg is gt else to_torch
    n = 32
    c, w = _field(n)
    op = pkg.varcoef_operator(conv(c))
    diag = pkg.varcoef_diagonal(conv(c))
    b = np.asarray(gt.varcoef_operator(jnp.asarray(c))(jnp.asarray(seeded(122, (n, n)))))
    inner = {"jacobi": lambda r: r / diag,
             "mg": pkg.varcoef_multigrid_preconditioner(conv(c))}[precond.split("+")[0]]
    m = pkg.coarse_space_preconditioner(op, conv(w), M=inner) if "+defl" in precond else inner
    return pkg.cg(op, conv(b), tol=1e-10 * float(np.linalg.norm(b)), max_iterations=5000,
                  M=m)


@pytest.mark.parametrize("precond", ["jacobi", "jacobi+defl", "mg", "mg+defl"])
def test_cg_on_inclusions_matches_jax(precond):
    rj, rt = _varcoef_cg("jax", precond), _varcoef_cg("torch", precond)
    assert (rt.iterations, rt.status) == (int(rj.iterations), int(rj.status)) and rt.converged
    assert rel_err(rt.x, rj.x) <= 1e-9


def test_indicator_deflation_cuts_jacobi():
    jac, defl = _varcoef_cg("torch", "jacobi"), _varcoef_cg("torch", "jacobi+defl")
    assert defl.iterations * 1.5 < jac.iterations


def test_modes_match_jax_in_order():
    n, k = 12, 20
    mt = to_np(tt.dirichlet_poisson_modes(n, k, device="cpu"))
    mj = np.asarray(gt.dirichlet_poisson_modes(n, k))
    assert mt.shape == (k, n, n)
    np.testing.assert_allclose(mt, mj, atol=1e-14)


@functools.lru_cache(maxsize=None)
def _poisson_cg(pkg_name, k):
    pkg = gt if pkg_name == "jax" else tt
    conv = jnp.asarray if pkg is gt else to_torch
    n = 32
    op = pkg.poisson_operator(n)
    b = np.asarray(gt.poisson_operator(n)(jnp.ones((n, n))))
    m = None
    if k:
        modes = (gt.dirichlet_poisson_modes(n, k) if pkg is gt
                 else tt.dirichlet_poisson_modes(n, k, device="cpu"))
        m = pkg.coarse_space_preconditioner(op, modes)
    return pkg.cg(op, conv(b), tol=1e-10, M=m)


@pytest.mark.parametrize("k", [0, 4, 16])
def test_exact_modes_cut_cg_iterations(k):
    rj, rt = _poisson_cg("jax", k), _poisson_cg("torch", k)
    assert (rt.iterations, rt.status) == (int(rj.iterations), int(rj.status)) and rt.converged
    assert rel_err(rt.x, rj.x) <= 1e-9
    if k:
        assert rt.iterations < _poisson_cg("torch", {4: 0, 16: 4}[k]).iterations


def test_deflation_is_the_identity_on_the_coarse_space():
    n, k = 16, 6
    op = tt.poisson_operator(n)
    w = tt.dirichlet_poisson_modes(n, k, device="cpu")
    p = tt.coarse_space_preconditioner(op, w)
    for i in range(k):
        torch.testing.assert_close(p(op(w[i])), w[i], rtol=0, atol=1e-12)
    r = seeded(123, (n, n))
    pj = gt.coarse_space_preconditioner(gt.poisson_operator(n), gt.dirichlet_poisson_modes(n, k))
    assert rel_err(p(to_torch(r)), pj(jnp.asarray(r))) <= 1e-13


def test_deflation_validation():
    with pytest.raises(ValueError, match="k, \\*shape"):
        tt.coarse_space_preconditioner(tt.poisson_operator(8),
                                       torch.ones(8, dtype=torch.float64))
