"""The GMRES polynomial preconditioner of the PyTorch port against
gmres_tpu's, on the CPU, float64.

Tolerances: the modified Leja order of the same root list is JAX's exactly
(the same host numpy code); the harmonic Ritz values within 1e-10 relative
(the Arnoldi reductions sum in another order), as multisets, since the two
roots of a conjugate pair can come out of the eigensolver in either order;
the application within 1e-9 relative of JAX's (the roots' difference,
amplified by the degree-24 product); solves converge where JAX's do, with
iterations within 2, and fail where JAX's fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
from gmres_tpu.precond import polynomial as jpoly
import gmres_tpu_torch as tt
from gmres_tpu_torch.precond import polynomial as tpoly
from tests.torch_parity import rel_err, seeded, to_torch


def _as_multiset(roots):
    return np.sort_complex(np.asarray(roots))


def _dense(seed, d):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    a = (q * np.linspace(1.0, 12.0, d)) @ q.T + 0.3 * rng.standard_normal((d, d))
    return a, rng.standard_normal(d)


def test_modified_leja_order_is_jax():
    rng = np.random.default_rng(5)
    re = rng.uniform(0.5, 8.0, 6)
    im = rng.uniform(0.1, 2.0, 6)
    roots = list(np.concatenate([re + 1j * im, re - 1j * im, rng.uniform(0.1, 8.0, 5)]))
    rng.shuffle(roots)
    np.testing.assert_array_equal(np.asarray(tpoly._modified_leja(list(roots))),
                                  np.asarray(jpoly._modified_leja(list(roots))))


@pytest.mark.parametrize("seed,d", [(0, 12), (3, 10)])
def test_full_degree_is_exact_inverse(seed, d):
    """degree = n: a root at every eigenvalue, so s(A) = A⁻¹ (pins the
    harmonic Ritz roots, the Leja order and the pair fusion at once)."""
    a, r = _dense(seed, d)
    at = torch.as_tensor(a)
    m_t = tt.gmres_polynomial_preconditioner(lambda v: at @ v, to_torch(r), degree=d)
    m_j = gt.gmres_polynomial_preconditioner(lambda v: jnp.asarray(a) @ v, jnp.asarray(r),
                                             degree=d)
    np.testing.assert_allclose(m_t(to_torch(r)).numpy(), np.linalg.solve(a, r), atol=1e-12)
    if seed == 0:  # JAX's case: complex roots occurred
        assert np.abs(m_t.roots.imag).max() > 1e-3
    np.testing.assert_allclose(_as_multiset(m_t.roots), _as_multiset(m_j.roots), rtol=1e-10)
    assert m_t.degree == m_j.degree == d


def test_harmonic_ritz_values_match():
    rng = np.random.default_rng(3)
    d = 10
    a = rng.standard_normal((d, d)) + 6 * np.eye(d)
    probe = rng.standard_normal(d)
    at = torch.as_tensor(a)
    hr_t = tpoly.harmonic_ritz_values(lambda v: at @ v, to_torch(probe), d)
    hr_j = jpoly.harmonic_ritz_values(lambda v: jnp.asarray(a) @ v, jnp.asarray(probe), d)
    np.testing.assert_allclose(_as_multiset(hr_t), _as_multiset(np.linalg.eigvals(a)), rtol=1e-8)
    np.testing.assert_allclose(_as_multiset(hr_t), _as_multiset(hr_j), rtol=1e-10)


@pytest.fixture(scope="module")
def convdiff64():
    n = 64
    opj, opt = gt.convection_diffusion_operator(n), tt.convection_diffusion_operator(n)
    b = np.asarray(opj(jnp.ones((n, n))))
    return n, opj, opt, b


@pytest.mark.parametrize("degree", [8, 24])
def test_convdiff_roots_and_application(convdiff64, degree):
    n, opj, opt, b = convdiff64
    m_j = gt.gmres_polynomial_preconditioner(opj, jnp.asarray(b), degree=degree)
    calls = [0]

    def counted(v):
        calls[0] += 1
        return opt(v)

    m_t = tt.gmres_polynomial_preconditioner(counted, to_torch(b), degree=degree)
    assert calls[0] == degree  # the setup's Arnoldi
    np.testing.assert_allclose(_as_multiset(m_t.roots), _as_multiset(m_j.roots), rtol=1e-10)
    r = seeded(960, (n, n))
    calls[0] = 0
    z = m_t(to_torch(r))
    assert calls[0] == degree  # d applications of A, nothing else
    assert z.dtype == torch.float64 and tuple(z.shape) == (n, n)
    assert rel_err(z, m_j(jnp.asarray(r))) <= 1e-9


@pytest.mark.parametrize("solver", ["gmres", "bicgstab", "cgs", "tfqmr", "bicgstabl"])
def test_degree_24_collapses_convdiff_64(convdiff64, solver):
    """Degree 24 on 64² convection-diffusion converges in a few iterations,
    as in JAX (JAX's test_polynomial.py: GMRES ≤ 25 inner iterations)."""
    n, opj, opt, b = convdiff64
    m_j = gt.gmres_polynomial_preconditioner(opj, jnp.asarray(b), degree=24)
    m_t = tt.gmres_polynomial_preconditioner(opt, to_torch(b), degree=24)
    if solver == "gmres":
        kw = dict(restart=30, tol=1e-9, compute_v_err=False, max_restarts=50, certify="true")
        rj = gt.gmres(opj, jnp.asarray(b), M=m_j, **kw)
        rt = tt.gmres(opt, to_torch(b), M=m_t, **kw)
        its_j = (int(rj.restarts) - 1) * 30 + int(rj.iterations)
        its_t = (rt.restarts - 1) * 30 + rt.iterations
        assert its_t <= 25
    else:
        rj = getattr(gt, solver)(opj, jnp.asarray(b), M=m_j)
        rt = getattr(tt, solver)(opt, to_torch(b), M=m_t)
        its_j, its_t = int(rj.iterations), rt.iterations
    assert rt.status == int(rj.status) == 0
    assert abs(its_t - its_j) <= 2
    np.testing.assert_allclose(rt.x.numpy(), 1.0, atol=1e-7)


def test_too_low_degree_fails_honestly(convdiff64):
    """Degree 8 at 64² misses the lower spectrum (|1 − z·s(z)| > 1 there):
    GMRES must not claim convergence, in the port as in JAX."""
    n, opj, opt, b = convdiff64
    kw = dict(restart=30, tol=1e-9, compute_v_err=False, max_restarts=30, certify="true")
    rj = gt.gmres(opj, jnp.asarray(b), M=gt.gmres_polynomial_preconditioner(
        opj, jnp.asarray(b), degree=8), **kw)
    rt = tt.gmres(opt, to_torch(b), M=tt.gmres_polynomial_preconditioner(
        opt, to_torch(b), degree=8), **kw)
    assert not bool(rj.converged) and not rt.converged
    assert rt.status == int(rj.status)
