"""The port's Lanczos bounds and Arnoldi helpers (``solvers/lanczos.py``)
and ``chebyshev_from_lanczos`` against gmres_tpu's, on the CPU, float64.

Tolerances: the bounds, the power-iteration radius and the Arnoldi basis
and Hessenberg within 1e-10 relative (the same recurrences; the
reductions round in another order, and the port solves the small
eigenproblems on a float64 host copy as JAX does in float64); Ritz values
within 1e-8 after sorting (a nonsymmetric eigenproblem amplifies the
Hessenberg's last bits by its condition); the damping ω and the ellipse
interval equal (host numpy on the same Ritz values); the preconditioner
from Lanczos bounds within 1e-10 on a random vector.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
from gmres_tpu.precond.chebyshev import chebyshev_from_lanczos as jax_cfl
from gmres_tpu.solvers import lanczos as jl
import gmres_tpu_torch as tt
from gmres_tpu_torch.precond.chebyshev import chebyshev_from_lanczos
from gmres_tpu_torch.solvers import lanczos as tl
from tests.torch_parity import rel_err, seeded, to_np, to_torch

N = 16


def _dense(a):
    """The same dense operator for both packages."""
    aj, at = jnp.asarray(a), to_torch(a)
    return (lambda v: aj @ v), (lambda v: at @ v)


def _nonsymmetric(n=40):
    """A diagonally dominant nonsymmetric matrix with a complex spectrum."""
    a = seeded(71, (n, n)) * 0.3 + np.diag(np.linspace(2.0, 8.0, n))
    return a


@pytest.mark.parametrize("rigorous", [True, False])
@pytest.mark.parametrize("probe", ["ones", "random"])
def test_lanczos_bounds_match_jax(rigorous, probe):
    p = np.ones((N, N)) if probe == "ones" else seeded(72, (N, N))
    lo_j, hi_j = jl.lanczos_bounds(gt.poisson_operator(N), jnp.asarray(p), 20, rigorous)
    lo_t, hi_t = tl.lanczos_bounds(tt.poisson_operator(N), to_torch(p), 20, rigorous)
    assert lo_t.dtype == hi_t.dtype == torch.float64 and lo_t.dim() == 0
    np.testing.assert_allclose([float(lo_t), float(hi_t)], [float(lo_j), float(hi_j)],
                               rtol=1e-10, atol=0)
    lam_min, lam_max = tt.poisson_spectral_bounds(N)
    if probe == "random":  # (ones is orthogonal to the 16² top mode)
        assert float(hi_t) >= lam_max * (1 - 1e-12)
    if rigorous:
        assert 0.0 <= float(lo_t) <= lam_min


def test_lanczos_breakdown_freezes_and_pads():
    """Three distinct eigenvalues: β vanishes at step 3, the rest of the
    diagonal is padded with the first Rayleigh quotient."""
    d = np.repeat([1.0, 4.0, 9.0], 10)
    a = np.diag(d)
    aj, at = _dense(a)
    p = np.ones(30)
    for rigorous in (True, False):
        lo_j, hi_j = jl.lanczos_bounds(aj, jnp.asarray(p), 10, rigorous)
        lo_t, hi_t = tl.lanczos_bounds(at, to_torch(p), 10, rigorous)
        np.testing.assert_allclose([float(lo_t), float(hi_t)],
                                   [float(lo_j), float(hi_j)], rtol=1e-10)
        assert float(hi_t) == pytest.approx(9.0, rel=1e-10)
    assert float(lo_t) == pytest.approx(1.0, rel=1e-10)


def test_power_iteration_bound_matches_jax():
    p = seeded(73, (N, N))
    j = jl.power_iteration_bound(gt.poisson_operator(N), jnp.asarray(p), 50)
    t = tl.power_iteration_bound(tt.poisson_operator(N), to_torch(p), 50)
    assert rel_err(t, j) <= 1e-10
    # A dominant negative eigenvalue still gives a positive radius.
    aj, at = _dense(np.diag([-5.0, 1.0, 2.0]))
    assert float(tl.power_iteration_bound(at, to_torch(np.ones(3)), 200)) == pytest.approx(
        float(jl.power_iteration_bound(aj, jnp.ones(3), 200)), rel=1e-10)


def test_arnoldi_factorization_matches_jax():
    a = _nonsymmetric()
    aj, at = _dense(a)
    p = seeded(74, (40,))
    basis_j, h_j = jl.arnoldi_factorization(aj, jnp.asarray(p), 12)
    basis_t, h_t = tl.arnoldi_factorization(at, to_torch(p), 12)
    assert basis_t.shape == (13, 40) and h_t.shape == (13, 12)
    assert rel_err(basis_t, basis_j) <= 1e-10
    assert rel_err(h_t, h_j) <= 1e-10
    # A·V_k = V_{k+1}·H̄ and V orthonormal.
    v = to_np(basis_t)
    np.testing.assert_allclose(a @ v[:12].T, v.T @ to_np(h_t), atol=1e-12)
    np.testing.assert_allclose(v @ v.T, np.eye(13), atol=1e-13)
    assert rel_err(tl.arnoldi_hessenberg(at, to_torch(p), 12), h_j) <= 1e-10


def test_arnoldi_expand_continues_and_leaves_inputs():
    """Expanding from column 5 of a 5-step factorization gives the 12-step
    one, and the inputs are not modified (JAX's are immutable)."""
    a = _nonsymmetric()
    aj, at = _dense(a)
    p = seeded(75, (40,))
    b5, h5 = tl.arnoldi_factorization(at, to_torch(p), 5)
    basis = torch.zeros((13, 40), dtype=torch.float64)
    basis[:6] = b5
    hmat = torch.zeros((13, 12), dtype=torch.float64)
    hmat[:6, :5] = h5
    before = (basis.clone(), hmat.clone())
    b_t, h_t = tl.arnoldi_expand(at, basis, hmat, 5)
    assert torch.equal(basis, before[0]) and torch.equal(hmat, before[1])
    b_j, h_j = jl.arnoldi_expand(aj, jnp.asarray(to_np(basis)), jnp.asarray(to_np(hmat)), 5)
    assert rel_err(b_t, b_j) <= 1e-10 and rel_err(h_t, h_j) <= 1e-10


def test_ritz_values_omega_and_ellipse_match_jax():
    a = _nonsymmetric()
    aj, at = _dense(a)
    p = seeded(76, (40,))
    rz_j = jl.arnoldi_ritz_values(aj, jnp.asarray(p), 20)
    rz_t = tl.arnoldi_ritz_values(at, to_torch(p), 20)
    assert isinstance(rz_t, np.ndarray) and rz_t.shape == (20,)
    key = lambda z: np.lexsort((np.round(z.imag, 6), np.round(z.real, 6)))  # noqa: E731
    np.testing.assert_allclose(rz_t[key(rz_t)], rz_j[key(rz_j)], rtol=1e-8, atol=1e-8)
    om_j, _ = jl.estimate_jacobi_omega(aj, jnp.asarray(p), diag=5.0, steps=12)
    om_t, _ = tl.estimate_jacobi_omega(at, to_torch(p), diag=5.0, steps=12)
    assert om_t == om_j
    for band in (4.0, None):
        assert tl.chebyshev_ellipse_interval(rz_t, band) == jl.chebyshev_ellipse_interval(rz_t, band)
    # Taller than wide: no real-foci interval.
    tall = np.array([3.0 + 4.0j, 3.0 - 4.0j, 4.0 + 0j])
    assert tl.chebyshev_ellipse_interval(tall) is None is jl.chebyshev_ellipse_interval(tall)


def test_chebyshev_from_lanczos_matches_jax():
    p = np.ones((N, N))
    r = seeded(77, (N, N))
    mj = jax_cfl(gt.poisson_operator(N), jnp.asarray(p), order=2)
    mt = chebyshev_from_lanczos(tt.poisson_operator(N), to_torch(p), order=2)
    assert rel_err(mt(to_torch(r)), mj(jnp.asarray(r))) <= 1e-10
    mj4 = jax_cfl(gt.poisson_operator(N), jnp.asarray(p), order=4, floor=0.05)
    mt4 = chebyshev_from_lanczos(tt.poisson_operator(N), to_torch(p), order=4, floor=0.05)
    assert rel_err(mt4(to_torch(r)), mj4(jnp.asarray(r))) <= 1e-10


def test_lanczos_reads_nothing_in_the_loop(monkeypatch):
    """The recurrence stays on the device: no value is read back to the
    host while the k operator applications run."""
    reads = {"n": 0}
    for name in ("__float__", "__bool__", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, **k):
            reads["n"] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counting)
    op = tt.poisson_operator(N)
    reads_at_application = []

    def watched(v):
        reads_at_application.append(reads["n"])
        return op(v)

    tl.lanczos_bounds(watched, torch.ones((N, N), dtype=torch.float64), 20)
    assert reads_at_application == [0] * 20
