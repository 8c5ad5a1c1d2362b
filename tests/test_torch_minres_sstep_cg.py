"""MINRES and s-step CG of the PyTorch port against gmres_tpu on the same
numpy inputs, on the CPU.

MINRES (float64, and complex128 for a Hermitian A): iterations and status
equal; x within 1e-9 of JAX's relative to max|x|; the residual history
within 1e-6 relative or 1e-12 absolute; the certified residual under tol.
On the two indefinite matrices the Lanczos vectors lose orthogonality and
rounding grows along the history: there the history is held within 1e-8 of
its first entry (absolute), and the count within 1 (the dense 12²
Helmholtz case stops at 58 in gmres_tpu and 59 in the port, x within
1e-12).
Cases mirror tests/test_minres.py: SPD Poisson with and without the
V-cycle, the indefinite dense oracle (gmres_tpu's 12² Helmholtz matrix,
np.linalg.solve to 1e-7), x0 and a zero b (tests/test_minres.py:108), an
indefinite M (BREAKDOWN in both), and a complex Hermitian indefinite
matrix (every Lanczos and Givens scalar real).

s-step CG (float64): iterations and status equal; x within 1e-9 relative;
the history within 1e-6 relative or 1e-13 absolute except at s = 8, whose
monomial basis without a preconditioner amplifies rounding along the
history (x still within 1e-10); the s-step iterate equal to CG's at
cycle boundaries within 1e-9 (tests/test_sstep_cg.py:24). Float32 without a preconditioner at s = 2
and 4: iterations equal (the port's Gram is summed in float32 as JAX's).
With the multigrid cycle, float32 s-step counts follow each package's
rounding (B = M∘A is near the identity, the monomial chains nearly
dependent: gmres_tpu diverges at 64² where the port converges), so no
float32 case takes the cycle.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.helmholtz import helmholtz_lambda_min, helmholtz_matrix
from gmres_tpu.solvers.sstep_cg import sstep_cg as jax_sstep_cg
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _dense(pkg, a):
    mat = jnp.asarray(a) if pkg is gt else to_torch(a)
    return lambda v: (mat @ v.reshape(-1)).reshape(v.shape)


def _hermitian(n=30, seed=80):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    lam = np.linspace(-1.0, 2.0, n)
    lam[n // 2] = 0.37  # away from zero: a well-posed indefinite system
    h = (q * lam) @ q.conj().T
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return 0.5 * (h + h.conj().T), b


# label: (operator, b, keyword arguments).
MINRES_CASES = ("poisson", "poisson-mg", "indefinite", "x0", "zero-b", "indefinite-m",
                "hermitian")


def _minres_call(pkg, label):
    conv = jnp.asarray if pkg is gt else to_torch
    n = 16
    kw = {"tol": 1e-9, "max_iterations": 400}
    if label in ("poisson", "poisson-mg", "x0", "zero-b", "indefinite-m"):
        op = pkg.poisson_operator(n)
        b = np.asarray(gt.poisson_operator(n)(jnp.asarray(seeded(81, (n, n)))))
        if label == "poisson-mg":
            kw["M"] = pkg.poisson_multigrid_preconditioner(n)
        if label == "x0":
            kw["x0"] = conv(0.5 * np.ones((n, n)))
            b = np.asarray(gt.poisson_operator(n)(jnp.ones((n, n))))
        if label == "zero-b":
            b = np.zeros((n, n))
        if label == "indefinite-m":
            kw["M"] = lambda r: -r
    elif label == "indefinite":
        n = 12
        kh2 = 4.0 * helmholtz_lambda_min(n, 0.0)
        op = _dense(pkg, np.asarray(helmholtz_matrix(n, kh2)))
        b = seeded(82, (n, n))
        kw["tol"] = 1e-10
    else:
        h, b = _hermitian()
        op = _dense(pkg, h)
        kw["tol"] = 1e-10
    return pkg.minres(op, conv(b), **kw)


@functools.lru_cache(maxsize=None)
def _jax_minres(label):
    return _minres_call(gt, label)


@pytest.mark.parametrize("label", MINRES_CASES)
def test_minres_matches_jax(label):
    rj, rt = _jax_minres(label), _minres_call(tt, label)
    indefinite = label in ("indefinite", "hermitian")
    assert rt.status == int(rj.status)
    assert abs(rt.iterations - int(rj.iterations)) <= (1 if indefinite else 0)
    assert rt.x.dtype == (torch.complex128 if label == "hermitian" else torch.float64)
    hist_j, hist_t = to_np(rj.residual_history), to_np(rt.residual_history)
    assert rt.residual_history.dtype == torch.float64
    if label == "indefinite-m":
        # β₁² = (r, M r) < 0: NaN from the first step, BREAKDOWN in both.
        assert rt.status == tt.SolverStatus.BREAKDOWN
        assert torch.isnan(rt.x).all() and np.isnan(to_np(rj.x)).all()
        return
    assert rel_err(rt.x, rj.x) <= 1e-9
    k = min(rt.iterations, int(rj.iterations))
    np.testing.assert_allclose(hist_t[:k], hist_j[:k], rtol=1e-6,
                               atol=1e-8 * hist_j[0] if indefinite else 1e-12)
    assert rt.converged and float(rt.residual) < (1e-10 if indefinite else 1e-9)
    if not indefinite:
        np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=1e-5,
                                   atol=1e-13)
    # β₁, one read an iteration and the certification.
    assert rt.host_syncs == rt.iterations + 2


def test_minres_indefinite_dense_oracle():
    n = 12
    kh2 = 4.0 * helmholtz_lambda_min(n, 0.0)
    a = np.asarray(helmholtz_matrix(n, kh2))
    assert np.linalg.eigvalsh(a).min() < 0
    x_star = np.linalg.solve(a, seeded(82, (n, n)).reshape(-1)).reshape(n, n)
    res = _minres_call(tt, "indefinite")
    np.testing.assert_allclose(to_np(res.x), x_star, atol=1e-7)
    # MINRES minimises ‖r‖ over the Krylov space: a non-increasing history.
    hist = to_np(res.residual_history)[: res.iterations]
    assert np.all(np.diff(hist) <= hist[:-1] * 1e-10 + 1e-12)


def test_minres_x0_and_zero_b():
    res = _minres_call(tt, "x0")
    assert res.converged
    np.testing.assert_allclose(to_np(res.x), 1.0, atol=1e-7)
    zero = _minres_call(tt, "zero-b")
    assert zero.converged and zero.iterations == 0
    assert float(zero.residual) == 0.0


def test_minres_hermitian_scalars_are_real():
    """A complex Hermitian indefinite A: the solution solves the system
    (np.linalg.solve to 1e-8) and the residual and its history are real."""
    h, b = _hermitian()
    res = _minres_call(tt, "hermitian")
    np.testing.assert_allclose(to_np(res.x), np.linalg.solve(h, b), atol=1e-8)
    assert not res.residual.is_complex() and not res.residual_history.is_complex()


# label: (grid, s, dtype, tol, multigrid).
SSTEP_CASES = {
    "f64-plain-s3": (16, 3, np.float64, 1e-9, False),
    "f64-mg-s4": (32, 4, np.float64, 1e-10, True),
    "f64-plain-s8": (16, 8, np.float64, 1e-9, False),
    "f32-plain-s2": (32, 2, np.float32, 1e-2, False),
    "f32-plain-s4": (32, 4, np.float32, 1e-2, False),
}


def _sstep_call(pkg, label):
    n, s, dtype, tol, mg = SSTEP_CASES[label]
    conv = jnp.asarray if pkg is gt else to_torch
    b = seeded(83, (n, n)).astype(dtype)
    fn = jax_sstep_cg if pkg is gt else tt.sstep_cg
    m = pkg.poisson_multigrid_preconditioner(n) if mg else None
    return fn(pkg.poisson_operator(n), conv(b), s=s, tol=tol, M=m, max_cycles=400)


@functools.lru_cache(maxsize=None)
def _jax_sstep(label):
    return _sstep_call(gt, label)


@pytest.mark.parametrize("label", sorted(SSTEP_CASES))
def test_sstep_cg_matches_jax(label):
    rj, rt = _jax_sstep(label), _sstep_call(tt, label)
    assert (rt.iterations, rt.status) == (int(rj.iterations), int(rj.status))
    assert rt.converged and float(rt.residual) < SSTEP_CASES[label][3]
    if SSTEP_CASES[label][2] == np.float64:
        assert rel_err(rt.x, rj.x) <= (1e-10 if SSTEP_CASES[label][1] == 8 else 1e-9)
        if SSTEP_CASES[label][1] < 8:
            np.testing.assert_allclose(to_np(rt.residual_history),
                                       to_np(rj.residual_history), rtol=1e-6, atol=1e-13)
    else:
        assert rt.x.dtype == torch.float32 and rel_err(rt.x, rj.x) <= 1e-3
    # The initial residual, then the Gram and the certified residual a cycle.
    assert rt.host_syncs == 1 + 2 * (rt.iterations // SSTEP_CASES[label][1])


def test_sstep_cg_equals_cg_at_cycle_boundaries():
    """cycles·s s-step iterations against as many CG iterations (tol 0 never
    stops either), both in the port and against gmres_tpu's s-step."""
    n, s, cycles = 16, 3, 4
    op = tt.poisson_operator(n)
    b = to_torch(np.asarray(gt.poisson_operator(n)(jnp.asarray(seeded(84, (n, n))))))
    ref = tt.cg(op, b, tol=0.0, max_iterations=s * cycles)
    ca = tt.sstep_cg(op, b, s=s, tol=0.0, max_cycles=cycles)
    assert ca.iterations == s * cycles
    np.testing.assert_allclose(to_np(ca.x), to_np(ref.x), atol=1e-9)
    rj = jax_sstep_cg(gt.poisson_operator(n), jnp.asarray(to_np(b)), s=s, tol=0.0,
                      max_cycles=cycles)
    assert rel_err(ca.x, rj.x) <= 1e-9


def test_sstep_cg_indefinite_breaks_down_honestly():
    """An indefinite A: no CONVERGED claim it cannot certify; the status is
    gmres_tpu's."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    a = (q * np.linspace(-1.0, 2.0, 40)) @ q.T
    b = rng.standard_normal(40)
    rt = tt.sstep_cg(to_torch(a), to_torch(b), s=4, tol=1e-12, max_cycles=60)
    rj = jax_sstep_cg(jnp.asarray(a), jnp.asarray(b), s=4, tol=1e-12, max_cycles=60)
    assert rt.status == int(rj.status)
    assert rt.status != tt.SolverStatus.CONVERGED or float(rt.residual) < 1e-12


def test_sstep_cg_zero_b():
    res = tt.sstep_cg(tt.poisson_operator(8), torch.zeros((8, 8), dtype=torch.float64),
                      s=4, tol=1e-12)
    assert res.converged and res.iterations == 0 and res.host_syncs == 1
