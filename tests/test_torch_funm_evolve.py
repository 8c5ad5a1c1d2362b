"""The port's matrix functions and time steppers against gmres_tpu on the same
numpy inputs, on the CPU, float64.

* ``funm_lanczos`` (A^{−1/2}·b) and ``expm_multiply`` (a scalar and a vector
  of times): y within 1e-12 relative of JAX's; Saad's error estimate within
  1e-12·‖b‖ absolute (it falls to rounding once the basis is converged);
  the asymmetry diagnostic at rounding level for a symmetric A and O(1)
  for the convection-diffusion operator in both.
* ``trace_funm`` with JAX's Rademacher probes patched in through
  ``_rademacher``: samples, value and stderr within 1e-12 relative.
* ``theta_evolve`` for each solver (cg on Poisson; bicgstab, gmres, gcrodr
  on convection-diffusion; Crank–Nicolson, 5 steps, save_trajectory): the
  per-step counts within 2 of JAX's, every state of the trajectory within
  1e-10 relative; with a callable forcing and an explicit AB2 term too.
* ``exponential_evolve`` with a constant forcing: u within 1e-12 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.solvers import funm as tfunm
from tests.torch_parity import rel_err, seeded, to_np, to_torch

N = 16


@pytest.mark.parametrize("model", ["poisson", "convdiff"])
def test_funm_lanczos_matches_jax(model):
    b = seeded(1, (N, N))
    ops = {pkg: (pkg.poisson_operator(N) if model == "poisson"
                 else pkg.convection_diffusion_operator(N, 0.4, 0.2)) for pkg in (gt, tt)}
    ref = gt.funm_lanczos(ops[gt], jnp.asarray(b), lambda s: 1 / jnp.sqrt(s), steps=20)
    res = tt.funm_lanczos(ops[tt], to_torch(b), lambda s: 1 / torch.sqrt(s), steps=20)
    assert rel_err(res.y, ref.y) < 1e-12
    assert abs(float(res.error_estimate) - float(ref.error_estimate)) < 1e-12 * np.linalg.norm(b)
    if model == "poisson":
        assert float(res.asymmetry) < 1e-13 and float(ref.asymmetry) < 1e-13
    else:
        assert abs(float(res.asymmetry) - float(ref.asymmetry)) < 1e-12
        assert float(res.asymmetry) > 0.1
    assert res.host_syncs == 1


@pytest.mark.parametrize("t", [0.3, (0.1, 0.5, 2.0)])
def test_expm_multiply_matches_jax(t):
    b = seeded(2, (N, N))
    ref = gt.expm_multiply(gt.poisson_operator(N), jnp.asarray(b), jnp.asarray(t), steps=20)
    res = tt.expm_multiply(tt.poisson_operator(N), to_torch(b), t, steps=20)
    assert tuple(res.y.shape) == tuple(ref.y.shape)
    assert rel_err(res.y, ref.y) < 1e-12
    assert np.max(np.abs(to_np(res.error_estimate) - np.asarray(ref.error_estimate))) \
        < 1e-12 * np.linalg.norm(b)


def test_trace_funm_matches_jax_with_its_probes(monkeypatch):
    z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (6, N, N), dtype=jnp.float64))
    monkeypatch.setattr(tfunm, "_rademacher",
                        lambda n_probes, shape, dtype, device, key: to_torch(z).to(device, dtype))
    ref = gt.trace_funm(gt.poisson_operator(N), jnp.log, jnp.zeros((N, N)), n_probes=6,
                        steps=20)
    res = tt.trace_funm(tt.poisson_operator(N), torch.log,
                        torch.zeros((N, N), dtype=torch.float64), n_probes=6, steps=20)
    assert rel_err(res.samples, ref.samples) < 1e-12
    assert rel_err(res.value, ref.value) < 1e-12
    assert rel_err(res.stderr, ref.stderr) < 1e-12
    assert res.host_syncs == 1  # the probes batched: one read of their Hessenbergs


def test_trace_funm_own_probes_estimate_the_log_det():
    """The port's own probes: the log-det of the 16² Poisson matrix (closed
    form) within 4 standard errors."""
    res = tt.trace_funm(tt.poisson_operator(N), torch.log,
                        torch.zeros((N, N), dtype=torch.float64), n_probes=16, steps=20)
    j = np.arange(1, N + 1)
    lam = 4 - 2 * np.cos(j * np.pi / (N + 1))[:, None] - 2 * np.cos(j * np.pi / (N + 1))[None, :]
    exact = float(np.sum(np.log(lam)))
    assert abs(float(res.value) - exact) < 4 * float(res.stderr)
    assert set(np.unique(to_np(tfunm._rademacher(3, (4,), torch.float64, "cpu", 0)))) <= {-1.0, 1.0}


def _forcing(pkg):
    f = seeded(9, (N, N))
    fj = jnp.asarray(f) if pkg is gt else to_torch(f)
    sin = jnp.sin if pkg is gt else torch.sin
    return lambda t: sin(t) * fj


def _explicit(pkg):
    return lambda u: 0.1 * u * u


# label: (solver, model, extra keyword arguments)
EVOLVE_CASES = {
    "cg": ("cg", "poisson", {}),
    "bicgstab": ("bicgstab", "convdiff", {}),
    "gmres": ("gmres", "convdiff", {}),
    "gcrodr": ("gcrodr", "convdiff", {}),
    "cg-forcing-ab2": ("cg", "poisson", {"forcing": True, "explicit": True}),
    "cg-backward-euler": ("cg", "poisson", {"theta": 1.0, "explicit": True,
                                            "explicit_order": 1}),
}


def _evolve(pkg, label):
    solver, model, kw = EVOLVE_CASES[label]
    kw = dict(kw)
    if kw.pop("forcing", False):
        kw["forcing"] = _forcing(pkg)
    if kw.pop("explicit", False):
        kw["explicit"] = _explicit(pkg)
    L = (pkg.poisson_operator(N) if model == "poisson"
         else pkg.convection_diffusion_operator(N, 2.0, 1.0))
    u0 = seeded(3, (N, N))
    conv = jnp.asarray if pkg is gt else to_torch
    return pkg.theta_evolve(L, conv(u0), dt=1.0, n_steps=5, solver=solver, tol=1e-11,
                            restart=20, recycle_k=4, save_trajectory=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_evolve(label):
    return _evolve(gt, label)


@pytest.mark.parametrize("label", sorted(EVOLVE_CASES))
def test_theta_evolve_matches_jax(label):
    ref = _jax_evolve(label)
    res = _evolve(tt, label)
    assert res.status == int(ref.status) == 0
    assert np.max(np.abs(to_np(res.iterations) - np.asarray(ref.iterations))) <= 2
    assert res.inner_total == int(np.sum(to_np(res.iterations)))
    assert tuple(res.trajectory.shape) == tuple(ref.trajectory.shape)
    for i in range(res.trajectory.shape[0]):
        assert rel_err(res.trajectory[i], ref.trajectory[i]) < 1e-10, i
    assert rel_err(res.u, ref.u) < 1e-10
    assert to_np(res.statuses).tolist() == np.asarray(ref.statuses).tolist()
    assert res.host_syncs > 0


def test_theta_evolve_decays_an_eigenmode_as_the_closed_form():
    """A Poisson eigenmode under Crank–Nicolson: u_n = ρ(λ)^n u0."""
    x = np.sin(np.pi * np.arange(1, N + 1) / (N + 1))
    u0 = np.outer(x, x)
    lam = 2 * (2 - 2 * np.cos(np.pi / (N + 1)))
    dt = 0.5
    rho = (1 - 0.5 * dt * lam) / (1 + 0.5 * dt * lam)
    res = tt.theta_evolve(tt.poisson_operator(N), to_torch(u0), dt=dt, n_steps=4, tol=1e-13)
    assert rel_err(res.u, rho ** 4 * u0) < 1e-10
    assert res.trajectory.numel() == 0


def test_theta_evolve_validates_its_arguments():
    u0 = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tt.theta_evolve(tt.poisson_operator(4), u0, dt=1.0, n_steps=1, solver="x")
    with pytest.raises(ValueError):
        tt.theta_evolve(tt.poisson_operator(4), u0, dt=1.0, n_steps=1, theta=1.5)
    with pytest.raises(ValueError):
        tt.theta_evolve(tt.poisson_operator(4), u0, dt=1.0, n_steps=1, explicit_order=3)


def test_exponential_evolve_matches_jax():
    u0, f = seeded(4, (N, N)), seeded(5, (N, N))
    ref = gt.exponential_evolve(gt.poisson_operator(N), jnp.asarray(u0), dt=0.5, n_steps=3,
                                forcing=jnp.asarray(f), steps=20, save_trajectory=True)
    res = tt.exponential_evolve(tt.poisson_operator(N), to_torch(u0), dt=0.5, n_steps=3,
                                forcing=to_torch(f), steps=20, save_trajectory=True)
    assert rel_err(res.u, ref.u) < 1e-12
    assert rel_err(res.trajectory, ref.trajectory) < 1e-12
    assert np.max(np.abs(to_np(res.error_estimates) - np.asarray(ref.error_estimates))) \
        < 1e-12 * np.linalg.norm(u0)
    assert res.host_syncs == 4  # the forcing propagator and one per step
