"""``implicit_solve`` of the port under the ``torch.func`` transforms,
against gmres_tpu's ``implicit_solve`` under ``jax.grad`` and ``jax.vmap``
on tests/test_implicit.py's cases (the same seeded numpy inputs, CPU,
float64).

* ``torch.func.grad`` through ``implicit_solve`` gives ``jax.grad``'s
  gradient within 1e-9 relative (tests/test_torch_newton_implicit.py's
  band for ``torch.autograd.grad``), and ``torch.autograd.grad``'s to the
  bit;
* ``torch.autograd.grad`` gives the bits of the adjoint formula written
  out (one derived-transpose solve and one pullback of θ ↦ A(θ)x), the
  computation the Function made before it took the ``setup_context`` form;
* ``torch.func.vmap(torch.func.grad(loss))`` (tests/test_implicit.py::
  test_vmap_and_jit_compose): the lanes' forward and adjoint solves each
  one batched solve; each lane within rtol 1e-8 of its single gradient,
  as JAX holds its vmapped lanes, and of ``jax.vmap(jax.grad(loss))``;
* a solver function that calls the operator itself runs its lanes in turn,
  with the same gradients.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.convection_diffusion import convection_diffusion_apply as jca
from gmres_tpu.solvers.implicit import implicit_solve as jax_implicit
from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply as tca
from gmres_tpu_torch.solvers.requests import derived_transpose
from tests.torch_parity import seeded, to_np, to_torch


def _gmres_j(op, b):
    return gt.gmres(op, b, restart=30, tol=1e-12, max_restarts=200, compute_v_err=False)


def _gmres_t(op, b):
    return tt.gmres(op, b, restart=30, tol=1e-12, max_restarts=200, compute_v_err=False)


def _cg_j(op, b):
    return gt.cg(op, b, tol=1e-12, max_iterations=2000)


def _cg_t(op, b):
    return tt.cg(op, b, tol=1e-12, max_iterations=2000)


def _convdiff(pkg_apply):
    return lambda g: (lambda v: pkg_apply(v, g, 0.2))


def test_func_grad_shifted_poisson_matches_jax_and_autograd():
    n = 16
    b = seeded(4, (n, n))

    def a_j(theta):
        return lambda v: gt.poisson_operator(n)(v) + theta * v

    def a_t(theta):
        return lambda v: tt.poisson_operator(n)(v) + theta * v

    gj = float(jax.grad(lambda t: 0.5 * jnp.sum(jax_implicit(
        a_j, t, jnp.asarray(b), solver=_cg_j, symmetric=True) ** 2))(jnp.asarray(0.7)))

    def loss(t):
        x = tt.implicit_solve(a_t, t, to_torch(b), solver=_cg_t, symmetric=True)
        return 0.5 * torch.sum(x * x)

    g = torch.func.grad(loss)(torch.tensor(0.7, dtype=torch.float64))
    assert abs(float(g) - gj) <= 1e-9 * abs(gj)
    th = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    (ga,) = torch.autograd.grad(loss(th), th)
    assert torch.equal(g, ga)


def test_func_grad_rhs_is_the_adjoint_solution():
    n = 12
    b, c = seeded(5, (n, n)), seeded(6, (n, n))
    op_j = gt.convection_diffusion_operator(n, 0.4, 0.2)
    gj = jax.grad(lambda bb: jnp.sum(jnp.asarray(c) * jax_implicit(
        lambda t: op_j, 0.0, bb, solver=_gmres_j)))(jnp.asarray(b))
    op_t = tt.convection_diffusion_operator(n, 0.4, 0.2)
    g = torch.func.grad(lambda bb: torch.sum(to_torch(c) * tt.implicit_solve(
        lambda t: op_t, 0.0, bb, solver=_gmres_t)))(to_torch(b))
    np.testing.assert_allclose(to_np(g), np.asarray(gj), atol=1e-9)


@pytest.mark.parametrize("transform", ["grad", "jacrev", "vjp"])
def test_func_transforms_convection_gradient_match_jax(transform):
    n = 12
    b, target = seeded(7, (n, n)), seeded(8, (n, n))
    gj = float(jax.grad(lambda g: jnp.sum((jax_implicit(
        _convdiff(jca), g, jnp.asarray(b), solver=_gmres_j)
        - jnp.asarray(target)) ** 2))(jnp.asarray(0.35)))

    def loss(gm):
        x = tt.implicit_solve(_convdiff(tca), gm, to_torch(b), solver=_gmres_t)
        return torch.sum((x - to_torch(target)) ** 2)

    g0 = torch.tensor(0.35, dtype=torch.float64)
    if transform == "grad":
        g = torch.func.grad(loss)(g0)
    elif transform == "jacrev":
        g = torch.func.jacrev(loss)(g0)
    else:
        _, pullback = torch.func.vjp(loss, g0)
        (g,) = pullback(torch.ones((), dtype=torch.float64))
    assert abs(float(g) - gj) <= 1e-9 * abs(gj)


def test_autograd_grad_is_the_adjoint_formula_to_the_bit():
    """torch.autograd.grad through implicit_solve: the bits of the adjoint
    computation written out, for θ and b together."""
    n = 12
    b, target = to_torch(seeded(9, (n, n))), to_torch(seeded(10, (n, n)))
    gm = torch.tensor(0.35, dtype=torch.float64, requires_grad=True)
    bt = b.clone().requires_grad_()
    x = tt.implicit_solve(_convdiff(tca), gm, bt, solver=_gmres_t)
    ct = 2.0 * (x - target)
    g_gm, g_b = torch.autograd.grad(torch.sum((x - target) ** 2), (gm, bt))
    # The formula: y = A(γ)⁻ᵀ ∂L/∂x; ∂L/∂γ = pullback of −y through
    # γ ↦ A(γ)x; ∂L/∂b = y.
    with torch.no_grad():
        xs = _gmres_t(_convdiff(tca)(gm.detach()), b).x
        ct = 2.0 * (xs - target)
        op = _convdiff(tca)(gm.detach())
    y = _gmres_t(derived_transpose(op, ct), ct).x
    leaf = gm.detach().requires_grad_()
    (want,) = torch.autograd.grad(_convdiff(tca)(leaf)(xs), leaf, grad_outputs=-y)
    assert torch.equal(g_gm, want) and torch.equal(g_b, y)


def _vmap_case():
    n = 12
    b = jnp.ones((n, n))

    def loss_j(gamma):
        return jnp.sum(jax_implicit(lambda g: (lambda v: jca(v, g, 0.1)), gamma, b,
                                    solver=_gmres_j) ** 2)

    gammas = np.array([0.1, 0.3, 0.5])
    return n, gammas, jax.jit(jax.vmap(jax.grad(loss_j)))(jnp.asarray(gammas))


def test_vmap_of_grad_batches_the_solves():
    """tests/test_implicit.py::test_vmap_and_jit_compose: dL/dγ at several γ
    in one transform; the forward and adjoint solves each one batched
    solve of the lanes."""
    n, gammas, gj = _vmap_case()
    b = torch.ones((n, n), dtype=torch.float64)

    def loss(gamma):
        return torch.sum(tt.implicit_solve(lambda g: (lambda v: tca(v, g, 0.1)), gamma, b,
                                           solver=_gmres_t) ** 2)

    before = dict(tt.implicit_solve.lane_paths)
    grads = torch.func.vmap(torch.func.grad(loss))(to_torch(gammas))
    assert tt.implicit_solve.lane_paths["batched"] - before["batched"] == 2
    assert tt.implicit_solve.lane_paths["in turn"] == before["in turn"]
    singles = np.array([float(torch.func.grad(loss)(g)) for g in to_torch(gammas)])
    np.testing.assert_allclose(to_np(grads), singles, rtol=1e-8)
    np.testing.assert_allclose(to_np(grads), np.asarray(gj), rtol=1e-8)


def test_vmap_of_grad_with_a_solver_that_calls_the_operator_runs_in_turn():
    """A solver function of the caller's own that applies op itself (no
    steps): the lanes' solves run one after another, with the same
    gradients as the singles."""
    n = 8
    b = torch.ones((n, n), dtype=torch.float64)

    def richardson(op, rhs):
        x = torch.zeros_like(rhs)
        for _ in range(400):
            x = x + 0.2 * (rhs - op(x))
        return types.SimpleNamespace(x=x)

    def loss(gamma):
        return torch.sum(tt.implicit_solve(lambda g: (lambda v: tca(v, g, 0.1)), gamma, b,
                                           solver=richardson) ** 2)

    gammas = torch.tensor([0.1, 0.3], dtype=torch.float64)
    before = dict(tt.implicit_solve.lane_paths)
    grads = torch.func.vmap(torch.func.grad(loss))(gammas)
    assert tt.implicit_solve.lane_paths["in turn"] - before["in turn"] == 2
    singles = torch.stack([torch.func.grad(loss)(g) for g in gammas])
    torch.testing.assert_close(grads, singles, rtol=1e-12, atol=0)
