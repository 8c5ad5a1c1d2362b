"""Newton-Krylov on the Bratu problem and implicit differentiation (ROADMAP
item 9.4) of the PyTorch port against ``gmres_tpu`` on the CPU.

J·v is ``torch.func.jvp`` of the residual (gmres_tpu: ``jax.linearize``),
and ``implicit_solve`` is a ``torch.autograd.Function`` (gmres_tpu:
``jax.custom_vjp``). Newton steps and inner iterations are JAX's in float64;
with float32 inner bases the inner count follows the float32 sums (265
against 250 at 32², λ = 6) and is held to 10%. Gradients are held to JAX's
within 1e-9 relative and to central differences within 1e-5 (solves to
1e-12).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.bratu import bratu_dense_residual as jax_dense
from gmres_tpu.models.convection_diffusion import convection_diffusion_apply as jca
from gmres_tpu.solvers.implicit import implicit_solve as jax_implicit
from gmres_tpu_torch.models.bratu import bratu_dense_residual
from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply as tca
from tests.torch_parity import rel_err, seeded, to_np, to_torch

F32_INNER_SPREAD = 0.10


def test_bratu_residual_matches_jax():
    n = 16
    u = 0.1 * seeded(1, (n, n))
    got = tt.bratu_residual(n, 5.0)(to_torch(u))
    want = np.asarray(gt.bratu_residual(n, 5.0)(jnp.asarray(u)))
    assert rel_err(got, want) <= 1e-15
    np.testing.assert_array_equal(bratu_dense_residual(n, 5.0)(u.reshape(-1)),
                                  jax_dense(n, 5.0)(u.reshape(-1)))
    np.testing.assert_allclose(to_np(got).reshape(-1), bratu_dense_residual(n, 5.0)(u),
                               atol=1e-15)


def _newton_pair(n, lam, **kw):
    kj, kt = dict(kw), dict(kw)
    if kw.pop("mg", False):
        kj.pop("mg"), kt.pop("mg")
        kj["M"] = gt.poisson_multigrid_preconditioner(n)
        kt["M"] = tt.poisson_multigrid_preconditioner(n)
    if kw.pop("f32", False):
        kj.pop("f32"), kt.pop("f32")
        kj["inner_dtype"], kt["inner_dtype"] = jnp.float32, torch.float32
    rj = gt.newton_krylov(gt.bratu_residual(n, lam), jnp.zeros((n, n)), **kj)
    rt = tt.newton_krylov(tt.bratu_residual(n, lam), torch.zeros((n, n), dtype=torch.float64),
                          **kt)
    return rt, rj


@pytest.mark.parametrize("case", [
    dict(n=16, lam=5.0, tol=1e-11, restart=20),
    dict(n=32, lam=6.0, tol=1e-10, mg=True),
    dict(n=32, lam=6.0, tol=1e-10, inner="gcrodr", recycle_k=10, restart=30,
         max_restarts=100),
    dict(n=16, lam=3.0, tol=1e-11, restart=20, forcing="fixed", eta_fixed=1e-6),
    dict(n=16, lam=3.0, tol=1e-11, restart=20, line_search=False),
], ids=["gmres", "fgmres-mg", "gcrodr", "fixed-forcing", "no-line-search"])
def test_newton_krylov_matches_jax(case):
    case = dict(case)
    n, lam = case.pop("n"), case.pop("lam")
    rt, rj = _newton_pair(n, lam, **case)
    assert rt.status == int(rj.status) == 0
    assert (rt.iterations, rt.inner_iterations) == (int(rj.iterations),
                                                    int(rj.inner_iterations))
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), atol=1e-9)
    # ‖F‖ after each step, while it is far above the inner solves' rounding
    # (the last steps' ‖F‖ is the inexact inner solution's, which the two
    # packages reach by other roundings).
    it = rt.iterations
    hist_j = np.asarray(rj.residual_history)[:it]
    far = hist_j > 1e-6
    np.testing.assert_allclose(to_np(rt.residual_history)[:it][far], hist_j[far], rtol=1e-3)
    assert float(rt.residual) < case["tol"]
    assert rt.jv_products >= rt.inner_iterations - (case.get("recycle_k", 0) * it)


def test_newton_krylov_float32_inner_bases():
    rt, rj = _newton_pair(32, 6.0, tol=1e-10, f32=True)
    assert rt.status == int(rj.status) == 0 and rt.iterations == int(rj.iterations)
    assert abs(rt.inner_iterations - int(rj.inner_iterations)) <= \
        F32_INNER_SPREAD * int(rj.inner_iterations)
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), atol=1e-8)


def test_jv_is_the_jacobian_action():
    """torch.func.jvp of F is J(x)·v = A v − λh² eˣ ⊙ v, JAX's linearisation."""
    n, lam = 12, 5.0
    x, v = 0.1 * seeded(2, (n, n)), seeded(3, (n, n))
    _, jv = torch.func.jvp(tt.bratu_residual(n, lam), (to_torch(x),), (to_torch(v),))
    _, lin = jax.linearize(gt.bratu_residual(n, lam), jnp.asarray(x))
    assert rel_err(jv, np.asarray(lin(jnp.asarray(v)))) <= 1e-14
    h2 = 1.0 / (n + 1) ** 2
    want = to_np(tt.poisson_apply(to_torch(v))) - lam * h2 * np.exp(x) * v
    assert rel_err(jv, want) <= 1e-14


def test_newton_krylov_refuses_and_breaks_down():
    def rootless(x):
        return x * x + 1.0

    res = tt.newton_krylov(rootless, 0.5 * torch.ones((8, 8), dtype=torch.float64),
                           tol=1e-9, restart=8, max_newton=30)
    jres = gt.newton_krylov(rootless, 0.5 * jnp.ones((8, 8)), tol=1e-9, restart=8,
                            max_newton=30)
    assert res.status == int(jres.status) == int(tt.SolverStatus.BREAKDOWN)
    assert np.isfinite(float(res.residual))
    with pytest.raises(ValueError, match="same shape"):
        tt.newton_krylov(lambda x: torch.sum(x), torch.ones((4, 4)))
    f = tt.bratu_residual(8)
    x0 = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown forcing"):
        tt.newton_krylov(f, x0, forcing="nope")
    with pytest.raises(ValueError, match="unknown inner"):
        tt.newton_krylov(f, x0, inner="nope")
    with pytest.raises(ValueError, match="gmres inner"):
        tt.newton_krylov(f, x0, inner="gcrodr", inner_dtype=torch.float32)


def _gmres_j(op, b):
    return gt.gmres(op, b, restart=30, tol=1e-12, max_restarts=200, compute_v_err=False)


def _gmres_t(op, b):
    return tt.gmres(op, b, restart=30, tol=1e-12, max_restarts=200, compute_v_err=False)


def test_implicit_shifted_poisson_gradient_matches_jax_and_analytic():
    """x(θ) = (A + θI)⁻¹b, symmetric: d/dθ ½‖x‖² = −xᵀ(A + θI)⁻¹x."""
    n = 16
    b = seeded(4, (n, n))

    def cg_j(op, bb):
        return gt.cg(op, bb, tol=1e-12, max_iterations=2000)

    def cg_t(op, bb):
        return tt.cg(op, bb, tol=1e-12, max_iterations=2000)

    def a_j(theta):
        return lambda v: gt.poisson_operator(n)(v) + theta * v

    def a_t(theta):
        return lambda v: tt.poisson_operator(n)(v) + theta * v

    gj = float(jax.grad(lambda t: 0.5 * jnp.sum(jax_implicit(
        a_j, t, jnp.asarray(b), solver=cg_j, symmetric=True) ** 2))(jnp.asarray(0.7)))
    th = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    x = tt.implicit_solve(a_t, th, to_torch(b), solver=cg_t, symmetric=True)
    (g,) = torch.autograd.grad(0.5 * torch.sum(x * x), th)
    assert abs(float(g) - gj) <= 1e-9 * abs(gj)
    xs = cg_t(a_t(0.7), to_torch(b)).x
    w = cg_t(a_t(0.7), xs).x
    assert abs(float(g) + float(torch.sum(xs * w))) <= 1e-9 * abs(float(g))


def test_implicit_rhs_gradient_is_the_adjoint_solution():
    n = 12
    b, c = seeded(5, (n, n)), seeded(6, (n, n))
    op_j = gt.convection_diffusion_operator(n, 0.4, 0.2)
    gj = jax.grad(lambda bb: jnp.sum(jnp.asarray(c) * jax_implicit(
        lambda t: op_j, 0.0, bb, solver=_gmres_j)))(jnp.asarray(b))
    bt = to_torch(b).requires_grad_()
    x = tt.implicit_solve(lambda t: tt.convection_diffusion_operator(n, 0.4, 0.2), 0.0, bt,
                          solver=_gmres_t)
    (g,) = torch.autograd.grad(torch.sum(to_torch(c) * x), bt)
    np.testing.assert_allclose(to_np(g), np.asarray(gj), atol=1e-9)


def _convdiff_loss(b, target, adjoint_solver=None):
    def loss(gm):
        x = tt.implicit_solve(lambda g: (lambda v: tca(v, g, 0.2)), gm, b, solver=_gmres_t,
                              adjoint_solver=adjoint_solver)
        return torch.sum((x - target) ** 2)
    return loss


def test_implicit_convection_gradient_matches_jax_and_central_differences():
    """The nonsymmetric θ-dependence: A(γ) the convdiff operator, γ a tensor
    (its coefficients' gradients through the stencil)."""
    n = 12
    b, target = seeded(7, (n, n)), seeded(8, (n, n))
    gj = float(jax.grad(lambda g: jnp.sum((jax_implicit(
        lambda gm: (lambda v: jca(v, gm, 0.2)), g, jnp.asarray(b), solver=_gmres_j)
        - jnp.asarray(target)) ** 2))(jnp.asarray(0.35)))
    loss = _convdiff_loss(to_torch(b), to_torch(target))
    g0 = torch.tensor(0.35, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(g0), g0)
    assert abs(float(g) - gj) <= 1e-9 * abs(gj)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.tensor(0.35 + eps, dtype=torch.float64)))
              - float(loss(torch.tensor(0.35 - eps, dtype=torch.float64)))) / (2 * eps)
    assert abs(float(g) - fd) <= 1e-5 * abs(fd)


def test_implicit_pytree_theta_and_separate_adjoint_solver():
    """θ a dict of tensors (JAX's pytree); an adjoint solver of its own; a
    leaf that needs no gradient gets none."""
    n = 12
    b = to_torch(seeded(9, (n, n)))
    calls = {"adj": 0}

    def adj(op, bb):
        calls["adj"] += 1
        return _gmres_t(op, bb)

    def a_fn(p):
        return lambda v: tca(v, p["gx"], p["gy"])

    gx = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    gy = torch.tensor(0.2, dtype=torch.float64)
    x = tt.implicit_solve(a_fn, {"gx": gx, "gy": gy}, b, solver=_gmres_t,
                          adjoint_solver=adj)
    (g,) = torch.autograd.grad(torch.sum(x * x), gx)
    assert calls["adj"] == 1 and torch.isfinite(g)
    gj = float(jax.grad(lambda t: jnp.sum(jax_implicit(
        lambda p: (lambda v: jca(v, p["gx"], p["gy"])), {"gx": t, "gy": jnp.asarray(0.2)},
        jnp.asarray(to_np(b)), solver=_gmres_j) ** 2))(jnp.asarray(0.4)))
    assert abs(float(g) - gj) <= 1e-9 * abs(gj)


def test_implicit_refuses_complex():
    with pytest.raises(ValueError, match="real"):
        tt.implicit_solve(lambda t: (lambda v: v), 0.0,
                          torch.ones(4, dtype=torch.complex128),
                          solver=functools.partial(tt.cg, tol=1e-9))
