"""The solvers that need Aᵀ (ROADMAP item 9.4): QMR, LSQR and LSMR of the
PyTorch port against ``gmres_tpu`` on the CPU, K1's rules on the plain
version, and the refusal of the other kernels under a transform.

gmres_tpu derives the transpose with ``jax.linear_transpose``; the port
takes the pullback of ``torch.func.vjp``. On a complex operator that
pullback is already the adjoint Aᴴ: the port must not conjugate around it,
as gmres_tpu conjugates around its transpose (pinned below). Counts are
JAX's on these inputs (absolute tolerances as in gmres_tpu); x is held to
1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.convection_diffusion import convection_diffusion_matrix
from gmres_tpu_torch.ops import _cuda, fused, sparse, stencil, stencil_rdma
from gmres_tpu_torch.solvers.qmr import derived_transpose
from tests.torch_parity import rel_err, seeded, to_np, to_torch


# QMR's two-sided Lanczos loses biorthogonality with the reductions'
# rounding: at 24², (0.8, 0.4), the port takes 72, 70 and 84 steps where
# gmres_tpu takes 73 (derived Aᵀ, dense Aᵀ, Jacobi M); the counts are held
# to 5% (at least 2), the residual history's first steps to 1e-9.
QMR_SPREAD = 0.05


def _counts(rt, rj):
    return (rt.iterations, rt.status), (int(rj.iterations), int(rj.status))


# ---------------------------------------------------------------------------
# K1's rules, on the plain version (the card's are tests/test_torch_kernels_gpu.py).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coefs", [stencil.POISSON_COEFS, (4.1, -1.3, -0.7, -1.2, -0.8)])
def test_k1_rules_on_the_plain_version(coefs):
    """Stencil5Grid's backward (the mirrored stencil), jvp and coefficient
    gradients against the plain stencil's autograd, and the adjoint
    identity; the rules count their applications."""
    x, y = to_torch(seeded(1, (12, 13))), to_torch(seeded(2, (12, 13)))
    before = dict(stencil.Stencil5Grid.rule_applications)
    ax, pull = torch.func.vjp(lambda v: stencil.stencil5_grid(v, coefs), x)
    _, pull_p = torch.func.vjp(lambda v: stencil.stencil_5pt_general(v, *coefs), x)
    (aty,) = pull(y)
    assert rel_err(aty, pull_p(y)[0]) <= 1e-15
    assert abs(float(torch.sum(ax * y) - torch.sum(x * aty))) <= 1e-13
    _, jv = torch.func.jvp(lambda v: stencil.stencil5_grid(v, coefs), (x,), (y,))
    np.testing.assert_array_equal(to_np(jv), to_np(stencil.stencil_5pt_general(y, *coefs)))
    assert stencil.Stencil5Grid.rule_applications == {
        "transpose": before["transpose"] + 1, "tangent": before["tangent"] + 1}
    c = torch.tensor(coefs, dtype=torch.float64, requires_grad=True)
    cp = torch.tensor(coefs, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(stencil.stencil5_grid(x, c) * y), c)
    (gp,) = torch.autograd.grad(torch.sum(stencil.stencil_5pt_general(x, *cp.unbind()) * y), cp)
    assert rel_err(g, gp) <= 1e-15


def test_tensor_coefficients_stay_in_the_graph_on_the_cpu():
    """A coefficient built from a tensor γ keeps its gradient through the
    routed operator (the convdiff operator at γ), on the plain route."""
    x = to_torch(seeded(3, (10, 10)))
    g = torch.tensor(0.35, dtype=torch.float64, requires_grad=True)
    y = tt.convection_diffusion_apply(x, g, 0.2)
    (dg,) = torch.autograd.grad(y.sum(), g)
    # ∂y/∂γ = −shift_w(x) + shift_e(x): columns summed.
    want = -x[:, :-1].sum() + x[:, 1:].sum()
    assert abs(float(dg - want)) <= 1e-13


# ---------------------------------------------------------------------------
# Every ctypes wrapper refuses a tracked operand (the check runs before the
# device check, so it is exercised here on CPU tensors).
# ---------------------------------------------------------------------------


def _refusals(tracked, plain):
    theta, _, steps = fused.chebyshev_k_scalars(0.5, 8.0, 3)
    dia = sparse.DIAMatrix(data=torch.ones((1, 64), dtype=torch.float64), offsets=(0,),
                           shape=(64, 64))
    bsr = sparse.BSRMatrix(data=torch.ones((2, 1, 4, 4), dtype=torch.float64),
                           block_cols=torch.zeros((2, 1), dtype=torch.int32), shape=(8, 8))
    return {
        "K1": lambda: stencil.stencil5_cuda(tracked),
        "K1rr": lambda: stencil.residual_restrict_cuda(tracked, plain),
        "K1cr": lambda: stencil.correct_residual_cuda(plain, tracked, plain[:4, :4]),
        "K2": lambda: fused.chebk_cuda(tracked, theta, steps),
        "K3": lambda: sparse.dia_spmv_cuda(dia, tracked.reshape(-1)),
        "K4": lambda: sparse.bsr_spmv_cuda(bsr, tracked.reshape(-1)[:8]),
        "K5": lambda: fused.cheb2_cuda(tracked, None, None, 4.2, 0.2),
        "K6": lambda: stencil.stencil5_dd_cuda(tracked.float(), plain.float()),
        "K7a": lambda: fused.cg_fused_update_cuda(plain, plain, plain, plain, tracked.sum()),
        "K7b": lambda: fused.axpy_dot_cuda(0.5, tracked, plain, plain),
        "K8": lambda: stencil_rdma.rdma_interior_cuda(tracked, [1.0] * 7),
    }


@pytest.mark.parametrize("kernel", ["K1", "K1rr", "K1cr", "K2", "K3", "K4", "K5", "K6",
                                    "K7a", "K7b", "K8"])
def test_every_wrapper_refuses_autograd(kernel):
    plain = to_torch(seeded(4, (8, 8)))
    tracked = plain.clone().requires_grad_()
    with pytest.raises(RuntimeError, match=f"kernel {kernel} \\(route cuda\\).*autograd.*"
                                           "ROADMAP: transposes of K2–K8"):
        _refusals(tracked, plain)[kernel]()
    # Under no_grad nothing is tracked: the device check speaks instead.
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        _refusals(tracked, plain)[kernel]()


@pytest.mark.parametrize("transform", ["vjp", "jvp"])
def test_wrappers_refuse_functorch_tensors(transform):
    plain = to_torch(seeded(5, (8, 8)))
    theta, _, steps = fused.chebyshev_k_scalars(0.5, 8.0, 3)

    def k2(v):
        return fused.chebk_cuda(v, theta, steps)

    with pytest.raises(RuntimeError, match="kernel K2 .*torch.func transform"):
        if transform == "vjp":
            torch.func.vjp(k2, plain)
        else:
            torch.func.jvp(k2, (plain,), (plain,))


def _coef_refusals(c, plain):
    """Each ctypes wrapper that takes stencil coefficients, handed ``c``."""
    theta, _, steps = fused.chebyshev_k_scalars(0.5, 8.0, 3)
    return {
        "K1": lambda: stencil.stencil5_cuda(plain, plain[0], None, c),
        "K1rr": lambda: stencil.residual_restrict_cuda(plain, plain, c),
        "K1cr": lambda: stencil.correct_residual_cuda(plain, plain, plain[:4, :4], c),
        "K2": lambda: fused.chebk_cuda(plain, theta, steps, c),
        "K5": lambda: fused.cheb2_cuda(plain, None, None, 4.2, 0.2, c),
        "K6": lambda: stencil.stencil5_dd_cuda(plain.float(), plain.float(), c),
    }


@pytest.mark.parametrize("kernel", ["K1", "K1rr", "K1cr", "K2", "K5", "K6"])
@pytest.mark.parametrize("form", ["tensor", "leaf"])
def test_every_wrapper_refuses_a_tracked_coefficient(kernel, form):
    """A launch reads a coefficient's value: one that autograd tracks (a
    (5,) tensor, or one 0-d leaf among floats) raises rather than lose its
    gradient; torch.func.grad with respect to the coefficients too."""
    plain = to_torch(seeded(8, (8, 8)))
    coefs = (4.1, -1.3, -0.7, -1.2, -0.8)
    if form == "tensor":
        c = torch.tensor(coefs, dtype=torch.float64, requires_grad=True)
    else:
        c = (torch.tensor(coefs[0], dtype=torch.float64, requires_grad=True), *coefs[1:])
    with pytest.raises(RuntimeError, match=f"kernel {kernel} \\(route cuda\\).*autograd.*"
                                           "ROADMAP: transposes of K2–K8"):
        _coef_refusals(c, plain)[kernel]()
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        _coef_refusals(c, plain)[kernel]()

    def loss(cv):
        out = _coef_refusals(cv if form == "tensor" else (cv[0], *coefs[1:]), plain)[kernel]()
        return (out[0] if isinstance(out, tuple) else out).sum()

    with pytest.raises(RuntimeError, match=f"kernel {kernel} .*torch.func transform"):
        torch.func.grad(loss)(torch.tensor(coefs, dtype=torch.float64))


def test_tracked_by_names_each_transform():
    """What ``_cuda.tracked_by`` sees: nothing on a plain tensor or under
    no_grad, autograd, forward-mode AD's tangent, a torch.func wrapper; the
    routed full-grid stencil takes the wrapper directly only where it sees
    nothing (checked on the card in test_torch_kernels_gpu.py)."""
    import torch.autograd.forward_ad as fwad

    x = to_torch(seeded(9, (6, 6)))
    assert _cuda.tracked_by(x) is None and _cuda.tracked_by(1.5) is None
    t = x.clone().requires_grad_()
    assert _cuda.tracked_by(t).startswith("autograd")
    with torch.no_grad():
        assert _cuda.tracked_by(t) is None
    with fwad.dual_level():
        d = fwad.make_dual(x, torch.ones_like(x))
        assert _cuda.tracked_by(d).startswith("forward-mode AD")
        assert _cuda.tracked_by(x) is None
        with pytest.raises(RuntimeError, match="kernel K2 .*forward-mode AD"):
            theta, _, steps = fused.chebyshev_k_scalars(0.5, 8.0, 3)
            fused.chebk_cuda(d, theta, steps)
    seen = []
    torch.func.vjp(lambda v: seen.append(_cuda.tracked_by(v)) or v * 2, x)
    assert seen == ["a torch.func transform"]


# ---------------------------------------------------------------------------
# QMR.
# ---------------------------------------------------------------------------


def test_derived_transpose_is_the_dense_transpose():
    n = 12
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    u = seeded(6, (n, n))
    at = derived_transpose(op, to_torch(np.zeros((n, n))))
    a = np.asarray(convection_diffusion_matrix(n, 0.4, 0.2))
    np.testing.assert_allclose(to_np(at(to_torch(u))).reshape(-1), a.T @ u.reshape(-1),
                               atol=1e-13)


@pytest.mark.parametrize("case", ["derived", "AT", "jacobi-M"])
def test_qmr_matches_jax(case):
    n = 24
    x_true = seeded(7, (n, n))
    bj = gt.convection_diffusion_operator(n, 0.8, 0.4)(jnp.asarray(x_true))
    kw_j, kw_t = {}, {}
    if case == "AT":
        a = np.asarray(convection_diffusion_matrix(n, 0.8, 0.4))
        kw_j["AT"] = lambda u: (jnp.asarray(a.T) @ u.reshape(-1)).reshape(n, n)
        kw_t["AT"] = lambda u: (to_torch(a.T) @ u.reshape(-1)).reshape(n, n)
    if case == "jacobi-M":
        d = 1.0 + np.arange(n * n).reshape(n, n) / (n * n)
        kw_j["M"] = lambda r: r / jnp.asarray(d)
        kw_t["M"] = lambda r: r / to_torch(d)
    rj = gt.qmr(gt.convection_diffusion_operator(n, 0.8, 0.4), bj, tol=1e-10,
                max_iterations=2000, **kw_j)
    rt = tt.qmr(tt.convection_diffusion_operator(n, 0.8, 0.4), to_torch(bj), tol=1e-10,
                max_iterations=2000, **kw_t)
    assert rt.status == 0
    ct, cj = _counts(rt, rj)
    assert abs(ct[0] - cj[0]) <= max(2, QMR_SPREAD * cj[0]) and ct[1] == cj[1]
    np.testing.assert_allclose(to_np(rt.x), x_true, atol=1e-7)
    np.testing.assert_allclose(to_np(rt.residual_history)[:10],
                               np.asarray(rj.residual_history)[:10], rtol=1e-9)
    assert rt.host_syncs == rt.iterations + 2


def test_qmr_with_the_cycle_and_its_transpose_matches_jax():
    """M the convdiff cycle, MT its transpose=True cycle: (M∘A)ᵀ = Aᵀ∘Mᵀ
    with Aᵀ derived."""
    n = 32
    bj = gt.convection_diffusion_operator(n, 0.4, 0.2)(jnp.ones((n, n)))
    rj = gt.qmr(gt.convection_diffusion_operator(n, 0.4, 0.2), bj, tol=1e-9,
                M=gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2),
                MT=gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2,
                                                                    transpose=True))
    rt = tt.qmr(tt.convection_diffusion_operator(n, 0.4, 0.2), to_torch(bj), tol=1e-9,
                M=tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2),
                MT=tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2,
                                                                    transpose=True))
    ct, cj = _counts(rt, rj)
    assert ct == cj and ct[1] == 0
    np.testing.assert_allclose(to_np(rt.x), 1.0, atol=1e-7)


def test_qmr_derives_the_cycles_transpose_on_the_cpu_where_jax_cannot():
    """Without MT, gmres_tpu cannot transpose the cycle's fori_loop; the
    port's plain cycle on the CPU is torch, whose transpose torch derives
    (on the card the cycle's kernels refuse: test_torch_kernels_gpu.py).
    The derived (M∘A)ᵀ is the MT-composed one (ROADMAP queue 3)."""
    n = 32
    b = tt.convection_diffusion_operator(n, 0.4, 0.2)(torch.ones((n, n),
                                                                dtype=torch.float64))
    op = tt.convection_diffusion_operator(n, 0.4, 0.2)
    m = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    mt = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, transpose=True)
    derived = tt.qmr(op, b, tol=1e-9, M=m)
    composed = tt.qmr(op, b, tol=1e-9, M=m, MT=mt)
    assert derived.converged and abs(derived.iterations - composed.iterations) <= 2
    u = to_torch(seeded(8, (n, n)))
    at_derived = derived_transpose(lambda v: m(op(v)), b)(u)
    at_composed = derived_transpose(op, b)(mt(u))
    assert rel_err(at_derived, at_composed) <= 1e-12
    jop = gt.convection_diffusion_operator(n, 0.4, 0.2)
    with pytest.raises(Exception):
        gt.qmr(jop, jop(jnp.ones((n, n))), tol=1e-9,
               M=gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2))


def test_qmr_refuses_complex():
    with pytest.raises(ValueError, match="real"):
        tt.qmr(lambda v: v, torch.ones(4, dtype=torch.complex128))


# ---------------------------------------------------------------------------
# LSQR and LSMR.
# ---------------------------------------------------------------------------


def _dense(a):
    aj, at = jnp.asarray(a), to_torch(a)
    return (lambda v: aj @ v), (lambda v: at @ v)


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
@pytest.mark.parametrize("case", ["overdetermined", "damped", "complex"])
def test_least_squares_match_jax(name, case):
    rng = np.random.default_rng({"overdetermined": 10, "damped": 11, "complex": 12}[case])
    m, n = (60, 20) if case == "complex" else (80, 30)
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x_like = np.zeros(n)
    if case == "complex":
        a = a + 1j * rng.standard_normal((m, n))
        b = b + 1j * rng.standard_normal(m)
        x_like = x_like.astype(np.complex128)
    damp = 0.7 if case == "damped" else 0.0
    fj, ft = _dense(a)
    kw = dict(tol=1e-12, atol=1e-10, max_iterations=500, damp=damp)
    rj = getattr(gt, name)(fj, jnp.asarray(b), x_like=jnp.asarray(x_like), **kw)
    rt = getattr(tt, name)(ft, to_torch(b), x_like=to_torch(x_like), **kw)
    assert _counts(rt, rj)[0] == _counts(rt, rj)[1] and rt.status == 0
    if damp:
        want = np.linalg.solve(a.T @ a + damp ** 2 * np.eye(n), a.T @ b)
    else:
        want = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(to_np(rt.x), want, atol=1e-9)
    assert rel_err(rt.x, np.asarray(rj.x)) <= 1e-12
    assert rt.host_syncs == rt.iterations + 2


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_least_squares_on_the_convdiff_stencil_match_jax(name):
    """The derived adjoint of the nonsymmetric stencil: JAX's count."""
    n = 16
    bj = gt.convection_diffusion_operator(n, 0.4, 0.2)(jnp.ones((n, n)))
    rj = getattr(gt, name)(gt.convection_diffusion_operator(n, 0.4, 0.2), bj, tol=1e-10,
                           max_iterations=2000)
    rt = getattr(tt, name)(tt.convection_diffusion_operator(n, 0.4, 0.2), to_torch(bj),
                           tol=1e-10, max_iterations=2000)
    ct, cj = _counts(rt, rj)
    assert ct == cj and ct[1] == 0
    np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), atol=1e-9)


def test_the_pullback_is_already_the_adjoint():
    """No double conjugation: the pullback of a complex linear map is Aᴴu.
    Conjugating around it, as gmres_tpu conjugates around its transpose,
    would give Aᵀu, and LSQR would then solve another problem."""
    rng = np.random.default_rng(13)
    a = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    u = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    at = to_torch(a)
    ah = derived_transpose(lambda v: at @ v, torch.zeros(4, dtype=torch.complex128))
    np.testing.assert_allclose(to_np(ah(to_torch(u))), a.conj().T @ u, atol=1e-14)
    conj_wrapped = to_np(ah(to_torch(u).conj()).conj().resolve_conj())
    np.testing.assert_allclose(conj_wrapped, a.T @ u, atol=1e-14)
    assert np.abs(conj_wrapped - a.conj().T @ u).max() > 1e-3
    # JAX's form, conj ∘ linear_transpose ∘ conj, is the same adjoint.
    (t,) = jax.linear_transpose(lambda v: jnp.asarray(a) @ v,
                                jnp.zeros(4, jnp.complex128))(jnp.conj(jnp.asarray(u)))
    np.testing.assert_allclose(np.conj(np.asarray(t)), a.conj().T @ u, atol=1e-14)


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_least_squares_certify(name):
    """An inconsistent system certifies the least-squares optimum (‖Aᴴr‖),
    not ‖r‖; the zero right-hand side converges at once."""
    rng = np.random.default_rng(14)
    a = rng.standard_normal((40, 10))
    b = rng.standard_normal(40)
    _, ft = _dense(a)
    res = getattr(tt, name)(ft, to_torch(b), x_like=torch.zeros(10, dtype=torch.float64),
                            tol=1e-10, max_iterations=500)
    assert res.converged and float(res.residual) > 1.0
    grad = a.T @ (b - a @ to_np(res.x))
    assert np.linalg.norm(grad) < 1e-8
    zero = getattr(tt, name)(ft, torch.zeros(40, dtype=torch.float64),
                             x_like=torch.zeros(10, dtype=torch.float64))
    assert zero.converged and zero.iterations == 0
