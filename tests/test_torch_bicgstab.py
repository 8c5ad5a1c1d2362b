"""BiCGSTAB of the PyTorch port against gmres_tpu.bicgstab on the same
numpy inputs, on the CPU, float64.

Tolerances: iterations equal where the two agree in float64 (16² from
b = A·1), within 2 at 64² and from a random x0 (the packages sum their reductions in different orders, and
BiCGSTAB amplifies the last-bit differences: the residual histories part
from ~1e-13 relative at iteration 14 of the unpreconditioned 48² solve);
the same status; x within 1e-6 of JAX's relative to max|x| (solves to an
absolute 1e-9 on grids whose smallest eigenvalue is ≥ 2e-3); the first
iterations' history within 1e-9 relative; the history padded past the last
iteration with the final residual. The port reads the device once per
iteration, plus once for the initial residual, once for the certification
and once for an ``rtol`` target.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from tests.torch_parity import np_poisson, rel_err, seeded, to_np, to_torch

# (grid, cbpr2, reliable, extra keyword arguments, allowed iteration gap)
CASES = {
    "plain-16": (16, False, True, {}, 0),
    "cbpr2-16": (16, True, True, {}, 0),
    "plain-64": (64, False, True, {}, 2),
    "cbpr2-64": (64, True, True, {}, 2),
    "cbpr2-64-plain-recurrence": (64, True, False, {}, 2),
    "plain-16-plain-recurrence": (16, False, False, {}, 0),
    # A random x0: the last-bit differences grow from the first iteration
    # (26 iterations here, 28 in JAX).
    "x0": (16, True, True, {"x0": True}, 2),
    "rtol": (16, True, True, {"rtol": 1e-6}, 0),
    "max-iterations": (16, True, True, {"max_iterations": 3}, 0),
    # Replacement fires twice in 30 iterations (the port's count below).
    "replacement": (16, False, True, {"tol": 3e-14}, 0),
    # The recursive residual crosses 1e-14 while the true residual
    # (1.9e-14 in JAX) cannot: certification downgrades CONVERGED to
    # BREAKDOWN.
    "certification-downgrade": (16, False, False, {"tol": 1e-14}, 0),
}


def _solve_both(n, cbpr2, reliable, kw, b=None):
    b = np_poisson(np.ones((n, n))) if b is None else b
    opj, opt = gt.poisson_operator(n), tt.poisson_operator(n)
    calls = [0]

    def counted(v):
        calls[0] += 1
        return opt(v)

    extra_j, extra_t = {}, {}
    if cbpr2:
        extra_j["M"] = gt.chebyshev_preconditioner(opj, 0.2, 8.2)
        extra_t["M"] = tt.chebyshev_preconditioner(counted, 0.2, 8.2)
    kw = dict(kw)
    if kw.pop("x0", False):
        x0 = seeded(81, (n, n))
        extra_j["x0"], extra_t["x0"] = jnp.asarray(x0), to_torch(x0)
    rj = gt.bicgstab(opj, jnp.asarray(b), reliable=reliable, **kw, **extra_j)
    rt = tt.bicgstab(counted, to_torch(b), reliable=reliable, **kw, **extra_t)
    return rj, rt, calls[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bicgstab_matches_jax(case):
    n, cbpr2, reliable, kw, gap = CASES[case]
    rj, rt, applications = _solve_both(n, cbpr2, reliable, kw)
    t = rt.to_numpy()
    it_j, it_t = int(rj.iterations), rt.iterations
    assert abs(it_t - it_j) <= gap, (it_t, it_j)
    assert rt.status == int(rj.status)
    assert rel_err(rt.x, rj.x) <= 1e-6
    hist_j, hist_t = to_np(rj.residual_history), t["residual_history"]
    max_it = kw.get("max_iterations", 10_000)
    assert hist_t.shape == hist_j.shape == (max_it,)
    # Padded past the last iteration with the final (certified) residual.
    np.testing.assert_array_equal(hist_t[it_t:], float(rt.residual))
    k = min(it_t, it_j, 10)
    np.testing.assert_allclose(hist_t[:k], hist_j[:k], rtol=1e-9)
    if gap == 0:
        np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=0.5)
    # One host read per iteration (+ initial, certification, rtol target).
    assert rt.host_syncs == it_t + 2 + ("rtol" in kw)
    # A per iteration: A z1, A z2, and the A inside each cbpr2.
    per_iteration = 4 if cbpr2 else 2
    base = per_iteration * it_t + 1 + reliable + ("x0" in kw)
    if case == "replacement":
        assert applications == base + 2
    elif reliable:
        assert applications >= base
    else:
        assert applications == base


def test_certification_downgrade_reports_the_true_residual():
    n, cbpr2, reliable, kw, _ = CASES["certification-downgrade"]
    rj, rt, _ = _solve_both(n, cbpr2, reliable, kw)
    assert rt.status == int(rj.status) == tt.SolverStatus.BREAKDOWN
    true = np.linalg.norm(np_poisson(np.ones((n, n))) - np_poisson(to_np(rt.x)))
    assert float(rt.residual) > kw["tol"]
    np.testing.assert_allclose(float(rt.residual), true, rtol=1e-6)
    # The recursion had claimed convergence at the last iteration.
    assert rt.residual_history[rt.iterations - 1] != rt.residual


def test_zero_rhs_converges_without_iterating():
    n = 16
    rj, rt, applications = _solve_both(n, True, True, {}, b=np.zeros((n, n)))
    assert rt.iterations == int(rj.iterations) == 0
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert float(rt.residual) == float(rj.residual) == 0.0
    assert torch.count_nonzero(rt.x) == 0
    assert rt.host_syncs == 2 and applications == 2  # the ‖A‖ probe, the certification
    np.testing.assert_array_equal(rt.residual_history.numpy(), 0.0)


def test_float32_solve_matches_jax():
    """The thresholds (tiny, ε, δ = √ε) and the tol comparison in float32."""
    n = 16
    b = np_poisson(np.ones((n, n))).astype(np.float32)
    rj = gt.bicgstab(gt.poisson_operator(n), jnp.asarray(b), tol=1e-4,
                     M=gt.chebyshev_preconditioner(gt.poisson_operator(n), 0.2, 8.2))
    op = tt.poisson_operator(n)
    rt = tt.bicgstab(op, to_torch(b), tol=1e-4, M=tt.chebyshev_preconditioner(op, 0.2, 8.2))
    assert rt.x.dtype == rt.residual_history.dtype == torch.float32
    assert abs(rt.iterations - int(rj.iterations)) <= 2
    assert rt.status == int(rj.status)
    assert rel_err(rt.x, rj.x) <= 1e-4


def _numpy_dot(a, b):
    return np.asarray(np.dot(np.asarray(a).ravel(), np.asarray(b).ravel()))


@pytest.mark.parametrize("n,cbpr2", [(32, False), (64, True)])
def test_bitwise_with_shared_reductions(n, cbpr2, monkeypatch):
    """The port's arithmetic is JAX's: with both packages' inner products
    taken by the same numpy dot, and JAX run op by op (``disable_jit``:
    jitted, XLA:CPU contracts y + αx into fused multiply-adds), x is
    bitwise JAX's, the iterations and status equal, the history within one
    ulp (the scalar square roots). So every difference in the other tests
    comes from the order in which the reductions sum."""
    import jax

    import gmres_tpu.solvers.bicgstab as jb
    import gmres_tpu_torch.solvers.bicgstab as tb

    monkeypatch.setattr(jb, "tree_vdot", lambda a, b: jnp.asarray(_numpy_dot(a, b)))
    monkeypatch.setattr(jb, "batched_vdot", lambda pairs: jnp.stack(
        [jnp.asarray(_numpy_dot(a, b)) for a, b in pairs]))
    monkeypatch.setattr(tb, "tree_vdot", lambda a, b: torch.as_tensor(_numpy_dot(a, b)))
    monkeypatch.setattr(tb, "batched_vdot", lambda pairs: torch.stack(
        [torch.as_tensor(_numpy_dot(a, b)) for a, b in pairs]))
    b = np_poisson(np.ones((n, n)))
    opj, opt = gt.poisson_operator(n), tt.poisson_operator(n)
    mj = gt.chebyshev_preconditioner(opj, 0.2, 8.2) if cbpr2 else None
    mt = tt.chebyshev_preconditioner(opt, 0.2, 8.2) if cbpr2 else None
    with jax.disable_jit():
        rj = gt.bicgstab(opj, jnp.asarray(b), M=mj)
    rt = tt.bicgstab(opt, to_torch(b), M=mt)
    assert rt.iterations == int(rj.iterations) and rt.status == int(rj.status)
    np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    hj = np.asarray(rj.residual_history)
    assert np.all(np.abs(rt.residual_history.numpy() - hj) <= np.spacing(hj))


def test_jax_count_moves_with_its_reduction_order(monkeypatch):
    """gmres_tpu's own iteration count moves by 4 at 32² (unpreconditioned,
    tol 1e-9) when its inner products are jnp.vdot instead of
    jnp.sum(x·y), the same mathematics: BiCGSTAB's count is sensitive to the
    order of summation, so two implementations agree within 2 iterations
    only where their reductions agree closely (at 1000² with cbpr2 the same
    switch moves JAX from 744 to 813). The port's count lies within 2 of
    that spread."""
    import gmres_tpu.solvers.bicgstab as jb

    n = 32
    b = jnp.asarray(np_poisson(np.ones((n, n))))
    counts = [int(gt.bicgstab(gt.poisson_operator(n), b).iterations)]
    monkeypatch.setattr(jb, "tree_vdot", lambda a, c: jnp.vdot(a, c))
    monkeypatch.setattr(jb, "batched_vdot",
                        lambda pairs: jnp.stack([jnp.vdot(a, c) for a, c in pairs]))
    counts.append(int(gt.bicgstab(gt.poisson_operator(n), b).iterations))
    assert counts == [50, 54]
    port = tt.bicgstab(tt.poisson_operator(n), to_torch(np.asarray(b))).iterations
    assert min(counts) - 2 <= port <= max(counts) + 2
