"""CGS, TFQMR and BiCGStab(ℓ) of the PyTorch port (and BiCGSTAB with the
convection-diffusion cycle) against gmres_tpu on the same numpy inputs, on
the CPU, float64 unless a case says otherwise.

Tolerances, as in tests/test_torch_bicgstab.py: iterations equal where the
two agree in float64 (gap 0), within 2 at 64² and from a random x0 (the
packages sum their reductions in different orders and these recurrences
amplify last-bit differences); the same status; x within 1e-6 of JAX's
relative to max|x| (float32: 1e-3); the first iterations' history within
1e-9 relative or 1e-12 of ‖b‖; the history padded past
the last iteration with the final residual. The port reads the device once per iteration (a BiCGStab(ℓ)
cycle), plus once for the initial residual, once for the certification and
once for an ``rtol`` target. With both packages' inner products taken by
one numpy dot and JAX run op by op, x is bitwise JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.precond import multigrid as tmg
from tests.torch_parity import np_poisson, rel_err, seeded, to_np, to_torch

SOLVERS = {
    "cgs": (gt.cgs, tt.cgs),
    "tfqmr": (gt.tfqmr, tt.tfqmr),
    "bicgstabl": (gt.bicgstabl, tt.bicgstabl),
}
# (grid, preconditioner, keyword arguments, allowed iteration gap); the
# operator is convection-diffusion at γ = (0.4, 0.2) unless "poisson".
CASES = {
    "plain-16": (16, None, {}, 0),
    "mg-32": (32, "mg", {}, 0),
    "mg-64": (64, "mg", {}, 2),
    "mg-rbgs-64": (64, "mg-rbgs", {}, 2),
    "poly-32": (32, "poly", {}, 2),
    "poisson-cbpr2-16": (16, "cbpr2", {"poisson": True}, 0),
    "x0": (16, "mg", {"x0": True}, 2),
    "max-iterations": (16, None, {"max_iterations": 3}, 0),
    "float32": (16, "mg", {"float32": True, "tol": 1e-4}, 2),
}
# Solver-specific keyword arguments, each a case of its own.
EXTRA = {
    ("cgs", "rtol"): (16, "mg", {"rtol": 1e-8}, 0),
    ("bicgstabl", "ell-1"): (16, None, {"ell": 1}, 2),
    ("bicgstabl", "ell-4"): (32, "mg", {"ell": 4}, 0),
    ("bicgstabl", "plain-recurrence"): (32, None, {"reliable": False}, 0),
}
PARAMS = [(s, c) for s in SOLVERS for c in CASES] + list(EXTRA)


def _problem(n, precond, kw):
    """Operators, b and preconditioners of both packages; the port's
    operator counts its applications."""
    gx, gy = kw.pop("gamma", (0.4, 0.2))
    if kw.pop("poisson", False):
        opj, opt = gt.poisson_operator(n), tt.poisson_operator(n)
    else:
        opj = gt.convection_diffusion_operator(n, gx, gy)
        opt = tt.convection_diffusion_operator(n, gx, gy)
    dtype = np.float32 if kw.pop("float32", False) else np.float64
    b = np.asarray(opj(jnp.ones((n, n), dtype=dtype)))
    calls = [0]

    def counted(v):
        calls[0] += 1
        return opt(v)

    mj = mt = None
    if precond == "cbpr2":
        mj = gt.chebyshev_preconditioner(opj, 0.2, 8.2)
        mt = tt.chebyshev_preconditioner(counted, 0.2, 8.2)
    elif precond and precond.startswith("mg"):
        sm = precond[3:] or "jacobi"
        mj = gt.convection_diffusion_multigrid_preconditioner(n, gx, gy, smoother=sm)
        mt = tt.convection_diffusion_multigrid_preconditioner(n, gx, gy, smoother=sm)
    elif precond == "poly":
        mj = gt.gmres_polynomial_preconditioner(opj, jnp.asarray(b), degree=16)
        mt = tt.gmres_polynomial_preconditioner(counted, to_torch(b), degree=16)
    return opj, counted, b, mj, mt, calls


def _solve_both(solver, n, precond, kw):
    kw = dict(kw)
    opj, opt, b, mj, mt, calls = _problem(n, precond, kw)
    extra_j, extra_t = {}, {}
    if kw.pop("x0", False):
        x0 = seeded(950, (n, n))
        extra_j["x0"], extra_t["x0"] = jnp.asarray(x0), to_torch(x0)
    fj, ft = SOLVERS[solver]
    rj = fj(opj, jnp.asarray(b), M=mj, **kw, **extra_j)
    rt = ft(opt, to_torch(b), M=mt, **kw, **extra_t)
    return rj, rt, calls[0], b


@pytest.mark.parametrize("solver,case", PARAMS)
def test_solver_matches_jax(solver, case):
    n, precond, kw, gap = CASES[case] if (solver, case) not in EXTRA else EXTRA[solver, case]
    rj, rt, applications, b = _solve_both(solver, n, precond, kw)
    tol = max(kw.get("tol", 1e-9), kw.get("rtol", 0.0) * np.linalg.norm(b))
    it_j, it_t = int(rj.iterations), rt.iterations
    assert abs(it_t - it_j) <= gap, (it_t, it_j)
    assert rt.status == int(rj.status)
    assert rt.x.dtype == to_torch(b).dtype
    assert rel_err(rt.x, rj.x) <= (1e-3 if "float32" in kw else 1e-6)
    hist_j, hist_t = to_np(rj.residual_history), to_np(rt.residual_history)
    max_it = kw.get("max_iterations", 10_000)
    assert hist_t.shape == hist_j.shape == (max_it,)
    np.testing.assert_array_equal(hist_t[it_t:], float(rt.residual))
    if "float32" not in kw:
        k = min(it_t, it_j, 10)
        np.testing.assert_allclose(hist_t[:k], hist_j[:k], rtol=1e-9,
                                   atol=1e-12 * np.linalg.norm(b))
    if rt.status == 0:  # certified: the true residual is under tol
        assert float(rt.residual) < tol
    assert rt.host_syncs == it_t + 2 + ("rtol" in kw)
    # Operator applications: two an iteration (2ℓ a BiCGStab(ℓ) cycle),
    # the certification, x0's residual, TFQMR's first A·M·r, BiCGStab(ℓ)'s
    # ‖A∘M‖ probe and its replacements; cbpr2 adds one inside each M, the
    # degree-16 polynomial 16 (and its setup's Arnoldi 16 once).
    per_m = {"cbpr2": 1, "poly": 16}.get(precond, 0)
    setup = 16 if precond == "poly" else 0
    if solver == "bicgstabl":
        ell = kw.get("ell", 2)
        base = (setup + 2 * ell * it_t * (1 + per_m) + 1 + ("x0" in kw)
                + (1 + per_m) * kw.get("reliable", True) + per_m)
        assert applications >= base if kw.get("reliable", True) else applications == base
    else:
        base = setup + 2 * it_t * (1 + per_m) + 1 + ("x0" in kw)
        if solver == "tfqmr":
            base += 1 + per_m
        assert applications == base


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_zero_rhs_converges_without_iterating(solver):
    n = 16
    fj, ft = SOLVERS[solver]
    b = np.zeros((n, n))
    rj = fj(gt.convection_diffusion_operator(n), jnp.asarray(b))
    rt = ft(tt.convection_diffusion_operator(n), to_torch(b))
    assert rt.iterations == int(rj.iterations) == 0
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert float(rt.residual) == float(rj.residual) == 0.0
    assert torch.count_nonzero(rt.x) == 0 and rt.host_syncs == 2
    np.testing.assert_array_equal(rt.residual_history.numpy(), 0.0)


def test_bicgstabl_refuses_ell_0():
    with pytest.raises(ValueError, match="ell"):
        tt.bicgstabl(tt.convection_diffusion_operator(8), torch.ones(8, 8), ell=0)


def test_bicgstab_with_the_cycle_matches_jax(monkeypatch):
    """BiCGSTAB with the convection-diffusion cycle at 64² (JAX's Arnoldi
    probe patched in for the auto smoother), float64 and with a float32
    cycle inside (internal_dtype)."""
    monkeypatch.setattr(tmg, "_ritz_probe", lambda m: torch.as_tensor(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (m, m), dtype=jnp.float64))))
    n = 64
    opj, opt = gt.convection_diffusion_operator(n), tt.convection_diffusion_operator(n)
    b = np.asarray(opj(jnp.ones((n, n))))
    for kw_j, kw_t in (({"smoother": "auto"}, {"smoother": "auto"}),
                       ({"internal_dtype": jnp.float32}, {"internal_dtype": torch.float32})):
        rj = gt.bicgstab(opj, jnp.asarray(b),
                         M=gt.convection_diffusion_multigrid_preconditioner(n, **kw_j))
        rt = tt.bicgstab(opt, to_torch(b),
                         M=tt.convection_diffusion_multigrid_preconditioner(n, **kw_t))
        assert rt.status == int(rj.status) == 0
        assert abs(rt.iterations - int(rj.iterations)) <= 2
        assert rel_err(rt.x, rj.x) <= 1e-6


@pytest.mark.parametrize("smoother", ["rbgs", "auto"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_strong_peclet_counts_within_spread(solver, smoother):
    """γ = (2, 1) at 32² with the cycle (the fine level's Jacobi, rbgs or
    ellipse-Chebyshev below): the residuals spike by 10–40× between
    iterations and the counts move with the reductions' order (the
    bitwise test below holds the arithmetic), so the count is held to
    within 15% of JAX's (at least 2), the band chip_smoke.py holds the card
    to; both converge, and x agrees within 1e-6."""
    n = 32
    rj, rt, _, b = _solve_both(solver, n, f"mg-{smoother}", {"gamma": (2.0, 1.0)})
    it_j = int(rj.iterations)
    assert rt.status == int(rj.status) == 0
    assert abs(rt.iterations - it_j) <= max(2, 0.15 * it_j), (rt.iterations, it_j)
    assert rel_err(rt.x, rj.x) <= 1e-6
    assert float(rt.residual) < 1e-9


def _numpy_dot(a, b):
    return np.asarray(np.dot(np.asarray(a).ravel(), np.asarray(b).ravel()))


@pytest.mark.parametrize("solver,precond", [
    (s, p) for s in ("cgs", "tfqmr", "bicgstabl") for p in (None, "mg", "mg-rbgs-strong")])
def test_bitwise_with_shared_reductions(solver, precond, monkeypatch):
    """The port's arithmetic is JAX's: with both packages' inner products
    (and norms) taken by one numpy dot, and JAX run op by op
    (``disable_jit``: jitted, XLA:CPU contracts y + αx into fused
    multiply-adds), x is bitwise JAX's, the iterations and status equal,
    the history within one ulp. torch's CPU float64 sqrt is not always
    correctly rounded (it can differ from math.sqrt by one ulp, where XLA's
    and CUDA's do not), and TFQMR's rotation feeds a square root into the
    recurrence, so here torch.sqrt is numpy's. So every difference in the
    other tests comes from the order in which the reductions sum, and
    TFQMR's also from that rounding."""
    import importlib

    real_sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: torch.as_tensor(np.sqrt(t.numpy()))
                        if t.device.type == "cpu" else real_sqrt(t))
    jmod = importlib.import_module(f"gmres_tpu.solvers.{solver}")
    tmod = importlib.import_module(f"gmres_tpu_torch.solvers.{solver}")
    for mod, wrap, sqrt in ((jmod, jnp.asarray, jnp.sqrt), (tmod, torch.as_tensor, torch.sqrt)):
        monkeypatch.setattr(mod, "tree_vdot", lambda a, b, w=wrap: w(_numpy_dot(a, b)))
        monkeypatch.setattr(mod, "batched_vdot", lambda pairs, w=wrap: (
            jnp.stack if w is jnp.asarray else torch.stack)([w(_numpy_dot(a, b)) for a, b in pairs]))
        if hasattr(mod, "tree_norm"):
            monkeypatch.setattr(mod, "tree_norm", lambda a, w=wrap, s=sqrt: s(w(_numpy_dot(a, a))))
    n = 32
    g, sm = ((2.0, 1.0), "rbgs") if precond == "mg-rbgs-strong" else ((0.4, 0.2), "jacobi")
    opj, opt = gt.convection_diffusion_operator(n, *g), tt.convection_diffusion_operator(n, *g)
    b = np.asarray(opj(jnp.ones((n, n))))
    mj = gt.convection_diffusion_multigrid_preconditioner(n, *g, smoother=sm) if precond else None
    mt = tt.convection_diffusion_multigrid_preconditioner(n, *g, smoother=sm) if precond else None
    fj, ft = SOLVERS[solver]
    # Unpreconditioned, and at γ = (2, 1), a run of a few iterations (JAX op
    # by op is slow); the rest run to convergence.
    kw = {"max_iterations": {None: 40, "mg-rbgs-strong": 6}.get(precond, 10_000)}
    with jax.disable_jit():
        rj = fj(opj, jnp.asarray(b), M=mj, **kw)
    rt = ft(opt, to_torch(b), M=mt, **kw)
    assert rt.iterations == int(rj.iterations) and rt.status == int(rj.status)
    np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    hj = np.asarray(rj.residual_history)
    assert np.all(np.abs(rt.residual_history.numpy() - hj) <= np.spacing(hj))


def test_poisson_solves_agree_with_np_residual():
    """An independent numpy check: TFQMR and CGS with cbpr2 on the 32²
    Poisson problem meet the absolute tolerance in float64."""
    n = 32
    b = np_poisson(np.ones((n, n)))
    op = tt.poisson_operator(n)
    for solver in (tt.cgs, tt.tfqmr, tt.bicgstabl):
        res = solver(op, to_torch(b), tol=1e-9, M=tt.chebyshev_preconditioner(op, 0.2, 8.2))
        assert res.status == 0
        assert np.linalg.norm(b - np_poisson(res.x.numpy())) < 1e-9
