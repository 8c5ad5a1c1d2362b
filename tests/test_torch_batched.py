"""Batched solves of the port (``gmres_tpu_torch.batched_solve``) against
gmres_tpu's ``jax.vmap`` of the same solve on the same numpy inputs (the
cases of tests/test_batched.py, at its sizes), and each lane against the
port's own sequential solve.

Against JAX: per-lane iterations, restarts and status equal, and x within
the tolerance of the solver's sequential parity test (CG 1e-8 relative,
test_torch_cg.py; GMRES 1e-6, test_torch_gmres.py; BiCGSTAB 1e-6,
test_torch_bicgstab.py). Against the port's sequential solve: iterations,
restarts and status exact and x within 1e-12 (JAX's bound in
test_vmap_per_lane_parity): each lane runs its sequential solve's steps.
``test_vmap_newton_continuation`` is mirrored in test_torch_batched_newton.py,
the other solvers in test_torch_batched_family.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import fused, stencil
from tests.torch_parity import rel_err, to_np, to_torch, total_inner


def _rhs_batch(n, k):
    """tests/test_batched.py's batch: xs standard normal from seed 0, bs its
    Poisson images (JAX's, as numpy)."""
    xs = np.random.default_rng(0).standard_normal((k, n, n))
    bs = np.asarray(jax.vmap(gt.poisson_operator(n))(jnp.asarray(xs)))
    return xs, bs


def _match_jax(res, rj, x_rtol, fields=("iterations", "status")):
    """Per lane: the counts equal JAX's vmapped solve's, x within x_rtol."""
    for k in range(res.x.shape[0]):
        for name in fields:
            assert int(getattr(res, name)[k]) == int(getattr(rj, name)[k]), (name, k)
        assert rel_err(res.x[k], np.asarray(rj.x[k])) < x_rtol, k


def _match_sequential(res, solve, bs, fields=("iterations", "status")):
    """Per lane: the counts of the port's sequential solve exactly, x
    within 1e-12."""
    for k in range(bs.shape[0]):
        single = solve(to_torch(bs[k]))
        for name in fields:
            assert int(getattr(res, name)[k]) == int(getattr(single, name)), (name, k)
        np.testing.assert_allclose(to_np(res.x[k]), to_np(single.x), rtol=0, atol=1e-12)


def test_vmap_cg():
    n, k = 16, 4
    xs, bs = _rhs_batch(n, k)
    kw = dict(tol=1e-10, max_iterations=2000)
    rj = jax.vmap(lambda b: gt.cg(gt.poisson_operator(n), b, **kw))(jnp.asarray(bs))
    op = tt.poisson_operator(n)
    res = tt.batched_solve(tt.cg, op, to_torch(bs), **kw)
    assert res.x.shape == (k, n, n) and res.iterations.shape == (k,)
    assert bool(torch.all(res.status == 0))
    np.testing.assert_allclose(to_np(res.x), xs, atol=1e-7)
    _match_jax(res, rj, 1e-8)
    _match_sequential(res, lambda b: tt.cg(op, b, **kw), bs)


def test_vmap_gmres():
    n, k = 12, 3
    xs, bs = _rhs_batch(n, k)
    kw = dict(restart=30, tol=1e-10, max_restarts=100, compute_v_err=False)
    rj = jax.vmap(lambda b: gt.gmres(gt.poisson_operator(n), b, **kw))(jnp.asarray(bs))
    op = tt.poisson_operator(n)
    res = tt.batched_solve(tt.gmres, op, to_torch(bs), **kw)
    assert res.x.shape == (k, n, n)
    assert bool(torch.all(res.status == 0))
    np.testing.assert_allclose(to_np(res.x), xs, atol=1e-6)
    fields = ("iterations", "restarts", "status")
    _match_jax(res, rj, 1e-6, fields)
    _match_sequential(res, lambda b: tt.gmres(op, b, **kw), bs, fields)


def test_vmap_bicgstab():
    n, k = 12, 3
    xs, bs = _rhs_batch(n, k)
    kw = dict(tol=1e-10, max_iterations=2000)
    rj = jax.vmap(lambda b: gt.bicgstab(gt.poisson_operator(n), b, **kw))(jnp.asarray(bs))
    op = tt.poisson_operator(n)
    res = tt.batched_solve(tt.bicgstab, op, to_torch(bs), **kw)
    assert bool(torch.all(res.status == 0))
    np.testing.assert_allclose(to_np(res.x), xs, atol=1e-6)
    _match_jax(res, rj, 1e-6)
    _match_sequential(res, lambda b: tt.bicgstab(op, b, **kw), bs)


def test_vmap_per_lane_parity():
    """JAX's jit(vmap) of CG at 32², six lanes: each lane's iterations and
    status those of JAX's batched lane and of the port's sequential solve,
    x within 1e-12 of the sequential solve's."""
    n = 32
    bs = np.random.default_rng(3).standard_normal((6, n, n))
    kw = dict(tol=1e-10, max_iterations=500)
    rj = jax.jit(jax.vmap(lambda b: gt.cg(gt.poisson_operator(n), b, **kw)))(
        jnp.asarray(bs))
    op = tt.poisson_operator(n)
    res = tt.batched_solve(tt.cg, op, to_torch(bs), **kw)
    _match_jax(res, rj, 1e-8)
    _match_sequential(res, lambda b: tt.cg(op, b, **kw), bs)


def test_vmap_over_operator_parameters():
    """One batched solve sweeps the operator family: per-lane convection
    strengths, A(v, γ) with γ split per lane, which reaches K1's route with
    per-lane coefficients. BiCGSTAB's count on this family moves with the
    order of its reductions: JAX's own counts for the γ = 0.2 lane are 75
    under vmap, 81 eager and 84 under jit. So each lane's count is held
    within 15% of JAX's vmapped lane (chip_smoke.py's BICGSTAB_SPREAD), the
    status equal and x within 1e-6; against the port's sequential solve the
    count is exact."""
    from gmres_tpu.models.convection_diffusion import convection_diffusion_apply as cd_j
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply

    n = 32
    gammas = np.asarray([0.0, 0.2, 0.4, 0.8])
    kw = dict(tol=1e-9, max_iterations=2000)

    def solve_j(gx):
        op = lambda v: cd_j(v, gx, 0.5 * gx)  # noqa: E731
        return gt.bicgstab(op, op(jnp.ones((n, n))), **kw)

    rj = jax.jit(jax.vmap(solve_j))(jnp.asarray(gammas))

    def op(v, g):
        return convection_diffusion_apply(v, g, 0.5 * g)

    g_t = to_torch(gammas)
    ones = torch.ones((n, n), dtype=torch.float64)
    bs = torch.stack([op(ones, g) for g in g_t])
    calls = stencil.stencil_5pt_pallas.block_calls
    res = tt.batched_solve(tt.bicgstab, op, bs, lane_args=(g_t,), **kw)
    assert stencil.stencil_5pt_pallas.block_calls > calls
    assert bool(torch.all(res.status == tt.SolverStatus.CONVERGED))
    np.testing.assert_allclose(to_np(res.x), 1.0, atol=1e-7)
    for k in range(len(gammas)):
        it_j = int(rj.iterations[k])
        assert abs(int(res.iterations[k]) - it_j) <= 0.15 * it_j, (k, res.iterations, it_j)
        assert int(res.status[k]) == int(rj.status[k])
        assert rel_err(res.x[k], np.asarray(rj.x[k])) < 1e-6
    for k, g in enumerate(g_t):
        single = tt.bicgstab(lambda v: op(v, g), bs[k], **kw)
        assert int(res.iterations[k]) == single.iterations
        np.testing.assert_allclose(to_np(res.x[k]), to_np(single.x), rtol=0, atol=1e-12)


def test_vmap_cg_multigrid():
    """CG with the Poisson V-cycle as M at 32², four lanes: JAX's vmapped
    solve's counts, the sequential solves', and one batched call of each
    kernel entry per block application (the longest lane's applications)."""
    n = 32
    bs = np.random.default_rng(5).standard_normal((4, n, n))
    kw = dict(tol=1e-10, max_iterations=200)
    rj = jax.vmap(lambda b: gt.cg(gt.poisson_operator(n), b,
                                  M=gt.poisson_multigrid_preconditioner(n), **kw))(
        jnp.asarray(bs))
    op, m = tt.poisson_operator(n), tt.poisson_multigrid_preconditioner(n)
    before = (stencil.stencil_5pt_pallas.block_calls,
              fused.poly_stencil_smoother_pallas.block_calls,
              stencil.residual_restrict.block_calls)
    res = tt.batched_solve(tt.cg, op, to_torch(bs), M=m, **kw)
    k1, k2, k1rr = (stencil.stencil_5pt_pallas.block_calls - before[0],
                    fused.poly_stencil_smoother_pallas.block_calls - before[1],
                    stencil.residual_restrict.block_calls - before[2])
    longest = int(res.iterations.max())
    # A: every iteration and the certification; M: the first and every
    # iteration (a 2-level cycle: 3 smoothers, one form of each kind).
    assert k1 == longest + 1 and k2 == 3 * (longest + 1) and k1rr == longest + 1
    # One read an iteration for the batch: the initial and final reads.
    assert res.host_syncs == longest + 2
    _match_jax(res, rj, 1e-8)
    _match_sequential(res, lambda b: tt.cg(op, b, M=m, **kw), bs)


def test_vmap_gmres_mixed_multigrid():
    """Householder GMRES(10) with float32 Arnoldi cycles and the V-cycle,
    certified on the float64 true residual, three lanes at 32². The float32
    cycles round their reductions unlike JAX's, so against JAX each lane's
    total inner iterations are held within 2, as test_torch_gmres.py holds
    the sequential mixed solve; against the port's sequential solve the
    counts are exact."""
    n = 32
    bs = np.random.default_rng(7).standard_normal((3, n, n))
    kw = dict(restart=10, tol=1e-10, max_restarts=50, certify="true",
              compute_v_err=False)
    rj = jax.vmap(lambda b: gt.gmres(gt.poisson_operator(n), b,
                                     M=gt.poisson_multigrid_preconditioner(n),
                                     inner_dtype=jnp.float32, **kw))(jnp.asarray(bs))
    op, m = tt.poisson_operator(n), tt.poisson_multigrid_preconditioner(n)
    res = tt.batched_solve(tt.gmres, op, to_torch(bs), M=m,
                           inner_dtype=torch.float32, **kw)
    assert bool(torch.all(res.status == 0))
    for k in range(bs.shape[0]):
        inner = (int(res.restarts[k]) - 1) * 10 + int(res.iterations[k])
        assert abs(inner - total_inner(jax.tree.map(lambda a: a[k], rj), 10)) <= 2, k
        assert int(res.status[k]) == int(rj.status[k])
        assert rel_err(res.x[k], np.asarray(rj.x[k])) < 1e-6
    fields = ("iterations", "restarts", "status")
    _match_sequential(res, lambda b: tt.gmres(op, b, M=m, inner_dtype=torch.float32,
                                              **kw), bs, fields)


def test_vmap_gmres_mgsr_and_pipelined_cg():
    """The other variants the steps carry: MGSR GMRES and pipelined CG, each
    lane its sequential solve."""
    n, k = 12, 3
    _, bs = _rhs_batch(n, k)
    op = tt.poisson_operator(n)
    kw = dict(restart=8, tol=1e-9, variant="mgsr", compute_v_err=False)
    res = tt.batched_solve(tt.gmres, op, to_torch(bs), **kw)
    _match_sequential(res, lambda b: tt.gmres(op, b, **kw), bs,
                      ("iterations", "restarts", "status"))
    kw = dict(tol=1e-9, variant="pipelined")
    res = tt.batched_solve(tt.cg, op, to_torch(bs), **kw)
    _match_sequential(res, lambda b: tt.cg(op, b, **kw), bs)


def test_unsupported_solver_and_arguments_raise():
    op = tt.poisson_operator(8)
    bs = torch.ones((2, 8, 8), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.batched_solve(tt.arnoldi_eigs_real, op, bs)
    with pytest.raises(ValueError, match="lanes"):
        tt.batched_solve(tt.cg, lambda v, g: op(v), bs, lane_args=(torch.ones(3),))
