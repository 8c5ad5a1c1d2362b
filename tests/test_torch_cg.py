"""Conjugate gradients of the PyTorch port against gmres_tpu.cg on the same
seeded inputs: classic and pipelined, on the 16² HYB sparse operator and on
the stencil operator, with the reference's cbpr2 preconditioner."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gmres_tpu as gt
from gmres_tpu.ops import sparse as jsp
import gmres_tpu_torch as tt
from tests.torch_parity import np_poisson, rel_err, seeded, to_np, to_torch

N = 16


def _operators(kind):
    """(JAX operator, port operator, the shape of b)."""
    if kind == "hyb":
        mj = jsp.csr_to_hyb(jsp.poisson_csr(N))
        return (jsp.sparse_operator(mj),
                tt.sparse_operator(tt.csr_to_hyb(tt.poisson_csr(N, device="cpu"))),
                (N * N,))
    return gt.poisson_operator(N), tt.poisson_operator(N), (N, N)


def _solve_both(kind, b, **kw):
    opj, opt, _ = _operators(kind)
    extra_j, extra_t = {}, {}
    if kw.pop("cbpr2", True):
        extra_j["M"] = gt.chebyshev_preconditioner(opj, 0.2, 8.2)
        extra_t["M"] = tt.chebyshev_preconditioner(opt, 0.2, 8.2)
    x0 = kw.pop("x0", None)
    if x0 is not None:
        extra_j["x0"], extra_t["x0"] = jnp.asarray(x0), to_torch(x0)
    rj = gt.cg(opj, jnp.asarray(b), **kw, **extra_j)
    rt = tt.cg(opt, to_torch(b), **kw, **extra_t)
    return rj, rt


def _assert_match(rj, rt, b, iter_slack=0):
    """x within 1e-8 of max|x|; status equal; iterations equal (or within
    iter_slack where the test says why); the residual and the history over
    the performed iterations within 1e-8 relative, with an absolute floor
    of 1e-13·‖b‖: below that, the residuals are the rounding of ‖b‖-sized
    sums, which the two packages add in different orders (the pipelined
    recurrences amplify it most)."""
    ft = rt.to_numpy()
    it_j, it_t = int(rj.iterations), ft["iterations"]
    assert int(rj.status) == ft["status"]
    assert abs(it_j - it_t) <= iter_slack, (it_j, it_t)
    assert rel_err(ft["x"], rj.x) < 1e-8
    floor = 1e-13 * float(np.linalg.norm(b))
    np.testing.assert_allclose(ft["residual"], np.asarray(rj.residual),
                               rtol=1e-8, atol=floor)
    k = min(it_j, it_t)
    hj = np.asarray(rj.residual_history)
    np.testing.assert_allclose(ft["residual_history"][:k], hj[:k],
                               rtol=1e-8, atol=floor)
    # Padded with the final residual past the last iteration.
    assert ft["residual_history"].shape == hj.shape
    np.testing.assert_array_equal(ft["residual_history"][it_t:],
                                  np.full(hj.size - it_t, ft["residual"]))
    assert rt.host_syncs >= it_t + 2


@pytest.mark.parametrize("variant", ["classic", "pipelined"])
@pytest.mark.parametrize("kind", ["hyb", "stencil"])
def test_cbpr2_cg_matches_jax(kind, variant):
    """tol 1e-9 absolute, the cg program's configuration at 16²."""
    b = seeded(901, _operators(kind)[2])
    rj, rt = _solve_both(kind, b, tol=1e-9, variant=variant)
    assert rt.converged and int(rj.status) == 0
    _assert_match(rj, rt, b)


@pytest.mark.parametrize("variant", ["classic", "pipelined"])
def test_rtol_and_x0(variant):
    """rtol raises the target to rtol·‖b‖ (here above tol); x0 is the
    start. Unpreconditioned on the HYB operator."""
    b = seeded(902, (N * N,))
    x0 = seeded(903, (N * N,))
    rj, rt = _solve_both("hyb", b, tol=1e-12, rtol=1e-6, x0=x0, cbpr2=False,
                         variant=variant)
    assert rt.converged
    assert float(rt.residual) < 1e-6 * np.linalg.norm(b)
    _assert_match(rj, rt, b)


@pytest.mark.parametrize("variant", ["classic", "pipelined"])
def test_zero_rhs_converges_without_iterating(variant):
    b = np.zeros((N, N))
    rj, rt = _solve_both("stencil", b, tol=1e-9, variant=variant)
    assert rt.status == 0 and rt.iterations == 0
    assert float(rt.residual) == 0.0 and not to_np(rt.x).any()
    _assert_match(rj, rt, b)


@pytest.mark.parametrize("variant", ["classic", "pipelined"])
def test_max_iterations_hit(variant):
    b = seeded(904, (N, N))
    rj, rt = _solve_both("stencil", b, tol=1e-12, max_iterations=7,
                         cbpr2=False, variant=variant)
    assert rt.status == 1 and rt.iterations == 7
    assert rt.residual_history.shape == (7,)
    _assert_match(rj, rt, b)


def test_pipelined_certification_miss_matches_jax():
    """cbpr2 CG on the 300² HYB operator, b = A·1, tol 1e-9 (the cg
    program's smallest grid): both packages' classic solves converge, and
    both pipelined solves stop on the recursive residual at the same
    iteration as classic CG, then miss the certification of the true
    residual (just above tol) and end in BREAKDOWN — the drift of the
    Ghysels–Vanroose recurrences, reproduced, not a fault of the port."""
    n = 300
    b = np_poisson(np.ones((n, n))).reshape(-1)
    opj = jsp.sparse_operator(jsp.csr_to_hyb(jsp.poisson_csr(n)))
    opt = tt.sparse_operator(tt.csr_to_hyb(tt.poisson_csr(n, device="cpu")))
    out = {}
    for variant in ("classic", "pipelined"):
        rj = gt.cg(opj, jnp.asarray(b), tol=1e-9, variant=variant,
                   M=gt.chebyshev_preconditioner(opj, 0.2, 8.2))
        rt = tt.cg(opt, to_torch(b), tol=1e-9, variant=variant,
                   M=tt.chebyshev_preconditioner(opt, 0.2, 8.2))
        assert rt.status == int(rj.status)
        assert rt.iterations == int(rj.iterations)
        assert rel_err(rt.x, rj.x) < 1e-8
        out[variant] = rt
    assert out["classic"].status == 0 and out["pipelined"].status == 2
    assert out["pipelined"].iterations == out["classic"].iterations
    assert 1e-9 <= float(out["pipelined"].residual) < 1.1e-9


def test_float32_solve_matches():
    """A float32 solve compares in float32 (tol rounded to float32, as JAX
    compares). Iterations within 1: float32 sums in another order can move
    the crossing of tol by one iteration."""
    b = seeded(905, (N * N,)).astype(np.float32)
    mj = jsp.csr_to_hyb(jsp.poisson_csr(N, dtype=jnp.float32))
    mt = tt.csr_to_hyb(tt.poisson_csr(N, dtype=torch.float32, device="cpu"))
    rj = gt.cg(jsp.sparse_operator(mj), jnp.asarray(b), tol=1e-4)
    rt = tt.cg(tt.sparse_operator(mt), to_torch(b), tol=1e-4)
    assert rt.x.dtype == torch.float32 and rt.residual_history.dtype == torch.float32
    assert rt.status == int(rj.status) == 0
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert rel_err(rt.x, rj.x) < 1e-4


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown cg variant"):
        tt.cg(tt.poisson_operator(4), torch.ones((4, 4), dtype=torch.float64),
              variant="chronopoulos")


def test_solve_result_fields():
    res = tt.cg(tt.poisson_operator(4), torch.ones((4, 4), dtype=torch.float64),
                tol=1e-10)
    assert isinstance(res, tt.SolveResult) and res.converged
    assert isinstance(res.iterations, int) and isinstance(res.status, int)
    assert set(res.to_numpy()) == {"x", "iterations", "residual", "status",
                                   "residual_history"}
