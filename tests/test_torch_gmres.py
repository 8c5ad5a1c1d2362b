"""The slice as a whole: Householder GMRES of the PyTorch port against
gmres_tpu on the same seeded inputs, field by field."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gmres_tpu as gt
import gmres_tpu_torch as tt
from tests.golden import golden_gmres_householder
from tests.torch_parity import np_poisson, rel_err, seeded, total_inner


def _fields(res):
    """The JAX result fields as numpy values (either package)."""
    if isinstance(res, tt.GmresResult):
        return res.to_numpy()
    return {k: np.asarray(getattr(res, k)) for k in
            ("x", "iterations", "restarts", "residual", "status",
             "residual_history", "v_err")}


def _assert_same_counts(ft, fj):
    for k in ("iterations", "restarts", "status"):
        assert int(ft[k]) == int(fj[k]), (k, ft[k], fj[k])


def _assert_fields_close(ft, fj, rtol):
    """Counts identical; x, residual and history to rtol (the history and
    the residual are already relative to ‖b‖, and below ~1e-7 of it their
    last digits are rounding of ‖b‖-sized sums: atol 1e-15 is that floor);
    v_err at its rounding floor (entries are sums of squared dot products
    of ~1e-16)."""
    _assert_same_counts(ft, fj)
    assert rel_err(ft["x"], fj["x"]) < rtol
    np.testing.assert_allclose(ft["residual_history"], fj["residual_history"],
                               rtol=rtol, atol=1e-15)
    np.testing.assert_allclose(ft["residual"], fj["residual"], rtol=rtol, atol=1e-15)
    np.testing.assert_allclose(ft["v_err"], fj["v_err"], rtol=0, atol=1e-26)


def _poisson_rhs(n):
    return np_poisson(np.ones((n, n)))


@pytest.mark.parametrize("max_restarts", [1, 100])
def test_graft_entry_configuration(max_restarts):
    """__graft_entry__'s flagship: 64², m=30, tol 1e-8, cbpr2, float64 —
    one cycle (a full 30-column basis, non-trivial v_err) and the whole
    solve."""
    n = 64
    b = _poisson_rhs(n)
    rj = gt.gmres(gt.poisson_operator(n), jnp.asarray(b), restart=30, tol=1e-8,
                  max_restarts=max_restarts,
                  M=gt.chebyshev_preconditioner(gt.poisson_operator(n), 0.2, 8.2))
    rt = tt.gmres(tt.poisson_operator(n), tt.as_tensor(b, "cpu"), restart=30,
                  tol=1e-8, max_restarts=max_restarts,
                  M=tt.chebyshev_preconditioner(tt.poisson_operator(n), 0.2, 8.2))
    _assert_fields_close(rt.to_numpy(), _fields(rj), 1e-10)
    if max_restarts == 100:
        assert rt.converged
        # one read per restart plus the initial residual, one per inner
        # iteration that tested convergence
        assert rt.host_syncs == (1 + rt.restarts + (rt.restarts - 1) * 29
                                 + min(rt.iterations, 29))


@pytest.mark.parametrize("n", [64, 128])
def test_bench_mg_configuration(n):
    """bench.py's default mg configuration: m=10, float32 Arnoldi cycles,
    certified on the true residual. float32 reductions sum in another order
    in PyTorch than in XLA, so the counts may differ by an iteration."""
    b = _poisson_rhs(n)
    rj = gt.gmres(gt.poisson_operator(n), jnp.asarray(b), restart=10, tol=1e-8,
                  M=gt.poisson_multigrid_preconditioner(n), compute_v_err=False,
                  inner_dtype=jnp.float32, certify="true")
    rt = tt.gmres(tt.poisson_operator(n), tt.as_tensor(b, "cpu"), restart=10,
                  tol=1e-8, M=tt.poisson_multigrid_preconditioner(n),
                  compute_v_err=False, inner_dtype=torch.float32, certify="true")
    assert int(rj.status) == rt.status == 0
    assert rt.x.dtype == torch.float64
    for x in (rt.x.numpy(), np.asarray(rj.x)):
        assert np.linalg.norm(b - np_poisson(x)) / np.linalg.norm(b) <= 1e-8
    assert abs(total_inner(rt, 10) - total_inner(rj, 10)) <= 2
    # Both solutions sit within the certified 1e-8 residual of x* = 1.
    assert rel_err(rt.x, rj.x) < 1e-6
    assert float(rt.residual) <= 1e-8


def test_householder_matches_numpy_golden():
    """The dense-matrix path against the explicit-reflector numpy oracle
    of tests/golden.py (the same check tests/test_gmres.py makes of JAX)."""
    nsize, m = 10, 25
    a = tt.poisson_matrix(nsize, device="cpu")
    np.testing.assert_array_equal(a.numpy(), np.asarray(gt.poisson_matrix(nsize)))
    bf = a @ torch.ones(nsize * nsize, dtype=torch.float64)
    res = tt.gmres(a, bf, restart=m, tol=1e-10, breakdown_check=False)
    _, n_out, st, ferr, _ = golden_gmres_householder(
        lambda v: a.numpy() @ v, bf.numpy(), m, 1e-10, 1000)
    assert res.iterations == n_out and res.restarts == st
    np.testing.assert_allclose(res.residual_history[:n_out].numpy(), ferr[:n_out],
                               rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("opts", [
    {"check_inner": False},
    {"breakdown_check": False, "certify": "true"},
    {"x0": "seeded", "compute_v_err": True},
    {"inner_dtype": "float32", "certify": "preconditioned"},
])
def test_options_match(opts):
    n = 16
    b = seeded(800, (n, n))
    jo, to = dict(opts), dict(opts)
    if "x0" in opts:
        x0 = seeded(801, (n, n))
        jo["x0"], to["x0"] = jnp.asarray(x0), tt.as_tensor(x0, "cpu")
    if "inner_dtype" in opts:
        jo["inner_dtype"], to["inner_dtype"] = jnp.float32, torch.float32
    kw = dict(restart=8, tol=1e-9, max_restarts=200)
    rj = gt.gmres(gt.poisson_operator(n), jnp.asarray(b), **kw, **jo)
    rt = tt.gmres(tt.poisson_operator(n), tt.as_tensor(b, "cpu"), **kw, **to)
    ft, fj = rt.to_numpy(), _fields(rj)
    if "inner_dtype" in opts:
        assert abs(total_inner(rt, 8) - total_inner(rj, 8)) <= 2
        assert int(ft["status"]) == int(fj["status"]) == 0
        assert rel_err(ft["x"], fj["x"]) < 1e-6
    else:
        _assert_fields_close(ft, fj, 1e-9)
    if opts.get("check_inner") is False:
        assert rt.host_syncs == 1 + rt.restarts


def test_dense_matrix_and_clamp():
    """A dense numpy operator on a flat b, with restart > n clamped to n−1."""
    rng = np.random.default_rng(802)
    a = rng.standard_normal((6, 6)) + 6.0 * np.eye(6)
    b = rng.standard_normal(6)
    rj = gt.gmres(a, jnp.asarray(b), restart=30, tol=1e-12)
    rt = tt.gmres(a, tt.as_tensor(b, "cpu"), restart=30, tol=1e-12)
    assert rt.residual_history.shape == (5,)
    _assert_fields_close(rt.to_numpy(), _fields(rj), 1e-9)
    # float32 cycles on a float64 dense matrix
    rt32 = tt.gmres(torch.as_tensor(a), tt.as_tensor(b, "cpu"), restart=30,
                    tol=1e-12, inner_dtype=torch.float32)
    assert rt32.converged


@pytest.mark.parametrize("a_val", [2.0, 0.0])
def test_one_by_one(a_val):
    a = np.array([[a_val]])
    b = np.array([3.0])
    x0 = np.array([0.5])
    rj = gt.gmres(a, jnp.asarray(b), x0=jnp.asarray(x0))
    rt = tt.gmres(a, tt.as_tensor(b, "cpu"), x0=tt.as_tensor(x0, "cpu"))
    ft, fj = rt.to_numpy(), _fields(rj)
    _assert_same_counts(ft, fj)
    for k in ("x", "residual", "residual_history", "v_err"):
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-15)


def test_probes():
    """The verify-skill probes: bad variant / orthogonalization / certify
    raise ValueError; max_restarts hit gives status 1; b = 0 converges in
    0 iterations; the MGSR variant runs (it raised before it was ported)."""
    n = 8
    op = tt.poisson_operator(n)
    b = tt.as_tensor(seeded(803, (n, n)), "cpu")
    with pytest.raises(ValueError):
        tt.gmres(op, b, variant="nope")
    with pytest.raises(ValueError):
        tt.gmres(op, b, variant="mgsr", orthogonalization="nope")
    with pytest.raises(ValueError):
        tt.gmres(op, b, certify="nope")
    with pytest.raises(ValueError, match="real-only"):
        tt.gmres(op, b.to(torch.complex128))
    assert tt.gmres(op, b, variant="mgsr").converged
    with pytest.raises(TypeError):
        tt.gmres("not an operator", b)

    res = tt.gmres(op, b, restart=2, tol=1e-14, max_restarts=3)
    assert res.status == tt.SolverStatus.MAX_ITERATIONS and res.restarts == 3

    zero = torch.zeros((n, n), dtype=torch.float64)
    rt = tt.gmres(op, zero)
    rj = gt.gmres(gt.poisson_operator(n), jnp.zeros((n, n)))
    ft, fj = rt.to_numpy(), _fields(rj)
    _assert_same_counts(ft, fj)
    assert rt.status == 0 and rt.iterations == 0 and rt.restarts == 0
    assert not rt.x.any() and rt.host_syncs == 1
    np.testing.assert_array_equal(ft["residual_history"], fj["residual_history"])


# ---------------------------------------------------------------------------
# The MGSR variant.
# ---------------------------------------------------------------------------


def _mgsr_pair(n, ortho, precond, rhs, **kw):
    """gmres_tpu and the port, MGSR, on the same float64 rhs."""
    b = (_poisson_rhs(n) if rhs == "ones" else seeded(810, (n, n)))
    common = dict(restart=20, tol=1e-10, max_restarts=300, variant="mgsr",
                  orthogonalization=ortho)
    jkw, tkw = dict(kw), dict(kw)
    if "inner_dtype" in kw:
        jkw["inner_dtype"], tkw["inner_dtype"] = jnp.float32, torch.float32
    mj = (gt.chebyshev_preconditioner(gt.poisson_operator(n), 0.2, 8.2)
          if precond else None)
    mt = (tt.chebyshev_preconditioner(tt.poisson_operator(n), 0.2, 8.2)
          if precond else None)
    rj = gt.gmres(gt.poisson_operator(n), jnp.asarray(b), M=mj, **common, **jkw)
    rt = tt.gmres(tt.poisson_operator(n), tt.as_tensor(b, "cpu"), M=mt,
                  **common, **tkw)
    return b, rj, rt


def _assert_mgsr_close(ft, fj):
    """Counts equal; x to 1e-9; the residual history and the residual (both
    relative to ‖b‖) to 1e-9 above an absolute 1e-12: the last cycle starts
    from a true residual of ~1e-10·‖b‖ recomputed at every restart, which
    carries the rounding of all earlier cycles (up to 14 here); v_err (the
    cumulative chain, ~1e-15 for a float64 basis) to its rounding floor of
    1e-14."""
    _assert_same_counts(ft, fj)
    assert rel_err(ft["x"], fj["x"]) < 1e-9
    np.testing.assert_allclose(ft["residual_history"], fj["residual_history"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ft["residual"], fj["residual"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ft["v_err"], fj["v_err"], rtol=0, atol=1e-14)


@pytest.mark.parametrize("ortho", ["cgs2", "mgs2"])
@pytest.mark.parametrize("n,precond,rhs", [(24, True, "ones"), (32, False, "ones"),
                                           (48, True, "seeded"), (64, True, "ones")])
def test_mgsr_matches_jax(ortho, n, precond, rhs):
    _, rj, rt = _mgsr_pair(n, ortho, precond, rhs)
    ft = rt.to_numpy()
    assert rt.converged
    _assert_mgsr_close(ft, _fields(rj))
    assert 0 < ft["v_err"].max() < 1e-13


@pytest.mark.parametrize("ortho", ["cgs2", "mgs2"])
def test_mgsr_mixed_certified_matches_jax(ortho):
    """float32 Arnoldi cycles certified on the float64 true residual: the
    float32 sums run in another order than XLA's, so the inner iterations
    may differ, by at most 2 in all."""
    b, rj, rt = _mgsr_pair(48, ortho, True, "ones", inner_dtype="f32",
                           certify="true")
    assert int(rj.status) == rt.status == 0
    assert abs(total_inner(rt, 20) - total_inner(rj, 20)) <= 2
    for x in (rt.x.numpy(), np.asarray(rj.x)):
        assert np.linalg.norm(b - np_poisson(x)) / np.linalg.norm(b) <= 1e-10
    assert rt.x.dtype == torch.float64 and rt.v_err.max() < 1e-5


def test_mgsr_options_match_jax():
    """check_inner=False (restart-boundary checks only: one host read per
    restart) and an x0 give JAX's counts and history."""
    n = 16
    b, x0 = seeded(811, (n, n)), seeded(812, (n, n))
    kw = dict(restart=8, tol=1e-9, max_restarts=200, variant="mgsr",
              check_inner=False)
    rj = gt.gmres(gt.poisson_operator(n), jnp.asarray(b), x0=jnp.asarray(x0), **kw)
    rt = tt.gmres(tt.poisson_operator(n), tt.as_tensor(b, "cpu"),
                  x0=tt.as_tensor(x0, "cpu"), **kw)
    _assert_mgsr_close(rt.to_numpy(), _fields(rj))
    assert rt.host_syncs == 1 + rt.restarts


@pytest.mark.parametrize("ortho", ["cgs2", "mgs2"])
def test_mgsr_complex_dense_matches_jax(ortho):
    """MGSR on a complex dense operator (the Householder variant is
    real-only): conjugated projections, a real residual history and v_err."""
    rng = np.random.default_rng(813)
    n = 40
    a = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + 20.0 * np.eye(n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    kw = dict(restart=10, tol=1e-10, variant="mgsr", orthogonalization=ortho)
    rj = gt.gmres(a, jnp.asarray(b), **kw)
    rt = tt.gmres(a, tt.as_tensor(b, "cpu"), **kw)
    assert rt.converged and rt.x.dtype == torch.complex128
    assert rt.residual_history.dtype == rt.v_err.dtype == torch.float64
    _assert_mgsr_close(rt.to_numpy(), _fields(rj))
