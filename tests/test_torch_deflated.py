"""GMRES-DR of the PyTorch port against gmres_tpu on the same numpy inputs,
on the CPU, float64 unless a case says otherwise (GCRO-DR:
tests/test_torch_gcrodr.py).

The harmonic Ritz vectors come from different eigensolvers (LAPACK's
``geev`` on a float64 CPU copy in the port, JAX's in-jit QR iteration);
on these cases the counts agree exactly, and then x is within 1e-9 of
JAX's relative to max|x| and the residual histories within 1e-6. The
float32 case holds restarts and total inner iterations within 2.

gmres_tpu's ``gmres_dr`` never runs its ``deflation="subspace"`` route (a
nested function rebinds the argument's name before the test that reads
it, ``gmres_tpu/solvers/gmres_dr.py``:217, :225), so "subspace" is its
exact eig route, and the port does the same; "auto" is "eig" in the port
(JAX: "subspace" on a TPU).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu.solvers.gmres_dr as jdr
import gmres_tpu_torch as tt
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _total(res, m):
    return (int(res.restarts) - 1) * m + int(res.iterations)


def _op(pkg, model, n):
    if model == "poisson":
        return pkg.poisson_operator(n)
    return pkg.convection_diffusion_operator(n, *model)


def _b(model, n, seed=None):
    op = _op(gt, model, n)
    x = jnp.ones((n, n)) if seed is None else jnp.asarray(seeded(seed, (n, n)))
    return np.asarray(op(x))


# ---------------------------------------------------------------------------
# GMRES-DR.
# ---------------------------------------------------------------------------

# label: (model, n, preconditioner, keyword arguments, exact). exact: the
# counts agree exactly, and x and the history are compared.
DR_CASES = {
    "poisson-cbpr2-k4": ("poisson", 24, "cbpr2", {"restart": 16, "deflate": 4}, True),
    "poisson-cbpr2-k8": ("poisson", 24, "cbpr2", {"restart": 16, "deflate": 8}, True),
    "pairs-k4": ((2.0, 1.0), 24, None, {"restart": 16, "deflate": 4}, True),
    "pairs-k8": ((2.0, 1.0), 24, None, {"restart": 16, "deflate": 8}, True),
    "deflate0": ("poisson", 24, "cbpr2", {"restart": 16, "deflate": 0}, True),
    "mg": ((0.4, 0.2), 32, "mg", {"restart": 10, "deflate": 4}, True),
    "x0": ("poisson", 16, "cbpr2", {"restart": 12, "deflate": 4, "x0": True}, True),
    "max-restarts": ((2.0, 1.0), 16, None,
                     {"restart": 8, "deflate": 2, "tol": 1e-14, "max_restarts": 3}, True),
    "zero-b": ("poisson", 8, None, {"restart": 6, "deflate": 2, "zero_b": True}, True),
    "v-err": ("poisson", 16, "cbpr2",
              {"restart": 12, "deflate": 4, "compute_v_err": True}, True),
    "float32": ("poisson", 16, None,
                {"restart": 12, "deflate": 4, "tol": 1e-5, "float32": True}, False),
}


def _precond(pkg, op, name, model, n):
    if name == "cbpr2":
        return pkg.chebyshev_preconditioner(op, 0.2, 8.2)
    if name == "mg":
        return pkg.convection_diffusion_multigrid_preconditioner(n, *model)
    return None


def _dr_call(pkg, label, **extra):
    model, n, precond, kw, _ = DR_CASES[label]
    kw = {"tol": 1e-10, **kw, **extra}
    op = _op(pkg, model, n)
    m = _precond(pkg, op, precond, model, n)
    b = _b(model, n)
    if kw.pop("zero_b", False):
        b = np.zeros_like(b)
    if kw.pop("float32", False):
        b = b.astype(np.float32)
    conv = jnp.asarray if pkg is gt else to_torch
    if kw.pop("x0", False):
        kw["x0"] = conv(seeded(70, b.shape))
    fn = gt.gmres_dr if pkg is gt else tt.gmres_dr
    return fn(op, conv(b), M=m, **kw)


@functools.lru_cache(maxsize=None)
def _jax_dr(label):
    return _dr_call(gt, label)


@pytest.mark.parametrize("label", sorted(DR_CASES))
def test_gmres_dr_matches_jax(label):
    rj = _jax_dr(label)
    rt = _dr_call(tt, label)
    _, _, _, kw, exact = DR_CASES[label]
    m = kw["restart"]
    assert rt.status == int(rj.status)
    assert rt.x.dtype == to_torch(np.asarray(rj.x)).dtype
    if exact:
        assert (rt.restarts, rt.iterations) == (int(rj.restarts), int(rj.iterations))
        assert rel_err(rt.x, rj.x) <= 1e-9
        np.testing.assert_allclose(to_np(rt.residual_history),
                                   to_np(rj.residual_history), rtol=0, atol=1e-6)
        np.testing.assert_allclose(to_np(rt.v_err), to_np(rj.v_err), rtol=0, atol=1e-10)
    else:
        assert abs(rt.restarts - int(rj.restarts)) <= 2
        assert abs(_total(rt, m) - _total(rj, m)) <= 2
    if rt.status == 0 and not kw.get("zero_b"):
        assert float(rt.residual) < 10 * kw.get("tol", 1e-10)


def test_gmres_dr_host_syncs():
    """One read per inner iteration that tested convergence, one per cycle
    (its small state), the initial residual and the certification."""
    rt = _dr_call(tt, "poisson-cbpr2-k4")
    m, k = 16, 4
    # The first cycle starts at step 0, the deflated ones at k (k_eff may be
    # k + 1 where a pair straddles: not on Poisson).
    full = (m - 1) + (rt.restarts - 2) * (m - k - 1)
    assert rt.host_syncs == 2 + rt.restarts + full + min(rt.iterations - k, m - k - 1)


def test_gmres_dr_deflate0_is_restarted_right_preconditioned_gmres():
    """deflate = 0 minimises over the same spaces as FGMRES with the same
    (linear) M: the same counts, and x to rounding."""
    rd = _dr_call(tt, "deflate0")
    op = tt.poisson_operator(24)
    rf = tt.fgmres(op, to_torch(_b("poisson", 24)), restart=16, tol=1e-10,
                   M=tt.chebyshev_preconditioner(op, 0.2, 8.2))
    assert (rd.restarts, rd.iterations, rd.status) == (rf.restarts, rf.iterations, rf.status)
    assert rel_err(rd.x, rf.x) < 1e-12


def test_gmres_dr_subspace_is_eig_in_both_packages(monkeypatch):
    """gmres_tpu's gmres_dr ignores deflation="subspace": with its subspace
    iteration made to raise it still runs, bit for bit its eig route. The
    port's "subspace" and "auto" are its "eig" bit for bit."""
    def boom(*a, **k):
        raise AssertionError("the subspace iteration ran")

    monkeypatch.setattr(jdr, "smallest_invariant_subspace", boom)
    kw = dict(restart=16, deflate=4, tol=1e-10)
    opj = gt.convection_diffusion_operator(24, 2.0, 1.0)
    b = _b((2.0, 1.0), 24)
    sub = gt.gmres_dr(opj, jnp.asarray(b), deflation="subspace", **kw)
    eig = _jax_dr("pairs-k4")
    assert np.array_equal(np.asarray(sub.x), np.asarray(eig.x))
    opt = tt.convection_diffusion_operator(24, 2.0, 1.0)
    runs = [tt.gmres_dr(opt, to_torch(b), deflation=d, **kw)
            for d in ("eig", "subspace", "auto")]
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x) and r.restarts == runs[0].restarts
    assert runs[0].restarts == int(sub.restarts)
    with pytest.raises(ValueError, match="unknown deflation"):
        tt.gmres_dr(opt, to_torch(b), deflation="schur", **kw)


def test_gmres_dr_1x1():
    rj = gt.gmres_dr(jnp.asarray([[4.0]]), jnp.asarray([[8.0]]), restart=5, deflate=2,
                     tol=1e-12)
    rt = tt.gmres_dr(to_torch(np.array([[4.0]])), to_torch(np.array([[8.0]])),
                     restart=5, deflate=2, tol=1e-12)
    assert float(rt.x[0, 0]) == float(rj.x[0, 0]) == 2.0
    assert (rt.restarts, rt.iterations, rt.status) == (1, 1, 0)
