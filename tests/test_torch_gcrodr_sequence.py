"""GCRO-DR of the PyTorch port against gmres_tpu, continued: a recycling
sequence, the shared-eigensolver mechanism behind the count differences, a
float32 work dtype, and the argument checks. Tolerances as in
tests/test_torch_gcrodr.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu.solvers.gcrodr as jgc
import gmres_tpu_torch as tt
from gmres_tpu_torch.solvers import gcrodr as tgc
from tests.test_torch_deflated import _b, _total
from tests.test_torch_gcrodr import _gc_call, _jax_gc
from tests.torch_parity import rel_err, to_np, to_torch


def _np_eig_select(a, nvec):
    """One numpy eigensolver for both packages (the shared-eigenpair runs)."""
    a = np.asarray(a, dtype=np.float64)
    if not np.all(np.isfinite(a)):
        nan = np.full(a.shape, np.nan + 0j)
        return nan[0], nan[:, :nvec]
    vals, vecs = np.linalg.eig(a)
    order = np.argsort(np.abs(vals), kind="stable")
    vecs = vecs[:, order[:nvec]]
    return vals[order], vecs / np.linalg.norm(vecs, axis=0)


def _shared_eig(monkeypatch):
    def jax_eig(a, nvec, which="smallest"):
        m = a.shape[0]
        shapes = (jax.ShapeDtypeStruct((m,), jnp.complex128),
                  jax.ShapeDtypeStruct((m, nvec), jnp.complex128))
        vals, vecs = jax.pure_callback(lambda x: _np_eig_select(x, nvec), shapes, a)
        return vals, vecs, jnp.array(True)

    def port_eig(a, nvec, which="smallest"):
        vals, vecs = _np_eig_select(to_np(a), nvec)
        return torch.as_tensor(vals), torch.as_tensor(vecs), torch.tensor(True)

    monkeypatch.setattr(jgc, "eig_select", jax_eig)
    monkeypatch.setattr(tgc, "eig_select", port_eig)


def test_gcrodr_shared_eigenpairs_give_jax_counts(monkeypatch):
    """With both packages' harmonic Ritz pairs from one numpy eigensolver,
    the case whose counts differ (γ = (2, 1), no preconditioner: JAX's QR
    iteration and LAPACK split nearly equal harmonic Ritz values apart
    differently) gives JAX's counts and x."""
    _shared_eig(monkeypatch)
    rj = _gc_call(gt, "pairs")
    rt = _gc_call(tt, "pairs")
    assert (rt.restarts, rt.iterations, rt.status) == (
        int(rj.restarts), int(rj.iterations), int(rj.status))
    assert rel_err(rt.x, rj.x) <= 1e-9


def test_gcrodr_recycle_chain_warm_beats_fresh():
    """A sequence: b₁ = A·1, then b₂ = A·x₂ fresh and with the recycle block
    of the first solve. The warm solve takes fewer cycles than the fresh
    one in both packages, and the port's counts are JAX's within 2."""
    b2 = _b("poisson", 16, seed=72)
    first_j, first_t = _jax_gc("poisson-cbpr2"), _gc_call(tt, "poisson-cbpr2")
    fresh_j = _gc_call(gt, "poisson-cbpr2", b=b2)
    fresh_t = _gc_call(tt, "poisson-cbpr2", b=b2)
    warm_j = _gc_call(gt, "poisson-cbpr2", b=b2, recycle=first_j.recycle)
    warm_t = _gc_call(tt, "poisson-cbpr2", b=b2, recycle=first_t.recycle)
    assert int(warm_j.restarts) < int(fresh_j.restarts)
    assert warm_t.restarts < fresh_t.restarts
    for rt, rj in ((first_t, first_j), (fresh_t, fresh_j), (warm_t, warm_j)):
        assert rt.status == int(rj.status) == 0
        assert abs(rt.restarts - int(rj.restarts)) <= 2
    # The import costs k applications of op, one a row of the block.
    assert warm_t.host_syncs >= warm_t.restarts + 2


def test_gcrodr_auto_is_eig_and_validation():
    op = tt.poisson_operator(16)
    b = to_torch(_b("poisson", 16))
    r_auto = tt.gcrodr(op, b, k=4, restart=12, tol=1e-10, deflation="auto")
    r_eig = tt.gcrodr(op, b, k=4, restart=12, tol=1e-10, deflation="eig")
    assert torch.equal(r_auto.x, r_eig.x) and r_auto.restarts == r_eig.restarts
    with pytest.raises(ValueError, match="restart >= k"):
        tt.gcrodr(op, b, k=4, restart=5)
    with pytest.raises(ValueError, match="k >= 1"):
        tt.gcrodr(op, b, k=0, restart=5)
    with pytest.raises(ValueError, match="real dtypes"):
        tt.gcrodr(op, b.to(torch.complex128), k=4, restart=12)
    with pytest.raises(ValueError, match="recycle must be"):
        tt.gcrodr(op, b, k=4, restart=12, recycle=torch.zeros(3, 16, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown deflation"):
        tt.gcrodr(op, b, k=4, restart=12, deflation="qr")


def test_gcrodr_float32_work_dtype():
    """inner_dtype=float32 with a float64 b: every cycle boundary recomputes
    the true residual in float64 and decides on it; the recycle block comes
    back in float64. Counts within 2 of gmres_tpu's."""
    n = 24
    opj = gt.convection_diffusion_operator(n, 0.4, 0.2)
    mj = gt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    opt = tt.convection_diffusion_operator(n, 0.4, 0.2)
    mt = tt.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    b = _b((0.4, 0.2), n)
    kw = dict(k=4, restart=12, tol=1e-10, max_restarts=200)
    rj = gt.gcrodr(opj, jnp.asarray(b), M=mj, inner_dtype=jnp.float32, **kw)
    rt = tt.gcrodr(opt, to_torch(b), M=mt, inner_dtype=torch.float32, **kw)
    assert rt.status == int(rj.status) == 0
    assert abs(rt.restarts - int(rj.restarts)) <= 2
    assert abs(_total(rt, 8) - _total(rj, 8)) <= 2
    assert float(rt.residual) < 1e-10
    assert rt.x.dtype == rt.recycle.dtype == torch.float64
