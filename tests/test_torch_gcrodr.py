"""GCRO-DR of the PyTorch port against gmres_tpu on the same numpy inputs,
on the CPU, float64 unless a case says otherwise.

The harmonic Ritz vectors come from different eigensolvers (LAPACK's
``geev`` on a float64 CPU copy in the port, JAX's in-jit QR iteration), so
the rule is: restarts and total inner iterations within 2 of JAX's, the
same status, a certified residual under tol; where the counts agree (the
multigrid cases, or both packages' eigenpairs taken from one numpy
eigensolver), x within 1e-9 of JAX's relative to max|x| and the residual
histories within 1e-6. Both routes of ``deflation`` run in both packages;
the port's subspace iteration starts from its own seam, with JAX's
PRNGKey(7) block patched in here. "auto" is "eig" in the port (JAX:
"subspace" on a TPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import hessenberg_eig as the
from tests.test_torch_deflated import _b, _op, _precond, _total
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _jax_start(n, k, dtype):
    return to_torch(jax.random.normal(jax.random.PRNGKey(7), (n, k), jnp.float64)).to(dtype)


# label: (model, n, preconditioner, keyword arguments, exact).
GC_CASES = {
    "mg": ((0.4, 0.2), 24, "mg", {"k": 4, "restart": 12}, True),
    "poisson-cbpr2": ("poisson", 16, "cbpr2", {"k": 4, "restart": 12}, False),
    "pairs": ((2.0, 1.0), 16, None, {"k": 4, "restart": 12}, False),
    "x0": ((0.4, 0.2), 24, "mg", {"k": 4, "restart": 12, "x0": True}, True),
    "zero-recycle": ((0.4, 0.2), 24, "mg", {"k": 4, "restart": 12, "zero_recycle": True},
                     True),
    "subspace": ("poisson", 24, "cbpr2", {"k": 4, "restart": 12, "deflation": "subspace"},
                 False),
}


def _gc_call(pkg, label, b=None, recycle=None, **extra):
    model, n, precond, kw, _ = GC_CASES[label]
    kw = {"tol": 1e-10, "max_restarts": 200, **kw, **extra}
    op = _op(pkg, model, n)
    m = _precond(pkg, op, precond, model, n)
    conv = jnp.asarray if pkg is gt else to_torch
    b = _b(model, n) if b is None else b
    if kw.pop("x0", False):
        kw["x0"] = conv(seeded(71, b.shape))
    if kw.pop("zero_recycle", False):
        kw["recycle"] = conv(np.zeros((kw["k"], n, n)))
    if kw.pop("inner", False):
        kw["inner_dtype"] = jnp.float32 if pkg is gt else torch.float32
    if recycle is not None:
        kw["recycle"] = conv(to_np(recycle))
    fn = gt.gcrodr if pkg is gt else tt.gcrodr
    return fn(op, conv(b), M=m, **kw)


@functools.lru_cache(maxsize=None)
def _jax_gc(label):
    return _gc_call(gt, label)


@pytest.mark.parametrize("label", sorted(GC_CASES))
def test_gcrodr_matches_jax(label, monkeypatch):
    if GC_CASES[label][3].get("deflation") == "subspace":
        monkeypatch.setattr(the, "_subspace_start", _jax_start)
    rj = _jax_gc(label)
    rt = _gc_call(tt, label)
    _, _, _, kw, exact = GC_CASES[label]
    m = kw["restart"] - kw["k"]
    assert rt.status == int(rj.status) == 0
    assert float(rt.residual) < 1e-10
    assert rt.recycle.shape == tuple(rj.recycle.shape) and rt.recycle.dtype == torch.float64
    assert abs(rt.restarts - int(rj.restarts)) <= 2
    assert abs(_total(rt, m) - _total(rj, m)) <= 2
    if exact:
        assert (rt.restarts, rt.iterations) == (int(rj.restarts), int(rj.iterations))
        assert rel_err(rt.x, rj.x) <= 1e-9
        k = rt.restarts
        np.testing.assert_allclose(to_np(rt.residual_history)[:k],
                                   to_np(rj.residual_history)[:k], rtol=0, atol=1e-6)
    # The recycle block is not compared: nearly equal harmonic Ritz values
    # split differently between the eigensolvers, so its last directions
    # differ (its span's last principal angle is far from 0 at "mg").
    assert torch.isfinite(rt.recycle).all()
