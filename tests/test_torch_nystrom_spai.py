"""The port's Nyström and SPAI preconditioners against gmres_tpu on the same
numpy inputs, on the CPU, float64.

* ``nystrom_preconditioner`` with JAX's Gaussian sketch patched in through
  ``_sketch``: the eigenvalue estimates λ̂ and the preconditioner's
  application within 1e-12 relative (μ = 0 and μ > 0, 0 and 1 power
  iterations); CG with it takes JAX's count within 2.
* ``spai_matrix``: the ELL column indices equal to JAX's and the values
  within 1e-12 relative, from a dense matrix, from a CSR matrix (carried
  over with ``sparse_from_numpy``), in chunks, and for a complex matrix;
  ``spai_preconditioner``'s application within 1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.models.convection_diffusion import convection_diffusion_matrix
from gmres_tpu_torch.precond import nystrom as tnys
from tests.torch_parity import rel_err, seeded, to_np, to_torch

N = 12


def _decaying(pkg):
    """An SPD operator with a decaying spectrum: Q diag(1/i²) Qᵀ + 1e-3 I on
    the flattened N² grid (dense, small)."""
    q, _ = np.linalg.qr(seeded(7, (N * N, N * N)))
    d = 1.0 / np.arange(1, N * N + 1) ** 2 + 1e-3
    a = (q * d) @ q.T
    a = 0.5 * (a + a.T)
    aj = jnp.asarray(a) if pkg is gt else to_torch(a)
    return lambda v: (aj @ v.reshape(-1)).reshape(v.shape)


def _jax_sketch(rank):
    om = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (rank, N, N), jnp.float64))
    return lambda r, shape, dtype, device, key: to_torch(om).to(device, dtype)


@pytest.mark.parametrize("mu,power_iters", [(0.0, 1), (1e-2, 1), (0.0, 0)])
def test_nystrom_matches_jax_with_its_sketch(mu, power_iters, monkeypatch):
    rank = 10
    monkeypatch.setattr(tnys, "_sketch", _jax_sketch(rank))
    jp, jl = gt.nystrom_preconditioner(_decaying(gt), jnp.zeros((N, N)), rank=rank, mu=mu,
                                       power_iters=power_iters)
    tp, tl = tt.nystrom_preconditioner(_decaying(tt), torch.zeros((N, N), dtype=torch.float64),
                                       rank=rank, mu=mu, power_iters=power_iters)
    assert rel_err(tl, jl) < 1e-12
    assert np.all(np.diff(to_np(tl)) <= 0)
    r = seeded(8, (N, N))
    assert rel_err(tp(to_torch(r)), jp(jnp.asarray(r))) < 1e-12


def test_nystrom_under_cg_matches_jax(monkeypatch):
    rank = 16
    monkeypatch.setattr(tnys, "_sketch", _jax_sketch(rank))
    b = seeded(9, (N, N))
    jp, _ = gt.nystrom_preconditioner(_decaying(gt), jnp.zeros((N, N)), rank=rank)
    tp, _ = tt.nystrom_preconditioner(_decaying(tt), torch.zeros((N, N), dtype=torch.float64),
                                      rank=rank)
    ref = gt.cg(_decaying(gt), jnp.asarray(b), tol=1e-10, M=jp)
    res = tt.cg(_decaying(tt), to_torch(b), tol=1e-10, M=tp)
    plain = tt.cg(_decaying(tt), to_torch(b), tol=1e-10)
    assert res.status == int(ref.status) == 0
    assert abs(res.iterations - int(ref.iterations)) <= 2
    assert res.iterations < plain.iterations


def _spai_pair(a, **kw):
    return gt.spai_matrix(a, **kw), tt.spai_matrix(to_torch(a), **kw)


def _check_ell(jm, tm):
    assert tuple(tm.shape) == tuple(jm.shape)
    assert np.array_equal(to_np(tm.cols), np.asarray(jm.cols))
    assert rel_err(tm.data, jm.data) < 1e-12


@pytest.mark.parametrize("gamma", [(0.4, 0.2), (2.0, 1.0)])
def test_spai_matrix_matches_jax(gamma):
    a = np.asarray(convection_diffusion_matrix(8, *gamma))
    _check_ell(*_spai_pair(a))
    _check_ell(*_spai_pair(a, chunk=10))


def test_spai_from_csr_matches_jax():
    a = np.asarray(convection_diffusion_matrix(8, 0.4, 0.2))
    jcsr = gt.csr_from_dense(a)
    tcsr = tt.sparse_from_numpy("csr", {"data": np.asarray(jcsr.data),
                                        "indices": np.asarray(jcsr.indices),
                                        "indptr": np.asarray(jcsr.indptr)},
                                jcsr.shape, device="cpu")
    jm, tm = gt.spai_matrix(jcsr), tt.spai_matrix(tcsr)
    _check_ell(jm, tm)
    assert tm.data.device.type == "cpu"


def test_spai_complex_matches_jax():
    rng = np.random.default_rng(10)
    n = 20
    a = np.diag(4.0 + 1j * rng.standard_normal(n))
    for k in (1, 3):
        a += np.diag(rng.standard_normal(n - k) + 1j * rng.standard_normal(n - k), k)
        a += np.diag(rng.standard_normal(n - k), -k)
    _check_ell(*_spai_pair(a))


def test_spai_preconditioner_matches_jax():
    a = np.asarray(convection_diffusion_matrix(8, 0.4, 0.2))
    jp = gt.spai_preconditioner(a)
    tp = tt.spai_preconditioner(to_torch(a))
    v = seeded(11, (8, 8))
    assert rel_err(tp(to_torch(v)), jp(jnp.asarray(v))) < 1e-12


def test_spai_refuses_a_rectangular_matrix():
    with pytest.raises(ValueError):
        tt.spai_matrix(to_torch(np.ones((3, 4))))
