"""The port's eigensolvers against gmres_tpu on the same numpy inputs, on the
CPU, float64.

* ``arnoldi_expand`` on a complex128 basis (a real matrix applied to each
  part): the port raised here before its β was taken from the real part;
  basis and Hessenberg within 1e-13 of JAX's.
* The Schur route: ``schur_sort`` and ``schur_eigvec`` of both packages on
  the same T, Q and key within 1e-13; the port's ``sorted_schur`` (LAPACK's
  Schur form reordered by the swap network) satisfies S = Z T Zᴴ to 1e-12
  with diag(T) in JAX's order for every ``which`` (a complex S: no ties).
* ``arnoldi_eigs``, ``arnoldi_eigs_real``, ``subspace_eigs``: eigenvalues
  within 1e-10 relative (as multisets free of the conjugate pair's sign),
  restart cycles within 1. On the clustered convection-dominated spectrum
  at a tight tol, the Schur forms' tie order (conjugate pairs share |λ|)
  differs between LAPACK and JAX's shifted QR, so the kept subspaces
  differ and the cycle counts drift apart (74 against 80): that case is
  held within 10% of JAX's count; its eigenvalues are ill-conditioned (the
  operator is far from normal: a 1e-10 residual leaves ~3e-9 of eigenvalue
  error in either package), so they are held within 1e-8 relative of JAX's
  and of the closed-form spectrum.
* ``lobpcg`` with JAX's guard rows and fallback directions patched in
  through ``_guard_rows`` and ``_fallback_rows``: eigenvalues within 1e-12,
  iterations and status equal; with M, B, guard and degenerate X0 rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.ops import hessenberg_eig as jhe
from gmres_tpu.solvers.lanczos import arnoldi_expand as jax_expand
from gmres_tpu_torch.ops import hessenberg_eig as the
from gmres_tpu_torch.solvers import lobpcg as tlobpcg
from gmres_tpu_torch.solvers import subspace_eigs as tsub
from gmres_tpu_torch.solvers.lanczos import arnoldi_expand as port_expand
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _keyed(v):
    v = np.asarray(v)
    return np.sort_complex(v.real + 1j * np.abs(v.imag))


def test_arnoldi_expand_on_a_complex_basis():
    n, m = 8, 5
    a = seeded(1, (n, n))
    v0 = seeded(2, (n,)) + 1j * seeded(3, (n,))
    v0 = v0 / np.linalg.norm(v0)
    basis = np.zeros((m + 1, n), np.complex128)
    basis[0] = v0
    hmat = np.zeros((m + 1, m), np.complex128)
    aj = jnp.asarray(a)
    jb, jh = jax_expand(lambda v: aj @ v.real + 1j * (aj @ v.imag), jnp.asarray(basis),
                        jnp.asarray(hmat), 0)
    at = to_torch(a)
    pb, ph = port_expand(lambda v: torch.complex(at @ v.real, at @ v.imag),
                         to_torch(basis), to_torch(hmat), 0)
    assert pb.dtype == torch.complex128 and ph.dtype == torch.complex128
    assert np.max(np.abs(to_np(pb) - np.asarray(jb))) < 1e-13
    assert np.max(np.abs(to_np(ph) - np.asarray(jh))) < 1e-13


def _triangular(seed, m):
    t = np.triu(seeded(seed, (m, m)) + 1j * seeded(seed + 1, (m, m)))
    q, _ = np.linalg.qr(seeded(seed + 2, (m, m)) + 1j * seeded(seed + 3, (m, m)))
    return t, q


def _jax_key(d, which):
    return {"LM": -np.abs(d), "SM": np.abs(d), "LR": -d.real, "SR": d.real}[which]


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR"])
def test_schur_sort_matches_jax(which):
    t, q = _triangular(10, 8)
    key = _jax_key(np.diagonal(t), which)
    jt, jq = jhe.schur_sort(jnp.asarray(t), jnp.asarray(q), jnp.asarray(key))
    pt, pq = the.schur_sort(to_torch(t), to_torch(q), to_torch(key))
    assert np.max(np.abs(to_np(pt) - np.asarray(jt))) < 1e-13
    assert np.max(np.abs(to_np(pq) - np.asarray(jq))) < 1e-13
    assert np.all(np.diff(_jax_key(np.diagonal(to_np(pt)), which)) >= 0)


def test_schur_eigvec_matches_jax():
    t, _ = _triangular(20, 7)
    t[3, 3] = t[1, 1]  # a repeated eigenvalue: the perturbed pivot
    for i in range(7):
        jy = jhe.schur_eigvec(jnp.asarray(t), jnp.int32(i))
        py = the.schur_eigvec(to_torch(t), i)
        assert np.max(np.abs(to_np(py) - np.asarray(jy))) < 1e-13


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR"])
def test_sorted_schur_is_an_ordered_schur_form(which):
    s = seeded(30, (12, 12)) + 1j * seeded(31, (12, 12))
    key = functools.partial(_jax_key, which=which)
    t, z, ok = the.sorted_schur(to_torch(s), key)
    t, z = to_np(t), to_np(z)
    assert ok
    assert np.max(np.abs(z @ t @ z.conj().T - s)) < 1e-12 * np.max(np.abs(s))
    assert np.max(np.abs(np.tril(t, -1))) == 0.0
    h, p = jhe.hessenberg_reduce(jnp.asarray(s))
    jt, jq, jok = jhe.hessenberg_schur(h)
    jt, _ = jhe.schur_sort(jt, jq, jnp.asarray(key(np.diagonal(np.asarray(jt)))))
    assert bool(jok)
    assert np.max(np.abs(np.diagonal(t) - np.diagonal(np.asarray(jt)))) < 1e-12


def test_sorted_schur_refuses_a_non_finite_block():
    s = seeded(32, (6, 6)).astype(np.complex128)
    s[2, 3] = np.nan
    _, _, ok = the.sorted_schur(to_torch(s), np.abs)
    assert not ok


# label: (n, gamma, kwargs, cycle band, eigenvalue tolerance)
ARNOLDI_CASES = {
    "moderate": (16, (0.4, 0.2), {"nev": 4, "steps": 20, "tol": 1e-10}, 1, 1e-10),
    "poisson": (12, (0.0, 0.0), {"nev": 4, "steps": 20, "tol": 1e-10}, 1, 1e-10),
    # Clustered, convection-dominated: the Schur forms' tie order differs,
    # and the eigenvalues are ill-conditioned.
    "clustered": (24, (2.0, 0.5), {"nev": 4, "steps": 20, "tol": 1e-10}, 8, 1e-8),
}


@functools.lru_cache(maxsize=None)
def _jax_arnoldi(label):
    n, g, kw, _, _ = ARNOLDI_CASES[label]
    return gt.arnoldi_eigs(gt.convection_diffusion_operator(n, *g),
                           jnp.asarray(seeded(1, (n, n))), **kw)


@pytest.mark.parametrize("label", sorted(ARNOLDI_CASES))
def test_arnoldi_eigs_matches_jax(label):
    n, g, kw, band, eig_tol = ARNOLDI_CASES[label]
    ref = _jax_arnoldi(label)
    res = tt.arnoldi_eigs(tt.convection_diffusion_operator(n, *g), to_torch(seeded(1, (n, n))),
                          **kw)
    assert res.status == int(ref.status) == 0
    assert abs(res.iterations - int(ref.iterations)) <= band
    lam, jlam = _keyed(to_np(res.eigenvalues)), _keyed(ref.eigenvalues)
    assert np.max(np.abs(lam - jlam)) < eig_tol * np.max(np.abs(jlam))
    if label == "clustered":  # (one probe sees a double eigenvalue once elsewhere)
        exact = tt.models.convection_diffusion.convection_diffusion_eigenvalues(n, *g)
        exact = _keyed(exact[np.argsort(-np.abs(exact))][:kw["nev"]])
        assert np.max(np.abs(lam - exact)) < eig_tol * np.max(np.abs(exact))
    assert np.all(to_np(res.residuals) < kw["tol"])
    # One read of the Rayleigh block a cycle, one of the residuals.
    assert res.host_syncs == res.iterations + 1
    x = to_np(res.x)
    assert np.allclose(np.linalg.norm(x.reshape(kw["nev"], -1), axis=1), 1.0)


def test_arnoldi_eigs_validates_its_arguments():
    op = tt.poisson_operator(8)
    probe = torch.ones((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        tt.arnoldi_eigs(op, probe, which="XX")
    with pytest.raises(ValueError):
        tt.arnoldi_eigs(op, probe, nev=19, steps=20)
    with pytest.raises(ValueError):
        tt.arnoldi_eigs_real(op, probe.to(torch.complex128))


def test_arnoldi_eigs_real_matches_jax():
    n, kw = 16, {"nev": 4, "steps": 20, "tol": 1e-9}
    p = seeded(2, (n, n))
    ref = gt.arnoldi_eigs_real(gt.convection_diffusion_operator(n, 2.0, 0.5),
                               jnp.asarray(p), **kw)
    res = tt.arnoldi_eigs_real(tt.convection_diffusion_operator(n, 2.0, 0.5), to_torch(p),
                               **kw)
    assert res.status == int(ref.status) == 0
    assert abs(res.iterations - int(ref.iterations)) <= 1
    lam = to_np(res.eigenvalues)
    assert np.max(np.abs(lam - np.asarray(ref.eigenvalues))) < 1e-10 * np.max(np.abs(lam))
    # The certified residuals agree to rounding (they sit at 1e-13 and 3.5e-10).
    assert np.max(np.abs(to_np(res.residuals) - np.asarray(ref.residuals))) < 1e-11
    assert np.all(to_np(res.residuals) < kw["tol"])


def test_subspace_eigs_matches_jax_with_its_start_block(monkeypatch):
    n = 16
    p = seeded(3, (n, n))
    q0 = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (n * n, 8), jnp.float64))
    monkeypatch.setattr(tsub, "_start_block",
                        lambda nn, pp, dtype, device: to_torch(q0).to(device, dtype))
    ref = gt.subspace_eigs(gt.convection_diffusion_operator(n, 0.4, 0.2), jnp.asarray(p),
                           nev=4, guard=4, iters=100, tol=1e-2)
    res = tt.subspace_eigs(tt.convection_diffusion_operator(n, 0.4, 0.2), to_torch(p),
                           nev=4, guard=4, iters=100, tol=1e-2)
    assert res.iterations == int(ref.iterations) == 100
    assert res.status == int(ref.status)
    lam = to_np(res.eigenvalues)
    assert np.max(np.abs(lam - np.asarray(ref.eigenvalues))) < 1e-10 * np.max(np.abs(lam))
    assert rel_err(res.residuals, ref.residuals) < 1e-8


def _jax_guard(guard, shape, dtype, device):
    key = jax.random.fold_in(jax.random.PRNGKey(1), guard)
    return to_torch(jax.random.normal(key, (guard,) + tuple(shape), jnp.float64)).to(
        device, dtype)


def _jax_fallback(i, salt, shape, dtype, device):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(i)), salt)
    return to_torch(jax.random.normal(key, tuple(shape), jnp.float64)).to(device, dtype)


def _mass(pkg):
    w = 1.0 + 0.5 * seeded(40, (12, 12)) ** 2
    wj = jnp.asarray(w) if pkg is gt else to_torch(w)
    return lambda v: wj * v


# label: (n, k, kwargs); "mg" the Poisson cycle as M, "B" a diagonal mass
# operator, "degenerate" a duplicated and a zero row in X0.
LOBPCG_CASES = {
    "mg": (16, 3, {"tol": 1e-9, "mg": True}),
    "mg-guard": (16, 3, {"tol": 1e-9, "mg": True, "guard": 2}),
    "plain-rtol": (12, 2, {"tol": 0.0, "rtol": 1e-8, "max_iterations": 60}),
    # B·q is kept by recombination, so the pencil's residuals level off near
    # 1e-9, where rounding decides the last step: this case stops at 1e-7.
    "pencil": (12, 2, {"tol": 1e-7, "B": True, "mg": True}),
    "degenerate": (16, 3, {"tol": 1e-9, "mg": True, "degenerate": True}),
}


def _lobpcg(pkg, label):
    n, k, kw = LOBPCG_CASES[label]
    kw = dict(kw)
    x0 = seeded(41, (k, n, n))
    if kw.pop("degenerate", False):
        x0[1] = x0[0]
        x0[2] = 0.0
    if kw.pop("mg", False):
        kw["M"] = pkg.poisson_multigrid_preconditioner(n)
    if kw.pop("B", False):
        kw["B"] = _mass(pkg)
    conv = jnp.asarray if pkg is gt else to_torch
    return pkg.lobpcg(pkg.poisson_operator(n), conv(x0), **kw)


@pytest.mark.parametrize("label", sorted(LOBPCG_CASES))
def test_lobpcg_matches_jax_with_its_draws(label, monkeypatch):
    monkeypatch.setattr(tlobpcg, "_guard_rows", _jax_guard)
    monkeypatch.setattr(tlobpcg, "_fallback_rows", _jax_fallback)
    ref = _lobpcg(gt, label)
    res = _lobpcg(tt, label)
    assert res.iterations == int(ref.iterations)
    assert res.status == int(ref.status)
    assert np.max(np.abs(to_np(res.eigenvalues) - np.asarray(ref.eigenvalues))) < 1e-12
    assert np.all(np.diff(to_np(res.eigenvalues)) >= 0)
    assert res.x.shape == ref.x.shape
    # Three reads per Rayleigh–Ritz (two SVQB Grams and the projected
    # matrix) and one decision, for the setup and each iteration.
    assert res.host_syncs == 4 * (res.iterations + 1)


def test_lobpcg_complex_hermitian():
    """A complex Hermitian operator: real, ascending eigenvalues equal to a
    dense eigh's."""
    n, k = 6, 2
    h = seeded(50, (n, n)) + 1j * seeded(51, (n, n))
    h = h @ h.conj().T + n * np.eye(n)
    ht = to_torch(h)
    res = tt.lobpcg(lambda v: ht @ v, to_torch(seeded(52, (k, n)) + 0j), tol=1e-10)
    assert res.status == 0
    assert np.max(np.abs(to_np(res.eigenvalues) - np.linalg.eigvalsh(h)[:k])) < 1e-9
