"""Block GMRES and IDR(s) of the PyTorch port against gmres_tpu on the same
numpy inputs, on the CPU, float64.

Block GMRES: restarts and status equal; x within 1e-9 of JAX's relative to
max|x|; the per-RHS residuals within 1e-6 relative or 1e-13 absolute
(relative residuals near 1e-12 carry the orthonormalisation's rounding). The s×s ``eigh`` of SVQB may flip an
eigenvector's sign between LAPACK builds, which flips the basis block and
its coefficients together: x and the residuals are compared, never the
basis.

IDR(s): with JAX's shadow block patched into ``_shadow_block``, iterations
and status equal, x within 1e-9 of JAX's relative to max|x| and the
history within 1e-6 relative or 1e-12 absolute (1e-3 of tol); at γ = (2, 1)
without a preconditioner rounding grows ~10× an iteration, so there the
iterations are held within 1 and the first 10 history entries to 1e-6; with the port's own block (a torch
Generator, since JAX's PRNGKey(7) cannot be reproduced) the iterations
within 2 and the certified residual under tol.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.solvers.block_gmres import _orthonormalize_block as jax_orthonormalize
from gmres_tpu_torch.solvers import block_gmres as tbg
from gmres_tpu_torch.solvers import idrs as tidrs
from tests.torch_parity import rel_err, seeded, to_np, to_torch

# label: (s, grid, keyword arguments) for block GMRES on Poisson with the
# multigrid V-cycle on the right unless "plain" or "dense".
BLOCK_CASES = {
    "s1-mg": (1, 16, {"restart": 10, "tol": 1e-10}),
    "s3-mg": (3, 16, {"restart": 10, "tol": 1e-10}),
    "s3-plain": (3, 12, {"restart": 6, "tol": 1e-9, "plain": True}),
    "s2-x0": (2, 16, {"restart": 8, "tol": 1e-10, "x0": True}),
    "s3-zero-column": (3, 16, {"restart": 10, "tol": 1e-10, "zero_row": 1}),
    "s2-all-zero": (2, 8, {"restart": 4, "tol": 1e-10, "all_zero": True}),
    "s2-dense": (2, 6, {"restart": 8, "tol": 1e-10, "dense": True}),
    "s2-max-restarts": (2, 16, {"restart": 2, "tol": 1e-12, "max_restarts": 2, "plain": True}),
}


def _block_problem(pkg, label):
    s, n, kw = BLOCK_CASES[label]
    kw = dict(kw)
    if kw.pop("dense", False):
        a = np.asarray(gt.poisson_matrix(n))
        op = jnp.asarray(a) if pkg is gt else to_torch(a)
        rows = [a @ v for v in seeded(61, (s, n * n))]
        return op, None, np.stack(rows), kw
    op = pkg.poisson_operator(n)
    m = None if kw.pop("plain", False) else pkg.poisson_multigrid_preconditioner(n)
    xs = seeded(60, (s, n, n))
    b = np.array(jax.vmap(gt.poisson_operator(n))(jnp.asarray(xs)))
    if "zero_row" in kw:
        b[kw.pop("zero_row")] = 0.0
    if kw.pop("all_zero", False):
        b = np.zeros_like(b)
    return op, m, b, kw


def _block_call(pkg, label):
    op, m, b, kw = _block_problem(pkg, label)
    conv = jnp.asarray if pkg is gt else to_torch
    if kw.pop("x0", False):
        kw["x0"] = conv(seeded(62, b.shape))
    fn = gt.block_gmres if pkg is gt else tt.block_gmres
    return fn(op, conv(b), M=m, **kw)


@functools.lru_cache(maxsize=None)
def _jax_block(label):
    return _block_call(gt, label)


@pytest.mark.parametrize("label", sorted(BLOCK_CASES))
def test_block_gmres_matches_jax(label):
    rj = _jax_block(label)
    rt = _block_call(tt, label)
    assert (rt.restarts, rt.status) == (int(rj.restarts), int(rj.status))
    assert rt.x.shape == tuple(rj.x.shape) and rt.x.dtype == torch.float64
    assert rel_err(rt.x, rj.x) <= 1e-9
    np.testing.assert_allclose(to_np(rt.residuals), to_np(rj.residuals), rtol=1e-6,
                               atol=1e-13)
    assert float(rt.residual) == float(torch.max(rt.residuals))
    assert rt.host_syncs == 1 + rt.restarts
    if rt.status == 0:
        assert float(rt.residual) < BLOCK_CASES[label][2]["tol"]


def test_block_gmres_launches_per_row(monkeypatch):
    """A block application of A and of M maps the single-vector callable
    over the rows with ``torch.func.vmap``, as JAX's vmap does: one call of
    each per block application (on the card, one batched launch of each
    kernel the single-vector operator launches)."""
    s, n = 3, 16
    calls = {"A": 0, "M": 0}
    op, m = tt.poisson_operator(n), tt.poisson_multigrid_preconditioner(n)

    def a_counted(v):
        assert v.shape == (n, n)
        calls["A"] += 1
        return op(v)

    def m_counted(v):
        calls["M"] += 1
        return m(v)

    b = to_torch(seeded(63, (s, n, n)))
    res = tt.block_gmres(a_counted, b, restart=5, tol=1e-30, max_restarts=1, M=m_counted)
    assert res.restarts == 1
    # The initial and final residuals, the 5 steps and the update's M.
    assert calls["A"] == 1 + 5 + 1
    assert calls["M"] == 5 + 1


def test_svqb_sign_flip_leaves_x_unchanged(monkeypatch):
    """Flipping eigh's eigenvector signs (another LAPACK build may) flips q
    and the reconstruction factor together, and x does not move."""
    label = "s3-mg"
    base = _block_call(tt, label)
    eigh = torch.linalg.eigh

    def flipped(a):
        lam, u = eigh(a)
        sign = torch.ones(u.shape[-1], dtype=u.dtype)
        sign[::2] = -1.0
        return lam, u * sign

    monkeypatch.setattr(tbg.torch.linalg, "eigh", flipped)
    res = _block_call(tt, label)
    assert res.restarts == base.restarts
    assert rel_err(res.x, base.x) < 1e-12


def test_orthonormalize_block_reconstructs():
    w = seeded(64, (4, 10, 10))
    q, h = tbg._orthonormalize_block(to_torch(w), float(np.finfo(np.float64).eps))
    qf = to_np(q).reshape(4, -1)
    np.testing.assert_allclose(qf @ qf.T, np.eye(4), atol=1e-14)
    np.testing.assert_allclose(np.einsum("ab,ai->bi", to_np(h), qf), w.reshape(4, -1),
                               atol=1e-13)
    qj, hj = jax_orthonormalize(jnp.asarray(w), float(np.finfo(np.float64).eps))
    # Spans agree; the bases may differ by eigenvector signs.
    sv = np.linalg.svd(np.asarray(qj).reshape(4, -1) @ qf.T, compute_uv=False)
    np.testing.assert_allclose(sv, 1.0, atol=1e-12)


# IDR(s): (s, problem, keyword arguments). Convection-diffusion at
# γ = (0.4, 0.2) with its multigrid cycle unless "plain".
IDRS_CASES = {
    "s1-mg": (1, 32, {}),
    "s4-mg": (4, 32, {}),
    "s8-mg": (8, 32, {}),
    "s4-plain": (4, 16, {"plain": True}),
    "s2-strong": (2, 24, {"plain": True, "gamma": (2.0, 1.0)}),
    "s4-x0": (4, 16, {"x0": True}),
    "s4-zero-b": (4, 8, {"zero_b": True}),
    "s4-max-iterations": (4, 16, {"plain": True, "max_iterations": 3}),
}


def _jax_shadow(s, shape):
    raw = jax.random.normal(jax.random.PRNGKey(7), (s,) + tuple(shape), jnp.float64)
    p, _ = jax_orthonormalize(raw, float(jnp.finfo(jnp.float64).eps))
    return to_np(p)


def _idrs_call(pkg, label, shadow="own"):
    s, n, kw = IDRS_CASES[label]
    kw = dict(kw)
    gamma = kw.pop("gamma", (0.4, 0.2))
    op = pkg.convection_diffusion_operator(n, *gamma)
    m = None if kw.pop("plain", False) else pkg.convection_diffusion_multigrid_preconditioner(
        n, *gamma)
    b = np.asarray(gt.convection_diffusion_operator(n, *gamma)(jnp.ones((n, n))))
    if kw.pop("zero_b", False):
        b = np.zeros_like(b)
    conv = jnp.asarray if pkg is gt else to_torch
    if kw.pop("x0", False):
        kw["x0"] = conv(seeded(65, (n, n)))
    if pkg is gt:
        return gt.idrs(op, conv(b), s=s, tol=1e-9, M=m, **kw), b
    original = tidrs._shadow_block
    if shadow == "jax":
        p = _jax_shadow(s, (n, n))
        tidrs._shadow_block = lambda s_, shape, dtype, device: to_torch(p, device).to(dtype)
    try:
        return tt.idrs(op, conv(b), s=s, tol=1e-9, M=m, **kw), b
    finally:
        tidrs._shadow_block = original


@functools.lru_cache(maxsize=None)
def _jax_idrs(label):
    return _idrs_call(gt, label)


@pytest.mark.parametrize("label", sorted(IDRS_CASES))
def test_idrs_with_jax_shadow_matches_jax(label):
    rj, b = _jax_idrs(label)
    rt, _ = _idrs_call(tt, label, shadow="jax")
    gap = 1 if label == "s2-strong" else 0
    assert abs(rt.iterations - int(rj.iterations)) <= gap
    assert rt.status == int(rj.status)
    hist_t, hist_j = to_np(rt.residual_history), to_np(rj.residual_history)
    assert hist_t.shape == hist_j.shape
    # At γ = (2, 1) unpreconditioned, rounding grows ~10× an iteration: the
    # first 10 entries agree, the last ones by O(1).
    k = 10 if gap else rt.iterations
    np.testing.assert_allclose(hist_t[:k], hist_j[:k], rtol=1e-6, atol=1e-12)
    if gap == 0:
        assert rel_err(rt.x, rj.x) <= 1e-9
        np.testing.assert_allclose(hist_t, hist_j, rtol=1e-6, atol=1e-12)
    # One read an outer iteration, the initial residual, the certification.
    assert rt.host_syncs == rt.iterations + 2
    if rt.status == 0:
        assert float(rt.residual) < 1e-9


@pytest.mark.parametrize("label", ["s1-mg", "s4-mg", "s8-mg", "s4-plain", "s2-strong"])
def test_idrs_own_shadow_within_two(label):
    rj, b = _jax_idrs(label)
    rt, _ = _idrs_call(tt, label)
    assert abs(rt.iterations - int(rj.iterations)) <= 2
    assert rt.status == int(rj.status) == 0
    assert float(rt.residual) < 1e-9


def test_idrs_shadow_block_is_seeded_and_orthonormal():
    p1 = tidrs._shadow_block(4, (6, 6), torch.float64, "cpu")
    p2 = tidrs._shadow_block(4, (6, 6), torch.float64, "cpu")
    assert torch.equal(p1, p2)
    pf = to_np(p1).reshape(4, -1)
    np.testing.assert_allclose(pf @ pf.T, np.eye(4), atol=1e-14)


def test_idrs_bad_s_raises_in_both():
    op = tt.poisson_operator(4)
    with pytest.raises(ValueError, match="s must be >= 1"):
        tt.idrs(op, torch.ones(4, 4, dtype=torch.float64), s=0)
    with pytest.raises(ValueError, match="s must be >= 1"):
        gt.idrs(gt.poisson_operator(4), jnp.ones((4, 4)), s=0)
