"""The anisotropic model, its multigrid cycle and the batched PCR solve in
the PyTorch port against gmres_tpu on the same numpy inputs, on the CPU,
float64.

PCR (``ops/tridiag.py``): the port's ``tridiag_solve_pcr`` equals JAX's
bit for bit at n = 13 (not a power of two) and n = 16, and both solve
against a dense solve to 1e-12 (diagonally dominant batches); the plan of
one coefficient row, broadcast over the lines as the anisotropic smoother
uses it, gives the full-shape solve's bits. The operator on the CPU is
JAX's pad-and-sum form bit for bit; ``anisotropic_coefs`` in
``stencil_5pt_general`` (K1's plain version, the card's route) within
1e-14 (another summation order); ``anisotropic_matrix`` equals JAX's. One
cycle application, line and point, within 1e-13 of JAX's relative to
max|z|. CG with each cycle at 32², ε = 0.01 and 1: iterations and status
equal, x within 1e-10 relative; the line cycle takes a small fraction of
the point cycle's iterations at ε = 0.01 (tests/test_anisotropic.py:
line against point).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu.ops.tridiag import tridiag_solve_pcr as jax_pcr
from gmres_tpu_torch.models.anisotropic import anisotropic_coefs
from gmres_tpu_torch.ops.stencil import stencil_5pt_general
from gmres_tpu_torch.ops.tridiag import pcr_apply, pcr_plan, tridiag_solve_pcr
from tests.torch_parity import rel_err, seeded, to_np, to_torch


def _system(n, seed):
    rng = np.random.default_rng(seed)
    dl, du, rhs = rng.standard_normal((3, 5, n))
    dd = 4.0 + rng.random((5, n))
    return dl, dd, du, rhs


@pytest.mark.parametrize("n", [1, 13, 16])
def test_pcr_matches_jax_and_a_dense_solve(n):
    dl, dd, du, rhs = _system(n, 110 + n)
    xt = tridiag_solve_pcr(*(to_torch(a) for a in (dl, dd, du, rhs)))
    xj = jax_pcr(*(jnp.asarray(a) for a in (dl, dd, du, rhs)))
    np.testing.assert_array_equal(to_np(xt), np.asarray(xj))
    for k in range(5):
        t = np.diag(dd[k]) + np.diag(dl[k, 1:], -1) + np.diag(du[k, :-1], 1)
        np.testing.assert_allclose(to_np(xt[k]), np.linalg.solve(t, rhs[k]), atol=1e-12)


def test_pcr_plan_on_one_row_equals_the_full_shape_solve():
    n, eps = 24, 0.01
    rhs = to_torch(seeded(114, (7, n)))
    full = functools.partial(torch.full, (7, n), dtype=torch.float64)
    row = functools.partial(torch.full, (n,), dtype=torch.float64)
    diag = 2.0 * eps + 2.0
    x_full = tridiag_solve_pcr(full(-1.0), full(diag), full(-1.0), rhs)
    x_row = pcr_apply(pcr_plan(row(-1.0), row(diag), row(-1.0)), rhs)
    assert torch.equal(x_full, x_row)


@pytest.mark.parametrize("eps", [1.0, 0.05, 0.01])
def test_operator_matches_jax(eps):
    n = 12
    x = seeded(115, (n, n))
    yt = tt.anisotropic_apply(to_torch(x), eps)
    np.testing.assert_array_equal(to_np(yt), np.asarray(gt.anisotropic_apply(
        jnp.asarray(x), eps)))
    torch.testing.assert_close(stencil_5pt_general(to_torch(x), *anisotropic_coefs(eps)),
                               yt, rtol=0, atol=1e-14)
    a = to_np(tt.anisotropic_matrix(n, eps, device="cpu"))
    np.testing.assert_array_equal(a, np.asarray(gt.anisotropic_matrix(n, eps)))
    np.testing.assert_allclose(a @ x.reshape(-1), to_np(yt).reshape(-1), atol=1e-12)


@pytest.mark.parametrize("smoother", ["line", "point"])
def test_cycle_matches_jax(smoother):
    n, eps = 32, 0.01
    r = seeded(116, (n, n))
    mj = gt.anisotropic_multigrid_preconditioner(n, eps, smoother=smoother)
    mt = tt.anisotropic_multigrid_preconditioner(n, eps, smoother=smoother)
    assert rel_err(mt(to_torch(r)), mj(jnp.asarray(r))) <= 1e-13


@functools.lru_cache(maxsize=None)
def _cg(pkg_name, eps, smoother, cap=400):
    pkg = gt if pkg_name == "jax" else tt
    n = 32
    conv = jnp.asarray if pkg is gt else to_torch
    op = pkg.anisotropic_operator(n, eps)
    b = np.asarray(gt.anisotropic_operator(n, eps)(jnp.ones((n, n))))
    m = pkg.anisotropic_multigrid_preconditioner(n, eps, smoother=smoother)
    return pkg.cg(op, conv(b), tol=1e-8, M=m, max_iterations=cap)


@pytest.mark.parametrize("eps,smoother", [(0.01, "line"), (1.0, "line"), (0.01, "point")])
def test_cg_with_the_cycle_matches_jax(eps, smoother):
    rj, rt = _cg("jax", eps, smoother), _cg("torch", eps, smoother)
    assert (rt.iterations, rt.status) == (int(rj.iterations), int(rj.status)) and rt.converged
    assert rel_err(rt.x, rj.x) <= 1e-10
    np.testing.assert_allclose(to_np(rt.x), 1.0, atol=1e-6)


def test_line_smoothing_beats_point_smoothing_at_small_eps():
    line, point = _cg("torch", 0.01, "line"), _cg("torch", 0.01, "point")
    assert line.converged and 3 * line.iterations < point.iterations


def test_unknown_smoother_raises():
    with pytest.raises(ValueError, match="unknown smoother"):
        tt.anisotropic_multigrid_preconditioner(32, 0.1, smoother="nope")
