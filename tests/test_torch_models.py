"""The Hilbert model, the 7-point stencil and ``record_from_result`` of the
PyTorch port against gmres_tpu's, on the CPU.

Tolerances: the Hilbert matrix bitwise in both roundings (one correctly
rounded division per entry), the 7-point stencil bitwise at 8³ (the same
neighbour sums in the same order), ``record_from_result`` the same
``to_json()`` on the same result arrays. The Hilbert orthogonality A/B
(BASELINE config 2, the reference's test_hilbert.f90) at n = 12, m = 90,
tol 1e-15: both variants take JAX's iteration count, and Householder's
max |I − VᵀV| lies at least 1e6 below MGSR's in both packages; x within
1e-3 relative (cond(H) ≈ 1.7e16 at n = 12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
from gmres_tpu.ops.stencil import stencil_7pt_apply as jax_7pt
from gmres_tpu.ops.stencil import stencil_7pt_general as jax_7pt_general
from gmres_tpu.types import GmresResult as JaxGmresResult
from gmres_tpu.types import SolveResult as JaxSolveResult
from gmres_tpu.utils.reporting import record_from_result as jax_record
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops.stencil import stencil_7pt_apply, stencil_7pt_general
from gmres_tpu_torch.utils.reporting import record_from_result
from tests.torch_parity import seeded, to_np, to_torch


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("n", [1, 5, 12, 40])
def test_hilbert_matrix_bitwise(n, rounding):
    j = np.asarray(gt.hilbert_matrix(n, reference_rounding=rounding))
    t = tt.hilbert_matrix(n, reference_rounding=rounding, device="cpu")
    assert t.dtype == torch.float64 and t.shape == (n, n)
    np.testing.assert_array_equal(t.numpy(), j)
    if rounding and n > 2:
        # The float32 rounding is visible: 1/3 is not the float64 1/3.
        assert t[0, 2].item() != 1.0 / 3.0


def test_hilbert_matrix_float32():
    j = np.asarray(gt.hilbert_matrix(12, dtype=jnp.float32))
    t = tt.hilbert_matrix(12, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 7, 6)])
def test_stencil_7pt_bitwise(shape):
    x = seeded(91, shape)
    np.testing.assert_array_equal(stencil_7pt_apply(to_torch(x)).numpy(),
                                  np.asarray(jax_7pt(jnp.asarray(x))))
    np.testing.assert_array_equal(
        stencil_7pt_general(to_torch(x), 6.3, -0.7).numpy(),
        np.asarray(jax_7pt_general(jnp.asarray(x), 6.3, -0.7)))


def test_stencil_7pt_float32_bitwise():
    x = seeded(92, (8, 8, 8), np.float32)
    np.testing.assert_array_equal(stencil_7pt_apply(to_torch(x)).numpy(),
                                  np.asarray(jax_7pt(jnp.asarray(x))))


def test_record_from_result_same_json():
    """The same result arrays through both packages' record_from_result."""
    x = 1.0 + 1e-9 * seeded(93, (6, 6))
    hist = np.abs(seeded(94, (8,)))
    v_err = np.abs(seeded(95, (9,))) * 1e-15
    kw = dict(wall_s=0.25, tol=1e-8, nnz=5 * 36 - 24, extra={"matvecs": 10})
    jg = JaxGmresResult(x=jnp.asarray(x), iterations=jnp.int32(7), restarts=jnp.int32(3),
                        residual=jnp.asarray(3.5e-9), status=jnp.int32(0),
                        residual_history=jnp.asarray(hist), v_err=jnp.asarray(v_err))
    tg = tt.GmresResult(x=to_torch(x), iterations=7, restarts=3,
                        residual=torch.tensor(3.5e-9, dtype=torch.float64), status=0,
                        residual_history=to_torch(hist), v_err=to_torch(v_err))
    ones = np.ones((6, 6))
    assert (record_from_result("gmres", tg, x_true=to_torch(ones), **kw).to_json()
            == jax_record("gmres", jg, x_true=jnp.asarray(ones), **kw).to_json())
    # numpy x_true, no v_err or restarts field (a SolveResult), no x_true.
    js = JaxSolveResult(x=jnp.asarray(x), iterations=jnp.int32(12),
                        residual=jnp.asarray(4e-10), status=jnp.int32(0),
                        residual_history=jnp.asarray(hist))
    ts = tt.SolveResult(x=to_torch(x), iterations=12,
                        residual=torch.tensor(4e-10, dtype=torch.float64), status=0,
                        residual_history=to_torch(hist))
    assert (record_from_result("cg", ts, x_true=ones, tol=1e-9).to_json()
            == jax_record("cg", js, x_true=ones, tol=1e-9).to_json())
    assert (record_from_result("cg", ts).to_json() == jax_record("cg", js).to_json())


def test_hilbert_orthogonality_ab():
    """BASELINE config 2: one GMRES cycle on the n = 12 Hilbert system, b =
    H·1. Householder keeps the basis orthogonal to ~1e-30, MGSR to ~1e-16."""
    n, m, tol = 12, 90, 1e-15
    a_j = gt.hilbert_matrix(n)
    a_t = tt.hilbert_matrix(n, device="cpu")
    b_j = a_j @ jnp.ones(n)
    b_t = a_t @ torch.ones(n, dtype=torch.float64)
    v_err = {}
    for variant in ("mgsr", "householder"):
        rj = gt.gmres(a_j, b_j, restart=m, tol=tol, variant=variant, max_restarts=1)
        rt = tt.gmres(a_t, b_t, restart=m, tol=tol, variant=variant, max_restarts=1)
        assert rt.iterations == int(rj.iterations)
        assert rt.status == int(rj.status)
        v_err[variant] = (float(rt.v_err.max()), float(jnp.max(rj.v_err)))
        np.testing.assert_allclose(to_np(rt.x), np.asarray(rj.x), rtol=1e-3)
    for k in (0, 1):  # port, JAX
        assert v_err["householder"][k] <= 1e-6 * v_err["mgsr"][k], v_err
