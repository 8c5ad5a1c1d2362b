"""Kernel K2 (order-k polynomial smoother) and the Chebyshev
preconditioners of the PyTorch port against gmres_tpu.

On the CPU the port's entry points take the plain recurrence; these tests
hold it against the Pallas kernels in interpret mode and against the jnp
recurrence. K2 itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gmres_tpu as gt
from gmres_tpu.ops import fused as jfu
from gmres_tpu.precond import chebyshev as jch
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import fused as tfu
from tests.torch_parity import rel_err, seeded, to_torch


@pytest.mark.parametrize("lo,hi,order", [(0.2, 8.2, 2), (8.2, 0.2, 8),
                                         (2.0, 8.0, 3), (0.0035, 8.0, 32),
                                         (1e-4, 7.9, 1)])
def test_chebyshev_scalars_bit_identical(lo, hi, order):
    assert tfu.chebyshev_k_scalars(lo, hi, order) == jfu.chebyshev_k_scalars(lo, hi, order)


@pytest.mark.parametrize("omega,center,order", [(0.7, 4.0, 8), (0.6, 4.4, 3)])
def test_jacobi_scalars_bit_identical(omega, center, order):
    assert tfu.jacobi_k_scalars(omega, center, order) == jfu.jacobi_k_scalars(omega, center, order)


@pytest.mark.parametrize("lo,hi", [(0.2, 8.2), (8.2, 0.2), (0.01, 7.5)])
def test_cbpr2_scalars_bit_identical(lo, hi):
    assert tfu.chebyshev_ref_scalars(lo, hi) == jfu.chebyshev_ref_scalars(lo, hi)


@pytest.mark.parametrize("order", [2, 3, 8, 32])
def test_plain_matches_whole_grid_pallas(order):
    r = seeded(order, (32, 32), np.float32)
    ref = jfu.chebyshev_k_poisson_pallas(jnp.asarray(r), order, 0.005, 8.0,
                                         interpret=True)
    z = tfu.chebyshev_k_poisson_pallas(to_torch(r), order, 0.005, 8.0)
    # Same f32 operations in the same order; a deep polynomial amplifies
    # the last-bit differences a fused multiply-add can make.
    assert rel_err(z, ref) < (1e-6 if order <= 8 else 1e-5)


@pytest.mark.parametrize("order", [3, 8])
def test_plain_matches_blocked_pallas(order):
    r = seeded(40 + order, (64, 64), np.float32)
    ref = jfu.chebyshev_k_poisson_pallas_blocked(
        jnp.asarray(r), order, 0.5, 8.0, interpret=True, block_rows=16)
    z = tfu.chebyshev_k_poisson_pallas_blocked(to_torch(r), order, 0.5, 8.0)
    assert rel_err(z, ref) < 1e-6


def test_plain_matches_jacobi_pallas():
    from gmres_tpu.models.convection_diffusion import convection_diffusion_coefs

    coefs = tuple(float(c) for c in convection_diffusion_coefs(0.4, 0.2))
    theta, steps = jfu.jacobi_k_scalars(0.7, coefs[0], 8)
    r = seeded(50, (32, 32), np.float32)
    ref = jfu.poly_stencil_smoother_pallas(jnp.asarray(r), theta, tuple(steps),
                                           coefs, interpret=True)
    z = tfu.poly_stencil_smoother_pallas(to_torch(r), theta, steps, coefs)
    assert rel_err(z, ref) < 1e-6
    zb = tfu.poly_stencil_smoother_pallas_blocked(to_torch(r), theta, steps, coefs)
    torch.testing.assert_close(zb, z, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stencil_preconditioner_matches_jax(dtype):
    """The routed semi-iteration (plain on the CPU) against JAX's router
    (the jnp recurrence on the CPU), including order 2, where it is the
    semi-iteration and not cbpr2."""
    r = seeded(51, (24, 24), dtype)
    for order in (2, 8):
        ref = jch.chebyshev_stencil_preconditioner(0.005, 8.0, order=order)(jnp.asarray(r))
        m = tt.chebyshev_stencil_preconditioner(0.005, 8.0, order=order)
        assert rel_err(m(to_torch(r)), ref) < (2e-6 if dtype == np.float32 else 1e-13)
        theta, _, steps = jfu.chebyshev_k_scalars(0.005, 8.0, order)
        assert (m.theta, m.steps, m.order) == (theta, tuple(steps), order)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chebyshev_preconditioner_both_forms(dtype):
    n = 20
    r = seeded(52, (n, n), dtype)
    jop, top = gt.poisson_operator(n), tt.poisson_operator(n)
    tol = 2e-6 if dtype == np.float32 else 1e-13
    # cbpr2 closed form (reference_form=True at order 2)
    ref = gt.chebyshev_preconditioner(jop, 0.2, 8.2)(jnp.asarray(r))
    assert rel_err(tt.chebyshev_preconditioner(top, 0.2, 8.2)(to_torch(r)), ref) < tol
    # order-k recurrence, and order 2 in recurrence form
    for order in (2, 5):
        ref = gt.chebyshev_preconditioner(jop, 0.1, 8.0, order=order,
                                          reference_form=False)(jnp.asarray(r))
        z = tt.chebyshev_preconditioner(top, 0.1, 8.0, order=order,
                                        reference_form=False)(to_torch(r))
        assert z.dtype == to_torch(r).dtype
        assert rel_err(z, ref) < tol


def test_tuned_preconditioner_plan_matches():
    mj, order_j, lo_j, hi_j = gt.tuned_poisson_preconditioner(40)
    mt, order_t, lo_t, hi_t = tt.tuned_poisson_preconditioner(40)
    assert (order_t, lo_t, hi_t) == (order_j, lo_j, hi_j)
    r = seeded(53, (40, 40))
    assert rel_err(mt(to_torch(r)), mj(jnp.asarray(r))) < 1e-12


def test_blocked_feasible_covers_path_grids():
    for n in (16, 75, 150, 300, 1024, 2048):
        assert tfu.chebyshev_blocked_feasible(n, 3)
        assert tfu.chebyshev_blocked_feasible(n, 32)
    assert not tfu.chebyshev_blocked_feasible(0, 3)
