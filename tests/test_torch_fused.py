"""The plain versions of kernels K5 (fused cbpr2) and K7 (fused CG update,
axpy-dot) against gmres_tpu's Pallas kernels in interpret mode, as
tests/test_fused.py runs them, on the same numpy-seeded inputs.

Tolerances: K5's plain version repeats the Pallas kernel's operations in
its order, so it agrees to the last bit or two (rtol 1e-6 in float32,
1e-14 in float64). K7's elementwise outputs are the same operations in the
input dtype (rtol 1e-6); its float32 sums are taken in another order than
the Pallas kernel's (rtol 1e-5 over a few thousand terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.ops import fused as jfu
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import fused as tfu
from tests.torch_parity import rel_err, seeded, to_torch

COEFS = (4.0, -1.2, -0.8, -1.1, -0.9)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-14)])
@pytest.mark.parametrize("halos", ["zero", "random"])
@pytest.mark.parametrize("coefs", [(4.0, -1.0, -1.0, -1.0, -1.0), COEFS])
def test_k5_plain_matches_pallas(dtype, rtol, halos, coefs):
    rows, n = 16, 40
    r = seeded(910, (rows, n), dtype)
    if halos == "zero":
        top = bot = np.zeros((1, n), dtype)
    else:
        top, bot = seeded(911, (1, n), dtype), seeded(912, (n,), dtype)
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    zj = jfu.chebyshev_poisson_fused(jnp.asarray(r), jnp.asarray(top),
                                     jnp.asarray(bot), d, alpha, coefs,
                                     interpret=True)
    zt = tt.chebyshev_poisson_fused(to_torch(r), to_torch(top), to_torch(bot),
                                    d, alpha, coefs)
    assert zt.dtype == to_torch(r).dtype
    assert rel_err(zt, zj) < rtol


def test_k5_is_cbpr2():
    """With zero halos on the whole grid, K5's plain version is the
    reference cbpr2 of the port (by linearity, A(r/d) = A(r)/d)."""
    n = 32
    r = to_torch(seeded(913, (n, n)))
    m_ref = tt.chebyshev_preconditioner(tt.poisson_operator(n), 0.2, 8.2)
    d, alpha = tfu.chebyshev_ref_scalars(0.2, 8.2)
    assert rel_err(tt.chebyshev_poisson_fused(r, None, None, d, alpha), m_ref(r)) < 1e-14


@pytest.mark.parametrize("shape", [(16, 128), (300,)])
@pytest.mark.parametrize("alpha", [0.37, -1.25])
def test_k7_cg_fused_update_plain_matches_pallas(shape, alpha):
    x, r, p, ap = (seeded(920 + s, shape, np.float32) for s in range(4))
    xj, rj, sj = jfu.cg_fused_update(*(jnp.asarray(a) for a in (x, r, p, ap)),
                                     alpha, interpret=True)
    xt, rt, st = tt.cg_fused_update(*(to_torch(a) for a in (x, r, p, ap)), alpha)
    assert st.dtype == torch.float32 and st.shape == ()
    assert rel_err(xt, xj) < 1e-6 and rel_err(rt, rj) < 1e-6
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 128), (300,)])
@pytest.mark.parametrize("alpha", [-1.25, 0.5])
def test_k7_axpy_dot_plain_matches_pallas(shape, alpha):
    x, y, z = (seeded(930 + s, shape, np.float32) for s in range(3))
    yj, dj = jfu.axpy_dot(alpha, *(jnp.asarray(a) for a in (x, y, z)),
                          interpret=True)
    yt, dt = tt.axpy_dot(alpha, *(to_torch(a) for a in (x, y, z)))
    assert dt.dtype == torch.float32 and dt.shape == ()
    assert rel_err(yt, yj) < 1e-6
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_k7_float64_operands_sum_in_float32():
    """float64 vectors: the update stays float64, the sum is float32 (the
    JAX kernels' out_shape), as JAX's interpret-mode kernel returns it."""
    x, r, p, ap = (seeded(940 + s, (16, 128)) for s in range(4))
    xj, rj, sj = jfu.cg_fused_update(*(jnp.asarray(a) for a in (x, r, p, ap)),
                                     0.37, interpret=True)
    xt, rt, st = tt.cg_fused_update(*(to_torch(a) for a in (x, r, p, ap)), 0.37)
    assert xt.dtype == rt.dtype == torch.float64 and st.dtype == torch.float32
    assert rel_err(xt, xj) < 1e-15 and rel_err(rt, rj) < 1e-15
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-15)])
def test_k7_plain_alpha_as_number_or_tensor(dtype, rtol):
    """α as a Python number and as a 0-d tensor (of float64, or of the
    vectors' dtype) is rounded to the dtype alike: the same bits, as K7
    gives for α by value and by pointer; and gmres_tpu's interpret-mode
    kernels, which round α with jnp.asarray(alpha, dtype=x.dtype)."""
    x, r, p, ap = (seeded(960 + s, (16, 128), dtype) for s in range(4))
    alpha = 0.37
    xj, rj, sj = jfu.cg_fused_update(*(jnp.asarray(a) for a in (x, r, p, ap)),
                                     alpha, interpret=True)
    yj, dj = jfu.axpy_dot(alpha, *(jnp.asarray(a) for a in (x, r, p)), interpret=True)
    xt, rt, pt, apt = (to_torch(a) for a in (x, r, p, ap))
    forms = (alpha, torch.tensor(alpha, dtype=torch.float64),
             torch.tensor(alpha, dtype=xt.dtype))
    upd = [tfu.cg_fused_update_plain(xt, rt, pt, apt, a) for a in forms]
    axd = [tfu.axpy_dot_plain(a, xt, rt, pt) for a in forms]
    for got in upd[1:]:
        for a, b in zip(got, upd[0]):
            assert torch.equal(a, b)
    for got in axd[1:]:
        for a, b in zip(got, axd[0]):
            assert torch.equal(a, b)
    assert rel_err(upd[0][0], xj) < rtol and rel_err(upd[0][1], rj) < rtol
    assert rel_err(axd[0][0], yj) < rtol
    np.testing.assert_allclose(upd[0][2].numpy(), np.asarray(sj), rtol=1e-5)
    np.testing.assert_allclose(axd[0][1].numpy(), np.asarray(dj), rtol=1e-5)


@pytest.mark.parametrize("n,itemsize,aligned,want", [
    (304 * 304, 8, True, (2, 181)),     # the strong-scaling shard, f64
    (304 * 304, 4, True, (4, 132)),     # f32: 91 blocks' worth, one a SM
    (2048 * 2048, 4, True, (4, 528)),   # capped at 4 blocks an SM
    (304 * 304, 8, False, (1, 361)),    # unaligned: one element a step
    (7, 4, True, (4, 1)),               # one chunk and a tail of 3
    (1000, 8, True, (2, 16)),           # 500 chunks: a warp's worth a block
])
def test_k7_plan(n, itemsize, aligned, want):
    """K7's grid on a 132-SM card: a block per 256 chunks, at most 4 an SM,
    and at least one a SM while each gets a warp's worth of chunks; every
    element is covered by the grid-stride loop or the tail."""
    vec, blocks = tfu.k7_plan(n, itemsize, aligned, 132)
    assert (vec, blocks) == want
    # The last n mod vec elements go one a thread to block 0's first threads.
    assert n % vec < vec <= tfu.K7_THREADS


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counters stay put."""
    before = (tfu.cheb2_cuda.launches, tfu.cg_fused_update_cuda.launches,
              tfu.axpy_dot_cuda.launches)
    v = to_torch(seeded(950, (8, 8)))
    tt.chebyshev_poisson_fused(v, None, None, 4.2, 0.25)
    tt.cg_fused_update(v, v, v, v, 0.5)
    tt.axpy_dot(0.5, v, v, v)
    assert (tfu.cheb2_cuda.launches, tfu.cg_fused_update_cuda.launches,
            tfu.axpy_dot_cuda.launches) == before
