"""Kernel K1 (5-point stencil) of the PyTorch port against gmres_tpu.

On the CPU the port's entry points take the plain PyTorch version; these
tests hold it against the JAX jnp stencils and against the Pallas kernels
in interpret mode. K1 itself is held against the plain version on the
card by tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmres_tpu.ops import stencil as jst
from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops import stencil as tst
from tests.torch_parity import seeded, to_np, to_torch

# The plain versions evaluate the same products and sums in the same order
# as the jnp stencil, so only a compiler's fused multiply-add can separate
# them: allow a few ulp of the output's scale.
RTOL = {np.float32: 2e-6, np.float64: 1e-14}


def _coefs(seed):
    return tuple(float(c) for c in seeded(seed, 5))


def _close(a, b, dtype):
    b = to_np(b)
    np.testing.assert_allclose(to_np(a), b, rtol=0,
                               atol=RTOL[dtype] * np.max(np.abs(b)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (17, 17), (64, 64)])
def test_plain_general_matches_jnp(dtype, shape):
    x = seeded(1, shape, dtype)
    coefs = _coefs(2)
    _close(tst.stencil_5pt_general(to_torch(x), *coefs),
           jst.stencil_5pt_general(jnp.asarray(x), *coefs), dtype)
    _close(tst.stencil_5pt_apply(to_torch(x)),
           jst.stencil_5pt_apply(jnp.asarray(x)), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_halo_matches_jnp(dtype):
    x, top, bot = seeded(3, (12, 40), dtype), seeded(4, 40, dtype), seeded(5, 40, dtype)
    coefs = _coefs(6)
    _close(tst.stencil_5pt_halo(to_torch(x), to_torch(top), to_torch(bot), coefs),
           jst.stencil_5pt_halo(jnp.asarray(x), jnp.asarray(top),
                                jnp.asarray(bot), coefs), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_halo_entry_matches_pallas_interpret(dtype):
    x, top, bot = seeded(7, (24, 48), dtype), seeded(8, 48, dtype), seeded(9, 48, dtype)
    coefs = _coefs(10)
    ref = jst.stencil_5pt_pallas_halo(
        jnp.asarray(x), jnp.asarray(top), jnp.asarray(bot),
        jnp.asarray(coefs, dtype=dtype), interpret=True)
    _close(tst.stencil_5pt_pallas_halo(to_torch(x), to_torch(top),
                                       to_torch(bot), coefs), ref, dtype)
    # (1, N) halo rows, as the Pallas kernel takes them
    _close(tst.stencil_5pt_pallas_halo(to_torch(x), to_torch(top[None]),
                                       to_torch(bot[None]), coefs), ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_full_grid_entry_matches_pallas_interpret(dtype):
    x = seeded(11, (32, 32), dtype)
    coefs = _coefs(12)
    ref = jst.stencil_5pt_pallas(jnp.asarray(x), jnp.asarray(coefs, dtype=dtype),
                                 interpret=True)
    _close(tst.stencil_5pt_pallas(to_torch(x), coefs), ref, dtype)
    # default coefficients: the Laplacian
    _close(tst.stencil_5pt_pallas(to_torch(x)),
           jst.stencil_5pt_pallas(jnp.asarray(x), interpret=True), dtype)


@pytest.mark.parametrize("block_rows", [8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_entry_matches_pallas_interpret(block_rows, dtype):
    x = seeded(13, (64, 64), dtype)
    coefs = _coefs(14)
    ref = jst.stencil_5pt_pallas_blocked(
        jnp.asarray(x), jnp.asarray(coefs, dtype=dtype), interpret=True,
        block_rows=block_rows)
    _close(tst.stencil_5pt_pallas_blocked(to_torch(x), coefs), ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_routed_matches_jax_router(dtype):
    x = seeded(15, (48, 48), dtype)
    coefs = _coefs(16)
    _close(tst.stencil_5pt_routed(to_torch(x)),
           jst.stencil_5pt_routed(jnp.asarray(x)), dtype)
    _close(tst.stencil_5pt_routed_general(to_torch(x), coefs),
           jst.stencil_5pt_routed_general(jnp.asarray(x), coefs), dtype)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version without building anything, and
    the kernel wrapper refuses a CPU tensor instead of computing on it."""
    def no_build():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", no_build)
    x = to_torch(seeded(17, (8, 8)))
    before = tst.stencil5_cuda.launches
    tst.stencil_5pt_routed(x)
    tst.stencil_5pt_pallas_halo(x, x[0], x[-1])
    assert tst.stencil5_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tst.stencil5_cuda(x)


def test_dtype_gate():
    """Only float32 and float64 have a kernel build."""
    assert _cuda.suffix(torch.float32) == "f32"
    assert _cuda.suffix(torch.float64) == "f64"
    for dt in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(TypeError):
            _cuda.suffix(dt)
