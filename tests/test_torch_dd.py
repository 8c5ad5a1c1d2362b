"""The (hi, lo) float32 pair route of the PyTorch port (``ops/dd.py`` and the
dd entry points of ``ops/stencil.py``, kernel K6's plain version) against
gmres_tpu: the pair constructors bitwise, the Pallas dd kernels in interpret
mode and the float64 oracle.

The JAX kernels run double-double arithmetic (~2⁻⁴⁸ relative per
application); the port's plain version works in float64 and splits the
result once (one float64 rounding per operation, then the pair's 2⁻⁴⁹).
So the two agree to the JAX kernel's own error: 1e-13 relative to max|y| for
one application, 1e-12 after 20 (JAX's bounds against its oracle,
tests/test_dd_stencil.py). K6 itself is held against the plain version on
the card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.models.convection_diffusion import convection_diffusion_coefs
from gmres_tpu.ops import dd as jdd
from gmres_tpu.ops import stencil as jst
from gmres_tpu_torch.ops import dd as tdd
from gmres_tpu_torch.ops import stencil as tst
from tests.torch_parity import rel_err, seeded, to_np, to_torch

GENERAL = {
    "convection-diffusion": convection_diffusion_coefs(0.4, 0.2),
    "arbitrary": (4.3, -1.2, -0.7, -1.9, -0.1),
}


def _rel_norm(a, b) -> float:
    """‖a − b‖ / ‖b‖ over the grid (the metric of JAX's dd tests)."""
    a, b = to_np(a), to_np(b)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def test_pair_constructors_bitwise():
    """dd_from_f64 and dd_to_f64 give JAX's bits, over 12 decades."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, size=4096)
    j_hi, j_lo = jdd.dd_from_f64(jnp.asarray(x))
    t_hi, t_lo = tdd.dd_from_f64(to_torch(x))
    assert t_hi.dtype == t_lo.dtype == torch.float32
    np.testing.assert_array_equal(to_np(t_hi), np.asarray(j_hi))
    np.testing.assert_array_equal(to_np(t_lo), np.asarray(j_lo))
    back = tdd.dd_to_f64((t_hi, t_lo))
    assert back.dtype == torch.float64
    np.testing.assert_array_equal(to_np(back), np.asarray(jdd.dd_to_f64((j_hi, j_lo))))
    assert np.max(np.abs(to_np(back) - x) / np.abs(x)) < 2.0 ** -48


def test_poisson_pair_matches_pallas_interpret():
    x = seeded(4, (32, 32))
    j_pair = jst.stencil_5pt_dd_pallas_blocked(*jdd.dd_from_f64(jnp.asarray(x)),
                                               interpret=True)
    t_pair = tst.stencil_5pt_dd_pallas_blocked(*tdd.dd_from_f64(to_torch(x)))
    assert all(t.dtype == torch.float32 and t.shape == (32, 32) for t in t_pair)
    y = tdd.dd_to_f64(t_pair)
    assert rel_err(y, jdd.dd_to_f64(j_pair)) < 1e-13
    oracle = jst.stencil_5pt_apply(jnp.asarray(x))
    assert _rel_norm(y, oracle) < 1e-13
    assert _rel_norm(tst.stencil_5pt_f64_via_dd(to_torch(x)), oracle) < 1e-13


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_pair_matches_pallas_interpret(name):
    coefs = GENERAL[name]
    x = seeded(8, (64, 64))
    ref = jst.stencil_5pt_general_f64_via_dd(jnp.asarray(x), coefs, interpret=True)
    y = tst.stencil_5pt_general_f64_via_dd(to_torch(x), coefs)
    assert y.dtype == torch.float64
    assert rel_err(y, ref) < 1e-13
    assert _rel_norm(y, jst.stencil_5pt_general(jnp.asarray(x), *coefs)) < 1e-13


def test_chain_of_20_matches_pallas_interpret():
    """20 applications in pair space (split once): the most the pair's
    float32 exponent range allows (JAX's cap, tests/test_dd_stencil.py)."""
    x = seeded(6, (32, 32))
    ref = jst.stencil_5pt_f64_dd_chain(jnp.asarray(x), 20, interpret=True)
    y = tst.stencil_5pt_f64_dd_chain(to_torch(x), 20)
    assert rel_err(y, ref) < 1e-12
    y64 = jnp.asarray(x)
    for _ in range(20):
        y64 = jst.stencil_5pt_apply(y64)
    assert _rel_norm(y, y64) < 1e-12


def test_poisson_through_general_entry_equals_poisson_entry():
    hi, lo = tdd.dd_from_f64(to_torch(seeded(9, (40, 24))))
    p = tst.stencil_5pt_dd_pallas_blocked(hi, lo)
    g = tst.stencil_5pt_dd_general_pallas_blocked(hi, lo, torch.tensor(tst.POISSON_COEFS))
    torch.testing.assert_close(g[0], p[0], rtol=0, atol=0)
    torch.testing.assert_close(g[1], p[1], rtol=0, atol=0)
