"""chebyshev_solve of the PyTorch port against gmres_tpu on the same numpy
inputs, on the CPU, float64.

Cycles and status equal; x within 1e-10 of JAX's relative to max|x|; the
per-cycle history within 1e-8 relative or 1e-13 absolute; the residual
under tol. Cases mirror tests/test_chebyshev_solve.py: the generic route
(the semi-iteration around A) and the stencil route (``coefs``: K2's plain
version on the CPU), which apply the same polynomial and take the same
cycles (x within 1e-12 of each other, tests/test_chebyshev_solve.py:30);
bounds that miss the lower spectrum, BREAKDOWN on non-contraction in both
(:48); x0; the 3-D model (:61, here 8³); ``use_pallas="never"``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops.stencil import stencil_5pt_general
from tests.torch_parity import rel_err, seeded, to_np, to_torch

POISSON = (4.0, -1.0, -1.0, -1.0, -1.0)
# label: (grid, order, keyword arguments).
CASES = {
    "generic": (32, 16, {}),
    "stencil": (32, 16, {"coefs": POISSON}),
    "never": (32, 16, {"coefs": POISSON, "use_pallas": "never"}),
    "x0": (24, 12, {"x0": True}),
    "bad-bounds": (16, 8, {"bad": True}),
    "3d": (8, 16, {"dim": 3}),
}


def _call(pkg, label):
    n, order, kw = CASES[label]
    kw = dict(kw)
    conv = jnp.asarray if pkg is gt else to_torch
    if kw.pop("dim", 2) == 3:
        op = pkg.poisson3d_operator(n)
        b = np.asarray(gt.poisson3d_operator(n)(jnp.ones((n, n, n))))
        lo, hi = gt.poisson3d_spectral_bounds(n)
    else:
        op = pkg.poisson_operator(n)
        b = np.asarray(gt.poisson_operator(n)(jnp.ones((n, n))))
        lo, hi = gt.poisson_spectral_bounds(n)
    if kw.pop("bad", False):
        lo, hi = hi / 4, hi / 2
    if kw.pop("x0", False):
        kw["x0"] = conv(seeded(90, b.shape))
    return pkg.chebyshev_solve(op, conv(b), lo, hi, order=order, tol=1e-9,
                               max_cycles=200, **kw)


@functools.lru_cache(maxsize=None)
def _jax(label):
    return _call(gt, label)


@pytest.mark.parametrize("label", sorted(CASES))
def test_chebyshev_solve_matches_jax(label):
    rj, rt = _jax(label), _call(tt, label)
    assert (rt.iterations, rt.status) == (int(rj.iterations), int(rj.status))
    np.testing.assert_allclose(to_np(rt.residual_history), to_np(rj.residual_history),
                               rtol=1e-8, atol=1e-13)
    # The initial residual and one read a cycle.
    assert rt.host_syncs == 1 + rt.iterations
    if label == "bad-bounds":
        assert rt.status == tt.SolverStatus.BREAKDOWN
        return
    assert rel_err(rt.x, rj.x) <= 1e-10
    assert rt.converged and float(rt.residual) < 1e-9
    np.testing.assert_allclose(to_np(rt.x), 1.0, atol=1e-8)


def test_stencil_route_equals_generic_route():
    generic, stencil = _call(tt, "generic"), _call(tt, "stencil")
    assert stencil.iterations == generic.iterations
    np.testing.assert_allclose(to_np(stencil.x), to_np(generic.x), rtol=1e-12)


def test_use_pallas_values():
    """"never" takes K2's plain version (any device), which applies the
    semi-iteration of chebyshev_preconditioner around the stencil; "auto"
    and "always" route by device (the plain version on the CPU); anything
    else raises."""
    r = to_torch(seeded(91, (16, 16)))
    plain = tt.chebyshev_stencil_preconditioner(0.1, 8.0, order=6, use_pallas="never")
    generic = tt.chebyshev_preconditioner(
        lambda x: stencil_5pt_general(x, *POISSON), 0.1, 8.0, order=6,
        reference_form=False)
    torch.testing.assert_close(plain(r), generic(r), rtol=1e-13, atol=1e-13)
    for mode in ("auto", "always"):
        routed = tt.chebyshev_stencil_preconditioner(0.1, 8.0, order=6, use_pallas=mode)
        torch.testing.assert_close(routed(r), plain(r), rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match="use_pallas"):
        tt.chebyshev_stencil_preconditioner(0.1, 8.0, use_pallas="sometimes")
    with pytest.raises(ValueError, match="use_pallas"):
        tt.chebyshev_solve(tt.poisson_operator(8), r[:8, :8], 0.1, 8.0, coefs=POISSON,
                           use_pallas="sometimes")
