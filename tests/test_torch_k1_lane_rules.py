"""K1's per-lane route with its rules, on the plain version (the card's are
tests/test_torch_kernels_gpu.py): ``ops/stencil.py:Stencil5Lanes`` on a
(lanes, rows, cols) block with a (lanes, 5) coefficient array, and the
nested vmap of ``ops/_cuda.py:through_lanes`` (a lane that is itself a
block of rows), against dense matrices, ``torch.autograd.functional`` on
the plain stencil and per-row calls.
"""

import numpy as np
import pytest
import torch

from gmres_tpu_torch.ops import fused as tfu
from gmres_tpu_torch.ops import stencil as tst
from tests.torch_parity import seeded, to_torch

F64 = torch.float64


def _coefs(lanes, seed=90):
    c = seeded(seed, (lanes, 5)) * 0.3
    c[:, 0] += 4.0
    c[:, 1:] -= 1.0
    return to_torch(c)


def _dense(c, n):
    """The (n², n²) matrix of one lane's stencil (C order)."""
    eye = np.eye(n * n)
    return np.stack([tst.stencil_5pt_general(to_torch(e.reshape(n, n)), *c.tolist())
                     .reshape(-1).numpy() for e in eye], axis=1)


def test_transpose_is_the_dense_transpose_each_lane():
    lanes, n = 3, 6
    c = _coefs(lanes)
    u = to_torch(seeded(91, (lanes, n, n))).requires_grad_()
    y = tst.Stencil5Lanes.apply(u, c)
    gy = to_torch(seeded(92, (lanes, n, n)))
    before = tst.Stencil5Grid.rule_applications["transpose"]
    (gu,) = torch.autograd.grad(y, u, gy)
    assert tst.Stencil5Grid.rule_applications["transpose"] == before + 1
    for k in range(lanes):
        want = _dense(c[k], n).T @ gy[k].reshape(-1).numpy()
        np.testing.assert_allclose(gu[k].reshape(-1).numpy(), want, atol=1e-13)
        # The transpose is the stencil with the mirrored coefficients.
        assert torch.equal(gu[k], tst.stencil_5pt_general(
            gy[k], *c[k, list(tst._MIRROR)].tolist()))


def test_coefficient_cotangent_and_tangent_match_autograd_functional():
    lanes, n = 3, 7
    c = _coefs(lanes, 93)
    x = to_torch(seeded(94, (lanes, n, n)))
    gy = to_torch(seeded(95, (lanes, n, n)))

    def plain(xb, cb):
        return tst._per_lane_apply(xb, cb)

    _, (gx_ref, gc_ref) = torch.autograd.functional.vjp(plain, (x, c), gy)
    xt, ct = x.clone().requires_grad_(), c.clone().requires_grad_()
    gx, gc = torch.autograd.grad(tst.Stencil5Lanes.apply(xt, ct), (xt, ct), gy)
    torch.testing.assert_close(gx, gx_ref, rtol=0, atol=1e-13)
    torch.testing.assert_close(gc, gc_ref, rtol=1e-13, atol=1e-12)
    tx, tc = to_torch(seeded(96, (lanes, n, n))), to_torch(seeded(97, (lanes, 5)))
    _, jvp_ref = torch.autograd.functional.jvp(plain, (x, c), (tx, tc))
    before = tst.Stencil5Grid.rule_applications["tangent"]
    _, jvp = torch.func.jvp(tst.Stencil5Lanes.apply, (x, c), (tx, tc))
    assert tst.Stencil5Grid.rule_applications["tangent"] == before + 1
    torch.testing.assert_close(jvp, jvp_ref, rtol=1e-13, atol=1e-12)


def test_per_lane_route_under_vjp_of_vmap_takes_the_rules():
    """A tracked block reaching the per-lane route (the vjp of a vmapped
    operator family, a batched solve's transposes): on the card through
    Stencil5Lanes; on the CPU the plain version, whose transposes are
    the sequential solve's bits, each lane's."""
    lanes, n = 3, 8
    gam = to_torch(np.array([0.1, 0.4, 0.7]))

    def a(v, g):
        return tst.stencil_5pt_pallas(v, torch.stack([4.0 + 0 * g, -(1 + g), -(1 - g),
                                                      -(1 + 0.5 * g), -(1 - 0.5 * g)]))

    like = to_torch(seeded(98, (lanes, n, n)))
    u = to_torch(seeded(99, (lanes, n, n)))
    _, pullback = torch.func.vjp(lambda vb: torch.func.vmap(a)(vb, gam), like)
    (got,) = pullback(u)
    for k in range(lanes):
        _, pb = torch.func.vjp(lambda v: a(v, gam[k]), like[k])
        assert torch.equal(got[k], pb(u[k])[0]), k


@pytest.mark.parametrize("in_dims", [(0, 0), (1, 0), (2, 1)])
def test_nested_vmap_is_one_block_call_bitwise_the_rows(in_dims):
    """(lanes, s) blocks (with the batch dims anywhere) through K1, its two
    V-cycle forms and K2: one block call each, on lanes·s grids, each
    lane's per-lane coefficients repeated down its s rows; every row the
    bits of its own call."""
    lanes, s, n = 3, 2, 8
    outer, inner = in_dims
    x = to_torch(seeded(100, (lanes, s, n, n)))
    c = _coefs(lanes, 101)
    xin = x.movedim(1, inner + 1).movedim(0, outer) if (outer, inner) != (0, 0) else x

    def per_lane(xl, cl):
        return torch.func.vmap(lambda v: tst.stencil_5pt_pallas(v, cl.unbind()),
                               in_dims=inner)(xl)

    before = tst.stencil_5pt_pallas.block_calls
    y = torch.func.vmap(per_lane, in_dims=(outer, 0))(xin, c)
    assert tst.stencil_5pt_pallas.block_calls == before + 1
    for k in range(lanes):
        for j in range(s):
            assert torch.equal(y[k, j], tst.stencil_5pt_general(x[k, j], *c[k].tolist()))
    e = to_torch(seeded(102, (lanes, s, n, n)))
    ec = to_torch(seeded(103, (lanes, s, n // 2, n // 2)))
    cs = (4.2, -1.1, -0.9, -1.0, -1.2)
    theta, _, steps = tfu.chebyshev_k_scalars(0.3, 8.0, 4)
    counters = (tst.residual_restrict, tst.correct_residual, tfu.poly_stencil_smoother_pallas)
    before = [f.block_calls for f in counters]
    nest = lambda f: torch.func.vmap(torch.func.vmap(f))  # noqa: E731
    rr = nest(lambda r, ee: tst.residual_restrict(r, ee, cs))(x, e)
    e2, r2 = nest(lambda r, ee, cc: tst.correct_residual(r, ee, cc, cs))(x, e, ec)
    z = nest(lambda r: tfu.poly_stencil_smoother_pallas(r, theta, steps, cs))(x)
    assert [f.block_calls - b for f, b in zip(counters, before)] == [1, 1, 1]
    for k in range(lanes):
        for j in range(s):
            assert torch.equal(rr[k, j], tst.residual_restrict_plain(x[k, j], e[k, j], cs))
            want_e, want_r = tst.correct_residual_plain(x[k, j], e[k, j], ec[k, j], cs)
            assert torch.equal(e2[k, j], want_e) and torch.equal(r2[k, j], want_r)
            assert torch.equal(z[k, j], tfu.poly_stencil_smoother_plain(x[k, j], theta,
                                                                        steps, cs))


def test_nested_vmap_with_a_coefficient_batched_at_the_inner_level_only():
    """A coefficient that differs by row and not by lane (batched at the
    inner level only) is repeated down the lanes."""
    lanes, s, n = 2, 3, 6
    x = to_torch(seeded(104, (lanes, s, n, n)))
    g = to_torch(np.array([0.1, 0.2, 0.3]))

    def row(v, gi):
        return tst.stencil_5pt_pallas(v, (4.0, -(1 + gi), -(1 - gi), -1.0, -1.0))

    y = torch.func.vmap(lambda xl: torch.func.vmap(row)(xl, g))(x)
    for k in range(lanes):
        for j in range(s):
            gj = float(g[j])
            assert torch.equal(y[k, j], tst.stencil_5pt_general(
                x[k, j], 4.0, -(1 + gj), -(1 - gj), -1.0, -1.0))


def test_tangent_of_a_gamma_family_under_vmap():
    """vmap of jvp through an operator family whose coefficients differ by
    lane (a batched Newton J·v on a family): the rules keep the lanes'
    coefficients as tensors (``ops/stencil.py:_value``) and each lane's
    tangent is its own jvp's, bitwise."""
    lanes, n = 3, 8
    gam = to_torch(np.array([0.1, 0.4, 0.7]))
    x = to_torch(seeded(105, (lanes, n, n)))
    t = to_torch(seeded(106, (lanes, n, n)))

    def a(v, g):
        return tst.stencil5_grid(v, torch.stack([4.0 + 0 * g, -(1 + g), -(1 - g),
                                                 -(1 + 0.5 * g), -(1 - 0.5 * g)]))

    got = torch.func.vmap(lambda v, tv, g: torch.func.jvp(lambda u: a(u, g), (v,), (tv,))[1])(
        x, t, gam)
    for k in range(lanes):
        _, want = torch.func.jvp(lambda u: a(u, gam[k]), (x[k],), (t[k],))
        assert torch.equal(got[k], want), k
