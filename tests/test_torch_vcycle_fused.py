"""K1's fused V-cycle forms (residual-restrict, correct-residual) and the
V-cycle that runs them, on the CPU.

The CUDA kernels cannot run here, so their per-quad expressions
(``csrc/stencil5.cu``: ``residual_restrict_kernel``,
``correct_residual_kernel``) are transcribed below, vectorised over the
quads, and held bitwise to the plain versions, which are the composition of
``stencil_5pt_general``, ``restrict_sum`` and ``prolong_repeat`` that the
V-cycle ran before the fused forms. The card holds the kernels to the same
plain versions (tests/test_torch_kernels_gpu.py, chip_smoke.py). The V-cycle
built on the routed forms is held to gmres_tpu's with
tests/test_torch_multigrid.py's tolerances."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import gmres_tpu as gt
import gmres_tpu_torch as tt
from gmres_tpu_torch.ops import _cuda
from gmres_tpu_torch.ops import stencil as tst
from gmres_tpu_torch.precond import multigrid as tmg
from tests.torch_parity import rel_err, seeded, to_torch

GENERAL = (4.3, -1.2, -0.7, -1.9, -0.1)
SHAPES = [(16, 16), (32, 32), (64, 64), (150, 150), (8, 20)]


def _quads(e: torch.Tensor):
    """e(i0 + di, j0 + dj) for every quad (i0, j0) = (2I, 2J), zero outside
    the grid: the values one kernel thread loads."""
    rows, cols = e.shape
    ep = F.pad(e, (1, 1, 1, 1))

    def at(di, dj):
        return ep[1 + di:1 + di + rows:2, 1 + dj:1 + dj + cols:2]

    return at


def _stencil(c, x, w, e, s, n):
    return c[0] * x + c[1] * w + c[2] * e + c[3] * s + c[4] * n


def emulate_residual_restrict(r, e, c):
    at = _quads(e)
    ea0, ea1, eb0, eb1 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    up0, up1, dn0, dn1 = at(-1, 0), at(-1, 1), at(2, 0), at(2, 1)
    wa, wb, xa, xb = at(0, -1), at(1, -1), at(0, 2), at(1, 2)
    ra0, ra1, rb0, rb1 = r[0::2, 0::2], r[0::2, 1::2], r[1::2, 0::2], r[1::2, 1::2]
    x00 = ra0 - _stencil(c, ea0, wa, ea1, up0, eb0)
    x01 = ra1 - _stencil(c, ea1, ea0, xa, up1, eb1)
    x10 = rb0 - _stencil(c, eb0, wb, eb1, ea0, dn0)
    x11 = rb1 - _stencil(c, eb1, eb0, xb, ea1, dn1)
    return (x00 + x10) + (x01 + x11)


def emulate_correct_residual(r, e, ec, c):
    at = _quads(e)
    gp = F.pad(ec, (1, 1, 1, 1))
    g, gu, gd = ec, gp[:-2, 1:-1], gp[2:, 1:-1]
    gw, ge = gp[1:-1, :-2], gp[1:-1, 2:]
    ea0, ea1, eb0, eb1 = at(0, 0) + g, at(0, 1) + g, at(1, 0) + g, at(1, 1) + g
    # A neighbour outside the grid reads e = 0 and ec = 0 here, 0 + 0 = +0:
    # the kernel's zero.
    up0, up1, dn0, dn1 = at(-1, 0) + gu, at(-1, 1) + gu, at(2, 0) + gd, at(2, 1) + gd
    wa, wb, xa, xb = at(0, -1) + gw, at(1, -1) + gw, at(0, 2) + ge, at(1, 2) + ge
    e2, r3 = torch.empty_like(e), torch.empty_like(r)
    e2[0::2, 0::2], e2[0::2, 1::2], e2[1::2, 0::2], e2[1::2, 1::2] = ea0, ea1, eb0, eb1
    r3[0::2, 0::2] = r[0::2, 0::2] - _stencil(c, ea0, wa, ea1, up0, eb0)
    r3[0::2, 1::2] = r[0::2, 1::2] - _stencil(c, ea1, ea0, xa, up1, eb1)
    r3[1::2, 0::2] = r[1::2, 0::2] - _stencil(c, eb0, wb, eb1, ea0, dn0)
    r3[1::2, 1::2] = r[1::2, 1::2] - _stencil(c, eb1, eb0, xb, ea1, dn1)
    return e2, r3


def _grids(seed, shape, dtype):
    r = to_torch(seeded(seed, shape)).to(dtype)
    e = to_torch(seeded(seed + 1, shape)).to(dtype)
    ec = to_torch(seeded(seed + 2, (shape[0] // 2, shape[1] // 2))).to(dtype)
    return r, e, ec


def _bitwise(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("coefs", [tst.POISSON_COEFS, GENERAL], ids=["poisson", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", ["residual_restrict", "correct_residual"])
def test_forms_are_bitwise_the_composition(form, shape, dtype, coefs):
    """The routed form (the plain version on the CPU), the plain version,
    the composition written out, and the kernel's per-quad expressions: all
    the same bits."""
    r, e, ec = _grids(600, shape, dtype)
    c = [float(v) for v in coefs]
    if form == "residual_restrict":
        composed = tt.restrict_sum(r - tst.stencil_5pt_general(e, *c))
        outs = (tst.residual_restrict(r, e, coefs), tst.residual_restrict_plain(r, e, coefs),
                emulate_residual_restrict(r, e, c))
        assert composed.shape == (shape[0] // 2, shape[1] // 2)
        for out in outs:
            _bitwise(out, composed)
    else:
        e2 = e + tt.prolong_repeat(ec)
        composed = (e2, r - tst.stencil_5pt_general(e2, *c))
        outs = (tst.correct_residual(r, e, ec, coefs),
                tst.correct_residual_plain(r, e, ec, coefs),
                emulate_correct_residual(r, e, ec, c))
        for out in outs:
            _bitwise(out[0], composed[0])
            _bitwise(out[1], composed[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [48, 150])
def test_v_cycle_on_the_fused_forms_matches_jax(n, dtype):
    """The V-cycle (now on the routed forms) against gmres_tpu's, with
    tests/test_torch_multigrid.py's tolerances (XLA may fuse a multiply-add
    that PyTorch rounds twice; the order-32 coarse solve amplifies it)."""
    mj = gt.poisson_multigrid_preconditioner(n)
    mt = tt.poisson_multigrid_preconditioner(n)
    r = seeded(610 + n, (n, n), dtype)
    z = mt(to_torch(r))
    assert z.dtype == to_torch(r).dtype and tuple(z.shape) == (n, n)
    assert rel_err(z, mj(jnp.asarray(r))) < (1e-5 if dtype == np.float32 else 1e-12)


def test_v_cycle_runs_each_form_once_a_level(monkeypatch):
    """One residual-restrict and one correct-residual per non-coarsest level
    and cycle."""
    calls = {"residual_restrict": 0, "correct_residual": 0}

    def counting(name):
        fn = getattr(tmg, name)

        def wrapped(*args):
            calls[name] += 1
            return fn(*args)

        return wrapped

    for name in calls:
        monkeypatch.setattr(tmg, name, counting(name))
    m_inv = tt.poisson_multigrid_preconditioner(64)
    m_inv(to_torch(seeded(620, (64, 64))))
    assert calls == {"residual_restrict": m_inv.levels - 1,
                     "correct_residual": m_inv.levels - 1}


def test_forms_refuse_mismatched_grids():
    r, e, ec = _grids(630, (8, 12), torch.float64)
    with pytest.raises(ValueError, match="even sides"):
        tst.residual_restrict(r[:7], e[:7])
    with pytest.raises(ValueError, match=r"\(8, 12\)"):
        tst.residual_restrict(r, e[:, :10])
    with pytest.raises(ValueError, match=r"\(4, 6\)"):
        tst.correct_residual(r, e, ec[:3])
    with pytest.raises(ValueError, match="float64"):
        tst.correct_residual(r, e, ec.float())


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """A CPU tensor takes the plain versions without building anything, and
    the kernel wrappers refuse a CPU tensor instead of computing on it."""
    def no_build():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", no_build)
    r, e, ec = _grids(640, (16, 16), torch.float32)
    before = (tst.residual_restrict_cuda.launches, tst.correct_residual_cuda.launches)
    tst.residual_restrict(r, e)
    tst.correct_residual(r, e, ec)
    tt.poisson_multigrid_preconditioner(32)(to_torch(seeded(641, (32, 32))))
    assert (tst.residual_restrict_cuda.launches,
            tst.correct_residual_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tst.residual_restrict_cuda(r, e)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tst.correct_residual_cuda(r, e, ec)
