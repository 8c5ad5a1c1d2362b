"""Communication-avoiding (s-step) preconditioned CG, in eager PyTorch.

Counterpart of ``gmres_tpu/solvers/sstep_cg.py`` (Chronopoulos–Gear;
Carson–Demmel–Hoemmen form), with its arithmetic. A cycle:

1. generates the monomial chains W_p = [p, Bp, …, Bˢp] and
   W_z = [z, Bz, …, Bˢ⁻¹z] with B = M∘A, keeping the A-images U of the
   chain columns (the intermediates of each B application): s + s
   operator and s + s − 1 preconditioner applications, no reduction;
2. takes the (2(2s+1)+1)² Gram of S = [r₀, V, U] in one product;
3. runs the s α/β/x̂/ẑ/p̂ recurrences on (2s+1)-vectors with the
   basis-shift matrix T (B·Vĉ = V·Tĉ), a failed or indefinite pivot
   ending the cycle's steps (BREAKDOWN, honestly);
4. rebuilds x and p from V, recomputes the true residual and z = M r, and
   certifies on ‖r‖₂ < tol (absolute).

JAX runs step 3 as a ``lax.scan`` of tiny products on the device. Here the
Gram is read back once a cycle and the recurrences run on that CPU copy,
in b's dtype; the coefficients of x and p go back to the device for the
reconstruction. ``lax.while_loop`` becomes a Python loop: the host reads
the initial residual, and twice a cycle the Gram and the certified
residual (``SolveResult.host_syncs``).

The Gram's products accumulate in b's dtype, as JAX's do. A float32 solve
is held to JAX's counts on the CPU only where the monomial basis is mildly
conditioned (s ≤ 4, no preconditioner): with the multigrid cycle B = M∘A
is close to the identity, the chains are nearly dependent, and both
packages' float32 counts follow their rounding (ROADMAP queue 3).

The loop is a generator of steps (``sstep_cg_steps``): each application
of A or M and each read is a request to its runner
(``solvers/requests.py``). ``sstep_cg`` drives it on its own;
``solvers/batched.py`` drives one per lane of a batched solve.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gmres_tpu_torch.ops.blas import as_plain, replicate_like, tree_vdot
from gmres_tpu_torch.solvers.cg import _in_dtype
from gmres_tpu_torch.solvers.gmres import _as_operator
from gmres_tpu_torch.solvers.requests import Apply, Read, run
from gmres_tpu_torch.types import Preconditioner, SolveResult, SolverStatus


def _shift_matrix(s: int, dtype: torch.dtype) -> torch.Tensor:
    """T: the coordinates of B·(V ĉ) for ĉ on the shiftable columns
    (p-degree < s, z-degree < s − 1)."""
    nb = 2 * s + 1
    t = torch.zeros((nb, nb), dtype=dtype)
    for i in range(s):
        t[i + 1, i] = 1.0                        # B·(Bⁱp) = Bⁱ⁺¹p
    for i in range(s - 1):
        t[s + 1 + i + 1, s + 1 + i] = 1.0        # B·(Bⁱz) = Bⁱ⁺¹z
    return t


def _recurrences(g: torch.Tensor, s: int, t_mat: torch.Tensor):
    """The s scalar CG steps on the cycle's Gram g (a CPU tensor in b's
    dtype): returns (x̂, p̂, ok), as JAX's ``inner`` scan (whose per-step
    residual estimates no caller reads, so they are not formed)."""
    nb = 2 * s + 1
    dtype = g.dtype
    g_rv = g[1: 1 + nb, 0]
    g_vu = g[1: 1 + nb, 1 + nb:]
    zero = torch.zeros((), dtype=dtype)
    one = torch.ones((), dtype=dtype)
    xh = torch.zeros(nb, dtype=dtype)
    zh = torch.zeros(nb, dtype=dtype)
    zh[s + 1] = 1.0
    ph = torch.zeros(nb, dtype=dtype)
    ph[0] = 1.0
    ok = True
    for _ in range(s):
        # r_j = r₀ − U x̂_j, so (r_j, z_j) = g_rv·ẑ − x̂ᵀ(UᵀV)ẑ.
        rz = (g_rv @ zh) - xh @ (g_vu.T @ zh)
        pap = ph @ (g_vu @ ph)
        bad = bool((pap <= 0) | ~torch.isfinite(pap) | ~torch.isfinite(rz))
        alpha = zero if bad else rz / torch.where(pap == 0, one, pap)
        xh = xh + alpha * ph
        zh = zh - alpha * (t_mat @ ph)
        rz2 = (g_rv @ zh) - xh @ (g_vu.T @ zh)
        beta = zero if (bad or bool(rz == 0)) else rz2 / rz
        ph = zh + beta * ph
        ok = ok and not bad
    return xh, ph, ok


def sstep_cg(
    A,
    b: torch.Tensor,
    *,
    s: int = 4,
    tol: float = 1e-9,
    max_cycles: int = 2500,
    M: Optional[Preconditioner] = None,
    x0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve A x = b (A SPD) by s-step PCG (the arguments of
    ``gmres_tpu.solvers.sstep_cg.sstep_cg``).

      s: inner steps per cycle (keep ≤ ~8; with the multigrid cycle s = 4
        loses nothing).
      tol: absolute ‖r‖₂ target, certified on the recomputed true residual
        at each cycle's end.
      max_cycles: outer cycle cap.
      M: SPD left preconditioner.
      x0: initial guess (zeros by default).

    ``iterations`` is cycles·s."""
    return run(sstep_cg_steps(A, b, s=s, tol=tol, max_cycles=max_cycles, M=M, x0=x0))


def sstep_cg_steps(A, b, *, s=4, tol=1e-9, max_cycles=2500, M=None, x0=None):
    """``sstep_cg``'s solve as steps (``solvers/requests.py``), returning
    its SolveResult."""
    op = _as_operator(A, b.device)

    def prec(v):
        return (yield Apply(M, v)) if M is not None else v

    if x0 is None:
        x0 = torch.zeros_like(b)
    dtype = b.dtype
    dev = b.device
    shape = b.shape
    nb = 2 * s + 1
    t_mat = _shift_matrix(s, dtype)
    tol = _in_dtype(tol, dtype)

    def cycle(x, r, z, p):
        # The chains: the A-image of each column is the intermediate of
        # the next B application. V = [p … Bˢp | z … Bˢ⁻¹z]; U's Bˢp slot
        # is zero (no coordinate vector U multiplies reaches p-degree s).
        cols, imgs = [], []
        w = p
        for _ in range(s):
            aw = yield Apply(op, w)
            cols.append(w)
            imgs.append(aw)
            w = yield from prec(aw)
        cols.append(w)
        imgs.append(torch.zeros_like(p))
        w = z
        for k in range(s):
            aw = yield Apply(op, w)
            cols.append(w)
            imgs.append(aw)
            if k < s - 1:
                w = yield from prec(aw)
        v_cols = torch.stack(cols)
        stacked = torch.cat([r.reshape(1, -1), v_cols.reshape(nb, -1),
                             torch.stack(imgs).reshape(nb, -1)])
        # One read: the (2nb+1)² Gram. g_vu is deliberately not
        # symmetrised (U's zero Bˢp slot makes VᵀU's mirror row nonzero).
        g_dev = as_plain(stacked @ stacked.T)
        g = torch.tensor((yield Read(g_dev.reshape(-1))), dtype=g_dev.dtype).reshape(
            g_dev.shape)
        xh, ph, ok = _recurrences(g, s, t_mat)
        coef = replicate_like(torch.stack([xh, ph]).to(dev), v_cols)
        x_new = x + torch.tensordot(coef[0], v_cols, dims=([0], [0])).reshape(shape)
        p_new = torch.tensordot(coef[1], v_cols, dims=([0], [0])).reshape(shape)
        return x_new, p_new, ok

    r = b - (yield Apply(op, x0))
    res = torch.sqrt(tree_vdot(r, r))
    res_f = yield Read(res)
    syncs = 1
    z = yield from prec(r)
    p = z
    status = int(SolverStatus.CONVERGED if res_f < tol else SolverStatus.MAX_ITERATIONS)
    history = []
    x, k = x0, 0
    while k < max_cycles and status == SolverStatus.MAX_ITERATIONS:
        x, p, ok = yield from cycle(x, r, z, p)
        # The certification pair: the cycle's one extra A and M.
        r = b - (yield Apply(op, x))
        res = torch.sqrt(tree_vdot(r, r))
        z = yield from prec(r)
        res_f = yield Read(res)
        syncs += 2
        history.append(res_f)
        if res_f < tol:
            status = int(SolverStatus.CONVERGED)
        elif not ok or not math.isfinite(res_f):
            status = int(SolverStatus.BREAKDOWN)
        k += 1
    hist = torch.tensor(history + [res_f] * (max_cycles - k), dtype=dtype, device=dev)
    return SolveResult(x=x, iterations=k * s, residual=res, status=status,
                       residual_history=hist, host_syncs=syncs)
