"""Batched solves: the port's counterpart of ``jax.vmap`` over a solver.

gmres_tpu's solvers are pure functions of arrays, so ``jax.vmap(lambda b:
gt.cg(A, b, ...))(bs)`` solves many systems in one program: the
``while_loop`` runs while any lane runs, a lane that has stopped keeps its
state, and each application of A or M is one batched call for all lanes (a
Pallas kernel gains a leading grid axis). ``batched_solve(solver, A, bs)``
is that program here, for every solver of gmres_tpu's that ``jax.vmap``
takes (``_STEPS``): cg, bicgstab, gmres, minres, cgs, tfqmr, bicgstabl,
idrs, chebyshev_solve, sstep_cg, fgmres, lgmres, sstep_gmres, qmr, lsqr,
lsmr, gmres_dr, gcrodr, block_cg, block_gmres and newton_krylov (with its
gmres, fgmres or gcrodr inner).

Each lane runs its solver's own steps (``solvers/requests.py``): the
operations of its sequential solve in the same order, so its iterations,
status and bits are its sequential solve's. The runner
(``requests.run_lanes``) answers the lanes together. The lanes waiting on
the same operator (the same callable on grids of one shape and dtype) get
one ``torch.func.vmap`` application, so each kernel on the operator's path
launches once for all of them through its vmap rule (K1 and its V-cycle
forms, K2, K3 and K4). When no lane waits on an operator, every lane
waiting on a read gets its value from one host read: one read an
iteration for the whole batch. A lane that has stopped makes no more
requests; the loop runs while any lane runs, so a batched solve launches
each kernel about as often as the sequential solve of its longest lane (a
lone lane's application is the plain call, single launches). Lanes whose
steps differ (GMRES between restarts, BiCGSTAB at a residual replacement
or its certifying matvec) wait on different operators; the runner applies
the largest group first, so the others catch up, and each such step costs
one more application. A lane's vector updates and reductions run on the
lane's own tensors (B launches of each where a sequential solve makes
one): batching them is ROADMAP work, and what keeps each lane's reductions
those of its sequential solve.

An operator family swept over lanes is ``A(v, *lane_args_i)``: each tensor
of ``lane_args`` has the lanes on its first axis and is split per lane under
``torch.func.vmap`` (per-lane coefficients reach K1 as a (lanes, 5)
array). M is one callable for every lane. For ``newton_krylov`` A is the
residual F, called as F(u, *lane_args_i), and bs the lanes' starting
points; J·v at each lane's own linearisation point is one
``torch.func.vmap`` of ``torch.func.jvp`` over the lanes that ask for it.

The solvers that apply a transpose (qmr, lsqr, lsmr) ask for it through
``requests.transposed``: the lanes that wait on the transpose of one
operator get one pullback of ``torch.func.vjp`` of the vmapped operator
(on a stencil one K1 launch, each lane's coefficients mirrored). The
caller's ``AT``, ``MT`` and ``AH`` are single-lane callables, vmapped as M
is. gmres_dr and gcrodr read each cycle's small state for every waiting
lane at once, and each lane's eigensolve runs on its own host copy, as in
its sequential solve; gcrodr's recycle block is each lane's own (as is
newton_krylov's with the gcrodr inner). block_cg and block_gmres take
bs as (lanes, s, *grid), each lane a block: a block application of every
lane is one nested ``torch.func.vmap``, one launch a kernel for the
lanes' s rows (``ops/_cuda.py:through_lanes``); each lane's SVQB
``eigh`` runs as in its sequential solve.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gmres_tpu_torch.solvers.bicgstab import bicgstab, bicgstab_steps
from gmres_tpu_torch.solvers.bicgstabl import bicgstabl, bicgstabl_steps
from gmres_tpu_torch.solvers.block_cg import block_cg, block_cg_steps
from gmres_tpu_torch.solvers.block_gmres import block_gmres, block_gmres_steps
from gmres_tpu_torch.solvers.cg import cg, cg_steps
from gmres_tpu_torch.solvers.cgs import cgs, cgs_steps
from gmres_tpu_torch.solvers.chebyshev import chebyshev_solve, chebyshev_solve_steps
from gmres_tpu_torch.solvers.fgmres import fgmres, fgmres_steps
from gmres_tpu_torch.solvers.gcrodr import gcrodr, gcrodr_steps
from gmres_tpu_torch.solvers.gmres import gmres, gmres_steps
from gmres_tpu_torch.solvers.gmres_dr import gmres_dr, gmres_dr_steps
from gmres_tpu_torch.solvers.idrs import idrs, idrs_steps
from gmres_tpu_torch.solvers.lgmres import lgmres, lgmres_steps
from gmres_tpu_torch.solvers.lsmr import lsmr, lsmr_steps
from gmres_tpu_torch.solvers.lsqr import lsqr, lsqr_steps
from gmres_tpu_torch.solvers.minres import minres, minres_steps
from gmres_tpu_torch.solvers.newton_krylov import newton_krylov, newton_krylov_steps
from gmres_tpu_torch.solvers.qmr import qmr, qmr_steps
from gmres_tpu_torch.solvers.requests import LaneOperator, run_lanes
from gmres_tpu_torch.solvers.sstep import sstep_gmres, sstep_gmres_steps
from gmres_tpu_torch.solvers.sstep_cg import sstep_cg, sstep_cg_steps
from gmres_tpu_torch.solvers.tfqmr import tfqmr, tfqmr_steps

_STEPS = {cg: cg_steps, bicgstab: bicgstab_steps, gmres: gmres_steps,
          minres: minres_steps, cgs: cgs_steps, tfqmr: tfqmr_steps,
          bicgstabl: bicgstabl_steps, idrs: idrs_steps,
          chebyshev_solve: chebyshev_solve_steps, sstep_cg: sstep_cg_steps,
          fgmres: fgmres_steps, lgmres: lgmres_steps, sstep_gmres: sstep_gmres_steps,
          newton_krylov: newton_krylov_steps, qmr: qmr_steps, lsqr: lsqr_steps,
          lsmr: lsmr_steps, gmres_dr: gmres_dr_steps, gcrodr: gcrodr_steps,
          block_cg: block_cg_steps, block_gmres: block_gmres_steps}

# The caller's single-lane operators besides A and M, vmapped as M is.
_LANE_OPERATOR_KEYWORDS = ("AT", "MT", "AH")


def _stack_results(results: list, reads: int, device):
    """The lanes' results as one result of their type, with a leading lane
    axis on every per-solve field; ``host_syncs`` the batch's reads."""
    fields = {}
    for f in dataclasses.fields(results[0]):
        vals = [getattr(r, f.name) for r in results]
        if f.name == "host_syncs":
            fields[f.name] = reads
        elif isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        else:
            fields[f.name] = torch.tensor([int(v) for v in vals], device=device)
    return type(results[0])(**fields)


def batched_solve(solver: Callable, A: Callable, bs: torch.Tensor, *,
                  lane_args: tuple = (), M: Optional[Callable] = None, **kw):
    """Solve A x = bs[i] for every lane i with ``solver`` (JAX's
    ``jax.vmap(lambda b: solver(A, b, M=M, **kw))(bs)``).

    solver: one of ``_STEPS`` (module docstring), with the keywords its
      sequential call takes; anything else raises NotImplementedError (it
      is not one of gmres_tpu's solvers that ``jax.vmap`` takes: the
      eigensolvers, matrix functions and time steppers have their own
      entry points).
    A, M: the single-lane callables of the solver, applied to the lanes
      through ``torch.func.vmap``; A is called as A(v, *lane_args_i)
      (newton_krylov's residual F as F(u, *lane_args_i)). The keywords
      AT, MT (qmr) and AH (lsqr, lsmr) are single-lane callables too.
    bs: the right-hand sides, (lanes, *grid) (newton_krylov's x0s;
      (lanes, s, *grid) for block_cg and block_gmres).
    lane_args: tensors with the lanes on their first axis (an operator
      family swept over lanes).
    kw: the solver's own keywords, shared by the lanes (as a closure
      shares them under ``jax.vmap``).

    Returns the solver's result type with a leading lane axis on every
    per-solve field (x, iterations, residual, status, the history, the
    GMRES family's restarts and v_err, Newton's inner iterations and J·v
    products); ``host_syncs`` counts the batch's host reads.
    """
    steps = _STEPS.get(solver)
    if steps is None:
        raise NotImplementedError(
            f"batched_solve does not take {getattr(solver, '__name__', solver)!r}: it "
            "is not one of the linear or Newton solvers (the port's counterpart of "
            "gmres_tpu's jax.vmap over a solver; ROADMAP queue 1, item 11)")
    ops = {"M": M, **{k: kw[k] for k in _LANE_OPERATOR_KEYWORDS if kw.get(k) is not None}}
    if not callable(A) or not all(callable(f) for f in ops.values() if f is not None):
        raise TypeError("batched_solve: A, M, AT, MT and AH must be callables on one "
                        "lane")
    n = bs.shape[0]
    lane_args = tuple(torch.as_tensor(a) for a in lane_args)
    for a in lane_args:
        if a.dim() == 0 or a.shape[0] != n:
            raise ValueError(f"batched_solve: each lane argument needs {n} lanes "
                             f"on its first axis, got shape {tuple(a.shape)}")
    a_lanes = LaneOperator(A, lane_args)
    kw.update({k: LaneOperator(f) for k, f in ops.items() if f is not None})
    results, reads = run_lanes([steps(a_lanes, bs[i], **kw) for i in range(n)])
    return _stack_results(results, reads, bs.device)
