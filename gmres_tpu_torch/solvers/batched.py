"""Batched solves: the port's counterpart of ``jax.vmap`` over a solver.

gmres_tpu's solvers are pure functions of arrays, so ``jax.vmap(lambda b:
gt.cg(A, b, ...))(bs)`` solves many systems in one program: the
``while_loop`` runs while any lane runs, a lane that has stopped keeps its
state, and each application of A or M is one batched call for all lanes (a
Pallas kernel gains a leading grid axis). ``batched_solve(solver, A, bs)``
is that program here, for every solver of gmres_tpu's that ``jax.vmap``
takes (``_STEPS``): the linear solvers cg, bicgstab, gmres, minres, cgs,
tfqmr, bicgstabl, idrs, chebyshev_solve, sstep_cg, fgmres, lgmres,
sstep_gmres, qmr, lsqr, lsmr, gmres_dr, gcrodr, block_cg and block_gmres;
newton_krylov (with its gmres, fgmres or gcrodr inner); the eigensolvers
lobpcg, arnoldi_eigs and lanczos_bounds; the matrix functions
funm_lanczos, expm_multiply and trace_funm; and the time steppers
theta_evolve and exponential_evolve. arnoldi_eigs_real and subspace_eigs
take host numpy steps inside their loop, which ``jax.vmap`` cannot trace
either: they raise NotImplementedError.

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

The spectral solvers take as bs their second positional argument with
the lanes on axis 0: lobpcg's X0 (lanes, k, *grid), as the block solvers
do (its A, M and B block applications one nested vmap each; its SVQB
Grams, Rayleigh–Ritz matrices and decisions one read for the waiting
lanes, each eigh on the lane's own copy); arnoldi_eigs' and
lanczos_bounds' probe (a real A's two applications a complex matvec
each one vmapped launch; each cycle's Rayleigh blocks one read, each
lane's Schur form its own; lanczos_bounds returns a tuple of two (lanes,)
tensors); funm_lanczos's and expm_multiply's b (each factorization's
Hessenbergs one read); trace_funm's x_like (every lane the same probes
from ``key``, the lanes × probes factorizations one lane each of the
runner, each probe with its lane's arguments: one application an Arnoldi
step for all of them); theta_evolve's and exponential_evolve's u0 (the
shifted operator I + θΔt·L ``requests.derived`` from the lanes' A, each
step's solve the lane's own steps and recycle block, so a lane's next
step does not wait on the slowest lane's solve). f, t, key, forcing,
explicit, M and B are shared by the lanes, as a closure shares them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gmres_tpu_torch.solvers.arnoldi import arnoldi_eigs, arnoldi_eigs_steps
from gmres_tpu_torch.solvers.bicgstab import bicgstab, bicgstab_steps
from gmres_tpu_torch.solvers.bicgstabl import bicgstabl, bicgstabl_steps
from gmres_tpu_torch.solvers.block_cg import block_cg, block_cg_steps
from gmres_tpu_torch.solvers.block_gmres import block_gmres, block_gmres_steps
from gmres_tpu_torch.solvers.cg import cg, cg_steps
from gmres_tpu_torch.solvers.cgs import cgs, cgs_steps
from gmres_tpu_torch.solvers.chebyshev import chebyshev_solve, chebyshev_solve_steps
from gmres_tpu_torch.solvers.evolve import (
    exponential_evolve,
    exponential_evolve_steps,
    theta_evolve,
    theta_evolve_steps,
)
from gmres_tpu_torch.solvers.fgmres import fgmres, fgmres_steps
from gmres_tpu_torch.solvers.funm import (
    expm_multiply,
    expm_multiply_steps,
    funm_lanczos,
    funm_lanczos_steps,
    trace_funm,
    trace_funm_lanes,
)
from gmres_tpu_torch.solvers.gcrodr import gcrodr, gcrodr_steps
from gmres_tpu_torch.solvers.gmres import gmres, gmres_steps
from gmres_tpu_torch.solvers.gmres_dr import gmres_dr, gmres_dr_steps
from gmres_tpu_torch.solvers.idrs import idrs, idrs_steps
from gmres_tpu_torch.solvers.krylov_schur_real import arnoldi_eigs_real
from gmres_tpu_torch.solvers.lanczos import lanczos_bounds, lanczos_bounds_steps
from gmres_tpu_torch.solvers.lgmres import lgmres, lgmres_steps
from gmres_tpu_torch.solvers.lobpcg import lobpcg, lobpcg_steps
from gmres_tpu_torch.solvers.lsmr import lsmr, lsmr_steps
from gmres_tpu_torch.solvers.lsqr import lsqr, lsqr_steps
from gmres_tpu_torch.solvers.minres import minres, minres_steps
from gmres_tpu_torch.solvers.newton_krylov import newton_krylov, newton_krylov_steps
from gmres_tpu_torch.solvers.qmr import qmr, qmr_steps
from gmres_tpu_torch.solvers.requests import LaneOperator, run_lanes
from gmres_tpu_torch.solvers.sstep import sstep_gmres, sstep_gmres_steps
from gmres_tpu_torch.solvers.sstep_cg import sstep_cg, sstep_cg_steps
from gmres_tpu_torch.solvers.subspace_eigs import subspace_eigs
from gmres_tpu_torch.solvers.tfqmr import tfqmr, tfqmr_steps

_STEPS = {cg: cg_steps, bicgstab: bicgstab_steps, gmres: gmres_steps,
          minres: minres_steps, cgs: cgs_steps, tfqmr: tfqmr_steps,
          bicgstabl: bicgstabl_steps, idrs: idrs_steps,
          chebyshev_solve: chebyshev_solve_steps, sstep_cg: sstep_cg_steps,
          fgmres: fgmres_steps, lgmres: lgmres_steps, sstep_gmres: sstep_gmres_steps,
          newton_krylov: newton_krylov_steps, qmr: qmr_steps, lsqr: lsqr_steps,
          lsmr: lsmr_steps, gmres_dr: gmres_dr_steps, gcrodr: gcrodr_steps,
          block_cg: block_cg_steps, block_gmres: block_gmres_steps,
          lobpcg: lobpcg_steps, arnoldi_eigs: arnoldi_eigs_steps,
          lanczos_bounds: lanczos_bounds_steps, funm_lanczos: funm_lanczos_steps,
          expm_multiply: expm_multiply_steps, theta_evolve: theta_evolve_steps,
          exponential_evolve: exponential_evolve_steps}

# The caller's single-lane operators besides A and M, vmapped as M is.
_LANE_OPERATOR_KEYWORDS = ("AT", "MT", "AH", "B")

# Solvers whose loop takes host numpy steps: gmres_tpu's jax.vmap cannot
# trace them, and batched_solve does not take them.
_HOST_LOOPS = (arnoldi_eigs_real, subspace_eigs)


def _stack_results(results: list, reads: int, device):
    """The lanes' results as one result of their type, with a leading lane
    axis on every per-solve field; ``host_syncs`` the batch's reads."""
    if isinstance(results[0], tuple):  # lanczos_bounds' (lo, hi)
        return tuple(torch.stack(col) for col in zip(*results))
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


def batched_solve(solver: Callable, A: Callable, bs: torch.Tensor, /, *,
                  lane_args: tuple = (), M: Optional[Callable] = None, **kw):
    """Solve A x = bs[i] for every lane i with ``solver`` (JAX's
    ``jax.vmap(lambda b: solver(A, b, M=M, **kw))(bs)``).

    solver: one of ``_STEPS`` or trace_funm (module docstring), with the
      keywords its sequential call takes (f as a keyword for funm_lanczos
      and trace_funm); arnoldi_eigs_real and subspace_eigs raise
      NotImplementedError (their host numpy steps defeat gmres_tpu's
      ``jax.vmap`` too), as does anything else.
    A, M: the single-lane callables of the solver, applied to the lanes
      through ``torch.func.vmap``; A is called as A(v, *lane_args_i)
      (newton_krylov's residual F as F(u, *lane_args_i)). The keywords
      AT, MT (qmr), AH (lsqr, lsmr) and B (lobpcg) are single-lane
      callables too, as is theta_evolve's explicit.
    bs: the right-hand sides, (lanes, *grid) (newton_krylov's x0s;
      (lanes, s, *grid) for block_cg and block_gmres; the solver's second
      positional argument for the spectral solvers: lobpcg's X0s
      (lanes, k, *grid), the probes, b, x_like or u0).
    lane_args: tensors with the lanes on their first axis (an operator
      family swept over lanes).
    kw: the solver's own keywords, shared by the lanes (as a closure
      shares them under ``jax.vmap``); the first three arguments are
      positional only, so theta_evolve's ``solver`` is one of them.

    Returns the solver's result type with a leading lane axis on every
    per-solve field (x, iterations, residual, status, the history, the
    GMRES family's restarts and v_err, Newton's inner iterations and J·v
    products, eigenpairs, f(A)·b, SLQ samples, trajectories);
    ``host_syncs`` counts the batch's host reads. lanczos_bounds gives its
    (lo, hi) as two (lanes,) tensors.
    """
    name = getattr(solver, "__name__", solver)
    if solver in _HOST_LOOPS:
        raise NotImplementedError(
            f"batched_solve does not take {name!r}: its loop takes host numpy steps, "
            "which gmres_tpu's jax.vmap cannot trace either (ROADMAP queue 1, item 11)")
    steps = _STEPS.get(solver)
    if steps is None and solver is not trace_funm:
        raise NotImplementedError(
            f"batched_solve does not take {name!r}: it is not one of gmres_tpu's "
            "solvers that jax.vmap takes (the port's counterpart of gmres_tpu's "
            "jax.vmap over a solver; ROADMAP queue 1, item 11)")
    ops = {"M": M, **{k: kw[k] for k in _LANE_OPERATOR_KEYWORDS if kw.get(k) is not None}}
    if not callable(A) or not all(callable(f) for f in ops.values() if f is not None):
        raise TypeError("batched_solve: A, M, AT, MT, AH and B must be callables on "
                        "one lane")
    n = bs.shape[0]
    lane_args = tuple(torch.as_tensor(a) for a in lane_args)
    for a in lane_args:
        if a.dim() == 0 or a.shape[0] != n:
            raise ValueError(f"batched_solve: each lane argument needs {n} lanes "
                             f"on its first axis, got shape {tuple(a.shape)}")
    if solver is trace_funm:
        return _stack_results(trace_funm_lanes(A, kw.pop("f"), bs, lane_args=lane_args,
                                               **kw), 1, bs.device)
    a_lanes = LaneOperator(A, lane_args)
    kw.update({k: LaneOperator(f) for k, f in ops.items() if f is not None})
    results, reads = run_lanes([steps(a_lanes, bs[i], **kw) for i in range(n)])
    return _stack_results(results, reads, bs.device)
