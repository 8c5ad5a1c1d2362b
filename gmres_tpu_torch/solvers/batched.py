"""Batched solves: the port's counterpart of ``jax.vmap`` over a solver.

gmres_tpu's solvers are pure functions of arrays, so ``jax.vmap(lambda b:
gt.cg(A, b, ...))(bs)`` solves many systems in one program: the
``while_loop`` runs while any lane runs, a lane that has stopped keeps its
state, and each application of A or M is one batched call for all lanes (a
Pallas kernel gains a leading grid axis). ``batched_solve(solver, A, bs)``
is that program here, for ``cg``, ``bicgstab`` and ``gmres``.

Each lane runs its solver's own steps (``solvers/requests.py``): the
operations of its sequential solve in the same order, so its iterations,
status and bits are its sequential solve's. The runner answers the lanes
together. The lanes waiting on the same operator (the same callable on
grids of one shape and dtype) get one ``torch.func.vmap`` application, so
each kernel on the operator's path launches once for all of them through
its vmap rule (K1 and its V-cycle forms, K2; K3 and K4 once a lane). When
no lane waits on an operator, every lane waiting on a read gets its value
from one host read: one read an iteration for the whole batch. A lane that
has stopped makes no more requests; the loop runs while any lane runs, so a
batched solve launches each kernel about as often as the sequential solve
of its longest lane (a lone lane's application is the plain call, single
launches). Lanes whose steps differ (GMRES between restarts, BiCGSTAB at a
residual replacement or its certifying matvec) wait on different
operators; the runner applies the largest group first, so the others
catch up, and each such step costs one more application. A lane's vector updates and reductions run on the
lane's own tensors (B launches of each where a sequential solve makes one):
batching them is ROADMAP work, and what keeps each lane's reductions those
of its sequential solve.

An operator family swept over lanes is ``A(v, *lane_args_i)``: each tensor
of ``lane_args`` has the lanes on its first axis and is split per lane under
``torch.func.vmap`` (per-lane coefficients reach K1 as a (lanes, 5)
array). M is one callable for every lane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gmres_tpu_torch.solvers.bicgstab import bicgstab, bicgstab_steps
from gmres_tpu_torch.solvers.cg import cg, cg_steps
from gmres_tpu_torch.solvers.gmres import gmres, gmres_steps
from gmres_tpu_torch.solvers.requests import Apply

_STEPS = {cg: cg_steps, bicgstab: bicgstab_steps, gmres: gmres_steps}


class _LaneOperator:
    """A or M as each lane's steps see it: the runner answers its requests
    with ``torch.func.vmap`` over the lanes that make them. Calling it
    directly is an error (a path of the solver that makes no request)."""

    def __init__(self, fn: Callable, lane_args: tuple):
        self.fn = fn
        self.lane_args = lane_args

    def __call__(self, v):
        raise RuntimeError("a batched solve's operator is applied by its runner "
                           "(solvers/batched.py), not called directly")

    def apply(self, vs: list, lanes: list) -> list:
        """fn on each of the vectors ``vs`` of ``lanes``: one
        ``torch.func.vmap`` application on their stack, or the plain call
        where one lane waits (the same bits, without vmap's host cost)."""
        if len(lanes) == 1:
            # A lane's vector may be a view of a batched output.
            return [self.fn(vs[0].contiguous(), *(a[lanes[0]] for a in self.lane_args))]
        block = torch.stack(vs)
        if not self.lane_args:
            return torch.func.vmap(self.fn)(block).unbind()
        idx = torch.tensor(lanes, device=self.lane_args[0].device)
        args = [a if len(lanes) == a.shape[0] else a.index_select(0, idx)
                for a in self.lane_args]
        return torch.func.vmap(self.fn)(block, *args).unbind()


def _read_together(ts: list) -> list:
    """Each of ``ts`` (0-d or 1-d) as ``t.tolist()`` gives it, from one host
    read of all of them (float64 holds each value exactly)."""
    if len(ts) == 1:
        return [ts[0].tolist()]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in ts]).tolist()
    out, k = [], 0
    for t in ts:
        vals = flat[k:k + t.numel()]
        k += t.numel()
        if t.dtype == torch.bool:
            vals = [v != 0.0 for v in vals]
        elif not t.dtype.is_floating_point:
            vals = [int(v) for v in vals]
        out.append(vals[0] if t.dim() == 0 else vals)
    return out


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

    solver: ``cg``, ``bicgstab`` or ``gmres`` (either variant, with
      ``inner_dtype`` and ``certify`` as ``gmres`` takes them); any other
      raises NotImplementedError (ROADMAP queue 1: batched solves for the
      other solvers).
    A, M: the single-lane callables of the solver, applied to the lanes
      through ``torch.func.vmap``; A is called as A(v, *lane_args_i).
    bs: the right-hand sides, (lanes, *grid).
    lane_args: tensors with the lanes on their first axis (an operator
      family swept over lanes).
    kw: the solver's own keywords, shared by the lanes (as a closure
      shares them under ``jax.vmap``).

    Returns the solver's result type with a leading lane axis on every
    per-solve field (x, iterations, residual, status, the history, and
    GMRES's restarts and v_err); ``host_syncs`` counts the batch's host
    reads.
    """
    steps = _STEPS.get(solver)
    if steps is None:
        raise NotImplementedError(
            f"batched_solve takes cg, bicgstab and gmres, not "
            f"{getattr(solver, '__name__', solver)!r} (ROADMAP queue 1: batched "
            "solves for the other solvers)")
    if not callable(A) or (M is not None and not callable(M)):
        raise TypeError("batched_solve: A and M must be callables on one lane")
    n = bs.shape[0]
    lane_args = tuple(torch.as_tensor(a) for a in lane_args)
    for a in lane_args:
        if a.dim() == 0 or a.shape[0] != n:
            raise ValueError(f"batched_solve: each lane argument needs {n} lanes "
                             f"on its first axis, got shape {tuple(a.shape)}")
    a_lanes = _LaneOperator(A, lane_args)
    m_lanes = _LaneOperator(M, ()) if M is not None else None
    gens = [steps(a_lanes, bs[i], M=m_lanes, **kw) for i in range(n)]
    pending, results = [None] * n, [None] * n

    def advance(i, answer=None, first=False):
        try:
            pending[i] = next(gens[i]) if first else gens[i].send(answer)
        except StopIteration as done:
            pending[i], results[i] = None, done.value

    for i in range(n):
        advance(i, first=True)
    reads = 0
    while any(p is not None for p in pending):
        groups: dict = {}
        for i, req in enumerate(pending):
            if isinstance(req, Apply):
                key = (id(req.fn), req.v.dtype, tuple(req.v.shape), req.v.device)
                groups.setdefault(key, []).append(i)
        if groups:
            # The operator most lanes wait on (the first lane's, on a tie).
            lanes = max(groups.values(), key=len)
            outs = pending[lanes[0]].fn.apply([pending[i].v for i in lanes], lanes)
            for i, out in zip(lanes, outs):
                advance(i, out)
            continue
        waiting = [i for i, p in enumerate(pending) if p is not None]
        reads += 1
        for i, value in zip(waiting, _read_together([pending[i].t for i in waiting])):
            advance(i, value)
    return _stack_results(results, reads, bs.device)
