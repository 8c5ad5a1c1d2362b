"""What a solver's loop asks of its runner: operator applications and host
reads.

The solvers a batched solve takes (``solvers/batched.py:batched_solve``)
are written as generators of steps. Each application of A or M is a
request ``Apply(fn, v, args)`` that the runner answers with fn(v, *args),
and each read of a device value that decides the loop is a request
``Read(t)`` that it answers with ``t.tolist()``; everything else the solver
computes itself. ``args`` are a lane's own operands of a shared function
(Newton–Krylov's J·v at the lane's linearisation point); ``At(fn, *args)``
is such an operator as a one-argument callable, for the steps of a solver
that applies its A as A(v).

``run`` is the runner of one solve: it answers each request at once, so a
solve runs as the plain loop it replaces, with the same operations in the
same order. ``run_lanes`` drives one generator per lane and answers the
lanes' requests together: one ``torch.func.vmap`` application for the
lanes that ask for the same operator (``LaneOperator``), one host read for
the lanes that wait on a read.

Operators made from the solve's A and M keep the lanes together:
``transposed(A, like)`` is Aᵀ (the pullback of ``torch.func.vjp``; for a
LaneOperator one pullback of the vmapped operator for the lanes that ask
together, ``LaneTranspose``), ``composed(M, A)`` is M∘A (taking a block
of rows of a sharded grid whole where both do, ``ops/blas.py:row_blocks``),
and ``rows(A)`` is A on each row of a block (``ops/blas.py:row_apply``; for a
LaneOperator one nested vmap, so a block of every lane's rows is one
launch a kernel). ``capture_steps(call)`` takes the steps of the solve that
a function of a solver starts (``run`` hands them out instead of running
them), which is how ``implicit_solve``'s vmap rule batches a solver given
as a function.
"""

from __future__ import annotations

import threading
from typing import Callable, Generator, NamedTuple

import torch

from gmres_tpu_torch.ops.blas import is_dtensor, row_apply, row_blocks


class Apply(NamedTuple):
    """The request fn(v, *args): an application of the solve's A or M, or
    of a function of them (``derived``) at the lane's operands ``args``."""

    fn: Callable
    v: torch.Tensor
    args: tuple = ()


class Read(NamedTuple):
    """The request t.tolist(): a device value the loop decides on."""

    t: torch.Tensor


class At:
    """fn(·, *args) as a one-argument operator: fn shared by the lanes of a
    batched solve, ``args`` this lane's operands. A runner answers
    ``Apply(At(fn, *args), v)`` as ``Apply(fn, v, args)`` and counts it in
    ``calls``."""

    def __init__(self, fn: Callable, *args):
        self.fn, self.args, self.calls = fn, args, 0
        self.counted = self

    def __call__(self, v):
        self.counted.calls += 1
        return self.fn(v, *self.args)


def _unfold(req: Apply):
    """(fn, v, args) of an application, an ``At`` operator unfolded."""
    if isinstance(req.fn, At):
        return req.fn.fn, req.v, req.fn.args + req.args
    return req.fn, req.v, req.args


def _resolved(req: Apply):
    """``_unfold`` of a request being answered (counted in its ``At``)."""
    if isinstance(req.fn, At):
        req.fn.counted.calls += 1
    return _unfold(req)


def _key(fn, v, args) -> tuple:
    """What lanes share to take one application together."""
    return (id(fn), v.dtype, tuple(v.shape), v.device,
            tuple((a.dtype, tuple(a.shape)) for a in args))


_capture = threading.local()


class _Captured(Exception):
    """Raised by ``run`` while ``capture_steps`` waits: the steps it was
    handed, not run."""

    def __init__(self, steps):
        super().__init__("steps captured")
        self.steps = steps


def capture_steps(call: Callable):
    """The steps of the first solve that ``call()`` starts through ``run``
    (every entry point of a solver that is a generator of steps), not run;
    None where ``call`` returns before it starts one, or calls a
    LaneOperator itself (``DirectCall``)."""
    _capture.on = True
    try:
        call()
    except _Captured as got:
        return got.steps
    except DirectCall:
        return None
    finally:
        _capture.on = False
    return None


def read_host(t: torch.Tensor):
    """Steps of one ``Read``: a float64 (complex128 for a complex ``t``)
    CPU copy of ``t``, the values of ``t.detach().to("cpu", float64)``
    (float64 holds each value exactly). A steps function's host
    eigensolve runs on it, so in a batched solve each lane's small matrix
    comes back in the one read of the lanes that wait together."""
    real = torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
    vals = yield Read(real.detach().reshape(-1).to(torch.float64))
    host = torch.tensor(vals, dtype=torch.float64).reshape(real.shape)
    return torch.view_as_complex(host) if t.is_complex() else host


def run(steps: Generator):
    """Drive one solve's steps, answering each request as it comes; returns
    the solve's result (or, while ``capture_steps`` waits, hands the steps
    to it)."""
    if getattr(_capture, "on", False):
        _capture.on = False
        raise _Captured(steps)
    try:
        req = next(steps)
        while True:
            if isinstance(req, Apply):
                fn, v, args = _resolved(req)
                ans = fn(v, *args)
            else:
                ans = req.t.tolist()
            req = steps.send(ans)
    except StopIteration as done:
        return done.value


def derived(fn: Callable, key, make: Callable, lanes: bool = True) -> Callable:
    """``make(fn)``: an operator built from the solve's A (J·v of a residual
    F, a polynomial in A). For a batched solve's ``LaneOperator`` it is one
    LaneOperator per (fn, key), shared by the lanes so that their requests
    group, which keeps fn's lane arguments where ``lanes`` (make(fn) is
    then called as make(fn)(v, *args, *lane_args_i)); a plain fn gets
    make(fn) itself."""
    derive = getattr(fn, "derive", None)
    return derive(key, make, lanes) if derive is not None else make(fn)


def derived_transpose(op, like: torch.Tensor):
    """The transpose u ↦ opᵀ u of a linear operator, as the pullback of
    ``torch.func.vjp`` of op at ``like`` (one application of op now; one
    backward pass a call). For a complex operator the pullback is already
    the adjoint opᴴ (PyTorch's convention for complex cotangents), which
    gmres_tpu builds as conj ∘ linear_transpose ∘ conj."""
    _, pullback = torch.func.vjp(op, like)

    def apply_t(u: torch.Tensor) -> torch.Tensor:
        (out,) = pullback(u)
        return out

    return apply_t


def transposed(fn: Callable, like: torch.Tensor) -> Callable:
    """fnᵀ for a solve's steps: ``derived_transpose(fn, like)`` for a plain
    operator; for a batched solve's LaneOperator, its ``LaneTranspose`` at
    this lane's ``like`` (an ``At``), so the lanes that ask together get one
    pullback."""
    if isinstance(fn, LaneOperator):
        return At(fn.transpose(), like)
    return derived_transpose(fn, like)


def composed(outer: Callable, inner: Callable) -> Callable:
    """outer∘inner (QMR's M∘A) for a solve's steps: one LaneOperator of the
    composition, with inner's lane arguments, where inner is one."""
    if isinstance(inner, LaneOperator):
        out = outer.fn if isinstance(outer, LaneOperator) else outer
        return inner.derive(("then", id(outer)),
                            lambda f: row_blocks(lambda v, *a: out(f(v, *a)), out, f))
    return row_blocks(lambda v: outer(inner(v)), outer, inner)


def _rows_fn(fn: Callable) -> Callable:
    def on_rows(block, *args):
        return row_apply(row_blocks(lambda v: fn(v, *args), fn), block)

    return on_rows


def rows(fn: Callable) -> Callable:
    """fn on each row of a (k, *shape) block (``row_apply``), for a solve's
    steps: ``Apply(rows(A), block)``. A LaneOperator's is one LaneOperator
    (a nested ``torch.func.vmap`` over the lanes' blocks); an ``At``'s
    keeps its operands, shared by the rows, and counts in its ``calls`` (one
    call a block, as ``row_apply`` calls it once)."""
    if isinstance(fn, LaneOperator):
        return fn.derive("rows", _rows_fn)
    if isinstance(fn, At):
        out = At(rows(fn.fn), *fn.args)
        out.counted = fn.counted
        return out
    return _rows_fn(fn)


class DirectCall(RuntimeError):
    """A LaneOperator called directly: the code that called it is not steps
    (a path of a solver that makes no request, or a solver function of the
    caller's own)."""


class LaneOperator:
    """A or M as each lane's steps see it: the runner answers its requests
    with ``torch.func.vmap`` over the lanes that make them. Calling it
    directly is an error (a path of the solver that makes no request).
    fn is called as fn(v, *args, *lane_args_i): ``args`` the request's own
    operands, ``lane_args`` tensors with the lanes on their first axis."""

    def __init__(self, fn: Callable, lane_args: tuple = ()):
        self.fn = fn
        self.lane_args = lane_args
        self._derived: dict = {}

    def __call__(self, *args):
        raise DirectCall("a batched solve's operator is applied by its runner "
                         "(solvers/requests.py:run_lanes), not called directly")

    def derive(self, key, make: Callable, lanes: bool = True) -> "LaneOperator":
        op = self._derived.get(key)
        if op is None:
            op = self._derived[key] = LaneOperator(make(self.fn),
                                                   self.lane_args if lanes else ())
        return op

    def transpose(self) -> "LaneTranspose":
        op = self._derived.get("T")
        if op is None:
            op = self._derived["T"] = LaneTranspose(self)
        return op

    def lane_blocks(self, lanes: list) -> list:
        """The lane arguments of ``lanes``, lanes first."""
        if not self.lane_args:
            return []
        idx = torch.tensor(lanes, device=self.lane_args[0].device)
        return [a if len(lanes) == a.shape[0] else a.index_select(0, idx)
                for a in self.lane_args]

    def apply(self, vs: list, argss: list, lanes: list) -> list:
        """fn on each of the vectors ``vs`` (with each lane's operands
        ``argss``) of ``lanes``: one ``torch.func.vmap`` application on
        their stacks, or the plain call where one lane waits (the same
        bits, without vmap's host cost). Row-sharded vectors (DTensors) with
        no operands of their own stack into a sharded block of rows for one
        ``row_apply``, which a halo-route fn takes whole (its block form)
        and any other fn one row at a time."""
        if len(lanes) == 1:
            # A lane's vector may be a view of a batched output.
            return [self.fn(vs[0].contiguous(), *(a.contiguous() for a in argss[0]),
                            *(a[lanes[0]] for a in self.lane_args))]
        blocks = [torch.stack(vs)] + [torch.stack(col) for col in zip(*argss)]
        if is_dtensor(blocks[0]) and len(blocks) == 1 and not self.lane_args:
            return row_apply(self.fn, blocks[0]).unbind()
        return torch.func.vmap(self.fn)(*blocks, *self.lane_blocks(lanes)).unbind()


class LaneTranspose(LaneOperator):
    """The transpose of a LaneOperator, applied by ``run_lanes``: a request
    ``Apply(At(T, like), u)`` (``transposed``) is uᵀ·A at the lane's
    ``like``. The lanes that ask together get one pullback of
    ``torch.func.vjp`` of the vmapped operator at their stacked ``like``s,
    built once for that set of lanes and applied to each request (on a
    stencil one K1 launch with each lane's mirrored coefficients); a lone
    lane gets its sequential solve's ``derived_transpose``."""

    def __init__(self, base: LaneOperator):
        super().__init__(base.fn, base.lane_args)
        self._pullbacks: dict = {}

    def apply(self, vs: list, argss: list, lanes: list) -> list:
        likes = [a[0] for a in argss]
        key = tuple(lanes) + tuple(map(id, likes))
        hit = self._pullbacks.get(key)
        if hit is None:
            if len(lanes) == 1:
                own = [a[lanes[0]] for a in self.lane_args]
                pullback = derived_transpose(lambda v: self.fn(v, *own), likes[0])
            else:
                blocks = self.lane_blocks(lanes)
                pullback = derived_transpose(
                    lambda vb: torch.func.vmap(self.fn)(vb, *blocks), torch.stack(likes))
            # The likes are kept so that their ids stay theirs.
            hit = self._pullbacks[key] = (likes, pullback)
        if len(lanes) == 1:
            return [hit[1](vs[0].contiguous())]
        return hit[1](torch.stack(vs)).unbind()


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


def run_lanes(gens: list):
    """Drive one generator of steps a lane (their A and M ``LaneOperator``s)
    and answer the lanes together; returns (the lanes' results, the host
    reads made).

    The lanes waiting on the same operator (the same LaneOperator on
    vectors and operands of one shape and dtype) get one application; the
    operator most lanes wait on goes first (the first lane's, on a tie), so
    lanes that took another step catch up. When no lane waits on an
    operator, every lane waiting on a read gets its value from one host
    read. A lane that has stopped makes no more requests."""
    n = len(gens)
    pending, results = [None] * n, [None] * n

    def advance(i, answer=None, first=False):
        try:
            pending[i] = next(gens[i]) if first else gens[i].send(answer)
        except StopIteration as done:
            pending[i], results[i] = None, done.value

    for i in range(n):
        advance(i, first=True)
    reads = 0
    plain: dict = {}
    while any(p is not None for p in pending):
        groups: dict = {}
        for i, req in enumerate(pending):
            if isinstance(req, Apply):
                groups.setdefault(_key(*_unfold(req)), []).append(i)
        if groups:
            lanes = max(groups.values(), key=len)
            taken = [_resolved(pending[i]) for i in lanes]
            fn = taken[0][0]
            if not isinstance(fn, LaneOperator):
                # A callable the caller shares by closure (a solver
                # function's own M): vmapped over the lanes like M.
                if id(fn) not in plain:
                    plain[id(fn)] = (fn, LaneOperator(fn))
                fn = plain[id(fn)][1]
            outs = fn.apply([t[1] for t in taken], [t[2] for t in taken], lanes)
            for i, out in zip(lanes, outs):
                advance(i, out)
            continue
        waiting = [i for i, p in enumerate(pending) if p is not None]
        reads += 1
        for i, value in zip(waiting, _read_together([pending[i].t for i in waiting])):
            advance(i, value)
    return results, reads
