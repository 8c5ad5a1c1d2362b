"""Implicit differentiation through linear solves (the adjoint method).

Counterpart of ``gmres_tpu/solvers/implicit.py``: ``implicit_solve`` makes
the solution of A(θ)·x = b a differentiable function of θ and b, with the
gradients of the implicit function theorem rather than of the iteration:

    x(θ, b) = A(θ)⁻¹ b
    ∂L/∂b  = y          where  A(θ)ᵀ y = ∂L/∂x   (one adjoint solve)
    ∂L/∂θ  = −yᵀ (∂A/∂θ) x                         (a vjp of θ ↦ A(θ)x)

gmres_tpu wraps the solve in ``jax.custom_vjp``; here it is a
``torch.autograd.Function`` in the ``forward`` + ``setup_context`` form, so
``torch.autograd``, ``.backward()`` and the ``torch.func`` transforms
(``grad``, ``vjp``, ``jacrev``, ``vmap`` and their compositions) all go
through it. θ is a tensor, or a tuple, list or dict of tensors (JAX's
pytree); its leaves are the Function's inputs. The backward is a second
Function, ``_Adjoint``: the adjoint solve and the θ pullback run in its
forward, which every transform hands plain tensors, so the solvers' loops
read no wrapped tensor. Aᵀ is the pullback of ``torch.func.vjp`` of A(θ)
at x (``symmetric=True`` uses A); the θ pullback is ``torch.autograd.grad``
of A(θ)(x) against −y. On a CUDA stencil both reach K1's rules
(``ops/stencil.py:Stencil5Grid``): Aᵀ is one K1 launch with mirrored
coefficients, and a coefficient built from θ gets its gradient
Σ ȳ·shiftₖ(x). Any other kernel under A raises there, for a tracked
operand or a tracked coefficient alike. On a sharded b (a DTensor) the
adjoint solve runs on the mesh, and a plain θ's gradient, which the
pullback leaves as per-rank partial sums, is all-reduced once.

Under ``torch.func.vmap`` (gmres_tpu's ``jax.vmap(jax.grad(loss))``, a
parameter sweep through the gradient) both Functions take vmap rules. The
lanes' forward solves are one batched solve (``solvers/batched.py``) with
θ's leaves as lane arguments, A(v, θᵢ) = A_fn(θᵢ)(v); so are their
adjoint solves, on the lanes' transposes (``requests.LaneTranspose``: on a
stencil one K1 launch with each lane's mirrored coefficients); the θ
pullback is one ``torch.func.vjp`` of the vmapped θ ↦ A(θ)·x, on a
stencil one per-lane K1 launch (``ops/stencil.py:Stencil5Lanes``) and the
lanes' coefficient cotangents. ``solver`` is a function of (op, b), as in
gmres_tpu's tests: the rule reaches its steps by calling it once a lane
with the lanes' operator while ``requests.capture_steps`` waits, which
takes the steps of the first solve it starts through ``requests.run``
(every solver ``batched_solve`` takes) instead of running them. So the
function must return that solve's result as it is. A function that starts
no such solve, or calls the lanes' operator itself
(``requests.DirectCall``), runs its lanes one after another with each
lane's own operator. ``implicit_solve.lane_paths`` counts the rule's
solves by path ("batched" or "in turn"), ``implicit_solve.lane_reads``
the batched solves' host reads.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from gmres_tpu_torch.ops.blas import is_dtensor
from gmres_tpu_torch.solvers.requests import (
    At,
    DirectCall,
    LaneOperator,
    capture_steps,
    derived_transpose,
    run_lanes,
)


def _lanes_first(t: torch.Tensor, dim, lanes: int) -> torch.Tensor:
    """A vmap rule's operand with its lanes first (repeated where it is not
    batched)."""
    if dim is None:
        return t.expand((lanes,) + tuple(t.shape)).contiguous()
    return t.movedim(dim, 0)


def _solve_lanes(solve: Callable, ops: list, bs: torch.Tensor,
                 single: Callable) -> torch.Tensor:
    """x of ``solve(op, b)`` for each lane, stacked: one batched solve where
    ``solve`` starts a solve through ``requests.run`` on the lanes' operators
    ``ops`` (``requests.capture_steps``), else each lane's solve with its own
    operator ``single(i)`` in turn."""
    gens = []
    for i, op in enumerate(ops):
        steps = capture_steps(lambda op=op, i=i: solve(op, bs[i]))
        if steps is None:
            break
        gens.append(steps)
    results = None
    if len(gens) == len(ops):
        try:
            results, reads = run_lanes(gens)
            implicit_solve.lane_paths["batched"] += 1
            implicit_solve.lane_reads += reads
        except DirectCall:
            pass  # a step called the lanes' operator itself: not batchable
    if results is None:
        for g in gens:
            g.close()
        implicit_solve.lane_paths["in turn"] += 1
        results = [solve(single(i), bs[i]) for i in range(len(ops))]
    return torch.stack([r.x for r in results])


class _LaneProblem:
    """The lanes of a vmap rule: b (or the cotangent) and θ's leaves as
    (lanes, …) blocks, and A(v, *leaves of a lane) = A_fn(θ of the lane)(v)."""

    def __init__(self, spec, A_fn, n: int, rhs, rhs_dim, leaves, leaf_dims):
        self.spec, self.A_fn = spec, A_fn
        self.bs = _lanes_first(rhs, rhs_dim, n)
        self.blocks = [_lanes_first(t, d, n) for t, d in zip(leaves, leaf_dims)]

    def a_lane(self, v, *vals):
        return self.A_fn(pytree.tree_unflatten(list(vals), self.spec))(v)

    def single(self, i: int) -> Callable:
        theta = pytree.tree_unflatten([t[i] for t in self.blocks], self.spec)
        with torch.no_grad():
            return self.A_fn(theta)


class _ImplicitSolve(torch.autograd.Function):
    """apply(spec, A_fn, solver, adj, symmetric, b, *θ leaves) → x."""

    @staticmethod
    def forward(spec, A_fn, solver, adj, symmetric, b, *leaves):
        theta = pytree.tree_unflatten(list(leaves), spec)
        return solver(A_fn(theta), b).x

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, A_fn, _, adj, symmetric, _, *leaves = inputs
        ctx.spec, ctx.A_fn, ctx.adj, ctx.symmetric = spec, A_fn, adj, symmetric
        ctx.save_for_backward(output, *leaves)

    @staticmethod
    def backward(ctx, ct_x):
        x, *leaves = ctx.saved_tensors
        want = tuple(i for i, need in enumerate(ctx.needs_input_grad[6:]) if need)
        y, *got = _Adjoint.apply(ctx.spec, ctx.A_fn, ctx.adj, ctx.symmetric, want,
                                 ct_x, x, *leaves)
        grads = [None] * len(leaves)
        for i, g in zip(want, got):
            grads[i] = g
        b_grad = y if ctx.needs_input_grad[5] else None
        return (None, None, None, None, None, b_grad, *grads)

    @staticmethod
    def vmap(info, in_dims, spec, A_fn, solver, adj, symmetric, b, *leaves):
        n = info.batch_size
        lanes = _LaneProblem(spec, A_fn, n, b, in_dims[5], leaves, in_dims[6:])
        a_lanes = LaneOperator(lanes.a_lane, tuple(lanes.blocks))
        with torch.no_grad():
            xs = _solve_lanes(solver, [a_lanes] * n, lanes.bs, lanes.single)
        return xs, 0


class _Adjoint(torch.autograd.Function):
    """_ImplicitSolve's backward as a Function of its own:
    apply(spec, A_fn, adj, symmetric, want, ct_x, x, *θ leaves) → (y, the
    gradients of the leaves ``want`` names). Its forward gets plain tensors
    under every transform; its vmap rule batches the lanes' adjoint solves
    and θ pullbacks. Not differentiable again (as gmres_tpu's bwd, which
    ``jax.custom_vjp`` differentiates no further here)."""

    @staticmethod
    def forward(spec, A_fn, adj, symmetric, want, ct_x, x, *leaves):
        leaves = [t.detach() for t in leaves]
        theta = pytree.tree_unflatten(leaves, spec)
        with torch.no_grad():
            op = A_fn(theta)
        op_t = op if symmetric else derived_transpose(op, ct_x)
        with torch.no_grad():
            y = adj(op_t, ct_x).x
        grads = []
        if want:
            # ∂L/∂θ = −yᵀ(∂A/∂θ)x: pull −y back through θ ↦ A(θ)·x, x held
            # fixed (the solution's own θ-dependence is in y already).
            with torch.enable_grad():
                tracked = [t.requires_grad_(i in want) for i, t in enumerate(leaves)]
                ax = A_fn(pytree.tree_unflatten(tracked, spec))(x)
                got = torch.autograd.grad(ax, [tracked[i] for i in want],
                                          grad_outputs=-y, allow_unused=True)
            for i, g in zip(want, got):
                if g is None:
                    g = torch.zeros_like(leaves[i])
                elif is_dtensor(g) and not is_dtensor(leaves[i]):
                    # A plain θ used against sharded vectors: its gradient
                    # comes back as per-rank partial sums; one all-reduce.
                    g = g.full_tensor()
                grads.append(g)
        return (y, *grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, spec, A_fn, adj, symmetric, want, ct_x, x, *leaves):
        n = info.batch_size
        lanes = _LaneProblem(spec, A_fn, n, ct_x, in_dims[5], leaves, in_dims[7:])
        xs = _lanes_first(x, in_dims[6], n)
        a_lanes = LaneOperator(lanes.a_lane, tuple(lanes.blocks))
        if symmetric:
            ops, single = [a_lanes] * n, lanes.single
        else:
            a_t = a_lanes.transpose()
            ops = [At(a_t, lanes.bs[i]) for i in range(n)]

            def single(i):
                return derived_transpose(lanes.single(i), lanes.bs[i])
        with torch.no_grad():
            ys = _solve_lanes(adj, ops, lanes.bs, single)
        got = []
        if want:
            def ax(*wanted):
                blocks = list(lanes.blocks)
                for i, blk in zip(want, wanted):
                    blocks[i] = blk
                return torch.func.vmap(lanes.a_lane)(xs, *blocks)

            with torch.enable_grad():
                _, pullback = torch.func.vjp(ax, *(lanes.blocks[i] for i in want))
                got = list(pullback(-ys))
        return (ys, *got), (0,) * (1 + len(got))


def implicit_solve(
    A_fn: Callable[[Any], Callable],
    theta: Any,
    b: torch.Tensor,
    *,
    solver: Callable,
    adjoint_solver: Optional[Callable] = None,
    symmetric: bool = False,
) -> torch.Tensor:
    """Differentiable x(θ, b) = A(θ)⁻¹ b.

    The arguments are those of ``gmres_tpu.implicit_solve``: ``A_fn`` maps
    θ to a linear operator (linear in its vector argument, differentiable
    in θ); ``solver(op, b)`` returns a result with ``.x``;
    ``adjoint_solver`` (default ``solver``) solves the transpose system;
    ``symmetric=True`` solves it with A itself. θ's leaves that require
    grad, and b, get the adjoint gradients through ``.backward()``,
    ``torch.autograd.grad`` or the ``torch.func`` transforms; one backward
    pass is one adjoint solve plus one pullback of θ ↦ A(θ)x. Under
    ``torch.func.vmap`` the lanes' solves are batched (module docstring).
    Complex b raises ValueError (real dtypes only, as in gmres_tpu)."""
    if b.is_complex():
        raise ValueError("implicit_solve supports real dtypes only")
    leaves, spec = pytree.tree_flatten(theta)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        leaves = [t if isinstance(t, torch.Tensor)
                  else torch.tensor(t, dtype=b.dtype, device=b.device) for t in leaves]
    adj = adjoint_solver if adjoint_solver is not None else solver
    return _ImplicitSolve.apply(spec, A_fn, solver, adj, symmetric, b, *leaves)


implicit_solve.lane_paths = {"batched": 0, "in turn": 0}
# Host reads of the vmap rules' batched solves (one a read of all lanes).
implicit_solve.lane_reads = 0
