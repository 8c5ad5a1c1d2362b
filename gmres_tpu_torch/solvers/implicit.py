"""Implicit differentiation through linear solves (the adjoint method).

Counterpart of ``gmres_tpu/solvers/implicit.py``: ``implicit_solve`` makes
the solution of A(θ)·x = b a differentiable function of θ and b, with the
gradients of the implicit function theorem rather than of the iteration:

    x(θ, b) = A(θ)⁻¹ b
    ∂L/∂b  = y          where  A(θ)ᵀ y = ∂L/∂x   (one adjoint solve)
    ∂L/∂θ  = −yᵀ (∂A/∂θ) x                         (a vjp of θ ↦ A(θ)x)

gmres_tpu wraps the solve in ``jax.custom_vjp``; here it is a
``torch.autograd.Function``. θ is a tensor, or a tuple, list or dict of
tensors (JAX's pytree); its leaves are the Function's inputs. Aᵀ is the
pullback of ``torch.func.vjp`` of A(θ) at x (``symmetric=True`` uses A);
the θ pullback is ``torch.autograd.grad`` of A(θ)(x) against −y. On a CUDA
stencil both reach K1's rules (``ops/stencil.py:Stencil5Grid``): Aᵀ is one
K1 launch with mirrored coefficients, and a coefficient built from θ gets
its gradient Σ ȳ·shiftₖ(x). Any other kernel under A raises there, for a
tracked operand or a tracked coefficient alike. On a sharded b (a DTensor)
the adjoint solve runs on the mesh, and a plain θ's gradient, which the
pullback leaves as per-rank partial sums, is all-reduced once.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from gmres_tpu_torch.ops.blas import is_dtensor
from gmres_tpu_torch.solvers.qmr import derived_transpose


class _ImplicitSolve(torch.autograd.Function):
    """forward(spec, A_fn, solver, adj, symmetric, b, *θ leaves) → x."""

    @staticmethod
    def forward(ctx, spec, A_fn, solver, adj, symmetric, b, *leaves):
        theta = pytree.tree_unflatten(list(leaves), spec)
        x = solver(A_fn(theta), b).x
        ctx.spec, ctx.A_fn, ctx.adj, ctx.symmetric = spec, A_fn, adj, symmetric
        ctx.save_for_backward(x, *leaves)
        return x

    @staticmethod
    def backward(ctx, ct_x):
        x, *leaves = ctx.saved_tensors
        leaves = [t.detach() for t in leaves]
        theta = pytree.tree_unflatten(leaves, ctx.spec)
        with torch.no_grad():
            op = ctx.A_fn(theta)
        op_t = op if ctx.symmetric else derived_transpose(op, ct_x)
        with torch.no_grad():
            y = ctx.adj(op_t, ct_x).x
        grads = [None] * len(leaves)
        want = [i for i, need in enumerate(ctx.needs_input_grad[6:]) if need]
        if want:
            # ∂L/∂θ = −yᵀ(∂A/∂θ)x: pull −y back through θ ↦ A(θ)·x, x held
            # fixed (the solution's own θ-dependence is in y already).
            with torch.enable_grad():
                tracked = [t.requires_grad_(i in want) for i, t in enumerate(leaves)]
                ax = ctx.A_fn(pytree.tree_unflatten(tracked, ctx.spec))(x)
                got = torch.autograd.grad(ax, [tracked[i] for i in want],
                                          grad_outputs=-y, allow_unused=True)
            for i, g in zip(want, got):
                if g is None:
                    g = torch.zeros_like(leaves[i])
                elif is_dtensor(g) and not is_dtensor(leaves[i]):
                    # A plain θ used against sharded vectors: its gradient
                    # comes back as per-rank partial sums; one all-reduce.
                    g = g.full_tensor()
                grads[i] = g
        b_grad = y if ctx.needs_input_grad[5] else None
        return (None, None, None, None, None, b_grad, *grads)


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
    grad, and b, get the adjoint gradients through ``.backward()`` or
    ``torch.autograd.grad``; one backward pass is one adjoint solve plus one
    pullback of θ ↦ A(θ)x. Complex b raises ValueError (real dtypes only,
    as in gmres_tpu)."""
    if b.is_complex():
        raise ValueError("implicit_solve supports real dtypes only")
    leaves, spec = pytree.tree_flatten(theta)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        leaves = [t if isinstance(t, torch.Tensor)
                  else torch.tensor(t, dtype=b.dtype, device=b.device) for t in leaves]
    adj = adjoint_solver if adjoint_solver is not None else solver
    return _ImplicitSolve.apply(spec, A_fn, solver, adj, symmetric, b, *leaves)
