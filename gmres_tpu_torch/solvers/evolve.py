"""Time integration driven by the port's solvers: the implicit θ-method and
exponential Euler.

Counterpart of ``gmres_tpu/solvers/evolve.py``. For u_t + L u + C(u) = f(t),
u(0) = u0, with L the positive (semi-)definite spatial operator:

    (I + θΔt·L) u_{n+1} = (I − (1−θ)Δt·L) u_n + Δt·(θ f_{n+1} + (1−θ) f_n)
                          − Δt·Ĉ_n,

each step solved by cg, bicgstab, gmres or gcrodr warm-started at u_n; with
gcrodr the recycle block rides from step to step. ``exponential_evolve``
steps u_{n+1} = e^{−Δt·L} u_n + Δt·φ₁(−Δt·L) f by the Krylov semigroup
action (``solvers/funm.py``).

JAX's ``lax.scan`` over the steps is a Python loop here: each step's solve
decides on the host as the solvers do, and its result (iterations,
residual, status) is read once. Both integrators are steps
(``theta_evolve_steps``, ``exponential_evolve_steps``;
``solvers/requests.py``), each step's solve yielding from its solver's
steps, so a batched solve (``solvers/batched.py``) runs one trajectory a
lane. The step counts follow JAX's
(``evolve.py:225-235``): gmres counts (restarts − 1)·restart + iterations,
gcrodr k + (restarts − 1)·(restart − k) + iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from gmres_tpu_torch.ops.blas import rows_like
from gmres_tpu_torch.solvers.requests import Apply, derived, run
from gmres_tpu_torch.types import Preconditioner, SolverStatus


@dataclasses.dataclass(frozen=True)
class EvolveResult:
    """Trajectory result of ``theta_evolve`` (the fields of
    ``gmres_tpu.EvolveResult``).

    Attributes:
      u: the state after n_steps.
      iterations: (n_steps,) int32 CPU tensor, solver iterations per step.
      residuals: (n_steps,) per-step final solver residual (absolute for
        cg/bicgstab, relative for gmres/gcrodr).
      statuses: (n_steps,) int32 CPU tensor, per-step SolverStatus.
      status: the worst per-step status.
      inner_total: solver iterations over the trajectory.
      trajectory: (n_steps, *shape) states with ``save_trajectory``, else an
        empty (0,) tensor.

    Beyond the JAX fields:
      host_syncs: the per-step solves' reads of the device, summed.
    """

    u: Any
    iterations: torch.Tensor
    residuals: torch.Tensor
    statuses: torch.Tensor
    status: int
    inner_total: int
    trajectory: torch.Tensor
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED


def theta_evolve(
    L,
    u0: torch.Tensor,
    *,
    dt: float,
    n_steps: int,
    theta: float = 0.5,
    forcing: Optional[Union[torch.Tensor, Callable]] = None,
    t0: float = 0.0,
    solver: str = "cg",
    M: Optional[Preconditioner] = None,
    tol: float = 1e-10,
    max_iterations: int = 500,
    restart: int = 40,
    max_restarts: int = 50,
    recycle_k: int = 10,
    save_trajectory: bool = False,
    explicit: Optional[Callable] = None,
    explicit_order: int = 2,
) -> EvolveResult:
    """Integrate u_t + L u + C(u) = f from u0 over n_steps of size dt (the
    arguments of ``gmres_tpu.theta_evolve``).

      L: spatial operator (positive-definite convention).
      theta: 1 backward Euler, 0.5 Crank–Nicolson (default).
      forcing: None, a constant tensor, or a callable t ↦ f(t) (t a 0-d
        float64 CPU tensor) averaged θ-weighted over the step.
      solver: "cg", "bicgstab", "gmres" or "gcrodr" (recycling across
        steps); M preconditions S = I + θΔt·L.
      tol, max_iterations, restart, max_restarts, recycle_k: passed to the
        per-step solver with its own semantics.
      save_trajectory: keep every step's state.
      explicit: C(u) treated explicitly, Adams–Bashforth-2
        (``explicit_order`` 2, explicit Euler on the first step) or
        explicit Euler (1).
    """
    return run(theta_evolve_steps(
        L, u0, dt=dt, n_steps=n_steps, theta=theta, forcing=forcing, t0=t0, solver=solver,
        M=M, tol=tol, max_iterations=max_iterations, restart=restart,
        max_restarts=max_restarts, recycle_k=recycle_k, save_trajectory=save_trajectory,
        explicit=explicit, explicit_order=explicit_order))


def theta_evolve_steps(L, u0, *, dt, n_steps, theta=0.5, forcing=None, t0=0.0, solver="cg",
                       M=None, tol=1e-10, max_iterations=500, restart=40, max_restarts=50,
                       recycle_k=10, save_trajectory=False, explicit=None, explicit_order=2):
    """``theta_evolve`` as steps (``solvers/requests.py``): the explicit
    L(u) and C(u) are requests, the shifted operator S = I + θΔt·L is
    ``requests.derived`` from L (in a batched solve one operator for every
    lane, so the lanes' S applications are one launch), and each step's
    solve yields from its solver's steps, the recycle block the lane's
    own."""
    if solver not in ("cg", "bicgstab", "gmres", "gcrodr"):
        raise ValueError(f"unknown solver {solver!r}")
    if not 0.0 <= theta <= 1.0:
        raise ValueError(f"theta must be in [0, 1], got {theta}")
    if explicit_order not in (1, 2):
        raise ValueError(f"explicit_order must be 1 or 2, got {explicit_order}")

    from gmres_tpu_torch.solvers.bicgstab import bicgstab_steps
    from gmres_tpu_torch.solvers.cg import cg_steps
    from gmres_tpu_torch.solvers.gcrodr import gcrodr_steps
    from gmres_tpu_torch.solvers.gmres import gmres_steps

    dtype, dev = u0.dtype, u0.device
    rdtype = dtype.to_real() if dtype.is_complex else dtype
    step_c = float(theta) * float(dt)
    shifted = derived(L, ("theta", step_c),
                      lambda fn: lambda v, *a: v + step_c * fn(v, *a))

    def f_avg(t_n):
        if forcing is None:
            return 0.0
        if callable(forcing):
            t_n = torch.tensor(t_n, dtype=torch.float64)
            return theta * forcing(t_n + dt) + (1.0 - theta) * forcing(t_n)
        return forcing

    u = u0
    # The zero recycle block of the first step ([Shard(1)] on a sharded u0).
    rec = rows_like(recycle_k, u0) if solver == "gcrodr" else None
    c_prev = None
    iters, resids, statuses, snaps = [], [], [], []
    syncs = 0
    for idx in range(n_steps):
        t_n = t0 + dt * idx
        if theta == 1.0:  # backward Euler: no explicit matvec
            rhs = u + dt * f_avg(t_n)
        else:
            rhs = u - ((1.0 - theta) * dt) * (yield Apply(L, u)) + dt * f_avg(t_n)
        if explicit is not None:
            c_now = yield Apply(explicit, u)
            c_hat = (c_now if explicit_order == 1 or idx == 0
                     else 1.5 * c_now - 0.5 * c_prev)
            rhs = rhs - dt * c_hat
            c_prev = c_now
        if solver == "cg":
            res = yield from cg_steps(shifted, rhs, tol=tol, max_iterations=max_iterations,
                                      M=M, x0=u)
            inner = res.iterations
        elif solver == "bicgstab":
            res = yield from bicgstab_steps(shifted, rhs, tol=tol,
                                            max_iterations=max_iterations, M=M, x0=u)
            inner = res.iterations
        elif solver == "gmres":
            res = yield from gmres_steps(shifted, rhs, restart=restart, tol=tol,
                                         max_restarts=max_restarts, M=M, x0=u,
                                         compute_v_err=False)
            inner = max(res.restarts - 1, 0) * restart + res.iterations
        else:
            res = yield from gcrodr_steps(shifted, rhs, k=recycle_k, restart=restart, tol=tol,
                                          max_restarts=max_restarts, M=M, x0=u, recycle=rec)
            rec = res.recycle
            inner = (recycle_k + max(res.restarts - 1, 0) * (restart - recycle_k)
                     + res.iterations)
        u = res.x
        iters.append(int(inner))
        resids.append(torch.as_tensor(res.residual).to(dev, rdtype))
        statuses.append(int(res.status))
        syncs += res.host_syncs
        if save_trajectory:
            snaps.append(u)
    return EvolveResult(
        u=u,
        iterations=torch.tensor(iters, dtype=torch.int32),
        residuals=(torch.stack(resids) if resids
                   else torch.zeros((0,), dtype=rdtype, device=dev)),
        statuses=torch.tensor(statuses, dtype=torch.int32),
        status=max(statuses, default=int(SolverStatus.CONVERGED)),
        inner_total=sum(iters),
        trajectory=(torch.stack(snaps) if save_trajectory and snaps
                    else torch.zeros((0,), dtype=dtype, device=dev)),
        host_syncs=syncs)


@dataclasses.dataclass(frozen=True)
class ExpEvolveResult:
    """Result of ``exponential_evolve`` (the fields of
    ``gmres_tpu.ExpEvolveResult``).

    Attributes:
      u: the state after n_steps.
      error_estimates: (n_steps,) per-step Saad indicators of the
        propagator's Krylov approximation (the time rule itself is exact).
      trajectory: (n_steps, *shape) states when requested, else (0,).

    Beyond the JAX fields:
      host_syncs: reads of the device, one per factorization.
    """

    u: Any
    error_estimates: torch.Tensor
    trajectory: torch.Tensor
    host_syncs: int = 0


def exponential_evolve(
    L,
    u0: torch.Tensor,
    *,
    dt: float,
    n_steps: int,
    steps: int = 30,
    forcing: Optional[torch.Tensor] = None,
    save_trajectory: bool = False,
) -> ExpEvolveResult:
    """Integrate u_t + L u = f (L symmetric positive definite, f constant or
    zero) by exponential Euler, exact in time for this class:
    u_{n+1} = e^{−Δt·L} u_n + Δt·φ₁(−Δt·L) f, the forcing propagator
    (I − e^{−ΔtL}) L⁻¹ f formed once (the arguments of
    ``gmres_tpu.exponential_evolve``)."""
    return run(exponential_evolve_steps(L, u0, dt=dt, n_steps=n_steps, steps=steps,
                                        forcing=forcing, save_trajectory=save_trajectory))


def exponential_evolve_steps(L, u0, *, dt, n_steps, steps=30, forcing=None,
                             save_trajectory=False):
    """``exponential_evolve`` as steps (``solvers/requests.py``): the
    forcing propagator's factorization, then one a step, each yielding
    from ``funm``'s steps (one read of its Hessenberg)."""
    from gmres_tpu_torch.solvers.funm import expm_multiply_steps, funm_lanczos_steps

    dtype, dev = u0.dtype, u0.device
    syncs = 0
    if forcing is None:
        g = torch.zeros_like(u0)
    else:
        out = yield from funm_lanczos_steps(L, torch.as_tensor(forcing).to(dev, dtype),
                                            lambda s: (1.0 - torch.exp(-dt * s)) / s,
                                            steps=steps)
        g, syncs = out.y, out.host_syncs
    u = u0
    ests, snaps = [], []
    for _ in range(n_steps):
        r = yield from expm_multiply_steps(L, u, dt, steps=steps)
        u = r.y + g
        ests.append(r.error_estimate)
        syncs += r.host_syncs
        if save_trajectory:
            snaps.append(u)
    rdtype = dtype.to_real() if dtype.is_complex else dtype
    return ExpEvolveResult(
        u=u,
        error_estimates=(torch.stack(ests).to(rdtype) if ests
                         else torch.zeros((0,), dtype=rdtype, device=dev)),
        trajectory=(torch.stack(snaps) if save_trajectory and snaps
                    else torch.zeros((0,), dtype=dtype, device=dev)),
        host_syncs=syncs)
