"""Krylov matrix functions: f(A)·b without forming f(A), and stochastic
Lanczos quadrature for tr f(A).

Counterpart of ``gmres_tpu/solvers/funm.py``:

    f(A)·b ≈ ‖b‖ · V_m · f(H_m) · e₁,     A V_m = V_{m+1} H̄_m

(Saad 1992), with the basis from the port's ``arnoldi_factorization`` (CGS2,
full reorthogonalisation) on b's device and f applied to the (m, m)
projected matrix by a dense ``eigh`` of its symmetric part. That ``eigh``
runs on a float64 CPU copy of H̄ (one read of the device per
factorization), where JAX solves it in-jit; f therefore receives a float64
CPU tensor of Ritz values (``torch.log``, ``lambda s: 1 / torch.sqrt(s)``).
``funm_lanczos`` and ``expm_multiply`` are steps (``*_steps``,
``solvers/requests.py``), so a batched solve (``solvers/batched.py``) runs
one a lane and reads the lanes' Hessenbergs together.

``trace_funm`` batches its probes, as JAX ``jax.vmap``s them: each probe's
factorization runs as steps (``arnoldi_factorization_steps``), one lane of
``solvers/requests.py:run_lanes``, so each Arnoldi step applies A once to
all probes (one ``torch.func.vmap``: one batched K1 launch for a stencil on
the card) while each probe's reductions and updates run on its own
tensors, its bits those of its factorization alone; the probes'
Hessenbergs then come back in one read for the small eigenproblems
(``trace_funm_lanes``, which also runs a batched solve's lanes × probes).
On a row-sharded x_like (a DTensor) the probes are the same draws placed
like it and run as the same lanes: an Arnoldi step's application of A is
one ``row_apply`` of the probes' sharded block, so a halo-route operator
makes one exchange and one launch for all of them (``parallel/halo.py``'s
block form), and each probe's reductions are its own all-reduces. Its
Rademacher probes cannot be JAX's (``PRNGKey`` draws have no torch
counterpart): they come from one seam, ``_rademacher``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from gmres_tpu_torch.ops.blas import row_combine, shard_rows_like, tree_vdot
from gmres_tpu_torch.solvers.lanczos import arnoldi_factorization_steps
from gmres_tpu_torch.solvers.requests import LaneOperator, read_host, run, run_lanes
from gmres_tpu_torch.types import LinearOperator


@dataclasses.dataclass(frozen=True)
class FunmResult:
    """Result of ``funm_lanczos`` / ``expm_multiply`` (the fields of
    ``gmres_tpu.FunmResult``).

    Attributes:
      y: f(A)·b: b's shape, or (nt, *shape) for a vector of times.
      error_estimate: Saad's indicator ‖b‖·β_m·|eₘᵀ f(H) e₁|, 0-d or (nt,).
      asymmetry: max|H − Hᵀ| of the Krylov pencil (~ε‖A‖ for a symmetric A;
        O(‖A‖) means f was taken of the Hermitian part only).

    Beyond the JAX fields:
      host_syncs: reads of the device (one per factorization).
    """

    y: Any
    error_estimate: torch.Tensor
    asymmetry: torch.Tensor
    host_syncs: int = 0


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Result of ``trace_funm`` (the fields of ``gmres_tpu.TraceResult``).

    Attributes:
      value: the tr f(A) estimate, the mean over the probes.
      stderr: standard error of that mean (population std / √probes).
      samples: (n_probes,) per-probe estimates zᵀ f(A) z.

    Beyond the JAX fields:
      host_syncs: reads of the device (one for all probes; one per probe on
        a row-sharded x_like).
    """

    value: torch.Tensor
    stderr: torch.Tensor
    samples: torch.Tensor
    host_syncs: int = 0


def _projected_eigh(hmat: torch.Tensor, steps: int):
    """(theta, q, beta_m, asym) of the (steps+1, steps) Hessenberg: the
    eigh of its symmetric (steps, steps) part, the last subdiagonal entry
    and the asymmetry, all on a float64 CPU copy (one read)."""
    return _host_eigh(hmat.detach().to("cpu", torch.float64), steps)


def _host_eigh(host: torch.Tensor, steps: int):
    """``_projected_eigh`` of a float64 CPU Hessenberg."""
    h = host[:steps, :steps]
    theta, q = torch.linalg.eigh(0.5 * (h + h.T))
    return theta, q, host[steps, steps - 1], torch.max(torch.abs(h - h.T))


def _funm_core_steps(A, b, steps):
    """The factorization of b and the eigh of its projected matrix, as
    steps: ``steps`` applications of A, then one read of the Hessenberg
    (in a batched solve one read for every lane waiting on it), whose
    eigh runs on the lane's own float64 CPU copy."""
    basis, hmat = yield from arnoldi_factorization_steps(A, b, steps)
    theta, q, beta_m, asym = _host_eigh((yield from read_host(hmat)), steps)
    beta0 = torch.sqrt(tree_vdot(b, b))
    return basis, theta, q, beta0, beta_m, asym


def funm_lanczos(
    A: LinearOperator,
    b: torch.Tensor,
    f: Callable,
    *,
    steps: int = 30,
) -> FunmResult:
    """f(A)·b for symmetric A by ``steps``-step Lanczos (the arguments of
    ``gmres_tpu.funm_lanczos``). f maps a float64 CPU tensor of Ritz values
    elementwise (it is evaluated only there, inside A's spectral
    interval)."""
    return run(funm_lanczos_steps(A, b, f, steps=steps))


def funm_lanczos_steps(A, b, f, *, steps=30):
    """``funm_lanczos`` as steps (``solvers/requests.py``)."""
    basis, theta, q, beta0, beta_m, asym = yield from _funm_core_steps(A, b, steps)
    w = q @ (f(theta) * q[0, :])  # f(H) e₁
    y = beta0 * row_combine(w.to(b.device, b.dtype), basis[:steps])
    err = beta0 * float(abs(beta_m) * abs(w[steps - 1]))
    return FunmResult(y=y, error_estimate=err, asymmetry=asym.to(b.device, b.dtype),
                      host_syncs=1)


def expm_multiply(
    A: LinearOperator,
    b: torch.Tensor,
    t=1.0,
    *,
    steps: int = 30,
) -> FunmResult:
    """The heat-semigroup action exp(−t·A)·b (A positive definite, so
    states decay; the arguments of ``gmres_tpu.expm_multiply``). t: a
    number, or a 1-D sequence of times, all from one factorization; y then
    gains a leading (nt,) axis."""
    return run(expm_multiply_steps(A, b, t, steps=steps))


def expm_multiply_steps(A, b, t=1.0, *, steps=30):
    """``expm_multiply`` as steps (``solvers/requests.py``)."""
    scalar = torch.as_tensor(t).dim() == 0
    t_arr = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float64))
    basis, theta, q, beta0, beta_m, asym = yield from _funm_core_steps(A, b, steps)
    # (nt, m): f(H) e₁ for every time.
    w = torch.einsum("ij,tj,j->ti", q, torch.exp(-t_arr[:, None] * theta), q[0, :])
    y = beta0 * row_combine(w.T.to(b.device, b.dtype), basis[:steps])
    err = beta0 * (abs(beta_m) * torch.abs(w[:, steps - 1])).to(b.device, b.dtype)
    if scalar:
        y, err = y[0], err[0]
    return FunmResult(y=y, error_estimate=err, asymmetry=asym.to(b.device, b.dtype),
                      host_syncs=1)


def _rademacher(n_probes: int, shape, dtype, device, key) -> torch.Tensor:
    """(n_probes, *shape) ±1 probes from a CPU torch.Generator seeded
    ``key`` (an int; JAX takes a PRNG key, default PRNGKey(0))."""
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    bits = torch.randint(0, 2, (n_probes,) + tuple(shape), generator=gen)
    return (2.0 * bits - 1.0).to(device, dtype)


def trace_funm(
    A: LinearOperator,
    f: Callable,
    x_like: torch.Tensor,
    *,
    n_probes: int = 16,
    steps: int = 30,
    key=None,
) -> TraceResult:
    """tr f(A) for symmetric A by stochastic Lanczos quadrature (Ubaru,
    Chen, Saad 2017): the mean of ‖z‖²·e₁ᵀ f(T_m) e₁ over Rademacher probes
    z (the arguments of ``gmres_tpu.trace_funm``; ``key`` is an int seed,
    default 0). x_like gives the probes' shape, dtype and device; on a
    row-sharded x_like the probes are the same draws placed like it, so
    each rank runs the quadrature on its own rows, the probes batched as on
    a plain x_like."""
    return trace_funm_lanes(A, f, x_like[None], n_probes=n_probes, steps=steps,
                            key=key)[0]


def _trace_result(f, z, hosts, steps, like, syncs):
    """The TraceResult of the probes z from their float64 Hessenbergs."""
    samples = []
    for i in range(z.shape[0]):
        theta, q, _, _ = _host_eigh(hosts[i], steps)
        quad = torch.sum(f(theta) * q[0, :] ** 2).to(like.device, like.dtype)
        samples.append(tree_vdot(z[i], z[i]) * quad)  # ‖z‖² = N for Rademacher
    samples = torch.stack(samples)
    value = torch.mean(samples)
    stderr = torch.std(samples, correction=0) / (1.0 * z.shape[0]) ** 0.5
    return TraceResult(value=value, stderr=stderr, samples=samples, host_syncs=syncs)


def trace_funm_lanes(A, f, x_likes: torch.Tensor, *, lane_args: tuple = (),
                     n_probes: int = 16, steps: int = 30, key=None) -> list:
    """``trace_funm`` for each lane of ``x_likes`` (lanes, *shape) on the
    operator A(v, *lane_args_i) (``batched_solve``; one lane for a plain
    ``trace_funm``). Every lane draws the same probes from ``key``, as
    ``jax.vmap`` over a closure does. The lanes × probes factorizations are
    one lane each of ``run_lanes``, each probe carrying its lane's
    arguments, so an Arnoldi step applies A once to all of them (one
    ``torch.func.vmap``: one K1 launch, per-lane coefficients, on the
    card); every Hessenberg then comes back in one read. Each lane's
    samples are those of its sequential ``trace_funm`` to the bit."""
    lanes = x_likes.shape[0]
    like = x_likes[0]
    z = shard_rows_like(_rademacher(n_probes, tuple(like.shape), like.dtype, like.device,
                                    0 if key is None else key), like)
    a_lanes = LaneOperator(A, tuple(a.repeat_interleave(n_probes, dim=0) for a in lane_args))
    done, _ = run_lanes([arnoldi_factorization_steps(a_lanes, z[i], steps)
                         for _ in range(lanes) for i in range(n_probes)])
    # One read: every probe's Hessenberg.
    hosts = torch.stack([hmat for _, hmat in done]).detach().to("cpu", torch.float64)
    return [_trace_result(f, z, hosts[k * n_probes:(k + 1) * n_probes], steps, like, 1)
            for k in range(lanes)]
