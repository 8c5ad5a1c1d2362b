"""Driver programs of the PyTorch/CUDA port, as one CLI.

Counterpart of ``benchmarks/cli.py``, which has a subcommand for each
reference program (SURVEY.md §4). Ported so far, with the JAX defaults and
flags:

  dense-poisson   ← tests/test_poisson.f90: dense MGSR vs Householder
  hilbert         ← tests/test_hilbert.f90: orthogonality A/B at n, m
  poisson-mf      ← tests/test_poisson_mf.f90: cbpr2-preconditioned
                    Householder vs MGSR, matrix-free (flagship)
  cg              ← tests/test_cg.f90: PCG grid sweep 300²..1000², 1e-9
  bicgstab        ← tests/test_bicgstab.f90: the same sweep
  convdiff        BASELINE config 3: BiCGSTAB (or GMRES, BiCGStab(ℓ), CGS,
                  TFQMR, IDR(s), QMR) on the nonsymmetric convection-diffusion
                  stencil, with its multigrid cycle or the GMRES polynomial
  bratu           Jacobian-free Newton-Krylov on the 2-D Bratu problem, with
                  the frozen Poisson multigrid cycle as M
  helmholtz       the indefinite Helmholtz stencil: MINRES (or GMRES) with the
                  SPD shifted-Laplacian cycle, or GMRES / GCRO-DR with the
                  complex-shifted (CSL) cycle, complex or split real
  sequence        GCRO-DR fresh and warm-started over a Helmholtz frequency
                  sweep (Krylov recycling)
  strong-scaling  ← tests/strong_scaling.f90: fixed grid, rank count 1..D
  weak-scaling    ← the true weak scaling the reference commented out
                    (weak_scaling.f90:60): the grid grows with the ranks
  restart-sweep   ← tests/weak_scaling.f90 (misnamed there: it sweeps the
                    restart parameter m); Householder GMRES, LGMRES or
                    GMRES-DR
  multirhs        block CG (or block GMRES) over s stacked right-hand
                  sides, time per right-hand side against s = 1
  varcoef         CG on −∇·(c∇u) with two high-contrast inclusions: Jacobi,
                  the rediscretised multigrid cycle, each with and without
                  the inclusion-indicator coarse space (deflation)
  eig             LOBPCG (Poisson, multigrid M), Krylov–Schur on a complex or
                  real Schur basis, or subspace iteration (convection-
                  diffusion), against the closed-form spectra
  slq             log det of the Poisson operator by stochastic Lanczos
                  quadrature, per probe count
  evolve          θ-method trajectories (cg, bicgstab, gmres, gcrodr steps,
                  optionally the σ-shifted multigrid cycle) or exponential
                  Euler
  scale           the production configuration (Householder GMRES, the
                  Poisson V-cycle, float32 cycles certified on the true
                  residual) across grids 300²..4096²; --dim 3: CG with the
                  3-D cycle
  spmv            SpMV throughput on the Poisson matrix: the plain stencil
                  and sparse formats, and the kernels K1, K3 and K4
  roofline        achieved bandwidth of the stencil routes (plain float32
                  and float64, kernel K1, kernel K6 on (hi, lo) pairs), of
                  the order-k Chebyshev smoother (kernel K2) and of the
                  multigrid V-cycle, against the card's HBM peak

Usage: python -m gmres_tpu_torch.benchmarks <subcommand> [options]

Every subcommand runs on the card unless ``--device cpu`` is given, and
raises where there is no card and no such flag. It prints the
reference-style table and can append its rows to JSONL (``--jsonl PATH``).
A solve is timed as in JAX's ``_timed``: one warm-up solve, then one timed
solve that ends in a device synchronisation.

One process drives one card. ``strong-scaling`` and ``weak-scaling`` run
under ``torchrun --nproc-per-node W`` (or in a process group the caller
made) and sweep the device count d over the first d ranks, up to
``min(--max-devices, W)``; ranks outside a mesh sit that run out and only
rank 0 prints. Run alone, such a program makes a one-rank group of its
own (NCCL on the card, gloo with ``--device cpu``). Both apply the
explicit-halo operator (kernel K1 on each rank's rows) at every d, with
or without ``--explicit-halo``: JAX lets GSPMD partition the plain
operator over a sharded b, and PyTorch has no such partitioner (on the
card K1 needs a plain tensor's storage, which a DTensor lacks). The
preconditioner is the program's own cbpr2 over that operator. JAX's
``hlo_static_collectives`` reads XLA's HLO and has no counterpart here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from gmres_tpu_torch.utils.reporting import (
    RunRecord,
    is_host0,
    print_table,
    record_from_result,
    write_jsonl,
)

# The card's L2 (H100: 50 MB). A chained row whose working set fits there
# re-reads its data from L2, not from HBM.
L2_BYTES = 50 * 2**20
# A row may exceed the HBM peak by measurement noise; beyond this it must
# carry a stated traffic model.
PEAK_SLACK = 1.05


# Chebyshev eigenvalue bounds every reference program hardcodes
# (test_poisson_mf.f90:38 params=(8.2, 0.2)).
REF_EIG = (0.2, 8.2)
# The restart-sweep solvers of the JAX program.
RESTART_SOLVERS = ("gmres", "lgmres", "gmres-dr")
# The convdiff solvers of the JAX program.
CONVDIFF_SOLVERS = ("bicgstab", "gmres", "bicgstabl", "cgs", "tfqmr", "idrs", "qmr")
# JAX's exit for qmr with the multigrid cycle (benchmarks/cli.py:328-334): it
# derives (M A)ᵀ, and the cycle has no transpose rule (in JAX its fori_loop,
# on the card its K2 and K1 V-cycle forms).
QMR_MG_EXIT = ("qmr derives (M A)^T by jax.linear_transpose; the MG cycle's "
               "fori_loop has no transpose rule — use --precond none with qmr "
               "(poly is transposable but measured to stall QMR's two-sided "
               "recurrence here)")
# The helmholtz program's solvers. gmres_tpu's takes any string and runs
# MINRES for any but gmres outside the CSL route, labelling the row with
# the string it was given (ROADMAP queue 3); the port takes these and exits
# where it would not run the solver named.
HELMHOLTZ_SOLVERS = ("minres", "gmres", "gcrodr")
# The multirhs solvers of the JAX program.
MULTIRHS_SOLVERS = ("block-cg", "block-gmres")
# GMRES's restart length in the convdiff program.
CONVDIFF_RESTART = 30


def _emit(records, args):
    print_table(records)
    if getattr(args, "jsonl", None):
        write_jsonl(records, args.jsonl, append=True)


def _device(args) -> torch.device:
    """The device a program runs on: the card unless --device cpu."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's programs run on the "
                           "card; pass --device cpu for the plain versions "
                           "on the CPU")
    return torch.device(args.device)


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(solve: Callable, dev: torch.device):
    """One warm-up solve, then one timed solve that ends in a device
    synchronisation (the reference's omp_get_wtime wraps only the solve,
    test_poisson_mf.f90:44-46)."""
    solve()
    _synchronize(dev)
    t0 = time.perf_counter()
    out = solve()
    _synchronize(dev)
    return out, time.perf_counter() - t0


def _grid_range(spec: str):
    """'300:1000:50' → [300, 350, ..., 1000]."""
    lo, hi, step = (int(v) for v in spec.split(":"))
    return list(range(lo, hi + 1, step))


def _ones(shape, dev) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float64, device=dev)


def _total_inner(res, m: int) -> int:
    return max(int(res.restarts) - 1, 0) * m + int(res.iterations)


def _record(name, res, extra=None, **kw):
    """``record_from_result`` with the solve's status among the row's
    extra fields (JAX's rows carry none; a row of the port says whether
    its solve converged)."""
    return record_from_result(name, res, extra={"status": int(res.status),
                                                **(extra or {})}, **kw)


# ---------------------------------------------------------------------------
# The reference's programs.
# ---------------------------------------------------------------------------


def cmd_dense_poisson(args):
    """Dense 5-point Poisson matrix: MGSR against Householder GMRES."""
    from gmres_tpu_torch.models.poisson import poisson_matrix
    from gmres_tpu_torch.solvers.gmres import gmres

    dev = _device(args)
    n, m = args.nsize, args.restart
    a = poisson_matrix(n, device=dev)
    x_true = _ones(n * n, dev)
    b = a @ x_true
    records = []
    for variant in ("mgsr", "householder"):
        res, dt = _timed(lambda v=variant: gmres(
            a, b, restart=m, tol=args.tol, variant=v,
            max_restarts=args.max_restarts), dev)
        records.append(_record(
            f"gmres-{variant}-dense", res, x_true=x_true, wall_s=dt,
            tol=args.tol, nnz=(n * n) ** 2))
    _emit(records, args)
    return records


def cmd_hilbert(args):
    """The Hilbert matrix's orthogonality A/B: one cycle of MGSR and of
    Householder GMRES, with the |I − VᵀV| audit."""
    from gmres_tpu_torch.models.hilbert import hilbert_matrix
    from gmres_tpu_torch.solvers.gmres import gmres

    dev = _device(args)
    n, m = args.n, args.restart
    a = hilbert_matrix(n, device=dev)
    x_true = _ones(n, dev)
    b = a @ x_true
    records = []
    for variant in ("mgsr", "householder"):
        res, dt = _timed(lambda v=variant: gmres(
            a, b, restart=m, tol=args.tol, variant=v, max_restarts=1), dev)
        records.append(_record(
            f"gmres-{variant}-hilbert", res, x_true=x_true, wall_s=dt,
            tol=args.tol))
    _emit(records, args)
    return records


def cmd_poisson_mf(args):
    """The flagship: matrix-free Poisson, cbpr2 on REF_EIG, Householder
    against MGSR (``--mixed``: float32 Arnoldi cycles)."""
    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.precond.chebyshev import chebyshev_preconditioner
    from gmres_tpu_torch.solvers.gmres import gmres

    dev = _device(args)
    n, m = args.nsize, args.restart
    op = poisson_operator(n)
    m_inv = chebyshev_preconditioner(op, *REF_EIG)
    x_true = _ones((n, n), dev)
    b = op(x_true)
    inner = torch.float32 if args.mixed else None
    records = []
    for variant in ("householder", "mgsr"):
        res, dt = _timed(lambda v=variant: gmres(
            op, b, restart=m, tol=args.tol, M=m_inv, variant=v,
            max_restarts=args.max_restarts, inner_dtype=inner,
            compute_v_err=not args.no_v_err), dev)
        iters = _total_inner(res, m)
        records.append(_record(
            f"gmres-{variant}-mf{'-f32' if args.mixed else ''}", res,
            x_true=x_true, wall_s=dt, tol=args.tol, nnz=5 * n * n - 4 * n,
            extra={"matvecs": 2 * iters, "total_iters": iters}))
    _emit(records, args)
    return records


def _sweep(args, solver_name: str):
    """cbpr2 CG or BiCGSTAB over the grids of ``--grids``, b = A·1."""
    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.precond.chebyshev import chebyshev_preconditioner
    from gmres_tpu_torch.solvers.bicgstab import bicgstab
    from gmres_tpu_torch.solvers.cg import cg

    dev = _device(args)
    solver = cg if solver_name == "cg" else bicgstab
    records = []
    for n in _grid_range(args.grids):
        op = poisson_operator(n)
        m_inv = chebyshev_preconditioner(op, *REF_EIG)
        x_true = _ones((n, n), dev)
        b = op(x_true)
        res, dt = _timed(lambda: solver(
            op, b, tol=args.tol, max_iterations=args.max_iterations,
            M=m_inv), dev)
        # A and the A inside M: 2 per CG iteration, 4 per BiCGSTAB one.
        matvecs_per_iter = 2 if solver_name == "cg" else 4
        records.append(_record(
            f"p{solver_name}-{n}x{n}", res, x_true=x_true, wall_s=dt,
            tol=args.tol, nnz=5 * n * n - 4 * n,
            extra={"matvecs": matvecs_per_iter * int(res.iterations),
                   "host_syncs": res.host_syncs}))
    _emit(records, args)
    return records


def cmd_cg(args):
    return _sweep(args, "cg")


def cmd_bicgstab(args):
    return _sweep(args, "bicgstab")


def convdiff_problem(n: int, dev: torch.device, *, gamma_x=0.4, gamma_y=0.2,
                     solver="bicgstab", precond="none", precision="f64",
                     smoother="jacobi", tol=1e-9, max_iterations=10_000, ell=2,
                     poly_degree=24, idrs_s=8):
    """The ``convdiff`` program's problem on ``dev``: the operator, b = A·1,
    the preconditioner (None, the multigrid cycle or the GMRES polynomial)
    and a closure that solves once, as the program configures them (its
    flags as keyword arguments). Mixed BiCGSTAB runs a float32 cycle
    (internal_dtype); mixed GMRES casts M's input to its float32 Arnoldi
    dtype itself. BiCGStab(ℓ) maps its solution through M, so M's precision
    caps its accuracy: it keeps a float64 cycle, as in JAX."""
    from gmres_tpu_torch.models.convection_diffusion import (
        convection_diffusion_operator,
    )
    from gmres_tpu_torch.precond.multigrid import (
        convection_diffusion_multigrid_preconditioner,
    )
    from gmres_tpu_torch.precond.polynomial import gmres_polynomial_preconditioner
    from gmres_tpu_torch.solvers.bicgstab import bicgstab
    from gmres_tpu_torch.solvers.bicgstabl import bicgstabl
    from gmres_tpu_torch.solvers.cgs import cgs
    from gmres_tpu_torch.solvers.gmres import gmres
    from gmres_tpu_torch.solvers.idrs import idrs
    from gmres_tpu_torch.solvers.tfqmr import tfqmr

    from gmres_tpu_torch.solvers.qmr import qmr

    if solver == "qmr" and precond == "mg":
        raise SystemExit(QMR_MG_EXIT)
    op = convection_diffusion_operator(n, gamma_x, gamma_y)
    b = op(_ones((n, n), dev))
    mixed = precision == "mixed"
    m_inv = None
    if precond == "mg":
        m_inv = convection_diffusion_multigrid_preconditioner(
            n, gamma_x, gamma_y, smoother=smoother,
            internal_dtype=torch.float32 if mixed and solver == "bicgstab" else None)
    elif precond == "poly":
        m_inv = gmres_polynomial_preconditioner(op, b, degree=poly_degree)
    if solver == "gmres":
        def solve():
            return gmres(op, b, restart=CONVDIFF_RESTART, tol=tol, M=m_inv,
                         certify="true", compute_v_err=False,
                         inner_dtype=torch.float32 if mixed else None,
                         max_restarts=max(max_iterations // CONVDIFF_RESTART, 1))
    else:
        fn = {"bicgstab": bicgstab, "bicgstabl": bicgstabl, "cgs": cgs,
              "tfqmr": tfqmr, "idrs": idrs, "qmr": qmr}[solver]
        kw = {"ell": ell} if solver == "bicgstabl" else {}
        if solver == "idrs":
            kw = {"s": idrs_s}

        def solve():
            return fn(op, b, tol=tol, max_iterations=max_iterations, M=m_inv, **kw)
    return op, b, m_inv, solve


def cmd_convdiff(args):
    """BASELINE config 3: the nonsymmetric convection-diffusion stencil at
    ``--nsize``, b = A·1, solved to an absolute ``--tol`` (GMRES: relative,
    certified on the true residual) with no preconditioner, the multigrid
    cycle (``--precond mg``, ``--smoother``) or the degree-``--poly-degree``
    GMRES polynomial (``--precond poly``); ``--precision mixed`` runs the
    cycle in float32 under BiCGSTAB and the Arnoldi cycles in float32 under
    GMRES (see ``convdiff_problem``); ``--solver idrs`` runs IDR(``--idrs-s``).
    ``--solver qmr`` takes Aᵀ from ``torch.func.vjp`` of the operator (K1's
    backward rule on the card); with ``--precond mg`` it exits with JAX's
    message, as the cycle has no transpose rule."""
    dev = _device(args)
    n = args.nsize
    _, _, _, solve = convdiff_problem(
        n, dev, gamma_x=args.gamma_x, gamma_y=args.gamma_y, solver=args.solver,
        precond=args.precond, precision=args.precision, smoother=args.smoother,
        tol=args.tol, max_iterations=args.max_iterations, ell=args.ell,
        poly_degree=args.poly_degree, idrs_s=args.idrs_s)
    res, dt = _timed(solve, dev)
    # Operator applications, counted as the JAX program counts them: GMRES
    # one an inner iteration and one a restart cycle (its certified
    # residual), BiCGStab(ℓ) 2ℓ a cycle, IDR(s) s+1 an outer iteration, the
    # others 2 an iteration (QMR: A and Aᵀ).
    if args.solver == "gmres":
        matvecs = _total_inner(res, CONVDIFF_RESTART) + int(res.restarts)
    elif args.solver == "idrs":
        matvecs = (args.idrs_s + 1) * int(res.iterations)
    else:
        matvecs = (2 * args.ell if args.solver == "bicgstabl" else 2) * int(res.iterations)
    records = [_record(
        f"{args.solver}-convdiff-{n}x{n}", res, x_true=_ones((n, n), dev), wall_s=dt,
        tol=args.tol, nnz=5 * n * n - 4 * n,
        extra={"matvecs": matvecs,
               "precision": args.precision, "smoother": args.smoother,
               "host_syncs": res.host_syncs})]
    _emit(records, args)
    return records


def cmd_bratu(args):
    """Jacobian-free Newton-Krylov (solvers/newton_krylov.py) on the 2-D
    Bratu problem (models/bratu.py) from u₀ = 0, with the frozen Poisson
    multigrid cycle as M (``--precond mg``), the gmres (FGMRES with M) or
    gcrodr inner solver, float32 inner bases with ``--precision mixed``."""
    from gmres_tpu_torch.models.bratu import bratu_residual
    from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner
    from gmres_tpu_torch.solvers.newton_krylov import newton_krylov

    dev = _device(args)
    n = args.nsize
    F = bratu_residual(n, args.lam)
    m_inv = poisson_multigrid_preconditioner(n) if args.precond == "mg" else None
    mixed = args.precision == "mixed"
    u0 = torch.zeros((n, n), dtype=torch.float64, device=dev)
    res, dt = _timed(lambda: newton_krylov(
        F, u0, tol=args.tol, M=m_inv, inner=args.inner,
        inner_dtype=torch.float32 if mixed else None,
        max_newton=args.max_newton), dev)
    records = [_record(
        f"jfnk-bratu-{n}x{n}", res, wall_s=dt, tol=args.tol, nnz=5 * n * n - 4 * n,
        extra={"lam": args.lam, "newton_steps": int(res.iterations),
               "inner_iterations": int(res.inner_iterations), "inner": args.inner,
               "precision": args.precision, "precond": args.precond,
               "jv_products": res.jv_products, "host_syncs": res.host_syncs})]
    _emit(records, args)
    return records


def _helmholtz_csl(args, dev, n, kh2):
    """The helmholtz program's complex route (``--precond csl`` or
    ``--damping`` > 0): GMRES (MGSR, certified on the true residual) or
    GCRO-DR with the CSL cycle, on the complex operator (complex128, or
    complex64 with ``--precision f32|c64|mixed``) or, with ``--precision
    split``, on the real (2, N, N) stack with float32 cycles and float64
    certification (JAX's TPU route). ``--chunks`` > 1 continues an
    unconverged solve from its x (and GCRO-DR's recycle block)."""
    from gmres_tpu_torch.models.helmholtz import (
        helmholtz_operator,
        helmholtz_split_operator,
    )
    from gmres_tpu_torch.precond.multigrid import csl_multigrid_preconditioner
    from gmres_tpu_torch.solvers.gcrodr import gcrodr
    from gmres_tpu_torch.solvers.gmres import gmres

    split = args.precision == "split"
    if split:
        op = helmholtz_split_operator(n, kh2, args.damping)
        x_true = torch.stack([_ones((n, n), dev), torch.zeros((n, n), dtype=torch.float64,
                                                               device=dev)])
        m_inv = csl_multigrid_preconditioner(n, kh2, layout="split")
        restart = args.restart if args.restart > 0 else 120
        inner_dtype = torch.float32
        precision = "split-f64"
    else:
        cdtype = (torch.complex64 if args.precision in ("f32", "c64", "mixed")
                  else torch.complex128)
        op = helmholtz_operator(n, kh2, args.damping)
        x_true = torch.ones((n, n), dtype=cdtype, device=dev)
        m_inv = csl_multigrid_preconditioner(n, kh2)
        restart = args.restart if args.restart > 0 else 60
        inner_dtype = None
        precision = str(cdtype).replace("torch.", "")
    b = op(x_true)
    use_gcrodr = args.solver == "gcrodr"
    max_restarts = max(args.max_iterations // restart, 1)
    k_rec = max(args.deflate, 1)
    x0 = torch.zeros_like(b)
    recycle = torch.zeros((k_rec,) + tuple(b.shape), dtype=b.dtype, device=dev)

    def solve(x0, recycle):
        if use_gcrodr:
            return gcrodr(op, b, x0=x0, recycle=recycle, k=k_rec, restart=restart,
                          tol=args.tol, M=m_inv, inner_dtype=inner_dtype,
                          max_restarts=max_restarts)
        return gmres(op, b, x0=x0, restart=restart, tol=args.tol, M=m_inv,
                     variant="mgsr", certify="true", compute_v_err=False,
                     inner_dtype=inner_dtype, max_restarts=max_restarts)

    total_inner = total_restarts = chunks_used = 0
    dt = 0.0
    for chunk in range(max(args.chunks, 1)):
        if chunk == 0:
            res, dt_c = _timed(lambda: solve(x0, recycle), dev)
        else:
            t0 = time.perf_counter()
            res = solve(x0, recycle)
            _synchronize(dev)
            dt_c = time.perf_counter() - t0
        dt += dt_c
        chunks_used += 1
        # gmres_tpu's count for both arms: restart steps a cycle. GCRO-DR
        # runs restart − k steps a recycled cycle, so its rows overstate
        # the steps (ROADMAP queue 3; mirrored so that rows compare).
        total_inner += _total_inner(res, restart)
        total_restarts += int(res.restarts)
        x0 = res.x
        if use_gcrodr:
            recycle = res.recycle
        if int(res.status) == 0:
            break
    name = "gcrodr" if use_gcrodr else "gmres"
    extra = {"matvecs": total_inner + total_restarts, "total_inner": total_inner,
             "dispatch_chunks": chunks_used, "kh2": kh2, "damping": args.damping,
             "precond": "csl", "precision": precision, "host_syncs": res.host_syncs}
    if use_gcrodr:
        extra["deflate_k"] = k_rec
    return [_record(f"{name}-csl-helmholtz-{n}x{n}", res, x_true=x_true, wall_s=dt,
                    tol=args.tol, nnz=5 * n * n - 4 * n, extra=extra)]


def cmd_helmholtz(args):
    """The symmetric-indefinite Helmholtz stencil (models/helmholtz.py),
    b = A·1: MINRES (or GMRES(30), ``--solver gmres``) with the SPD
    shifted-Laplacian cycle (``--precond mg``; a float32 cycle with
    ``--precision mixed``) or none; with ``--precond csl`` or ``--damping`` >
    0, the complex route (``_helmholtz_csl``). (kh)² is ``--kh2`` where
    positive, else ``--kh2-factor`` times the grid's smallest Laplacian
    eigenvalue. ``--solver gcrodr`` runs only on the complex route; on the
    real one the program exits, where gmres_tpu's runs MINRES and names the
    row gcrodr (ROADMAP queue 3)."""
    from gmres_tpu_torch.models.helmholtz import helmholtz_lambda_min, helmholtz_operator
    from gmres_tpu_torch.precond.multigrid import (
        helmholtz_shifted_laplacian_preconditioner,
    )
    from gmres_tpu_torch.solvers.gmres import gmres
    from gmres_tpu_torch.solvers.minres import minres

    dev = _device(args)
    n = args.nsize
    kh2 = args.kh2 if args.kh2 > 0 else args.kh2_factor * helmholtz_lambda_min(n, 0.0)
    if args.precond == "csl" or args.damping > 0:
        records = _helmholtz_csl(args, dev, n, kh2)
        _emit(records, args)
        return records
    if args.solver == "gcrodr":
        raise SystemExit(
            "helmholtz --solver gcrodr runs on the CSL route only (--precond csl "
            "or --damping > 0); the real route runs minres or gmres (gmres_tpu's "
            "program runs MINRES here and names the row gcrodr)")
    op = helmholtz_operator(n, kh2)
    x_true = _ones((n, n), dev)
    b = op(x_true)
    mixed = args.precision == "mixed"
    m_inv = None
    if args.precond == "mg":
        # The float32 cast lives inside the cycle (MINRES's Lanczos runs on
        # whatever M returns).
        m_inv = helmholtz_shifted_laplacian_preconditioner(
            n, kh2, smooth_order=args.smooth_order,
            internal_dtype=torch.float32 if mixed else None)
    if args.solver == "gmres":
        res, dt = _timed(lambda: gmres(
            op, b, restart=30, tol=args.tol, M=m_inv, certify="true",
            compute_v_err=False, inner_dtype=torch.float32 if mixed else None,
            max_restarts=max(args.max_iterations // 30, 1)), dev)
        matvecs = _total_inner(res, 30) + int(res.restarts)
    else:
        res, dt = _timed(lambda: minres(op, b, tol=args.tol,
                                        max_iterations=args.max_iterations, M=m_inv), dev)
        matvecs = int(res.iterations) + 1  # one an iteration, one certification
    records = [_record(
        f"{args.solver}-helmholtz-{n}x{n}", res, x_true=x_true, wall_s=dt, tol=args.tol,
        nnz=5 * n * n - 4 * n,
        extra={"matvecs": matvecs, "kh2": kh2, "precision": args.precision,
               "precond": args.precond, "host_syncs": res.host_syncs})]
    _emit(records, args)
    return records


def cmd_sequence(args):
    """Krylov recycling over a frequency sweep of indefinite Helmholtz
    systems (kh2 = factor·λ_min for each factor of ``--kh2-factors``), one
    right-hand side b (numpy seed 0): GCRO-DR fresh, and warm-started from
    the previous frequency's recycle block; plain GMRES too with
    ``--with-gmres``."""
    from gmres_tpu_torch.models.helmholtz import helmholtz_lambda_min, helmholtz_operator
    from gmres_tpu_torch.solvers.gcrodr import gcrodr
    from gmres_tpu_torch.solvers.gmres import gmres

    dev = _device(args)
    n = args.nsize
    lam_min = helmholtz_lambda_min(n)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal((n, n))).to(dev)
    records = []
    recycle = None
    for fac in (float(v) for v in args.kh2_factors.split(",")):
        op = helmholtz_operator(n, fac * lam_min)

        def run(name, solve):
            res, dt = _timed(solve, dev)
            records.append(_record(
                f"{name}-helmholtz-{n}x{n}", res, wall_s=dt, tol=args.tol,
                nnz=5 * n * n - 4 * n,
                extra={"kh2_factor": fac, "k": args.k, "restart": args.restart,
                       "host_syncs": res.host_syncs}))
            return res

        if args.with_gmres:
            run("gmres", lambda op=op: gmres(op, b, restart=args.restart, tol=args.tol,
                                             max_restarts=args.max_restarts,
                                             compute_v_err=False))
        run("gcrodr-fresh", lambda op=op: gcrodr(op, b, k=args.k, restart=args.restart,
                                                 tol=args.tol,
                                                 max_restarts=args.max_restarts))
        warm = run("gcrodr-warm", lambda op=op, rec=recycle: gcrodr(
            op, b, k=args.k, restart=args.restart, tol=args.tol,
            max_restarts=args.max_restarts, recycle=rec))
        recycle = warm.recycle
    _emit(records, args)
    return records


@contextlib.contextmanager
def _process_group(dev: torch.device):
    """The default process group: the caller's (``torchrun``'s, or one made
    before the call), or a one-rank group made here and destroyed on exit
    (NCCL for the card, gloo for the CPU)."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                                    rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _scaling_meshes(max_devices: int, dev: torch.device, sizes):
    """(d, n, mesh) for each device count d of the sweep whose grid n
    (``sizes(d)``, None to skip d) is to run, the mesh over the first d
    ranks; every rank builds every mesh (a collective), and only the ranks
    inside it get the entry."""
    from gmres_tpu_torch.parallel.mesh import solver_mesh

    world = dist.get_world_size()
    for d in range(1, min(max_devices or world, world) + 1):
        n = sizes(d)
        if n is None:
            continue
        mesh = solver_mesh(d, device_type=dev.type)
        if mesh.get_coordinate() is not None:
            yield d, n, mesh


def _scaling_solve(args, n, mesh, dev, m_inv=None, shard=True):
    """MGSR GMRES on the halo operator over ``mesh`` with cbpr2 over it (or
    ``m_inv``); b = A·1 row-sharded over the mesh (``shard``) or plain."""
    from gmres_tpu_torch.models.poisson import poisson_apply
    from gmres_tpu_torch.parallel.halo import halo_poisson_operator
    from gmres_tpu_torch.parallel.mesh import shard_grid_vector
    from gmres_tpu_torch.precond.chebyshev import chebyshev_preconditioner
    from gmres_tpu_torch.solvers.gmres import gmres

    op = halo_poisson_operator(mesh)
    if m_inv is None:
        m_inv = chebyshev_preconditioner(op, *REF_EIG)
    b = poisson_apply(_ones((n, n), dev))
    if shard:
        b = shard_grid_vector(b, mesh)
    return _timed(lambda: gmres(
        op, b, restart=args.restart, tol=args.tol, M=m_inv, variant="mgsr",
        max_restarts=args.max_restarts, compute_v_err=False), dev)


def _caveat(dev: torch.device) -> dict:
    if dev.type == "cpu":
        return {"caveat": "cpu: gloo processes on shared host cores; the time "
                "columns measure no card and no NCCL communication"}
    return {"device": torch.cuda.get_device_name(dev)}


def cmd_strong_scaling(args):
    """Fixed grid, growing device count (the reference sweeps OpenMP
    threads 1..6, strong_scaling.f90:44-45)."""
    dev = _device(args)
    n, m = args.nsize, args.restart
    records = []
    with _process_group(dev):
        base_t = None
        for d, _, mesh in _scaling_meshes(
                args.max_devices, dev, lambda d: n if n % d == 0 else None):
            res, dt = _scaling_solve(args, n, mesh, dev)
            if base_t is None:
                base_t = dt
            extra = {"devices": d, "speedup": base_t / dt,
                     "efficiency": base_t / dt / d,
                     "total_iters": _total_inner(res, m), **_caveat(dev)}
            records.append(_record(
                f"gmres-mgsr-{d}dev", res, wall_s=dt, tol=args.tol,
                nnz=5 * n * n - 4 * n, extra=extra))
        _emit(records, args)
    return records


def cmd_weak_scaling(args):
    """True weak scaling: the rows grow with the device count (the line the
    reference commented out, weak_scaling.f90:60), d = 1, 2, 4, …

    ``--precond mg`` (the default) keeps the iteration count flat across
    rows. At d > 1 it is the distributed V-cycle
    (``poisson_multigrid_preconditioner(mesh=…)``, as in JAX) on a
    row-sharded b. At d = 1 it is the plain cycle, as in JAX, and takes b
    as a plain tensor (its whole-grid kernels need a plain tensor's
    storage); the halo operator takes it as the one rank's block."""
    from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner

    dev = _device(args)
    m = args.restart
    records = []
    with _process_group(dev):
        base = base_work = None

        def grid(d):
            return args.nsize_per_device * d if d & (d - 1) == 0 else None

        for d, n, mesh in _scaling_meshes(args.max_devices, dev, grid):
            m_inv = None
            if args.precond == "mg":
                m_inv = poisson_multigrid_preconditioner(
                    n, mesh=mesh if d > 1 else None)
            res, dt = _scaling_solve(args, n, mesh, dev, m_inv=m_inv,
                                     shard=args.precond != "mg" or d > 1)
            iters = _total_inner(res, m)
            per_iter = dt / max(iters, 1)
            if base is None:
                base, base_work = per_iter, n * n / d
            # Constant rows per device on a 2-D grid means the work per
            # device grows ∝ d: normalise by it.
            expected = base * (n * n / d) / base_work
            extra = {"devices": d, "precond": args.precond,
                     "total_iters": iters, "time_per_iter": per_iter,
                     "work_per_device": n * n // d,
                     "weak_efficiency": expected / per_iter, **_caveat(dev)}
            records.append(_record(
                f"gmres-mgsr-{args.precond}-{d}dev-{n}x{n}", res, wall_s=dt,
                tol=args.tol, nnz=5 * n * n - 4 * n, extra=extra))
        _emit(records, args)
    return records


def cmd_restart_sweep(args):
    """The reference's 'weak_scaling' program: fixed grid, m = start,
    start+step, … (weak_scaling.f90:24,61), Householder GMRES with cbpr2,
    or with ``--solver lgmres`` (``--aug``) or ``gmres-dr`` (``--deflate``)
    the same cbpr2 applied on the right.

    --cycle-reps K > 0 adds a per-cycle time per m: a run of exactly K
    cycles (tol 1e-30 never converges) timed --repeats times, the minimum
    over K; derived_wall_s is that times the cycles of the solve."""
    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.precond.chebyshev import chebyshev_preconditioner
    from gmres_tpu_torch.solvers.gmres import gmres
    from gmres_tpu_torch.solvers.gmres_dr import gmres_dr
    from gmres_tpu_torch.solvers.lgmres import lgmres

    dev = _device(args)
    n = args.nsize
    op = poisson_operator(n)
    m_inv = chebyshev_preconditioner(op, *REF_EIG)
    x_true = _ones((n, n), dev)
    b = op(x_true)

    def solve_fn(mm, tol, max_restarts):
        if args.solver == "lgmres":
            return lambda: lgmres(op, b, restart=mm, aug=args.aug, tol=tol, M=m_inv,
                                  max_restarts=max_restarts)
        if args.solver == "gmres-dr":
            return lambda: gmres_dr(op, b, restart=mm, deflate=args.deflate, tol=tol,
                                    M=m_inv, max_restarts=max_restarts)
        return lambda: gmres(op, b, restart=mm, tol=tol, M=m_inv,
                             variant="householder", max_restarts=max_restarts,
                             compute_v_err=False)

    label_base = {"lgmres": f"lgmres{args.aug}",
                  "gmres-dr": f"gmres-dr{args.deflate}"}.get(args.solver, "gmres-hh")
    records = []
    for i in range(args.ntests):
        m = args.start + i * args.step
        res, dt = _timed(solve_fn(m, args.tol, args.max_restarts), dev)
        extra = {"restart_m": m, "total_iters": _total_inner(res, m)}
        if args.cycle_reps:
            fnc = solve_fn(m, 1e-30, args.cycle_reps)
            fnc()  # warm once
            ts = []
            for _ in range(max(args.repeats, 1)):
                _synchronize(dev)
                t0 = time.perf_counter()
                fnc()
                _synchronize(dev)
                ts.append(time.perf_counter() - t0)
            per_cycle = min(ts) / args.cycle_reps
            # the final cycle exits after `iterations` of m inner steps
            cycles = max(int(res.restarts) - 1, 0) + int(res.iterations) / m
            extra.update({
                "time_per_cycle": per_cycle,
                "time_per_cycle_spread": (max(ts) - min(ts)) / max(min(ts), 1e-30),
                "cycle_reps": args.cycle_reps,
                "timing_repeats": max(args.repeats, 1),
                "derived_wall_s": per_cycle * cycles,
            })
        records.append(_record(
            f"{label_base}-m{m}", res, x_true=x_true, wall_s=dt, tol=args.tol,
            nnz=5 * n * n - 4 * n, extra=extra))
    _emit(records, args)
    return records


def cmd_multirhs(args):
    """Multi-RHS amortisation sweep: s stacked Poisson right-hand sides
    b_i = A x_i (x_i standard normal, numpy seed 0, drawn in turn for each
    s of ``--s-list``) solved together by block CG (``--solver block-cg``,
    JAX's default: absolute ``--tol`` per right-hand side, at most
    ``--max-iterations`` block iterations) or block GMRES (relative
    ``--tol``, restart ``--restart``), with the multigrid V-cycle as M
    (``--precond mg``; anything else runs without one, as in JAX); the time
    per RHS and the amortisation against the s = 1 row. On the card each
    block application of A and of M runs s single-vector applications (one
    launch of their kernels per row), where JAX's ``vmap`` batches them."""
    import types

    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner
    from gmres_tpu_torch.solvers.block_cg import block_cg
    from gmres_tpu_torch.solvers.block_gmres import block_gmres

    dev = _device(args)
    n = args.nsize
    op = poisson_operator(n)
    m_inv = poisson_multigrid_preconditioner(n) if args.precond == "mg" else None
    rng = np.random.default_rng(0)
    records = []
    base_per_rhs = None
    for s in (int(v) for v in args.s_list.split(",")):
        xs = torch.as_tensor(rng.standard_normal((s, n, n))).to(dev)
        B = torch.stack([op(xs[i]) for i in range(s)])
        if args.solver == "block-gmres":
            res, dt = _timed(lambda: block_gmres(
                op, B, restart=args.restart, tol=args.tol, M=m_inv,
                max_restarts=args.max_restarts), dev)
            # Block GMRES counts restart cycles: its row's iterations are
            # restarts·m, as in JAX's program.
            row = types.SimpleNamespace(x=res.x, restarts=res.restarts,
                                        iterations=res.restarts * args.restart,
                                        residual=res.residual, status=res.status)
        else:
            res, dt = _timed(lambda: block_cg(
                op, B, tol=args.tol, M=m_inv,
                max_iterations=args.max_iterations), dev)
            row = res
        per_rhs = dt / s
        if base_per_rhs is None:
            base_per_rhs = per_rhs
        records.append(_record(
            f"{args.solver}-poisson-{n}x{n}-s{s}", row, wall_s=dt, tol=args.tol,
            nnz=5 * n * n - 4 * n,
            extra={"s": s, "time_per_rhs": per_rhs,
                   "amortization_vs_s1": base_per_rhs / per_rhs,
                   "precond": args.precond,
                   "max_rhs_residual": float(res.residual),
                   "host_syncs": res.host_syncs}))
    _emit(records, args)
    return records


def _program_normal(shape, dtype, dev) -> torch.Tensor:
    """The eig program's standard-normal start (the Krylov–Schur probe, the
    LOBPCG block): a CPU torch.Generator seeded 0, drawn in float64, where
    JAX draws from PRNGKey(0) (no torch counterpart)."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float64).to(dev, dtype)


def _keyed(v: np.ndarray) -> np.ndarray:
    """Eigenvalues as a multiset free of the conjugate pair's sign: sorted by
    (real, |imag|)."""
    return np.sort_complex(v.real + 1j * np.abs(v.imag))


def eig_row(args, dev):
    """The eig program's solve and its row (the closed-form spectrum as the
    reference): (row, result)."""
    import math

    from gmres_tpu_torch.models.convection_diffusion import (
        convection_diffusion_eigenvalues,
        convection_diffusion_operator,
    )

    n, k = args.nsize, args.k
    nnz = 5 * n * n - 4 * n
    if args.method == "lobpcg":
        from gmres_tpu_torch.models.poisson import poisson_operator
        from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner
        from gmres_tpu_torch.solvers.lobpcg import lobpcg

        op = poisson_operator(n)
        m_inv = poisson_multigrid_preconditioner(n) if args.precond == "mg" else None
        x0 = _program_normal((k, n, n), torch.float64, dev)
        res, dt = _timed(lambda: lobpcg(op, x0, tol=args.tol, rtol=args.rtol,
                                        max_iterations=args.max_iterations, M=m_inv), dev)
        lam = np.sort(res.eigenvalues.cpu().numpy())
        # Candidates with i, j ≤ k+1 contain the k smallest.
        m_idx = min(n, k + 1)
        exact = np.sort([4.0 - 2 * math.cos(i * math.pi / (n + 1))
                         - 2 * math.cos(j * math.pi / (n + 1))
                         for i in range(1, m_idx + 1) for j in range(1, m_idx + 1)])[:k]
        row = RunRecord(
            name=f"lobpcg-poisson-{n}x{n}", nvars=n * n, iterations=int(res.iterations),
            tol=args.tol, residual=float(torch.max(res.residuals)),
            l2_error=float(np.linalg.norm(lam - exact)),
            linf_error=float(np.max(np.abs(lam - exact))), wall_s=dt, nnz=nnz,
            extra={"k": k, "eigenvalues": [float(v) for v in lam], "precond": args.precond,
                   "converged": bool(res.converged), "status": int(res.status),
                   "host_syncs": res.host_syncs})
        return row, res
    op = convection_diffusion_operator(n, args.gamma_x, args.gamma_y)
    single = args.precision in (("f32", "c64", "mixed") if args.method == "arnoldi"
                                else ("f32", "mixed"))
    pdtype = torch.float32 if single else torch.float64
    if args.method == "subspace":
        from gmres_tpu_torch.solvers.subspace_eigs import subspace_eigs

        probe = torch.ones((n, n), dtype=pdtype, device=dev)
        res, dt = _timed(lambda: subspace_eigs(op, probe, nev=k, guard=6,
                                               iters=args.max_iterations, tol=args.tol), dev)
        name = f"subspace-eigs-convdiff-{n}x{n}"
        extra = {"k": k, "which": "LM"}
    else:
        if args.method == "ks_real":
            from gmres_tpu_torch.solvers.krylov_schur_real import arnoldi_eigs_real as fn

            name = f"ksreal-convdiff-{n}x{n}"
        else:
            from gmres_tpu_torch.solvers.arnoldi import arnoldi_eigs as fn

            name = f"krylovschur-convdiff-{n}x{n}"
        probe = _program_normal((n, n), pdtype, dev)
        res, dt = _timed(lambda: fn(op, probe, nev=k, steps=args.steps, which="LM",
                                    tol=args.tol, max_restarts=args.max_iterations), dev)
        extra = {"k": k, "which": "LM", "steps": args.steps}
    got = res.eigenvalues.cpu().numpy()
    exact = convection_diffusion_eigenvalues(n, args.gamma_x, args.gamma_y)
    exact = exact[np.argsort(-np.abs(exact))][:k]
    err = np.abs(_keyed(got) - _keyed(exact))
    row = RunRecord(
        name=name, nvars=n * n, iterations=int(res.iterations), tol=args.tol,
        residual=float(torch.max(res.residuals)), l2_error=float(np.linalg.norm(err)),
        linf_error=float(np.max(err)), wall_s=dt, nnz=nnz,
        extra={**extra, "gamma": [args.gamma_x, args.gamma_y],
               "eigenvalues": [[float(v.real), float(v.imag)] for v in got],
               "precision": str(pdtype).replace("torch.", ""),
               "converged": bool(res.converged), "status": int(res.status),
               "host_syncs": res.host_syncs})
    return row, res


def cmd_eig(args):
    """Eigenpairs against closed-form spectra: ``--method lobpcg`` (the k
    smallest Poisson pairs by LOBPCG with the multigrid cycle as M),
    ``arnoldi`` (the k largest-modulus pairs of the nonsymmetric
    convection-diffusion operator by Krylov–Schur on a complex basis: on the
    card, 2 K1 launches a complex matvec), ``ks_real`` (the same pairs by
    Krylov–Schur on a real Schur basis) or ``subspace`` (real subspace
    iteration, estimation grade on clustered moduli). The start block is a
    torch Generator's (seed 0), where JAX's is PRNGKey(0)'s."""
    dev = _device(args)
    row, _ = eig_row(args, dev)
    _emit([row], args)
    return [row]


def cmd_slq(args):
    """Stochastic Lanczos quadrature of log det A = tr log A on the Poisson
    operator at ``--nsize``: one row per probe count of ``--probes-list``
    with the value, its Monte-Carlo standard error and the time per probe
    (probes: a torch Generator seeded 0, where JAX's are PRNGKey(0)'s)."""
    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.solvers.funm import trace_funm

    dev = _device(args)
    n = args.nsize
    op = poisson_operator(n)
    x_like = torch.zeros((n, n), dtype=torch.float64, device=dev)
    records = []
    for p in (int(v) for v in args.probes_list.split(",")):
        out, dt = _timed(lambda p=p: trace_funm(op, torch.log, x_like, n_probes=p,
                                               steps=args.steps, key=0), dev)
        value, stderr = float(out.value), float(out.stderr)
        records.append(RunRecord(
            name=f"slq-logdet-poisson-{n}x{n}-p{p}", nvars=n * n, iterations=args.steps,
            wall_s=dt, nnz=5 * n * n - 4 * n,
            extra={"n_probes": p, "value": value, "stderr": stderr,
                   "time_per_probe": dt / p,
                   "rel_stderr": stderr / max(abs(value), 1e-30),
                   "host_syncs": out.host_syncs}))
    _emit(records, args)
    return records


def evolve_problem(args, dev):
    """The evolve program's operator, u0 (numpy seed 0) and solve closure, as
    the program configures them; the closure passes its keyword arguments
    (``save_trajectory``) on to the integrator."""
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_operator
    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.precond.multigrid import (
        convection_diffusion_multigrid_preconditioner,
        helmholtz_shifted_laplacian_preconditioner,
    )
    from gmres_tpu_torch.solvers.evolve import exponential_evolve, theta_evolve

    n = args.nsize
    if args.model == "heat":
        L = poisson_operator(n)
    else:
        L = convection_diffusion_operator(n, args.gamma_x, args.gamma_y)
    u0 = torch.as_tensor(np.random.default_rng(0).standard_normal((n, n))).to(dev)
    if args.solver == "expm":
        if args.model != "heat":
            raise SystemExit("--solver expm needs the SPD heat model")
        return L, u0, lambda **kw: exponential_evolve(L, u0, dt=args.dt, n_steps=args.steps,
                                                      steps=args.expm_steps, **kw)
    M = None
    if args.precond == "mg":
        # S = I + θΔt·L = θΔt·(L + σI) with σ = 1/(θΔt): M_S(r) = cycle(r)/(θΔt)
        # with the σ-shifted cycle (JAX's program passes kh2 = −σ to the
        # Helmholtz cycle for the heat model; kept as it is).
        sigma = 1.0 / (args.theta * args.dt)
        if args.model == "convdiff":
            cyc = convection_diffusion_multigrid_preconditioner(
                n, args.gamma_x, args.gamma_y, shift=sigma)
        else:
            cyc = helmholtz_shifted_laplacian_preconditioner(n, -sigma)
        scale = args.theta * args.dt
        M = lambda r: cyc(r) / scale  # noqa: E731
    return L, u0, lambda **kw: theta_evolve(
        L, u0, dt=args.dt, n_steps=args.steps, theta=args.theta, solver=args.solver,
        tol=args.tol, restart=args.restart, recycle_k=args.k,
        max_restarts=args.max_restarts, max_iterations=args.max_iterations, M=M, **kw)


def cmd_evolve(args):
    """A trajectory of the heat equation (``--model heat``) or of
    convection-diffusion (``--model convdiff``, the default) by the θ-method
    with cg, bicgstab, gmres or gcrodr steps (GCRO-DR recycling across
    steps; ``--precond mg`` the σ-shifted cycle, σ = 1/(θΔt)), or by
    exponential Euler (``--solver expm``, heat only). u0 standard normal
    (numpy seed 0)."""
    import types

    dev = _device(args)
    n = args.nsize
    _, _, solve = evolve_problem(args, dev)
    res, dt_wall = _timed(solve, dev)
    if args.solver == "expm":
        iters = np.full((args.steps,), args.expm_steps)
        row = types.SimpleNamespace(
            x=res.u, iterations=args.expm_steps * args.steps,
            residual=float(torch.max(res.error_estimates)), status=0)
        converged = True
    else:
        iters = res.iterations.numpy()
        row = types.SimpleNamespace(x=res.u, iterations=res.inner_total,
                                    residual=float(torch.max(res.residuals)),
                                    status=res.status)
        converged = res.converged
    record = _record(
        f"evolve-{args.model}-{args.solver}-{n}x{n}", row, wall_s=dt_wall, tol=args.tol,
        nnz=5 * n * n - 4 * n,
        extra={"model": args.model, "solver": args.solver, "precond": args.precond,
               "theta": args.theta, "dt": args.dt, "n_steps": args.steps,
               "converged": bool(converged), "iters_step0": int(iters[0]),
               "iters_last": int(iters[-1]), "iters_mean": float(iters.mean()),
               "ms_per_step": dt_wall * 1e3 / args.steps,
               "host_syncs": res.host_syncs})
    _emit([record], args)
    return [record]


def varcoef_problem(n: int, contrast: float, dev: torch.device):
    """The ``varcoef`` program's problem on ``dev``: the coefficient field
    c (1 with two square inclusions of ``contrast``, the
    Vuik–Segal–Meijerink bubbly-flow shape), the operator, x_true (numpy
    ``default_rng(0)``), b = A·x_true, the Jacobi diagonal and the coarse
    block W of the two normalised inclusion indicators. The arrays are made
    in numpy and carried over with ``as_tensor``."""
    from gmres_tpu_torch.models.varcoef import varcoef_diagonal, varcoef_operator
    from gmres_tpu_torch.types import as_tensor

    c = np.ones((n, n))
    a1 = (slice(n // 6, 5 * n // 12), slice(n // 6, 5 * n // 12))
    a2 = (slice(7 * n // 12, 7 * n // 8), slice(13 * n // 24, 5 * n // 6))
    c[a1] = contrast
    c[a2] = contrast
    w = np.zeros((2, n, n))
    w[0][a1] = 1.0
    w[1][a2] = 1.0
    w /= np.linalg.norm(w.reshape(2, -1), axis=1)[:, None, None]
    c_t = as_tensor(c, dev)
    op = varcoef_operator(c_t)
    x_true = as_tensor(np.random.default_rng(0).standard_normal((n, n)), dev)
    return c_t, op, x_true, op(x_true), varcoef_diagonal(c_t), as_tensor(w, dev)


def varcoef_preconditioners(c, op, diag, w) -> dict:
    """The program's four preconditioners by row name: Jacobi, Jacobi with
    the coarse space, the varcoef cycle, the cycle with the coarse space."""
    from gmres_tpu_torch.models.varcoef import varcoef_multigrid_preconditioner
    from gmres_tpu_torch.precond.deflation import coarse_space_preconditioner

    def jacobi(r):
        return r / diag

    mg = varcoef_multigrid_preconditioner(c)
    return {"jacobi": jacobi,
            "jacobi+defl": coarse_space_preconditioner(op, w, M=jacobi),
            "mg": mg,
            "mg+defl": coarse_space_preconditioner(op, w, M=mg)}


def cmd_varcoef(args):
    """Heterogeneous media (models/varcoef.py): CG on −∇·(c∇u) with two
    square inclusions of ``--contrast``, tol ``--tol``·‖b‖ absolute, one row
    per preconditioner (jacobi, jacobi+defl, mg, mg+defl; +defl stacks the
    inclusion-indicator coarse space of precond/deflation.py on it). Read
    the rows by their L2/L∞ errors against x_true as well as by
    iterations: deflation pins the near-null inclusion modes."""
    from gmres_tpu_torch.solvers.cg import cg

    dev = _device(args)
    n = args.nsize
    c, op, x_true, b, diag, w = varcoef_problem(n, args.contrast, dev)
    tol = args.tol * float(torch.linalg.norm(b))
    records = []
    for name, m_inv in varcoef_preconditioners(c, op, diag, w).items():
        res, dt = _timed(lambda m_inv=m_inv: cg(
            op, b, tol=tol, max_iterations=args.max_iterations, M=m_inv), dev)
        records.append(_record(
            f"varcoef-{name}-{n}x{n}", res, x_true=x_true, wall_s=dt, tol=tol,
            nnz=5 * n * n - 4 * n,
            extra={"contrast": args.contrast, "precond": name,
                   "host_syncs": res.host_syncs}))
    _emit(records, args)
    return records


def cmd_roofline(args):
    """Achieved bandwidth (slope-timed chains, utils/profiling.py's
    measure_bandwidth) of the stencil routes, the order-k smoother and the
    multigrid V-cycle, with fraction-of-peak columns.

    Traffic: every row's bytes_moved is the IDEAL read-x + write-y traffic
    of one application (2·N²·itemsize; a (hi, lo) pair moves the bytes of
    float64; the V-cycle's is fine_equiv_sweeps × that; the smoother's
    (order − 1) × that, the work of as many plain stencil sweeps). K2 fuses
    the smoother's sweeps, so its row can read above 1.0 of that model; its
    ``fraction_of_single_pass`` is against the single pass the smoother
    needs (r read once, z written once).

    L2 residency: the chain re-applies fn to its own output, so when the
    working set (two copies of x) fits in the card's 50 MB L2 the reps after
    the first barely touch HBM: such rows are flagged ``l2_resident`` with
    a note (float32 1024² and 2048², float64 and pairs 1024²), and so is any
    row above the peak that carries no other traffic model. The honest HBM
    rows are float32 4096² and float64 and pairs 2048² and 4096². The kernel
    rows (K1, K6, K2) run on the card only, as JAX's run on the TPU only."""
    from gmres_tpu_torch.ops.dd import dd_from_f64
    from gmres_tpu_torch.ops.fused import (
        chebyshev_blocked_feasible,
        chebyshev_k_poisson_pallas_blocked,
    )
    from gmres_tpu_torch.ops.stencil import (
        stencil_5pt_apply,
        stencil_5pt_dd_pallas_blocked,
        stencil_5pt_pallas_blocked,
        stencil_blocked_feasible,
    )
    from gmres_tpu_torch.precond.multigrid import poisson_multigrid_preconditioner
    from gmres_tpu_torch.utils.profiling import measure_bandwidth

    dev = _device(args)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    records = []

    def bench(name, fn, x, traffic, extra=None):
        out = measure_bandwidth(fn, x, bytes_moved=traffic, reps=args.reps)
        leaves = list(x) if isinstance(x, tuple) else [x]
        nvars = max(t.numel() for t in leaves)
        e = {
            "matvecs": 1,
            "gbps": out["gbps"],
            "fraction_of_peak": out["fraction_of_peak"],
            "peak_gbps": out["peak_gbps"],
            "device": out["device"],
            "timing": out["timing"],
        }
        if extra:
            e.update(extra)
        working_set = 2 * sum(t.numel() * t.element_size() for t in leaves)
        if on_card and (
            working_set <= L2_BYTES
            or ((e["fraction_of_peak"] or 0) > PEAK_SLACK and "note" not in e)
        ):
            e["l2_resident"] = True
            e["l2_note"] = (
                "working set fits in the card's 50 MB L2: the chained reps "
                "re-use on-chip data, so this row measures L2 bandwidth, "
                "not HBM — read the largest grid for the HBM number"
            )
        records.append(RunRecord(name=name, nvars=nvars, iterations=1,
                                 wall_s=out["seconds"], nnz=5 * nvars, extra=e))

    for n in (int(s) for s in args.grids.split(",")):
        x64 = torch.as_tensor(rng.standard_normal((n, n))).to(dev)
        x32 = x64.to(torch.float32)
        t32 = 2 * x32.numel() * 4
        bench(f"stencil-plain-f32-{n}", stencil_5pt_apply, x32, t32)
        bench(f"stencil-plain-f64-{n}", stencil_5pt_apply, x64, 2 * x64.numel() * 8)
        if on_card and stencil_blocked_feasible(n):
            bench(f"stencil-pallas-blocked-f32-{n}", stencil_5pt_pallas_blocked,
                  x32, t32)
            # The float64 route on (hi, lo) float32 pairs, chained in pair
            # space (split once outside); hi + lo in and out moves the bytes
            # of the float64 row, so the fractions compare directly.
            bench(f"stencil-pallas-dd-f64-{n}",
                  lambda p: stencil_5pt_dd_pallas_blocked(p[0], p[1]),
                  dd_from_f64(x64), 2 * x64.numel() * 8,
                  extra={"note": "(hi, lo) float32 pairs, pair-space chain; "
                         "K6 works in native float64 (more accurate than the "
                         "TPU kernel's ~2^-48)"})
        k = args.cheb_order
        if on_card and chebyshev_blocked_feasible(n, k):
            bench(f"chebk{k}-blocked-f32-{n}",
                  lambda v, kk=k: chebyshev_k_poisson_pallas_blocked(v, kk, 0.005, 8.0),
                  x32, (k - 1) * t32,
                  extra={"sweeps_fused": k - 1,
                         "note": "traffic = (order-1) plain-equivalent sweeps; "
                         "K2 fuses the sweeps (one pass over r and z on its "
                         "tiled path), so this model can read above 1.0; "
                         "fraction_of_single_pass is against r read once and "
                         "z written once"})
            row = records[-1].extra
            row["fraction_of_single_pass"] = (
                row["fraction_of_peak"] / (k - 1) if row["fraction_of_peak"] else None)
        m_inv = poisson_multigrid_preconditioner(n)
        bench(f"mg-vcycle-f32-{n}", m_inv, x32,
              int(m_inv.fine_equiv_sweeps * t32),
              extra={"fine_equiv_sweeps": m_inv.fine_equiv_sweeps})
    _emit(records, args)
    # The table's seconds column hides microsecond kernels.
    if is_host0():
        print(f"{'row':<30} {'us/apply':>11} {'GB/s':>9} {'of peak':>8}  flags")
        for r in records:
            frac = r.extra["fraction_of_peak"]
            flags = " ".join(f for f in ("l2_resident", "note") if f in r.extra)
            if r.extra.get("fraction_of_single_pass") is not None:
                flags += f" single-pass {r.extra['fraction_of_single_pass']:.3f}"
            print(f"{r.name:<30} {r.wall_s * 1e6:>11.3f} {r.extra['gbps']:>9.1f} "
                  f"{'-' if frac is None else f'{frac:.3f}':>8}  {flags}")
    return records


def cmd_scale(args):
    """The production configuration across growing grids: Householder
    GMRES with the Poisson V-cycle, float32 Arnoldi cycles certified on the
    float64 true residual, b = A·1 (``--dim 3``: CG with the 3-D cycle at
    n³, absolute tol)."""
    from gmres_tpu_torch.models.poisson import poisson_operator
    from gmres_tpu_torch.models.poisson3d import poisson3d_operator
    from gmres_tpu_torch.precond.multigrid import (
        poisson3d_multigrid_preconditioner,
        poisson_multigrid_preconditioner,
    )
    from gmres_tpu_torch.solvers.cg import cg
    from gmres_tpu_torch.solvers.gmres import gmres

    dev = _device(args)
    grids = [int(s) for s in args.grids.split(",")]
    records = []
    for n in grids:
        if args.dim == 3:
            op = poisson3d_operator(n)
            m_inv = poisson3d_multigrid_preconditioner(n)
            b = op(_ones((n, n, n), dev))
            res, dt = _timed(lambda: cg(op, b, tol=args.tol, max_iterations=400,
                                        M=m_inv), dev)
            records.append(_record(
                f"cg-mg3d-{n}^3", res, wall_s=dt, tol=args.tol,
                nnz=7 * n ** 3 - 6 * n * n,
                extra={"dim": 3, "true_certified": True}))
            continue
        op = poisson_operator(n)
        m_inv = poisson_multigrid_preconditioner(n)
        b = op(_ones((n, n), dev))
        m = args.restart
        res, dt = _timed(lambda: gmres(
            op, b, restart=m, tol=args.tol, M=m_inv, variant="householder",
            compute_v_err=False, inner_dtype=torch.float32, certify="true"), dev)
        records.append(_record(
            f"gmres-hh-mg-ir-{n}x{n}", res, wall_s=dt, tol=args.tol,
            nnz=5 * n * n - 4 * n,
            extra={"total_iters": _total_inner(res, m), "true_certified": True}))
    _emit(records, args)
    return records


def cmd_spmv(args):
    """SpMV throughput (nnz/s) on the Poisson matrix: the plain stencil in
    float64 and float32 and the sparse formats' plain products, and on the
    card K1 (the stencil), K3 (DIA and HYB's DIA part) and, from 512² rows
    (n ≥ 256), K4 on a block-tridiagonal BSR of 128² blocks beside its
    einsum twin. Rows keep gmres_tpu's names, with the kernel's id where
    JAX's say ``pallas``. Each product is timed by
    ``utils/profiling.py:measure_bandwidth`` (the slope between chains of
    ``--reps`` and twice as many; on the card CUDA graphs between events,
    synchronised). JAX runs its Pallas rows on the TPU only and its stencil
    row only to 1024², a limit of the TPU's VMEM that the card does not
    share."""
    from gmres_tpu_torch.ops import sparse as sp
    from gmres_tpu_torch.ops.stencil import stencil_5pt_apply, stencil_5pt_pallas
    from gmres_tpu_torch.utils.profiling import measure_bandwidth

    dev = _device(args)
    on_card = dev.type == "cuda"
    n = args.nsize
    nnz = 5 * n * n - 4 * n  # interior 5, boundary truncated
    rng = np.random.default_rng(0)
    records = []

    def bench(name, fn, x, kernel_nnz=None):
        out = measure_bandwidth(fn, x, bytes_moved=2 * x.numel() * x.element_size(),
                                reps=args.reps)
        dt = out["seconds"]
        knnz = kernel_nnz if kernel_nnz is not None else nnz
        records.append(RunRecord(name=name, nvars=x.numel(), iterations=1, wall_s=dt,
                                 nnz=knnz, extra={"matvecs": 1,
                                                  "gnnz_per_s": knnz / dt / 1e9,
                                                  "timing": out["timing"]}))

    def f32(a):
        """The matrix with its values in float32 (indices shared)."""
        if isinstance(a, sp.HYBMatrix):
            return sp.HYBMatrix(dia=f32(a.dia), ell=None if a.ell is None else f32(a.ell),
                                shape=a.shape)
        return dataclasses.replace(a, data=a.data.to(torch.float32))

    def hyb_plain(a, x):
        """HYB with its DIA part in the plain roll version (JAX's shift row)."""
        y = sp.dia_spmv(a.dia, x)
        return y if a.ell is None else y + sp.ell_spmv(a.ell, x)

    xg64 = torch.as_tensor(rng.standard_normal((n, n))).to(dev)
    xg32 = xg64.to(torch.float32)
    bench("stencil-jnp-f64", stencil_5pt_apply, xg64)
    bench("stencil-jnp-f32", stencil_5pt_apply, xg32)
    if on_card:
        bench("stencil-k1-f32", stencil_5pt_pallas, xg32)
    if not args.skip_sparse:
        csr = sp.poisson_csr(n, device=dev)
        ell = sp.csr_to_ell(csr)
        xf = xg64.reshape(-1)
        bench("csr-segsum-f64", lambda x, a=csr: sp.csr_spmv(a, x), xf)
        bench("ell-gather-f64", lambda x, a=ell: sp.ell_spmv(a, x), xf)
        bench("ell-gather-f32", lambda x, a=f32(ell): sp.ell_spmv(a, x), xg32.reshape(-1))
        dia = sp.poisson_dia(n, device=dev)
        bench("dia-shift-f64", lambda x, a=dia: sp.dia_spmv(a, x), xf)
        dia32 = f32(dia)
        bench("dia-shift-f32", lambda x, a=dia32: sp.dia_spmv(a, x), xg32.reshape(-1))
        # CSR split into HYB: for the Poisson CSR the residue is empty, so
        # this is the CSR matrix at DIA speed.
        hyb32 = f32(sp.csr_to_hyb(csr))
        bench("csr2hyb-shift-f32", lambda x, a=hyb32: hyb_plain(a, x), xg32.reshape(-1))
        if on_card:
            bench("csr2hyb-k3-f32", lambda x, a=hyb32: sp.hyb_spmv(a, x),
                  xg32.reshape(-1))
            bench("dia-k3-f32", lambda x, a=dia32: sp.dia_spmv_pallas(a, x),
                  xg32.reshape(-1))
        if on_card and n >= 256:
            # Block-tridiagonal BSR of 128² blocks (JAX's MXU-tile size).
            bs = 128
            nb = n // bs * bs
            dense_b = np.zeros((nb, nb), np.float32)
            for i in range(nb // bs):
                for jj in (i - 1, i, i + 1):
                    if 0 <= jj < nb // bs:
                        dense_b[i * bs:(i + 1) * bs, jj * bs:(jj + 1) * bs] = (
                            rng.standard_normal((bs, bs)))
            bmat = sp.bsr_from_dense(dense_b, block_size=bs, device=dev)
            xb = torch.as_tensor(rng.standard_normal(nb).astype(np.float32)).to(dev)
            bsr_nnz = int(np.count_nonzero(dense_b))
            bench("bsr-k4-f32", lambda x, a=bmat: sp.bsr_spmv_pallas(a, x), xb,
                  kernel_nnz=bsr_nnz)
            bench("bsr-einsum-f32", lambda x, a=bmat: sp.bsr_spmv(a, x), xb,
                  kernel_nnz=bsr_nnz)
    # The standard table's ms resolution hides microsecond kernels.
    if is_host0():
        print(f"{'kernel':<22} {'us/apply':>10} {'Gnnz/s':>9}")
        for r in records:
            print(f"{r.name:<22} {r.wall_s * 1e6:>10.2f} {r.extra['gnnz_per_s']:>9.2f}")
    if getattr(args, "jsonl", None):
        write_jsonl(records, args.jsonl, append=True)
    return records


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmres-tpu-torch-bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--jsonl", help="append rows to this JSONL file")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, choices=None, help=None, **defaults):
        sp_ = sub.add_parser(name, help=help, description=help)
        sp_.set_defaults(func=fn)
        # SUPPRESS: without it the subparser's default would clobber a
        # top-level --jsonl given before the subcommand.
        sp_.add_argument("--jsonl", default=argparse.SUPPRESS)
        sp_.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                         help="the card (default) or the CPU")
        for k, v in defaults.items():
            flag = "--" + k.replace("_", "-")
            if isinstance(v, bool):
                sp_.add_argument(flag, action="store_true")
            else:
                sp_.add_argument(flag, type=type(v), default=v,
                                 choices=(choices or {}).get(k))
        return sp_

    add("dense-poisson", cmd_dense_poisson, nsize=16, restart=30,
        tol=1e-15, max_restarts=1000,
        help="dense Poisson matrix, MGSR vs Householder GMRES")
    add("hilbert", cmd_hilbert, n=12, restart=90, tol=1e-15,
        help="Hilbert matrix orthogonality A/B (one GMRES cycle each)")
    add("poisson-mf", cmd_poisson_mf, nsize=300, restart=50, tol=1e-15,
        max_restarts=1000, mixed=False, no_v_err=False,
        help="matrix-free Poisson, cbpr2, Householder vs MGSR GMRES")
    add("cg", cmd_cg, grids="300:1000:50", tol=1e-9, max_iterations=10_000,
        help="cbpr2 CG over a grid sweep (absolute tol)")
    add("bicgstab", cmd_bicgstab, grids="300:1000:50", tol=1e-9,
        max_iterations=10_000,
        help="cbpr2 BiCGSTAB over a grid sweep (absolute tol)")
    add("convdiff", cmd_convdiff, nsize=256, gamma_x=0.4, gamma_y=0.2,
        tol=1e-9, max_iterations=10_000, precond="none", solver="bicgstab",
        precision="f64", smoother="jacobi", ell=2, poly_degree=24, idrs_s=8,
        choices={"precond": ("none", "mg", "poly"), "solver": CONVDIFF_SOLVERS,
                 "precision": ("f64", "mixed"),
                 "smoother": ("jacobi", "chebyshev", "auto", "rbgs")},
        help="BASELINE config 3: nonsymmetric convection-diffusion, b = A·1, "
             "with the multigrid cycle or the GMRES polynomial; qmr with the "
             "cycle exits with gmres_tpu's message (no transpose rule)")
    add("bratu", cmd_bratu, nsize=256, lam=5.0, tol=1e-10, max_newton=30,
        precond="mg", precision="f64", inner="gmres",
        choices={"precond": ("mg", "none"), "precision": ("f64", "mixed"),
                 "inner": ("gmres", "gcrodr")},
        help="Jacobian-free Newton-Krylov on the Bratu problem, frozen Poisson "
             "multigrid M")
    add("helmholtz", cmd_helmholtz, nsize=256, kh2=0.0, kh2_factor=10.0, tol=1e-9,
        max_iterations=50_000, precond="mg", solver="minres", precision="f64",
        smooth_order=3, damping=0.0, chunks=1, restart=0, deflate=20,
        choices={"precond": ("mg", "csl", "none"), "solver": HELMHOLTZ_SOLVERS,
                 "precision": ("f64", "mixed", "split", "f32", "c64")},
        help="indefinite Helmholtz: MINRES/GMRES with the SPD shifted-Laplacian "
             "cycle, or GMRES/GCRO-DR with the CSL cycle (complex or split)")
    add("sequence", cmd_sequence, nsize=128, k=10, restart=40, tol=1e-8,
        max_restarts=400, kh2_factors="10.0,10.5,11.0", with_gmres=False,
        help="GCRO-DR fresh and warm over a Helmholtz frequency sweep")
    scaling_note = (" The halo operator runs at every d, with or without "
                    "--explicit-halo (no GSPMD partitioner in PyTorch).")
    add("strong-scaling", cmd_strong_scaling, nsize=304, restart=50,
        tol=1e-15, max_restarts=1000, max_devices=0, explicit_halo=False,
        help="fixed grid over 1..min(--max-devices, ranks) ranks (torchrun "
             "for several; alone, one rank), MGSR GMRES with cbpr2."
             + scaling_note)
    add("weak-scaling", cmd_weak_scaling, nsize_per_device=128, restart=50,
        tol=1e-12, max_restarts=1000, max_devices=0, explicit_halo=False,
        precond="mg", choices={"precond": ("mg", "chebyshev")},
        help="grid rows grow with the ranks d = 1, 2, 4, …; --precond mg "
             "at d > 1 is the distributed V-cycle." + scaling_note)
    add("restart-sweep", cmd_restart_sweep, nsize=280, start=20, step=5,
        ntests=10, tol=1e-15, max_restarts=1000, cycle_reps=0, repeats=5,
        solver="gmres", aug=3, deflate=10,
        choices={"solver": RESTART_SOLVERS},
        help="Householder GMRES (or LGMRES, GMRES-DR with M on the right) "
             "over restart lengths m")
    add("multirhs", cmd_multirhs, nsize=512, s_list="1,2,4,8",
        solver="block-cg", precond="mg", tol=1e-8, restart=30,
        max_restarts=200, max_iterations=2000,
        choices={"solver": MULTIRHS_SOLVERS},
        help="block CG (or block GMRES) on s stacked Poisson right-hand "
             "sides, time per RHS against s = 1")
    add("varcoef", cmd_varcoef, nsize=256, contrast=1e5, tol=1e-9,
        max_iterations=20_000,
        help="CG on the variable-coefficient model with two high-contrast "
             "inclusions: jacobi, mg, each with and without deflation")
    add("eig", cmd_eig, nsize=256, k=4, tol=1e-8, rtol=0.0, max_iterations=200,
        precond="mg", method="lobpcg", gamma_x=2.0, gamma_y=0.5, steps=40,
        precision="f64",
        choices={"method": ("lobpcg", "arnoldi", "ks_real", "subspace"),
                 "precision": ("f64", "f32", "mixed", "c64")},
        help="eigenpairs against closed-form spectra: LOBPCG on Poisson with the "
             "multigrid M, or Krylov-Schur (complex or real Schur basis) or "
             "subspace iteration on convection-diffusion")
    add("slq", cmd_slq, nsize=512, probes_list="8,16,32", steps=40,
        help="stochastic Lanczos quadrature of log det A (Poisson) per probe count")
    add("evolve", cmd_evolve, nsize=256, dt=1.0, steps=50, theta=0.5, model="convdiff",
        gamma_x=2.0, gamma_y=1.0, solver="gcrodr", tol=1e-9, restart=40, k=10,
        max_restarts=100, max_iterations=2000, expm_steps=30, precond="none",
        choices={"model": ("heat", "convdiff"),
                 "solver": ("cg", "bicgstab", "gmres", "gcrodr", "expm"),
                 "precond": ("none", "mg")},
        help="a θ-method (or exponential Euler) trajectory of the heat equation "
             "or convection-diffusion, GCRO-DR recycling across steps")
    add("scale", cmd_scale, grids="300,600,1200,2048,4096", restart=10, tol=1e-8,
        dim=2, choices={"dim": (2, 3)},
        help="the production configuration across grids: Householder GMRES "
             "with the Poisson V-cycle, float32 Arnoldi cycles certified on "
             "the true residual (--dim 3: CG with the 3-D cycle)")
    add("spmv", cmd_spmv, nsize=512, reps=20, skip_sparse=False,
        help="SpMV throughput on the Poisson matrix: the plain stencil and "
             "formats, and on the card K1, K3 (DIA, HYB) and K4 (BSR)")
    add("roofline", cmd_roofline, grids="1024,2048,4096", reps=20, cheb_order=8,
        help="achieved bandwidth of the stencil, smoother and V-cycle routes")
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
