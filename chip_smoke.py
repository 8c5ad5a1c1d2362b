#!/usr/bin/env python3
"""Smoke run of gmres_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py                      # the smoke run below
    python3 chip_smoke.py --k2-paths [OUT]     # K2's path table (JSONL to OUT)
    python3 chip_smoke.py --phase15            # the build and phase 15 alone
    python3 chip_smoke.py --phase17            # the build and phase 17 alone
    python3 chip_smoke.py --phase18            # the build and phase 18 alone
    python3 chip_smoke.py --phase19            # the build and phase 19 alone
    python3 chip_smoke.py --phase20            # the build and phase 20 alone
    python3 chip_smoke.py --phase21            # the build and phase 21 alone
    python3 chip_smoke.py --phase22            # the build and phase 22 alone
    python3 chip_smoke.py --phase23            # the build and phase 23 alone
    python3 chip_smoke.py --phase24            # the build and phase 24 alone
    python3 chip_smoke.py --phase25            # the build and phase 25 alone
    python3 chip_smoke.py --phase26            # the build and phase 26 alone
    python3 chip_smoke.py --phase27            # the build and phase 27 alone
    python3 chip_smoke.py --phase28            # the build and phase 28 alone
    python3 chip_smoke.py --phase29            # the build and phase 29 alone

Run from the root of a checkout on a machine with an H100 (the kernels are
built for sm_90a). It imports torch, numpy and gmres_tpu_torch only. The
``--k2-paths`` mode builds the kernels, then forces every path of kernel K2
that can take each multigrid shape (16² to 4096², orders 3, 8 and 32,
float32 and float64), holds each bitwise to the per-sweep path and times it
by CUDA-graph replay; ops/fused.py's chebk_plan is set from that table.
The ``--phase15`` and ``--phase17`` to ``--phase29`` modes build the
kernels and run that phase alone, with its checks. The smoke run runs
phases 1-14, 16, 24-26 and 28 (a) in turn, then phases 15, 17-23, 27, 28
(b)-(c) and 29, which time no kernel, in four worker processes at once
(``--worker OUT PHASE...``, each pickling what the kernel report reads of
its phases to OUT; WORKER_GROUPS: 19; 15, 18 and 28; 20, 21 and 27; 22,
17, 23 and 29), and prints each worker's output in turn. Phases of the
smoke run:

1. Require CUDA (exit non-zero without it); print the card's name and
   power limit as nvidia-smi reports them.
2. Build the CUDA kernels from gmres_tpu_torch/csrc with nvcc (one nvcc per
   source, all started together); print the build time and ptxas's
   resource report.
3. Compare kernel K1 (5-point stencil) and kernel K2 (order-k polynomial
   smoother) with their plain PyTorch versions on the card, at the shapes
   the main path gives them; print the error against a tolerance stated
   per case, each kernel's and plain version's time (CUDA events, after a
   warm-up), the bound and, for K1, the time of F.conv2d with the cross
   kernel (the one PyTorch call that computes the same stencil). Each K2
   case also runs on K2's per-sweep path: the routed path (printed with its
   cluster or tile) must give the same bits and take no longer (3% for
   noise). Then the launch floor (an empty kernel's chained slope between
   CUDA graphs of 20 and 40 launches) and the redesigned kernels, each
   bitwise against its plain version with its device time by CUDA-graph
   replay, bound, the floor and the host µs to enqueue one call: K1's
   residual-restrict and correct-residual forms at 300², 150², 2048² float32
   and 304² float64 (residual-restrict beside one F.conv2d computing it),
   and K1 and K5 at the halo path's 304² float64 with null halo rows, K1
   also at the mg operator's 300² and 150² and at 2048² float32, there with
   16-byte row chunks and, on inputs one element off alignment, one point a
   thread. Rows at 2048² cycle through 4 input sets (more than the 50 MB L2
   in all), so their inputs come from HBM; every other row whose working
   set fits the L2 is flagged ``l2_resident``.
4. Solve the multigrid ``mg`` configuration (Householder GMRES, m=10,
   float32 Arnoldi cycles certified on the float64 true residual) at 300²
   and 2048², with the package's V-cycle (K1's fused forms) and, in turn,
   with the unfused V-cycle built here from public pieces; require the
   same iteration counts; check convergence with a float64 true residual
   computed independently in numpy, and that K1 (the operator and the two
   V-cycle forms) and K2 were launched during the fused solves, K2 on its
   cluster path at both sizes (the coarse solves) and on its tiled path at
   2048² (printed by path); profile one more solve of each V-cycle (device
   time by kernel, kernels per solve, and the device's busy share of the
   wall time) and count the kernels of one V-cycle of each.
5. Solve the reference configuration at 300² (float64, cbpr2, m=50).
6. At 64², check that the GPU solve and the port's CPU solve agree.
7. Compare kernel K3 (DIA SpMV) and kernel K4 (BSR SpMV) with their plain
   versions: K3 bitwise on the Poisson DIA and HYB matrices at 512², 1000²
   and 2048² and on a wide, ragged DIA; K4 on block-tridiagonal matrices of
   random 128² blocks (the spmv program's n = 2048, and 512 block rows) and
   on the 64² Poisson matrix in 64² blocks. Print times, bounds, Gnnz/s and
   the time of the PyTorch sparse CSR/BSR product on the same matrix.
8. The sparse solve of the ``cg`` program: cbpr2 CG on the HYB operator of
   the Poisson CSR matrix, float64, tol 1e-9 absolute, at 300² and 1000²
   (the median of CG_REPEATS solves after a warm-up; one profiled 1000² solve), and
   the pipelined variant at 300²; each checked by an independent numpy
   residual and by K3's launch count.
9. GMRES (the reference configuration) on the 300² HYB operator, against
   phase 5's iteration count on the stencil; CG on the BSR form of the 64²
   Poisson matrix, which must launch K4.
10. At 64², check that the port's GPU and CPU CG on the HYB operator agree.
11. Compare kernel K5 (fused cbpr2 with halo rows) and kernel K7 (fused CG
    update, K7a; fused axpy-dot, K7b) with their plain versions: K5 bitwise
    at 304² float64 (the strong-scaling shard) with zero and with random
    halo rows and at 2048² float32; K7 on a 2048² float32 and a 304² float64
    block (elementwise outputs bitwise, the float32 sums to a stated
    tolerance, the same bits on a second call and with α given by value as
    with α a tensor on the card), one kernel a call by torch.profiler (the
    slope between 20 and 40 calls, within half a kernel). Print times
    (CUDA-graph replay), bounds, the launch floor, the host µs to enqueue a
    call with α by value and with α a tensor, the time of F.conv2d with
    K5's function as a 3×3 cross kernel (cuDNN, TF32 off), and the time of
    the eager torch calls that K7 fuses (add, sub, dot; add, dot). Then
    call K7 through the public entry points as a per-shard caller would (no
    solver calls K7, as in gmres_tpu).
12. The strong-scaling configuration on the explicit-halo route with the
    fused halo cbpr2 (the program itself applies the reference cbpr2 over
    the GSPMD operator; the mathematics is the same): a one-rank NCCL
    process group, the port's mesh, the 304² right-hand side
    sharded over it; one application of the halo operator (K1) and of the
    fused halo cbpr2 (K5) must launch its one kernel once (the wrappers'
    counts) and run one kernel in all (torch.profiler's count, within half
    a kernel: a profile can lose events), and equal the same application on
    halo_exchange's two zero rows (built here: three kernels); then the two under MGSR GMRES (cgs2,
    m=50, float64) at tol 1e-8 and 1e-15, the wall of STRONG_REPEATS solves, the
    counts against the JAX package's, the launches of K1 and K5 against the
    operator and preconditioner applications, a profiled solve; then the
    same solve on plain tensors (the DTensor layer's cost), one mgs2 solve
    and one CG solve on the same operators.
13. Compare kernel K6 (the float64-accurate stencil on (hi, lo) float32
    pairs) with its plain version, bitwise in both components and within
    1e-13 of the float64 oracle, at 2048² and 4096² (Poisson and general
    coefficients), timed by CUDA-graph replay beside its bound and the
    float64 F.conv2d (the nearest PyTorch call); then run the port's
    ``roofline`` program at its defaults (1024, 2048, 4096; reps 20;
    order 8), which prints every row, and check that K1, K2 and K6 were
    launched, that no row exceeds 1.05 of the HBM peak without a stated
    traffic model, and that K2's rows carry their fraction of the single
    pass (r read once, z written once).
14. On the same one-rank NCCL group: compare kernel K8 (the RDMA route's
    affine stencil, interior then edges) with its plain version on zero
    rows, bitwise, at 304² and 2048² float32, with no halo rows (no edge
    launch), zero, random and bottom-only rows, timed by CUDA-graph replay
    beside the bound, the launch floor and F.conv2d of the affine weights
    (the 2048² rows cycle through 4 input sets; rows that fit the L2 are
    flagged ``l2_resident``), and at 304² the application as the route ran
    it before (two zero rows filled, interior, edges). Then one application
    of the RDMA operator and of the RDMA cbpr2 must launch K8's interior
    once and its edges never (the wrappers' counts), run one kernel in all
    (torch.profiler, within half a kernel) and equal the application on
    zero rows (built here: four kernels). Then float32 MGSR GMRES at 304²
    with the RDMA operator and the RDMA cbpr2 (m=50, tol 1e-5) and CG on
    the RDMA operator (1e-4 relative), STRONG_REPEATS timed solves each, checked in
    numpy, with K8's interior launches equal to the operator and
    preconditioner applications, no edge launch, and a profiled solve.

15. BiCGSTAB, the Lanczos bounds and the reference's programs:
    cbpr2 BiCGSTAB (float64, tol 1e-9 absolute, b = A·1) at 300² and 1000²,
    BICGSTAB_REPEATS timed solves after a warm-up, one profiled
    solve (device busy, kernels per iteration), status 0, a numpy float64
    ‖b − A x‖ under 1e-9, the iterations against gmres_tpu's (within 15%:
    the count moves with the reductions' order, BICGSTAB_SPREAD) and K1's
    launches equal to the operator applications (4 an iteration, the ‖A‖
    probe, each residual replacement, the certification); the ``hilbert``
    program at n = 12 (Householder's max |I − VᵀV| at least 1e6 below
    MGSR's); ``lanczos_bounds`` on the 300² operator containing the exact
    λ_max and equal to the CPU's within 1e-10; then the programs in this
    process at reduced depth: ``dense-poisson``, ``poisson-mf`` (300², m=50,
    tol 1e-8), ``cg`` and ``bicgstab`` (300² and 1000²), ``restart-sweep``
    (2 restart lengths, tol 1e-8), ``strong-scaling`` (304², tol 1e-8, one
    rank) with and without ``--explicit-halo`` and ``weak-scaling`` (one
    rank), each making its own one-rank NCCL group; every row has status 0.
    The phase's wall time and the run's are printed.
16. Convection–diffusion (BASELINE config 3): K1 (the operator, and its
    residual-restrict and correct-residual forms) at 1024² with the central
    coefficients, float64 and float32, and the forms at 64² with the upwind
    ones, each bitwise against its plain version from HBM (4 input sets at
    1024²) beside its bound, the launch floor and one F.conv2d; K2's damped
    Jacobi at 1024² float32 (order 3) and its order-64 coarse solve at 16²
    on upwind coefficients (float32 and float64), each within a stated
    tolerance of its plain version, bitwise to its per-sweep path and timed
    beside it (a slower routed path is printed, not refused: chebk_plan was
    set from Poisson shapes). Then the ``convdiff`` program's
    configurations on the card through its own problem setup
    (CONVDIFF_ROWS: BiCGSTAB + MG float64 at 256² and 1024², mixed ``auto``
    at 1024², GMRES mixed ``auto`` at 1024², BiCGStab(2), CGS and TFQMR at
    256², red-black Gauss-Seidel at 256² and (BiCGStab(2)) at γ = (2, 1)
    at 32², the
    degree-24 polynomial at 64²), each with the launch counts set to 0 just
    before and read just after: status 0, a numpy float64 residual under
    1e-9 in the norm the solve certifies, gmres_tpu's count (within 15%,
    at least 2; GMRES within one restart cycle and 2, since gmres_tpu's
    less accurate float32 sums cost it a cycle), K1, its forms and K2
    launched (the
    polynomial only K1), K2's launches by path; at 1024² the median and
    quartiles of CONVDIFF_REPEATS solves after a warm-up and one profiled solve. Then the
    program itself at BASELINE config 3 (``convdiff --nsize 1024 --precond
    mg --precision mixed --smoother auto``). The phase's wall time is
    printed.

17. The GMRES family on the card, each row through the port's public
    functions or the program's own setup, with the launch counts set to 0
    just before its warm-up (3 cycles for the long s-step and FGMRES rows)
    and FAMILY_REPEATS timed solves and read just after; the
    operator and the preconditioner are wrapped to count their
    applications, their launches per application are measured once each,
    and the launches over the solves must equal the applications times
    those, kernel by kernel (K1, its two V-cycle forms, K2). Rows: the
    ``restart-sweep`` program with ``--solver lgmres`` (280², m 20 and 25,
    tol 1e-15) and ``--solver gmres-dr --deflate 10`` (tol 1e-10: at 1e-15
    gmres_tpu's own certification fails), and each at m = 20 through its
    function; ``gmres_dr`` at 300² (m 30, k 10, tol 1e-10) with deflation
    "eig" and "subspace" (one route, as in gmres_tpu); IDR(8) with the
    float64 Jacobi cycle on convdiff 1024² (tol 1e-9), profiled, then the
    ``convdiff --solver idrs`` program; GCRO-DR(40, k 10) sequences b₁ = A·1,
    b₂ = A·x₂ fresh and warm on convdiff 1024² with its cycle and on
    Poisson 300² with cbpr2; the ``multirhs --solver block-gmres --s-list
    1,4`` program at 512² and block GMRES at s = 4 with its row
    applications counted (a block application is s single-vector ones);
    s-step GMRES (s 8, tol 1e-6) with the order-16 Chebyshev
    preconditioner at 1024², float64 and with a float32 block (15 K1
    launches an M); FGMRES(10) at 300² (tol 1e-6) with four CG steps as M.
    Each row: status 0, a numpy float64 residual under its tolerance in the
    norm the solver certifies, its counts against gmres_tpu's CPU counts
    (within 2, or the band its constant states), host syncs, the wall
    of the FAMILY_REPEATS timed solves.
18. The short-recurrence family and the real models, each row with the
    launch counts set to 0 just before its warm-up and SHORT_REPEATS timed solves and
    read just after, its operator and preconditioner applications counted
    and its launches required to equal the applications times the launches
    per application: the ``multirhs --solver block-cg`` program (512², s 1,
    2, 4, 8, the V-cycle, tol 1e-8) and ``block_cg`` at s = 4 through its
    function (whole blocks of s row applications); MINRES and s-step CG
    (s = 4) on Poisson 1024² float64 with the V-cycle (tol 1e-9·‖b‖);
    ``chebyshev_solve`` with ``coefs`` (K2 once a cycle, K1 once a cycle)
    at 1024² order 512 and 64² order 16 (one K2 launch a cycle there); CG
    with the 3-D V-cycle at 128³ (the 3-D arm of gmres_tpu's scale
    program; plain PyTorch, no kernel); CG with the line-smoothed
    anisotropic cycle at 1024², ε = 0.01 (K1 for every operator
    application); the ``varcoef`` program at 256² and CG with mg+defl on
    the varcoef model at 1024² (plain PyTorch, no kernel) with its L2 error.
    Each row: status 0, a numpy float64 residual under its tolerance in the
    norm the solver certifies, its count within 2 of gmres_tpu's CPU count
    (scripts/jax_phase18_counts.py), host syncs, the median and quartiles
    of the timed solves and the launches per solve; one more solve of the
    block CG, MINRES, s-step CG, 1024² Chebyshev and 3-D rows profiled
    (device busy, kernels; the anisotropic and varcoef rows' 57k and 24k
    kernels a solve would cost the profiler ~40 s).

19. Helmholtz and the solvers that need Aᵀ or J·v. First K1's rules on the
    card at 1024² float64 and float32, Poisson and convdiff coefficients:
    the adjoint identity ⟨A x, y⟩ = ⟨x, Aᵀ y⟩ with Aᵀ the pullback of
    torch.func.vjp through K1 (1e-13 relative in float64), the vjp, the jvp
    and a tensor coefficient's gradient against the plain stencil's autograd
    on the card, each rule's launches (a pullback one K1 with mirrored
    coefficients, a tangent one K1), K2, K1's halo form, K1rr and K3
    refusing a transform with a named error, and K1's host µs a call with
    and without the autograd Function. Then MINRES with the SPD
    shifted-Laplacian cycle at 1024² (kh2 factor 10), float64 and with the
    float32 cycle, and the ``helmholtz`` program at 256²; the split CSL
    GMRES(120) and GCRO-DR at 512² (float32 cycles, float64 certified; one
    timed solve each) and the complex128 CSL GMRES at 256² (plain torch; its
    kernels per cycle); the ``sequence`` program at its defaults (128², three
    frequencies); the ``bratu`` program at 256² and
    newton_krylov with the V-cycle at 1024², float64 and mixed (Newton
    steps, inner iterations, J·v products, K1 launches per J·v: 2); QMR with
    the convdiff cycle and its transpose as MT at 1024² (K1 per iteration)
    and the ``convdiff --solver qmr`` program at 32² and at its 256² default
    capped at 2000 iterations (gmres_tpu's stalls there: held to its count
    and residual); LSQR and LSMR at 128² with the derived adjoint (one timed
    solve each after a short warm-up); implicit_solve's γ-gradient at 256² against central
    differences. Each row: status 0, a numpy float64 residual in the norm
    the solver certifies, its count against gmres_tpu's CPU count
    (scripts/jax_phase19_counts.py; within 2 or the band its constant
    states), host syncs, the wall of PHASE19_REPEATS timed solves, the
    launches (K1 split into forward, transpose and tangent) checked against
    the applications; one profiled solve per solver family.

20. The eigensolvers, matrix functions, time steppers and the Nyström and
    SPAI preconditioners, each row with the launch counts set to 0 after its
    warm-up solve and read after its PHASE20_REPEATS timed solves (the wall
    printed, the launches of K1, K1rr, K1cr and K2 per solve, the host
    syncs): the eig program's LOBPCG (Poisson, the V-cycle as M, k = 4) at
    256² (tol 1e-8) and 1024² (tol 0, the rtol of
    scripts/jax_phase20_counts.py), eigenvalues against the closed form and
    each pair's residual recomputed in numpy; its Krylov–Schur on a complex
    basis (2 K1 launches a complex matvec, counted), Krylov–Schur on a real
    Schur basis and subspace iteration on convection-diffusion 256², k = 4,
    steps 40, at most 200 cycles, at the program's γ = (2, 0.5) (timed;
    eigenvalues not computable in float64 there, both packages end at the
    cap: status and count against gmres_tpu's) and at the mild
    EIG_MILD_GAMMA (Krylov–Schur converged, eigenvalues against the closed
    form, cycles against gmres_tpu's; subspace iteration against the CPU
    port on the same start and the closed form within its band), residuals
    recomputed in numpy against the reported ones; one profiled solve of
    each LOBPCG row and of each Krylov–Schur row at γ = (2, 0.5) (at most
    PROFILE_CYCLES cycles); stochastic Lanczos quadrature of log det on
    Poisson 512² with 8, 16 and 32 probes, 40 steps, against the closed-form
    sum within 3 standard errors; the evolve program's trajectories at 256²,
    50 steps (GCRO-DR on convection-diffusion, with and without the
    σ-shifted cycle; each step's residual recomputed in numpy from a saved
    trajectory) and exponential Euler on the heat equation against the
    sine-transform solution; CG with the rank-64 Nyström preconditioner on
    Poisson 512² (its λ̂ against gmres_tpu's, its M r − r against the CPU
    port's on the same sketch) and BiCGSTAB with SPAI (from the
    convection-diffusion CSR matrix) at 128², residuals in numpy; then the
    eig (lobpcg, arnoldi, ks_real) and evolve programs at 64². Counts against gmres_tpu's CPU counts within the bands the
    constants state.

21. The distributed solve on a one-rank NCCL group made by the script:
    row-sharded b (DTensor), the halo operators and the ``mesh=`` cycles,
    whose sharded levels run K1's halo form (one exchange and one launch
    a stencil) and whose replicated levels, gathered once a cycle, run the
    ``mesh=None`` cycle (K1's forms, K2). Rows: (a) the mg configuration
    (Householder GMRES(10), float32 cycles, certified on the float64 true
    residual) at 300² with ``replicate_below`` 160 and (b) at 2048² with
    300; (c) Householder GMRES(50) with the fused halo cbpr2 (K5) at 304²,
    tol 1e-4; (d) BiCGSTAB with the float32 ``auto`` convection–diffusion
    cycle at 1024² (BASELINE config 3); (e) MINRES on Helmholtz 1024² with
    the SPD cycle; (f) LSQR on the 512² halo operator, Aᵀ by the halo
    operator's transpose rule, capped at P21_LSQR_CAP steps and held to
    LSQR on the plain operator; (g) the ``weak-scaling --precond mg``
    program at d = 1 and the same solve with the ``mesh=`` cycle; (h)
    GCRO-DR(40, k 10) on convection–diffusion 512² with its cycle; (d),
    (e) and (h) replicate from P21_REPLICATE_BELOW rows. Each row: the
    wall of PHASE21_REPEATS solves after a warm-up, the counts against the same
    solve with ``mesh=None`` on plain tensors (equal), host syncs, K1 (halo
    and full grid), K1rr, K1cr, K2 and K5 launches a solve, all-gathers a
    cycle application and all-reduces by CommDebugMode over one more solve
    (one all-gather a cycle where a level is replicated, nothing but
    all-gathers and all-reduces), the float64 true residual in numpy, and
    the device's busy share of one profiled solve.
22. The plain model operators, the CSL and 3-D ``mesh=`` cycles and the
    preconditioners and AD solvers on a sharded b, on a third one-rank NCCL
    group: a plain operator on a DTensor takes the halo route (one exchange,
    K1's halo form on a real 5-point stencil). Rows: (a) MGSR GMRES(60)
    with the complex CSL ``mesh=`` cycle at 256², complex128; (b)
    GMRES(120) on the split stack ([Shard(1)]) with the split ``mesh=``
    cycle, float32 basis, certified in float64; (c) CG with the 3-D
    ``mesh=`` cycle at 128³; (d) CG with the line anisotropic cycle at
    1024², ε 0.01; (e) CG with mg+defl on varcoef 1024², contrast 1e5;
    (f) Newton–Krylov on Bratu 1024², λ 5, with the Poisson ``mesh=`` cycle
    (J·v on the rank's block); (g) CG with Nyström rank 64 at 512², built
    on the sharded x_like; (h) the implicit_solve gradients at 512² and
    BiCGSTAB with SPAI on convection–diffusion 128². Each row against its
    twin on plain tensors: counts equal (BiCGSTAB within 2), the numpy
    float64 true residual under the row's bound, K1 halo-form launches a
    fixed multiple of the exchanges (1 on the real 5-point rows, 2 on the
    split stack, 0 where the halo form is plain torch), one all-gather an
    M application of a ``mesh=`` cycle or of SPAI and none of Nyström,
    nothing but all-gathers and all-reduces (CommDebugMode over the
    warm-up), and the wall of one timed solve.

23. The eigensolvers, matrix functions, time steppers and ``mesh=None``
    cycles, and the sparse formats, on a sharded b, on a fourth one-rank
    NCCL group: LOBPCG with the plain Poisson cycle at 1024², k 4 (block
    [Shard(1)]); Krylov–Schur on a complex and on a real basis and subspace
    iteration at convection–diffusion 256², γ (0.02, 0.01); SLQ at 512²;
    expm_multiply, exponential Euler and θ-steps (GCRO-DR with the
    σ-shifted ``mesh=None`` convdiff cycle) at 256², 5 steps; one
    application of the Poisson, convection–diffusion and Helmholtz SPD
    ``mesh=None`` cycles on a sharded r (the distributed cycle on its mesh);
    CG with cbpr2 on a sharded HYB at 1000² (K3 on the rank's rows), CSR, COO and ELL
    SpMV at 512² (one all-gather of x), DIA at 2048² f32 and f64 (K3, one
    exchange) and a BSR of 128² blocks (K4 on the rank's block rows). Each
    row beside its twin on plain tensors: counts equal, the largest
    difference from the twin under the row's bound, the launches of K1 (and
    its halo form), K1rr, K1cr, K2, K3 and K4, the explicit all-gathers and
    exchanges an application, the walls. Then K3 and K4 as the sharded
    route launches them for an interior rank of four (shifted offsets, a
    window of block columns), against their plain versions and the whole
    matrix's rows; then the ``spmv`` program at its defaults (K1, K3 and K4
    rows beside the plain ones) and ``scale`` at its 2-D defaults (300² to
    4096²) and its ``--dim 3`` arm at 128³.

24. Batched solves and the batched launches (a (lanes, rows, cols) block in
    one launch, the lane a grid dimension: what jax.vmap makes of a Pallas
    kernel). (a) Each batched kernel at B = 2, 4, 8 bitwise against B
    single launches and against its plain version: K1 at 300² and 2048²,
    float32 and float64, with one coefficient set and with one a lane; K1rr
    and K1cr at 300² → 150² and 2048² → 1024²; K2 on its cluster (75²,
    order 32), tiled (2048², order 3) and per-sweep (300², order 8,
    float64) paths; device ms by CUDA-graph replay of the batched launch
    and of the B single launches, the bound (the lanes' bytes and
    operations), host µs, and for K1 and K1rr the batched ``F.conv2d``. (b)
    One block application of the mg 512² cycle at s = 4 through
    ``row_apply`` (vmap) and through a loop of single-vector applications
    written here: the same bits, launches (the loop's s times row_apply's),
    device ms and host µs of each. (c) Block CG at s = 4 + MG 512², LOBPCG
    at k = 4 1024² and block GMRES(30) + MG at s = 4 512², with the launch
    counts set to 0 just before and read just after: the counts of one
    launch a row, no single-grid launch, block CG's launches a solve 1/s
    of one launch a row's. (d)
    ``batched_solve`` at full width, each with the launch counts set to 0
    just before and read just after, then each lane's sequential solve on
    the card: the mg configuration (Householder GMRES(10), float32 cycles
    certified in float64) at 300² on 8 right-hand sides, CG + MG at 1024²
    on 8, BiCGSTAB with the convection–diffusion cycle at γ (0.4, 0.2) on
    convection–diffusion 256² over 4 lanes of γ around it (K1's per-lane
    coefficients); each lane's counts and x its sequential run's to the
    bit, a numpy float64 residual, the host reads (one an iteration for the
    batch) the longest lane's, and the launches the longest lane's where
    the lanes run in lockstep (CG), else between the longest lane's and all
    lanes'; the batched wall against the B sequential walls.

25. (a) K3 and K4 on lane blocks, the lanes in chunks that read each matrix
    entry once (``sparse.spmv_lanes_plan``): K3 on the DIA of HYB 1000²
    float64 at 4, 8 and 9 lanes, K4 on 512 block rows of three 128² blocks
    at 8, 4, 9 and 16 lanes float32 and 8 lanes float64 (9: a partial
    chunk), each bitwise against its B single launches and against its
    plain version (K3 bitwise, K4 within 1e-5 or 1e-13 of max|y|), with
    device ms by CUDA-graph replay, the bound (the matrix once, the lanes'
    x and y), its share and the library call on X = (n, lanes); then single
    K3 and K4 on the same matrices, retimed beside them. (b)
    ``batched_solve`` of the short recurrences, the GMRES family and
    Newton–Krylov (the Bratu λ-sweep), CG on HYB 1000² and on BSR 64², and
    SLQ's probes as lanes, each with the launch counts set to 0 just before
    and read just after; each lane's counts and x its sequential run's to
    the bit.

26. (h) K1's per-lane transposed launch (the backward rule of
    ``ops/stencil.py:Stencil5Lanes``) on 8 lanes of 2048² f32 and f64, bitwise
    against the launch and its 8 single transposed launches, with device ms,
    the bound and a grouped ``F.conv2d``; then ``batched_solve`` of QMR (the
    convdiff cycle and its transpose as MT), LSQR and LSMR over γ lanes,
    GMRES-DR(30, 10) with cbpr2, GCRO-DR(40, 10) with the cycle over γ,
    Newton–Krylov with the gcrodr inner over the Bratu λ-sweep, block CG and
    block GMRES(30) with the V-cycle, and vmap(grad) through
    ``implicit_solve`` over γ. Each row (``batched_row``): each lane's counts
    and x its sequential run's to the bit, host reads the longest lane's,
    K1's launches by role (forward, transpose, tangent) and K1rr, K1cr, K2
    between the longest lane's and all lanes'; the batched wall against the
    lanes in turn.
27. ``batched_solve`` over the eigensolvers, matrix functions and time
    steppers, in a worker: (a) ``lanczos_bounds`` on Poisson 1024² + s·I,
    s ∈ P27_SHIFTS, 40 steps; (b) ``funm_lanczos`` (A^(-1/2)·b) and
    ``expm_multiply`` (t 0.1 and a vector of 3 times) on the same lanes, 30
    steps; (c) ``trace_funm`` log det on Poisson 512² + s·I, 8 probes a lane,
    40 steps; (d) ``exponential_evolve`` on Poisson 256² + s·I, 5 steps,
    constant forcing; (e) ``theta_evolve``, Crank–Nicolson, 5 steps:
    GCRO-DR(40, 10) with the σ-shifted cycle on convdiff 256² over γx, and CG
    with the V-cycle on Poisson 1024² + s·I; (f) LOBPCG + the V-cycle, k 4,
    Poisson 1024² + s·I, rtol 1e-4; (g) Krylov–Schur on a complex basis on
    convdiff 256² over γ (γx, 0.01), γx ∈ P27_EIG_GAMMAS, steps 40. Each row
    (``batched_row``) beside the same lanes run one after another, the
    launch counts set to 0 just before each run and read just after: each
    lane's counts, status and outputs (bounds, y, samples, states,
    eigenpairs) its sequential run's to the bit; host reads the longest
    lane's; K1, K1rr, K1cr and K2 launches the longest lane's (the lockstep
    rows (a)–(d)) or between the longest lane's and all lanes'; a numpy
    check: the sine transform's closed form for (a), (b), (d), log det
    within 3 standard errors, LOBPCG's λ within 1e-6 of the closed form,
    each θ-step's ‖rhs − S u‖/‖rhs‖, each Krylov–Schur pair's ‖A x − λ x‖
    under tol and its λ within 1e-6 of the closed form; the batched wall
    against the lanes in turn.

28. The halo route's batched form (a block of rows of a row-sharded grid:
    one exchange and one launch, what gmres_tpu's jax.vmap makes of the
    halo operators). (a) K1's halo form, K5 and K8's interior and edges on
    8 lanes of 1024² float64 and 2048² float32, with random per-lane halo
    rows and with a null side, each bitwise against its 8 single launches
    and its plain lane form, with device ms by CUDA-graph replay, the bound
    and one F.conv2d over the lanes (the only place per-lane halo rows run
    on the card: one card is one rank, with no neighbour). (b) On a
    one-rank NCCL group, one ``row_apply`` of 8 rows placed [Shard(1)]
    through the halo operator, the halo cbpr2 and the order-4 halo
    Chebyshev (1024² float64), the split Helmholtz operator (8 stacks of
    2×1024² float64 placed [Shard(2)]: two launches of K1's halo form, one a
    plane) and the two RDMA operators (2048² float32), beside the rows one
    by one: one row's exchanges and launches (by the
    wrappers' counts, and kernels by torch.profiler's two-profile rule),
    each row bitwise its own call, both walls. (c) Solver rows on the same
    group beside their twins on plain tensors, the counts set to 0 just
    before each and read just after: block CG (halo operator + halo cbpr2,
    1024² float64, s 8), LOBPCG (halo cbpr2 as M, 1024², k 4, held at
    gmres_tpu's cap), the Nyström build on the halo operator (1024², rank
    20), SLQ on a sharded 512² x_like (8 probes: samples bitwise the probes
    one by one, log det within 3 stderr of the closed form) and block CG on
    the RDMA route (1024² float32); counts against gmres_tpu's
    (JAX_PHASE28, scripts/jax_phase28_counts.py) and the twin's, every
    exchange followed by one launch of K1's halo form, K5 or K8, and each
    of the row's kernels launched on lane blocks.
29. The distributed V-cycles and the sparse operators' rank rows on a
    block of rows (one exchange a sharded-level application and one
    all-gather a block, what gmres_tpu's jax.vmap makes of its mesh= cycle
    and sparse operator), on a one-rank NCCL group. (a) One ``row_apply``
    of 8 rows beside the rows one by one: the mesh= Poisson cycle at 2048²
    float32 (replicate_below at its default: every level sharded, K1's halo
    form on lanes; and 512: one all-gather, then K1rr, K1cr and K2 on lane
    blocks under vmap), the mesh=None cycle on a DTensor at 300², BASELINE
    config 3's convection–diffusion cycle at 1024², the split CSL cycle at
    512² float32 (stacks placed [Shard(2)]) and the 3-D cycle at 128³. (b)
    The same for sparse_operator on HYB 1000² float64, DIA 2048² float32
    (one exchange, one K3 lane launch), BSR 16 × 128² float32 (one K4 lane
    launch) and CSR, COO, ELL 512² (one all-gather). Each: one row's
    exchanges, all-gathers and launches, all on lane blocks (by the
    wrappers' counts; kernels by torch.profiler), each row bitwise its own
    call, the walls of both (medians of 5). (c) Block CG with the mesh=
    cycle (1024² float64, s 8), LOBPCG with the mesh=None cycle (1024², k
    4) and block CG with cbpr2 on HYB 1000² (s 4), each beside its twin on
    plain tensors, counts against gmres_tpu's (JAX_PHASE29,
    scripts/jax_phase29_counts.py) and the twin's.

Phases 12–14 share one NCCL process group made by the script; phases 21,
22, 23, 28 and 29 make one each. Any failure
raises and exits non-zero. The line before the last is the
kernel report (JSON); the last line is the result (JSON).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
TOL = 1e-8
# Timed solves after each row's warm-up. The whole run must stay well
# inside its 1200 s limit on a loaded host (with 2-5 timed solves a row,
# phases 1-24 took 1040.8 s in one run on an H100 and 1264.0 s in another):
# phases 8 and 12-21 time one or two solves a row; no correctness row is
# dropped.
SOLVE_REPEATS = 11
CG_TOL = 1e-9  # the cg program's absolute tolerance
CG_REPEATS = 2
REF_EIG = (0.2, 8.2)  # cbpr2's interval, the reference's eigenvalue bounds
# Shapes of the sparse phases: the spmv program's default grid and the 2048²
# secondary; the ends of the cg program's grids (300:1000); the BSR cases
# (label, block rows, block size); the wide, ragged DIA of
# tests/test_sparse.py; the grid of the BSR solve and of the CPU check.
SPMV_GRIDS = (512, 2048)
CG_GRIDS = (300, 1000)
BSR_CASES = (("spmv program n=2048 bs=128", 16, 128),
             ("512 block rows bs=128", 512, 128))
WIDE_DIA = (700, (-301, -128, -17, 0, 17, 256, 301))
SMALL_GRID = 64
# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s
# and non-tensor-core FLOP/s by dtype.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Its L2 (50 MB): a record whose working set fits is flagged l2_resident,
# since CUDA-graph replay then reads it from L2, not HBM.
L2_BYTES = 50 * 2**20
# Inner iterations of the reference configuration at 300² recorded by the
# JAX package (BENCH_r05.json, decomposition, CPU run).
JAX_REFERENCE_INNER = 1200
# The strong-scaling program's configuration (benchmarks/cli.py): 304²,
# m=50, MGSR with cgs2, cbpr2 on REF_EIG, float64, up to 1000 restarts.
STRONG_N = 304
STRONG_M = 50
# gmres_tpu's counts for it (restarts, inner iterations of the last cycle),
# from jax.jit(gmres(..., variant="mgsr")) of the JAX package on the CPU, the
# same on its explicit-halo route on 1 and 8 devices, except that at 1e-15
# the last cycle takes 20 iterations on 1 device and 21 on 8 (the order of
# rounding): the check allows 2 inner iterations.
JAX_STRONG_COUNTS = {1e-8: (24, 15), 1e-15: (56, 21)}
STRONG_REPEATS = 1
# The program certifies the preconditioned norm ‖M(b − A x)‖/‖b‖. Its
# independent numpy recomputation must meet tol, times this factor: at 1e-15
# the float64 rounding of b − A x over 304² points is a tenth of the target
# (the port's CPU solve: 9.943e-16 certified, 1.157e-15 recomputed in numpy).
STRONG_ROUNDING = {1e-8: 1.0, 1e-15: 2.0}
# The roofline program's default grids (benchmarks/cli.py), and the general
# coefficients of tests/test_dd_stencil.py for K6's second entry point.
ROOFLINE_GRIDS = (1024, 2048, 4096)
GENERAL_COEFS = (4.3, -1.2, -0.7, -1.9, -0.1)
# The RDMA route's solves (tests/test_rdma.py, dryrun_multichip): float32
# MGSR GMRES to 1e-5 with cbpr2 on REF_EIG, and CG on the operator to 1e-4.
# At 304² float32 CG's true residual floors near 5.7e-4 absolute (the port's
# CPU run), above an absolute 1e-4, and gmres_tpu's certification would then
# end the solve in BREAKDOWN; so CG is held to 1e-4 relative to ‖b‖ (rtol).
RDMA_GMRES_TOL = 1e-5
RDMA_CG_TOL = 1e-4
# K1's V-cycle forms at the fine shapes the paths give them: mg 300²'s two
# levels, mg 2048²'s finest, and the strong-scaling grid in float64.
FORM_SHAPES = ((300, "float32"), (150, "float32"), (2048, "float32"), (304, "float64"))
# Input sets that phase 3's redesigned rows at 2048² cycle through: 4 sets of
# 34–71 MB exceed the L2 twice over, so each call reads its inputs from HBM.
HBM_SETS = 4
# Applications profiled per operator in phase 12's launch count.
HALO_APPLICATIONS = 20
# A profile's warm-up step (host seconds after its spin kernels; its events
# are dropped), the host seconds between the recorded step's edges and fn
# (the profiler keeps only the device events inside the step's host-clock
# window; scripts/profile_edges.py counts the profiles that lose fn's
# kernels with and without the gap) and the most profiles device_events
# takes for one count.
PROFILE_WARMUP_S = 0.01
PROFILE_EDGE_S = 0.02
PROFILE_TRIES = 5
# Phase 15: the bicgstab program's grids (test_bicgstab.f90's range ends) and
# gmres_tpu's iteration counts there (cbpr2 on REF_EIG, float64, tol 1e-9
# absolute, b = A·1), from the JAX package on the CPU:
#   JAX_PLATFORMS=cpu python -m benchmarks.cli bicgstab --grids 300:1000:700
BICGSTAB_GRIDS = (300, 1000)
JAX_BICGSTAB_ITERATIONS = {300: 230, 1000: 744}
# BiCGSTAB's count moves with the order in which its inner products sum: the
# JAX package itself takes 232 and 813 when its reductions are jnp.vdot
# instead of jnp.sum(x·y), and the port's CPU solves take 228–242 and 747–835
# across thread counts and reduction forms (tests/test_torch_bicgstab.py pins
# the mechanism: with shared reductions the port is JAX's bit for bit). So
# the card's count is held to this share of gmres_tpu's (at least 2), and the
# gap is printed.
BICGSTAB_SPREAD = 0.15
BICGSTAB_REPEATS = 2
# The Lanczos phase: 20 steps from a ones probe on the 300² operator; its
# exact λ_max (poisson_spectral_bounds) must lie inside the bounds.
LANCZOS_N = 300
# The hilbert program's A/B: Householder's orthogonality audit at least this
# factor below MGSR's (gmres_tpu on the CPU: 9.05e-31 against 6.40e-16).
HILBERT_AB = 1e6
# Phase 16: convection-diffusion (BASELINE config 3), the convdiff program's
# configurations: γ = (0.4, 0.2) unless given, b = A·1, tol 1e-9 (absolute
# for the BiCGSTAB family, relative and certified on the true residual for
# GMRES). Each row: (label, n, solver, precond, precision, smoother, γ).
CONVDIFF_TOL = 1e-9
CONVDIFF_ROWS = (
    ("bicgstab mg f64 256", 256, "bicgstab", "mg", "f64", "jacobi", (0.4, 0.2)),
    ("bicgstab mg f64 1024", 1024, "bicgstab", "mg", "f64", "jacobi", (0.4, 0.2)),
    # BASELINE config 3.
    ("bicgstab mg mixed auto 1024", 1024, "bicgstab", "mg", "mixed", "auto", (0.4, 0.2)),
    ("gmres mg mixed auto 1024", 1024, "gmres", "mg", "mixed", "auto", (0.4, 0.2)),
    ("bicgstabl mg f64 256", 256, "bicgstabl", "mg", "f64", "jacobi", (0.4, 0.2)),
    ("cgs mg f64 256", 256, "cgs", "mg", "f64", "jacobi", (0.4, 0.2)),
    ("tfqmr mg f64 256", 256, "tfqmr", "mg", "f64", "jacobi", (0.4, 0.2)),
    # Red-black Gauss-Seidel at 256² runs at γ = (0.4, 0.2): at γ = (2, 1)
    # gmres_tpu itself does not converge there (BiCGSTAB breaks down after
    # 129 iterations at ‖r‖ 46.8; GMRES(30) stops at 0.1 relative after 40
    # restarts, with every smoother), so the strong-Péclet row is at 32²,
    # with BiCGStab(2): BiCGSTAB's count there spreads over 67–72 with the
    # reductions' order in gmres_tpu itself (and 82 on the card), BiCGStab(2)'s
    # over 22–25.
    ("bicgstab mg rbgs 256", 256, "bicgstab", "mg", "f64", "rbgs", (0.4, 0.2)),
    ("bicgstabl mg rbgs strong 32", 32, "bicgstabl", "mg", "f64", "rbgs", (2.0, 1.0)),
    ("bicgstab poly24 64", 64, "bicgstab", "poly", "f64", "jacobi", (0.4, 0.2)),
)
# gmres_tpu's counts for those rows (GMRES: total inner iterations, here 2
# restart cycles of 30 and 12 in the last), from the JAX package on the CPU:
#   JAX_PLATFORMS=cpu python -m benchmarks.cli convdiff --nsize N --precond P
#       [--solver S] [--precision mixed] [--smoother M] [--gamma-x 2.0
#       --gamma-y 1.0] [--poly-degree 24]
JAX_CONVDIFF_ITERATIONS = {
    "bicgstab mg f64 256": 14, "bicgstab mg f64 1024": 20,
    "bicgstab mg mixed auto 1024": 18, "gmres mg mixed auto 1024": 72,
    "bicgstabl mg f64 256": 7, "cgs mg f64 256": 14, "tfqmr mg f64 256": 16,
    "bicgstab mg rbgs 256": 10, "bicgstabl mg rbgs strong 32": 25,
    "bicgstab poly24 64": 12,
}
CONVDIFF_REPEATS = 2
# Mixed GMRES's restart cycles follow the float32 accuracy of each cycle's
# update: gmres_tpu's float32 sums over the grid (XLA:CPU's) are less
# accurate than PyTorch's or cuBLAS's, and it needs 3 cycles where the port
# needs 2 (its CPU solve: 43 inner iterations at 1024² against gmres_tpu's
# 72; with gmres_tpu's sums accumulated in float64 it needs 2 as well, as
# tests/test_torch_convdiff.py pins at 512²). So GMRES is held to gmres_tpu's
# total within one restart cycle and 2 iterations.
CONVDIFF_GMRES_BAND = 30 + 2
# Phase 17: the GMRES family. gmres_tpu's counts for each row, from the JAX
# package on the CPU (jax.jit of each solver, float64, b = A·1 unless said):
#   restart-sweep: JAX_PLATFORMS=cpu python -m benchmarks.cli restart-sweep
#       --solver lgmres --ntests 2 (and --solver gmres-dr --deflate 10
#       --tol 1e-10): (restarts, iterations of the last cycle) for m = 20, 25;
#   the rest: the same calls as the rows below, through gmres_tpu's
#   functions (gcrodr's x₂: numpy default_rng(GCRODR_SEED).standard_normal).
# gmres-dr at the program's tol 1e-15 ends in BREAKDOWN in gmres_tpu too
# (its Givens estimate reaches 1e-15, its certification 4.5e-14 misses
# 10·tol at m = 20 and 25): its rows run at 1e-10.
FAMILY_REPEATS = 1
# The long rows (s-step, FGMRES: 2–4 s a solve on the card) warm up on a
# run of this many cycles of the same solver, not on a whole solve.
WARM_RESTARTS = 3
RESTART_SWEEP_N = 280
# LGMRES certifies on its Givens estimate (right preconditioning: an
# estimate of ‖b − A x‖/‖b‖). At 1e-15 that estimate runs below the float64
# floor of the true residual: the card's solve at m = 20 certified 9.81e-16
# and its numpy recomputation is 2.82e-15, so that row's numpy residual is
# held to this multiple of tol (gmres-dr's rows to its certification, 10·tol).
LGMRES_ROUNDING = 5.0
JAX_RESTART_SWEEP = {
    ("lgmres", 1e-15): {20: (38, 6), 25: (31, 27)},
    ("gmres-dr", 1e-10): {20: (33, 20), 25: (21, 15)},
}
# gmres_dr(restart=30, deflate=10, tol=1e-10) with cbpr2 on the right at
# 300²: gmres_tpu's "subspace" runs its "eig" route (the nested function
# `deflation` rebinds the argument's name, gmres_tpu/solvers/gmres_dr.py:217
# and :225), and so does the port's: the same counts for both.
GMRES_DR_N = 300
JAX_GMRES_DR_300 = (16, 22)
# IDR(8) + the float64 Jacobi cycle on convdiff 1024², γ = (0.4, 0.2),
# tol 1e-9 absolute; held to BICGSTAB_SPREAD (its count moves with the
# reductions' order, like BiCGSTAB's).
IDRS_N = 1024
JAX_IDRS_1024 = 5
# GCRO-DR(40, k=10), tol 1e-9, b₁ = A·1, then b₂ = A·x₂ fresh and warm
# (recycle= from the first): (cycles, iterations of the last) each. On
# convdiff 1024² with the multigrid cycle (left) gmres_tpu takes one cycle
# after the first in all three, so warm cannot beat fresh there; on Poisson
# 300² with cbpr2 it does (14 fresh, 11 warm): both sequences run.
GCRODR_SEED = 20261017
JAX_GCRODR = {"convdiff 1024 mg": ((2, 2), (2, 1), (2, 1)),
              "poisson 300 cbpr2": ((10, 24), (14, 7), (11, 28))}
# multirhs --solver block-gmres --s-list 1,4 at 512² with the V-cycle: one
# restart cycle of 30 block steps at s = 1 and s = 4.
MULTIRHS_N = 512
JAX_MULTIRHS_RESTARTS = {1: 1, 4: 1}
# sstep_gmres(s=8, tol=1e-6) with the order-16 Chebyshev preconditioner on
# (0.005, 8.0) at 1024²: restarts in float64 and with a float32 block. The
# float32 block's Gram: gmres_tpu sums it in float32 (2.4e-7 relative error
# at 1024² on the CPU), the port in float64 (torch's float32 GEMM, 9e-6
# there, breaks the Cholesky), and the port's CPU takes 135 restarts
# against 143: the float32 row is held to 10% of gmres_tpu's count.
SSTEP_N = 1024
JAX_SSTEP_RESTARTS = {"f64": 134, "f32": 143}
SSTEP_F32_SPREAD = 0.10
# fgmres(restart=10, tol=1e-6) at 300² with M four steps of CG (tol 0): the
# nonlinear M amplifies last-bit differences from cycle to cycle (a one-ulp
# perturbation of M moves x by > 1e-10 in 20 cycles at 128², a linear M's
# by < 1e-12: tests/test_torch_family_counts.py), so the count follows the
# reductions' rounding (the port's CPU: 116 restarts against 111) and is
# held to 15% of gmres_tpu's.
FGMRES_N = 300
JAX_FGMRES_300 = (111, 8)
FGMRES_SPREAD = 0.15
# Phase 18: the short-recurrence family and the real models. gmres_tpu's
# counts for each row, from the JAX package on the CPU (float64):
#   JAX_PLATFORMS=cpu python3 scripts/jax_phase18_counts.py
# which drives the same programs (multirhs --solver block-cg, varcoef) and
# public functions with the configurations below. The Poisson rows take
# b = A·1 and tol 1e-9·‖b‖ (absolute, as each solver takes tol) with the
# Poisson V-cycle; the multirhs and block rows tol 1e-8 per right-hand side.
SHORT_REPEATS = 1
BLOCK_CG_S = 4
POISSON_1024 = 1024
SSTEP_CG_S = 4
# chebyshev_solve on Poisson 1024² with the exact bounds: an order-k cycle
# contracts the error by 1/T_k((λmax+λmin)/(λmax−λmin)), 0.9988 at order 16
# there (about 17,000 cycles to 1e-9, past the 1000-cycle default in
# gmres_tpu too), 0.40 at order 512. So the 1024² row runs order 512 (K2's
# per-sweep path: 511 launches a call), and order 16 runs at 64², where
# it contracts by 0.76 a cycle and K2 takes one launch (its cluster path).
CHEB_ORDER_1024 = 512
CHEB_SMALL = (64, 16)
POISSON3D_N = 128
ANISO_N, ANISO_EPS = 1024, 0.01
VARCOEF_DEFAULT_N = 256
VARCOEF_N = 1024
VARCOEF_CONTRAST = 1e5
# Each entry: (iterations or cycles, status), the multirhs program's
# iterations by s, the varcoef program's (iterations, L2 error) by row, and
# the 1024² mg+defl row's (iterations, status, L2 error).
JAX_PHASE18 = {
    "multirhs": {1: 15, 2: 14, 4: 14, 8: 13},
    "block_cg": (14, 0),
    "minres": (13, 0),
    "sstep_cg": (16, 0),
    "chebyshev": (22, 0),
    "chebyshev64": (69, 0),
    "poisson3d": (13, 0),
    "anisotropic": (12, 0),
    "varcoef": {"varcoef-jacobi-256x256": (413, 2.244026490945668),
                "varcoef-jacobi+defl-256x256": (414, 0.028112200238658142),
                "varcoef-mg-256x256": (20, 0.45603032816166217),
                "varcoef-mg+defl-256x256": (21, 0.0007861187588659232)},
    "varcoef1024": (12, 0, 0.7982120608812189),
}
# Phase 19: Helmholtz and the solvers that need Aᵀ or J·v. gmres_tpu's counts
# for each row, from the JAX package on the CPU (float64):
#   JAX_PLATFORMS=cpu python3 scripts/jax_phase19_counts.py
# which drives the same programs (helmholtz, sequence, bratu, convdiff
# --solver qmr) and functions (qmr with the cycle and its transpose, lsqr,
# lsmr). Program rows: [name, iterations, restarts, extras]; function rows:
# (iterations, status).
PHASE19_REPEATS = 1
RULE_N = 1024
HELM_N, HELM_FACTOR = 1024, 10.0
# The programs' defaults: helmholtz, sequence, bratu. The sequence program
# runs at all of its defaults (128², k 10, restart 40, kh2 factors 10, 10.5,
# 11); 10·λ_min takes 116 GCRO-DR cycles fresh and warm (6–7 s a solve on an
# H100), and the program solves each row twice (a warm-up, then the timed
# solve), ~50 s in all.
HELM_PROGRAM_N, SEQUENCE_N, BRATU_PROGRAM_N = 256, 128, 256
# The split-CSL rows take 5–10 s a solve on an H100 (~1000 eager kernels an
# iteration): one timed solve each after a one-cycle warm-up.
CSL_SPLIT_REPEATS = 1
CSL_SPLIT_N, CSL_COMPLEX_N = 512, 256
CSL_SPLIT_RESTART, CSL_COMPLEX_RESTART, CSL_DEFLATE = 120, 60, 20
HELM_TOL = 1e-9
BRATU_N, BRATU_TOL = 1024, 1e-10
QMR_N = 1024
# gmres_tpu's convdiff --solver qmr at its 256² default (no preconditioner,
# absolute tol 1e-9) stalls at ‖r‖ 4.93 and ends at its cap (status 1): after
# 2000 iterations as after 10000 (~1.6 ms an iteration on an H100, so the
# default's 10000 twice would take ~32 s). The program runs at 256² with
# --max-iterations QMR_PROGRAM_CAP, held to gmres_tpu's count, status and
# residual there, and at 32², where it converges in 111.
QMR_PROGRAM_N, QMR_PROGRAM_DEFAULT_N, QMR_PROGRAM_CAP = 32, 256, 2000
# LSQR and LSMR on convdiff (0.4, 0.2), b = A·1, tol 1e-9 at 128²: gmres_tpu
# takes 4361 and 4183 bidiagonalisation steps (host-bound at ~2 ms a step on
# an H100): a warm-up of LSQ_WARMUP steps, then one timed solve each; the
# profile (LSQR) covers the first LSQ_WARMUP steps.
LSQ_N, LSQ_REPEATS, LSQ_WARMUP = 128, 1, 200
IMPLICIT_N = 256
# MINRES's count follows the last bits of M: gmres_tpu's CPU cycle rounds
# with XLA's fused multiply-adds (3e-16 relative from the port's at 32²), and
# at 32² the port takes 23 steps against gmres_tpu's 25, or 25 with
# gmres_tpu's M (tests/test_torch_helmholtz.py); its 1024² CPU solve takes 35
# against 34. The float32 split-CSL GMRES takes one restart cycle less or
# more with the float32 sums. GCRO-DR's host eigensolves split close
# harmonic Ritz values otherwise than JAX. The bands below hold
# these rows (tests/test_torch_helmholtz.py and test_torch_cli.py pin them);
# every other count is held within 2.
HELM_MINRES_BAND = 0.15
CSL_SPLIT_BAND = 120 + 2
SEQUENCE_BAND = 0.15
# Newton-Krylov's inner count with float32 inner bases follows the float32
# sums (tests/test_torch_newton_implicit.py: 265 against 250 at 32²).
NEWTON_F32_BAND = 0.10
JAX_PHASE19 = {
    "helmholtz256": [["minres-helmholtz-256x256", 29, None]],
    "helmholtz1024": [["minres-helmholtz-1024x1024", 34, None]],
    "helmholtz1024_mixed": [["minres-helmholtz-1024x1024", 50, None]],
    "csl_split512": [["gmres-csl-helmholtz-512x512", 108, 3, 348]],
    "csl_split512_gcrodr": [["gcrodr-csl-helmholtz-512x512", 23, 3, 263]],
    "csl_complex256": [["gmres-csl-helmholtz-256x256", 25, 2, 85]],
    "sequence": [["gcrodr-fresh-helmholtz-128x128", 23, 116, 10.0],
                 ["gcrodr-warm-helmholtz-128x128", 23, 116, 10.0],
                 ["gcrodr-fresh-helmholtz-128x128", 15, 39, 10.5],
                 ["gcrodr-warm-helmholtz-128x128", 4, 65, 10.5],
                 ["gcrodr-fresh-helmholtz-128x128", 22, 64, 11.0],
                 ["gcrodr-warm-helmholtz-128x128", 26, 71, 11.0]],
    "bratu256": [["jfnk-bratu-256x256", 5, None, 5, 22]],
    "bratu1024": [["jfnk-bratu-1024x1024", 6, None, 6, 30]],
    "bratu1024_mixed": [["jfnk-bratu-1024x1024", 5, None, 5, 77]],
    "qmr_mg1024": (45, 0),
    "convdiff_qmr32": [["qmr-convdiff-32x32", 111, None]],
    "convdiff_qmr256_cap": [["qmr-convdiff-256x256", 2000, None, 4.92643881229037]],
    "lsqr128": (4361, 0),
    "lsmr128": (4183, 0),
}

# Phase 20: the eigensolvers, matrix functions, time steppers and the
# Nyström and SPAI preconditioners. gmres_tpu's numbers for each row, from the
# JAX package on the CPU (float64):
#   JAX_PLATFORMS=cpu python3 scripts/jax_phase20_counts.py
# which drives the same programs (eig with each method, slq, evolve) and
# functions (nystrom_preconditioner under CG, spai_preconditioner under
# BiCGSTAB). The eig program's start blocks, the slq probes and the Nyström
# sketch are the port's own draws (torch Generators; gmres_tpu draws from
# PRNGKeys no torch Generator reproduces), so the counts are held to bands:
# LOBPCG's within 15% (at least 2); a Krylov–Schur count that ends at the
# 200-cycle cap is held to the cap, one that converges within 15%; subspace
# iteration runs its fixed 200 iterations; the evolve trajectories' inner
# totals within 15% (GCRO-DR's host eigensolves split close harmonic Ritz
# values otherwise than JAX's, as in phase 19); CG and BiCGSTAB with the
# preconditioners within 15% (BICGSTAB_SPREAD: the count moves with the
# reductions' order).
PHASE20_REPEATS = 1
EIG_K = 4
LOBPCG_BIG_N = 1024
EIG_CD_N, EIG_GAMMA, EIG_STEPS = 256, (2.0, 0.5), 40
# γ at which the 256² eigenvalues are computable: the operator is D T D⁻¹
# with T symmetric and κ(D) ≈ 2·10³ here (≈ 10^122 at EIG_GAMMA).
EIG_MILD_GAMMA = (0.02, 0.01)
SLQ_N, SLQ_PROBES, SLQ_STEPS = 512, (8, 16, 32), 40
EVOLVE_N, EVOLVE_STEPS = 256, 50
NYSTROM_N, NYSTROM_RANK = 512, 64
SPAI_N = 128
LOBPCG_BAND = 0.15
EIG_BANDS = {"arnoldi": 0.15, "ks_real": 0.15, "subspace": 0}
EVOLVE_BAND = 0.15
PRECOND_BAND = 0.15
# The Nyström sketch's λ̂ ends against gmres_tpu's (another Gaussian sketch
# of the same operator: 0.07% and 0.08% apart on the H100).
NYSTROM_LAM_BAND = 0.01
# Subspace iteration's 200 iterations at EIG_MILD_GAMMA leave its Ritz
# values short of the clustered top (gmres_tpu 0.0176 from its start block,
# the port 0.0174 on the CPU from its own): held to this distance.
SUBSPACE_MILD_ERROR = 0.025
# Krylov–Schur profiles cover at most this many restart cycles (a profile of
# tens of thousands of kernels costs the profiler tens of seconds).
PROFILE_CYCLES = 10
# Exponential Euler at 256², 50 steps of e^{−Δt L} by 30 Lanczos steps each,
# against the sine-transform solution.
EXPM_ERROR = 1e-10
# With the σ-shifted cycle as M, GCRO-DR's tol is on the preconditioned
# residual; the numpy check of the unpreconditioned ‖rhs − S u‖/‖rhs‖ of
# each step is held to this.
EVOLVE_MG_NUMPY = 1e-6
JAX_PHASE20 = {
    # (rtol, iterations)
    "lobpcg256": (0.0, 23),
    "lobpcg1024": (1e-4, 20),
    # At the program's defaults neither Krylov–Schur converges in 200 cycles
    # in gmres_tpu (worst residual 0.0257 and 0.169): with κ(D) ≈ 10^122 the
    # Ritz values wander on the pseudospectrum, and where a run ends at the
    # cap is set by its rounding (the port's residuals there differ).
    "arnoldi256": [{"iterations": 200, "converged": False, "linf_error": 2.1589917780913783,
                    "residual": 0.02571018426771497}],
    "ksreal256": [{"iterations": 200, "converged": False, "linf_error": 1.1764726840207234,
                   "residual": 0.16934078648278386}],
    "subspace256": [{"iterations": 200, "converged": False, "linf_error": 3.8412167500474066}],
    # At EIG_MILD_GAMMA both Krylov–Schur bases converge; subspace iteration
    # runs its 200 iterations (its row carries no converged flag).
    "arnoldi256_mild": [{"iterations": 69, "converged": True, "linf_error": 2.723973867370504e-09,
                         "residual": 3.244488103942884e-09}],
    "ksreal256_mild": [{"iterations": 67, "converged": True, "linf_error": 1.0197210187357086e-08,
                        "residual": 9.413963754428227e-09}],
    "subspace256_mild": [{"iterations": 200, "converged": False,
                          "linf_error": 0.017606006879864466}],
    "slq512": [{"value": 306299.2263552081, "stderr": 110.12916621178493},
               {"value": 305853.5488507596, "stderr": 153.63959394978698},
               {"value": 306062.38715083024, "stderr": 114.45467657494768}],
    "evolve256": [{"iterations": 3763, "iters_step0": 74, "iters_last": 71,
                   "residual": 9.944165143759097e-10}],
    "evolve256_mg": [{"iterations": 1020, "iters_step0": 22, "iters_last": 18,
                      "residual": 9.684941925359981e-10}],
    "evolve256_expm": [{"iterations": 1500, "residual": 3.4865863234666942e-15}],
    # Nyström on a mesh Laplacian: the sketch holds the top of the spectrum,
    # CG's trouble is the bottom (gmres_tpu/precond/nystrom.py): no gain.
    "nystrom512": {"iterations": 1038, "plain_iterations": 1038,
                   "lam_max": 6.093317635049643, "lam_min": 5.974865390838207},
    "spai128": {"iterations": 139, "plain_iterations": 258},
}

# Phase 21: the distributed solve on a one-rank mesh (timed solves a row;
# row (c)'s tolerance, ~260 inner iterations; the level at and below which
# rows (d), (e) and (h) replicate their cycles; row (f)'s step cap, LSQR
# needing ~κ(A) ≈ 10⁵ steps to 1e-8 at 512²).
PHASE21_REPEATS = 1
P21_MG_ROWS = (("(a) mg 300", 300, 160), ("(b) mg 2048", 2048, 300))
P21_CBPR2_TOL = 1e-4
P21_MODEL_N = {"(d)": 1024, "(e)": 1024, "(h)": 512}
P21_REPLICATE_BELOW = 256
P21_LSQR_N, P21_LSQR_CAP = 512, 300
P21_WEAK_N = 128
P21_WEAK_SCALING = ["weak-scaling", "--max-devices", "1"]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def np_stencil(x):
    """Independent float64 5-point Laplacian in numpy (zero boundaries)."""
    import numpy as np

    y = 4.0 * x
    y[:, 1:] -= x[:, :-1]
    y[:, :-1] -= x[:, 1:]
    y[1:, :] -= x[:-1, :]
    y[:-1, :] -= x[1:, :]
    return y


def _events_ms(run, count: int) -> float:
    """Mean time of `count` units enqueued by run(), by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def call_ms(fn, reps: int) -> float:
    """Time of one eager call of fn, host launch overhead included: CUDA
    events around `reps` calls after a warm-up. For small kernels this is
    the host's launch rate, not the device's work."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _events_ms(run, reps)


def device_ms(fn, reps: int, per_graph: int = 10) -> float:
    """Device time of one call of fn: `per_graph` calls captured in a CUDA
    graph, replayed `reps` times, so the host's launch overhead is out of
    the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            graph.replay()

    return _events_ms(run, reps * per_graph)


def chained_slope(fn, short: int = 20, long: int = 40, reps: int = 20) -> float:
    """Device ms a call of fn adds to a chain: CUDA graphs of `short` and
    `long` calls, each replayed `reps` times; the slope between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    times = {}
    for k in (short, long):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(k):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times[k] = _events_ms(lambda g=graph: [g.replay() for _ in range(reps)], reps)
    return (times[long] - times[short]) / (long - short)


def host_us(fn, calls: int = 200) -> float:
    """Host µs to enqueue one call of fn (the host clock around `calls`
    calls with no synchronisation between them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def launch_floor(dev) -> dict:
    """The card's launch floor: an empty kernel (one CTA of one warp) as a
    chained slope, launched as the kernels are, and the host µs to enqueue
    it through ctypes."""
    import torch

    from gmres_tpu_torch.ops import _cuda

    lib = _cuda.load()

    def empty():
        rc = lib.gt_empty(dev.index, torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"empty kernel: CUDA error {rc}")

    return {"slope_ms": chained_slope(empty), "graph_ms": device_ms(empty, 50),
            "host_us": host_us(empty)}


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """The least time (ms) the card could take for work that must move
    `nbytes` and do `flops` in `dtype`, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_record(library, ref, reps: int) -> dict:
    """Time one PyTorch call that computes the kernel's function (eager
    calls between CUDA events: with enough work queued, the device time).
    A call that PyTorch refuses for this dtype or layout is reported."""
    import torch

    try:
        z = library()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        msg = str(exc).splitlines()[0][:160]
        return {"library_ms": None, "library_note": f"refused: {msg}"}
    err = float((z.reshape(-1) - ref.reshape(-1)).abs().max())
    scale = float(ref.abs().max())
    return {"library_ms": call_ms(library, reps),
            "library_rel_err": err / scale if scale > 0 else err}


def compare(name, kernel, plain, rtol, reps, work=None, library=None):
    """Run kernel and plain version on the same inputs; return a record.
    `work` is (bytes, flops, dtype, nnz or None) for the bound and the rate;
    `library` a callable of one PyTorch call computing the same function."""
    import torch

    z_k = kernel()
    z_p = plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(z_k).all()), f"{name}: kernel output not finite")
    abs_err = float((z_k - z_p).abs().max())
    scale = float(z_p.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    rec = {
        "case": name, "max_abs_err": abs_err, "max_rel_err": rel,
        "rtol": rtol, "ms": device_ms(kernel, reps),
        "plain_ms": device_ms(plain, reps),
        "call_ms": call_ms(kernel, reps), "plain_call_ms": call_ms(plain, reps),
        "bound_ms": None, "bound_by": None, "library_ms": None,
    }
    extra = ""
    if work is not None:
        nbytes, flops, dtype, nnz = work
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        rec["l2_resident"] = nbytes <= L2_BYTES
        extra += (f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                  f"{100 * rec['bound_ms'] / rec['ms']:.0f}% of it"
                  f"{'; L2-resident' if rec['l2_resident'] else ''})")
        if nnz:
            rec["gnnz_per_s"] = nnz / (rec["ms"] * 1e-3) / 1e9
            extra += f" {rec['gnnz_per_s']:.2f} Gnnz/s"
    if library is not None:
        rec.update(library_record(library, z_p, reps))
        if rec["library_ms"] is None:
            extra += f" library: {rec['library_note']}"
        else:
            extra += (f" library {rec['library_ms']:.4f} ms (eager, rel err "
                      f"{rec['library_rel_err']:.1e})")
    tol = "bitwise" if rtol == 0 else f"tol {rtol:.0e}"
    print(f"  {name:42s} rel_err {rel:.3e} ({tol})  device: kernel "
          f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms  eager call: "
          f"kernel {rec['call_ms']:.4f} ms plain {rec['plain_call_ms']:.4f} ms"
          f"{extra}", flush=True)
    require(rel <= rtol, f"{name}: kernel disagrees with plain version "
            f"(rel err {rel:.3e} > {rtol:.0e})")
    return rec


def stencil_work(n, dt, sweeps=0, halo=False):
    """One read of the grid and one write of the result; 9 flops a point for
    the stencil, 14 a point for each smoother sweep after z₀ = r/θ."""
    import torch

    item = torch.empty((), dtype=dt).element_size()
    flops = n * n * (9 if sweeps == 0 else 1 + 14 * sweeps)
    return (2 * n * n + (2 * n if halo else 0)) * item, flops, dt, None


def k2_compare(name, r, theta, steps, coefs, rtol, reps, sweeps, must_beat_sweep=True):
    """K2 on the path chebk_plan routes, against its plain version (compare),
    then against the per-sweep path in the same run: the same bits, and a
    time no worse than the per-sweep path's (3% for noise) where
    `must_beat_sweep`; elsewhere a slower routed path is printed, not
    refused (chebk_plan was set from the Poisson shapes)."""
    import torch

    from gmres_tpu_torch.ops import fused

    path = fused.chebk_plan(*r.shape, len(steps) // 2, r.dtype)
    n = r.shape[0]
    rec = compare(name, lambda: fused.chebk_cuda(r, theta, steps, coefs),
                  lambda: fused.poly_stencil_smoother_plain(r, theta, steps, coefs),
                  rtol, reps, work=stencil_work(n, r.dtype, sweeps=sweeps))
    z_c = fused.chebk_cuda(r, theta, steps, coefs, _path=("sweep", None))
    z_k = fused.chebk_cuda(r, theta, steps, coefs)
    torch.cuda.synchronize()
    require(torch.equal(z_k, z_c), f"{name}: the {path[0]} path differs from the "
            "per-sweep path")
    rec["path"], rec["param"] = path
    rec["sweep_ms"] = device_ms(
        lambda: fused.chebk_cuda(r, theta, steps, coefs, _path=("sweep", None)), reps)
    print(f"  {name:42s} path {path[0]} {path[1]}: {rec['ms']:.4f} ms, per-sweep "
          f"path {rec['sweep_ms']:.4f} ms ({rec['sweep_ms'] / rec['ms']:.2f}x), bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); bitwise equal to the "
          "per-sweep path", flush=True)
    if must_beat_sweep:
        require(rec["ms"] <= 1.03 * rec["sweep_ms"],
                f"{name}: the {path[0]} path is slower than the per-sweep path")
    elif rec["ms"] > 1.03 * rec["sweep_ms"]:
        print(f"  {name}: the routed {path[0]} path is SLOWER than the per-sweep "
              "path here", flush=True)
    return rec


def phase_kernels(gt_torch, rng, dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.ops import fused, stencil

    sizes = (300, 150, 128, 75, 1024, 2048)
    records = {"K1": [], "K2": []}
    print("phase 3: kernels against their plain versions", flush=True)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    cross = [[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]]
    for n in sizes:
        reps = 200 if n <= 300 else 50
        for dt, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-14)):
            tag = "f32" if dt == torch.float32 else "f64"
            x = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            top = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            bot = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            w = torch.tensor(cross, dtype=dt, device=dev).reshape(1, 1, 3, 3)
            # K1's yardstick: the cross kernel as a convolution (cuDNN, TF32
            # off), at the largest grid.
            conv = ((lambda: F.conv2d(x[None, None], w, padding=1)[0, 0])
                    if n == sizes[-1] else None)
            records["K1"].append(compare(
                f"K1 {n}x{n} {tag}",
                lambda: stencil.stencil5_cuda(x, None, None, coefs),
                lambda: stencil.stencil_5pt_general(x, *coefs), rtol, reps,
                work=stencil_work(n, dt), library=conv))
            records["K1"].append(compare(
                f"K1 {n}x{n} {tag} halo rows",
                lambda: stencil.stencil5_cuda(x, top, bot, coefs),
                lambda: stencil.stencil_5pt_halo(x, top, bot, coefs),
                rtol, reps, work=stencil_work(n, dt, halo=True)))
            # Order-3 smoother on [2, 8]: the V-cycle's pre/post smoother.
            theta, _, steps = fused.chebyshev_k_scalars(2.0, 8.0, 3)
            records["K2"].append(k2_compare(
                f"K2 order 3 {n}x{n} {tag}", x, theta, steps, coefs,
                1e-5 if dt == torch.float32 else 1e-13, reps, 2))
    for n in (75, 16):
        lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
        theta, _, steps = fused.chebyshev_k_scalars(lam_min, 8.0, 32)
        for dt, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            tag = "f32" if dt == torch.float32 else "f64"
            r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            records["K2"].append(k2_compare(
                f"K2 order 32 {n}x{n} {tag} (coarse solve)", r, theta, steps, coefs,
                rtol, 200, 31))
    # Damped Jacobi on a general (non-symmetric) stencil.
    gcoefs = (4.0, -1.2, -0.8, -1.1, -0.9)
    theta, steps = fused.jacobi_k_scalars(0.7, gcoefs[0], 8)
    r = torch.as_tensor(rng.standard_normal((300, 300))).to(dev, torch.float32)
    records["K2"].append(k2_compare(
        "K2 Jacobi order 8 300x300 f32 general coefs", r, theta, steps, gcoefs,
        1e-5, 200, 7))
    return records


def form_record(name, kernel, plain, work, reps, floor, library=None, sets=1) -> dict:
    """A redesigned kernel (one or several outputs) against its plain
    version: bitwise, then device ms by CUDA-graph replay beside the bound
    and the launch floor, host µs to enqueue, and the library call's time.
    Callables made by `cycling` over `sets` input sets start at the first,
    so the first calls compare one set; the working set of all of them is
    flagged l2_resident where it fits the L2."""
    import torch

    outs_k, outs_p = kernel(), plain()
    torch.cuda.synchronize()
    if isinstance(outs_k, torch.Tensor):
        outs_k, outs_p = (outs_k,), (outs_p,)
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        require(bool(torch.isfinite(a).all()), f"{name}: output {i} not finite")
        require(torch.equal(a, b), f"{name}: output {i} is not bitwise equal to "
                f"the plain version (max abs err {float((a - b).abs().max()):.3e})")
    rec = {"case": name, "max_abs_err": 0.0, "max_rel_err": 0.0, "rtol": 0.0,
           "ms": device_ms(kernel, reps), "plain_ms": device_ms(plain, reps),
           "host_us": host_us(kernel), "plain_host_us": host_us(plain),
           "floor_ms": floor["slope_ms"], "library_ms": None, "input_sets": sets,
           "l2_resident": work[0] * sets <= L2_BYTES}
    rec["bound_ms"], rec["bound_by"] = bound(*work[:3])
    extra = ""
    if library is not None:
        rec.update(library_record(library, outs_p[0], reps))
        extra = (f" library {rec['library_ms']:.4f} ms" if rec["library_ms"] is not None
                 else f" library: {rec['library_note']}")
    where = "L2-resident" if rec["l2_resident"] else f"HBM, {sets} input sets"
    print(f"  {name:46s} bitwise  device: kernel {rec['ms']:.4f} ms plain "
          f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; "
          f"{where}) = {rec['ms'] / rec['bound_ms']:.2f}x; floor {rec['floor_ms']:.5f} ms "
          f"= {rec['ms'] / rec['floor_ms']:.2f}x  host: kernel {rec['host_us']:.2f} us "
          f"plain {rec['plain_host_us']:.2f} us{extra}", flush=True)
    return rec


def cycling(calls):
    """One callable that runs `calls` in turn, the first at its first call."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def offset_copy(t):
    """t's values in a contiguous tensor one element past an aligned start:
    no 16-byte access of it is aligned, so K1 takes one point a thread."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def restrict_conv(r, e, coefs):
    """residual-restrict's yardstick, one F.conv2d: restrict_sum(r − A e) is
    a 4×4, stride-2 correlation of the pair (r, e) with padding 1; r's
    weights are the quad's ones, e's minus the sum of the quad's stencils."""
    import torch
    import torch.nn.functional as F

    c0, cw, ce, cs, cn = coefs
    w = torch.zeros((1, 2, 4, 4), dtype=torch.float64)
    for qi in (1, 2):
        for qj in (1, 2):
            w[0, 0, qi, qj] = 1.0
            for (di, dj), cv in (((0, 0), c0), ((0, -1), cw), ((0, 1), ce),
                                 ((-1, 0), cs), ((1, 0), cn)):
                w[0, 1, qi + di, qj + dj] -= cv
    w = w.to(r.device, r.dtype)
    pair = torch.stack([r, e])[None]
    return lambda: F.conv2d(pair, w, stride=2, padding=1)[0, 0]


def phase_redesigned(gt_torch, rng, dev):
    """Phase 3, second part: the launch floor, K1's two V-cycle forms, and
    K1 and K5 with null halo rows, against their plain versions at the
    shapes the paths run. At 2048² each row cycles through HBM_SETS input
    sets. Returns the records and the floor."""
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.ops import fused, stencil

    print("phase 3: the launch floor and the redesigned K1 and K5", flush=True)
    floor = launch_floor(dev)
    print(f"  empty kernel: chained slope {floor['slope_ms'] * 1e3:.3f} us; graph "
          f"replay of 10 {floor['graph_ms'] * 1e3:.3f} us a launch; host "
          f"{floor['host_us']:.2f} us to enqueue", flush=True)
    coefs = stencil.POISSON_COEFS
    records = {"K1rr": [], "K1cr": [], "K1": [], "K5": []}

    def grids(n, dt, shapes):
        """Input sets of the given shapes: HBM_SETS at 2048², else one."""
        return [[torch.as_tensor(rng.standard_normal(sh)).to(dev, dt) for sh in shapes]
                for _ in range(HBM_SETS if n >= 2048 else 1)]

    for n, dtname in FORM_SHAPES:
        dt = getattr(torch, dtname)
        tag = "f32" if dt == torch.float32 else "f64"
        item = torch.empty((), dtype=dt).element_size()
        sets = grids(n, dt, ((n, n), (n, n), (n // 2, n // 2)))
        reps = 200 if n <= 304 else 50
        records["K1rr"].append(form_record(
            f"K1 residual-restrict {n}x{n} -> {n // 2} {tag}",
            cycling([lambda r=r, e=e: stencil.residual_restrict_cuda(r, e, coefs)
                     for r, e, _ in sets]),
            cycling([lambda r=r, e=e: stencil.residual_restrict_plain(r, e, coefs)
                     for r, e, _ in sets]),
            # r and e read, rc written; 10 flops a fine point and 3 a quad.
            ((2 * n * n + n * n // 4) * item, 10.75 * n * n, dt), reps, floor,
            library=cycling([restrict_conv(r, e, coefs) for r, e, _ in sets]),
            sets=len(sets)))
        records["K1cr"].append(form_record(
            f"K1 correct-residual {n}x{n} <- {n // 2} {tag}",
            cycling([lambda r=r, e=e, ec=ec: stencil.correct_residual_cuda(r, e, ec, coefs)
                     for r, e, ec in sets]),
            cycling([lambda r=r, e=e, ec=ec: stencil.correct_residual_plain(r, e, ec, coefs)
                     for r, e, ec in sets]),
            # r, e and ec read, e' and r3 written; 11 flops a fine point.
            ((4 * n * n + n * n // 4) * item, 11 * n * n, dt), reps, floor,
            sets=len(sets)))
    cross = [[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]]
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)
    for n, dt in ((STRONG_N, torch.float64), (300, torch.float32), (150, torch.float32),
                  (2048, torch.float32)):
        tag = "f32" if dt == torch.float32 else "f64"
        xs = [x for (x,) in grids(n, dt, ((n, n),))]
        w = torch.tensor(cross, dtype=dt, device=dev).reshape(1, 1, 3, 3)
        # At 2048² the stencil takes 16-byte row chunks; inputs one element
        # off alignment take it back to one point a thread, the design the
        # smaller grids use.
        designs = ({"16-byte row chunks": xs, "one point a thread": [offset_copy(x) for x in xs]}
                   if n >= 2048 else {"one point a thread": xs})
        for design, inputs in designs.items():
            records["K1"].append(form_record(
                f"K1 {n}x{n} {tag} null halo rows, {design}",
                cycling([lambda x=x: stencil.stencil5_cuda(x, None, None, coefs)
                         for x in inputs]),
                cycling([lambda x=x: stencil.stencil_5pt_general(x, *coefs) for x in inputs]),
                stencil_work(n, dt), 200 if n <= 304 else 50, floor,
                library=cycling([lambda x=x: F.conv2d(x[None, None], w, padding=1)[0, 0]
                                 for x in inputs]),
                sets=len(inputs)))
        if n == STRONG_N:
            x = xs[0]
            records["K5"].append(form_record(
                f"K5 {n}x{n} {tag} null halo rows",
                lambda: fused.cheb2_cuda(x, None, None, d, alpha, coefs),
                lambda: fused.chebyshev_poisson_fused_plain(x, None, None, d, alpha, coefs),
                (2 * n * n * x.element_size(), 14 * n * n, dt), 200, floor,
                library=cheb2_conv(x, None, None, d, alpha, coefs)))
    return records, floor


# ---------------------------------------------------------------------------
# K2's path table (`python3 chip_smoke.py --k2-paths [out.jsonl]`): every
# path that can take each multigrid shape, forced, timed beside the per-sweep
# path and held bitwise to it. ops/fused.py's chebk_plan is set from it.
# ---------------------------------------------------------------------------

K2_PATH_SIZES = (16, 32, 64, 75, 128, 150, 256, 300, 512, 1024, 2048, 4096)
K2_TILES = ((8, 32), (16, 32), (16, 64), (32, 64), (16, 128), (32, 128), (64, 64),
            (16, 256), (32, 256), (64, 128), (8, 128), (8, 256))


def k2_candidates(r, nsteps):
    """Every cluster size (with each ghost depth) and tile (with each thread
    count) that can take r."""
    from gmres_tpu_torch.ops import fused

    rows, cols = r.shape
    item = r.element_size()
    out = [("sweep", None)]
    for c in fused.CLUSTER_SIZES:
        for g in ((0,) if c == 1 else (1, 2, 4, 8)):
            if (fused.cluster_fits(rows, cols, c, g, item)
                    and fused._cluster_schedulable(item == 8, rows, cols, c,
                                                   fused.cluster_threads(rows, cols, c, g),
                                                   g, r.device.index) > 0):
                out.append(("cluster", (c, g)))
    for t in K2_TILES:
        if t[0] > 2 * rows or t[1] > 2 * cols:
            continue
        if fused.tile_fits(t, nsteps, item):
            th = fused.tile_threads(t, nsteps, item)
            out.extend(("tiled", (*t, n)) for n in sorted({th, min(512, 2 * th)}))
    return out


def k2_paths(dev, out_path=None) -> None:
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused

    rng = np.random.default_rng(SEED)
    rows_out = []
    print("K2 paths: device ms per call (CUDA-graph replay); every fused path "
          "bitwise equal to the per-sweep path", flush=True)
    for n in K2_PATH_SIZES:
        for order in ((3, 8, 32) if n <= 512 else (3, 8)):
            for dt in (torch.float32, torch.float64):
                tag = "f32" if dt == torch.float32 else "f64"
                lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2
                theta, _, steps = fused.chebyshev_k_scalars(
                    lam_min if order > 3 else 2.0, 8.0, order)
                r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
                ref = fused.chebk_cuda(r, theta, steps, _path=("sweep", None))
                reps = 20 if n <= 512 else 5
                times = {}
                for path in k2_candidates(r, order - 1):
                    z = fused.chebk_cuda(r, theta, steps, _path=path)
                    torch.cuda.synchronize()
                    require(torch.equal(z, ref), f"K2 {path} {n}x{n} order {order} "
                            f"{tag}: not bitwise equal to the per-sweep path")
                    t = device_ms(lambda p=path: fused.chebk_cuda(r, theta, steps, _path=p),
                                  reps)
                    times[path] = t
                    rows_out.append({"n": n, "order": order, "dtype": tag,
                                     "path": path[0], "param": path[1], "ms": t})
                t_c = times[("sweep", None)]
                best = {}
                for (p, param), t in times.items():
                    if p not in best or t < best[p][1]:
                        best[p] = (param, t)
                print(f"  {n:5d}² order {order:2d} {tag}: sweep {t_c:.4f}"
                      + "".join(f"  {p} {best[p][0]} {best[p][1]:.4f} "
                                f"({t_c / best[p][1]:.2f}x)"
                                for p in ("cluster", "tiled") if p in best), flush=True)
                del r, ref
    if out_path:
        with open(out_path, "w") as f:
            for row in rows_out:
                f.write(json.dumps(row) + "\n")


# ---------------------------------------------------------------------------
# Phase 7: K3 and K4.
# ---------------------------------------------------------------------------


def dia_work(a):
    """Bytes: the coefficient array, x and y once each; flops: a multiply
    and an add for each nonzero coefficient."""
    n_rows, n_cols = a.shape
    item = a.data.element_size()
    nnz = int((a.data != 0).sum())
    return (a.data.numel() + n_rows + n_cols) * item, 2 * nnz, a.data.dtype, nnz


def bsr_work(a):
    """Bytes: the blocks, the block columns, x and y once each; flops: a
    multiply and an add for each stored block entry."""
    item = a.data.element_size()
    nbr, k, bs, _ = a.data.shape
    nbytes = a.data.numel() * item + a.block_cols.numel() * 4 + 2 * nbr * bs * item
    nnz = int((a.data != 0).sum())
    return nbytes, 2 * a.data.numel(), a.data.dtype, nnz


def csr_library(csr, dt):
    """PyTorch's sparse CSR tensor of a port CSRMatrix (the yardstick)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                       csr.data.to(dt), size=csr.shape,
                                       check_invariants=False)


def bsr_library(a):
    """PyTorch's sparse BSR tensor of a port BSRMatrix: its blocks without
    the all-zero padding blocks (a BSR row lists each block column once)."""
    import torch

    real = a.data.abs().amax(dim=(2, 3)) > 0
    counts = real.sum(dim=1)
    crow = torch.zeros(a.data.shape[0] + 1, dtype=torch.int32,
                       device=a.data.device)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_bsr_tensor(crow, a.block_cols[real], a.data[real],
                                       size=a.shape, check_invariants=False)


def block_tridiagonal(gt_torch, nbr, bs, dt, dev, gen):
    """Random (bs, bs) blocks on the block tridiagonal, made on the card; the
    first and last block rows end in an all-zero padding block with block
    column 0, the layout bsr_from_dense gives."""
    import torch

    data = torch.randn((nbr, 3, bs, bs), generator=gen, device=dev,
                       dtype=torch.float64).to(dt)
    i = torch.arange(nbr, device=dev)
    cols = torch.stack([i - 1, i, i + 1], dim=1)
    cols[0] = torch.tensor([0, 1, 0], device=dev)
    cols[-1] = torch.tensor([nbr - 2, nbr - 1, 0], device=dev)
    data[0, 2] = 0.0
    data[-1, 2] = 0.0
    return gt_torch.BSRMatrix(data=data, block_cols=cols.to(torch.int32),
                              shape=(nbr * bs, nbr * bs))


def cast_dia(gt_torch, a, dt):
    return gt_torch.DIAMatrix(data=a.data.to(dt), offsets=a.offsets,
                              shape=a.shape)


def phase_sparse_kernels(gt_torch, rng, a_small, dev):
    """K3 and K4 against their plain versions; returns the records, the HYB
    matrices built on the way (reused by the solves) and the BSR form of
    the dense Poisson matrix ``a_small``."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import sparse

    records = {"K3": [], "K4": []}
    hyb = {}
    print("phase 7: sparse kernels against their plain versions", flush=True)
    for n in sorted(SPMV_GRIDS + CG_GRIDS[-1:]):
        t0 = time.perf_counter()
        csr = gt_torch.poisson_csr(n, device=dev)
        hyb[n] = gt_torch.csr_to_hyb(csr)
        print(f"  poisson_csr + csr_to_hyb {n}x{n} on the host: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        require(hyb[n].ell is None and hyb[n].dia.offsets == (-n, -1, 0, 1, n),
                f"csr_to_hyb {n}: the Poisson matrix is not pure DIA")
        reps = 200 if n <= 1000 else 50
        for dt in (torch.float32, torch.float64):
            if n not in SPMV_GRIDS and dt == torch.float32:
                continue  # the CG path's shape, which is float64
            tag = "f32" if dt == torch.float32 else "f64"
            x = torch.as_tensor(rng.standard_normal(n * n)).to(dev, dt)
            lib = csr_library(csr, dt)
            mats = [("HYB", cast_dia(gt_torch, hyb[n].dia, dt))]
            if n in SPMV_GRIDS:
                mats.insert(0, ("poisson_dia", gt_torch.poisson_dia(n, dtype=dt,
                                                                    device=dev)))
            for label, a in mats:
                records["K3"].append(compare(
                    f"K3 {label} {n}x{n} {tag}",
                    lambda: sparse.dia_spmv_cuda(a, x),
                    lambda: sparse.dia_spmv(a, x), 0.0, reps,
                    work=dia_work(a), library=lambda: lib @ x))
    # Wide and ragged offsets (the shape of tests/test_sparse.py's wide case).
    n, offsets = WIDE_DIA
    dense = np.zeros((n, n))
    for off in offsets:
        dense += np.diag(rng.standard_normal(n - abs(off)), k=off)
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        a = gt_torch.dia_from_dense(dense, device=dev, dtype=dt)
        lib = csr_library(gt_torch.csr_from_dense(dense, device=dev), dt)
        x = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
        records["K3"].append(compare(
            f"K3 wide offsets {n} {tag}", lambda: sparse.dia_spmv_cuda(a, x),
            lambda: sparse.dia_spmv(a, x), 0.0, 200, work=dia_work(a),
            library=lambda: lib @ x))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for label, nbr, bs in BSR_CASES:
        base = block_tridiagonal(gt_torch, nbr, bs, torch.float64, dev, gen)
        for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
            tag = "f32" if dt == torch.float32 else "f64"
            a = gt_torch.BSRMatrix(data=base.data.to(dt),
                                   block_cols=base.block_cols, shape=base.shape)
            x = torch.as_tensor(rng.standard_normal(nbr * bs)).to(dev, dt)
            lib = bsr_library(a)
            records["K4"].append(compare(
                f"K4 {label} {tag}", lambda: sparse.bsr_spmv_cuda(a, x),
                lambda: sparse.bsr_spmv(a, x), rtol, 200 if nbr < 100 else 50,
                work=bsr_work(a), library=lambda: lib @ x))
    n = SMALL_GRID
    bsr_small = gt_torch.bsr_from_dense(a_small, n, device=dev)
    x = torch.as_tensor(rng.standard_normal(n * n)).to(dev, torch.float64)
    lib = bsr_library(bsr_small)
    records["K4"].append(compare(
        f"K4 Poisson {n}x{n} in {n}x{n} blocks f64 (the CG path)",
        lambda: sparse.bsr_spmv_cuda(bsr_small, x),
        lambda: sparse.bsr_spmv(bsr_small, x), 1e-13, 200,
        work=bsr_work(bsr_small), library=lambda: lib @ x))
    return records, hyb, bsr_small


def local_v_cycle(gt_torch, n):
    """The unfused V-cycle, built here from public pieces: K2 through
    poly_stencil_smoother_pallas with the plan's (θ, steps), and the
    composition the V-cycle ran before K1's fused forms (K1 through
    stencil_5pt_routed, restrict_sum, prolong_repeat, torch's subtractions
    and adds). The same arithmetic as the package's cycle, so the same bits."""
    from gmres_tpu_torch.ops import stencil
    from gmres_tpu_torch.ops.fused import poly_stencil_smoother_pallas as smooth

    plan = gt_torch.poisson_multigrid_preconditioner(n).plan
    coarsest = len(plan.sizes) - 1

    def v_cycle(r, level):
        if level == coarsest:
            return smooth(r, *plan.coarse)
        e = smooth(r, *plan.pre_smooth)
        ec = v_cycle(gt_torch.restrict_sum(r - stencil.stencil_5pt_routed(e)), level + 1)
        e = e + gt_torch.prolong_repeat(ec)
        r3 = r - stencil.stencil_5pt_routed(e)
        return e + smooth(r3, *plan.post_smooth)

    m_inv = lambda r: v_cycle(r, 0)  # noqa: E731
    m_inv.levels, m_inv.plan = len(plan.sizes), plan
    return m_inv


def mg_solve(gt_torch, n, dev, m_inv=None):
    import numpy as np
    import torch

    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    op = gt_torch.poisson_operator(n)
    m_inv = m_inv or gt_torch.poisson_multigrid_preconditioner(n)

    def solve():
        return gt_torch.gmres(op, b, restart=10, tol=TOL, M=m_inv,
                              compute_v_err=False, inner_dtype=torch.float32,
                              certify="true")

    return b_np, m_inv, solve


def mg_counters(reset: bool = False) -> dict:
    """The launch counts of the kernels the mg solves run (set to 0 first
    where `reset`): each kernel's single-grid and batched launches together
    ("K1", …; a block application through row_apply's vmap is one batched
    launch), the batched ones also apart ("K1 batched", …), and K2's by
    path."""
    from gmres_tpu_torch.ops import fused, stencil

    wrappers = {"K1": stencil.stencil5_cuda, "K1rr": stencil.residual_restrict_cuda,
                "K1cr": stencil.correct_residual_cuda, "K2": fused.chebk_cuda}
    if reset:
        for w in wrappers.values():
            w.launches = w.batched_launches = 0
        fused.chebk_cuda.launches_by_path = dict.fromkeys(fused.chebk_cuda.launches_by_path, 0)
    out = {name: w.launches for name, w in wrappers.items()}
    out.update({f"K2 {p}": v for p, v in fused.chebk_cuda.launches_by_path.items()})
    out.update({f"{name} batched": w.batched_launches for name, w in wrappers.items()})
    return out


def phase_mg(gt_torch, dev):
    """Phase 4: the mg solves at 300² and 2048², the fused V-cycle (the
    package's) and the unfused one (built here) in turn, SOLVE_REPEATS each;
    the same iteration counts; launches counted over the fused solves; one
    profiled solve and one profiled V-cycle of each. Returns the launches
    and the measurements."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused

    launches, out = {}, {}
    for n in (300, 2048):
        variants = {"fused": mg_solve(gt_torch, n, dev),
                    "unfused": mg_solve(gt_torch, n, dev, local_v_cycle(gt_torch, n))}
        b_np, m_inv, _ = variants["fused"]
        results, times = {}, {"fused": [], "unfused": []}
        for name, (_, _, solve) in variants.items():
            timed(solve)  # warm-up
        count = dict.fromkeys(mg_counters(), 0)
        for i in range(SOLVE_REPEATS):
            for name in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
                mg_counters(reset=True)
                results[name], t_solve = timed(variants[name][2])
                times[name].append(t_solve)
                if name == "fused":
                    for k, v in mg_counters().items():
                        count[k] += v
        launches[n] = count
        res = results["fused"]
        rel = true_rel(b_np, res.x)
        counts = {k: ((r.restarts - 1) * 10 + r.iterations, r.restarts)
                  for k, r in results.items()}
        print(f"phase 4: mg {n}x{n} ({m_inv.levels} levels): status {res.status}, "
              f"{counts['fused'][0]} inner iterations, {res.restarts} restarts, "
              f"{res.host_syncs} host syncs, true rel residual {rel:.3e}; unfused "
              f"V-cycle: {counts['unfused'][0]} inner iterations, "
              f"{results['unfused'].restarts} restarts, status {results['unfused'].status}",
              flush=True)
        for name in ("fused", "unfused"):
            print(f"phase 4: mg {n}x{n} {name} V-cycle, wall s over {SOLVE_REPEATS} "
                  f"solves (in turn with the other): {quartiles(times[name])}", flush=True)
        print(f"phase 4: launches over the {SOLVE_REPEATS} fused solves: {count}; K2 plans: "
              f"{[fused.chebk_plan(m, m, 2, torch.float32) for m in m_inv.plan.sizes[:-1]]} "
              f"and coarse {fused.chebk_plan(*(m_inv.plan.sizes[-1],) * 2, 31, torch.float32)}",
              flush=True)
        prof = {name: profile_solve(variants[name][2], f"mg {n}x{n} {name} V-cycle",
                                    float(np.median(times[name])))
                for name in ("fused", "unfused")}
        r = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
        require(torch.equal(variants["fused"][1](r), variants["unfused"][1](r)),
                f"mg {n}: the fused and unfused V-cycles differ in their bits")
        per_cycle = {name: device_events(lambda m=variants[name][1]: m(r))
                     for name in ("fused", "unfused")}
        saved = (per_cycle["unfused"] - per_cycle["fused"]) / (m_inv.levels - 1)
        print(f"phase 4: mg {n}x{n} kernels per V-cycle: fused {per_cycle['fused']}, "
              f"unfused {per_cycle['unfused']} ({saved:.2f} fewer per non-coarsest "
              f"level); per solve: fused {prof['fused']['kernels']}, unfused "
              f"{prof['unfused']['kernels']}; device busy per solve: fused "
              f"{prof['fused']['busy_ms']:.3f} ms, unfused {prof['unfused']['busy_ms']:.3f} ms",
              flush=True)
        out[n] = {"counts": counts, "times": times, "profile": prof,
                  "kernels_per_cycle": per_cycle}
        require(res.status == 0, f"mg {n}: not converged (status {res.status})")
        require(rel <= TOL, f"mg {n}: true relative residual {rel:.3e} > {TOL}")
        require(counts["fused"] == counts["unfused"]
                and results["unfused"].status == 0,
                f"mg {n}: the fused and unfused V-cycles' counts differ: {counts}")
        require(count["K1"] > 0 and count["K2"] > 0 and count["K1rr"] > 0
                and count["K1cr"] > 0, f"mg {n}: a kernel was not launched: {count}")
        require(count["K1rr"] == count["K1cr"],
                f"mg {n}: residual-restrict and correct-residual launches differ")
        require(count["K2 cluster"] > 0 and (n < 2048 or count["K2 tiled"] > 0),
                f"mg {n}: K2 launches by path {count}")
        require(count["K2 cluster"] + count["K2 tiled"] + count["K2 sweep"] == count["K2"],
                f"mg {n}: K2 launches by path do not add up")
        require(tuple(res.x.shape) == (n, n), f"mg {n}: wrong x shape")
    return launches, out


def true_rel(b_np, x):
    import numpy as np

    x_np = x.detach().cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(b_np - np_stencil(x_np)) / np.linalg.norm(b_np))


def timed(solve):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    float(res.residual)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def profiled(fn, edge=PROFILE_EDGE_S):
    """fn() under torch.profiler. The first device events of a profile can
    go missing (16 of 20 one-kernel applications were counted once; on a
    loaded host two profiles in turn gave 0.4 kernels an application for
    1), so the profiler first runs a warm-up step, whose events it drops,
    and the recorded step opens and closes with spin kernels
    (torch.cuda._sleep), which device_kernels leaves out, and with `edge`
    host seconds on either side of fn, so that fn's kernels lie inside the
    step's window however the device's timestamps sit on the host clock
    (scripts/profile_edges.py varies it). Returns fn's result, the host
    seconds it took, and the profile's key_averages."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def spin():
        for _ in range(20):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        spin()
        time.sleep(PROFILE_WARMUP_S)
        prof.step()
        spin()
        time.sleep(edge)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(edge)
        spin()
    return out, seconds, prof.key_averages()


def device_kernels(events) -> list:
    """A profile's device events (kernels, copies and sets) other than its
    opening spin kernels."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and "spin_kernel" not in e.key]


def kernel_counts(events) -> tuple:
    """(kernels, copies and sets) among a profile's device events."""
    device = device_kernels(events)
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy", "Memset")))
    return sum(e.count for e in device) - copies, copies


def profile_solve(solve, tag: str, wall_median: float) -> dict:
    """Profile one solve: device time by kernel, kernels per solve, and the
    device's busy share of the profiled wall time and of the unprofiled
    median."""
    def run():
        res = solve()
        float(res.residual)

    _, wall, events = profiled(run)
    # Kernel and copy events only (an operator's own entry repeats the time
    # of the kernels it launched).
    busy_ms = sum(e.self_device_time_total for e in device_kernels(events)) / 1e3
    kernels, copies = kernel_counts(events)
    print(f"profile {tag}: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / (wall * 1e3):.1f}% of the profiled wall "
          f"{wall * 1e3:.3f} ms, {100 * busy_ms / (wall_median * 1e3):.1f}% of "
          f"the unprofiled median {wall_median * 1e3:.3f} ms; {kernels} kernels and "
          f"{copies} copies or sets on the device", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)
    return {"busy_ms": busy_ms, "wall_ms": wall * 1e3, "kernels": kernels,
            "copies": copies}


def device_events(fn) -> int:
    """Kernels (copies and sets excluded) that one call of fn runs on the
    device, by torch.profiler: the largest count, once two profiles have
    given it, of at most PROFILE_TRIES (an event can go missing from a
    profile; none is invented)."""
    counts = []
    while len(counts) < PROFILE_TRIES:
        counts.append(kernel_counts(profiled(fn)[2])[0])
        if counts.count(max(counts)) >= 2:
            break
    if len(set(counts)) > 1:
        print(f"profiled kernel counts disagree: {counts}; taking {max(counts)}",
              flush=True)
    return max(counts)


def cg_solve(gt_torch, mat, n, dev, variant="classic"):
    """cbpr2 CG on a sparse operator, b = A·1 (flat), the cg program's
    tolerance; returns b as numpy and a closure that solves."""
    import numpy as np

    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np.reshape(-1), dev)
    op = gt_torch.sparse_operator(mat)
    m_inv = gt_torch.chebyshev_preconditioner(op, *REF_EIG)

    def solve():
        return gt_torch.cg(op, b, tol=CG_TOL, M=m_inv, variant=variant)

    return b_np, solve


def abs_residual(b_np, x, n):
    """Independent float64 ‖b − A x‖ in numpy, x read as an (n, n) grid."""
    import numpy as np

    x_np = x.detach().cpu().numpy().astype(np.float64).reshape(n, n)
    return float(np.linalg.norm(b_np - np_stencil(x_np)))


def quartiles(times) -> str:
    import numpy as np

    return (f"median {np.median(times):.4f} quartiles "
            f"{np.percentile(times, 25):.4f}-{np.percentile(times, 75):.4f} "
            f"min {min(times):.4f} max {max(times):.4f}")


def phase_cg(gt_torch, hyb, dev):
    """Phase 8; returns K3's launches over the timed solves."""
    import numpy as np

    from gmres_tpu_torch.ops import sparse

    k3_total = 0
    iterations = {}
    for n in CG_GRIDS:
        b_np, solve = cg_solve(gt_torch, hyb[n], n, dev)
        res, t_warm = timed(solve)  # warm-up
        sparse.dia_spmv_cuda.launches = 0
        times = []
        for _ in range(CG_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k3 = sparse.dia_spmv_cuda.launches
        k3_total += k3
        iterations[n] = res.iterations
        err = abs_residual(b_np, res.x, n)
        print(f"phase 8: cbpr2 CG on HYB {n}x{n} f64: status {res.status}, "
              f"{res.iterations} iterations, {res.host_syncs} host syncs, "
              f"residual {float(res.residual):.3e}, numpy ‖b − A x‖ {err:.3e}; "
              f"wall s over {CG_REPEATS} solves: {quartiles(times)} (warm-up "
              f"{t_warm:.4f}); K3 launches {k3} = "
              f"{k3 / (CG_REPEATS * res.iterations):.3f} per iteration; "
              f"{1e3 * float(np.median(times)) / res.iterations:.4f} ms per "
              f"iteration", flush=True)
        if n == CG_GRIDS[-1]:
            profile_solve(solve, f"cg {n}x{n}", float(np.median(times)))
        require(res.status == 0, f"cg {n}: not converged (status {res.status})")
        require(err < CG_TOL, f"cg {n}: numpy residual {err:.3e} >= {CG_TOL}")
        require(k3 > 0, f"cg {n}: K3 not launched")
    # The pipelined recurrences drift from the true residual sooner than the
    # classic ones. At 300² and tol 1e-9, gmres_tpu's own pipelined solve
    # stops where classic CG stops, and its certification then finds
    # ‖b − A x‖ just above tol and downgrades it to BREAKDOWN
    # (tests/test_torch_cg.py::test_pipelined_certification_miss_matches_jax
    # pins the port to that). So the check here: the same iterations as
    # classic CG (±2), a true residual within 10% of tol, and CONVERGED or
    # that downgrade.
    n = CG_GRIDS[0]
    b_np, solve = cg_solve(gt_torch, hyb[n], n, dev, variant="pipelined")
    sparse.dia_spmv_cuda.launches = 0
    res, t_solve = timed(solve)
    k3 = sparse.dia_spmv_cuda.launches
    k3_total += k3
    err = abs_residual(b_np, res.x, n)
    print(f"phase 8: pipelined cbpr2 CG on HYB {n}x{n} f64: status {res.status}, "
          f"{res.iterations} iterations, {res.host_syncs} host syncs, numpy "
          f"‖b − A x‖ {err:.3e}, {t_solve:.4f} s, K3 launches {k3}", flush=True)
    require(res.status in (0, 2) and err < 1.1 * CG_TOL and k3 > 0
            and abs(res.iterations - iterations[n]) <= 2,
            f"pipelined cg {n}: failed")
    return k3_total


def phase_sparse_solvers(gt_torch, hyb, bsr_small, dev, ref_inner):
    """Phases 9 and 10; returns K4's launches in the BSR solve."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import sparse

    # Phase 9: GMRES in the reference configuration on the HYB operator,
    # against the stencil's inner iterations (ref_inner); CG on BSR.
    n = CG_GRIDS[0]
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np.reshape(-1), dev)
    op = gt_torch.sparse_operator(hyb[n])
    m_ref = gt_torch.chebyshev_preconditioner(op, *REF_EIG)
    res, t_hyb = timed(lambda: gt_torch.gmres(op, b, restart=50, tol=TOL,
                                              M=m_ref, compute_v_err=False,
                                              certify="true"))
    rel = true_rel(b_np, res.x.reshape(n, n))
    hyb_inner = (res.restarts - 1) * 50 + res.iterations
    print(f"phase 9: reference GMRES on HYB {n}x{n}: status {res.status}, "
          f"{hyb_inner} inner iterations (stencil, phase 5: {ref_inner}), "
          f"true rel residual {rel:.3e}, {t_hyb:.4f} s", flush=True)
    require(res.status == 0 and rel <= TOL, "GMRES on HYB failed")
    require(abs(hyb_inner - ref_inner) <= 0.05 * ref_inner,
            "GMRES on HYB: inner iterations differ from the stencil's by > 5%")
    n = SMALL_GRID
    cg_small, k4_launches = {}, 0
    for label, mat in (("HYB", hyb[n]), ("BSR", bsr_small)):
        b_np, solve = cg_solve(gt_torch, mat, n, dev)
        sparse.dia_spmv_cuda.launches = sparse.bsr_spmv_cuda.launches = 0
        res, t_solve = timed(solve)
        k3, k4 = sparse.dia_spmv_cuda.launches, sparse.bsr_spmv_cuda.launches
        err = abs_residual(b_np, res.x, n)
        cg_small[label] = res
        print(f"phase 9: cbpr2 CG on {label} {n}x{n} f64: status {res.status}, "
              f"{res.iterations} iterations, numpy ‖b − A x‖ {err:.3e}, "
              f"{t_solve:.4f} s, launches K3 {k3} K4 {k4}", flush=True)
        require(res.status == 0 and err < CG_TOL, f"CG on {label} {n}: failed")
        if label == "BSR":
            k4_launches = k4
            require(k4 > 0 and k3 == 0, f"CG on BSR {n}: K4 not launched")
    require(abs(cg_small["BSR"].iterations - cg_small["HYB"].iterations) <= 2,
            f"CG on BSR and on HYB at {n}²: iterations differ by more than 2")

    # Phase 10: the port's GPU and CPU CG agree.
    b_np, solve = cg_solve(gt_torch, gt_torch.csr_to_hyb(
        gt_torch.poisson_csr(n, device="cpu")), n, torch.device("cpu"))
    res = solve()
    gpu = cg_small["HYB"]
    print(f"phase 10: {n}x{n} HYB CG, (iterations, status): GPU "
          f"({gpu.iterations}, {gpu.status}), CPU ({res.iterations}, "
          f"{res.status})", flush=True)
    require(res.status == gpu.status == 0, "phase 10: status")
    require(abs(res.iterations - gpu.iterations) <= 2,
            "phase 10: iteration counts differ by more than 2")
    return k4_launches


# ---------------------------------------------------------------------------
# Phase 11: K5 and K7.
# ---------------------------------------------------------------------------


def fused_work(numel, dt, vectors, flops_per_point):
    """Bytes: `vectors` passes over numel elements of dt (each input read once,
    each output written once); flops per point in dt."""
    import torch

    item = torch.empty((), dtype=dt).element_size()
    return vectors * numel * item, flops_per_point * numel, dt, None


def check_pair(name, outs_k, outs_p, rtols):
    """Per-output relative errors of a kernel returning several tensors."""
    errs = []
    for i, (a, b, rtol) in enumerate(zip(outs_k, outs_p, rtols)):
        abs_err = float((a.double() - b.double()).abs().max())
        scale = float(b.double().abs().max())
        rel = abs_err / scale if scale > 0 else abs_err
        require(rel <= rtol, f"{name}: output {i} disagrees with the plain "
                f"version (rel err {rel:.3e} > {rtol:.0e})")
        errs.append((abs_err, rel))
    return errs


def affine_conv(r, top, bot, coefs7):
    """The yardstick of K5 and K8, one F.conv2d: a·r + b·A(r) is a 5-point
    stencil with weights (a + b·c0) at the centre and b·c_k at the
    neighbours. With halo rows the block is extended by them and padded only
    at the sides; without (None), padded all round."""
    import torch
    import torch.nn.functional as F

    c0, cw, ce, cs, cn, a, b = coefs7
    w = torch.tensor([[0.0, b * cs, 0.0],
                      [b * cw, a + b * c0, b * ce],
                      [0.0, b * cn, 0.0]], dtype=r.dtype, device=r.device)
    w = w.reshape(1, 1, 3, 3)
    if top is None:
        return lambda: F.conv2d(r[None, None], w, padding=1)[0, 0]
    ext = torch.cat([top.reshape(1, -1), r, bot.reshape(1, -1)])
    return lambda: F.conv2d(ext[None, None], w, padding=(0, 1))[0, 0]


def cheb2_conv(r, top, bot, d, alpha, coefs):
    """K5's yardstick: by linearity z = r/d + α(r − A(r)/d) is the affine
    stencil (1/d + α)·r − (α/d)·A(r)."""
    return affine_conv(r, top, bot, (*coefs, 1.0 / d + alpha, -alpha / d))


def phase_fused_kernels(gt_torch, rng, dev, floor):
    """K5 and K7 against their plain versions; returns the records and the
    K7 launches of the per-shard calls."""
    import torch

    from gmres_tpu_torch.ops import fused

    records = {"K5": [], "K7a": [], "K7b": []}
    print("phase 11: K5 and K7 against their plain versions", flush=True)
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    for n, dt, halos in ((STRONG_N, torch.float64, "zero"),
                         (STRONG_N, torch.float64, "random"),
                         (2048, torch.float32, "random")):
        tag = "f32" if dt == torch.float32 else "f64"
        r = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
        top = bot = None
        if halos == "random":
            top = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
            bot = torch.as_tensor(rng.standard_normal(n)).to(dev, dt)
        item = r.element_size()
        records["K5"].append(compare(
            f"K5 {n}x{n} {tag} {halos} halo rows",
            lambda: fused.cheb2_cuda(r, top, bot, d, alpha, coefs),
            lambda: fused.chebyshev_poisson_fused_plain(r, top, bot, d, alpha, coefs),
            0.0, 200 if n <= 304 else 50,
            work=((2 * n * n + (2 * n if top is not None else 0)) * item,
                  14 * n * n, dt, None),
            library=cheb2_conv(r, top, bot, d, alpha, coefs)))
    for n, dt in ((2048, torch.float32), (STRONG_N, torch.float64)):
        tag = "f32" if dt == torch.float32 else "f64"
        x, r, p, ap = (torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
                       for _ in range(4))
        a = torch.tensor(0.37, dtype=dt, device=dev)
        reps = 200 if n <= 304 else 50
        for name, kernel, kernel_by_value, plain, work, calls, pair in (
            ("K7a", lambda: fused.cg_fused_update_cuda(x, r, p, ap, a),
             lambda: fused.cg_fused_update_cuda(x, r, p, ap, 0.37),
             lambda: fused.cg_fused_update_plain(x, r, p, ap, a),
             fused_work(n * n, dt, 6, 6), "add, sub, dot",
             lambda: torch.dot(torch.sub(r, ap, alpha=0.37).view(-1),
                               torch.add(x, p, alpha=0.37).view(-1))),
            ("K7b", lambda: fused.axpy_dot_cuda(a, x, r, p),
             lambda: fused.axpy_dot_cuda(0.37, x, r, p),
             lambda: fused.axpy_dot_plain(a, x, r, p),
             fused_work(n * n, dt, 4, 4), "add, dot",
             lambda: torch.dot(torch.add(r, x, alpha=0.37).view(-1), p.view(-1))),
        ):
            case = f"{name} {n}x{n} {tag}"
            outs_k, outs_p = kernel(), plain()
            torch.cuda.synchronize()
            # Elementwise outputs bitwise (-fmad=false); the float32 sum in
            # another order than torch.sum's over n² terms: 1e-5 relative.
            errs = check_pair(case, outs_k, outs_p,
                              (0.0,) * (len(outs_k) - 1) + (1e-5,))
            again = kernel()[-1]
            torch.cuda.synchronize()
            require(float(again) == float(outs_k[-1]),
                    f"{case}: the sum changed between two calls")
            # α as a Python number goes by value, bitwise as by pointer.
            by_value = kernel_by_value()
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(by_value, outs_k)),
                    f"{case}: α by value and by pointer give different bits")
            # One kernel a call, by torch.profiler (the slope between 20 and
            # 40 calls; a profile can lose events).
            counts = [device_events(lambda k=k: [kernel_by_value() for _ in range(k)])
                      for k in (20, 40)]
            per_call = (counts[1] - counts[0]) / 20
            require(abs(per_call - 1.0) <= 0.5,
                    f"{case}: {per_call} kernels a call by the profiler, not 1")
            rec = {"case": case, "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs),
                   "sum_rel_err": errs[-1][1],
                   "ms": device_ms(kernel, reps), "plain_ms": device_ms(plain, reps),
                   "library_ms": None, "torch_pair_ms": device_ms(pair, reps),
                   "floor_ms": floor["slope_ms"], "kernels_per_call": per_call,
                   "profiled_events": counts, "host_us": host_us(kernel_by_value),
                   "tensor_alpha_host_us": host_us(kernel),
                   "l2_resident": work[0] <= L2_BYTES}
            rec["bound_ms"], rec["bound_by"] = bound(*work[:3])
            records[name].append(rec)
            print(f"  {case:42s} elementwise bitwise, sum rel_err "
                  f"{errs[-1][1]:.3e} (tol 1e-05), deterministic, {per_call:.2f} "
                  f"kernels a call (profiled {counts})  device: kernel "
                  f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                  f"{100 * rec['bound_ms'] / rec['ms']:.0f}% of it"
                  f"{'; L2-resident' if rec['l2_resident'] else ''}); floor "
                  f"{rec['floor_ms']:.5f} ms = {rec['ms'] / rec['floor_ms']:.2f}x  host: "
                  f"{rec['host_us']:.2f} us (α by value), "
                  f"{rec['tensor_alpha_host_us']:.2f} us (α a tensor)", flush=True)
            print(f"  {case:42s} yardstick, not one call: the eager torch "
                  f"calls ({calls}) {rec['torch_pair_ms']:.4f} ms", flush=True)
    # The per-shard use of K7 (no solver calls it): a CG step's x/r update
    # and an axpy-dot on the strong-scaling shard, through the public names.
    x, r, p, ap = (torch.as_tensor(rng.standard_normal((STRONG_N, STRONG_N)))
                   .to(dev, torch.float64) for _ in range(4))
    fused.cg_fused_update_cuda.launches = fused.axpy_dot_cuda.launches = 0
    x, r, rsq = gt_torch.cg_fused_update(x, r, p, ap, 0.5)
    p, pz = gt_torch.axpy_dot(float(rsq), p, r, ap)
    torch.cuda.synchronize()
    k7 = (fused.cg_fused_update_cuda.launches, fused.axpy_dot_cuda.launches)
    require(k7 == (1, 1) and bool(torch.isfinite(pz)),
            f"phase 11: per-shard K7 calls launched {k7}")
    return records, k7


# ---------------------------------------------------------------------------
# Phase 12: the strong-scaling path on a one-rank mesh.
# ---------------------------------------------------------------------------


def cbpr2_scalars():
    """cbpr2's (d, α) on REF_EIG, the reference's closed form."""
    lo, hi = REF_EIG
    c, d = (hi - lo) / 2.0, (hi + lo) / 2.0
    return d, 1.0 / (d - (c / d / 2.0) ** 2)


def np_cbpr2(r):
    """Independent float64 cbpr2 (z = r/d; z += α(r − A z)) in numpy."""
    d, alpha = cbpr2_scalars()
    z = r / d
    return z + alpha * (r - np_stencil(z))


def cbpr2_min_eigenvalue(n):
    """The least eigenvalue of cbpr2's M = p(A) over A's spectrum: p is
    linear and decreasing, so it is p(λ_max). ‖b − A x‖ ≤ ‖M(b − A x)‖ / it."""
    import math

    d, alpha = cbpr2_scalars()
    lam_max = 8.0 * math.sin(n * math.pi / (2 * (n + 1))) ** 2
    return 1.0 / d + alpha * (1.0 - lam_max / d)


def counted(fn, calls, key):
    def wrapped(v):
        calls[key] += 1
        return fn(v)

    return wrapped


@contextlib.contextmanager
def one_rank_group(workdir, name="rendezvous"):
    """A one-rank NCCL process group on a file rendezvous `workdir/name`,
    destroyed on exit."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{workdir}/{name}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def phases_on_one_rank(gt_torch, rng, dev, workdir, floor):
    """Phases 12–14 on a one-rank NCCL group made here (a file rendezvous in
    `workdir`); returns phase 12's launches of K1 and K5, and phase 13's and
    14's records and launches."""
    with one_rank_group(workdir):
        strong = strong_scaling_solves(gt_torch, dev)
        roofline = phase_roofline(gt_torch, rng, dev, workdir)
        rdma = phase_rdma(gt_torch, rng, dev, floor)
        return strong, roofline, rdma


def halo_applications(gt_torch, mesh, x) -> dict:
    """Phase 12's applications on one rank: the halo operator (K1) and cbpr2
    (K5) as the package builds them, with no halo row where there is no
    neighbour, and as they ran before, on halo_exchange's two zero rows
    (built here). Per application: K1's and K5's launches (the wrappers'
    counts), kernels in all (torch.profiler, the slope between
    HALO_APPLICATIONS and twice as many), host µs to enqueue one, eager
    device ms (CUDA events around 200); and the same bits."""
    import torch
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    from gmres_tpu_torch.ops import fused, stencil
    from gmres_tpu_torch.ops.stencil import stencil_5pt_pallas_halo

    group = mesh.get_group("grid")
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)

    def sharded(fn):
        return local_map(fn, out_placements=[Shard(0)], in_placements=([Shard(0)],),
                         device_mesh=mesh)

    forms = {
        "A": gt_torch.halo_poisson_operator(mesh),
        "M": gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG),
        "A on zero rows": sharded(lambda blk: stencil_5pt_pallas_halo(
            blk, *gt_torch.halo_exchange(blk, group))),
        "M on zero rows": sharded(lambda blk: gt_torch.chebyshev_poisson_fused(
            blk, *gt_torch.halo_exchange(blk, group), d, alpha)),
    }
    out = {}
    for name, f in forms.items():
        y = f(x).to_local()
        before = (stencil.stencil5_cuda.launches, fused.cheb2_cuda.launches)
        for _ in range(HALO_APPLICATIONS):
            f(x)
        launched = {"K1": (stencil.stencil5_cuda.launches - before[0]) / HALO_APPLICATIONS,
                    "K5": (fused.cheb2_cuda.launches - before[1]) / HALO_APPLICATIONS}
        # The slope between profiles of N and 2N applications: a profile
        # drops a fixed few of its first device events (3 of 20 on the H100).
        counts = [device_events(lambda f=f, k=k: [f(x) for _ in range(k)])
                  for k in (HALO_APPLICATIONS, 2 * HALO_APPLICATIONS)]
        out[name] = {"kernels": (counts[1] - counts[0]) / HALO_APPLICATIONS,
                     "profiled_events": counts, "launches": launched,
                     "host_us": host_us(lambda f=f: f(x)),
                     "call_ms": call_ms(lambda f=f: f(x), 200), "y": y}
        print(f"phase 12: one-rank halo application {name:15s}: launches {launched}, "
              f"{out[name]['kernels']:.2f} kernels in all (profiled {counts[0]} over "
              f"{HALO_APPLICATIONS}, {counts[1]} over {2 * HALO_APPLICATIONS}), host "
              f"{out[name]['host_us']:.2f} us to enqueue, {out[name]['call_ms']:.4f} ms an "
              "eager application", flush=True)
    torch.cuda.synchronize()
    for op, kernel in (("A", "K1"), ("M", "K5")):
        require(torch.equal(out[op]["y"], out[f"{op} on zero rows"]["y"]),
                f"phase 12: {op} without halo rows differs from {op} on zero rows")
        other = "K5" if kernel == "K1" else "K1"
        require(out[op]["launches"] == {kernel: 1.0, other: 0.0},
                f"phase 12: {op} launches {out[op]['launches']} an application, not "
                f"{kernel} once")
        # One kernel in all, within half a kernel of the profiler's count (the
        # zero-row forms run three).
        require(abs(out[op]["kernels"] - 1.0) <= 0.5,
                f"phase 12: {op} runs {out[op]['kernels']} kernels an application, not 1")
        del out[op]["y"], out[f"{op} on zero rows"]["y"]
    return out


def strong_scaling_solves(gt_torch, dev):
    """The solves of phase 12 on a one-rank process group."""
    import numpy as np

    from gmres_tpu_torch.ops import fused, stencil

    n, m = STRONG_N, STRONG_M
    mesh = gt_torch.solver_mesh(1)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.shard_grid_vector(gt_torch.as_tensor(b_np, dev), mesh)
    calls = {"A": 0, "M": 0}
    op = counted(gt_torch.halo_poisson_operator(mesh), calls, "A")
    m_inv = counted(gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG),
                    calls, "M")
    p_min = cbpr2_min_eigenvalue(n)
    launches = {"K1": 0, "K5": 0, "applications": halo_applications(gt_torch, mesh, b)}

    def check(res, tol, tag):
        require(gt_torch.ops.blas.is_dtensor(res.x), f"{tag}: x is not sharded")
        x = res.x.full_tensor().cpu().numpy()
        require(x.shape == (n, n) and bool(np.isfinite(x).all()),
                f"{tag}: x is not a finite {n}x{n} grid")
        r = b_np - np_stencil(x)
        prec = float(np.linalg.norm(np_cbpr2(r)) / np.linalg.norm(b_np))
        true = float(np.linalg.norm(r) / np.linalg.norm(b_np))
        factor = STRONG_ROUNDING[tol]
        require(res.status == 0, f"{tag}: status {res.status}")
        require(prec < factor * tol, f"{tag}: numpy ‖M(b − A x)‖/‖b‖ {prec:.3e} "
                f">= {factor} × tol")
        require(true <= factor * tol / p_min, f"{tag}: numpy ‖b − A x‖/‖b‖ "
                f"{true:.3e} > {factor} × tol / λ_min(M) = {factor * tol / p_min:.3e}")
        return prec, true

    for tol, (j_restarts, j_iters) in JAX_STRONG_COUNTS.items():
        def solve(tol=tol):
            return gt_torch.gmres(op, b, restart=m, tol=tol, M=m_inv,
                                  variant="mgsr", orthogonalization="cgs2",
                                  max_restarts=1000, compute_v_err=False)

        # A warm-up before the first tolerance only: the later solves reuse
        # the operator and M it warmed.
        t_warm = timed(solve)[1] if tol == next(iter(JAX_STRONG_COUNTS)) else None
        stencil.stencil5_cuda.launches = fused.cheb2_cuda.launches = 0
        calls["A"] = calls["M"] = 0
        times = []
        for _ in range(STRONG_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k1, k5 = stencil.stencil5_cuda.launches, fused.cheb2_cuda.launches
        launches["K1"] += k1
        launches["K5"] += k5
        total = (res.restarts - 1) * m + res.iterations
        j_total = (j_restarts - 1) * m + j_iters
        prec, true = check(res, tol, f"strong-scaling tol {tol:g}")
        print(f"phase 12: strong-scaling {n}x{n} halo, 1 rank, mgsr cgs2 m={m} "
              f"f64 tol {tol:g}: status {res.status}, {res.restarts} restarts, "
              f"{res.iterations} in the last cycle, {total} inner iterations "
              f"(gmres_tpu: {j_restarts}, {j_iters}, {j_total}), {res.host_syncs} "
              f"host syncs, residual {float(res.residual):.4e}, numpy "
              f"‖M(b − A x)‖/‖b‖ {prec:.4e}, ‖b − A x‖/‖b‖ {true:.4e}; wall s over "
              f"{STRONG_REPEATS} solves: {quartiles(times)} (warm-up "
              f"{'none' if t_warm is None else f'{t_warm:.4f}'}); "
              f"{1e3 * float(np.median(times)) / total:.4f} ms per inner "
              f"iteration; launches over the {STRONG_REPEATS} solves: K1 {k1} "
              f"(operator applications {calls['A']}), K5 {k5} (preconditioner "
              f"applications {calls['M']})", flush=True)
        require(abs(total - j_total) <= 2,
                f"strong-scaling tol {tol:g}: {total} inner iterations, "
                f"gmres_tpu {j_total}")
        require(k1 == calls["A"] > 0 and k5 == calls["M"] > 0,
                f"strong-scaling tol {tol:g}: launches K1 {k1} K5 {k5} against "
                f"applications A {calls['A']} M {calls['M']}")
        if tol == TOL:
            profile_solve(solve, f"strong-scaling {n}x{n} tol {tol:g}",
                          float(np.median(times)))

    j_total = (JAX_STRONG_COUNTS[TOL][0] - 1) * m + JAX_STRONG_COUNTS[TOL][1]
    # The cost of the DTensor layer: the same solve (tol 1e-8) on plain
    # tensors, with the single-device operator and cbpr2 (K1 only).
    b_plain = gt_torch.as_tensor(b_np, dev)
    op_plain = gt_torch.poisson_operator(n)
    m_plain = gt_torch.chebyshev_preconditioner(op_plain, *REF_EIG)
    for _ in range(2):  # a warm-up, then the timed solve
        res, t_plain = timed(lambda: gt_torch.gmres(
            op_plain, b_plain, restart=m, tol=TOL, M=m_plain, variant="mgsr",
            max_restarts=1000, compute_v_err=False))
    total = (res.restarts - 1) * m + res.iterations
    print(f"phase 12: the same mgsr cgs2 solve at tol {TOL:g} on plain tensors "
          f"(poisson_operator, cbpr2 on it): status {res.status}, {total} inner "
          f"iterations, {t_plain:.4f} s = {1e3 * t_plain / total:.4f} ms per "
          f"inner iteration", flush=True)
    require(res.status == 0 and abs(total - j_total) <= 2,
            "strong-scaling on plain tensors failed")

    # The dryrun_multichip pair: MGSR with mgs2, and CG, on the same operators.
    stencil.stencil5_cuda.launches = fused.cheb2_cuda.launches = 0
    res, t_solve = timed(lambda: gt_torch.gmres(
        op, b, restart=m, tol=TOL, M=m_inv, variant="mgsr",
        orthogonalization="mgs2", max_restarts=1000, compute_v_err=False))
    total = (res.restarts - 1) * m + res.iterations
    prec, true = check(res, TOL, "strong-scaling mgs2")
    print(f"phase 12: mgsr mgs2 tol {TOL:g}: status {res.status}, {total} inner "
          f"iterations, numpy ‖M(b − A x)‖/‖b‖ {prec:.4e}, {t_solve:.4f} s, "
          f"launches K1 {stencil.stencil5_cuda.launches} K5 "
          f"{fused.cheb2_cuda.launches}", flush=True)
    require(abs(total - j_total) <= 2,
            f"strong-scaling mgs2: {total} inner iterations, cgs2's JAX count {j_total}")
    launches["K1"] += stencil.stencil5_cuda.launches
    launches["K5"] += fused.cheb2_cuda.launches
    stencil.stencil5_cuda.launches = fused.cheb2_cuda.launches = 0
    res, t_solve = timed(lambda: gt_torch.cg(op, b, tol=CG_TOL, M=m_inv))
    err = abs_residual(b_np, res.x.full_tensor(), n)
    print(f"phase 12: cbpr2 CG on the halo operator, tol {CG_TOL:g} absolute: "
          f"status {res.status}, {res.iterations} iterations, numpy ‖b − A x‖ "
          f"{err:.3e}, {t_solve:.4f} s, launches K1 {stencil.stencil5_cuda.launches} "
          f"K5 {fused.cheb2_cuda.launches}", flush=True)
    require(res.status == 0 and err < CG_TOL and fused.cheb2_cuda.launches > 0,
            "strong-scaling CG failed")
    launches["K1"] += stencil.stencil5_cuda.launches
    launches["K5"] += fused.cheb2_cuda.launches
    return launches


# ---------------------------------------------------------------------------
# Phase 13: K6 and the roofline program.
# ---------------------------------------------------------------------------


def phase_roofline(gt_torch, rng, dev, workdir):
    """K6 against its plain version, then the port's roofline program at its
    defaults; returns K6's records and the launches of K1, K2 and K6 during
    the program."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.ops import dd, fused, stencil

    records = {"K6": []}
    print("phase 13: K6 against its plain version", flush=True)
    cross = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]],
                         dtype=torch.float64, device=dev).reshape(1, 1, 3, 3)
    for n in ROOFLINE_GRIDS[1:]:
        x = torch.as_tensor(rng.standard_normal((n, n))).to(dev)
        hi, lo = dd.dd_from_f64(x)
        for label, coefs in (("poisson", stencil.POISSON_COEFS), ("general", GENERAL_COEFS)):
            case = f"K6 {n}x{n} {label}"

            def kernel(coefs=coefs):
                return stencil.stencil5_dd_cuda(hi, lo, coefs)

            def plain(coefs=coefs):
                return stencil.stencil_5pt_dd_plain(hi, lo, coefs)

            outs_k, outs_p = kernel(), plain()
            torch.cuda.synchronize()
            # -fmad=false and the plain version's order: both components bitwise.
            errs = check_pair(case, outs_k, outs_p, (0.0, 0.0))
            oracle = stencil.stencil_5pt_general(x, *coefs)
            err64 = float((dd.dd_to_f64(outs_k) - oracle).abs().max() / oracle.abs().max())
            require(err64 < 1e-13, f"{case}: {err64:.3e} from the float64 oracle")
            rec = {"case": case, "max_abs_err": max(e[0] for e in errs),
                   "max_rel_err": max(e[1] for e in errs), "oracle_rel_err": err64,
                   "ms": device_ms(kernel, 50), "plain_ms": device_ms(plain, 50),
                   "library_ms": None}
            # Pairs in and out: 16 B a point; 9 float64 flops a point.
            rec["bound_ms"], rec["bound_by"] = bound(16 * n * n, 9 * n * n, torch.float64)
            if label == "poisson":
                # No PyTorch call computes the stencil on pairs; the nearest is
                # K1's yardstick, the float64 cross as one F.conv2d (cuDNN).
                rec["nearest_library_ms"] = call_ms(
                    lambda: F.conv2d(x[None, None], cross, padding=1)[0, 0], 50)
            records["K6"].append(rec)
            near = rec.get("nearest_library_ms")
            print(f"  {case:42s} bitwise (both components), {err64:.2e} from the "
                  f"float64 oracle  device: kernel {rec['ms']:.4f} ms plain "
                  f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}, {100 * rec['bound_ms'] / rec['ms']:.0f}% of it)"
                  + ("" if near is None else
                     f"  nearest library call (float64 F.conv2d) {near:.4f} ms"),
                  flush=True)

    print(f"phase 13: python -m gmres_tpu_torch.benchmarks roofline (grids "
          f"{','.join(map(str, ROOFLINE_GRIDS))}, reps 20, order 8)", flush=True)
    jsonl = os.path.join(workdir, "roofline.jsonl")
    counters = (stencil.stencil5_cuda, fused.chebk_cuda, stencil.stencil5_dd_cuda,
                stencil.residual_restrict_cuda, stencil.correct_residual_cuda)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    cli.main(["roofline", "--jsonl", jsonl])
    seconds = time.perf_counter() - t0
    k1, k2, k6, k1rr, k1cr = (c.launches for c in counters)
    with open(jsonl) as f:
        rows = [json.loads(line) for line in f]
    print(f"phase 13: roofline program {seconds:.1f} s, {len(rows)} rows; launches "
          f"(captured in the chains' CUDA graphs, each replayed): K1 {k1} (its "
          f"V-cycle forms {k1rr} and {k1cr}), K2 {k2}, K6 {k6}", flush=True)
    names = {r["name"] for r in rows}
    for n in ROOFLINE_GRIDS:
        for row in (f"stencil-plain-f32-{n}", f"stencil-plain-f64-{n}",
                    f"stencil-pallas-blocked-f32-{n}", f"stencil-pallas-dd-f64-{n}",
                    f"chebk8-blocked-f32-{n}", f"mg-vcycle-f32-{n}"):
            require(row in names, f"roofline: row {row} missing")
    require(k1 > 0 and k2 > 0 and k6 > 0 and k1rr > 0 and k1cr > 0,
            f"roofline: K1 {k1} ({k1rr}, {k1cr}), K2 {k2}, K6 {k6} launches")
    kind = torch.cuda.get_device_name(0)
    for r in rows:
        require(r["device"] == kind and r["timing"].startswith("CUDA graph"),
                f"roofline {r['name']}: not timed on the card by CUDA graph")
        frac = r["fraction_of_peak"]
        require(frac is not None and np.isfinite(frac) and frac > 0,
                f"roofline {r['name']}: fraction of peak {frac}")
        require(frac <= 1.05 or "note" in r or r.get("l2_resident"),
                f"roofline {r['name']}: {frac:.3f} of peak without a traffic model")
        if r["name"].startswith("chebk"):
            single = r.get("fraction_of_single_pass")
            require(single is not None and np.isfinite(single) and 0 < single,
                    f"roofline {r['name']}: fraction_of_single_pass {single}")
    return records, {"K1": k1, "K2": k2, "K6": k6, "K1rr": k1rr, "K1cr": k1cr}


# ---------------------------------------------------------------------------
# Phase 14: K8 and the RDMA route on a one-rank mesh.
# ---------------------------------------------------------------------------


def k8_four_launches(rd, x, c):
    """An application as the RDMA route ran it before it dropped absent
    rows: two zero rows allocated and filled, the interior, the edges on
    them (four launches)."""
    import torch

    def run():
        top = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        bot = torch.zeros_like(top)
        return rd.rdma_edges_cuda(rd.rdma_interior_cuda(x, c), top, bot, c)

    return run


def phase_rdma(gt_torch, rng, dev, floor):
    """K8 against its plain version, then f32 MGSR GMRES with A and M on the
    RDMA route and CG on the RDMA operator at the strong-scaling grid;
    returns K8's records and launches."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused, stencil_rdma as rd
    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    records = {"K8": []}
    print("phase 14: K8 against its plain version", flush=True)
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)
    coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
    forms = {"operator": (0.0, 1.0), "cbpr2": (1.0 / d + alpha, -alpha / d)}
    # Halo rows: none (one rank, the path's case), zeros (as the route ran it
    # before), random on both sides, or on the bottom only (an end rank).
    for n, form, halos in ((STRONG_N, "operator", "no"), (STRONG_N, "cbpr2", "no"),
                           (STRONG_N, "operator", "zero"), (STRONG_N, "cbpr2", "random"),
                           (STRONG_N, "cbpr2", "bottom-only"), (2048, "operator", "no"),
                           (2048, "cbpr2", "random")):
        dt = torch.float32
        c7 = (*coefs, *forms[form])
        c = rd._coefs7(c7, dt)
        sets = []
        for _ in range(HBM_SETS if n >= 2048 else 1):
            x = torch.as_tensor(rng.standard_normal((n, n))).to(dev, dt)
            rand = [torch.as_tensor(rng.standard_normal((1, n))).to(dev, dt)
                    for _ in range(2)]
            zero = torch.zeros((1, n), dtype=dt, device=dev)
            top, bot = {"no": (None, None), "zero": (zero, torch.zeros_like(zero)),
                        "random": tuple(rand), "bottom-only": (None, rand[1])}[halos]
            sets.append((x, top, bot))
        rows = (top is not None) + (bot is not None)
        records["K8"].append(form_record(
            f"K8 {n}x{n} f32 {form}, {halos} halo rows",
            cycling([lambda x=x, t=t, b=b: rd.rdma_edges_cuda(rd.rdma_interior_cuda(x, c),
                                                               t, b, c)
                     for x, t, b in sets]),
            # The plain composition on zero rows where a row is absent: the
            # TPU kernel's form (they differ at most in the sign of a zero).
            cycling([lambda x=x, t=t, b=b: rd.rdma_edges_plain(
                rd.rdma_interior_plain(x, c), zero if t is None else t,
                zero if b is None else b, c) for x, t, b in sets]),
            # x and the given halo rows read, y written; 12 flops a point, and
            # 3 more at each point of a corrected row.
            ((2 * n * n + rows * n) * 4, 12 * n * n + 3 * rows * n, dt),
            200 if n <= STRONG_N else 50, floor,
            library=cycling([affine_conv(x, None if t is None and b is None else
                                         (zero if t is None else t), b, c7)
                             for x, t, b in sets]),
            sets=len(sets)))
        if n == STRONG_N and halos == "no":
            x = sets[0][0]
            rec = records["K8"][-1]
            rec["four_launch_ms"] = device_ms(k8_four_launches(rd, x, c), 200)
            print(f"  {rec['case']:46s} as the route ran it before (zero rows "
                  f"filled, interior, edges: four launches) {rec['four_launch_ms']:.4f} ms",
                  flush=True)

    n = STRONG_N
    mesh = gt_torch.solver_mesh(1)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.shard_grid_vector(gt_torch.as_tensor(b_np, dev, torch.float32), mesh)
    calls = {"A": 0, "M": 0}
    op = counted(rdma_stencil_operator(mesh), calls, "A")
    m_inv = counted(rdma_chebyshev_preconditioner(mesh, *REF_EIG), calls, "M")
    p_min = cbpr2_min_eigenvalue(n)
    nb = float(np.linalg.norm(b_np))
    launches = {"interior": 0, "edges": 0}

    solves = (
        ("gmres", lambda: gt_torch.gmres(op, b, restart=STRONG_M, tol=RDMA_GMRES_TOL,
                                         M=m_inv, variant="mgsr", max_restarts=1000,
                                         compute_v_err=False)),
        ("cg", lambda: gt_torch.cg(op, b, tol=RDMA_CG_TOL, rtol=RDMA_CG_TOL)),
    )
    applications = rdma_applications(gt_torch, mesh, b, rd, forms, coefs)
    for name, solve in solves:
        res, t_warm = timed(solve)  # warm-up
        rd.rdma_interior_cuda.launches = rd.rdma_edges_cuda.launches = 0
        calls["A"] = calls["M"] = 0
        times = []
        for _ in range(STRONG_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        interior, edges = rd.rdma_interior_cuda.launches, rd.rdma_edges_cuda.launches
        launches["interior"] += interior
        launches["edges"] += edges
        require(gt_torch.ops.blas.is_dtensor(res.x), f"rdma {name}: x is not sharded")
        x = res.x.full_tensor().cpu().numpy()
        require(x.dtype == np.float32 and x.shape == (n, n) and bool(np.isfinite(x).all()),
                f"rdma {name}: x is not a finite float32 {n}x{n} grid")
        r = b_np - np_stencil(x.astype(np.float64))
        true = float(np.linalg.norm(r))
        if name == "gmres":
            total = (res.restarts - 1) * STRONG_M + res.iterations
            prec = float(np.linalg.norm(np_cbpr2(r)) / nb)
            counts = (f"{res.restarts} restarts, {res.iterations} in the last cycle, "
                      f"{total} inner iterations")
            check = (f"numpy ‖M(b − A x)‖/‖b‖ {prec:.4e}, ‖b − A x‖/‖b‖ "
                     f"{true / nb:.4e}")
            # The certified norm is float32 arithmetic; numpy recomputes it in
            # float64 from the float32 x (CPU rehearsal: 9.9315e-6 against a
            # certified 9.9279e-6), hence the 10%.
            ok = (prec < 1.1 * RDMA_GMRES_TOL
                  and true / nb <= 1.1 * RDMA_GMRES_TOL / p_min)
            applied = calls["A"] + calls["M"]
        else:
            counts = f"{res.iterations} iterations"
            check = f"numpy ‖b − A x‖ {true:.4e} (target {RDMA_CG_TOL * nb:.4e})"
            ok = true < 1.1 * RDMA_CG_TOL * nb
            applied = calls["A"]
            require(calls["M"] == 0, "rdma cg: a preconditioner was applied")
        print(f"phase 14: {name} {n}x{n} on the RDMA route, 1 rank, f32: status "
              f"{res.status}, {counts}, {res.host_syncs} host syncs, residual "
              f"{float(res.residual):.4e}, {check}; wall s over {STRONG_REPEATS} solves: "
              f"{quartiles(times)} (warm-up {t_warm:.4f}); K8 launches over the "
              f"{STRONG_REPEATS} solves: interior {interior}, edges {edges} "
              f"(applications: A {calls['A']}, M {calls['M']})", flush=True)
        require(res.status == 0, f"rdma {name}: status {res.status}")
        require(ok, f"rdma {name}: the numpy residual misses the tolerance ({check})")
        # One rank: no halo row, so one interior launch an application and
        # no edge launch.
        require(interior == applied > 0 and edges == 0,
                f"rdma {name}: K8 launches {interior}/{edges} against {applied} "
                f"applications")
        launches[f"{name} profile"] = profile_solve(
            solve, f"rdma {name} {n}x{n}", float(np.median(times)))
    launches["applications"] = applications
    return records, launches


def rdma_applications(gt_torch, mesh, x, rd, forms, coefs) -> dict:
    """Phase 14's applications on one rank: the RDMA operator and cbpr2 as
    the package builds them (no halo row, no edge launch) and as the route
    ran them before, on two zero rows filled per application (built here:
    four kernels). Per application: K8's launches (the wrappers' counts),
    kernels in all (torch.profiler, the slope between HALO_APPLICATIONS and
    twice as many), host µs to enqueue one, eager device ms; and the same
    bits."""
    import torch
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    def zero_rows(form):
        c = rd._coefs7((*coefs, *forms[form]), torch.float32)
        return local_map(lambda blk: k8_four_launches(rd, blk, c)(),
                         out_placements=[Shard(0)], in_placements=([Shard(0)],),
                         device_mesh=mesh)

    fns = {"A": rdma_stencil_operator(mesh),
           "M": rdma_chebyshev_preconditioner(mesh, *REF_EIG),
           "A on zero rows": zero_rows("operator"), "M on zero rows": zero_rows("cbpr2")}
    out = {}
    for name, f in fns.items():
        y = f(x).to_local()
        before = (rd.rdma_interior_cuda.launches, rd.rdma_edges_cuda.launches)
        for _ in range(HALO_APPLICATIONS):
            f(x)
        launched = {"interior": (rd.rdma_interior_cuda.launches - before[0]) / HALO_APPLICATIONS,
                    "edges": (rd.rdma_edges_cuda.launches - before[1]) / HALO_APPLICATIONS}
        counts = [device_events(lambda f=f, k=k: [f(x) for _ in range(k)])
                  for k in (HALO_APPLICATIONS, 2 * HALO_APPLICATIONS)]
        out[name] = {"kernels": (counts[1] - counts[0]) / HALO_APPLICATIONS,
                     "profiled_events": counts, "launches": launched,
                     "host_us": host_us(lambda f=f: f(x)),
                     "call_ms": call_ms(lambda f=f: f(x), 200), "y": y}
        print(f"phase 14: one-rank RDMA application {name:15s}: launches {launched}, "
              f"{out[name]['kernels']:.2f} kernels in all (profiled {counts[0]} over "
              f"{HALO_APPLICATIONS}, {counts[1]} over {2 * HALO_APPLICATIONS}), host "
              f"{out[name]['host_us']:.2f} us to enqueue, {out[name]['call_ms']:.4f} ms an "
              "eager application", flush=True)
    torch.cuda.synchronize()
    for op in ("A", "M"):
        require(torch.equal(out[op]["y"], out[f"{op} on zero rows"]["y"]),
                f"phase 14: {op} without halo rows differs from {op} on zero rows")
        require(out[op]["launches"] == {"interior": 1.0, "edges": 0.0},
                f"phase 14: {op} launches {out[op]['launches']} an application, not "
                "one interior and no edges")
        require(abs(out[op]["kernels"] - 1.0) <= 0.5,
                f"phase 14: {op} runs {out[op]['kernels']} kernels an application, not 1")
        del out[op]["y"], out[f"{op} on zero rows"]["y"]
    return out


# ---------------------------------------------------------------------------
# Phase 15: BiCGSTAB, the Lanczos bounds and the reference's programs.
# ---------------------------------------------------------------------------


def within_spread(iterations, jax_iterations) -> bool:
    """A BiCGSTAB count against gmres_tpu's (BICGSTAB_SPREAD); prints the
    gap and whether it is within 2."""
    gap = iterations - jax_iterations
    print(f"phase 15: bicgstab iterations {iterations} against gmres_tpu's "
          f"{jax_iterations}: {gap:+d} ({100 * gap / jax_iterations:+.1f}%), "
          f"{'within' if abs(gap) <= 2 else 'not within'} 2", flush=True)
    return abs(gap) <= max(2, BICGSTAB_SPREAD * jax_iterations)


def bicgstab_solves(gt_torch, dev):
    """cbpr2 BiCGSTAB at BICGSTAB_GRIDS: timed solves, a profiled one, and
    the checks (status, numpy residual, JAX's iterations, K1 per
    application); returns K1's launches over the timed solves."""
    import numpy as np

    from gmres_tpu_torch.ops import stencil

    k1_total = 0
    for n in BICGSTAB_GRIDS:
        b_np = np_stencil(np.ones((n, n)))
        b = gt_torch.as_tensor(b_np, dev)
        op = gt_torch.poisson_operator(n)
        applications = [0]

        def counted(v, op=op):
            applications[0] += 1
            return op(v)

        m_inv = gt_torch.chebyshev_preconditioner(counted, *REF_EIG)

        def solve(b=b, m_inv=m_inv, counted=counted):
            return gt_torch.bicgstab(counted, b, tol=CG_TOL, M=m_inv)

        res, t_warm = timed(solve)
        times = []
        applications[0] = stencil.stencil5_cuda.launches = 0
        for _ in range(BICGSTAB_REPEATS):
            res, t_solve = timed(solve)
            times.append(t_solve)
        k1, applied = stencil.stencil5_cuda.launches, applications[0]
        k1_total += k1
        err = abs_residual(b_np, res.x, n)
        jax_its = JAX_BICGSTAB_ITERATIONS[n]
        per_solve = applied / BICGSTAB_REPEATS
        print(f"phase 15: cbpr2 BiCGSTAB {n}x{n} f64: status {res.status}, "
              f"{res.iterations} iterations (gmres_tpu on the CPU: {jax_its}), "
              f"{res.host_syncs} host syncs, residual {float(res.residual):.4e}, numpy "
              f"‖b − A x‖ {err:.4e}; wall s over {BICGSTAB_REPEATS} solves: "
              f"{quartiles(times)} (warm-up {t_warm:.4f}); "
              f"{1e3 * float(np.median(times)) / res.iterations:.4f} ms per iteration; "
              f"K1 launches {k1} for {applied} operator applications "
              f"({per_solve:.1f} a solve = 4 x {res.iterations} + "
              f"{per_solve - 4 * res.iterations:.1f}: the ‖A‖ probe, the "
              "certification, the residual replacements)", flush=True)
        prof = profile_solve(solve, f"bicgstab {n}x{n}", float(np.median(times)))
        print(f"phase 15: bicgstab {n}x{n}: {prof['kernels'] / res.iterations:.2f} kernels "
              f"and {prof['copies'] / res.iterations:.2f} copies or sets per iteration "
              "on the device", flush=True)
        require(res.status == 0, f"bicgstab {n}: status {res.status}")
        require(err < CG_TOL, f"bicgstab {n}: numpy residual {err:.3e} >= {CG_TOL}")
        require(within_spread(res.iterations, jax_its),
                f"bicgstab {n}: {res.iterations} iterations, gmres_tpu {jax_its}")
        require(k1 == applied >= BICGSTAB_REPEATS * (4 * res.iterations + 2),
                f"bicgstab {n}: K1 launches {k1}, operator applications {applied}")
        require(res.host_syncs == res.iterations + 2,
                f"bicgstab {n}: {res.host_syncs} host syncs")
    return k1_total


def program_rows(cli, argv, workdir, phase="phase 15", status=0):
    """Run one program in this process; its JSONL rows, each of status
    `status` (0, converged, unless the caller expects another)."""
    jsonl = os.path.join(workdir, "programs.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    t0 = time.perf_counter()
    cli.main(argv + ["--jsonl", jsonl])
    seconds = time.perf_counter() - t0
    with open(jsonl) as f:
        rows = [json.loads(line) for line in f]
    require(rows, f"{' '.join(argv)}: no rows")
    for r in rows:
        require(r["status"] == status,
                f"{' '.join(argv)}: row {r['name']} status {r['status']}")
    print(f"{phase}: python -m gmres_tpu_torch.benchmarks {' '.join(argv)}: "
          f"{seconds:.1f} s, rows " + "; ".join(
              f"{r['name']} {r['iterations']} it"
              + (f" {r['restarts']} rst" if "restarts" in r else "")
              + f" residual {r['residual']:.3e} wall {r['wall_s']:.4f} s" for r in rows),
          flush=True)
    return rows


def phase_programs(gt_torch, dev, workdir):
    """Phase 15; returns the launches of K1, K1rr, K1cr and K2 over it."""
    import torch

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.ops import fused, stencil

    t_phase = time.perf_counter()
    # K1 (A, and the A inside cbpr2), its V-cycle forms and K2 (weak-scaling's mg).
    counters = {"K1": stencil.stencil5_cuda, "K1rr": stencil.residual_restrict_cuda,
                "K1cr": stencil.correct_residual_cuda, "K2": fused.chebk_cuda}
    for c in counters.values():
        c.launches = 0
    bicgstab_solves(gt_torch, dev)

    rows = {r["name"]: r for r in program_rows(cli, ["hilbert"], workdir)}
    mgsr, hh = rows["gmres-mgsr-hilbert"], rows["gmres-householder-hilbert"]
    print(f"phase 15: hilbert n=12 max|I - V^T V|: MGSR {mgsr['v_err']:.3e}, "
          f"Householder {hh['v_err']:.3e} (gmres_tpu on the CPU: 6.40e-16, 9.05e-31)",
          flush=True)
    require(hh["v_err"] <= mgsr["v_err"] / HILBERT_AB,
            f"hilbert: Householder {hh['v_err']:.3e} not {HILBERT_AB:g} below "
            f"MGSR {mgsr['v_err']:.3e}")

    n = LANCZOS_N
    lam_min, lam_max = gt_torch.poisson_spectral_bounds(n)
    before = counters["K1"].launches
    lo, hi = gt_torch.lanczos_bounds(gt_torch.poisson_operator(n),
                                     torch.ones((n, n), dtype=torch.float64, device=dev), 20)
    k1 = counters["K1"].launches - before
    lo_c, hi_c = gt_torch.lanczos_bounds(gt_torch.poisson_operator(n),
                                         torch.ones((n, n), dtype=torch.float64), 20)
    print(f"phase 15: lanczos_bounds(poisson_operator({n}), ones, 20) on the card "
          f"({float(lo):.6g}, {float(hi):.6g}), on the CPU ({float(lo_c):.6g}, "
          f"{float(hi_c):.6g}); exact ({lam_min:.6g}, {lam_max:.6g}); K1 launches {k1}",
          flush=True)
    require(float(lo) <= lam_max <= float(hi), "lanczos: λ_max outside the bounds")
    require(k1 == 20, f"lanczos: {k1} K1 launches for 20 steps")
    for g, c in ((lo, lo_c), (hi, hi_c)):
        require(abs(float(g) - float(c)) <= 1e-10 * max(abs(float(c)), 1e-300),
                "lanczos: the card's bounds differ from the CPU's")

    kind = torch.cuda.get_device_name(0)
    for argv in (["dense-poisson"],
                 ["poisson-mf", "--nsize", "300", "--restart", "50", "--tol", "1e-8"],
                 ["cg", "--grids", "300:1000:700"],
                 ["bicgstab", "--grids", "300:1000:700"],
                 ["restart-sweep", "--ntests", "2", "--tol", "1e-8"],
                 ["strong-scaling", "--max-devices", "1", "--tol", "1e-8"],
                 ["strong-scaling", "--max-devices", "1", "--tol", "1e-8",
                  "--explicit-halo"],
                 ["weak-scaling", "--max-devices", "1"]):
        rows = program_rows(cli, argv, workdir)
        if argv[0].endswith("-scaling"):
            require([r["devices"] for r in rows] == [1] and rows[0]["device"] == kind,
                    f"{argv[0]}: rows {rows}")
        if argv[0] == "bicgstab":
            for r in rows:
                n = int(r["name"].split("x")[-1])
                require(within_spread(r["iterations"], JAX_BICGSTAB_ITERATIONS[n]),
                        f"bicgstab program {n}: {r['iterations']} iterations")
    launches = {k: c.launches for k, c in counters.items()}
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s; launches over the phase: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    require(all(v > 0 for v in launches.values()), f"phase 15: launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: convection-diffusion (BASELINE config 3).
# ---------------------------------------------------------------------------


def np_stencil_general(x, coefs):
    """Independent float64 5-point stencil with general coefficients in
    numpy (zero boundaries), summed in K1's order."""
    c0, cw, ce, cs, cn = coefs
    y = c0 * x
    y[:, 1:] += cw * x[:, :-1]
    y[:, :-1] += ce * x[:, 1:]
    y[1:, :] += cs * x[:-1, :]
    y[:-1, :] += cn * x[1:, :]
    return y


def cross_conv(x, coefs):
    """K1's yardstick on general coefficients: the stencil as one F.conv2d
    with a 3×3 cross (a correlation: west at column 0, south at row 0)."""
    import torch
    import torch.nn.functional as F

    c0, cw, ce, cs, cn = coefs
    w = torch.tensor([[0.0, cs, 0.0], [cw, c0, ce], [0.0, cn, 0.0]],
                     dtype=x.dtype, device=x.device).reshape(1, 1, 3, 3)
    return lambda: F.conv2d(x[None, None], w, padding=1)[0, 0]


def convdiff_kernels(gt_torch, rng, dev, floor):
    """Phase 16 (a): K1, its two V-cycle forms and K2 at the convdiff cycle's
    shapes and coefficients against their plain versions, timed by CUDA-graph
    replay (1024² rows cycle through HBM_SETS input sets, more than the L2)."""
    import torch

    from gmres_tpu_torch.models.convection_diffusion import (
        convection_diffusion_coefs,
        convection_diffusion_coefs_upwind,
    )
    from gmres_tpu_torch.ops import fused, stencil

    central = convection_diffusion_coefs(0.4, 0.2)
    # The 1024² cycle's levels 64² and 16²: γ·16 and γ·64, upwind.
    upwind64 = convection_diffusion_coefs_upwind(0.4 * 16, 0.2 * 16)
    upwind16 = convection_diffusion_coefs_upwind(0.4 * 64, 0.2 * 64)
    records = {"K1 convdiff": [], "K1rr convdiff": [], "K1cr convdiff": [],
               "K2 convdiff": []}
    print("phase 16: K1, its V-cycle forms and K2 at the convdiff cycle's shapes "
          f"(central {central}, upwind at 64² {upwind64}, at 16² {upwind16})", flush=True)

    def sets(n, dt, shapes):
        return [[torch.as_tensor(rng.standard_normal(sh)).to(dev, dt) for sh in shapes]
                for _ in range(HBM_SETS if n >= 1024 else 1)]

    for n, dtname, coefs, tag in ((1024, "float64", central, "central"),
                                  (1024, "float32", central, "central"),
                                  (64, "float64", upwind64, "upwind")):
        dt = getattr(torch, dtname)
        item = torch.empty((), dtype=dt).element_size()
        dtag = "f32" if dt == torch.float32 else "f64"
        grids = sets(n, dt, ((n, n), (n, n), (n // 2, n // 2)))
        reps = 50 if n >= 1024 else 200
        if n == 1024:
            records["K1 convdiff"].append(form_record(
                f"K1 convdiff operator {n}x{n} {dtag} {tag}",
                cycling([lambda x=x: stencil.stencil5_cuda(x, None, None, coefs)
                         for x, _, _ in grids]),
                cycling([lambda x=x: stencil.stencil_5pt_general(x, *coefs)
                         for x, _, _ in grids]),
                stencil_work(n, dt), reps, floor,
                library=cycling([cross_conv(x, coefs) for x, _, _ in grids]),
                sets=len(grids)))
        records["K1rr convdiff"].append(form_record(
            f"K1 residual-restrict {n}x{n} -> {n // 2} {dtag} {tag}",
            cycling([lambda r=r, e=e: stencil.residual_restrict_cuda(r, e, coefs)
                     for r, e, _ in grids]),
            cycling([lambda r=r, e=e: stencil.residual_restrict_plain(r, e, coefs)
                     for r, e, _ in grids]),
            ((2 * n * n + n * n // 4) * item, 10.75 * n * n, dt), reps, floor,
            library=cycling([restrict_conv(r, e, coefs) for r, e, _ in grids]),
            sets=len(grids)))
        records["K1cr convdiff"].append(form_record(
            f"K1 correct-residual {n}x{n} <- {n // 2} {dtag} {tag}",
            cycling([lambda r=r, e=e, ec=ec: stencil.correct_residual_cuda(r, e, ec, coefs)
                     for r, e, ec in grids]),
            cycling([lambda r=r, e=e, ec=ec: stencil.correct_residual_plain(r, e, ec, coefs)
                     for r, e, ec in grids]),
            ((4 * n * n + n * n // 4) * item, 11 * n * n, dt), reps, floor,
            sets=len(grids)))
    # K2: the damped-Jacobi smoother (order 3, ω 0.7) of the 1024² level in
    # float32 (the mixed cycle), and the order-64 coarse solve (63 sweeps)
    # at 16² on upwind coefficients in both dtypes. The plain version's
    # r/θ rounds once differently (PyTorch multiplies by 1/θ), hence the
    # tolerance; the per-sweep path gives the routed path's bits.
    theta, steps = fused.jacobi_k_scalars(0.7, central[0], 3)
    r = torch.as_tensor(rng.standard_normal((1024, 1024))).to(dev, torch.float32)
    records["K2 convdiff"].append(k2_compare(
        "K2 Jacobi order 3 1024x1024 f32 central", r, theta, steps, central, 1e-5, 50, 2,
        must_beat_sweep=False))
    theta, steps = fused.jacobi_k_scalars(0.7, upwind16[0], 64)
    for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        dtag = "f32" if dt == torch.float32 else "f64"
        r = torch.as_tensor(rng.standard_normal((16, 16))).to(dev, dt)
        records["K2 convdiff"].append(k2_compare(
            f"K2 Jacobi order 64 16x16 {dtag} upwind (coarse solve)", r, theta, steps,
            upwind16, rtol, 200, 63, must_beat_sweep=False))
    return records


def convdiff_row(gt_torch, dev, row):
    """One phase-16 row: the convdiff program's problem (its own setup,
    convdiff_problem), solved on the card with the launch counts set to 0
    just before and read just after; checked by status, a numpy float64
    residual in the norm the solve certifies, gmres_tpu's count, and the
    kernels it launched. At
    1024² the median of CONVDIFF_REPEATS solves after a warm-up, and one
    profiled solve."""
    import numpy as np

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs
    from gmres_tpu_torch.ops import fused

    label, n, solver, precond, precision, smoother, gamma = row
    t0 = time.perf_counter()
    _, b, m_inv, solve = cli.convdiff_problem(
        n, dev, gamma_x=gamma[0], gamma_y=gamma[1], solver=solver, precond=precond,
        precision=precision, smoother=smoother, tol=CONVDIFF_TOL)
    setup_s = time.perf_counter() - t0
    repeats = CONVDIFF_REPEATS if n >= 1024 else 1
    mg_counters(reset=True)
    res, t_warm = timed(solve)
    times = []
    for _ in range(repeats):
        res, t_solve = timed(solve)
        times.append(t_solve)
    count = mg_counters()
    coefs = convection_diffusion_coefs(*gamma)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    x_np = res.x.detach().cpu().numpy().astype(np.float64)
    err = float(np.linalg.norm(b_np - np_stencil_general(x_np, coefs)))
    if solver == "gmres":
        err /= float(np.linalg.norm(b_np))  # relative: what certify="true" certifies
        its = (res.restarts - 1) * cli.CONVDIFF_RESTART + res.iterations
    else:
        its = res.iterations
    jax_its = JAX_CONVDIFF_ITERATIONS[label]
    gap = its - jax_its
    band = CONVDIFF_GMRES_BAND if solver == "gmres" else max(2, BICGSTAB_SPREAD * jax_its)
    levels = getattr(m_inv, "levels", None)
    print(f"phase 16: {label} ({gamma}; "
          + (f"{levels} levels, smoothers {m_inv.smoothers}, ω {m_inv.omegas}; "
             if levels else "")
          + f"setup {setup_s:.3f} s): status {res.status}, {its} iterations"
          + (f" ({res.restarts} restarts)" if solver == "gmres" else "")
          + f" (gmres_tpu on the CPU: {jax_its}, gap {gap:+d}, "
          f"{'within' if abs(gap) <= 2 else 'not within'} 2), {res.host_syncs} host syncs, "
          f"residual {float(res.residual):.4e}, numpy ‖b − A x‖"
          f"{'/‖b‖' if solver == 'gmres' else ''} {err:.4e}; wall s over {repeats}: "
          f"{quartiles(times)} (warm-up {t_warm:.4f}); "
          f"{1e3 * float(np.median(times)) / max(its, 1):.4f} ms an iteration; launches over "
          f"{repeats + 1} solves: {count}", flush=True)
    out = {"label": label, "iterations": its, "jax_iterations": jax_its,
           "status": res.status, "residual": float(res.residual), "numpy_residual": err,
           "times": times, "launches": count, "host_syncs": res.host_syncs}
    if n >= 1024:
        prof = profile_solve(solve, f"convdiff {label}", float(np.median(times)))
        print(f"phase 16: {label}: {prof['kernels'] / max(its, 1):.2f} kernels and "
              f"{prof['copies'] / max(its, 1):.2f} copies or sets per iteration on the "
              f"device; busy {prof['busy_ms']:.3f} ms = "
              f"{100 * prof['busy_ms'] / (1e3 * float(np.median(times))):.1f}% of the median",
              flush=True)
        out["profile"] = prof
    require(res.status == 0, f"{label}: status {res.status}")
    require(err < CONVDIFF_TOL, f"{label}: numpy residual {err:.3e} >= {CONVDIFF_TOL}")
    require(abs(gap) <= band, f"{label}: {its} iterations, gmres_tpu {jax_its}")
    require(tuple(res.x.shape) == (n, n) and res.x.device.type == "cuda",
            f"{label}: x is not an ({n}, {n}) grid on the card")
    require(count["K1"] > 0, f"{label}: K1 was not launched: {count}")
    if precond == "mg":
        require(count["K1rr"] > 0 and count["K1rr"] == count["K1cr"],
                f"{label}: K1's V-cycle forms: {count}")
        # Every level but a red-black one smooths on K2 (an all-rbgs cycle
        # runs its sweeps and coarse solve on K1 alone).
        uses_k2 = any(sm != "rbgs" for sm in m_inv.smoothers)
        require((count["K2"] > 0) == uses_k2 and count["K2"] == sum(
            count[f"K2 {p}"] for p in fused.chebk_cuda.launches_by_path),
            f"{label}: K2 launches by path: {count}")
    else:
        require(count["K1rr"] == count["K1cr"] == count["K2"] == 0,
                f"{label}: the polynomial launched more than K1: {count}")
    return out


def phase_convdiff(gt_torch, rng, dev, floor, workdir):
    """Phase 16: the kernels at the cycle's shapes, then every CONVDIFF_ROWS
    row, then the program itself at BASELINE config 3. Returns the kernel
    records, the launches over the rows and the rows."""
    from gmres_tpu_torch.benchmarks import cli

    t_phase = time.perf_counter()
    records = convdiff_kernels(gt_torch, rng, dev, floor)
    launches = dict.fromkeys(mg_counters(), 0)
    rows = []
    for row in CONVDIFF_ROWS:
        out = convdiff_row(gt_torch, dev, row)
        for k, v in out["launches"].items():
            launches[k] += v
        rows.append(out)
    program = program_rows(cli, ["convdiff", "--nsize", "1024", "--precond", "mg",
                                 "--precision", "mixed", "--smoother", "auto"], workdir,
                           phase="phase 16")
    require(program[0]["residual"] < CONVDIFF_TOL, f"convdiff program: {program}")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return records, launches, rows


# ---------------------------------------------------------------------------
# Phase 17: the GMRES family.
# ---------------------------------------------------------------------------


KERNELS = ("K1", "K1rr", "K1cr", "K2")


def per_application(fn, v) -> dict:
    """Kernel launches of one application of fn to v, by the wrappers'
    counts."""
    import torch

    before = mg_counters()
    fn(v)
    torch.cuda.synchronize()
    after = mg_counters()
    return {k: after[k] - before[k] for k in KERNELS}


def family_run(label, solve, ops, repeats=FAMILY_REPEATS, warm=None, phase="phase 17",
               needs_k1=True):
    """Run one phase-17 (or phase-18) solve: a warm-up (`warm`, a shorter
    run of the same solver where given, else the solve) and `repeats` timed
    solves with the launch counts set to 0 just before and read just after.
    `ops` maps a name to (the callable, a probe vector); each is wrapped to
    count its applications, and its launches per application are measured
    on the probe first. The launches over the solves must be the
    applications times the launches per application, kernel by kernel, and
    K1 must have been launched unless `needs_k1` is False (a path that
    gmres_tpu writes in plain jnp, where the port launches no kernel).
    Returns the last result, the times, the counts, the applications, the
    launches per application and the median time."""
    import numpy as np

    calls = dict.fromkeys(ops, 0)
    per = {name: per_application(fn, probe) for name, (fn, probe) in ops.items()}
    wrapped = {name: counted(fn, calls, name) for name, (fn, _) in ops.items()}
    mg_counters(reset=True)
    _, t_warm = timed(lambda: (warm or solve)(**wrapped))
    times = []
    for _ in range(repeats):
        res, t = timed(lambda: solve(**wrapped))
        times.append(t)
    count = mg_counters()
    expected = {k: sum(calls[name] * per[name][k] for name in ops) for k in KERNELS}
    print(f"{phase}: {label}: wall s over {repeats}: {quartiles(times)} (warm-up "
          f"{t_warm:.4f}); applications over the warm-up and {repeats} solves "
          + ", ".join(f"{name} {calls[name]}" for name in ops)
          + "; launches per application "
          + ", ".join(f"{name} {per[name]}" for name in ops)
          + f"; launches {count}", flush=True)
    require(all(count[k] == expected[k] for k in KERNELS),
            f"{label}: launches {count} are not the applications times the launches "
            f"per application {expected}")
    require(count["K1"] > 0 or not needs_k1, f"{label}: K1 was not launched")
    require(count["K2"] == sum(count[f"K2 {p}"] for p in ("cluster", "tiled", "sweep")),
            f"{label}: K2 launches by path {count}")
    return res, times, count, calls, per, float(np.median(times))


def eig_share(module, solve, label):
    """One more solve with ``module.eig_select`` (the host eigensolve of the
    deflated solvers, on its float64 CPU copy) timed: its host ms and share
    of the solve's wall."""
    import torch

    spent = [0.0, 0]
    inner = module.eig_select

    def timed_eig(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    module.eig_select = timed_eig
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        module.eig_select = inner
    print(f"phase 17: {label}: {spent[1]} host eigensolves, {1e3 * spent[0]:.3f} ms = "
          f"{100 * spent[0] / wall:.1f}% of the solve's {1e3 * wall:.3f} ms", flush=True)
    return {"eig_calls": spent[1], "eig_ms": 1e3 * spent[0], "wall_ms": 1e3 * wall}


def family_counts(label, got, jax, band, phase="phase 17"):
    """Print a count against gmres_tpu's and require it within `band`."""
    gap = got - jax
    print(f"{phase}: {label}: {got} against gmres_tpu's {jax} on the CPU, gap {gap:+d} "
          f"({'within' if abs(gap) <= 2 else 'not within'} 2, held to {band})", flush=True)
    require(abs(gap) <= band, f"{label}: {got}, gmres_tpu {jax}")


def np_rel(b_np, x, coefs=None):
    """numpy float64 ‖b − A x‖/‖b‖ on the Poisson (or general) stencil."""
    import numpy as np

    x_np = x.detach().cpu().numpy().astype(np.float64)
    ax = np_stencil(x_np) if coefs is None else np_stencil_general(x_np, coefs)
    return float(np.linalg.norm(b_np - ax) / np.linalg.norm(b_np))


def family_record(label, res, times, count, calls, per, err, **extra):
    out = {"label": label, "status": res.status, "residual": float(res.residual),
           "numpy_residual": err, "times": times, "launches": count,
           "applications": calls, "per_application": per,
           "host_syncs": res.host_syncs, **extra}
    for key in ("restarts", "iterations"):
        if hasattr(res, key):
            out[key] = getattr(res, key)
    return out


def restart_sweep_rows(gt_torch, dev, workdir):
    """The restart-sweep program with --solver lgmres and gmres-dr (m = 20,
    25; its rows), and each solve at m = 20 timed through the public
    function with its applications counted."""
    import numpy as np

    from gmres_tpu_torch.benchmarks import cli

    n = RESTART_SWEEP_N
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.chebyshev_preconditioner(op, *REF_EIG)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    out = []
    for (solver, tol), jax_counts in JAX_RESTART_SWEEP.items():
        argv = ["restart-sweep", "--nsize", str(n), "--solver", solver, "--ntests", "2",
                "--tol", f"{tol:g}"]
        if solver == "gmres-dr":
            argv += ["--deflate", "10"]
        rows = program_rows(cli, argv, workdir, phase="phase 17")
        for r in rows:
            m = r["restart_m"]
            jr, ji = jax_counts[m]
            family_counts(f"{r['name']} total inner", r["total_iters"], (jr - 1) * m + ji, 2)
            if solver == "gmres-dr":
                family_counts(f"{r['name']} restarts", r["restarts"], jr, 2)
            require(r["residual"] < tol * (10 if solver == "gmres-dr" else 1),
                    f"{r['name']}: residual {r['residual']}")
        m = 20

        def solve(A, M, solver=solver, tol=tol):
            if solver == "lgmres":
                return gt_torch.lgmres(A, b, restart=m, aug=3, tol=tol, M=M)
            return gt_torch.gmres_dr(A, b, restart=m, deflate=10, tol=tol, M=M)

        label = f"restart-sweep {solver} m={m} {n}x{n} tol {tol:g}"
        res, times, count, calls, per, med = family_run(
            label, solve, {"A": (op, b), "M": (m_inv, b)})
        err = np_rel(b_np, res.x)
        total = (res.restarts - 1) * m + res.iterations
        print(f"phase 17: {label}: status {res.status}, {res.restarts} restarts, {total} "
              f"total inner, {res.host_syncs} host syncs, residual {float(res.residual):.4e}, "
              f"numpy ‖b − A x‖/‖b‖ {err:.4e}; {1e3 * med / max(total, 1):.4f} ms an inner "
              f"iteration", flush=True)
        require(res.status == 0, f"{label}: status {res.status}")
        require(err < tol * (10 if solver == "gmres-dr" else LGMRES_ROUNDING),
                f"{label}: numpy residual {err:.3e}")
        out.append(family_record(label, res, times, count, calls, per, err,
                                 total_inner=total))
    return out


def gmres_dr_routes(gt_torch, dev):
    """gmres_dr at 300² with deflation "eig" and "subspace" (the same route,
    as in gmres_tpu), each against gmres_tpu's counts."""
    import numpy as np

    from gmres_tpu_torch.solvers import gmres_dr as gmres_dr_module

    n = GMRES_DR_N
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.chebyshev_preconditioner(op, *REF_EIG)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    out = []
    for route in ("eig", "subspace"):
        label = f"gmres_dr {n}x{n} m=30 k=10 deflation={route}"
        res, times, count, calls, per, med = family_run(
            label, lambda A, M, route=route: gt_torch.gmres_dr(
                A, b, restart=30, deflate=10, tol=1e-10, M=M, deflation=route),
            {"A": (op, b), "M": (m_inv, b)})
        err = np_rel(b_np, res.x)
        print(f"phase 17: {label}: status {res.status}, {res.restarts} restarts, "
              f"{res.iterations} in the last, {res.host_syncs} host syncs, residual "
              f"{float(res.residual):.4e}, numpy {err:.4e}", flush=True)
        family_counts(f"{label} restarts", res.restarts, JAX_GMRES_DR_300[0], 2)
        family_counts(f"{label} total inner", (res.restarts - 1) * 30 + res.iterations,
                      (JAX_GMRES_DR_300[0] - 1) * 30 + JAX_GMRES_DR_300[1], 2)
        require(res.status == 0 and err < 1e-9, f"{label}: status {res.status}, {err:.3e}")
        share = eig_share(gmres_dr_module, lambda route=route: gt_torch.gmres_dr(
            op, b, restart=30, deflate=10, tol=1e-10, M=m_inv, deflation=route), label)
        out.append(family_record(label, res, times, count, calls, per, err, eig=share))
    return out


def convdiff_idrs_row(gt_torch, dev, workdir):
    """IDR(8) with the float64 Jacobi cycle at 1024² through the convdiff
    program's own setup, timed, then the program itself."""
    import numpy as np

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs

    n = IDRS_N
    op, b, m_inv, _ = cli.convdiff_problem(n, dev, solver="idrs", precond="mg",
                                           tol=CONVDIFF_TOL)
    label = f"convdiff idrs s=8 mg f64 {n}x{n}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.idrs(A, b, s=8, tol=CONVDIFF_TOL, M=M),
        {"A": (op, b), "M": (m_inv, b)})
    coefs = convection_diffusion_coefs(0.4, 0.2)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    err = np_rel(b_np, res.x, coefs) * float(np.linalg.norm(b_np))  # absolute
    print(f"phase 17: {label}: status {res.status}, {res.iterations} iterations "
          f"({9 * res.iterations} operator applications), {res.host_syncs} host syncs, "
          f"residual {float(res.residual):.4e}, numpy ‖b − A x‖ {err:.4e}; "
          f"{1e3 * med / max(res.iterations, 1):.4f} ms an iteration", flush=True)
    family_counts(f"{label} iterations", res.iterations, JAX_IDRS_1024,
                  max(2, BICGSTAB_SPREAD * JAX_IDRS_1024))
    require(res.status == 0 and err < CONVDIFF_TOL, f"{label}: {res.status}, {err:.3e}")
    require(count["K1rr"] > 0 and count["K2"] > 0, f"{label}: the cycle's kernels {count}")
    prof = profile_solve(lambda: gt_torch.idrs(op, b, s=8, tol=CONVDIFF_TOL, M=m_inv),
                         label, med)
    rows = program_rows(cli, ["convdiff", "--nsize", str(n), "--precond", "mg",
                              "--solver", "idrs"], workdir, phase="phase 17")
    require(rows[0]["residual"] < CONVDIFF_TOL, f"convdiff idrs program: {rows}")
    return family_record(label, res, times, count, calls, per, err, profile=prof)


def gcrodr_sequences(gt_torch, dev):
    """GCRO-DR(40, k=10) on b₁ = A·1, then b₂ = A·x₂ fresh and warm, on
    convdiff 1024² with the multigrid cycle and on Poisson 300² with cbpr2;
    held to gmres_tpu's cycles, warm never more than fresh (fewer where
    gmres_tpu's is). The residual in the certified norm ‖M(b − A x)‖/‖M b‖:
    b − A x in numpy, M the port's."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs
    from gmres_tpu_torch.solvers import gcrodr as gcrodr_module

    out = []
    for key, jax_counts in JAX_GCRODR.items():
        model, n = key.split()[0], int(key.split()[1])
        if model == "convdiff":
            coefs = convection_diffusion_coefs(0.4, 0.2)
            op = gt_torch.convection_diffusion_operator(n, 0.4, 0.2)
            m_inv = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
        else:
            coefs = (4.0, -1.0, -1.0, -1.0, -1.0)
            op = gt_torch.poisson_operator(n)
            m_inv = gt_torch.chebyshev_preconditioner(op, *REF_EIG)
        x2 = np.random.default_rng(GCRODR_SEED).standard_normal((n, n))
        bs_np = [np_stencil_general(np.ones((n, n)), coefs), np_stencil_general(x2, coefs)]
        bs = [gt_torch.as_tensor(v, dev) for v in bs_np]
        first = gt_torch.gcrodr(op, bs[0], k=10, restart=40, tol=1e-9, M=m_inv)
        runs = {"first": (bs[0], None), "fresh": (bs[1], None), "warm": (bs[1], first.recycle)}
        results = {}
        for (name, (b, rec)), (jc, ji) in zip(runs.items(), jax_counts):
            label = f"gcrodr {key} {name}"
            res, times, count, calls, per, med = family_run(
                label, lambda A, M, b=b, rec=rec: gt_torch.gcrodr(
                    A, b, k=10, restart=40, tol=1e-9, M=M, recycle=rec),
                {"A": (op, b), "M": (m_inv, b)})
            b_np = bs_np[0] if name == "first" else bs_np[1]
            r_np = b_np - np_stencil_general(res.x.detach().cpu().numpy(), coefs)
            mr = m_inv(torch.as_tensor(r_np, device=dev)).cpu().numpy()
            mb = m_inv(torch.as_tensor(b_np, device=dev)).cpu().numpy()
            err = float(np.linalg.norm(mr) / np.linalg.norm(mb))
            print(f"phase 17: {label}: status {res.status}, {res.restarts} cycles, "
                  f"{res.iterations} in the last, {res.host_syncs} host syncs, residual "
                  f"{float(res.residual):.4e}, numpy ‖M(b − A x)‖/‖M b‖ {err:.4e}", flush=True)
            family_counts(f"{label} cycles", res.restarts, jc, 2)
            require(res.status == 0 and err < 1e-9, f"{label}: {res.status}, {err:.3e}")
            require(res.recycle.shape == (10, n, n) and res.recycle.dtype == torch.float64,
                    f"{label}: recycle block {tuple(res.recycle.shape)}")
            results[name] = res
            share = eig_share(gcrodr_module, lambda b=b, rec=rec: gt_torch.gcrodr(
                op, b, k=10, restart=40, tol=1e-9, M=m_inv, recycle=rec), label)
            out.append(family_record(label, res, times, count, calls, per, err, eig=share))
        fresh, warm = results["fresh"].restarts, results["warm"].restarts
        jax_fresh, jax_warm = jax_counts[1][0], jax_counts[2][0]
        print(f"phase 17: gcrodr {key}: warm {warm} cycles, fresh {fresh} (gmres_tpu "
              f"{jax_warm}, {jax_fresh})", flush=True)
        require(warm <= fresh and (warm < fresh or jax_warm == jax_fresh),
                f"gcrodr {key}: warm {warm} against fresh {fresh}")
    return out


def multirhs_rows(gt_torch, dev, workdir):
    """The multirhs program (block-gmres, s = 1, 4, 512², mg), then block
    GMRES at s = 4 through the public function with its block applications
    counted: each is one call under row_apply's vmap, one batched launch of
    each kernel."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli

    rows = program_rows(cli, ["multirhs", "--nsize", str(MULTIRHS_N), "--solver",
                              "block-gmres", "--s-list", "1,4"], workdir, phase="phase 17")
    for r in rows:
        family_counts(f"{r['name']} restarts", r["restarts"],
                      JAX_MULTIRHS_RESTARTS[r["s"]], 2)
        require(r["max_rhs_residual"] < 1e-8, f"{r['name']}: {r['max_rhs_residual']}")
    n, s = MULTIRHS_N, 4
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    xs = np.random.default_rng(0).standard_normal((s, n, n))
    b_np = np.stack([np_stencil(x) for x in xs])
    b = torch.as_tensor(b_np, device=dev)
    label = f"block_gmres s={s} mg {n}x{n}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.block_gmres(A, b, restart=30, tol=1e-8, M=M,
                                                 max_restarts=200),
        {"A": (op, b[0]), "M": (m_inv, b[0])})
    errs = [np_rel(b_np[i], res.x[i]) for i in range(s)]
    block_apps = {name: calls[name] / (FAMILY_REPEATS + 1) for name in calls}
    print(f"phase 17: {label}: status {res.status}, {res.restarts} restarts, "
          f"{res.host_syncs} host syncs, residuals {[f'{e:.3e}' for e in errs]} (numpy); "
          f"block applications a solve {block_apps}, each one batched launch of the "
          f"kernels of one vector's: A {per['A']}, M {per['M']}", flush=True)
    require(res.status == 0 and max(errs) < 1e-8, f"{label}: {res.status}, {errs}")
    require(all(count[f"{k} batched"] == count[k] for k in KERNELS),
            f"{label}: single-grid launches in a block solve {count}")
    family_counts(f"{label} restarts", res.restarts, JAX_MULTIRHS_RESTARTS[s], 2)
    return family_record(label, res, times, count, calls, per, max(errs), rows=rows)


def sstep_rows(gt_torch, dev):
    """s-step GMRES (s = 8, tol 1e-6) with the order-16 Chebyshev
    preconditioner at 1024², float64 and with a float32 block. The
    certified norm ‖M(b − A x)‖/‖b‖: b − A x in numpy, M the port's."""
    import numpy as np
    import torch

    n = SSTEP_N
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.chebyshev_preconditioner(op, 0.005, 8.0, order=16)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    out = []
    for tag, inner in (("f64", None), ("f32", torch.float32)):
        label = f"sstep_gmres s=8 cheb16 {n}x{n} {tag}"
        res, times, count, calls, per, med = family_run(
            label, lambda A, M, inner=inner: gt_torch.sstep_gmres(
                A, b, s=8, tol=1e-6, M=M, inner_dtype=inner),
            {"A": (op, b), "M": (m_inv, b)},
            warm=lambda A, M, inner=inner: gt_torch.sstep_gmres(
                A, b, s=8, tol=1e-6, M=M, inner_dtype=inner, max_restarts=WARM_RESTARTS))
        r_np = b_np - np_stencil(res.x.detach().cpu().numpy())
        err = float(np.linalg.norm(m_inv(torch.as_tensor(r_np, device=dev)).cpu().numpy())
                    / np.linalg.norm(b_np))
        print(f"phase 17: {label}: status {res.status}, {res.restarts} restarts, "
              f"{res.host_syncs} host syncs, residual {float(res.residual):.4e}, numpy "
              f"‖M(b − A x)‖/‖b‖ {err:.4e}; {1e3 * med / max(res.restarts, 1):.4f} ms a "
              f"cycle", flush=True)
        band = 2 if tag == "f64" else max(2, SSTEP_F32_SPREAD * JAX_SSTEP_RESTARTS[tag])
        family_counts(f"{label} restarts", res.restarts, JAX_SSTEP_RESTARTS[tag], band)
        require(per["M"]["K1"] == 15, f"{label}: {per['M']['K1']} K1 launches an M")
        require(res.status == 0 and err < 1e-6, f"{label}: {res.status}, {err:.3e}")
        out.append(family_record(label, res, times, count, calls, per, err))
    return out


def fgmres_row(gt_torch, dev):
    """FGMRES(10) at 300², tol 1e-6, M four steps of CG (a nonlinear M)."""
    import numpy as np

    n = FGMRES_N
    op = gt_torch.poisson_operator(n)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)

    def inner_cg(r):
        return gt_torch.cg(op, r, tol=0.0, max_iterations=4).x

    label = f"fgmres m=10 inner cg4 {n}x{n}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.fgmres(A, b, restart=10, tol=1e-6, M=M),
        {"A": (op, b), "M": (inner_cg, b)},
        warm=lambda A, M: gt_torch.fgmres(A, b, restart=10, tol=1e-6, M=M,
                                          max_restarts=WARM_RESTARTS))
    err = np_rel(b_np, res.x)
    total = (res.restarts - 1) * 10 + res.iterations
    print(f"phase 17: {label}: status {res.status}, {res.restarts} restarts, {total} total "
          f"inner, {res.host_syncs} host syncs, residual {float(res.residual):.4e}, numpy "
          f"{err:.4e}; {1e3 * med / max(total, 1):.4f} ms an inner iteration", flush=True)
    family_counts(f"{label} restarts", res.restarts, JAX_FGMRES_300[0],
                  max(2, FGMRES_SPREAD * JAX_FGMRES_300[0]))
    require(res.status == 0 and err < 1e-6, f"{label}: {res.status}, {err:.3e}")
    return family_record(label, res, times, count, calls, per, err, total_inner=total)


def phase_family(gt_torch, dev, workdir):
    """Phase 17: every row of the GMRES family; returns the launches over
    the phase (each row's counts summed) and the rows."""
    t_phase = time.perf_counter()
    rows = []
    rows += restart_sweep_rows(gt_torch, dev, workdir)
    rows += gmres_dr_routes(gt_torch, dev)
    rows.append(convdiff_idrs_row(gt_torch, dev, workdir))
    rows += gcrodr_sequences(gt_torch, dev)
    rows.append(multirhs_rows(gt_torch, dev, workdir))
    rows += sstep_rows(gt_torch, dev)
    rows.append(fgmres_row(gt_torch, dev))
    launches = dict.fromkeys(mg_counters(), 0)
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] += v
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, rows


def np_stencil7(x):
    """Independent float64 3-D 7-point Laplacian in numpy (zero
    boundaries)."""
    y = 6.0 * x
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(1, None), slice(None, -1)
        y[tuple(lo)] -= x[tuple(hi)]
        y[tuple(hi)] -= x[tuple(lo)]
    return y


def np_varcoef(c, x):
    """Independent float64 variable-coefficient operator in numpy: the
    harmonic mean of the two cells' c on each face, the cell's own c on a
    boundary face, (A x)ᵢⱼ = Σ_faces c_face (xᵢⱼ − x_nbr) with x = 0 outside."""
    import numpy as np

    y = np.zeros_like(x)
    for ax in range(2):
        for side in (1, -1):
            nb_c = np.roll(c, side, axis=ax)
            nb_x = np.roll(x, side, axis=ax)
            edge = [slice(None)] * 2
            edge[ax] = 0 if side == 1 else -1
            nb_c[tuple(edge)] = c[tuple(edge)]
            nb_x[tuple(edge)] = 0.0
            y += 2.0 * c * nb_c / (c + nb_c) * (x - nb_x)
    return y


@contextlib.contextmanager
def solutions_of(module, name):
    """Within the block ``module.name`` (a solver that a program imports
    when it runs) also keeps each call's solution x, in call order, so that
    the program's rows are checked on x itself and not on the residual the
    solver certified. The program's ``_timed`` calls it twice a row (a
    warm-up, then the timed solve): the row's x is every second one."""
    solver = getattr(module, name)
    xs = []

    def tapped(*args, **kw):
        res = solver(*args, **kw)
        xs.append(res.x)
        return res

    setattr(module, name, tapped)
    try:
        yield xs
    finally:
        setattr(module, name, solver)


def row_solutions(xs, rows, label):
    """The timed solve's x of each program row, as float64 numpy arrays."""
    require(len(xs) == 2 * len(rows), f"{label}: {len(xs)} solves for {len(rows)} rows")
    return [x.detach().cpu().numpy() for x in xs[1::2]]


def short_record(label, res, times, count, calls, per, err, **extra):
    """A phase-18 row: the phase-17 record and the launches per solve and
    per application."""
    solves = SHORT_REPEATS + 1
    return family_record(label, res, times, count, calls, per, err,
                         launches_per_solve={k: v / solves for k, v in count.items()},
                         **extra)


def short_print(label, res, err, norm, med, unit="iteration", count=None, phase="phase 18"):
    iters = res.iterations
    print(f"{phase}: {label}: status {res.status}, {iters} {unit}s, {res.host_syncs} "
          f"host syncs, residual {float(res.residual):.4e}, numpy {norm} {err:.4e}; median "
          f"{1e3 * med:.3f} ms a solve, {1e3 * med / max(iters, 1):.4f} ms "
          f"{'an' if unit[0] in 'aeiou' else 'a'} {unit}"
          + ("" if count is None else f"; launches a solve {{"
             + ", ".join(f"{k}: {v / (SHORT_REPEATS + 1):g}" for k, v in count.items() if v)
             + "}"), flush=True)


def short_multirhs(gt_torch, dev, workdir):
    """The multirhs program with block CG (JAX's defaults: 512², s 1, 2, 4,
    8, the V-cycle, tol 1e-8), its launches counted over the program; then
    block_cg at s = 4 through the public function, its block applications
    counted: each one call under row_apply's vmap, one batched launch of
    each kernel."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.solvers import block_cg as block_cg_module

    mg_counters(reset=True)
    with solutions_of(block_cg_module, "block_cg") as xs:
        rows = program_rows(cli, ["multirhs", "--nsize", str(MULTIRHS_N), "--solver",
                                  "block-cg", "--s-list", "1,2,4,8"], workdir,
                            phase="phase 18")
    prog_count = mg_counters()
    # The program's right-hand sides, drawn anew in numpy as it draws them:
    # b_i = A x_i, x_i standard normal from seed 0, in turn for each s.
    rng = np.random.default_rng(0)
    for r, x_np in zip(rows, row_solutions(xs, rows, "multirhs block-cg")):
        b_np = np.stack([np_stencil(x) for x in rng.standard_normal((r["s"], MULTIRHS_N,
                                                                     MULTIRHS_N))])
        err = max(float(np.linalg.norm(b_np[i] - np_stencil(x_np[i])))
                  for i in range(r["s"]))
        print(f"phase 18: {r['name']}: numpy max ‖bᵢ − A xᵢ‖ {err:.4e} (certified "
              f"{r['max_rhs_residual']:.4e})", flush=True)
        family_counts(f"{r['name']} iterations", r["iterations"],
                      JAX_PHASE18["multirhs"][r["s"]], 2, phase="phase 18")
        require(err < 1e-8 and r["max_rhs_residual"] < 1e-8,
                f"{r['name']}: numpy {err:.3e}, certified {r['max_rhs_residual']:.3e}")
    print(f"phase 18: multirhs block-cg program: launches {prog_count}; time per RHS "
          + ", ".join(f"s={r['s']} {1e3 * r['time_per_rhs']:.3f} ms "
                      f"(amortisation {r['amortization_vs_s1']:.3f})" for r in rows),
          flush=True)
    require(prog_count["K1"] > 0 and prog_count["K1rr"] > 0 and prog_count["K2"] > 0,
            f"multirhs block-cg: the V-cycle's kernels {prog_count}")
    n, s = MULTIRHS_N, BLOCK_CG_S
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    xs = np.random.default_rng(0).standard_normal((s, n, n))
    b_np = np.stack([np_stencil(x) for x in xs])
    b = torch.as_tensor(b_np, device=dev)
    label = f"block_cg s={s} mg {n}x{n}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.block_cg(A, b, tol=1e-8, M=M, max_iterations=2000),
        {"A": (op, b[0]), "M": (m_inv, b[0])}, repeats=SHORT_REPEATS, phase="phase 18")
    x_np = res.x.detach().cpu().numpy()
    errs = [float(np.linalg.norm(b_np[i] - np_stencil(x_np[i]))) for i in range(s)]
    short_print(label, res, max(errs), "max ‖bᵢ − A xᵢ‖", med, count=count)
    print(f"phase 18: {label}: block applications over the warm-up and {SHORT_REPEATS} "
          f"solves {calls}; launches per block application (batched) A {per['A']}, M "
          f"{per['M']}", flush=True)
    require(res.status == 0 and max(errs) < 1e-8, f"{label}: {res.status}, {errs}")
    require(all(count[f"{k} batched"] == count[k] for k in KERNELS),
            f"{label}: single-grid launches in a block solve {count}")
    family_counts(f"{label} iterations", res.iterations, JAX_PHASE18["block_cg"][0], 2,
                  phase="phase 18")
    prof = profile_solve(lambda: gt_torch.block_cg(op, b, tol=1e-8, M=m_inv,
                                                   max_iterations=2000), label, med)
    return [short_record(label, res, times, count, calls, per, max(errs), rows=rows,
                         program_launches=prog_count, profile=prof)]


def short_poisson(gt_torch, dev):
    """MINRES and s-step CG (s = 4) on Poisson 1024², float64, with the
    V-cycle, tol 1e-9·‖b‖: MINRES certified in the M-norm √(r, M r), s-step
    CG in ‖r‖₂ (b − A x in numpy, M the port's)."""
    import numpy as np
    import torch

    n = POISSON_1024
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    tol = 1e-9 * float(np.linalg.norm(b_np))
    out = []
    for name in ("minres", "sstep_cg"):
        label = f"{name} mg {n}x{n} f64" + (f" s={SSTEP_CG_S}" if name == "sstep_cg" else "")
        if name == "minres":
            def solve(A, M):
                return gt_torch.minres(A, b, tol=tol, M=M)
        else:
            def solve(A, M):
                return gt_torch.sstep_cg(A, b, s=SSTEP_CG_S, tol=tol, M=M)
        res, times, count, calls, per, med = family_run(
            label, solve, {"A": (op, b), "M": (m_inv, b)}, repeats=SHORT_REPEATS,
            phase="phase 18")
        r_np = b_np - np_stencil(res.x.detach().cpu().numpy())
        if name == "minres":
            mr = m_inv(torch.as_tensor(r_np, device=dev)).cpu().numpy()
            err, norm = float(np.sqrt(np.vdot(r_np, mr))), "√(r, M r)"
        else:
            err, norm = float(np.linalg.norm(r_np)), "‖b − A x‖"
        short_print(label, res, err, norm, med, count=count)
        require(res.status == 0 and err < tol, f"{label}: {res.status}, {err:.3e} (tol {tol:.3e})")
        family_counts(f"{label} iterations", res.iterations, JAX_PHASE18[name][0], 2,
                      phase="phase 18")
        prof = profile_solve(lambda: solve(op, m_inv), label, med)
        out.append(short_record(label, res, times, count, calls, per, err, tol=tol,
                                profile=prof))
    return out


def short_chebyshev(gt_torch, dev):
    """chebyshev_solve with coefs (the polynomial on K2) on Poisson, float64,
    bounds from poisson_spectral_bounds, tol 1e-9·‖b‖: at 1024² order 512,
    and at 64² order 16 (see CHEB_ORDER_1024). Each cycle is one K2 call and
    one A (one K1 launch); the 64² row must launch exactly one K2 and one
    K1 a cycle."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused

    out = []
    for key, (n, order) in (("chebyshev", (POISSON_1024, CHEB_ORDER_1024)),
                            ("chebyshev64", CHEB_SMALL)):
        op = gt_torch.poisson_operator(n)
        lo, hi = gt_torch.poisson_spectral_bounds(n)
        b_np = np_stencil(np.ones((n, n)))
        b = gt_torch.as_tensor(b_np, dev)
        tol = 1e-9 * float(np.linalg.norm(b_np))
        poly = gt_torch.chebyshev_stencil_preconditioner(lo, hi, order=order,
                                                         coefs=(4.0, -1.0, -1.0, -1.0, -1.0))
        before = mg_counters()
        poly(b)
        torch.cuda.synchronize()
        per_call = {k: v - before[k] for k, v in mg_counters().items()}
        label = f"chebyshev_solve order {order} coefs {n}x{n} f64"
        calls = {"A": 0}
        wrapped = counted(op, calls, "A")

        def solve():
            return gt_torch.chebyshev_solve(wrapped, b, lo, hi, order=order, tol=tol,
                                            coefs=(4.0, -1.0, -1.0, -1.0, -1.0))

        mg_counters(reset=True)
        _, t_warm = timed(solve)
        times = []
        for _ in range(SHORT_REPEATS):
            res, t = timed(solve)
            times.append(t)
        count = mg_counters()
        cycles = res.iterations * (SHORT_REPEATS + 1)
        print(f"phase 18: {label}: wall s over {SHORT_REPEATS}: {quartiles(times)} (warm-up "
              f"{t_warm:.4f}); {cycles} cycles and {calls['A']} applications of A over the "
              f"warm-up and {SHORT_REPEATS} solves; launches of one K2 call {per_call}; "
              f"launches {count}", flush=True)
        require(calls["A"] == cycles and count["K1"] == cycles,
                f"{label}: {calls['A']} A, {count['K1']} K1 for {cycles} cycles")
        require(all(count[k] == cycles * per_call[k] for k in ("K2", "K2 cluster", "K2 tiled",
                                                               "K2 sweep")),
                f"{label}: K2 launches {count} are not one call a cycle {per_call}")
        if key == "chebyshev64":
            require(per_call["K2"] == 1 and count["K2"] == cycles,
                    f"{label}: {count['K2']} K2 launches for {cycles} cycles")
        err = float(np.linalg.norm(b_np - np_stencil(res.x.detach().cpu().numpy())))
        med = float(np.median(times))
        short_print(label, res, err, "‖b − A x‖", med, unit="cycle", count=count)
        require(res.status == 0 and err < tol, f"{label}: {res.status}, {err:.3e}")
        family_counts(f"{label} cycles", res.iterations, JAX_PHASE18[key][0], 2,
                      phase="phase 18")
        prof = profile_solve(solve, label, med) if key == "chebyshev" else None
        out.append(short_record(label, res, times, count, calls,
                                {"A": {"K1": 1}, "K2 call": per_call}, err, tol=tol,
                                k2_path=fused.chebk_plan(n, n, order - 1, b.dtype)[0],
                                profile=prof))
    return out


def short_poisson3d(gt_torch, dev):
    """CG with the 3-D V-cycle at 128³, float64, b = A·1, tol 1e-8, at most
    400 iterations: the 3-D arm of gmres_tpu's scale program. The 7-point
    stencil and the 3-D cycle are plain PyTorch (plain jnp in gmres_tpu):
    no kernel launches, and none is required."""
    import numpy as np

    n = POISSON3D_N
    op = gt_torch.poisson3d_operator(n)
    m_inv = gt_torch.poisson3d_multigrid_preconditioner(n)
    b_np = np_stencil7(np.ones((n, n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    label = f"cg mg3d {n}^3 f64"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.cg(A, b, tol=1e-8, max_iterations=400, M=M),
        {"A": (op, b), "M": (m_inv, b)}, repeats=SHORT_REPEATS, phase="phase 18",
        needs_k1=False)
    err = float(np.linalg.norm(b_np - np_stencil7(res.x.detach().cpu().numpy())))
    short_print(label, res, err, "‖b − A x‖", med, count=count)
    require(res.status == 0 and err < 1e-8, f"{label}: {res.status}, {err:.3e}")
    family_counts(f"{label} iterations", res.iterations, JAX_PHASE18["poisson3d"][0], 2,
                  phase="phase 18")
    prof = profile_solve(lambda: gt_torch.cg(op, b, tol=1e-8, max_iterations=400, M=m_inv),
                         label, med)
    return [short_record(label, res, times, count, calls, per, err, profile=prof,
                         levels=m_inv.levels, fine_equiv_sweeps=m_inv.fine_equiv_sweeps)]


def short_anisotropic(gt_torch, dev):
    """CG with the line-smoothed anisotropic cycle at 1024², ε = 0.01,
    float64, b = A·1, tol 1e-8; the operator (also inside the cycle) on K1
    with the anisotropic coefficients."""
    import numpy as np

    from gmres_tpu_torch.models.anisotropic import anisotropic_coefs

    n, eps = ANISO_N, ANISO_EPS
    coefs = anisotropic_coefs(eps)
    op = gt_torch.anisotropic_operator(n, eps)
    m_inv = gt_torch.anisotropic_multigrid_preconditioner(n, eps)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    b = gt_torch.as_tensor(b_np, dev)
    label = f"cg anisotropic line mg {n}x{n} eps {eps:g} f64"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.cg(A, b, tol=1e-8, M=M),
        {"A": (op, b), "M": (m_inv, b)}, repeats=SHORT_REPEATS, phase="phase 18")
    err = float(np.linalg.norm(
        b_np - np_stencil_general(res.x.detach().cpu().numpy(), coefs)))
    short_print(label, res, err, "‖b − A x‖", med, count=count)
    require(per["A"]["K1"] == 1, f"{label}: {per['A']} launches an A")
    require(res.status == 0 and err < 1e-8, f"{label}: {res.status}, {err:.3e}")
    family_counts(f"{label} iterations", res.iterations, JAX_PHASE18["anisotropic"][0], 2,
                  phase="phase 18")
    return [short_record(label, res, times, count, calls, per, err)]


def short_varcoef(gt_torch, dev, workdir):
    """The varcoef program at its default 256² (four rows), then CG with
    mg+defl on the varcoef model at 1024² through the program's own setup,
    its L2 error against x_true as the program reports it. The
    variable-coefficient operator, its cycle and the deflation are plain
    PyTorch (plain jnp in gmres_tpu): no kernel launches, and none is
    required."""
    import numpy as np

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.solvers import cg as cg_module

    mg_counters(reset=True)
    with solutions_of(cg_module, "cg") as xs:
        rows = program_rows(cli, ["varcoef", "--nsize", str(VARCOEF_DEFAULT_N)], workdir,
                            phase="phase 18")
    prog_count = mg_counters()
    # The program's c and b (made in numpy by varcoef_problem); A in numpy.
    c, _, _, b, _, _ = cli.varcoef_problem(VARCOEF_DEFAULT_N, rows[0]["contrast"], dev)
    c_np, b_np = c.cpu().numpy(), b.cpu().numpy()
    for r, x_np in zip(rows, row_solutions(xs, rows, "varcoef")):
        err = float(np.linalg.norm(b_np - np_varcoef(c_np, x_np)))
        jax_it, jax_l2 = JAX_PHASE18["varcoef"][r["name"]]
        family_counts(f"{r['name']} iterations", r["iterations"], jax_it, 2, phase="phase 18")
        print(f"phase 18: {r['name']}: numpy ‖b − A x‖ {err:.4e} (tol {r['tol']:.4e}), "
              f"L2 error {r['l2_error']:.4e} (gmres_tpu {jax_l2:.4e}), "
              f"host syncs {r['host_syncs']}", flush=True)
        require(err < r["tol"] and r["residual"] < r["tol"],
                f"{r['name']}: numpy {err:.3e}, certified {r['residual']:.3e}, "
                f"tol {r['tol']:.3e}")
    n = VARCOEF_N
    c, op, x_true, b, diag, w = cli.varcoef_problem(n, VARCOEF_CONTRAST, dev)
    m_inv = cli.varcoef_preconditioners(c, op, diag, w)["mg+defl"]
    b_np = b.detach().cpu().numpy()
    tol = 1e-9 * float(np.linalg.norm(b_np))
    label = f"cg varcoef mg+defl {n}x{n} contrast {VARCOEF_CONTRAST:g}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.cg(A, b, tol=tol, max_iterations=20_000, M=M),
        {"A": (op, b), "M": (m_inv, b)}, repeats=SHORT_REPEATS, phase="phase 18",
        needs_k1=False)
    x_np = res.x.detach().cpu().numpy()
    err = float(np.linalg.norm(b_np - np_varcoef(c.cpu().numpy(), x_np)))
    l2 = float(np.linalg.norm((x_np - x_true.cpu().numpy()).ravel()))
    short_print(label, res, err, "‖b − A x‖", med, count=count)
    jax_it, _, jax_l2 = JAX_PHASE18["varcoef1024"]
    print(f"phase 18: {label}: L2 error against x_true {l2:.4e} (gmres_tpu {jax_l2:.4e})",
          flush=True)
    require(res.status == 0 and err < tol, f"{label}: {res.status}, {err:.3e}")
    family_counts(f"{label} iterations", res.iterations, jax_it, 2, phase="phase 18")
    return [short_record(label, res, times, count, calls, per, err, tol=tol, l2_error=l2,
                         rows=rows, program_launches=prog_count)]


def phase_short(gt_torch, dev, workdir):
    """Phase 18: the short-recurrence family and the real models; returns
    the launches over the phase (each row's counts summed) and the rows."""
    t_phase = time.perf_counter()
    rows = []
    rows += short_multirhs(gt_torch, dev, workdir)
    rows += short_poisson(gt_torch, dev)
    rows += short_chebyshev(gt_torch, dev)
    rows += short_poisson3d(gt_torch, dev)
    rows += short_anisotropic(gt_torch, dev)
    rows += short_varcoef(gt_torch, dev, workdir)
    launches = dict.fromkeys(mg_counters(), 0)
    for r in rows:
        for src in (r["launches"], r.get("program_launches", {})):
            for k, v in src.items():
                launches[k] += v
    seconds = time.perf_counter() - t_phase
    print(f"phase 18: {seconds:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 19: Helmholtz and the solvers that need Aᵀ or J·v.
# ---------------------------------------------------------------------------


def rule_counters(reset: bool = False) -> dict:
    """mg_counters plus how many of K1's launches were transposes and
    tangents (ops/stencil.py:Stencil5Grid.rule_applications)."""
    from gmres_tpu_torch.ops.stencil import Stencil5Grid

    if reset:
        for k in Stencil5Grid.rule_applications:
            Stencil5Grid.rule_applications[k] = 0
    out = mg_counters(reset)
    out.update({f"K1 {k}": v for k, v in Stencil5Grid.rule_applications.items()})
    return out


def np_transpose_coefs(coefs):
    """The transpose's coefficients: west↔east and south↔north."""
    c, w, e, s, n = coefs
    return (c, e, w, n, s)


def k1_rules(gt_torch, rng, dev):
    """Phase 19 (a): K1's autograd and torch.func rules on the card at
    RULE_N² in float64 and float32, Poisson and convdiff (0.4, 0.2)
    coefficients: the adjoint identity ⟨A x, y⟩ = ⟨x, Aᵀ y⟩ with Aᵀ the
    pullback of torch.func.vjp through K1; the vjp, the jvp and a tensor
    coefficient's gradient against the plain stencil's autograd on the
    card; each rule's K1 launches; the rules' device times against the
    plain autograd's; and the refusal of K2, K1's halo form, K1rr and K3
    under a transform."""
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs
    from gmres_tpu_torch.ops import fused, stencil

    n = RULE_N
    out = []
    launches = dict.fromkeys(rule_counters(), 0)
    tols = {torch.float64: (1e-13, 1e-13), torch.float32: (1e-5, 2e-5)}
    for label, coefs in (("poisson", stencil.POISSON_COEFS),
                         ("convdiff", convection_diffusion_coefs(0.4, 0.2))):
        for dt in (torch.float64, torch.float32):
            x = torch.as_tensor(rng.standard_normal((n, n)), device=dev).to(dt)
            y = torch.as_tensor(rng.standard_normal((n, n)), device=dev).to(dt)
            tol_adj, tol_cmp = tols[dt]

            def plain(v, cf=coefs):
                return stencil.stencil_5pt_general(v, *cf)

            def k1(v, cf=coefs):
                return stencil.stencil_5pt_pallas(v, cf)

            before = rule_counters()
            ax, pull = torch.func.vjp(k1, x)
            (aty,) = pull(y)
            _, jv = torch.func.jvp(k1, (x,), (y,))
            torch.cuda.synchronize()
            after = rule_counters()
            used = {k: after[k] - before[k] for k in after}
            for k in launches:
                launches[k] += used[k]
            lhs = float(torch.sum(ax.double() * y.double()))
            rhs = float(torch.sum(x.double() * aty.double()))
            adj = abs(lhs - rhs) / (float(torch.linalg.norm(ax.double()))
                                    * float(torch.linalg.norm(y.double())))
            _, pull_p = torch.func.vjp(plain, x)
            (aty_p,) = pull_p(y)
            _, jv_p = torch.func.jvp(plain, (x,), (y,))

            def rel(a, b):
                return float((a - b).abs().max()) / float(b.abs().max())

            vjp_err, jvp_err = rel(aty, aty_p), rel(jv, jv_p)
            # A tensor coefficient's gradient (west), K1 against plain.
            cw_k = torch.tensor(coefs[1], dtype=dt, device=dev, requires_grad=True)
            cw_p = torch.tensor(coefs[1], dtype=dt, device=dev, requires_grad=True)
            before = rule_counters()
            (g_k,) = torch.autograd.grad(torch.sum(stencil.stencil_5pt_pallas(
                x, (coefs[0], cw_k, *coefs[2:])) * y), cw_k)
            torch.cuda.synchronize()
            coef_used = {k: v - before[k] for k, v in rule_counters().items()}
            for k in launches:
                launches[k] += coef_used[k]
            (g_p,) = torch.autograd.grad(torch.sum(stencil.stencil_5pt_general(
                x, coefs[0], cw_p, *coefs[2:]) * y), cw_p)
            coef_err = abs(float(g_k) - float(g_p)) / abs(float(g_p))
            # Eager call times (CUDA events around 20 calls, host overhead
            # in): a pullback, K1's one mirrored launch, against the plain
            # stencil's autograd backward; the forward against the plain
            # stencil. (A pullback runs in autograd's engine, which a CUDA
            # graph capture would not see on its stream.)
            ms = {"transpose": call_ms(lambda: pull(y)[0], 20),
                  "transpose_plain": call_ms(lambda: pull_p(y)[0], 20),
                  "forward": call_ms(lambda: k1(x), 20),
                  "forward_plain": call_ms(lambda: plain(x), 20)}
            rec = {"case": f"K1 rules {label} {n}x{n} {str(dt)[6:]}", "adjoint_rel": adj,
                   "vjp_rel": vjp_err, "jvp_rel": jvp_err, "coef_grad_rel": coef_err,
                   "launches": used, "coef_launches": coef_used, **ms}
            print(f"phase 19: {rec['case']}: adjoint |⟨Ax,y⟩ − ⟨x,Aᵀy⟩|/(‖Ax‖‖y‖) "
                  f"{adj:.3e} (tol {tol_adj:.0e}); vjp {vjp_err:.3e}, jvp {jvp_err:.3e}, "
                  f"west-coefficient gradient {coef_err:.3e} against the plain stencil's "
                  f"autograd (tol {tol_cmp:.0e}); launches vjp+pullback+jvp "
                  f"{ {k: v for k, v in used.items() if v} }, coefficient gradient "
                  f"{ {k: v for k, v in coef_used.items() if v} }; eager call ms: pullback "
                  f"{ms['transpose']:.4f} (plain autograd {ms['transpose_plain']:.4f}), "
                  f"forward {ms['forward']:.4f} (plain {ms['forward_plain']:.4f})",
                  flush=True)
            require(adj <= tol_adj, f"{rec['case']}: adjoint identity {adj:.3e}")
            require(max(vjp_err, jvp_err, coef_err) <= tol_cmp,
                    f"{rec['case']}: rules against plain {vjp_err}, {jvp_err}, {coef_err}")
            # vjp: the primal and one transpose; jvp: the primal and one
            # tangent; the coefficient gradient: the primal only (its
            # gradient is a torch reduction).
            require(used["K1"] == 4 and used["K1 transpose"] == 1 and used["K1 tangent"] == 1,
                    f"{rec['case']}: launches {used}")
            require(coef_used["K1"] == 1 and coef_used["K1 transpose"] == 0,
                    f"{rec['case']}: coefficient-gradient launches {coef_used}")
            out.append(rec)
    # Everything else refuses a transform, loudly.
    r = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    theta, _, steps = fused.chebyshev_k_scalars(0.5, 8.0, 3)
    dia = gt_torch.sparse_operator(gt_torch.poisson_dia(64, device=dev))
    v64 = torch.as_tensor(rng.standard_normal(64 * 64), device=dev)
    refusals = {
        "K2 under torch.func.vjp": lambda: torch.func.vjp(
            lambda v: fused.chebk_cuda(v, theta, steps), r),
        "K1 halo form under autograd": lambda: stencil.stencil5_cuda(
            r.clone().requires_grad_(), r[0], None),
        "K1rr under autograd": lambda: stencil.residual_restrict_cuda(
            r.clone().requires_grad_(), r),
        "K3 under torch.func.jvp": lambda: torch.func.jvp(dia, (v64,), (v64,)),
    }
    before = rule_counters()
    for what, call in refusals.items():
        try:
            call()
        except RuntimeError as exc:
            msg = str(exc)
            require("ROADMAP: transposes of K2–K8" in msg and "route cuda" in msg,
                    f"{what}: {msg}")
            print(f"phase 19: {what} raises: {msg[:110]}…", flush=True)
        else:
            require(False, f"{what}: no error")
    torch.cuda.synchronize()
    require(rule_counters() == before, "a refused call launched a kernel")
    out.append(k1_host_cost(stencil, rng, dev))
    return out, launches


def k1_host_cost(stencil, rng, dev, n: int = 256, rounds: int = 5) -> dict:
    """Host µs to enqueue one full-grid K1 application (float64, n², a grid
    whose device time is below the host's), the median of `rounds` rounds
    of host_us: the wrapper called directly; the routed stencil_5pt_pallas
    with nothing tracked (it calls the wrapper); the autograd.Function
    Stencil5Grid on the same untracked input (the route every call took
    before the routed entry learned to skip it); and the routed entry with
    x requiring grad (the Function and its graph node)."""
    import statistics

    import torch

    coefs = (4.0, -1.4, -0.6, -1.2, -0.8)
    x = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    xt = x.clone().requires_grad_()
    calls = {"wrapper": lambda: stencil.stencil5_cuda(x, None, None, coefs),
             "routed": lambda: stencil.stencil_5pt_pallas(x, coefs),
             "function": lambda: stencil.Stencil5Grid.apply(x, *coefs),
             "routed_tracked": lambda: stencil.stencil_5pt_pallas(xt, coefs)}
    us = {k: statistics.median(host_us(f, 500) for _ in range(rounds))
          for k, f in calls.items()}
    print(f"phase 19: K1 host µs an application at {n}x{n} float64 (median of {rounds} "
          f"rounds of 500): wrapper {us['wrapper']:.2f}, routed (nothing tracked) "
          f"{us['routed']:.2f}, through Stencil5Grid untracked {us['function']:.2f}, "
          f"routed with x requiring grad {us['routed_tracked']:.2f}", flush=True)
    return {"case": f"K1 host cost {n}x{n} float64", "host_us": us}


def phase19_run(label, solve, repeats=PHASE19_REPEATS, warmup=None):
    """A warm-up (`warmup`, else a solve) and `repeats` timed solves with the
    launch counts set to 0 just before and read just after; returns the last
    result, the times, the counts and the median."""
    import numpy as np

    rule_counters(reset=True)
    _, t_warm = timed(warmup or solve)
    times = []
    for _ in range(repeats):
        res, t = timed(solve)
        times.append(t)
    count = rule_counters()
    print(f"phase 19: {label}: wall s over {repeats}: {quartiles(times)} (warm-up "
          f"{t_warm:.4f}); launches {count}", flush=True)
    return res, times, count, float(np.median(times))


def p19_counts(label, got, jax, band):
    """family_counts for phase 19 (a band below 1 is a share of gmres_tpu's
    count, at least 2)."""
    if band < 1:
        band = max(2, int(band * jax))
    family_counts(label, got, jax, band, phase="phase 19")


def np_helmholtz(x, kh2):
    return np_stencil_general(x, (4.0 - kh2, -1.0, -1.0, -1.0, -1.0))


def helmholtz_rows(gt_torch, dev, workdir):
    """MINRES with the SPD shifted-Laplacian cycle at HELM_N², kh2 factor 10,
    float64 and with the float32 cycle (the program's --precision mixed),
    certified in the M-norm √(r, M r) (r = b − A x in numpy); then the
    helmholtz program at its 256² default."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.solvers import minres as minres_module

    n = HELM_N
    kh2 = HELM_FACTOR * gt_torch.helmholtz_lambda_min(n, 0.0)
    op = gt_torch.helmholtz_operator(n, kh2)
    b_np = np_helmholtz(np.ones((n, n)), kh2)
    b = gt_torch.as_tensor(b_np, dev)
    out = []
    for key, inner in (("helmholtz1024", None), ("helmholtz1024_mixed", torch.float32)):
        m_inv = gt_torch.helmholtz_shifted_laplacian_preconditioner(
            n, kh2, internal_dtype=inner)
        label = f"minres spd-mg helmholtz {n}x{n} {'mixed' if inner else 'f64'}"
        res, times, count, calls, per, med = family_run(
            label, lambda A, M: gt_torch.minres(A, b, tol=HELM_TOL, max_iterations=50_000,
                                                M=M),
            {"A": (op, b), "M": (m_inv, b)}, repeats=PHASE19_REPEATS, phase="phase 19")
        r_np = b_np - np_helmholtz(res.x.detach().cpu().numpy(), kh2)
        mr = m_inv(torch.as_tensor(r_np, device=dev)).cpu().numpy()
        err = float(np.sqrt(np.vdot(r_np, mr)))
        short_print(label, res, err, "√(r, M r)", med, count=count, phase="phase 19")
        require(res.status == 0 and err < HELM_TOL, f"{label}: {res.status}, {err:.3e}")
        p19_counts(f"{label} iterations", res.iterations, JAX_PHASE19[key][0][1],
                   HELM_MINRES_BAND)
        prof = profile_solve(lambda: gt_torch.minres(op, b, tol=HELM_TOL, M=m_inv),
                             label, med) if inner is None else None
        out.append(family_record(label, res, times, count, calls, per, err, profile=prof,
                                 levels=m_inv.levels, level_shifts=m_inv.level_shifts))
    rule_counters(reset=True)
    with solutions_of(minres_module, "minres") as xs:
        rows = program_rows(cli, ["helmholtz", "--nsize", str(HELM_PROGRAM_N)], workdir,
                            phase="phase 19")
    prog_count = rule_counters()
    (x_np,) = row_solutions(xs, rows, "helmholtz")
    kh2 = rows[0]["kh2"]
    n = HELM_PROGRAM_N
    err = float(np.linalg.norm(np_helmholtz(np.ones((n, n)), kh2) - np_helmholtz(x_np, kh2)))
    print(f"phase 19: {rows[0]['name']}: numpy ‖b − A x‖ {err:.4e}; launches {prog_count}",
          flush=True)
    p19_counts(f"{rows[0]['name']} program iterations", rows[0]["iterations"],
               JAX_PHASE19["helmholtz256"][0][1], HELM_MINRES_BAND)
    require(prog_count["K1"] > 0 and prog_count["K2"] > 0 and prog_count["K1rr"] > 0,
            f"helmholtz program: {prog_count}")
    out.append({"label": "helmholtz program 256", "rows": rows, "launches": prog_count})
    return out


def np_split(u, kh2, alpha=0.0):
    """The split-complex Helmholtz operator on a (2, N, N) stack, numpy."""
    import numpy as np

    ur, ui = u[0], u[1]
    return np.stack([np_stencil(ur) - kh2 * (ur - alpha * ui),
                     np_stencil(ui) - kh2 * (alpha * ur + ui)])


def csl_rows(gt_torch, dev):
    """The helmholtz program's CSL route through the public functions, as
    the program configures it: GMRES(120) (MGSR, certified on the true
    residual) and GCRO-DR(k 20, 120) on the split (2, N, N) system at
    CSL_SPLIT_N² with float32 cycles and float64 certification; then
    complex128 MGSR GMRES(60) with the complex cycle at CSL_COMPLEX_N²
    (plain torch: no kernel). Residuals ‖b − A x‖/‖b‖ in numpy."""
    import numpy as np
    import torch

    out = []
    n = CSL_SPLIT_N
    kh2 = HELM_FACTOR * gt_torch.helmholtz_lambda_min(n, 0.0)
    op = gt_torch.helmholtz_split_operator(n, kh2)
    m_inv = gt_torch.csl_multigrid_preconditioner(n, kh2, layout="split")
    x_star = np.stack([np.ones((n, n)), np.zeros((n, n))])
    b_np = np_split(x_star, kh2)
    b = gt_torch.as_tensor(b_np, dev)
    m, k = CSL_SPLIT_RESTART, CSL_DEFLATE
    max_restarts = 50_000 // m
    for key, name in (("csl_split512", "gmres"), ("csl_split512_gcrodr", "gcrodr")):
        label = f"{name} csl split {n}x{n} (f32 cycles, f64 certified)"
        if name == "gmres":
            def solve(A, M, max_restarts=max_restarts):
                return gt_torch.gmres(A, b, x0=torch.zeros_like(b), restart=m,
                                      tol=HELM_TOL, M=M, variant="mgsr", certify="true",
                                      compute_v_err=False, inner_dtype=torch.float32,
                                      max_restarts=max_restarts)
        else:
            def solve(A, M, max_restarts=max_restarts):
                return gt_torch.gcrodr(A, b, x0=torch.zeros_like(b),
                                       recycle=torch.zeros((k,) + tuple(b.shape),
                                                           dtype=b.dtype, device=dev),
                                       k=k, restart=m, tol=HELM_TOL, M=M,
                                       inner_dtype=torch.float32,
                                       max_restarts=max_restarts)
        # A whole solve takes seconds (~1000 eager kernels an iteration, 102
        # of them K1 in an M): the warm-up is one restart cycle.
        res, times, count, calls, per, med = family_run(
            label, solve, {"A": (op, b), "M": (m_inv, b.float())},
            repeats=CSL_SPLIT_REPEATS, phase="phase 19",
            warm=lambda A, M, solve=solve: solve(A, M, max_restarts=1))
        x_np = res.x.detach().cpu().numpy()
        r_np = b_np - np_split(x_np, kh2)
        if name == "gmres":  # certified on the true residual
            err, norm = float(np.linalg.norm(r_np) / np.linalg.norm(b_np)), "‖b − A x‖/‖b‖"
        else:  # GCRO-DR applies M on the left and certifies ‖M r‖/‖M b‖
            mr, mb = (m_inv(torch.as_tensor(v, device=dev)) for v in (r_np, b_np))
            err = float(torch.linalg.norm(mr) / torch.linalg.norm(mb))
            norm = "‖M(b − A x)‖/‖M b‖"
        total_inner = (res.restarts - 1) * m + res.iterations
        short_print(label, res, err, norm, med, count=count, phase="phase 19")
        jax_row = JAX_PHASE19[key][0]
        print(f"phase 19: {label}: {res.restarts} cycles, total inner (gmres_tpu's "
              f"count) {total_inner} against {jax_row[3]}; K1 per M {per['M']['K1']}, "
              f"per A {per['A']['K1']}", flush=True)
        require(res.status == 0 and err < HELM_TOL, f"{label}: {res.status}, {err:.3e}")
        p19_counts(f"{label} total inner", total_inner, jax_row[3], CSL_SPLIT_BAND)
        out.append(family_record(label, res, times, count, calls, per, err,
                                 total_inner=total_inner))
    n = CSL_COMPLEX_N
    kh2 = HELM_FACTOR * gt_torch.helmholtz_lambda_min(n, 0.0)
    op = gt_torch.helmholtz_operator(n, kh2)
    m_inv = gt_torch.csl_multigrid_preconditioner(n, kh2)
    b_np = np_helmholtz(np.ones((n, n), dtype=np.complex128), kh2)
    b = torch.as_tensor(b_np, device=dev)
    m = CSL_COMPLEX_RESTART
    label = f"gmres csl complex128 {n}x{n}"

    def solve(A, M):
        return gt_torch.gmres(A, b, x0=torch.zeros_like(b), restart=m, tol=HELM_TOL, M=M,
                              variant="mgsr", certify="true", compute_v_err=False,
                              max_restarts=50_000 // m)

    res, times, count, calls, per, med = family_run(
        label, solve, {"A": (op, b), "M": (m_inv, b)}, repeats=PHASE19_REPEATS,
        phase="phase 19", needs_k1=False)
    x_np = res.x.detach().cpu().numpy()
    err = float(np.linalg.norm(b_np - np_helmholtz(x_np, kh2)) / np.linalg.norm(b_np))
    total_inner = (res.restarts - 1) * m + res.iterations
    cycle_kernels = device_events(lambda: m_inv(b))
    short_print(label, res, err, "‖b − A x‖/‖b‖", med, count=count, phase="phase 19")
    print(f"phase 19: {label}: total inner {total_inner} against gmres_tpu's "
          f"{JAX_PHASE19['csl_complex256'][0][3]}; one complex CSL cycle runs "
          f"{cycle_kernels} kernels on the device (plain torch)", flush=True)
    require(res.status == 0 and err < HELM_TOL, f"{label}: {res.status}, {err:.3e}")
    require(all(v == 0 for v in count.values()), f"{label}: launched {count}")
    p19_counts(f"{label} total inner", total_inner, JAX_PHASE19["csl_complex256"][0][3], 2)
    # The CSL family's profiled solve: this row's (a split solve takes 5–10 s).
    prof = profile_solve(lambda: solve(op, m_inv), label, med)
    out.append(family_record(label, res, times, count, calls, per, err,
                             total_inner=total_inner, cycle_kernels=cycle_kernels,
                             profile=prof))
    return out


def sequence_rows(gt_torch, dev, workdir):
    """The sequence program at its defaults (128², GCRO-DR fresh and warm
    over kh2 factors 10, 10.5, 11), b from numpy seed 0; each row's x
    checked in numpy against its operator."""
    import numpy as np

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.solvers import gcrodr as gcrodr_module

    rule_counters(reset=True)
    with solutions_of(gcrodr_module, "gcrodr") as xs:
        rows = program_rows(cli, ["sequence"], workdir, phase="phase 19")
    count = rule_counters()
    n = SEQUENCE_N
    b_np = np.random.default_rng(0).standard_normal((n, n))
    lam_min = gt_torch.helmholtz_lambda_min(n)
    refs = JAX_PHASE19["sequence"]
    require(len(rows) == len(refs), f"sequence: {len(rows)} rows, gmres_tpu {len(refs)}")
    for r, x_np, ref in zip(rows, row_solutions(xs, rows, "sequence"), refs):
        kh2 = r["kh2_factor"] * lam_min
        err = float(np.linalg.norm(b_np - np_helmholtz(x_np, kh2)) / np.linalg.norm(b_np))
        total = (r["restarts"], r["iterations"])
        print(f"phase 19: {r['name']} factor {r['kh2_factor']}: (cycles, last) {total} "
              f"against gmres_tpu's ({ref[2]}, {ref[1]}); numpy ‖b − A x‖/‖b‖ {err:.4e}; "
              f"host syncs {r['host_syncs']}", flush=True)
        require(r["name"] == ref[0] and r["kh2_factor"] == ref[3] and err < r["tol"],
                f"{r['name']}: {err:.3e}")
        p19_counts(f"{r['name']} {r['kh2_factor']} cycles", r["restarts"], ref[2],
                   SEQUENCE_BAND)
    require(count["K1"] > 0, f"sequence: {count}")
    return [{"label": "sequence program 128", "rows": rows, "launches": count}]


def np_bratu(u, lam):
    import numpy as np

    n = u.shape[0]
    h = 1.0 / (n + 1)
    return np_stencil(u) - lam * h * h * np.exp(u)


def bratu_rows(gt_torch, dev, workdir):
    """The bratu program at its 256² default, then newton_krylov with the
    Poisson V-cycle at BRATU_N², float64 and with float32 inner bases: Newton
    steps, inner iterations, J·v products, and K1 launches per J·v (two: the
    primal and the tangent, torch.func.jvp re-evaluating F). ‖F(x)‖ in
    numpy."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli

    out = []
    rule_counters(reset=True)
    rows = program_rows(cli, ["bratu", "--nsize", str(BRATU_PROGRAM_N)], workdir,
                        phase="phase 19")
    count = rule_counters()
    ref = JAX_PHASE19["bratu256"][0]
    p19_counts("bratu program newton steps", rows[0]["newton_steps"], ref[3], 2)
    p19_counts("bratu program inner iterations", rows[0]["inner_iterations"], ref[4], 2)
    require(rows[0]["residual"] < rows[0]["tol"], f"bratu program: {rows}")
    out.append({"label": "bratu program 256", "rows": rows, "launches": count})
    n = BRATU_N
    F = gt_torch.bratu_residual(n, 5.0)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    x0 = torch.zeros((n, n), dtype=torch.float64, device=dev)
    v = torch.ones_like(x0)
    before = rule_counters()
    torch.func.jvp(F, (x0,), (v,))
    torch.cuda.synchronize()
    per_jv = {k: vv - before[k] for k, vv in rule_counters().items()}
    require(per_jv["K1"] == 2 and per_jv["K1 tangent"] == 1, f"K1 per J·v {per_jv}")
    for key, inner in (("bratu1024", None), ("bratu1024_mixed", torch.float32)):
        label = f"newton_krylov bratu mg {n}x{n} {'mixed' if inner else 'f64'}"
        calls = {"F": 0, "M": 0}
        Fc, Mc = counted(F, calls, "F"), counted(m_inv, calls, "M")

        def solve():
            return gt_torch.newton_krylov(Fc, x0, tol=BRATU_TOL, M=Mc, inner_dtype=inner,
                                          max_newton=30)

        res, times, count, med = phase19_run(label, solve)
        solves = PHASE19_REPEATS + 1
        jv = res.jv_products * solves
        err = float(np.linalg.norm(np_bratu(res.x.detach().cpu().numpy(), 5.0)))
        print(f"phase 19: {label}: status {res.status}, {res.iterations} Newton steps, "
              f"{res.inner_iterations} inner iterations, {res.jv_products} J·v, "
              f"{res.host_syncs} host syncs, ‖F(x)‖ {float(res.residual):.4e} (numpy "
              f"{err:.4e}); median {1e3 * med:.3f} ms a solve; K1 launches per J·v "
              f"{per_jv['K1']} (primal + tangent); F calls {calls['F'] // solves} a solve "
              f"(each J·v calls F once), M {calls['M'] // solves}", flush=True)
        require(res.status == 0 and err < BRATU_TOL, f"{label}: {res.status}, {err:.3e}")
        # Every F call is one K1 launch; every J·v adds its tangent launch.
        require(count["K1"] == calls["F"] + jv and count["K1 tangent"] == jv,
                f"{label}: K1 {count['K1']}, F {calls['F']}, J·v {jv}")
        ref = JAX_PHASE19[key][0]
        p19_counts(f"{label} newton steps", res.iterations, ref[3], 2)
        p19_counts(f"{label} inner iterations", res.inner_iterations, ref[4],
                   2 if inner is None else NEWTON_F32_BAND)
        prof = profile_solve(solve, label, med) if inner is None else None
        out.append(family_record(label, res, times, count, calls, {"J·v": per_jv}, err,
                                 jv_products=res.jv_products,
                                 inner_iterations=res.inner_iterations, profile=prof))
    return out


def tapped_transposes():
    """Within the block, every transpose the solvers derive
    (solvers/requests.py:derived_transpose, which qmr, lsqr and lsmr reach
    through requests.transposed) counts its calls: [setups, pullbacks]."""
    from gmres_tpu_torch.solvers import requests

    calls = [0, 0]
    inner = requests.derived_transpose

    def tapped(op, like):
        calls[0] += 1
        apply_t = inner(op, like)

        def counted_t(u):
            calls[1] += 1
            return apply_t(u)
        return counted_t

    @contextlib.contextmanager
    def block():
        requests.derived_transpose = tapped
        try:
            yield calls
        finally:
            requests.derived_transpose = inner
    return block()


def transpose_rows(gt_torch, dev, workdir):
    """QMR on convdiff QMR_N² with the multigrid cycle as M and its
    transpose=True cycle as MT (Aᵀ derived through K1), the convdiff
    program's qmr rows at QMR_PROGRAM_N² and at its default grid capped, and
    LSQR and LSMR on the convdiff operator at LSQ_N² with the derived
    adjoint. K1 launches: one per
    application of A (the vjp's primal included) and one per pullback."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs

    out = []
    gamma = (0.4, 0.2)
    coefs = convection_diffusion_coefs(*gamma)
    n = QMR_N
    op = gt_torch.convection_diffusion_operator(n, *gamma)
    m_inv = gt_torch.convection_diffusion_multigrid_preconditioner(n, *gamma)
    mt = gt_torch.convection_diffusion_multigrid_preconditioner(n, *gamma, transpose=True)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    b = gt_torch.as_tensor(b_np, dev)
    per_m = per_application(m_inv, b)
    per_mt = per_application(mt, b)
    label = f"qmr mg+MT convdiff {n}x{n}"
    calls = {"A": 0, "M": 0, "MT": 0}
    Ac, Mc, MTc = (counted(f, calls, key) for f, key in ((op, "A"), (m_inv, "M"),
                                                         (mt, "MT")))
    with tapped_transposes() as tcalls:
        res, times, count, med = phase19_run(
            label, lambda: gt_torch.qmr(Ac, b, tol=1e-9, M=Mc, MT=MTc))
    solves = PHASE19_REPEATS + 1
    r_np = b_np - np_stencil_general(res.x.detach().cpu().numpy(), coefs)
    err = float(torch.linalg.norm(m_inv(torch.as_tensor(r_np, device=dev))))
    it = res.iterations
    print(f"phase 19: {label}: status {res.status}, {it} iterations, {res.host_syncs} "
          f"host syncs, certified ‖M(b − A x)‖ {float(res.residual):.4e}, numpy r through "
          f"M {err:.4e} (plain ‖b − A x‖ {np.linalg.norm(r_np):.4e}); median "
          f"{1e3 * med:.3f} ms; a solve: A {calls['A'] // solves}, Aᵀ pullbacks "
          f"{tcalls[1] // solves} (derived {tcalls[0] // solves}), M {calls['M'] // solves}, "
          f"MT {calls['MT'] // solves}; K1 launches a solve {count['K1'] // solves} = "
          f"{count['K1'] / solves / max(it, 1):.3f} an iteration", flush=True)
    require(res.status == 0 and err < 1e-9, f"{label}: {res.status}, {err:.3e}")
    require(count["K1"] == calls["A"] + tcalls[1]
            and count["K1 transpose"] == tcalls[1],
            f"{label}: K1 {count}, A {calls['A']}, pullbacks {tcalls[1]}")
    require(all(count[k] == calls["M"] * per_m[k] + calls["MT"] * per_mt[k]
                for k in ("K1rr", "K1cr", "K2")), f"{label}: cycle launches {count}")
    p19_counts(f"{label} iterations", it, JAX_PHASE19["qmr_mg1024"][0], 2)
    prof = profile_solve(lambda: gt_torch.qmr(op, b, tol=1e-9, M=m_inv, MT=mt), label, med)
    out.append(family_record(label, res, times, count, dict(calls, AT=tcalls[1]),
                             {"M": per_m, "MT": per_mt}, err, profile=prof))
    rule_counters(reset=True)
    rows = program_rows(cli, ["convdiff", "--nsize", str(QMR_PROGRAM_N), "--solver", "qmr"],
                        workdir, phase="phase 19")
    count = rule_counters()
    ref = JAX_PHASE19["convdiff_qmr32"][0]
    p19_counts(f"{rows[0]['name']} program iterations", rows[0]["iterations"], ref[1], 2)
    per_it = count["K1"] / 2 / max(rows[0]["iterations"], 1)
    print(f"phase 19: {rows[0]['name']}: K1 launches {count['K1']} over the warm-up and "
          f"timed solve ({count['K1 transpose']} transposes) = {per_it:.3f} an iteration",
          flush=True)
    out.append({"label": "convdiff qmr program 32", "rows": rows, "launches": count})
    rule_counters(reset=True)
    rows = program_rows(cli, ["convdiff", "--solver", "qmr", "--max-iterations",
                              str(QMR_PROGRAM_CAP)], workdir, phase="phase 19", status=1)
    count = rule_counters()
    ref = JAX_PHASE19["convdiff_qmr256_cap"][0]
    row = rows[0]
    rel = abs(row["residual"] - ref[3]) / ref[3]
    print(f"phase 19: {row['name']} (default grid, --max-iterations {QMR_PROGRAM_CAP}): "
          f"{row['iterations']} iterations, residual {row['residual']:.6e} against gmres_tpu's "
          f"{ref[1]} at {ref[3]:.6e} (rel {rel:.2e}, tol 1e-6); wall {row['wall_s']:.4f} s; "
          f"K1 launches {count['K1']} over the warm-up and timed solve "
          f"({count['K1 transpose']} transposes) = "
          f"{count['K1'] / 2 / max(row['iterations'], 1):.3f} an iteration", flush=True)
    require(row["name"] == ref[0] and row["iterations"] == ref[1] and rel < 1e-6,
            f"{row['name']}: {row['iterations']} iterations, residual {row['residual']}")
    require(count["K1 transpose"] > 0, f"{row['name']}: {count}")
    out.append({"label": f"convdiff qmr program {QMR_PROGRAM_DEFAULT_N} capped", "rows": rows,
                "launches": count})
    n = LSQ_N
    op = gt_torch.convection_diffusion_operator(n, *gamma)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    b = gt_torch.as_tensor(b_np, dev)
    for name in ("lsqr", "lsmr"):
        label = f"{name} convdiff {n}x{n}"
        calls = {"A": 0}
        Ac = counted(op, calls, "A")
        fn = getattr(gt_torch, name)
        with tapped_transposes() as tcalls:
            res, times, count, med = phase19_run(
                label, lambda: fn(Ac, b, tol=1e-9), repeats=LSQ_REPEATS,
                warmup=lambda: fn(Ac, b, tol=1e-9, max_iterations=LSQ_WARMUP))
        x_np = res.x.detach().cpu().numpy()
        r_np = b_np - np_stencil_general(x_np, coefs)
        err = float(np.linalg.norm(r_np))
        grad = float(np.linalg.norm(np_stencil_general(r_np, np_transpose_coefs(coefs))))
        short_print(label, res, err, "‖b − A x‖", med, phase="phase 19")
        steps = LSQ_WARMUP + LSQ_REPEATS * res.iterations
        print(f"phase 19: {label}: numpy ‖Aᵀ(b − A x)‖ {grad:.4e}; over a {LSQ_WARMUP}-step "
              f"warm-up and {LSQ_REPEATS} solve: A {calls['A']}, pullbacks {tcalls[1]}, "
              f"K1 {count['K1']} ({count['K1 transpose']} transposes) = "
              f"{count['K1'] / steps:.3f} a step", flush=True)
        require(res.status == 0 and (err < 1e-9 or grad < 1e-9), f"{label}: {err}, {grad}")
        require(count["K1"] == calls["A"] + tcalls[1], f"{label}: {count}, {calls}, {tcalls}")
        p19_counts(f"{label} iterations", res.iterations, JAX_PHASE19[f"{name}{LSQ_N}"][0], 2)
        prof = profile_solve(
            lambda: fn(op, b, tol=1e-9, max_iterations=LSQ_WARMUP),
            f"{label} (its first {LSQ_WARMUP} steps)",
            med * LSQ_WARMUP / res.iterations) if name == "lsqr" else None
        out.append(family_record(label, res, times, count, dict(calls, AT=tcalls[1]), {},
                                 err, gradient_norm=grad, profile=prof))
    return out


def implicit_row(gt_torch, dev):
    """implicit_solve's γ-gradient on the card at IMPLICIT_N²: the loss
    Σ(x(γ) − target)² with A(γ) the convdiff operator (γ a tensor, so K1's
    coefficient rule carries the θ pullback), GMRES(30) to 1e-12 with the
    cycle at γ₀ (forward) and its transpose (adjoint) as M; the gradient
    against central differences (ε = 1e-6) of the same loss on the card."""
    import functools

    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply

    n = IMPLICIT_N
    rng = np.random.default_rng(2)
    b = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    target = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
    g0 = 0.35
    m_f = gt_torch.convection_diffusion_multigrid_preconditioner(n, g0, 0.2)
    m_t = gt_torch.convection_diffusion_multigrid_preconditioner(n, g0, 0.2, transpose=True)
    fwd = functools.partial(gt_torch.gmres, restart=30, tol=1e-12, max_restarts=200,
                            compute_v_err=False, M=m_f)
    adj = functools.partial(gt_torch.gmres, restart=30, tol=1e-12, max_restarts=200,
                            compute_v_err=False, M=m_t)

    def a_fn(gm):
        return lambda v: convection_diffusion_apply(v, gm, 0.2)

    def loss(gm):
        x = gt_torch.implicit_solve(a_fn, gm, b, solver=fwd, adjoint_solver=adj)
        return torch.sum((x - target) ** 2)

    def grad():
        gm = torch.tensor(g0, dtype=torch.float64, device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(loss(gm), gm)
        return float(g)

    rule_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = grad()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = rule_counters()
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.tensor(g0 + eps, dtype=torch.float64, device=dev)))
              - float(loss(torch.tensor(g0 - eps, dtype=torch.float64, device=dev)))) / (2 * eps)
    rel = abs(g - fd) / abs(fd)
    print(f"phase 19: implicit_solve γ-gradient {n}x{n}: {g:.10e}, central differences "
          f"{fd:.10e}, rel {rel:.3e} (tol 1e-5); one forward + adjoint {wall:.4f} s; "
          f"launches {count}", flush=True)
    require(rel < 1e-5, f"implicit_solve gradient {g} against {fd}")
    require(count["K1 transpose"] > 0 and count["K2"] > 0, f"implicit: {count}")
    return [{"label": f"implicit_solve gamma gradient {n}x{n}", "gradient": g, "fd": fd,
             "rel": rel, "wall_s": wall, "launches": count}]


def phase_transpose(gt_torch, rng, dev, workdir):
    """Phase 19: K1's rules on the card, then Helmholtz, the CSL routes, the
    sequence program, Newton-Krylov on Bratu, QMR, LSQR and LSMR, and
    implicit_solve. Returns the launches over the phase and the rows."""
    t_phase = time.perf_counter()
    rules, launches = k1_rules(gt_torch, rng, dev)
    rows = []
    rows += helmholtz_rows(gt_torch, dev, workdir)
    rows += csl_rows(gt_torch, dev)
    rows += sequence_rows(gt_torch, dev, workdir)
    rows += bratu_rows(gt_torch, dev, workdir)
    rows += transpose_rows(gt_torch, dev, workdir)
    rows += implicit_row(gt_torch, dev)
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] += v
    seconds = time.perf_counter() - t_phase
    print(f"phase 19: {seconds:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, rules + rows


def p20_run(label, solve, repeats=PHASE20_REPEATS, warmup=None):
    """A warm-up (`warmup`, a shorter run of the same solver where given,
    else the solve), then `repeats` timed solves with the launch counts set
    to 0 just before them and read just after; returns the last result, the
    times, the counts over the timed solves and the median."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (warmup or solve)()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    mg_counters(reset=True)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    count = mg_counters()
    print(f"phase 20: {label}: wall s over {repeats}: {quartiles(times)} (warm-up "
          f"{t_warm:.4f}); launches per solve "
          + ", ".join(f"{k} {count[k] / repeats:g}" for k in KERNELS) + "; K2 by path "
          + ", ".join(f"{p} {count[f'K2 {p}'] / repeats:g}" for p in ("cluster", "tiled", "sweep")),
          flush=True)
    return res, times, count, float(np.median(times))


def p20_profile(solve, label, med):
    """profile_solve for a result without a residual field."""
    import types

    return profile_solve(lambda: (solve(), types.SimpleNamespace(residual=0.0))[1], label, med)


def p20_record(label, res, times, count, **extra):
    return {"label": label, "status": int(getattr(res, "status", 0)), "times": times,
            "launches": count,
            "launches_per_solve": {k: count[k] / PHASE20_REPEATS for k in KERNELS},
            "host_syncs": getattr(res, "host_syncs", None), **extra}


def p20_counts(label, got, jax, band):
    """family_counts for phase 20 (a band below 1 is a share of gmres_tpu's
    count, at least 2)."""
    if band < 1:
        band = max(2, int(band * jax))
    family_counts(label, got, jax, band, phase="phase 20")


def poisson_smallest(n, k):
    """The k smallest eigenvalues of the n² Dirichlet Poisson stencil."""
    import numpy as np

    c = 2.0 - 2.0 * np.cos(np.arange(1, k + 2) * np.pi / (n + 1))
    return np.sort((c[:, None] + c[None, :]).ravel())[:k]


def lobpcg_rows(gt_torch, dev):
    """The eig program's LOBPCG (Poisson, the V-cycle as M, float64, k = 4,
    its start block) at 256² (tol 1e-8) and at 1024² (tol 0 and the rtol of
    scripts/jax_phase20_counts.py): eigenvalues within 1e-6 relative of the
    closed form, each pair's residual recomputed in numpy under its
    threshold, one profiled solve."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli

    out = []
    for key, n, tol, rtol in (("lobpcg256", 256, 1e-8, 0.0),
                              ("lobpcg1024", LOBPCG_BIG_N, 0.0, JAX_PHASE20["lobpcg1024"][0])):
        op = gt_torch.poisson_operator(n)
        m_inv = gt_torch.poisson_multigrid_preconditioner(n)
        x0 = cli._program_normal((EIG_K, n, n), torch.float64, dev)
        label = f"eig lobpcg poisson {n}x{n} mg k {EIG_K} tol {tol:g} rtol {rtol:g}"

        def solve(op=op, m_inv=m_inv, x0=x0, tol=tol, rtol=rtol):
            return gt_torch.lobpcg(op, x0, tol=tol, rtol=rtol, max_iterations=200, M=m_inv)

        res, times, count, med = p20_run(label, solve)
        lam = res.eigenvalues.cpu().numpy()
        x = res.x.detach().cpu().numpy()
        np_res = np.array([np.linalg.norm(np_stencil(x[i]) - lam[i] * x[i])
                           for i in range(EIG_K)])
        thresh = np.maximum(tol, rtol * np.abs(lam))
        err = float(np.max(np.abs(np.sort(lam) - poisson_smallest(n, EIG_K))))
        jax_it = JAX_PHASE20[key][1]
        print(f"phase 20: {label}: status {res.status}, {res.iterations} iterations "
              f"(gmres_tpu {jax_it}), host syncs {res.host_syncs}, numpy residuals "
              f"{np.array2string(np_res, precision=3)} under "
              f"{np.array2string(thresh, precision=3)}, max |λ − closed form| {err:.3e}",
              flush=True)
        require(res.status == 0 and np.all(np_res < thresh)
                and err < 1e-6 * float(np.max(np.abs(lam))),
                f"{label}: status {res.status}, {np_res}, {err}")
        p20_counts(f"{label} iterations", res.iterations, jax_it, LOBPCG_BAND)
        require(all(count[k] > 0 for k in KERNELS), f"{label}: launches {count}")
        prof = p20_profile(solve, label, med)
        out.append(p20_record(label, res, times, count, iterations=res.iterations,
                              numpy_residuals=np_res.tolist(), eig_error=err, profile=prof))
    return out


def np_complex_apply(x, coefs):
    """A real stencil on a complex grid, part by part, in numpy."""
    import numpy as np

    return (np_stencil_general(np.ascontiguousarray(x.real), coefs)
            + 1j * np_stencil_general(np.ascontiguousarray(x.imag), coefs))


def krylov_schur_rows(gt_torch, dev):
    """The eig program's Krylov–Schur (complex basis), Krylov–Schur on a real
    Schur basis and subspace iteration on convection-diffusion 256², k = 4,
    steps 40, tol 1e-8, at most 200 cycles (the program's defaults and
    start), at two γ:

    * (2, 0.5), the program's default: the timed, host-bound rows. The
      operator is D T D⁻¹ with T symmetric and κ(D) ≈ 10^122, so its
      eigenvalues are not computable in float64: Ritz pairs with small
      residuals sit on the pseudospectrum, neither package converges in 200
      cycles, and where each ends is set by rounding (held to the cap and
      to gmres_tpu's status only).
    * EIG_MILD_GAMMA, κ(D) ≈ 2·10³: eigenvalues within κ(D)·tol ≈ 2e-5 of
      the closed form once converged. Both Krylov–Schur bases converge:
      status 0, each numpy residual under tol, eigenvalues within 1e-6
      relative (8e-6) of the closed form, cycles within EIG_BANDS of
      gmres_tpu's. Subspace iteration's fixed 200 iterations cannot converge
      on this top spectrum (|λ₁₁/λ₄| ≈ 1 − 1.9e-4): its eigenvalues are held
      to the CPU port's on the same start block within 1e-10 relative, and
      to the closed form within SUBSPACE_MILD_ERROR.

    Each pair's residual is recomputed in numpy against the reported one.
    The operator's real applications are counted: on the complex basis 2 a
    complex matvec, one K1 launch each."""
    return (eig_cd_rows(gt_torch, dev, EIG_GAMMA, "", profile=True)
            + eig_cd_rows(gt_torch, dev, EIG_MILD_GAMMA, "_mild", profile=False))


def eig_cd_rows(gt_torch, dev, g, suffix, profile):
    """krylov_schur_rows at one γ (JAX_PHASE20 keys with ``suffix``)."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.convection_diffusion import (
        convection_diffusion_coefs,
        convection_diffusion_eigenvalues,
    )

    n, steps, tol = EIG_CD_N, EIG_STEPS, 1e-8
    coefs = convection_diffusion_coefs(*g)
    op = gt_torch.convection_diffusion_operator(n, *g)
    exact = convection_diffusion_eigenvalues(n, *g)
    exact = cli._keyed(exact[np.argsort(-np.abs(exact))][:EIG_K])
    out = []
    for key, method in (("arnoldi256", "arnoldi"), ("ksreal256", "ks_real"),
                        ("subspace256", "subspace")):
        key += suffix
        calls = {"A": 0}
        a_counted = counted(op, calls, "A")
        if method == "subspace":
            probe = torch.ones((n, n), dtype=torch.float64, device=dev)

            def solve(a=a_counted, probe=probe, max_restarts=None):
                return gt_torch.subspace_eigs(a, probe, nev=EIG_K, guard=6, iters=200, tol=tol)
        else:
            fn = gt_torch.arnoldi_eigs if method == "arnoldi" else gt_torch.arnoldi_eigs_real
            probe = cli._program_normal((n, n), torch.float64, dev)

            def solve(a=a_counted, probe=probe, fn=fn, max_restarts=200):
                return fn(a, probe, nev=EIG_K, steps=steps, which="LM", tol=tol,
                          max_restarts=max_restarts)

        label = f"eig {method} convdiff {n}x{n} gamma {g} k {EIG_K} steps {steps}"
        # The warm-up applies the uncounted operator; for Krylov–Schur it is
        # 2 cycles (nothing is compiled, and a full solve takes seconds).
        res, times, count, med = p20_run(
            label, solve, warmup=lambda: solve(a=op, max_restarts=2))
        applications = calls["A"] // PHASE20_REPEATS
        lam = res.eigenvalues.cpu().numpy()
        x = res.x.detach().cpu().numpy()
        np_res = np.array([np.linalg.norm(np_complex_apply(x[i], coefs) - lam[i] * x[i])
                           for i in range(EIG_K)])
        reported = res.residuals.cpu().numpy()
        err = float(np.max(np.abs(cli._keyed(lam) - exact)))
        jrow = JAX_PHASE20[key][0]
        print(f"phase 20: {label}: status {res.status}, {res.iterations} iterations "
              f"(gmres_tpu {jrow['iterations']}, converged {jrow['converged']}), host syncs "
              f"{res.host_syncs}, real applications of A a solve {applications}, numpy "
              f"residuals {np.array2string(np_res, precision=3)} (reported "
              f"{np.array2string(reported, precision=3)}), max |λ − closed form| {err:.3e} "
              f"(gmres_tpu {jrow['linf_error']:.3e})", flush=True)
        require(np.all(np.abs(np_res - reported) <= 1e-10 + 1e-8 * reported),
                f"{label}: numpy residuals {np_res} against {reported}")
        if jrow["converged"]:
            require(res.status == 0 and np.all(np_res < tol)
                    and err < 1e-6 * np.max(np.abs(exact)),
                    f"{label}: status {res.status}, {np_res}, {err}")
        else:  # gmres_tpu ends at its cap too: held to its status
            require(res.status == 1, f"{label}: status {res.status}")
        p20_counts(f"{label} iterations", res.iterations, jrow["iterations"], EIG_BANDS[method])
        require(count["K1"] == PHASE20_REPEATS * applications and count["K2"] == 0,
                f"{label}: launches {count}, applications {calls}")
        extra = {}
        if method == "subspace" and suffix:
            cpu = gt_torch.subspace_eigs(gt_torch.convection_diffusion_operator(n, *g),
                                         probe.cpu(), nev=EIG_K, guard=6, iters=200, tol=tol)
            lam_cpu = cpu.eigenvalues.numpy()
            gap = float(np.max(np.abs(cli._keyed(lam) - cli._keyed(lam_cpu))))
            print(f"phase 20: {label}: max |λ − the CPU port's| {gap:.3e}; max |λ − closed "
                  f"form| {err:.3e} held to {SUBSPACE_MILD_ERROR:g}", flush=True)
            require(gap < 1e-10 * float(np.max(np.abs(lam_cpu))) and err < SUBSPACE_MILD_ERROR,
                    f"{label}: {gap} from the CPU port, {err} from the closed form")
            extra["cpu_port_gap"] = gap
        if method == "arnoldi":
            # The cycles' matvecs one vector each; the certification's EIG_K
            # in one block application (row_apply's vmap).
            k = min(max(EIG_K + 1, 2 * EIG_K), steps - 2)
            matvecs = steps + (res.iterations - 1) * (steps - k) + EIG_K
            print(f"phase 20: {label}: {matvecs} complex matvecs a solve ({EIG_K} of them "
                  f"one block application), {applications} real applications, "
                  f"{count['K1'] / PHASE20_REPEATS:g} K1 launches", flush=True)
            require(applications == 2 * (matvecs - EIG_K + 1),
                    f"{label}: not 2 K1 per complex matvec or block application")
            extra["complex_matvecs"] = matvecs
        if method != "subspace" and profile:
            capped = min(res.iterations, PROFILE_CYCLES)
            extra["profile_cycles"] = capped
            extra["profile"] = p20_profile(lambda: solve(max_restarts=capped),
                                           f"{label}, {capped} cycles", med)
        out.append(p20_record(label, res, times, count, iterations=res.iterations,
                              numpy_residuals=np_res.tolist(), eig_error=err,
                              applications=applications, **extra))
    return out


def slq_rows(gt_torch, dev):
    """trace_funm(log) on Poisson 512² with 8, 16 and 32 probes, 40 steps
    (the slq program's defaults; probes from a torch Generator seeded 0):
    the log-det against the closed-form sum within 3 standard errors; the
    probes batched (one K1 launch a step, one host read)."""
    import numpy as np
    import torch

    n = SLQ_N
    c = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    exact = float(np.sum(np.log(c[:, None] + c[None, :])))
    op = gt_torch.poisson_operator(n)
    x_like = torch.zeros((n, n), dtype=torch.float64, device=dev)
    out = []
    for p, jrow in zip(SLQ_PROBES, JAX_PHASE20["slq512"]):
        label = f"slq logdet poisson {n}x{n} probes {p} steps {SLQ_STEPS}"
        res, times, count, med = p20_run(label, lambda p=p: gt_torch.trace_funm(
            op, torch.log, x_like, n_probes=p, steps=SLQ_STEPS, key=0))
        value, stderr = float(res.value), float(res.stderr)
        print(f"phase 20: {label}: {value:.6f} ± {stderr:.6f} against the closed form "
              f"{exact:.6f} (gap {(value - exact) / stderr:+.2f} stderr; gmres_tpu's probes "
              f"{jrow['value']:.6f} ± {jrow['stderr']:.6f}), host syncs {res.host_syncs}",
              flush=True)
        require(abs(value - exact) < 3 * stderr, f"{label}: {value} ± {stderr}, {exact}")
        # The probes batched (gmres_tpu's jax.vmap): one K1 launch an Arnoldi
        # step for all probes, one host read of their Hessenbergs.
        require(count["K1"] == count["K1 batched"] == PHASE20_REPEATS * SLQ_STEPS
                and res.host_syncs == 1, f"{label}: launches {count}, {res.host_syncs} reads")
        out.append(p20_record(label, res, times, count, value=value, stderr=stderr,
                              closed_form=exact))
    return out


def evolve_rows(gt_torch, dev):
    """The evolve program's trajectories at 256², 50 steps, through its own
    setup (cli.evolve_problem): convection-diffusion with GCRO-DR steps
    (recycling across steps), the same with the σ-shifted cycle, and the heat
    equation by exponential Euler. The θ-method's last timed run keeps its
    trajectory, and each step's ‖rhs − S u⁺‖/‖rhs‖ (GCRO-DR's relative
    residual without M) is recomputed in numpy; exponential Euler is held to
    the exact solution by the sine transform."""
    import argparse

    import numpy as np

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs

    n = EVOLVE_N
    defaults = dict(nsize=n, dt=1.0, steps=EVOLVE_STEPS, theta=0.5, model="convdiff",
                    gamma_x=2.0, gamma_y=1.0, solver="gcrodr", tol=1e-9, restart=40, k=10,
                    max_restarts=100, max_iterations=2000, expm_steps=30, precond="none")
    out = []
    for key, over in (("evolve256", {}), ("evolve256_mg", {"precond": "mg"}),
                      ("evolve256_expm", {"model": "heat", "solver": "expm"})):
        args = argparse.Namespace(**{**defaults, **over})
        _, u0, solve = cli.evolve_problem(args, dev)
        # The warm-up is a 2-step trajectory; the timed ones keep their states
        # (50 references, stacked once at the end) for the numpy check.
        _, _, warm = cli.evolve_problem(argparse.Namespace(**{**vars(args), "steps": 2}), dev)
        label = (f"evolve {args.model} {args.solver} {n}x{n} {args.steps} steps precond "
                 f"{args.precond}")
        res, times, count, med = p20_run(label, lambda: solve(save_trajectory=True),
                                         warmup=warm)
        jrow = JAX_PHASE20[key][0]
        u0_np = u0.cpu().numpy()
        if args.solver == "expm":
            s = np.sqrt(2.0 / (n + 1)) * np.sin(
                np.outer(np.arange(1, n + 1), np.arange(1, n + 1)) * np.pi / (n + 1))
            c = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
            exact = s @ ((s @ u0_np @ s)
                         * np.exp(-args.dt * args.steps * (c[:, None] + c[None, :]))) @ s
            err = float(np.linalg.norm(res.u.cpu().numpy() - exact) / np.linalg.norm(exact))
            est = float(res.error_estimates.max())
            print(f"phase 20: {label}: relative error against the sine-transform solution "
                  f"{err:.3e}; max Saad estimate {est:.3e} (gmres_tpu {jrow['residual']:.3e}); "
                  f"host syncs {res.host_syncs}", flush=True)
            require(err < EXPM_ERROR, f"{label}: error {err}")
            require(count["K1"] == PHASE20_REPEATS * args.steps * args.expm_steps,
                    f"{label}: launches {count}")
            out.append(p20_record(label, res, times, count, error=err, estimate=est))
            continue
        coefs = convection_diffusion_coefs(args.gamma_x, args.gamma_y)
        traj = res.trajectory.cpu().numpy()
        step_c = args.theta * args.dt
        ratios = []
        prev = u0_np
        for u in traj:
            rhs = prev - (1.0 - args.theta) * args.dt * np_stencil_general(prev.copy(), coefs)
            s_of = lambda v: v + step_c * np_stencil_general(v.copy(), coefs)  # noqa: E731
            ratios.append(np.linalg.norm(rhs - s_of(u)) / np.linalg.norm(rhs))
            prev = u
        worst_np = float(max(ratios))
        worst = float(res.residuals.max())
        print(f"phase 20: {label}: status {res.status}, inner iterations {res.inner_total} "
              f"(gmres_tpu {jrow['iterations']}), step 0 {int(res.iterations[0])} (gmres_tpu "
              f"{jrow['iters_step0']}), last {int(res.iterations[-1])} (gmres_tpu "
              f"{jrow['iters_last']}), worst step residual {worst:.3e} (numpy, unpreconditioned, "
              f"‖rhs − S u‖/‖rhs‖: {worst_np:.3e}), host syncs "
              f"{res.host_syncs}", flush=True)
        limit = args.tol * 1.01 if args.precond == "none" else EVOLVE_MG_NUMPY
        require(res.status == 0 and worst < args.tol and worst_np < limit,
                f"{label}: {res.status}, {worst}, {worst_np}")
        p20_counts(f"{label} inner iterations", res.inner_total, jrow["iterations"],
                   EVOLVE_BAND)
        require(count["K1"] > 0 and (count["K2"] > 0) == (args.precond == "mg"),
                f"{label}: launches {count}")
        out.append(p20_record(label, res, times, count, inner_total=res.inner_total,
                              worst_step_residual=worst, worst_numpy_ratio=worst_np))
    return out


def np_csr_convdiff(n, coefs):
    """(data, indices, indptr) of the 5-point matrix with these coefficients
    (C-order flattening: west/east along a row, south/north across rows)."""
    import numpy as np

    c0, cw, ce, cs, cn = coefs
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cols, vals = [], []
    for di, dj, c in ((-1, 0, cs), (0, -1, cw), (0, 0, c0), (0, 1, ce), (1, 0, cn)):
        ok = (i + di >= 0) & (i + di < n) & (j + dj >= 0) & (j + dj < n)
        cols.append(np.where(ok, (i + di) * n + (j + dj), -1).ravel())
        vals.append(np.full(n * n, c))
    cols, vals = np.stack(cols, 1), np.stack(vals, 1)
    keep = cols >= 0
    indptr = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int32)
    return vals[keep], cols[keep].astype(np.int32), indptr


def preconditioner_rows(gt_torch, dev):
    """The Nyström preconditioner (rank 64, its own sketch) under CG on
    Poisson 512², b = A·1, tol 1e-9 absolute; SPAI from the convection-
    diffusion CSR matrix at 128² under BiCGSTAB on the stencil, b = A·1, tol
    1e-9: counts against gmres_tpu's, residuals recomputed in numpy, the
    setup timed apart."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs

    out = []
    n = NYSTROM_N
    op = gt_torch.poisson_operator(n)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    mg_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_nys, lam = gt_torch.nystrom_preconditioner(op, torch.zeros_like(b), rank=NYSTROM_RANK)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    setup_count = mg_counters()
    label = f"cg nystrom rank {NYSTROM_RANK} poisson {n}x{n}"
    res, times, count, med = p20_run(label, lambda: gt_torch.cg(op, b, tol=1e-9, M=m_nys))
    err = float(np.linalg.norm(b_np - np_stencil(res.x.cpu().numpy())))
    jrow = JAX_PHASE20["nystrom512"]
    print(f"phase 20: {label}: setup {setup:.4f} s ({setup_count['K1']} K1 launches: the "
          f"sketch's {2 * NYSTROM_RANK} matvecs, two block applications), λ̂ [{float(lam[-1]):.4e}, {float(lam[0]):.4e}] (gmres_tpu "
          f"[{jrow['lam_min']:.4e}, {jrow['lam_max']:.4e}]); status {res.status}, "
          f"{res.iterations} iterations (gmres_tpu {jrow['iterations']}, unpreconditioned "
          f"{jrow['plain_iterations']}), numpy ‖b − A x‖ {err:.3e}, host syncs "
          f"{res.host_syncs}", flush=True)
    require(res.status == 0 and err < 1e-9 * 1.01, f"{label}: {res.status}, {err}")
    require(setup_count["K1"] == setup_count["K1 batched"] == 2,
            f"{label}: setup launches {setup_count}")
    # CG's count cannot tell this M from the identity (its λ̂ all lie near 6:
    # P⁻¹ moves a vector by ~1%), so the sketch and the application are held
    # apart: λ̂'s ends to gmres_tpu's within NYSTROM_LAM_BAND (other sketches
    # of the same operator), and M(r) − r for a fixed r to the CPU port's,
    # built on the same sketch, within 1e-10 relative.
    lam_np = lam.cpu().numpy()
    ends = np.array([lam_np[-1], lam_np[0]])
    jends = np.array([jrow["lam_min"], jrow["lam_max"]])
    m_cpu, lam_cpu = gt_torch.nystrom_preconditioner(
        gt_torch.poisson_operator(n), torch.zeros((n, n), dtype=torch.float64),
        rank=NYSTROM_RANK)
    r_np = np.random.default_rng(20).standard_normal((n, n))
    dm = (m_nys(gt_torch.as_tensor(r_np, dev)).cpu().numpy() - r_np)
    dm_cpu = m_cpu(torch.as_tensor(r_np)).numpy() - r_np
    lam_gap = float(np.max(np.abs(lam_np - lam_cpu.numpy())) / lam_np[0])
    apply_gap = float(np.linalg.norm(dm - dm_cpu) / np.linalg.norm(dm_cpu))
    print(f"phase 20: {label}: λ̂ ends {np.array2string(ends, precision=6)} against "
          f"gmres_tpu's {np.array2string(jends, precision=6)} (held to "
          f"{NYSTROM_LAM_BAND:g} relative); ‖M r − r‖/‖r‖ {np.linalg.norm(dm) / np.linalg.norm(r_np):.3e}; "
          f"card against the CPU port on the same sketch: λ̂ {lam_gap:.3e}, M r − r "
          f"{apply_gap:.3e} relative", flush=True)
    require(np.all(np.abs(ends - jends) <= NYSTROM_LAM_BAND * jends),
            f"{label}: λ̂ ends {ends}, gmres_tpu {jends}")
    require(lam_gap < 1e-10 and apply_gap < 1e-10,
            f"{label}: card against CPU: λ̂ {lam_gap}, M r − r {apply_gap}")
    p20_counts(f"{label} iterations", res.iterations, jrow["iterations"], PRECOND_BAND)
    out.append(p20_record(label, res, times, count, iterations=res.iterations,
                          numpy_residual=err, setup_s=setup, lam_ends=ends.tolist(),
                          cpu_lam_gap=lam_gap, cpu_apply_gap=apply_gap))

    n, g = SPAI_N, (0.4, 0.2)
    coefs = convection_diffusion_coefs(*g)
    data, indices, indptr = np_csr_convdiff(n, coefs)
    csr = gt_torch.sparse_from_numpy("csr", {"data": data, "indices": indices,
                                             "indptr": indptr}, (n * n, n * n), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_spai = gt_torch.spai_preconditioner(csr)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    op = gt_torch.convection_diffusion_operator(n, *g)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    b = gt_torch.as_tensor(b_np, dev)
    label = f"bicgstab spai convdiff {n}x{n}"
    res, times, count, med = p20_run(label, lambda: gt_torch.bicgstab(op, b, tol=1e-9, M=m_spai))
    err = float(np.linalg.norm(b_np - np_stencil_general(res.x.cpu().numpy(), coefs)))
    jrow = JAX_PHASE20["spai128"]
    print(f"phase 20: {label}: setup {setup:.4f} s; status {res.status}, {res.iterations} "
          f"iterations (gmres_tpu {jrow['iterations']}, unpreconditioned "
          f"{jrow['plain_iterations']}), numpy ‖b − A x‖ {err:.3e}, host syncs "
          f"{res.host_syncs}", flush=True)
    require(res.status == 0 and err < 1e-9 * 1.01, f"{label}: {res.status}, {err}")
    require(count["K1"] > 0, f"{label}: launches {count}")
    p20_counts(f"{label} iterations", res.iterations, jrow["iterations"], PRECOND_BAND)
    out.append(p20_record(label, res, times, count, iterations=res.iterations,
                          numpy_residual=err, setup_s=setup))
    return out


def spectral_programs(gt_torch, dev, workdir):
    """The eig program (LOBPCG and both Krylov–Schur bases) and the evolve
    program at 64² on the card (each row converged)."""
    from gmres_tpu_torch.benchmarks import cli

    mg_counters(reset=True)
    rows = []
    for argv in (["eig", "--nsize", "64"], ["eig", "--nsize", "64", "--method", "arnoldi"],
                 ["eig", "--nsize", "64", "--method", "ks_real"],
                 ["evolve", "--nsize", "64", "--steps", "5"]):
        rows += program_rows(cli, argv, workdir, phase="phase 20")
    count = mg_counters()
    require(count["K1"] > 0 and count["K2"] > 0, f"phase 20 programs: launches {count}")
    return [{"label": "eig and evolve programs 64", "rows": rows, "launches": count}]


def phase_spectral(gt_torch, dev, workdir):
    """Phase 20: the eigensolvers, matrix functions, time steppers and the
    Nyström and SPAI preconditioners. Returns the launches over the rows and
    the rows."""
    t_phase = time.perf_counter()
    rows = []
    rows += lobpcg_rows(gt_torch, dev)
    rows += krylov_schur_rows(gt_torch, dev)
    rows += slq_rows(gt_torch, dev)
    rows += evolve_rows(gt_torch, dev)
    rows += preconditioner_rows(gt_torch, dev)
    rows += spectral_programs(gt_torch, dev, workdir)
    launches = dict.fromkeys(mg_counters(), 0)
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] += v
    seconds = time.perf_counter() - t_phase
    print(f"phase 20: {seconds:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 21: the distributed solve on a one-rank mesh.
# ---------------------------------------------------------------------------


def p21_counters(reset: bool = False) -> dict:
    """mg_counters plus K5's launches, K1's launches through its halo form
    (counted where they launch, and also in "K1") and the halo route's
    exchanges (set to 0 first where `reset`). Each exchange is followed by
    one K1 halo launch or one K5 launch."""
    from gmres_tpu_torch.ops import fused, stencil
    from gmres_tpu_torch.parallel.halo import halo_exchange

    if reset:
        fused.cheb2_cuda.launches = 0
        stencil.stencil_5pt_pallas_halo.launches = 0
        halo_exchange.exchanges = 0
    out = mg_counters(reset)
    out["K5"] = fused.cheb2_cuda.launches
    out["K1 halo"] = stencil.stencil_5pt_pallas_halo.launches
    out["exchanges"] = halo_exchange.exchanges
    return out


def whole(x):
    """The whole grid of a row-sharded DTensor (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def counts_of(res) -> tuple:
    """(iterations, restarts or None, status) of a result."""
    return (res.iterations, getattr(res, "restarts", None), res.status)


def comm_counts(comm) -> dict:
    """A CommDebugMode's collectives by kind: all-gathers, all-reduces and
    any other."""
    out = {"all_gather": 0, "all_reduce": 0, "other": 0}
    for op, n in comm.get_comm_counts().items():
        name = str(op)
        kind = ("all_gather" if "allgather" in name or "all_gather" in name
                else "all_reduce" if "all_reduce" in name or "allreduce" in name
                else "other")
        out[kind] += n
    return out


def cycle_gathers(m_inv) -> int:
    """All-gathers an application of a mesh= cycle: one where a level is
    replicated, none otherwise."""
    return int(m_inv.replicate_from < m_inv.levels)


def sharded_row(label, make, m_inv, plain, residual, *, needs=(), phase=21, status=0,
                bound=None, k1_per_exchange=1, band=0, gathers_per_m=0,
                twin_timed=False, profile=True):
    """One row of phase 21 or 22. `make(M, short)` returns the solve on the
    sharded b with preconditioner M (`m_inv`, or None), capped where `short`
    (a few iterations, one restart cycle or one Newton step; a row whose
    solve is short enough ignores it). `plain()` runs the twin on plain
    tensors (mesh=None, K1's full-grid route) and returns its result or its
    counts; its launches are read around it and kept apart from the row's
    ("plain_count"); with `twin_timed` it is warmed up first and its wall
    kept. Then a warm-up and the phase's repeats of the solve, with the
    launch counts set to 0 just before and read just after, and the capped
    solve under CommDebugMode (which slows a solve 3-8x) with M's
    applications counted. Held:

    * the counts equal the twin's (iterations within `band`, the band
      PERF.md §2 names for the solver), status `status`;
    * each exchange not followed by K5 followed by `k1_per_exchange` launches
      of K1's halo form (1 on the real 5-point forms, 2 on the split stack, 0
      where the form is plain torch), each counted where it launches, and at
      least one exchange;
    * `gathers_per_m` all-gathers an M application (`cycle_gathers` for a
      mesh= cycle; None: not held), and no collective but all-gathers and
      all-reduces;
    * `residual(res)`, the numpy float64 true residual, under `bound`, or
      without one no worse than twice the twin's (float64 rows, whose two
      runs differ in rounding only);
    * every kernel in `needs` launched, and K1 launched in the twin where
      the row needs K1's halo form.

    Where `profile`, the capped solve is profiled for the device's busy
    share (its trace of a DTensor solve costs ~10 s a row)."""
    import numpy as np
    from torch.distributed.tensor.debug import CommDebugMode

    tag = f"phase {phase} {label}"
    repeats = PHASE22_REPEATS if phase == 22 else PHASE21_REPEATS
    t_plain = None
    if twin_timed:
        plain()
    p21_counters(reset=True)
    if twin_timed:
        plain_res, t_plain = timed(plain)
    else:
        plain_res = plain()
    plain_counts = plain_res if isinstance(plain_res, tuple) else counts_of(plain_res)
    plain_launches = p21_counters()
    solve = make(m_inv, False)
    _, t_warm = timed(solve)
    p21_counters(reset=True)
    times = []
    for _ in range(repeats):
        res, t = timed(solve)
        times.append(t)
    count = p21_counters()
    require(count["K1 halo"] == k1_per_exchange * (count["exchanges"] - count["K5"])
            and count["K1 halo"] <= count["K1"] and count["exchanges"] > 0,
            f"{tag}: {count['K1 halo']} K1 halo-form launches of {count['K1']} K1 "
            f"launches, {count['exchanges']} exchanges, {count['K5']} K5 launches "
            f"({k1_per_exchange} K1 halo launches an exchange not followed by K5 expected)")
    per = {k: v / repeats for k, v in count.items()}
    launches = {"K1 halo": per["K1 halo"], "K1 full grid": per["K1"] - per["K1 halo"],
                "K1rr": per["K1rr"], "K1cr": per["K1cr"], "K2": per["K2"],
                "K5": per["K5"]}
    got = counts_of(res)
    require(got[1:] == plain_counts[1:] and abs(got[0] - plain_counts[0]) <= band,
            f"{tag}: counts {got}, twin on plain tensors {plain_counts} (band {band})")
    require(got[2] == status, f"{tag}: status {got[2]}")
    calls = {"M": 0}
    with CommDebugMode() as comm:
        timed(make(counted(m_inv, calls, "M") if m_inv is not None else None, True))
    comms = comm_counts(comm)
    gathers_per_cycle = comms["all_gather"] / calls["M"] if calls["M"] else 0.0
    require(comms["other"] == 0 and (gathers_per_m is None
                                     or comms["all_gather"] == gathers_per_m * calls["M"]),
            f"{tag}: collectives {comms} over {calls['M']} M applications "
            f"({gathers_per_m} all-gathers an application expected)")
    rel = residual(res)
    rel_plain = None if isinstance(plain_res, tuple) else residual(plain_res)
    require(rel <= (bound if bound is not None else 2 * rel_plain + 1e-15),
            f"{tag}: numpy true residual {rel:.4e}, twin's {rel_plain}, bound {bound}")
    med = float(np.median(times))
    busy = None
    if profile:
        prof = profile_solve(make(m_inv, True), tag, med)
        busy = prof["busy_ms"] / prof["wall_ms"]
    twin_wall = "" if t_plain is None else f", its wall {t_plain:.4f} s"
    print(f"phase {phase}: {label}: counts (iterations, restarts, status) {got}, twin on "
          f"plain tensors {plain_counts} (its launches {plain_launches}{twin_wall}); "
          f"{res.host_syncs} host syncs; wall s over {repeats}: {quartiles(times)} "
          f"(warm-up {t_warm:.4f}); launches a solve {launches}, {per['exchanges']:g} "
          f"exchanges; {comms['all_gather']} all-gathers over {calls['M']} M "
          f"applications ({gathers_per_cycle:g} an application), {comms['all_reduce']} "
          f"all-reduces in the capped solve; numpy float64 true residual {rel:.4e} (twin "
          f"{'-' if rel_plain is None else f'{rel_plain:.4e}'}); device busy "
          f"{'not profiled' if busy is None else f'{100 * busy:.1f}%'} (the capped "
          f"solve's profiled wall)", flush=True)
    for k in needs:
        require(launches[k] > 0, f"{tag}: {k} was not launched")
    if "K1 halo" in needs:
        require(plain_launches["K1"] > 0, f"{tag}: the twin launched no K1")
    return {"label": label, "counts": got, "plain_counts": plain_counts,
            "plain_count": plain_launches, "median_s": med, "warm_s": t_warm,
            "plain_s": t_plain, "host_syncs": res.host_syncs, "launches": launches,
            "exchanges": per["exchanges"], "gathers_per_cycle": gathers_per_cycle,
            "m_applications": calls["M"], "all_reduces": comms["all_reduce"],
            "true_rel": rel, "twin_true_rel": rel_plain,
            "busy": busy, "count": count}


def p21_mg_rows(gt_torch, dev):
    """Rows (a) and (b): the mg configuration (Householder GMRES(10), float32
    cycles certified on the float64 true residual) with the halo operator
    and the mesh= Poisson cycle, at 300² (replicate_below 160: the 150² and
    75² levels whole on the rank) and 2048² (replicate_below 300)."""
    import numpy as np
    import torch

    mesh = gt_torch.solver_mesh(1)
    rows = []
    for label, n, below in P21_MG_ROWS:
        b_np = np_stencil(np.ones((n, n)))
        b = gt_torch.as_tensor(b_np, dev)
        b_sh = gt_torch.shard_grid_vector(b, mesh)
        op = gt_torch.halo_poisson_operator(mesh)

        def make(m, short, op=op, b_sh=b_sh):
            return lambda: gt_torch.gmres(op, b_sh, restart=10, tol=TOL, M=m,
                                          compute_v_err=False, inner_dtype=torch.float32,
                                          certify="true")

        def plain(n=n, b=b):
            return gt_torch.gmres(gt_torch.poisson_operator(n), b, restart=10, tol=TOL,
                                  M=gt_torch.poisson_multigrid_preconditioner(n),
                                  compute_v_err=False, inner_dtype=torch.float32,
                                  certify="true")

        m_inv = gt_torch.poisson_multigrid_preconditioner(n, mesh=mesh, replicate_below=below)
        rows.append(sharded_row(
            label, make, m_inv, plain,
            lambda res, b_np=b_np: true_rel(b_np, whole(res.x)),
            needs=("K1 halo", "K1rr", "K1cr", "K2"), bound=TOL,
            gathers_per_m=cycle_gathers(m_inv)))
    return rows


def p21_cbpr2_row(gt_torch, dev):
    """Row (c): Householder GMRES(50) with the fused halo cbpr2 (K5) at
    304², float64, tol P21_CBPR2_TOL; mesh=None on plain tensors is the same K5 on
    the whole grid. The profile and the CommDebugMode solve cover two restart
    cycles."""
    import numpy as np

    mesh = gt_torch.solver_mesh(1)
    n = STRONG_N
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    op = gt_torch.halo_poisson_operator(mesh)
    cbpr2 = gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG)

    def make(_, short):
        return lambda: gt_torch.gmres(op, b_sh, restart=STRONG_M, tol=P21_CBPR2_TOL,
                                      M=cbpr2, max_restarts=2 if short else 1000,
                                      compute_v_err=False)

    def plain():
        return gt_torch.gmres(gt_torch.poisson_operator(n), b, restart=STRONG_M,
                              tol=P21_CBPR2_TOL, M=cbpr2, compute_v_err=False)

    return [sharded_row(f"(c) householder cbpr2 {n}", make, None, plain,
                        lambda res: true_rel(b_np, whole(res.x)), needs=("K1 halo", "K5"),
                        bound=P21_CBPR2_TOL / cbpr2_min_eigenvalue(n))]


def p21_model_rows(gt_torch, dev):
    """Rows (d), (e) and (h): BiCGSTAB with the mesh= convection–diffusion
    cycle (float32, smoother "auto") at 1024² (BASELINE config 3; its true
    residual certified under CG_TOL), MINRES on Helmholtz 1024² (kh2 = 10
    λ_min) with the mesh= SPD cycle, and GCRO-DR(40, k 10) on
    convection–diffusion 512² with its mesh= cycle (these two certify a
    preconditioned norm: held to their mesh=None runs), each cycle
    replicating from P21_REPLICATE_BELOW rows."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs
    from gmres_tpu_torch.models.helmholtz import helmholtz_coefs

    mesh = gt_torch.solver_mesh(1)
    below = P21_REPLICATE_BELOW
    cd = convection_diffusion_coefs(0.4, 0.2)
    kh2 = 10 * gt_torch.helmholtz_lambda_min(P21_MODEL_N["(e)"])
    rows = []
    cases = (
        ("(d) bicgstab convdiff mixed auto", P21_MODEL_N["(d)"], cd,
         lambda n: gt_torch.convection_diffusion_operator(n, 0.4, 0.2),
         lambda n, **kw: gt_torch.convection_diffusion_multigrid_preconditioner(
             n, 0.4, 0.2, smoother="auto", internal_dtype=torch.float32, **kw),
         lambda op, b, m: gt_torch.bicgstab(op, b, tol=CG_TOL, M=m), "abs", CG_TOL),
        ("(e) minres helmholtz", P21_MODEL_N["(e)"], helmholtz_coefs(kh2),
         lambda n: gt_torch.helmholtz_operator(n, kh2),
         lambda n, **kw: gt_torch.helmholtz_shifted_laplacian_preconditioner(n, kh2, **kw),
         lambda op, b, m: gt_torch.minres(op, b, tol=CG_TOL, M=m), "abs", None),
        ("(h) gcrodr convdiff", P21_MODEL_N["(h)"], cd,
         lambda n: gt_torch.convection_diffusion_operator(n, 0.4, 0.2),
         lambda n, **kw: gt_torch.convection_diffusion_multigrid_preconditioner(
             n, 0.4, 0.2, **kw),
         lambda op, b, m: gt_torch.gcrodr(op, b, k=10, restart=40, tol=CG_TOL, M=m), "rel",
         None),
    )
    for label, n, coefs, plain_op, cycle, solver, norm, bound in cases:
        label = f"{label} {n}"
        b_np = np_stencil_general(np.ones((n, n)), coefs)
        b = gt_torch.as_tensor(b_np, dev)
        b_sh = gt_torch.shard_grid_vector(b, mesh)
        op = gt_torch.halo_stencil_operator(mesh, coefs)
        def plain(n=n, b=b, plain_op=plain_op, cycle=cycle, solver=solver):
            return solver(plain_op(n), b, cycle(n))

        def residual(res, b_np=b_np, coefs=coefs, norm=norm):
            x = whole(res.x).cpu().numpy().astype(np.float64)
            r = float(np.linalg.norm(b_np - np_stencil_general(x, coefs)))
            return r / float(np.linalg.norm(b_np)) if norm == "rel" else r

        m_inv = cycle(n, mesh=mesh, replicate_below=below)
        rows.append(sharded_row(
            label,
            lambda m, short, op=op, b_sh=b_sh, solver=solver: (lambda: solver(op, b_sh, m)),
            m_inv, plain, residual, needs=("K1 halo", "K1rr", "K1cr", "K2"), bound=bound,
            gathers_per_m=cycle_gathers(m_inv)))
    return rows


def p21_lsqr_row(gt_torch, dev):
    """Row (f): LSQR on the 512² halo operator, Aᵀ through the halo
    operator's transpose rule (the repair), against LSQR on the plain
    operator (K1's full-grid rules): both stop at P21_LSQR_CAP steps (tol
    1e-8 needs ~κ(A) ≈ 10⁵), their residuals within 1e-10 relative."""
    import numpy as np

    from gmres_tpu_torch.parallel.halo import HaloStencil

    mesh = gt_torch.solver_mesh(1)
    n = P21_LSQR_N
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    op = gt_torch.halo_poisson_operator(mesh)

    def make(_, short):
        return lambda: gt_torch.lsqr(op, b_sh, tol=TOL,
                                     max_iterations=50 if short else P21_LSQR_CAP)

    plains = []

    def plain():
        plains.append(gt_torch.lsqr(gt_torch.poisson_operator(n), b, tol=TOL,
                                    max_iterations=P21_LSQR_CAP))
        return plains[-1]

    row = sharded_row(f"(f) lsqr halo {n}", make, None, plain,
                      lambda res: true_rel(b_np, whole(res.x)), needs=("K1 halo",), status=1)
    before = HaloStencil.rule_applications["transpose"]
    res, (plain,) = make(None, False)(), plains
    transposes = HaloStencil.rule_applications["transpose"] - before
    gap = abs(float(res.residual) - float(plain.residual)) / float(plain.residual)
    print(f"phase 21: (f) lsqr: residual {float(res.residual):.6e} (plain operator "
          f"{float(plain.residual):.6e}, {gap:.2e} apart); {transposes} transpose-rule "
          f"applications in one solve of {res.iterations} steps", flush=True)
    require(gap <= 1e-10, f"phase 21 (f): residuals {gap:.2e} apart")
    require(transposes >= res.iterations,
            f"phase 21 (f): {transposes} transposes in {res.iterations} steps")
    return [row]


def p21_weak_scaling_row(gt_torch, dev, workdir):
    """Row (g): the ``weak-scaling --precond mg`` program at d = 1 (128², its
    default; MGSR GMRES(50), tol 1e-12; the mesh=None cycle at d = 1, as in
    gmres_tpu), then the same solve with the mesh= cycle (replicating
    the levels below n/2 rows: 32² and 16² at 128²) on the sharded b, whose
    counts must be the program's."""
    import numpy as np

    from gmres_tpu_torch.benchmarks import cli

    n = P21_WEAK_N
    rows = []

    def program():
        rows.extend(program_rows(cli, P21_WEAK_SCALING + ["--nsize-per-device", str(n)],
                                 workdir, phase="phase 21"))
        return (rows[0]["iterations"], rows[0]["restarts"], rows[0]["status"])

    mesh = gt_torch.solver_mesh(1)
    b_np = np_stencil(np.ones((n, n)))
    b_sh = gt_torch.shard_grid_vector(gt_torch.as_tensor(b_np, dev), mesh)
    op = gt_torch.halo_poisson_operator(mesh)

    def make(m, short):
        return lambda: gt_torch.gmres(op, b_sh, restart=50, tol=1e-12, M=m,
                                      variant="mgsr", max_restarts=1000,
                                      compute_v_err=False)

    m_inv = gt_torch.poisson_multigrid_preconditioner(n, mesh=mesh, replicate_below=n // 2)
    out = sharded_row(f"(g) weak-scaling mg {n} mesh=", make, m_inv, program,
                      lambda res: true_rel(b_np, whole(res.x)),
                      needs=("K1 halo", "K1rr", "K1cr", "K2"), bound=1e-10,
                      gathers_per_m=cycle_gathers(m_inv))
    out["program"] = {k: rows[0][k] for k in ("name", "iterations", "restarts", "wall_s")}
    return [out]


def phase_distributed(gt_torch, dev, workdir):
    """Phase 21: the distributed solve on the one-rank NCCL group (made by
    the caller): rows (a)-(h). Returns the launches over the rows' timed
    solves, those over their mesh=None twins, and the rows."""
    t_phase = time.perf_counter()
    rows = []
    rows += p21_mg_rows(gt_torch, dev)
    rows += p21_cbpr2_row(gt_torch, dev)
    rows += p21_model_rows(gt_torch, dev)
    rows += p21_lsqr_row(gt_torch, dev)
    rows += p21_weak_scaling_row(gt_torch, dev, workdir)
    rows.sort(key=lambda r: r["label"])
    launches, twins = ({k: sum(r[key][k] for r in rows) for k in rows[0][key]}
                       for key in ("count", "plain_count"))
    seconds = time.perf_counter() - t_phase
    print(f"phase 21: {seconds:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + "; over their mesh=None twins: "
          + ", ".join(f"{k} {v}" for k, v in twins.items()), flush=True)
    return launches, twins, rows


PHASE22_REPEATS = 1
P22_CSL_N = 256               # rows (a), (b): the complex and split CSL
P22_CSL_BELOW = 128           # their mesh= cycles: 256² sharded, 128² and below whole
P22_3D_BELOW = 64             # row (c): 128³ and 64³ sharded, 32³ and below whole
P22_NEWTON_BELOW = P21_REPLICATE_BELOW
P22_IMPLICIT_N = 512
P22_SHORT = 4                 # iterations of a row's capped solve under CommDebugMode
# sharded_row's arguments for a phase-22 row (its profiles would double the phase).
P22 = {"phase": 22, "twin_timed": True, "profile": False}


def p22_cap(short, default=None) -> dict:
    """The capped solve's ``max_iterations`` (P22_SHORT), or the row's own
    (the solver's default where None)."""
    if short:
        return {"max_iterations": P22_SHORT}
    return {} if default is None else {"max_iterations": default}


def p22_rel(b_np, apply_np):
    """The numpy float64 relative true residual of a result on the card."""
    import numpy as np

    def residual(res):
        x = whole(res.x).detach().cpu().numpy().astype(b_np.dtype)
        return float(np.linalg.norm(b_np - apply_np(x)) / np.linalg.norm(b_np))

    return residual


def p22_csl_rows(gt_torch, dev, mesh):
    """Rows (a) and (b): MGSR GMRES(60) on the complex Helmholtz operator
    with the complex CSL mesh= cycle at P22_CSL_N² (complex128; the complex
    halo forms are plain torch), and GMRES(120) on the split (2, N, N) stack,
    sharded [Shard(1)], with the split mesh= cycle in float32 (the Arnoldi
    basis float32, certified on the float64 true residual): each exchange of
    the split stack is followed by two K1 halo-form launches."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    n = P22_CSL_N
    kh2 = HELM_FACTOR * gt_torch.helmholtz_lambda_min(n, 0.0)
    rows = []
    b_np = np_helmholtz(np.ones((n, n), dtype=np.complex128), kh2)
    b = torch.as_tensor(b_np, device=dev)
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    op = gt_torch.helmholtz_operator(n, kh2)
    m = CSL_COMPLEX_RESTART

    def solve(rhs, M, short=False):
        return gt_torch.gmres(op, rhs, restart=m, tol=HELM_TOL, M=M, variant="mgsr",
                              certify="true", compute_v_err=False,
                              max_restarts=1 if short else 50_000 // m)

    m_inv = gt_torch.csl_multigrid_preconditioner(n, kh2, mesh=mesh,
                                                  replicate_below=P22_CSL_BELOW)
    rows.append(sharded_row(
        f"(a) gmres csl complex128 {n}x{n} mesh=",
        lambda M, short: lambda: solve(b_sh, M, short), m_inv,
        lambda: solve(b, gt_torch.csl_multigrid_preconditioner(n, kh2)),
        p22_rel(b_np, lambda x: np_helmholtz(x, kh2)), bound=HELM_TOL, k1_per_exchange=0,
        gathers_per_m=cycle_gathers(m_inv), **P22))

    x_star = np.stack([np.ones((n, n)), np.zeros((n, n))])
    b_np = np_split(x_star, kh2)
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = distribute_tensor(b, mesh, [Shard(1)])
    op = gt_torch.helmholtz_split_operator(n, kh2)
    m = CSL_SPLIT_RESTART

    def solve_split(rhs, M, short=False):
        return gt_torch.gmres(op, rhs, restart=m, tol=HELM_TOL, M=M, variant="mgsr",
                              certify="true", compute_v_err=False, inner_dtype=torch.float32,
                              max_restarts=1 if short else 50_000 // m)

    m_inv = gt_torch.csl_multigrid_preconditioner(n, kh2, layout="split", mesh=mesh,
                                                  replicate_below=P22_CSL_BELOW)
    rows.append(sharded_row(
        f"(b) gmres csl split {n}x{n} f32 cycles f64 certified mesh=",
        lambda M, short: lambda: solve_split(b_sh, M, short), m_inv,
        lambda: solve_split(b, gt_torch.csl_multigrid_preconditioner(n, kh2, layout="split")),
        p22_rel(b_np, lambda x: np_split(x, kh2)), bound=HELM_TOL, k1_per_exchange=2,
        needs=("K1 halo",), gathers_per_m=cycle_gathers(m_inv), **P22))
    return rows


def p22_model_rows(gt_torch, dev, mesh):
    """Rows (c), (d) and (e): CG with the 3-D mesh= cycle at POISSON3D_N³
    (float64, tol 1e-8 absolute; b sharded along its first axis, the 7-point
    halo form plain torch), CG with the line anisotropic cycle at ANISO_N²,
    ε ANISO_EPS (its mesh=None cycle on the sharded b: the operator K1's halo
    form, the line solves on the rank's rows, DTensor's own all-gathers at
    the restrictions), and CG with mg+defl on the varcoef model at
    VARCOEF_N², contrast VARCOEF_CONTRAST (the varcoef program's setup; its
    faces plain torch)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.anisotropic import anisotropic_coefs

    rows = []
    n = POISSON3D_N
    b_np = np_stencil7(np.ones((n, n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = distribute_tensor(b, mesh, [Shard(0)])
    op = gt_torch.poisson3d_operator(n)
    tol = 1e-8
    m_inv = gt_torch.poisson3d_multigrid_preconditioner(n, mesh=mesh,
                                                        replicate_below=P22_3D_BELOW)
    rows.append(sharded_row(
        f"(c) cg poisson3d mg {n}^3 mesh=",
        lambda M, short: lambda: gt_torch.cg(op, b_sh, tol=tol, M=M, **p22_cap(short)),
        m_inv,
        lambda: gt_torch.cg(op, b, tol=tol, M=gt_torch.poisson3d_multigrid_preconditioner(n)),
        p22_rel(b_np, np_stencil7), bound=tol / float(np.linalg.norm(b_np)),
        k1_per_exchange=0, gathers_per_m=cycle_gathers(m_inv), **P22))

    n, eps = ANISO_N, ANISO_EPS
    coefs = anisotropic_coefs(eps)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    op = gt_torch.anisotropic_operator(n, eps)
    m_inv = gt_torch.anisotropic_multigrid_preconditioner(n, eps)
    rows.append(sharded_row(
        f"(d) cg anisotropic line mg {n}x{n} eps {eps:g}",
        lambda M, short: lambda: gt_torch.cg(op, b_sh, tol=1e-8, M=M, **p22_cap(short)),
        m_inv,
        lambda: gt_torch.cg(op, b, tol=1e-8, M=m_inv),
        p22_rel(b_np, lambda x: np_stencil_general(x, coefs)),
        bound=1e-8 / float(np.linalg.norm(b_np)), needs=("K1 halo",), gathers_per_m=None,
        **P22))

    n = VARCOEF_N
    c, op, _, b, diag, w = cli.varcoef_problem(n, VARCOEF_CONTRAST, dev)
    m_inv = cli.varcoef_preconditioners(c, op, diag, w)["mg+defl"]
    b_np = b.detach().cpu().numpy()
    c_np = c.cpu().numpy()
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    tol = 1e-9 * float(np.linalg.norm(b_np))
    rows.append(sharded_row(
        f"(e) cg varcoef mg+defl {n}x{n} contrast {VARCOEF_CONTRAST:g}",
        lambda M, short: lambda: gt_torch.cg(
            op, b_sh, tol=tol, M=M, **p22_cap(short, default=20_000)), m_inv,
        lambda: gt_torch.cg(op, b, tol=tol, max_iterations=20_000, M=m_inv),
        p22_rel(b_np, lambda x: np_varcoef(c_np, x)), bound=1e-9, k1_per_exchange=0,
        gathers_per_m=None, **P22))
    return rows


def p22_newton_row(gt_torch, dev, mesh):
    """Row (f): Newton–Krylov on the Bratu residual at BRATU_N², λ 5, with
    the Poisson mesh= cycle (FGMRES inner): F on the sharded u takes the
    plain operator's halo form, J·v runs on each rank's block
    (parallel/halo.py:blockwise_jvp), two K1 halo-form launches a J·v; the
    twin is the mesh=None run on plain tensors (K1's full-grid route)."""
    import numpy as np
    import torch

    n = BRATU_N
    F = gt_torch.bratu_residual(n, 5.0)
    x0 = torch.zeros((n, n), dtype=torch.float64, device=dev)
    x0_sh = gt_torch.shard_grid_vector(x0, mesh)

    def residual(res):
        u = whole(res.x).detach().cpu().numpy()
        return float(np.linalg.norm(np_bratu(u, 5.0)))

    m_inv = gt_torch.poisson_multigrid_preconditioner(n, mesh=mesh,
                                                      replicate_below=P22_NEWTON_BELOW)
    return [sharded_row(
        f"(f) newton_krylov bratu {n}x{n} mg mesh=",
        lambda M, short: lambda: gt_torch.newton_krylov(F, x0_sh, tol=BRATU_TOL, M=M,
                                                        max_newton=1 if short else 30),
        m_inv,
        lambda: gt_torch.newton_krylov(F, x0, tol=BRATU_TOL, max_newton=30,
                                       M=gt_torch.poisson_multigrid_preconditioner(n)),
        residual, bound=BRATU_TOL, needs=("K1 halo", "K1rr", "K1cr", "K2"),
        gathers_per_m=cycle_gathers(m_inv), **P22)]


def p22_preconditioner_rows(gt_torch, dev, mesh):
    """Rows (g) and (h): CG with Nyström rank NYSTROM_RANK on Poisson
    NYSTROM_N², built on the sharded x_like (the sketch's rows sharded),
    beside the twin built and solved on plain tensors; the implicit_solve
    gradients at P22_IMPLICIT_N² (x(θ) = (A + θ)⁻¹ b, CG to 1e-12, L = ½‖x‖²)
    on a sharded b against the plain b's (θ's gradient within 1e-10
    relative, b's within 1e-10 absolute); BiCGSTAB with SPAI on the
    convection–diffusion operator at SPAI_N² (one all-gather of v an SPAI
    application)."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_coefs

    rows = []
    n = NYSTROM_N
    op = gt_torch.poisson_operator(n)
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    m_sh, lam_sh = gt_torch.nystrom_preconditioner(op, torch.zeros_like(b_sh),
                                                   rank=NYSTROM_RANK)
    m_plain, lam = gt_torch.nystrom_preconditioner(op, torch.zeros_like(b), rank=NYSTROM_RANK)
    lam_gap = float(torch.max(torch.abs(lam_sh - lam)) / lam[0])
    require(lam_gap < 1e-10, f"phase 22 (g): sharded λ̂ {lam_gap:.3e} from the plain build's")
    row = sharded_row(
        f"(g) cg nystrom rank {NYSTROM_RANK} poisson {n}x{n}",
        lambda M, short: lambda: gt_torch.cg(op, b_sh, tol=1e-9, M=M, **p22_cap(short)),
        m_sh,
        lambda: gt_torch.cg(op, b, tol=1e-9, M=m_plain),
        p22_rel(b_np, np_stencil), bound=1e-9 * 1.01 / float(np.linalg.norm(b_np)),
        needs=("K1 halo",), **P22)
    row["lam_gap"] = lam_gap
    rows.append(row)

    n = P22_IMPLICIT_N
    base = gt_torch.poisson_operator(n)
    rng = np.random.default_rng(3)
    b_imp = gt_torch.as_tensor(rng.standard_normal((n, n)), dev)

    def a_fn(theta):
        return lambda v: base(v) + theta * v

    def solver(op_, rhs):
        return gt_torch.cg(op_, rhs, tol=1e-12, max_iterations=5000)

    def grads(rhs):
        theta = torch.tensor(0.7, dtype=torch.float64, device=dev, requires_grad=True)
        rhs = rhs.detach().requires_grad_()
        x = gt_torch.implicit_solve(a_fn, theta, rhs, solver=solver, symmetric=True)
        g_theta, g_b = torch.autograd.grad(0.5 * torch.sum(x * x), (theta, rhs))
        return float(g_theta), whole(g_b)

    p21_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_sh = grads(gt_torch.shard_grid_vector(b_imp, mesh))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = p21_counters()
    p21_counters(reset=True)
    g = grads(b_imp)
    plain_count = p21_counters()
    theta_gap = abs(g_sh[0] - g[0]) / abs(g[0])
    b_gap = float(torch.max(torch.abs(g_sh[1] - g[1])))
    print(f"phase 22: (h) implicit_solve gradients {n}x{n} on a sharded b: dL/dθ "
          f"{g_sh[0]:.12e} (plain b {g[0]:.12e}, {theta_gap:.2e} apart), dL/db max "
          f"{b_gap:.2e} apart; {wall:.4f} s for the forward and adjoint solves; launches "
          f"{count}", flush=True)
    require(theta_gap < 1e-10 and b_gap < 1e-10,
            f"phase 22 (h): gradients {theta_gap:.3e}, {b_gap:.3e} apart")
    require(count["K1 halo"] == count["exchanges"] > 0, f"phase 22 (h) implicit: {count}")
    rows.append({"label": f"(h) implicit_solve gradients {n}x{n}", "theta_gap": theta_gap,
                 "b_gap": b_gap, "wall_s": wall, "count": count,
                 "plain_count": plain_count})

    n, gam = SPAI_N, (0.4, 0.2)
    coefs = convection_diffusion_coefs(*gam)
    data, indices, indptr = np_csr_convdiff(n, coefs)
    csr = gt_torch.sparse_from_numpy("csr", {"data": data, "indices": indices,
                                             "indptr": indptr}, (n * n, n * n), device=dev)
    m_spai = gt_torch.spai_preconditioner(csr)
    op = gt_torch.convection_diffusion_operator(n, *gam)
    b_np = np_stencil_general(np.ones((n, n)), coefs)
    b = gt_torch.as_tensor(b_np, dev)
    b_sh = gt_torch.shard_grid_vector(b, mesh)
    rows.append(sharded_row(
        f"(h) bicgstab spai convdiff {n}x{n}",
        lambda M, short: lambda: gt_torch.bicgstab(op, b_sh, tol=1e-9, M=M,
                                                   **p22_cap(short)), m_spai,
        lambda: gt_torch.bicgstab(op, b, tol=1e-9, M=m_spai),
        p22_rel(b_np, lambda x: np_stencil_general(x, coefs)),
        bound=1e-9 * 1.01 / float(np.linalg.norm(b_np)), needs=("K1 halo",),
        gathers_per_m=1, band=2, **P22))
    return rows


def phase_models_sharded(gt_torch, dev, workdir):
    """Phase 22: the plain model operators, the CSL and 3-D mesh= cycles and
    the preconditioners and AD solvers on a row-sharded b, on the one-rank
    NCCL group (made by the caller): rows (a)-(h), each beside its twin on
    plain tensors. Returns the launches over the rows' timed solves, those
    over their twins, and the rows."""
    t_phase = time.perf_counter()
    mesh = gt_torch.solver_mesh(1)
    rows = []
    rows += p22_csl_rows(gt_torch, dev, mesh)
    rows += p22_model_rows(gt_torch, dev, mesh)
    rows += p22_newton_row(gt_torch, dev, mesh)
    rows += p22_preconditioner_rows(gt_torch, dev, mesh)
    launches, twins = ({k: sum(r[key][k] for r in rows) for k in rows[0][key]}
                       for key in ("count", "plain_count"))
    seconds = time.perf_counter() - t_phase
    print(f"phase 22: {seconds:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + "; over their twins: " + ", ".join(f"{k} {v}" for k, v in twins.items()),
          flush=True)
    return launches, twins, rows


# Phase 23: the eigensolvers, matrix functions, time steppers and mesh=None
# cycles (ROADMAP item 8.6b) and the sparse formats (item 8.7) on a sharded b,
# and the scale and spmv programs. Depth cuts: 5 time steps (phase 20: 50).
P23_EVOLVE_STEPS = 5
P23_HYB_N = 1000              # CG on a row-sharded HYB (phase 8's cg 1000²)
P23_SPMV_N = 512              # CSR, COO, ELL (the spmv program's default)
P23_DIA_N = 2048              # DIA f32 and f64 (phase 7's SpMV 2048²)
P23_BSR = (16, 128)           # block rows, block size (phase 7's BSR)
P23_SCALE_3D = ["scale", "--dim", "3", "--grids", "128"]
P23_SUBSPACE_GAP = 1e-8       # CholQR2 against LAPACK's QR, unconverged Ritz values


@contextlib.contextmanager
def counted_all_gathers(calls):
    """Count the explicit all-gathers (torch.distributed.all_gather_into_tensor:
    the cycles' gather at their first replicated level, the sparse formats'
    gather of x) into calls["all-gathers"] while the block runs. On a one-rank
    mesh DTensor elides its own collectives, so these are all there are."""
    import torch.distributed as dist

    original = dist.all_gather_into_tensor

    def gather(*args, **kwargs):
        calls["all-gathers"] += 1
        return original(*args, **kwargs)

    dist.all_gather_into_tensor = gather
    try:
        yield
    finally:
        dist.all_gather_into_tensor = original


P23_KERNELS = ("K1", "K1 halo", "K1rr", "K1cr", "K2", "K3", "K4")


def p23_counters(reset: bool = False) -> dict:
    """p21_counters plus K3's and K4's launches."""
    from gmres_tpu_torch.ops import sparse

    if reset:
        sparse.dia_spmv_cuda.launches = 0
        sparse.bsr_spmv_cuda.launches = 0
    out = p21_counters(reset)
    out["K3"] = sparse.dia_spmv_cuda.launches
    out["K4"] = sparse.bsr_spmv_cuda.launches
    return out


def p23_row(label, sharded, plain, counts, diff, bound, *, needs=(), gathers=None,
            exchanges=None, ops=None):
    """One row of phase 23: the twin `plain()` on plain tensors, then
    `sharded()` on the sharded b, each once and timed to a synchronisation,
    the launch counts set to 0 just before each and read just after (the
    twin's kept apart). `ops` names the row's counted applications
    ({name: calls dict}); the explicit all-gathers and the halo exchanges are
    read per application of the first. Held: `counts(res)` equal to the
    twin's, `diff(res, twin)` (the largest difference from the twin) under
    `bound`, every kernel in `needs` launched, and where given `gathers` and
    `exchanges` an application. Returns the row's record."""
    import torch

    tag = f"phase 23 {label}"
    for calls in (ops or {}).values():
        calls["n"] = 0
    p23_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = plain()
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    twin_count = p23_counters()
    for calls in (ops or {}).values():
        calls["n"] = 0
    calls = {"all-gathers": 0}
    p23_counters(reset=True)
    with counted_all_gathers(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded()
        torch.cuda.synchronize()
        t_row = time.perf_counter() - t0
    count = p23_counters()
    applied = {k: c["n"] for k, c in (ops or {}).items()}
    first = next(iter(applied.values()), 0) or 1
    per = {"all-gathers": calls["all-gathers"] / first, "exchanges": count["exchanges"] / first}
    got, want = counts(res), counts(twin)
    gap = float(diff(res, twin))
    print(f"phase 23: {label}: counts {got} (twin on plain tensors {want}); wall {t_row:.4f} s "
          f"(twin {t_plain:.4f} s); launches " + ", ".join(f"{k} {count[k]}" for k in P23_KERNELS)
          + " (twin " + ", ".join(f"{k} {twin_count[k]}" for k in P23_KERNELS) + f"); "
          f"applications {applied}; an application {per['all-gathers']:g} all-gathers, "
          f"{per['exchanges']:g} exchanges; largest difference from the twin {gap:.3e} "
          f"(held to {bound:g})", flush=True)
    require(got == want, f"{tag}: counts {got}, twin {want}")
    require(gap <= bound, f"{tag}: {gap} from the twin")
    for k in needs:
        require(count[k] > 0, f"{tag}: {k} was not launched ({count})")
    require(count["K1 halo"] <= count["K1"], f"{tag}: launches {count}")
    if gathers is not None:
        require(per["all-gathers"] == gathers, f"{tag}: {per['all-gathers']} all-gathers "
                f"an application, {gathers} expected")
    if exchanges is not None:
        require(per["exchanges"] == exchanges, f"{tag}: {per['exchanges']} exchanges an "
                f"application, {exchanges} expected")
    return {"label": label, "counts": got, "twin_counts": want, "wall_s": t_row,
            "twin_wall_s": t_plain, "count": count, "twin_count": twin_count,
            "applications": applied, "per_application": per, "max_diff": gap}


def p23_spectral_rows(gt_torch, dev, mesh):
    """The 8.6b rows at the defaults phase 20 runs (LOBPCG + the plain Poisson
    cycle 1024², k 4; Krylov–Schur complex and real and subspace iteration at
    convdiff 256², γ EIG_MILD_GAMMA; SLQ 512²), expm_multiply, exponential
    Euler and θ-steps (GCRO-DR with the σ-shifted convdiff cycle) at 256²,
    and one application of each mesh=None cycle on a sharded r."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli

    def shard(t, dim=0):
        from torch.distributed.tensor import Shard, distribute_tensor

        return distribute_tensor(t, mesh, [Shard(dim)])

    def rel(a, b):
        a, b = whole(a).detach().cpu().numpy(), whole(b).detach().cpu().numpy()
        return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)

    def eig_gap(res, twin):
        lam, ref = (cli._keyed(r.eigenvalues.cpu().numpy()) for r in (res, twin))
        return np.max(np.abs(lam - ref)) / np.max(np.abs(ref))

    def iters(res):
        return (res.iterations, res.status)

    rows = []
    n = LOBPCG_BIG_N
    a_calls, m_calls = {"n": 0}, {"n": 0}
    op = counted(gt_torch.poisson_operator(n), a_calls, "n")
    m_inv = counted(gt_torch.poisson_multigrid_preconditioner(n), m_calls, "n")
    x0 = cli._program_normal((EIG_K, n, n), torch.float64, dev)
    rtol = JAX_PHASE20["lobpcg1024"][0]

    def lobpcg(x):
        return lambda: gt_torch.lobpcg(op, x, tol=0.0, rtol=rtol, max_iterations=200, M=m_inv)

    rows.append(p23_row(f"lobpcg poisson {n}x{n} k {EIG_K} + the mesh=None cycle, block "
                        "[Shard(1)]", lobpcg(shard(x0, 1)), lobpcg(x0), iters, eig_gap, 1e-10,
                        needs=("K1", "K1 halo"), gathers=0, ops={"M": m_calls, "A": a_calls}))
    n, g = EIG_CD_N, EIG_MILD_GAMMA
    a_calls = {"n": 0}
    cd = counted(gt_torch.convection_diffusion_operator(n, *g), a_calls, "n")
    probe = cli._program_normal((n, n), torch.float64, dev)
    for name, fn in (("arnoldi", gt_torch.arnoldi_eigs), ("ks_real", gt_torch.arnoldi_eigs_real)):
        def ks(p, fn=fn):
            return lambda: fn(cd, p, nev=EIG_K, steps=EIG_STEPS, which="LM", tol=1e-8,
                              max_restarts=200)

        rows.append(p23_row(f"{name} convdiff {n}x{n} gamma {g} k {EIG_K}, probe [Shard(0)]",
                            ks(shard(probe)), ks(probe), iters, eig_gap, 1e-10,
                            needs=("K1", "K1 halo"), gathers=0, exchanges=1,
                            ops={"A": a_calls}))
    ones = torch.ones((n, n), dtype=torch.float64, device=dev)

    def subspace(p):
        return lambda: gt_torch.subspace_eigs(cd, p, nev=EIG_K, guard=6, iters=200, tol=1e-8)

    rows.append(p23_row(f"subspace convdiff {n}x{n} gamma {g} k {EIG_K}, probe [Shard(0)] "
                        "(CholQR2; the twin LAPACK's QR)", subspace(shard(ones)),
                        subspace(ones), iters, eig_gap, P23_SUBSPACE_GAP,
                        needs=("K1", "K1 halo"), gathers=0, exchanges=1, ops={"A": a_calls}))
    n = SLQ_N
    a_calls = {"n": 0}
    op = counted(gt_torch.poisson_operator(n), a_calls, "n")
    x_like = torch.zeros((n, n), dtype=torch.float64, device=dev)

    def slq(x):
        return lambda: gt_torch.trace_funm(op, torch.log, x, n_probes=SLQ_PROBES[0],
                                           steps=SLQ_STEPS, key=0)

    rows.append(p23_row(f"slq poisson {n}x{n} probes {SLQ_PROBES[0]}, x_like [Shard(0)]",
                        slq(shard(x_like)), slq(x_like), lambda r: (r.samples.shape[0],),
                        lambda r, t: abs(float(r.value) - float(t.value)) / abs(float(t.value)),
                        1e-12, needs=("K1", "K1 halo"), gathers=0, exchanges=1,
                        ops={"A": a_calls}))
    n = EVOLVE_N
    a_calls = {"n": 0}
    heat = counted(gt_torch.poisson_operator(n), a_calls, "n")
    u0 = torch.as_tensor(np.random.default_rng(0).standard_normal((n, n))).to(dev)

    def expm(u):
        return lambda: gt_torch.expm_multiply(heat, u, 1.0, steps=30)

    rows.append(p23_row(f"expm_multiply poisson {n}x{n} t 1, b [Shard(0)]", expm(shard(u0)),
                        expm(u0), lambda r: (r.host_syncs,), lambda r, t: rel(r.y, t.y), 1e-12,
                        needs=("K1", "K1 halo"), gathers=0, exchanges=1, ops={"A": a_calls}))

    def exp_euler(u):
        return lambda: gt_torch.exponential_evolve(heat, u, dt=1.0, n_steps=P23_EVOLVE_STEPS,
                                                   steps=30)

    rows.append(p23_row(f"exponential_evolve heat {n}x{n} {P23_EVOLVE_STEPS} steps, u0 "
                        "[Shard(0)]", exp_euler(shard(u0)), exp_euler(u0),
                        lambda r: (r.host_syncs,), lambda r, t: rel(r.u, t.u), 1e-12,
                        needs=("K1", "K1 halo"), gathers=0, exchanges=1, ops={"A": a_calls}))
    a_calls, m_calls = {"n": 0}, {"n": 0}
    cd = counted(gt_torch.convection_diffusion_operator(n, 2.0, 1.0), a_calls, "n")
    cyc = gt_torch.convection_diffusion_multigrid_preconditioner(n, 2.0, 1.0, shift=2.0)
    m_inv = counted(lambda r: cyc(r) / 0.5, m_calls, "n")

    def theta(u):
        return lambda: gt_torch.theta_evolve(cd, u, dt=1.0, n_steps=P23_EVOLVE_STEPS, theta=0.5,
                                             solver="gcrodr", tol=1e-9, restart=40, recycle_k=10,
                                             max_restarts=100, M=m_inv)

    rows.append(p23_row(f"theta_evolve convdiff {n}x{n} gcrodr + the mesh=None shifted cycle, "
                        f"{P23_EVOLVE_STEPS} steps, u0 [Shard(0)]", theta(shard(u0)), theta(u0),
                        lambda r: (tuple(r.iterations.tolist()), r.status),
                        lambda r, t: rel(r.u, t.u), 1e-9, needs=("K1", "K1 halo"), gathers=0,
                        ops={"M": m_calls, "A": a_calls}))
    # Each mesh=None cycle on a sharded r: the distributed cycle on r's mesh
    # (every level sharded on one rank, 8 rows a rank being the default).
    n = 1024
    r = torch.as_tensor(np.random.default_rng(1).standard_normal((n, n))).to(dev)
    kh2 = 10 * gt_torch.helmholtz_lambda_min(n)
    for name, m in (("poisson", gt_torch.poisson_multigrid_preconditioner(n)),
                    ("convdiff auto f32", gt_torch.convection_diffusion_multigrid_preconditioner(
                        n, 0.4, 0.2, smoother="auto", internal_dtype=torch.float32)),
                    ("helmholtz spd", gt_torch.helmholtz_shifted_laplacian_preconditioner(
                        n, kh2))):
        m_calls = {"n": 0}
        mc = counted(m, m_calls, "n")
        rows.append(p23_row(f"mesh=None {name} cycle {n}x{n}, r [Shard(0)]",
                            lambda mc=mc: mc(shard(r)), lambda m=m: m(r), lambda z: tuple(z.shape),
                            lambda z, t: rel(z, t), 1e-6 if "f32" in name else 1e-13,
                            needs=("K1 halo",), gathers=0, ops={"M": m_calls}))
    return rows


def p23_sparse_rows(gt_torch, dev, mesh):
    """The 8.7 rows: CG with cbpr2 on a row-sharded HYB at 1000² (phase 8's
    cg 1000²: A and the A inside M each one K3 launch); CSR, COO and ELL SpMV
    at 512² (one all-gather of x); DIA at 2048² f32 and f64 (K3 on the rank's
    rows, one exchange); BSR of 128² blocks (K4 on the rank's block rows, one
    exchange)."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops.sparse import csr_row_ids

    def shard(t):
        from torch.distributed.tensor import Shard, distribute_tensor

        return distribute_tensor(t, mesh, [Shard(0)])

    def rel(a, b):
        a, b = whole(a).detach().cpu().numpy(), whole(b).detach().cpu().numpy()
        return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)

    rows = []
    n = P23_HYB_N
    hyb = gt_torch.csr_to_hyb(gt_torch.poisson_csr(n, device=dev))
    a_calls = {"n": 0}
    op = counted(gt_torch.sparse_operator(hyb), a_calls, "n")
    m_inv = gt_torch.chebyshev_preconditioner(op, *REF_EIG)
    b = gt_torch.sparse_operator(hyb)(torch.ones(n * n, dtype=torch.float64, device=dev))

    def cg(rhs):
        return lambda: gt_torch.cg(op, rhs, tol=CG_TOL, M=m_inv)

    rows.append(p23_row(f"cg HYB {n}x{n} + cbpr2 (phase 8's), b [Shard(0)] (K3 on the "
                        "rank's rows)", cg(shard(b)),
                        cg(b), lambda r: (r.iterations, r.status), lambda r, t: rel(r.x, t.x),
                        1e-10, needs=("K3",), gathers=0, exchanges=1, ops={"A": a_calls}))
    n = P23_SPMV_N
    csr = gt_torch.poisson_csr(n, device=dev)
    mats = {"csr": csr, "coo": gt_torch.COOMatrix(
        data=csr.data, row=csr_row_ids(csr), col=csr.indices, shape=csr.shape),
        "ell": gt_torch.csr_to_ell(csr)}
    dia = gt_torch.poisson_dia(P23_DIA_N, device=dev)
    mats["dia f64"] = dia
    mats["dia f32"] = cast_dia(gt_torch, dia, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nbr, bs = P23_BSR
    mats["bsr f32"] = block_tridiagonal(gt_torch, nbr, bs, torch.float32, dev, gen)
    for name, a in mats.items():
        a_calls = {"n": 0}
        op = counted(gt_torch.sparse_operator(a), a_calls, "n")
        dt = a.data.dtype
        x = torch.randn(a.shape[1], generator=gen, device=dev, dtype=torch.float64).to(dt)
        band = not name.startswith(("csr", "coo", "ell"))
        kernel = {"dia": "K3", "bsr": "K4"}.get(name[:3])
        rows.append(p23_row(
            f"spmv {name} {a.shape[0]} rows, x [Shard(0)]", lambda op=op, x=x: op(shard(x)),
            lambda op=op, x=x: op(x), lambda y: tuple(y.shape), rel,
            0.0 if name.startswith("dia") else (1e-5 if dt == torch.float32 else 1e-12),
            needs=(kernel,) if kernel else (), gathers=0 if band else 1,
            exchanges=1 if band else 0, ops={"A": a_calls}))
    return rows


def p23_rank_blocks(gt_torch, dev):
    """K3 and K4 as the sharded route launches them for an interior rank
    (rank 1 of 4, made without a group): K3 on the 2048² DIA's rows with its
    x widened by h = 2048 entries each side and the offsets shifted by h,
    against the plain rows version (bitwise) and the whole matrix's K3 rows;
    K4 on block rows 4–7 of the BSR with the window of block columns 3–8,
    against the einsum twin on the same block within §6 row 11's 1e-5."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import sparse

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    for dt in (torch.float32, torch.float64):
        a = cast_dia(gt_torch, gt_torch.poisson_dia(P23_DIA_N, device=dev), dt)
        n, h = a.shape[0], P23_DIA_N
        m = lo = n // 4
        local = sparse.DIAMatrix(data=a.data[:, lo:lo + m].contiguous(),
                                 offsets=tuple(o + h for o in a.offsets), shape=(m, m + 2 * h))
        x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64).to(dt)
        xw = x[lo - h:lo + m + h].contiguous()
        y = sparse.dia_spmv_pallas(local, xw)
        errs = [float((y - sparse.dia_spmv(local, xw)).abs().max()),
                float((y - sparse.dia_spmv_pallas(a, x)[lo:lo + m]).abs().max())]
        print(f"phase 23: K3 on a rank block {local.shape} {dt}, offsets {local.offsets}: "
              f"max |K3 − plain rows| {errs[0]:.3e}, max |K3 − whole matrix's rows| "
              f"{errs[1]:.3e}", flush=True)
        require(errs == [0.0, 0.0], f"phase 23: K3 on a rank block {dt}: {errs}")
        out[f"K3 {dt}"] = max(errs)
    nbr, bs = P23_BSR
    a = block_tridiagonal(gt_torch, nbr, bs, torch.float32, dev, gen)
    local = sparse.BSRMatrix(data=a.data[4:8].contiguous(),
                             block_cols=(a.block_cols[4:8] - 3).contiguous(),
                             shape=(4 * bs, 6 * bs))
    x = torch.randn(nbr * bs, generator=gen, device=dev, dtype=torch.float32)
    xw = x[3 * bs:9 * bs].contiguous()
    y = sparse.bsr_spmv_pallas(local, xw)
    ref = sparse.bsr_spmv(local, xw)
    err = float((y - ref).abs().max())
    rel_k4 = err / float(ref.abs().max())
    whole_err = float((y - sparse.bsr_spmv_pallas(a, x)[4 * bs:8 * bs]).abs().max())
    print(f"phase 23: K4 on block rows 4-7 of {nbr}x{bs}² f32: max |K4 − einsum| {err:.3e} "
          f"({rel_k4:.2e} of max|y|), max |K4 − whole matrix's rows| {whole_err:.3e}",
          flush=True)
    require(rel_k4 < 1e-5 and whole_err == 0.0, f"phase 23: K4 on a rank block: {rel_k4}, "
            f"{whole_err}")
    out["K4 float32"] = err
    return out


def p23_programs(dev, workdir):
    """The spmv program at its defaults, and scale at its 2-D defaults and its
    --dim 3 arm at 128³."""
    from gmres_tpu_torch.benchmarks import cli

    rows = {}
    jsonl = os.path.join(workdir, "spmv.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    t0 = time.perf_counter()
    cli.main(["spmv", "--jsonl", jsonl])
    with open(jsonl) as f:
        spmv = [json.loads(line) for line in f]
    names = [r["name"] for r in spmv]
    print(f"phase 23: python -m gmres_tpu_torch.benchmarks spmv: "
          f"{time.perf_counter() - t0:.1f} s, rows " + "; ".join(
              f"{r['name']} {r['wall_s'] * 1e6:.2f} us {r['gnnz_per_s']:.2f} Gnnz/s"
              for r in spmv), flush=True)
    for k in ("stencil-k1-f32", "dia-k3-f32", "csr2hyb-k3-f32", "bsr-k4-f32", "bsr-einsum-f32"):
        require(k in names, f"phase 23: spmv has no row {k}")
    rows["spmv"] = spmv
    rows["scale"] = program_rows(cli, ["scale"], workdir, phase="phase 23")
    rows["scale 3d"] = program_rows(cli, P23_SCALE_3D, workdir, phase="phase 23")
    return rows


def phase_sharded_spectral_sparse(gt_torch, dev, workdir):
    """Phase 23: the 8.6b and 8.7 rows on the one-rank NCCL group (made by the
    caller), each beside its twin on plain tensors; K3 and K4 on rank blocks;
    the spmv and scale programs. Returns the launches over the rows, those
    over their twins, the rank-block errors, the rows and the programs'
    rows."""
    t_phase = time.perf_counter()
    mesh = gt_torch.solver_mesh(1)
    rows = p23_spectral_rows(gt_torch, dev, mesh) + p23_sparse_rows(gt_torch, dev, mesh)
    launches, twins = ({k: sum(r[key][k] for r in rows) for k in rows[0][key]}
                       for key in ("count", "twin_count"))
    blocks = p23_rank_blocks(gt_torch, dev)
    programs = p23_programs(dev, workdir)
    seconds = time.perf_counter() - t_phase
    print(f"phase 23: {seconds:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {launches[k]}" for k in P23_KERNELS)
          + "; over their twins: " + ", ".join(f"{k} {twins[k]}" for k in P23_KERNELS),
          flush=True)
    return launches, twins, blocks, rows, programs


# ---------------------------------------------------------------------------
# Phase 24: batched solves and the batched launches of K1, K1rr, K1cr, K2.
# ---------------------------------------------------------------------------

P24_LANES = (2, 4, 8)
P24_K1 = ((300, "float32"), (300, "float64"), (2048, "float32"), (2048, "float64"))
P24_FORMS = (300, 2048)       # fine sides, float32
# K2's three paths at the shapes that take them: the 75² coarse solve
# (cluster), the 2048² order-3 smoother (tiled), and the per-sweep path
# forced at 300² order 8 float64.
P24_K2 = (("cluster", 75, 32, "float32", None), ("tiled", 2048, 3, "float32", None),
          ("sweep", 300, 8, "float64", ("sweep", None)))
P24_REPEATS = 2
# Phase 18's block CG at s = 4 + MG 512² when a block application launched
# each kernel once a row (PERF.md §5): 14 iterations, launches a solve.
ROWWISE_BLOCK_CG = {"iterations": 14, "K1": 60, "K1rr": 300, "K1cr": 300, "K2": 660}
LOBPCG_1024_ITERATIONS = 21   # phase 20's LOBPCG at 1024² (PERF.md §5)
P24_BATCHED_N = {"mg": 300, "cg": 1024, "bicgstab": 256}
# (γx, γx/2) a lane, around the shared cycle's (0.4, 0.2): 13-15
# iterations each (CPU), so the lanes run batched nearly to the end (with
# γ 0, 0.2, 0.4, 0.8 the γ 0 lane ran alone 177 of its 199 iterations).
P24_GAMMAS = (0.2, 0.3, 0.4, 0.5)
P24_SOLVE_LANES = 8


def p24_kernel_row(name, batched, singles, plain, rtol, work, reps, library=None):
    """One batched kernel against its B single launches (bitwise) and its
    plain version (rtol), with device ms by CUDA-graph replay of each (the
    singles without stacking their outputs), the bound (the lanes' bytes
    and operations), and the library call. `singles` returns the lanes'
    outputs, one tensor (or tuple) a lane."""
    import torch

    outs_b, lanes, outs_p = batched(), singles(), plain()
    torch.cuda.synchronize()
    if isinstance(outs_b, torch.Tensor):
        outs_b, outs_p, lanes = (outs_b,), (outs_p,), [(o,) for o in lanes]
    outs_s = [torch.stack([lane[i] for lane in lanes]) for i in range(len(outs_b))]
    err = 0.0
    for i, (a, s, p) in enumerate(zip(outs_b, outs_s, outs_p)):
        require(bool(torch.isfinite(a).all()), f"{name}: output {i} not finite")
        require(torch.equal(a, s), f"{name}: output {i} differs from the single launches "
                f"(max abs {float((a - s).abs().max()):.3e})")
        scale = float(p.abs().max())
        e = float((a - p).abs().max())
        err = max(err, e)
        require(e <= rtol * scale, f"{name}: output {i} against its plain version "
                f"{e:.3e} > {rtol:.0e} of {scale:.3e}")
    # Ten calls a graph, two for blocks over 100 MB (a graph keeps every
    # call's outputs and temporaries).
    pg = 2 if work[0] > 100e6 else 10
    rec = {"case": name, "max_abs_err": err, "rtol": rtol,
           "ms": device_ms(batched, reps, pg), "singles_ms": device_ms(singles, reps, pg),
           "plain_ms": device_ms(plain, reps, pg), "library_ms": None,
           "host_us": host_us(batched, 50), "singles_host_us": host_us(singles, 50)}
    rec["bound_ms"], rec["bound_by"] = bound(*work[:3])
    rec["l2_resident"] = work[0] <= L2_BYTES
    extra = ""
    if library is not None:
        rec.update(library_record(library, outs_p[0], reps))
        extra = (f" library {rec['library_ms']:.4f} ms" if rec["library_ms"] is not None
                 else f" library: {rec['library_note']}")
    print(f"  {name:46s} bitwise to singles, err {err:.2e} (tol {rtol:.0e})  device: "
          f"batched {rec['ms']:.4f} ms, singles {rec['singles_ms']:.4f} ms "
          f"({rec['singles_ms'] / rec['ms']:.2f}x), plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}"
          f"{'; L2-resident' if rec['l2_resident'] else ''}) = "
          f"{rec['ms'] / rec['bound_ms']:.2f}x; host {rec['host_us']:.1f} us "
          f"(singles {rec['singles_host_us']:.1f}){extra}", flush=True)
    return rec


def p24_kernels(dev):
    """(a) Each batched kernel at B ∈ P24_LANES against B single launches
    and its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.ops import fused, stencil

    gen = np.random.default_rng(SEED + 24)
    coefs = GENERAL_COEFS
    records = {"K1 batched": [], "K1rr batched": [], "K1cr batched": [], "K2 batched": []}
    print("phase 24 (a): the batched kernels against B single launches and their "
          "plain versions", flush=True)
    for n, dts in P24_K1:
        dt = getattr(torch, dts)
        item = torch.empty((), dtype=dt).element_size()
        for lanes in P24_LANES:
            xb = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
            per = torch.as_tensor(gen.standard_normal((lanes, 5)) * 0.3
                                  + np.array(coefs)).to(dev)
            w = torch.tensor([[0.0, coefs[3], 0.0], [coefs[1], coefs[0], coefs[2]],
                              [0.0, coefs[4], 0.0]], dtype=dt, device=dev).reshape(1, 1, 3, 3)
            # One cross a lane (a grouped convolution: one call for all).
            wl = torch.zeros((lanes, 1, 3, 3), dtype=torch.float64, device=dev)
            for (i, j), k in (((1, 1), 0), ((1, 0), 1), ((1, 2), 2), ((0, 1), 3),
                              ((2, 1), 4)):
                wl[:, 0, i, j] = per[:, k]
            wl = wl.to(dt)
            pl = [per[k].tolist() for k in range(lanes)]
            # The plain version's per-lane coefficients: (lanes, 1, 1), each
            # rounded to the block's dtype as the launch rounds it.
            per_terms = [per.to(dt)[:, k, None, None] for k in range(5)]
            work = (2 * lanes * n * n * item, 9 * lanes * n * n, dt)
            reps = 20 if n >= 2048 else 100
            tag = f"{lanes}x{n}x{n} {'f32' if dt == torch.float32 else 'f64'}"
            records["K1 batched"].append(p24_kernel_row(
                f"K1 batched {tag}",
                lambda: stencil.stencil5_cuda(xb, None, None, coefs),
                lambda: [stencil.stencil5_cuda(xb[k], None, None, coefs)
                         for k in range(lanes)],
                lambda: stencil.stencil_5pt_general(xb, *coefs), 0.0, work, reps,
                library=lambda: F.conv2d(xb[:, None], w, padding=1)[:, 0]))
            records["K1 batched"].append(p24_kernel_row(
                f"K1 batched {tag} per-lane coefficients",
                lambda: stencil.stencil5_cuda(xb, None, None, per),
                lambda: [stencil.stencil5_cuda(xb[k], None, None, pl[k])
                         for k in range(lanes)],
                lambda: stencil.stencil_5pt_general(xb, *per_terms), 0.0, work, reps,
                library=lambda: F.conv2d(xb[None], wl, padding=1, groups=lanes)[0]))
    for n in P24_FORMS:
        dt, item = torch.float32, 4
        for lanes in P24_LANES:
            rb = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
            eb = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
            ecb = torch.as_tensor(gen.standard_normal((lanes, n // 2, n // 2))).to(dev, dt)
            reps = 20 if n >= 2048 else 100
            tag = f"{lanes}x{n}x{n} -> {n // 2} f32"
            pair = torch.stack([rb, eb], dim=1)
            w4 = restrict_weights(coefs, dev, dt)
            records["K1rr batched"].append(p24_kernel_row(
                f"K1rr batched {tag}",
                lambda: stencil.residual_restrict_cuda(rb, eb, coefs),
                lambda: [stencil.residual_restrict_cuda(rb[k], eb[k], coefs)
                         for k in range(lanes)],
                lambda: stencil.residual_restrict_plain(rb, eb, coefs), 0.0,
                (lanes * (2 * n * n + n * n // 4) * item, 11 * lanes * n * n, dt), reps,
                library=lambda: F.conv2d(pair, w4, stride=2, padding=1)[:, 0]))

            records["K1cr batched"].append(p24_kernel_row(
                f"K1cr batched {tag}",
                lambda: stencil.correct_residual_cuda(rb, eb, ecb, coefs),
                lambda: [stencil.correct_residual_cuda(rb[k], eb[k], ecb[k], coefs)
                         for k in range(lanes)],
                lambda: stencil.correct_residual_plain(rb, eb, ecb, coefs), 0.0,
                (lanes * (4 * n * n + n * n // 4) * item, 12 * lanes * n * n, dt), reps))
    for path, n, order, dts, forced in P24_K2:
        dt = getattr(torch, dts)
        item = torch.empty((), dtype=dt).element_size()
        lam_min = 8.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 if order > 8 else 2.0
        theta, _, steps = fused.chebyshev_k_scalars(lam_min, 8.0, order)
        rtol = (1e-4 if order > 8 else 1e-5) if dt == torch.float32 else 1e-11
        for lanes in P24_LANES:
            rb = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
            reps = 20 if n >= 2048 else 100
            got = fused.chebk_route(n, n, order - 1, dt, dev.index, forced)[0]
            require(got == path, f"K2 batched {n}² order {order}: path {got}, not {path}")
            records["K2 batched"].append(p24_kernel_row(
                f"K2 batched {path} order {order} {lanes}x{n}x{n} {dts}",
                lambda: fused.chebk_cuda(rb, theta, steps, _path=forced),
                lambda: [fused.chebk_cuda(rb[k], theta, steps, _path=forced)
                         for k in range(lanes)],
                lambda: fused.poly_stencil_smoother_plain(rb, theta, steps), rtol,
                (2 * lanes * n * n * item, lanes * n * n * (1 + 14 * (order - 1)), dt), reps))
            records["K2 batched"][-1]["path"] = path
    return records


def restrict_weights(coefs, dev, dt):
    """restrict_conv's 4×4 stride-2 weights on (r, e), for a batch."""
    import torch

    c0, cw, ce, cs, cn = coefs
    w = torch.zeros((1, 2, 4, 4), dtype=torch.float64)
    for qi in (1, 2):
        for qj in (1, 2):
            w[0, 0, qi, qj] = 1.0
            for (di, dj), cv in (((0, 0), c0), ((0, -1), cw), ((0, 1), ce),
                                 ((-1, 0), cs), ((1, 0), cn)):
                w[0, 1, qi + di, qj + dj] -= cv
    return w.to(dev, dt)


def p24_block_calls() -> dict:
    """Calls of the routed entries of K1's forms and K2 on a (lanes, rows,
    cols) block (their vmap rules make one a block application; the CPU
    tests count the same)."""
    from gmres_tpu_torch.ops import fused, stencil

    return {"K1": stencil.stencil_5pt_pallas.block_calls,
            "K1rr": stencil.residual_restrict.block_calls,
            "K1cr": stencil.correct_residual.block_calls,
            "K2": fused.poly_stencil_smoother_pallas.block_calls}


def p24_block_application(gt_torch, dev):
    """(b) One block application of the mg 512² cycle at s = 4: through
    row_apply (one batched launch a kernel use, one routed-entry call on
    the block each) and through a loop of single-vector applications
    written here; the same bits, the launches, device ms by CUDA-graph
    replay and host µs of each."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops.blas import row_apply

    n, s = MULTIRHS_N, BLOCK_CG_S
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    rows = torch.as_tensor(np.random.default_rng(SEED).standard_normal((s, n, n)),
                           device=dev)
    ways = {"row_apply (vmap)": lambda: row_apply(m_inv, rows),
            "loop of single vectors": lambda: torch.stack([m_inv(rows[i]) for i in range(s)])}
    out = {}
    outs = {name: fn() for name, fn in ways.items()}
    torch.cuda.synchronize()
    require(torch.equal(*outs.values()), "phase 24 (b): row_apply differs from the loop")
    for name, fn in ways.items():
        mg_counters(reset=True)
        calls = p24_block_calls()
        fn()
        torch.cuda.synchronize()
        count = mg_counters()
        out[name] = {"launches": {k: count[k] for k in KERNELS},
                     "batched": {k: count[f"{k} batched"] for k in KERNELS},
                     "block_calls": {k: v - calls[k] for k, v in p24_block_calls().items()},
                     "ms": device_ms(fn, 20), "host_us": host_us(fn, 20)}
        print(f"phase 24 (b): one block application of the mg {n}x{n} cycle, s = {s}, "
              f"{name}: launches {out[name]['launches']} (batched "
              f"{out[name]['batched']}; routed-entry calls on the block "
              f"{out[name]['block_calls']}), device {out[name]['ms']:.4f} ms, host "
              f"{out[name]['host_us']:.1f} us", flush=True)
    via, loop = out["row_apply (vmap)"], out["loop of single vectors"]
    require(all(via["batched"][k] == via["launches"][k] == via["block_calls"][k]
                and s * via["launches"][k] == loop["launches"][k] for k in KERNELS),
            f"phase 24 (b): launches {via} against the loop's {loop}")
    return out


def p24_block_rows(gt_torch, dev, workdir):
    """(c) The block rows of phases 17, 18 and 20 again: block CG at s = 4
    + MG 512², LOBPCG at k = 4 1024², block GMRES(30) + MG at s = 4 512²;
    their counts those of one launch a row (and gmres_tpu's), each block
    application one batched launch of each kernel (no single-grid launch),
    and block CG's launches a solve 1/s of one launch a row's."""
    import types

    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli

    rows = []
    n, s = MULTIRHS_N, BLOCK_CG_S
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    xs = np.random.default_rng(0).standard_normal((s, n, n))
    b_np = np.stack([np_stencil(x) for x in xs])
    b = torch.as_tensor(b_np, device=dev)
    label = f"block_cg s={s} mg {n}x{n}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.block_cg(A, b, tol=1e-8, M=M, max_iterations=2000),
        {"A": (op, b[0]), "M": (m_inv, b[0])}, repeats=P24_REPEATS, phase="phase 24 (c)")
    solves = P24_REPEATS + 1
    per_solve = {k: count[k] / solves for k in KERNELS}
    errs = [float(np.linalg.norm(b_np[i] - np_stencil(res.x[i].cpu().numpy())))
            for i in range(s)]
    print(f"phase 24 (c): {label}: {res.iterations} iterations (one launch a row: "
          f"{ROWWISE_BLOCK_CG['iterations']}), launches a solve {per_solve} (one launch a "
          f"row: {ROWWISE_BLOCK_CG}), max numpy ‖bᵢ − A xᵢ‖ {max(errs):.3e}", flush=True)
    require(res.status == 0 and max(errs) < 1e-8 and
            res.iterations == ROWWISE_BLOCK_CG["iterations"], f"{label}: {res.iterations}")
    require(all(count[f"{k} batched"] == count[k] for k in KERNELS),
            f"{label}: single-grid launches in a block solve {count}")
    require(all(per_solve[k] * s == ROWWISE_BLOCK_CG[k] for k in KERNELS),
            f"{label}: launches a solve {per_solve} are not {ROWWISE_BLOCK_CG} / {s}")
    rows.append(family_record(label, res, times, count, calls, per, max(errs),
                              launches_per_solve=per_solve))

    n = LOBPCG_BIG_N
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    x0 = cli._program_normal((EIG_K, n, n), torch.float64, dev)
    label = f"lobpcg k {EIG_K} mg {n}x{n}"
    rtol = JAX_PHASE20["lobpcg1024"][0]
    def lobpcg(A, M):
        # family_run times a result with a residual: the largest pair's.
        out = gt_torch.lobpcg(A, x0, tol=0.0, rtol=rtol, max_iterations=200, M=M)
        return types.SimpleNamespace(eig=out, residual=out.residuals.max(),
                                     status=out.status, iterations=out.iterations,
                                     host_syncs=out.host_syncs)

    res, times, count, calls, per, med = family_run(
        label, lobpcg, {"A": (op, x0[0]), "M": (m_inv, x0[0])}, repeats=P24_REPEATS,
        phase="phase 24 (c)")
    lam = res.eig.eigenvalues.cpu().numpy()
    err = float(np.max(np.abs(np.sort(lam) - poisson_smallest(n, EIG_K))))
    per_it = {k: count[k] / (solves * res.iterations) for k in KERNELS}
    print(f"phase 24 (c): {label}: {res.iterations} iterations (phase 20's "
          f"{LOBPCG_1024_ITERATIONS}), launches an iteration {per_it} (one launch a row: "
          f"12 K1, 16–24 K1rr, 36–52 K2), "
          f"max |λ − closed form| {err:.3e}", flush=True)
    require(res.status == 0 and res.iterations == LOBPCG_1024_ITERATIONS
            and err < 1e-6 * float(np.max(np.abs(lam))), f"{label}: {res.iterations}, {err}")
    require(all(count[f"{k} batched"] == count[k] for k in KERNELS),
            f"{label}: single-grid launches in a block solve {count}")
    rows.append(family_record(label, res, times, count, calls, per, err,
                              launches_per_iteration=per_it))

    n, s = MULTIRHS_N, 4
    op = gt_torch.poisson_operator(n)
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    xs = np.random.default_rng(0).standard_normal((s, n, n))
    b_np = np.stack([np_stencil(x) for x in xs])
    b = torch.as_tensor(b_np, device=dev)
    label = f"block_gmres(30) s={s} mg {n}x{n}"
    res, times, count, calls, per, med = family_run(
        label, lambda A, M: gt_torch.block_gmres(A, b, restart=30, tol=1e-8, M=M,
                                                 max_restarts=200),
        {"A": (op, b[0]), "M": (m_inv, b[0])}, repeats=P24_REPEATS, phase="phase 24 (c)")
    errs = [np_rel(b_np[i], res.x[i]) for i in range(s)]
    print(f"phase 24 (c): {label}: {res.restarts} restarts, "
          f"launches a solve {dict((k, count[k] / solves) for k in KERNELS)}, numpy "
          f"residuals {[f'{e:.3e}' for e in errs]}", flush=True)
    require(res.status == 0 and max(errs) < 1e-8, f"{label}: {res.status}, {errs}")
    family_counts(f"{label} restarts", res.restarts, JAX_MULTIRHS_RESTARTS[s], 2,
                  phase="phase 24 (c)")
    require(all(count[f"{k} batched"] == count[k] for k in KERNELS),
            f"{label}: single-grid launches in a block solve {count}")
    rows.append(family_record(label, res, times, count, calls, per, max(errs)))
    return rows


def lockstep_launches(label, batched, seqs, keys):
    """A launch rule of batched_row: each of `keys` launched in the batched
    run exactly as often as in the longest lane's sequential run (the lanes
    run one sequence of steps until each stops: CG, the fixed-length
    factorizations). Returns (longest, every)."""
    longest = {k: max(s[k] for s in seqs) for k in keys}
    every = {k: sum(s[k] for s in seqs) for k in keys}
    require(all(batched[k] == longest[k] for k in keys),
            f"{label}: launches { {k: batched[k] for k in keys} } against the longest "
            f"lane's {longest}")
    return longest, every


def between_launches(label, batched, seqs, keys):
    """A launch rule of batched_row: each of `keys` launched in the batched
    run between the longest lane's sequential count and all lanes' together,
    and not at all where no lane launched it (the lanes that wait on one
    operator share a launch; a lane that stops earlier drops out; lanes
    whose steps differ wait on different operators and the runner serves
    the larger group first, so a change of waiting group costs one more
    application; a transposed set of lanes that changes takes one more
    forward for its pullback's primal). Returns (longest, every)."""
    longest = {k: max(s[k] for s in seqs) for k in keys}
    every = {k: sum(s[k] for s in seqs) for k in keys}
    require(all(longest[k] <= batched[k] <= every[k] for k in keys if every[k] > 0),
            f"{label}: launches { {k: batched[k] for k in keys} } against the longest "
            f"lane's {longest} and all lanes' {every}")
    require(all(batched[k] == 0 for k in keys if every[k] == 0),
            f"{label}: launches { {k: batched[k] for k in keys} } where the lanes made "
            f"none {every}")
    return longest, every


def batched_row(gt_torch, label, solver, A, bs, kw, residual, *, rule, phase, bound=None,
                lane_args=(), lane_op=None, fields=("iterations", "status"), outputs=("x",),
                statuses=(0,), counter=None, keys=KERNELS, counts=None, blocks=None,
                need_batched=True, wrap=None, single=None):
    """One batched-solve row of phases 24-27: ``batched_solve`` after an
    untimed one, then each lane's sequential run (after an untimed one of
    lane 0), every run with the counts set to 0 just before it and read
    just after. Required: each lane's `fields` (counts) and `outputs`
    (tensors) those of its sequential run, to the bit; the batch's host
    reads the longest lane's; the launches of `keys` by `rule`
    (lockstep_launches or between_launches); with `need_batched`, a launch
    on a lane block of each of `keys` the batch launched; each lane's status
    in `statuses`; and each lane's numpy float64 check `residual(k, out)`
    finite and, where `bound` is given, at most `bound` (out: the lane's x
    for a solve, else a dict of its `outputs` as numpy arrays). A lone
    lane's application is single launches. `counter(reset)` reads the
    launch counts (mg_counters by default), `counts` maps them to the row's
    launches (as read by default), `blocks` to its launches on lane blocks,
    kept apart where given. `wrap(call)` makes one call of a thunk and
    returns its result with ``host_syncs`` (default: call()); `single(A_k,
    b_k)` is a lane's sequential run (default solver(A_k, b_k, **kw));
    `statuses` None for a result without a status."""
    import numpy as np
    import torch

    counter = counter or mg_counters
    counts = counts or (lambda c: c)
    wrap = wrap or (lambda call: call())
    single = single or (lambda a, b: solver(a, b, **kw))
    lanes = bs.shape[0]
    lane_op = lane_op or (lambda k: A)

    def timed(call):
        counter(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wrap(call)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, counter()

    def batch():
        return gt_torch.batched_solve(solver, A, bs, lane_args=lane_args, **kw)

    wrap(batch)
    res, wall, raw = timed(batch)
    count = counts(raw)
    if need_batched:
        require(all(raw[f"{k} batched"] > 0 for k in keys if raw[k] > 0),
                f"{phase} {label}: no batched launch in a batched solve {raw}")
    wrap(lambda: single(lane_op(0), bs[0]))
    seqs, seq_counts, seq_walls = [], [], []
    for k in range(lanes):
        one, w, raw_k = timed(lambda: single(lane_op(k), bs[k]))
        seqs.append(one)
        seq_walls.append(w)
        seq_counts.append(counts(raw_k))
    diffs, errs = [], []
    for k, one in enumerate(seqs):
        for name in fields:
            got, want = int(getattr(res, name)[k]), int(getattr(one, name))
            require(got == want, f"{phase} {label} lane {k}: {name} {got}, sequential {want}")
        for name in outputs:
            got, want = getattr(res, name)[k], getattr(one, name)
            require(got.shape == want.shape,
                    f"{phase} {label} lane {k}: {name} {tuple(got.shape)}, sequential "
                    f"{tuple(want.shape)}")
            diffs.append(float((got - want).abs().max()) if got.numel() else 0.0)
        if outputs == ("x",):
            out = res.x[k].detach().cpu().numpy().astype(np.float64)
        else:
            out = {name: getattr(res, name)[k].detach().cpu().numpy() for name in outputs}
        errs.append(residual(k, out))
    longest, every = rule(f"{phase} {label}", count, seq_counts, keys)
    syncs = max(one.host_syncs for one in seqs)
    lane_counts = {name: [int(v) for v in getattr(res, name).tolist()] for name in fields}
    print(f"{phase}: {label}, {lanes} lanes: {lane_counts}; host reads {res.host_syncs} "
          f"(the longest lane's {syncs}); launches { {k: count[k] for k in keys} } "
          + (f"(on blocks {blocks(raw)}) " if blocks else
             f"(batched { {k: raw[f'{k} batched'] for k in keys} }) ")
          + f"(the longest lane's sequential {longest}, all lanes' {every}); batched wall "
          f"{wall:.4f} s, the lanes in turn {sum(seq_walls):.4f} s "
          f"({sum(seq_walls) / wall:.2f}x); max |output − sequential| {max(diffs):.3e}; "
          f"numpy checks {[f'{e:.3e}' for e in errs]}"
          + (f" (bound {bound:g})" if bound is not None else ""), flush=True)
    require(statuses is None or all(int(v) in statuses for v in res.status.tolist()),
            f"{phase} {label}: status {getattr(res, 'status', None)}")
    require(max(diffs) == 0.0, f"{phase} {label}: outputs differ from the sequential ones by "
            f"{max(diffs):.3e}")
    require(res.host_syncs == syncs,
            f"{phase} {label}: {res.host_syncs} host reads, the longest lane's {syncs}")
    require(all(np.isfinite(e) and (bound is None or e <= bound) for e in errs),
            f"{phase} {label}: numpy checks {errs} against {bound}")
    row = {"label": label, "lanes": lanes, "counts": lane_counts,
           "host_syncs": res.host_syncs, "longest_lane_host_syncs": syncs,
           "launches": count, "longest_lane_launches": longest,
           "all_lanes_launches": every, "wall_s": wall, "sequential_walls_s": seq_walls,
           "max_output_diff": max(diffs), "numpy_residuals": errs}
    if blocks:
        row["block_launches"] = blocks(raw)
    if outputs == ("x",):
        row["x_max"] = res.x.reshape(lanes, -1).amax(dim=1).tolist()
    return row


def p24_batched_solves(gt_torch, dev):
    """(d) The batched solves at full width: the mg configuration at 300²
    (Householder GMRES(10), float32 cycles certified in float64) on 8 seeded
    right-hand sides; CG + MG at 1024² on 8; BiCGSTAB on convection–diffusion
    256² over 4 lanes of γ (K1 with per-lane coefficients), with the
    BASELINE config 3 cycle (γ 0.4, 0.2) as the lanes' one M
    (unpreconditioned, γ 0.4 and 0.8 break down at 256², sequentially as
    batched) and γ around the cycle's (P24_GAMMAS)."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply

    rows = []
    gen = np.random.default_rng(SEED)
    n = P24_BATCHED_N["mg"]
    op, m_inv = gt_torch.poisson_operator(n), gt_torch.poisson_multigrid_preconditioner(n)
    b_np = np.stack([np_stencil(x) for x in gen.standard_normal((P24_SOLVE_LANES, n, n))])
    bs = torch.as_tensor(b_np, device=dev)
    kw = dict(restart=10, tol=TOL, M=m_inv, inner_dtype=torch.float32, certify="true",
              compute_v_err=False)
    row = batched_row(gt_torch, f"mg {n}x{n} gmres(10) f32 cycles", gt_torch.gmres, op, bs,
                      kw, lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil(x))
                                             / np.linalg.norm(b_np[k])),
                      rule=between_launches, phase="phase 24 (d)",
                      fields=("iterations", "restarts", "status"))
    require(max(row["numpy_residuals"]) <= TOL, f"mg batched: {row['numpy_residuals']}")
    rows.append(row)

    n = P24_BATCHED_N["cg"]
    op, m_inv = gt_torch.poisson_operator(n), gt_torch.poisson_multigrid_preconditioner(n)
    b_np = np.stack([np_stencil(x) for x in gen.standard_normal((P24_SOLVE_LANES, n, n))])
    bs = torch.as_tensor(b_np, device=dev)
    kw = dict(tol=CG_TOL, rtol=1e-10, M=m_inv)
    row = batched_row(gt_torch, f"cg mg {n}x{n}", gt_torch.cg, op, bs, kw,
                      lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil(x))
                                         / np.linalg.norm(b_np[k])),
                      rule=lockstep_launches, phase="phase 24 (d)")
    require(max(row["numpy_residuals"]) <= 1e-9, f"cg batched: {row['numpy_residuals']}")
    rows.append(row)

    n = P24_BATCHED_N["bicgstab"]
    g = torch.tensor(P24_GAMMAS, dtype=torch.float64, device=dev)
    m_inv = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)

    def cd(v, gx):
        return convection_diffusion_apply(v, gx, 0.5 * gx)

    ones = torch.ones((n, n), dtype=torch.float64, device=dev)
    bs = torch.stack([cd(ones, gx) for gx in g])
    b_np = bs.cpu().numpy()
    coefs = [(4.0, -(1.0 + gx), -(1.0 - gx), -(1.0 + 0.5 * gx), -(1.0 - 0.5 * gx))
             for gx in P24_GAMMAS]
    row = batched_row(
        gt_torch, f"bicgstab convdiff {n}x{n} over γ {list(P24_GAMMAS)}", gt_torch.bicgstab,
        cd, bs, dict(tol=CONVDIFF_TOL, M=m_inv),
        lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil_general(x, coefs[k]))),
        rule=between_launches, phase="phase 24 (d)", lane_args=(g,),
        lane_op=lambda k: (lambda v: cd(v, g[k])))
    require(max(row["numpy_residuals"]) <= CONVDIFF_TOL, f"bicgstab batched: {row}")
    rows.append(row)
    return rows


def phase_batched(gt_torch, dev, workdir):
    """Phase 24: (a) the batched kernels, (b) one block application of the
    cycle both ways, (c) the block rows, (d) the batched solves. Returns the
    kernel records, the launches over (c) and (d) (each row's counts
    summed) and the rows."""
    t_phase = time.perf_counter()
    records = p24_kernels(dev)
    block = p24_block_application(gt_torch, dev)
    rows = p24_block_rows(gt_torch, dev, workdir) + p24_batched_solves(gt_torch, dev)
    launches = dict.fromkeys(mg_counters(), 0)
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] += v
    require(all(launches[f"{k} batched"] > 0 for k in KERNELS),
            f"phase 24: a batched kernel was not launched on the main path {launches}")
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return records, launches, {"block_application": block, "rows": rows}


# ---------------------------------------------------------------------------
# Phase 25: batched solves of the short recurrences, the GMRES family and
# Newton–Krylov (the Bratu λ-sweep), SLQ's probes batched, and the batched
# launches of K3 and K4.
# ---------------------------------------------------------------------------

P25_KERNELS = KERNELS + ("K3", "K4")
P25_LANES = 4
P25_K3_N = CG_GRIDS[-1]                      # the HYB 1000² f64 of the cg path
P25_K3_LANES = (4, 8, 9)                     # 9: one partial chunk of 16
P25_K4 = (BSR_CASES[-1][1], BSR_CASES[-1][2])  # block rows, block size
# (dtype, lanes): the first is the headline (f32, 8 lanes: the matrix once);
# 9 a full chunk of 8 and a partial one.
P25_K4_LANES = (("float32", 8), ("float32", 4), ("float32", 9), ("float32", 16),
                ("float64", 8))
P25_BRATU_N, P25_LAMS = 512, (1.0, 3.0, 5.0, 6.5)
P25_CHEB = (512, 64)                         # side, order (K2 with the coefficients)
P25_FAMILY_N = P24_BATCHED_N["mg"]           # lgmres and sstep_gmres with the mg cycle
P25_CD_SOLVERS = ("cgs", "tfqmr", "bicgstabl", "idrs")


def p25_counters(reset: bool = False) -> dict:
    """mg_counters plus K3's and K4's launches, all and on a block."""
    from gmres_tpu_torch.ops import sparse

    if reset:
        for w in (sparse.dia_spmv_cuda, sparse.bsr_spmv_cuda):
            w.launches = w.batched_launches = 0
    out = mg_counters(reset)
    for name, w in (("K3", sparse.dia_spmv_cuda), ("K4", sparse.bsr_spmv_cuda)):
        out[name] = w.launches
        out[f"{name} batched"] = w.batched_launches
    return out


def p25_kernels(gt_torch, dev):
    """(a) K3 batched on the DIA of HYB 1000² f64 at P25_K3_LANES lanes and K4
    batched on 512 block rows of three 128² blocks at P25_K4_LANES (lanes,
    dtype), the partial chunks among them, each against its B single launches
    (bitwise) and its plain version, with device ms, the bound (the matrix
    once, the lanes' x and y) and the library call on X = (n, lanes); then
    single K3 and K4 at the same matrices, retimed beside them."""
    import torch

    from gmres_tpu_torch.ops import sparse

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 25)
    records = {"K3 batched": [], "K4 batched": [], "K3 single": [], "K4 single": []}
    print("phase 25 (a): K3 and K4 on lane blocks, a chunk of lanes reading each matrix "
          "entry once, against B single launches and their plain versions", flush=True)
    n = P25_K3_N
    csr = gt_torch.poisson_csr(n, device=dev)
    a = gt_torch.csr_to_hyb(csr).dia
    lib = csr_library(csr, torch.float64)
    nnz = int((a.data != 0).sum())
    for lanes in P25_K3_LANES:
        xb = torch.randn((lanes, n * n), generator=gen, device=dev, dtype=torch.float64)
        xt = xb.T.contiguous()
        plan = sparse.spmv_lanes_plan("K3", lanes, torch.float64, n * n)
        rec = p24_kernel_row(
            f"K3 batched HYB {n}x{n} f64 {lanes} lanes",
            lambda: sparse.dia_spmv_cuda(a, xb),
            lambda: [sparse.dia_spmv_cuda(a, xb[k]) for k in range(lanes)],
            lambda: sparse.dia_spmv(a, xb), 0.0,
            ((a.data.numel() + 2 * lanes * n * n) * 8, 2 * nnz * lanes, torch.float64),
            100, library=lambda: (lib @ xt).T)
        rec.update(lanes=lanes, chunk=plan.chunk, chunks=plan.chunks)
        records["K3 batched"].append(rec)
    x = torch.randn(n * n, generator=gen, device=dev, dtype=torch.float64)
    records["K3 single"].append(compare(
        f"K3 HYB {n}x{n} f64, retimed in phase 25", lambda: sparse.dia_spmv_cuda(a, x),
        lambda: sparse.dia_spmv(a, x), 0.0, 200, work=dia_work(a), library=lambda: lib @ x))

    nbr, bs = P25_K4
    base = block_tridiagonal(gt_torch, nbr, bs, torch.float64, dev, gen)
    for dts, lanes in P25_K4_LANES:
        dt, rtol = (torch.float32, 1e-5) if dts == "float32" else (torch.float64, 1e-13)
        item, tag = (4, "f32") if dts == "float32" else (8, "f64")
        a4 = gt_torch.BSRMatrix(data=base.data.to(dt), block_cols=base.block_cols,
                                shape=base.shape)
        xb4 = torch.randn((lanes, nbr * bs), generator=gen, device=dev, dtype=dt)
        xt4 = xb4.T.contiguous()
        lib4 = bsr_library(a4)
        plan = sparse.spmv_lanes_plan("K4", lanes, dt, nbr, bs)
        rec = p24_kernel_row(
            f"K4 batched {nbr} block rows bs={bs} {tag} {lanes} lanes",
            lambda: sparse.bsr_spmv_cuda(a4, xb4),
            lambda: [sparse.bsr_spmv_cuda(a4, xb4[k]) for k in range(lanes)],
            lambda: sparse.bsr_spmv(a4, xb4), rtol,
            (a4.data.numel() * item + a4.block_cols.numel() * 4
             + 2 * lanes * nbr * bs * item, 2 * a4.data.numel() * lanes, dt), 50,
            library=lambda: (lib4 @ xt4).T)
        rec.update(lanes=lanes, chunk=plan.chunk, chunks=plan.chunks)
        records["K4 batched"].append(rec)
        if (dts, lanes) == P25_K4_LANES[0]:
            x4 = torch.randn(nbr * bs, generator=gen, device=dev, dtype=dt)
            records["K4 single"].append(compare(
                f"K4 {nbr} block rows bs={bs} f32, retimed in phase 25",
                lambda: sparse.bsr_spmv_cuda(a4, x4), lambda: sparse.bsr_spmv(a4, x4),
                rtol, 50, work=bsr_work(a4), library=lambda: lib4 @ x4))
    for name in ("K3 batched", "K4 batched"):
        for r in records[name]:
            if r["library_ms"] is not None:
                print(f"  {r['case']}: {r['bound_ms'] / r['ms']:.0%} of the bound; the "
                      f"library call takes {r['library_ms'] / r['ms']:.2f}x its time",
                      flush=True)
    return records


def p25_unit_rhs(n, lanes, seed, dev):
    """b = A·x for seeded standard-normal x on Poisson n², each scaled to
    unit norm (one absolute tol serves every lane); numpy and the card's."""
    import numpy as np
    import torch

    xs = np.random.default_rng(seed).standard_normal((lanes, n, n))
    b_np = np.stack([np_stencil(x) for x in xs])
    b_np /= np.linalg.norm(b_np.reshape(lanes, -1), axis=1)[:, None, None]
    return b_np, torch.as_tensor(b_np, device=dev)


def p25_row(gt_torch, label, solver, A, bs, kw, residual, bound, **extra):
    """One phase 25 solve row: batched_row with K3 and K4 counted, the
    launches between the longest lane's and all lanes', the numpy residual
    at most `bound`."""
    return batched_row(gt_torch, label, solver, A, bs, kw, residual, bound=bound,
                       rule=between_launches, phase="phase 25 (b)", keys=P25_KERNELS,
                       counter=p25_counters, **extra)


def p25_batched_solves(gt_torch, dev):
    """(b) The batched solves at full width, each lane held to its
    sequential solve's counts, status and x to the bit, with the host reads
    and launches against the longest lane's and the wall against the lanes
    run in turn."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply
    from gmres_tpu_torch.models.poisson import poisson_apply

    rows = []
    lanes = P25_LANES
    # The Bratu λ-sweep (gmres_tpu's jax.vmap of a Newton solve): F(u, λ),
    # the frozen Poisson V-cycle as M (the FGMRES inner).
    n = P25_BRATU_N
    h2 = (1.0 / (n + 1)) ** 2
    lams = torch.tensor(P25_LAMS, dtype=torch.float64, device=dev)

    def bratu(u, lam):
        return poisson_apply(u) - (lam * h2) * torch.exp(u)

    row = p25_row(
        gt_torch, f"newton_krylov bratu {n}x{n} over λ {list(P25_LAMS)}, mg fgmres inner",
        gt_torch.newton_krylov, bratu, torch.zeros((len(P25_LAMS), n, n), dtype=torch.float64,
                                                   device=dev),
        dict(tol=BRATU_TOL, restart=20, max_newton=30,
             M=gt_torch.poisson_multigrid_preconditioner(n)),
        lambda k, x: float(np.linalg.norm(np_bratu(x, P25_LAMS[k]))), BRATU_TOL,
        lane_args=(lams,), lane_op=lambda k: (lambda u: bratu(u, lams[k])),
        fields=("iterations", "status", "inner_iterations", "jv_products"))
    require(all(np.diff(row["x_max"]) > 0), f"bratu sweep: max u {row['x_max']} not rising")
    rows.append(row)

    n = POISSON_1024
    m_inv = gt_torch.poisson_multigrid_preconditioner(n)
    b_np, bs = p25_unit_rhs(n, lanes, SEED + 251, dev)

    def poisson_residual(k, x):
        return float(np.linalg.norm(b_np[k] - np_stencil(x)))

    op = gt_torch.poisson_operator(n)
    rows.append(p25_row(gt_torch, f"minres mg {n}x{n}", gt_torch.minres, op, bs,
                        dict(tol=1e-9, M=m_inv), poisson_residual, 1e-8))
    rows.append(p25_row(gt_torch, f"sstep_cg s={SSTEP_CG_S} mg {n}x{n}", gt_torch.sstep_cg,
                        op, bs, dict(tol=1e-9, s=SSTEP_CG_S, M=m_inv), poisson_residual, 1e-9))

    n = P24_BATCHED_N["bicgstab"]
    g = torch.tensor(P24_GAMMAS, dtype=torch.float64, device=dev)
    m_cd = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)

    def cd(v, gx):
        return convection_diffusion_apply(v, gx, 0.5 * gx)

    ones = torch.ones((n, n), dtype=torch.float64, device=dev)
    bcd = torch.stack([cd(ones, gx) for gx in g])
    bcd_np = bcd.cpu().numpy()
    coefs = [(4.0, -(1.0 + gx), -(1.0 - gx), -(1.0 + 0.5 * gx), -(1.0 - 0.5 * gx))
             for gx in P24_GAMMAS]
    for name in P25_CD_SOLVERS:
        rows.append(p25_row(
            gt_torch, f"{name} convdiff {n}x{n} over γ {list(P24_GAMMAS)}",
            getattr(gt_torch, name), cd, bcd, dict(tol=CONVDIFF_TOL, M=m_cd),
            lambda k, x: float(np.linalg.norm(bcd_np[k] - np_stencil_general(x, coefs[k]))),
            1.01 * CONVDIFF_TOL, lane_args=(g,), lane_op=lambda k: (lambda v: cd(v, g[k]))))

    n, order = P25_CHEB
    lo, hi = gt_torch.poisson_spectral_bounds(n)
    b_np, bs = p25_unit_rhs(n, lanes, SEED + 252, dev)
    rows.append(p25_row(
        gt_torch, f"chebyshev_solve order {order} {n}x{n} (K2)", gt_torch.chebyshev_solve,
        gt_torch.poisson_operator(n), bs,
        dict(lam_min=lo, lam_max=hi, order=order, tol=1e-8, coefs=(4.0, -1.0, -1.0, -1.0, -1.0)),
        lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil(x))), 1.01e-8))

    n = P25_FAMILY_N
    op, m_inv = gt_torch.poisson_operator(n), gt_torch.poisson_multigrid_preconditioner(n)
    b_np, bs = p25_unit_rhs(n, lanes, SEED + 253, dev)
    for label, solver, kw, bound in (
            (f"lgmres(10, 3) mg {n}x{n}", gt_torch.lgmres,
             dict(restart=10, aug=3, tol=TOL, M=m_inv), 2 * TOL),
            (f"sstep_gmres s=4 mg {n}x{n}", gt_torch.sstep_gmres,
             dict(s=4, tol=TOL, M=m_inv), 1e-6)):
        rows.append(p25_row(gt_torch, label, solver, op, bs, kw,
                            lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil(x))), bound,
                            fields=("iterations", "restarts", "status")))

    # CG on the sparse operators: HYB 1000² (K3) and the BSR Poisson 64² in
    # 64² blocks of the CG path (K4), cbpr2 around the operator.
    for label, mat, n in (
            (f"cg cbpr2 HYB {P25_K3_N}x{P25_K3_N} (K3)",
             gt_torch.csr_to_hyb(gt_torch.poisson_csr(P25_K3_N, device=dev)), P25_K3_N),
            (f"cg cbpr2 BSR {SMALL_GRID}x{SMALL_GRID} in {SMALL_GRID}² blocks (K4)",
             gt_torch.bsr_from_dense(gt_torch.poisson_matrix(SMALL_GRID, device="cpu").numpy(),
                                     SMALL_GRID, device=dev), SMALL_GRID)):
        op = gt_torch.sparse_operator(mat)
        b_np, bs = p25_unit_rhs(n, lanes, SEED + n, dev)
        rows.append(p25_row(
            gt_torch, label, gt_torch.cg, op, bs.reshape(lanes, -1),
            dict(tol=CG_TOL, M=gt_torch.chebyshev_preconditioner(op, *REF_EIG)),
            lambda k, x, b_np=b_np, n=n: float(np.linalg.norm(
                b_np[k] - np_stencil(x.reshape(n, n)))), 1.01 * CG_TOL))
    return rows


def p25_slq(gt_torch, dev):
    """(b) trace_funm at phase 20's SLQ shape (Poisson 512², 40 steps, the
    smallest probe count): the probes batched, one K1 launch a step and one
    host read, the samples those of one factorization a probe to the bit."""
    import torch

    from gmres_tpu_torch.ops.blas import tree_vdot
    from gmres_tpu_torch.solvers import funm
    from gmres_tpu_torch.solvers.lanczos import arnoldi_factorization

    n, probes, steps = SLQ_N, SLQ_PROBES[0], SLQ_STEPS
    op = gt_torch.poisson_operator(n)
    x_like = torch.zeros((n, n), dtype=torch.float64, device=dev)
    gt_torch.trace_funm(op, torch.log, x_like, n_probes=probes, steps=steps, key=0)
    p25_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gt_torch.trace_funm(op, torch.log, x_like, n_probes=probes, steps=steps, key=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = p25_counters()
    z = funm._rademacher(probes, (n, n), torch.float64, dev, 0)
    p25_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = []
    for i in range(probes):
        _, hmat = arnoldi_factorization(op, z[i], steps)
        theta, q, _, _ = funm._projected_eigh(hmat, steps)
        quad = torch.sum(torch.log(theta) * q[0, :] ** 2).to(dev, torch.float64)
        loop.append(tree_vdot(z[i], z[i]) * quad)
    loop = torch.stack(loop)
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    loop_count = p25_counters()
    label = f"slq poisson {n}x{n} probes {probes} steps {steps}"
    print(f"phase 25 (b): {label}: {float(res.value):.6f} ± {float(res.stderr):.6f}; host "
          f"reads {res.host_syncs} (one factorization a probe: {probes}); K1 launches "
          f"{count['K1']} ({count['K1 batched']} batched; the loop's {loop_count['K1']}); "
          f"batched wall {wall:.4f} s, the loop {loop_wall:.4f} s "
          f"({loop_wall / wall:.2f}x); samples equal to the loop's: "
          f"{torch.equal(res.samples, loop)}", flush=True)
    require(torch.equal(res.samples, loop), f"{label}: samples differ from the loop's")
    require(res.host_syncs == 1 and count["K1"] == count["K1 batched"] == steps
            and loop_count["K1"] == probes * steps, f"{label}: {res.host_syncs} reads, {count}")
    return {"label": label, "host_syncs": res.host_syncs, "launches": count, "wall_s": wall,
            "loop_wall_s": loop_wall, "loop_launches": loop_count}


def phase_batched_family(gt_torch, dev):
    """Phase 25: (a) K3 and K4 on lane blocks, (b) the batched solves of the
    short recurrences, the GMRES family and Newton–Krylov, and SLQ's batched
    probes. Returns the kernel records, the launches over (b) (each row's
    counts summed) and the rows."""
    t_phase = time.perf_counter()
    records = p25_kernels(gt_torch, dev)
    rows = p25_batched_solves(gt_torch, dev) + [p25_slq(gt_torch, dev)]
    launches = dict.fromkeys(p25_counters(), 0)
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] += v
    require(all(launches[f"{k} batched"] > 0 for k in P25_KERNELS),
            f"phase 25: a batched kernel was not launched on the main path {launches}")
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return records, launches, rows


P26_LANES = 4
P26_GAMMAS = (0.2, 0.3, 0.4, 0.5)            # γx of the convdiff lanes (γy 0.2)
P26_QMR_N = QMR_N                            # (a): phase 19's QMR + cycle + MT row
P26_LSQ_N, P26_LSQ_CAP = P21_LSQR_N, P21_LSQR_CAP  # (b): phase 21 row (f)'s size and cap
P26_DR_N = 300                               # (c): GMRES-DR(30, 10) + cbpr2, tol 1e-10
P26_GCRODR_N = 1024                          # (d): GCRO-DR(40, 10) + the cycle
P26_BRATU_N, P26_LAMS = P25_BRATU_N, P25_LAMS  # (e): Newton, gcrodr inner
P26_BLOCK_N, P26_BLOCK_S = MULTIRHS_N, 4     # (f): block CG and block GMRES(30)
P26_IMPLICIT_N = 1024                        # (g): vmap(grad(loss)) through implicit_solve
P26_IMPLICIT_GAMMAS = (0.1, 0.3, 0.5, 0.7)
P26_K1_T = ((2048, "float32"), (2048, "float64"))  # (h): 8 lanes, transposed
P26_K1_T_LANES = 8
P26_KERNELS = ("K1", "K1rr", "K1cr", "K2")
P26_COUNTS = P26_KERNELS + ("K1 transpose", "K1 tangent", "K1 forward")  # p26_counts' keys


def p26_counts(count) -> dict:
    """rule_counters' counts with K1's split by role."""
    out = {k: count[k] for k in P26_KERNELS}
    out["K1 transpose"] = count["K1 transpose"]
    out["K1 tangent"] = count["K1 tangent"]
    out["K1 forward"] = count["K1"] - count["K1 transpose"] - count["K1 tangent"]
    return out


def p26_timed(fn):
    """fn() once untimed, then once with the counts set to 0 just before it
    and read just after; (result, wall s, counts by role, launches on a
    block by kernel)."""
    import torch

    fn()
    rule_counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = rule_counters()
    return (out, wall, p26_counts(count),
            {f"{k} batched": count[f"{k} batched"] for k in P26_KERNELS})


def p26_row(gt_torch, label, solver, A, bs, kw, residual, bound, **extra):
    """One phase 26 row: batched_row with K1's launches split by role
    (p26_counts) and those on lane blocks apart, each kernel and role
    between the longest lane's and all lanes' (between_launches), the
    numpy residual at most `bound`."""
    return batched_row(gt_torch, label, solver, A, bs, kw, residual, bound=bound,
                       rule=between_launches, phase="phase 26", counter=rule_counters,
                       counts=p26_counts, keys=P26_COUNTS, need_batched=False,
                       blocks=lambda c: {f"{k} batched": c[f"{k} batched"]
                                         for k in P26_KERNELS}, **extra)


def p26_convdiff(gt_torch, n, dev, gammas=P26_GAMMAS):
    """The convdiff family A(v, γx) (γy 0.2), each lane's b = A(γx)·1 and its
    coefficients; numpy and the card's."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import (
        convection_diffusion_apply,
        convection_diffusion_coefs,
    )

    g = torch.tensor(gammas, dtype=torch.float64, device=dev)

    def cd(v, gx):
        return convection_diffusion_apply(v, gx, 0.2)

    coefs = [convection_diffusion_coefs(gx, 0.2) for gx in gammas]
    b_np = np.stack([np_stencil_general(np.ones((n, n)), c) for c in coefs])
    return cd, g, coefs, b_np, torch.as_tensor(b_np, device=dev)


def p26_transpose_rows(gt_torch, dev):
    """(a) QMR with the convdiff cycle and MT= over γ lanes; (b) LSQR and
    LSMR over γ lanes to phase 21's cap: the lanes' transposes of the family
    one pullback, one K1 launch with each lane's mirrored coefficients."""
    import numpy as np

    rows = []
    n = P26_QMR_N
    cd, g, coefs, b_np, bs = p26_convdiff(gt_torch, n, dev)
    m_inv = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    mt = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, transpose=True)
    rows.append(p26_row(
        gt_torch, f"(a) qmr mg+MT convdiff {n}x{n} over γ {list(P26_GAMMAS)}", gt_torch.qmr,
        cd, bs, dict(tol=1e-9, M=m_inv, MT=mt),
        lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil_general(x, coefs[k]))
                           / np.linalg.norm(b_np[k])), 1e-6,
        lane_args=(g,), lane_op=lambda k: (lambda v: cd(v, g[k]))))
    require(rows[-1]["launches"]["K1 transpose"] > 0, f"(a): {rows[-1]['launches']}")
    n = P26_LSQ_N
    cd, g, coefs, b_np, bs = p26_convdiff(gt_torch, n, dev)
    for name in ("lsqr", "lsmr"):
        rows.append(p26_row(
            gt_torch, f"(b) {name} convdiff {n}x{n} over γ {list(P26_GAMMAS)}, cap "
                      f"{P26_LSQ_CAP}", getattr(gt_torch, name), cd, bs,
            dict(tol=TOL, max_iterations=P26_LSQ_CAP),
            lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil_general(x, coefs[k]))
                               / np.linalg.norm(b_np[k])), 1.0,
            lane_args=(g,), lane_op=lambda k: (lambda v: cd(v, g[k])), statuses=(0, 1)))
    return rows


def p26_deflated_rows(gt_torch, dev):
    """(c) GMRES-DR(30, 10) with cbpr2 over seeded right-hand sides; (d)
    GCRO-DR(40, 10) with the cycle over γ lanes; (e) Newton–Krylov with the
    gcrodr inner over the Bratu λ-sweep: each cycle's small state read for
    all waiting lanes at once, each lane's eigensolve on its own host copy,
    each lane's recycle block its own."""
    import numpy as np
    import torch

    from gmres_tpu_torch.models.poisson import poisson_apply

    rows = []
    n = P26_DR_N
    op = gt_torch.poisson_operator(n)
    b_np, bs = p25_unit_rhs(n, P26_LANES, SEED + 261, dev)
    rows.append(p26_row(
        gt_torch, f"(c) gmres_dr(30, 10) cbpr2 {n}x{n}", gt_torch.gmres_dr, op, bs,
        dict(restart=30, deflate=10, tol=1e-10, M=gt_torch.chebyshev_preconditioner(op,
                                                                                    *REF_EIG)),
        lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil(x))), 1e-9,
        fields=("restarts", "iterations", "status")))
    n = P26_GCRODR_N
    cd, g, coefs, b_np, bs = p26_convdiff(gt_torch, n, dev)
    rows.append(p26_row(
        gt_torch, f"(d) gcrodr(40, 10) mg convdiff {n}x{n} over γ {list(P26_GAMMAS)}",
        gt_torch.gcrodr, cd, bs,
        dict(k=10, restart=40, tol=1e-9,
             M=gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)),
        lambda k, x: float(np.linalg.norm(b_np[k] - np_stencil_general(x, coefs[k]))
                           / np.linalg.norm(b_np[k])), 1e-6,
        lane_args=(g,), lane_op=lambda k: (lambda v: cd(v, g[k])),
        fields=("restarts", "iterations", "status")))
    n = P26_BRATU_N
    h2 = (1.0 / (n + 1)) ** 2
    lams = torch.tensor(P26_LAMS, dtype=torch.float64, device=dev)

    def bratu(u, lam):
        return poisson_apply(u) - (lam * h2) * torch.exp(u)

    # Without the Armijo line search: with it, the gcrodr inner with the
    # left V-cycle stops every lane at its second Newton step with status 2
    # (BREAKDOWN) at this size, in gmres_tpu as in the port (the recycled
    # space's projection alone meets the forcing term, and its step fails
    # the Armijo test; tests/test_torch_batched_deflated.py pins it at 64²).
    row = p26_row(
        gt_torch, f"(e) newton_krylov gcrodr inner, mg, no line search, bratu {n}x{n} over "
                  f"λ {list(P26_LAMS)}", gt_torch.newton_krylov, bratu,
        torch.zeros((len(P26_LAMS), n, n), dtype=torch.float64, device=dev),
        dict(tol=BRATU_TOL, inner="gcrodr", recycle_k=10, restart=30, max_newton=30,
             line_search=False, M=gt_torch.poisson_multigrid_preconditioner(n)),
        lambda k, x: float(np.linalg.norm(np_bratu(x, P26_LAMS[k]))), BRATU_TOL,
        lane_args=(lams,), lane_op=lambda k: (lambda u: bratu(u, lams[k])),
        fields=("iterations", "status", "inner_iterations", "jv_products"))
    require(row["launches"]["K1 tangent"] > 0, f"(e): no tangent launch {row['launches']}")
    rows.append(row)
    return rows


def p26_block_rows(gt_torch, dev):
    """(f) block CG and block GMRES(30) with the V-cycle, each lane a block of
    s right-hand sides: a block application of every lane one nested vmap,
    one launch a kernel on lanes·s grids."""
    import numpy as np
    import torch

    rows = []
    n, s = P26_BLOCK_N, P26_BLOCK_S
    xs = np.random.default_rng(SEED + 266).standard_normal((P26_LANES, s, n, n))
    b_np = np.stack([np.stack([np_stencil(x) for x in lane]) for lane in xs])
    b_np /= np.linalg.norm(b_np.reshape(P26_LANES, s, -1), axis=2)[:, :, None, None]
    bs = torch.as_tensor(b_np, device=dev)
    op, m_inv = gt_torch.poisson_operator(n), gt_torch.poisson_multigrid_preconditioner(n)

    def per_rhs(k, x):
        return max(float(np.linalg.norm(b_np[k, j] - np_stencil(x[j]))) for j in range(s))

    for label, solver, kw, count_field, bound in (
            (f"(f) block_cg s={s} mg {n}x{n}", gt_torch.block_cg, dict(tol=1e-8, M=m_inv),
             "iterations", 1.01e-8),
            (f"(f) block_gmres(30) s={s} mg {n}x{n}", gt_torch.block_gmres,
             dict(restart=30, tol=1e-8, M=m_inv), "restarts", 1.01e-8)):
        row = p26_row(gt_torch, label, solver, op, bs, kw, per_rhs, bound,
                      fields=(count_field, "status"))
        # One launch a kernel for all lanes' rows (one a lane would be about
        # P26_LANES times the longest lane's count, one a row s times more).
        require(all(row["launches"][k] < 2 * row["longest_lane_launches"][k]
                    for k in P26_KERNELS if row["longest_lane_launches"][k] > 0),
                f"{label}: {row['launches']} against the longest lane's "
                f"{row['longest_lane_launches']}")
        rows.append(row)
    return rows


def p26_implicit_row(gt_torch, dev):
    """(g) torch.func.vmap(torch.func.grad(loss)) through implicit_solve on
    convdiff P26_IMPLICIT_N², loss Σx², GMRES(30) to 1e-10 with the cycle at
    γ 0.4 (forward) and its transpose (adjoint) as M, over γ
    P26_IMPLICIT_GAMMAS: the lanes' forward and adjoint solves each one
    batched solve (the path counted by implicit_solve.lane_paths), against
    torch.func.grad at each γ (rtol 1e-8: the batched θ pullback sums each
    lane's coefficient cotangent over its grid in a (lanes, 5) reduction,
    the single one over one grid) and central differences."""
    import functools

    import numpy as np
    import torch

    from gmres_tpu_torch.models.convection_diffusion import convection_diffusion_apply

    n = P26_IMPLICIT_N
    b = torch.ones((n, n), dtype=torch.float64, device=dev)
    m_f = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2)
    m_t = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, transpose=True)
    syncs = {"forward": [], "adjoint": []}

    def solver(m, op, rhs):
        res = gt_torch.gmres(op, rhs, restart=30, tol=1e-10, max_restarts=200,
                             compute_v_err=False, M=m)
        syncs["forward" if m is m_f else "adjoint"].append(res.host_syncs)
        return res

    fwd, adj = functools.partial(solver, m_f), functools.partial(solver, m_t)

    def loss(gm):
        x = gt_torch.implicit_solve(lambda gx: (lambda v: convection_diffusion_apply(
            v, gx, 0.2)), gm, b, solver=fwd, adjoint_solver=adj)
        return torch.sum(x * x)

    gammas = torch.tensor(P26_IMPLICIT_GAMMAS, dtype=torch.float64, device=dev)
    paths = dict(gt_torch.implicit_solve.lane_paths)
    reads = gt_torch.implicit_solve.lane_reads
    grads, wall, count, on_blocks = p26_timed(
        lambda: torch.func.vmap(torch.func.grad(loss))(gammas))
    batched_reads = (gt_torch.implicit_solve.lane_reads - reads) // 2
    ran = {k: v - paths[k] for k, v in gt_torch.implicit_solve.lane_paths.items()}
    torch.func.grad(loss)(gammas[0])
    singles, seq_counts, seq_walls = [], [], []
    for v in syncs.values():
        del v[:]
    for g in gammas:
        rule_counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles.append(float(torch.func.grad(loss)(g)))
        torch.cuda.synchronize()
        seq_walls.append(time.perf_counter() - t0)
        seq_counts.append(p26_counts(rule_counters()))
    # The batch reads once for all lanes at each read of its forward solve,
    # then of its adjoint solve.
    longest_reads = max(syncs["forward"]) + max(syncs["adjoint"])
    got = grads.tolist()
    rel = max(abs(a - s) / abs(s) for a, s in zip(got, singles))
    eps = 1e-6
    with torch.no_grad():
        fd = [(float(loss(g + eps)) - float(loss(g - eps))) / (2 * eps) for g in gammas]
    fd_rel = max(abs(a - f) / abs(f) for a, f in zip(got, fd))
    longest, every = between_launches("phase 26 (g)", count, seq_counts, P26_COUNTS)
    print(f"phase 26: (g) vmap(grad(loss)) through implicit_solve, convdiff {n}x{n} over γ "
          f"{list(P26_IMPLICIT_GAMMAS)}: gradients {got}; torch.func.grad at each γ "
          f"{singles} (max rel {rel:.3e}, rtol 1e-8); central differences max rel "
          f"{fd_rel:.3e}; paths {ran}; host reads {batched_reads} a pass (forward and "
          f"adjoint; the longest lanes' {longest_reads}); launches {count} (the longest "
          f"lane's {longest}, all lanes' {every}); batched wall {wall:.4f} s, the lanes in "
          f"turn {sum(seq_walls):.4f} s ({sum(seq_walls) / wall:.2f}x)", flush=True)
    require(ran == {"batched": 4, "in turn": 0},
            f"(g): the lanes' solves took {ran} (two batched forward, two adjoint)")
    require(rel <= 1e-8, f"(g): gradients {got} against {singles}")
    require(fd_rel <= 1e-5, f"(g): gradients {got} against central differences {fd}")
    require(batched_reads == longest_reads,
            f"(g): {batched_reads} host reads, the longest lanes' {longest_reads}")
    require(count["K1 transpose"] > 0 and all(np.isfinite(got)), f"(g): {count}, {got}")
    return {"label": f"(g) implicit vmap(grad) convdiff {n}", "gradients": got,
            "singles": singles, "rel": rel, "fd_rel": fd_rel, "paths": ran,
            "host_syncs": batched_reads, "longest_lane_host_syncs": longest_reads,
            "launches": count, "block_launches": on_blocks, "longest_lane_launches": longest,
            "all_lanes_launches": every, "wall_s": wall, "sequential_walls_s": seq_walls}


def p26_kernel_rows(gt_torch, dev):
    """(h) K1's per-lane transposed launch (the backward rule of
    ops/stencil.py:Stencil5Lanes, each lane's coefficients mirrored) on 8
    lanes of 2048² f32 and f64: the rule's output bitwise the launch timed
    here and its 8 single transposed launches, against its plain version,
    the bound and a grouped F.conv2d."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gmres_tpu_torch.ops import stencil

    gen = np.random.default_rng(SEED + 26)
    records = []
    print("phase 26 (h): K1's per-lane transposed launch against its single launches, "
          "its plain version and a grouped convolution", flush=True)
    lanes = P26_K1_T_LANES
    for n, dts in P26_K1_T:
        dt = getattr(torch, dts)
        item = torch.empty((), dtype=dt).element_size()
        per = torch.as_tensor(gen.standard_normal((lanes, 5)) * 0.3
                              + np.array(GENERAL_COEFS)).to(dev)
        gy = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
        x = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
        mirrored = per[:, list(stencil._MIRROR)].contiguous()
        # The rule's own output: one launch, the mirrored array.
        xt = x.clone().requires_grad_()
        y = stencil.Stencil5Lanes.apply(xt, per)
        rule_counters(reset=True)
        (rule_out,) = torch.autograd.grad(y, xt, gy)
        torch.cuda.synchronize()
        count = rule_counters()
        require(count["K1"] == 1 and count["K1 transpose"] == 1,
                f"(h): the transpose rule made {count}")
        direct = stencil.stencil5_cuda(gy, None, None, mirrored)
        require(torch.equal(rule_out, direct), "(h): the rule's transpose differs from the "
                "launch with the mirrored array")
        wl = torch.zeros((lanes, 1, 3, 3), dtype=torch.float64, device=dev)
        for (i, j), k in (((1, 1), 0), ((1, 0), 1), ((1, 2), 2), ((0, 1), 3), ((2, 1), 4)):
            wl[:, 0, i, j] = mirrored[:, k]
        wl = wl.to(dt)
        ml = [mirrored[k].tolist() for k in range(lanes)]
        terms = [mirrored.to(dt)[:, k, None, None] for k in range(5)]
        tag = f"{lanes}x{n}x{n} {'f32' if dt == torch.float32 else 'f64'}"
        rec = p24_kernel_row(
            f"K1 per-lane transposed {tag}",
            lambda: stencil.stencil5_cuda(gy, None, None, mirrored),
            lambda: [stencil.stencil5_cuda(gy[k], None, None, ml[k]) for k in range(lanes)],
            lambda: stencil.stencil_5pt_general(gy, *terms), 0.0,
            (2 * lanes * n * n * item, 9 * lanes * n * n, dt), 20,
            library=lambda: F.conv2d(gy[None], wl, padding=1, groups=lanes)[0])
        records.append(rec)
    records.append(p26_nested_host(dev))
    return records


def p26_nested_host(dev):
    """Host µs of one nested block application of K1 (vmap over 4 lanes of
    vmap over 4 rows, 256² f64): through `_cuda.through_lanes`, which
    unwraps both vmap levels in one rule, against the same application
    through `Stencil5Grid.apply` (functorch's vmap rule at each level);
    both one launch on 16 grids, the same bits."""
    import torch

    from gmres_tpu_torch.ops import stencil

    x = torch.randn((4, 4, 256, 256), dtype=torch.float64, device=dev)
    c = GENERAL_COEFS
    nested = torch.func.vmap(torch.func.vmap(lambda v: stencil.stencil_5pt_pallas(v, c)))
    by_rule = torch.func.vmap(torch.func.vmap(lambda v: stencil.Stencil5Grid.apply(v, *c)))
    rule_counters(reset=True)
    a, b = nested(x), by_rule(x)
    torch.cuda.synchronize()
    require(rule_counters()["K1"] == 2 and torch.equal(a, b),
            f"nested K1: {rule_counters()} launches, equal {torch.equal(a, b)}")
    rec = {"case": "K1 nested 4x4x256x256 f64 host",
           "through_lanes_host_us": host_us(lambda: nested(x), 100),
           "function_host_us": host_us(lambda: by_rule(x), 100)}
    print(f"  nested vmap (4 lanes x 4 rows, 256² f64), one K1 launch: host "
          f"{rec['through_lanes_host_us']:.1f} us through through_lanes, "
          f"{rec['function_host_us']:.1f} us through Stencil5Grid's vmap rule at each "
          f"level", flush=True)
    return rec


def phase_batched_rest(gt_torch, dev):
    """Phase 26: (h) K1's per-lane transposed launch, then the batched solves
    of QMR, LSQR, LSMR, GMRES-DR, GCRO-DR, Newton–Krylov's gcrodr inner, block
    CG and block GMRES, and vmap(grad) through implicit_solve. Returns the
    kernel records, the launches over the rows (each row's batched counts
    summed) and the rows."""
    t_phase = time.perf_counter()
    records = {"K1 per-lane transposed": p26_kernel_rows(gt_torch, dev)}
    rows = (p26_transpose_rows(gt_torch, dev) + p26_deflated_rows(gt_torch, dev)
            + p26_block_rows(gt_torch, dev) + [p26_implicit_row(gt_torch, dev)])
    launches = dict.fromkeys(list(rows[0]["launches"]) + list(rows[0]["block_launches"]), 0)
    for r in rows:
        for k, v in list(r["launches"].items()) + list(r["block_launches"].items()):
            launches[k] += v
    require(all(launches[k] > 0 for k in launches),
            f"phase 26: a kernel, a K1 role or a block launch was not made on the main path "
            f"{launches}")
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return records, launches, rows


# ---------------------------------------------------------------------------
# Phase 27: batched_solve over the eigensolvers, matrix functions and time
# steppers (lanczos_bounds, funm_lanczos, expm_multiply, trace_funm,
# exponential_evolve, theta_evolve, lobpcg, arnoldi_eigs).
# ---------------------------------------------------------------------------

P27_SHIFTS = (0.0, 0.5, 1.0, 2.0)            # Poisson + s·I, one s a lane
P27_N = POISSON_1024                         # (a), (b), (e) cg, (f)
P27_LANCZOS_STEPS, P27_FUNM_STEPS = 40, 30
P27_TIMES = (0.1, 0.5, 1.0)                  # (b): expm_multiply's vector of times
P27_SLQ = (SLQ_N, SLQ_PROBES[0], SLQ_STEPS)  # (c): 512², 8 probes a lane, 40 steps
P27_EVOLVE_N, P27_EVOLVE_STEPS = EVOLVE_N, 5  # (d), (e) gcrodr: 256², 5 steps
P27_EIG_GAMMAS = (0.02, 0.03, 0.04)          # (g): γx of convdiff 256², γy 0.01


def lanczos_with_reads(call):
    """lanczos_bounds' (lo, hi), with the host reads its call made (its
    result carries none): each ``tolist`` of a CUDA tensor, which is how
    the runners answer a Read (solvers/requests.py)."""
    import types

    import torch

    real, reads = torch.Tensor.tolist, [0]

    def counting(self, *args, **kwargs):
        reads[0] += int(self.is_cuda)
        return real(self, *args, **kwargs)

    torch.Tensor.tolist = counting
    try:
        lo, hi = call()
    finally:
        torch.Tensor.tolist = real
    return types.SimpleNamespace(lo=lo, hi=hi, host_syncs=reads[0])


def p27_poisson_lanes(n):
    """The family A(v, s) = Poisson(v) + s·v, the lanes' shifts on the card's
    device of the caller, and the closed form: the sine matrix S (S A S is
    diagonal) and the Poisson eigenvalues Λ (n, n)."""
    import numpy as np

    s_mat = np.sqrt(2.0 / (n + 1)) * np.sin(
        np.outer(np.arange(1, n + 1), np.arange(1, n + 1)) * np.pi / (n + 1))
    c = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    return s_mat, c[:, None] + c[None, :]


def sine_apply(s_mat, x, fvals):
    """f(A)·x for A = S diag(Λ) S: S ((S x S) ⊙ f(Λ)) S, in numpy."""
    return s_mat @ ((s_mat @ x @ s_mat) * fvals) @ s_mat


def p27_rows_poisson(gt_torch, dev):
    """(a) lanczos_bounds, (b) funm_lanczos and expm_multiply on Poisson
    1024² + s·I over P27_SHIFTS; (c) trace_funm log det on Poisson 512² + s·I,
    8 probes a lane; (d) exponential Euler on Poisson 256² + s·I: each lane
    held to its sequential run to the bit, and to the closed form by the
    sine transform."""
    import numpy as np
    import torch

    rows = []
    lanes = len(P27_SHIFTS)
    shifts = torch.tensor(P27_SHIFTS, dtype=torch.float64, device=dev)
    n = P27_N
    op = gt_torch.poisson_operator(n)

    def fam(v, s):
        return op(v) + s * v

    def lane(k):
        return lambda v: fam(v, shifts[k])

    s_mat, lam = p27_poisson_lanes(n)
    gen = np.random.default_rng(SEED + 270)
    bs_np = gen.standard_normal((lanes, n, n))
    bs = torch.as_tensor(bs_np, device=dev)

    def bounds_check(k, out):
        """The larger distance of (lo, hi) from the closed form's (λ_min,
        λ_max), over the spectrum's width (inf for a negative lo): 40 steps
        place both extreme Ritz values (widened by their residuals) within
        1% of it, though neither is a guaranteed bound until they converge."""
        lo, hi = float(out["lo"]), float(out["hi"])
        lam_min, lam_max = lam.min() + P27_SHIFTS[k], lam.max() + P27_SHIFTS[k]
        print(f"phase 27 (a): s {P27_SHIFTS[k]}: [{lo:.10f}, {hi:.10f}] against the closed "
              f"form [{lam_min:.10f}, {lam_max:.10f}]", flush=True)
        if lo < 0:
            return float("inf")
        return max(abs(lo - lam_min), abs(hi - lam_max)) / (lam_max - lam_min)

    rows.append(batched_row(
        gt_torch, f"(a) lanczos_bounds poisson {n}x{n} + s·I over s {list(P27_SHIFTS)}, "
                  f"steps {P27_LANCZOS_STEPS}", gt_torch.lanczos_bounds, fam, bs,
        dict(steps=P27_LANCZOS_STEPS), bounds_check, bound=1e-2, rule=lockstep_launches,
        phase="phase 27", lane_args=(shifts,), lane_op=lane, fields=(),
        outputs=("lo", "hi"), statuses=None, wrap=lanczos_with_reads))

    def rho_bound(k, m):
        """A relative bound of m-step Lanczos on f(x) = x^(−1/2): 2√κ ρ^m,
        ρ = (√κ − 1)/(√κ + 1) (Chebyshev), κ the lane's condition."""
        kappa = (lam.max() + P27_SHIFTS[k]) / (lam.min() + P27_SHIFTS[k])
        rho = (np.sqrt(kappa) - 1) / (np.sqrt(kappa) + 1)
        return max(2 * np.sqrt(kappa) * rho ** m, 1e-10)

    def invsqrt_check(k, out):
        exact = sine_apply(s_mat, bs_np[k], 1.0 / np.sqrt(lam + P27_SHIFTS[k]))
        err = np.linalg.norm(out["y"] - exact) / np.linalg.norm(exact)
        bound = rho_bound(k, P27_FUNM_STEPS)
        print(f"phase 27 (b): s {P27_SHIFTS[k]}: A^(-1/2) b relative error against the sine "
              f"transform {err:.3e} (Chebyshev bound {bound:.3e}; Saad's estimate "
              f"{float(out['error_estimate']) / np.linalg.norm(exact):.3e})", flush=True)
        return err / bound

    rows.append(batched_row(
        gt_torch, f"(b) funm_lanczos A^(-1/2) b poisson {n}x{n} + s·I, steps "
                  f"{P27_FUNM_STEPS}", gt_torch.funm_lanczos, fam, bs,
        dict(f=lambda x: 1 / torch.sqrt(x), steps=P27_FUNM_STEPS), invsqrt_check, bound=1.0,
        rule=lockstep_launches, phase="phase 27", lane_args=(shifts,), lane_op=lane,
        fields=(), outputs=("y", "error_estimate", "asymmetry"), statuses=None))
    for t in (0.1, P27_TIMES):
        times = np.atleast_1d(np.asarray(t, dtype=np.float64))

        def expm_check(k, out, times=times):
            y = out["y"].reshape((len(times), n, n))
            errs = [np.linalg.norm(y[i] - e) / np.linalg.norm(e) for i, e in enumerate(
                sine_apply(s_mat, bs_np[k], np.exp(-ti * (lam + P27_SHIFTS[k])))
                for ti in times)]
            return max(errs)

        rows.append(batched_row(
            gt_torch, f"(b) expm_multiply t {t} poisson {n}x{n} + s·I, steps {P27_FUNM_STEPS}",
            gt_torch.expm_multiply, fam, bs, dict(t=t, steps=P27_FUNM_STEPS), expm_check,
            bound=EXPM_ERROR, rule=lockstep_launches, phase="phase 27", lane_args=(shifts,),
            lane_op=lane, fields=(), outputs=("y", "error_estimate", "asymmetry"),
            statuses=None))

    n, probes, steps = P27_SLQ
    op_slq = gt_torch.poisson_operator(n)

    def fam_slq(v, s):
        return op_slq(v) + s * v

    _, lam_slq = p27_poisson_lanes(n)
    likes = torch.zeros((lanes, n, n), dtype=torch.float64, device=dev)

    def logdet_check(k, out):
        exact = float(np.sum(np.log(lam_slq + P27_SHIFTS[k])))
        z = abs(float(out["value"]) - exact) / float(out["stderr"])
        print(f"phase 27 (c): s {P27_SHIFTS[k]}: log det {float(out['value']):.6f} ± "
              f"{float(out['stderr']):.6f}, closed form {exact:.6f} ({z:.2f} stderr)",
              flush=True)
        return z

    kw = dict(n_probes=probes, steps=steps, key=0)
    rows.append(batched_row(
        gt_torch, f"(c) trace_funm log det poisson {n}x{n} + s·I, {probes} probes a lane, "
                  f"steps {steps}", gt_torch.trace_funm, fam_slq, likes,
        dict(f=torch.log, **kw), logdet_check, bound=3.0, rule=lockstep_launches,
        phase="phase 27", lane_args=(shifts,),
        lane_op=lambda k: (lambda v: fam_slq(v, shifts[k])), fields=(),
        outputs=("samples", "value", "stderr"), statuses=None,
        single=lambda a, x: gt_torch.trace_funm(a, torch.log, x, **kw)))

    n = P27_EVOLVE_N
    op_ev = gt_torch.poisson_operator(n)

    def fam_ev(v, s):
        return op_ev(v) + s * v

    s_ev, lam_ev = p27_poisson_lanes(n)
    u0_np = gen.standard_normal((lanes, n, n))
    f_np = gen.standard_normal((n, n))
    dt = 0.5
    kw = dict(dt=dt, n_steps=P27_EVOLVE_STEPS, steps=P27_FUNM_STEPS,
              forcing=torch.as_tensor(f_np, device=dev))

    def euler_check(k, out):
        lk = lam_ev + P27_SHIFTS[k]
        decay = np.exp(-P27_EVOLVE_STEPS * dt * lk)
        exact = (sine_apply(s_ev, u0_np[k], decay)
                 + sine_apply(s_ev, f_np, (1.0 - decay) / lk))
        return float(np.linalg.norm(out["u"] - exact) / np.linalg.norm(exact))

    rows.append(batched_row(
        gt_torch, f"(d) exponential_evolve poisson {n}x{n} + s·I, {P27_EVOLVE_STEPS} steps, "
                  "constant forcing", gt_torch.exponential_evolve, fam_ev,
        torch.as_tensor(u0_np, device=dev), kw, euler_check, bound=EXPM_ERROR,
        rule=lockstep_launches, phase="phase 27", lane_args=(shifts,),
        lane_op=lambda k: (lambda v: fam_ev(v, shifts[k])), fields=(),
        outputs=("u", "error_estimates"), statuses=None))
    return rows


def p27_theta_rows(gt_torch, dev):
    """(e) theta_evolve, Crank–Nicolson, dt 1, 5 steps: GCRO-DR(40, 10) with
    the σ-shifted convdiff cycle (σ = 1/(θΔt) = 2, built at γ (0.4, 0.2),
    shared) on convdiff 256² over γx P26_GAMMAS (γy 0.2), tol 1e-9; CG with
    the SPD shifted cycle for L + 2I over θΔt on Poisson 1024² + s·I, tol
    1e-10 (absolute, unit-norm u0s). Each lane held to its sequential run to the
    bit (states, per-step counts, statuses, residuals, trajectory), and
    each step's ‖rhs − S u‖/‖rhs‖ recomputed in numpy."""
    import numpy as np
    import torch

    rows = []
    n = P27_EVOLVE_N
    cd, g, coefs, _, _ = p26_convdiff(gt_torch, n, dev)
    gen = np.random.default_rng(SEED + 275)
    u0_np = gen.standard_normal((len(P26_GAMMAS), n, n))
    cyc = gt_torch.convection_diffusion_multigrid_preconditioner(n, 0.4, 0.2, shift=2.0)
    theta, dt = 0.5, 1.0

    def steps_check(u0s, apply_l):
        def check(k, out):
            prev, worst = u0s[k], 0.0
            for u in out["trajectory"]:
                rhs = prev - (1.0 - theta) * dt * apply_l(k, prev)
                r = rhs - (u + theta * dt * apply_l(k, u))
                worst = max(worst, float(np.linalg.norm(r) / np.linalg.norm(rhs)))
                prev = u
            return worst

        return check

    kw = dict(dt=dt, n_steps=P27_EVOLVE_STEPS, theta=theta, solver="gcrodr", tol=1e-9,
              restart=40, recycle_k=10, max_restarts=100, M=lambda r: cyc(r) / (theta * dt),
              save_trajectory=True)
    rows.append(batched_row(
        gt_torch, f"(e) theta_evolve gcrodr(40, 10) + σ-shifted cycle, convdiff {n}x{n} over "
                  f"γ {list(P26_GAMMAS)}, {P27_EVOLVE_STEPS} steps", gt_torch.theta_evolve,
        cd, torch.as_tensor(u0_np, device=dev), kw,
        steps_check(u0_np, lambda k, v: np_stencil_general(v.copy(), coefs[k])),
        bound=EVOLVE_MG_NUMPY, rule=between_launches, phase="phase 27", lane_args=(g,),
        lane_op=lambda k: (lambda v: cd(v, g[k])), fields=("status", "inner_total"),
        outputs=("u", "iterations", "statuses", "residuals", "trajectory")))

    n = P27_N
    op = gt_torch.poisson_operator(n)
    shifts = torch.tensor(P27_SHIFTS, dtype=torch.float64, device=dev)

    def fam(v, s):
        return op(v) + s * v

    u0_np = gen.standard_normal((len(P27_SHIFTS), n, n))
    u0_np /= np.linalg.norm(u0_np.reshape(len(P27_SHIFTS), -1), axis=1)[:, None, None]
    # S = θΔt·(L + σI), σ = 1/(θΔt) + s: the SPD cycle for L + 2I (shared by
    # the lanes) over θΔt, as gmres_tpu's theta_evolve docstring prescribes
    # for stiff steps (the plain Poisson cycle leaves M S's spectrum spread
    # over [1, 1 + σ/λ_min]: at 1024² CG stops at its 500-iteration cap).
    mg = gt_torch.helmholtz_shifted_laplacian_preconditioner(n, 1.0 / (theta * dt), shift=1.0)
    kw = dict(dt=dt, n_steps=P27_EVOLVE_STEPS, theta=theta, solver="cg", tol=1e-10,
              M=lambda r: mg(r) / (theta * dt), save_trajectory=True)
    rows.append(batched_row(
        gt_torch, f"(e) theta_evolve cg + mg, poisson {n}x{n} + s·I over s "
                  f"{list(P27_SHIFTS)}, {P27_EVOLVE_STEPS} steps", gt_torch.theta_evolve,
        fam, torch.as_tensor(u0_np, device=dev), kw,
        steps_check(u0_np, lambda k, v: np_stencil(v) + P27_SHIFTS[k] * v), bound=1e-8,
        rule=between_launches, phase="phase 27", lane_args=(shifts,),
        lane_op=lambda k: (lambda v: fam(v, shifts[k])), fields=("status", "inner_total"),
        outputs=("u", "iterations", "statuses", "residuals", "trajectory")))
    return rows


def p27_eig_rows(gt_torch, dev):
    """(f) LOBPCG + the Poisson V-cycle, k EIG_K, on Poisson 1024² + s·I over
    P27_SHIFTS (tol 0, rtol 1e-4, seeded start blocks): eigenvalues within
    1e-6 relative of the closed form; (g) Krylov–Schur on a complex basis,
    nev EIG_K, steps 40, tol 1e-8, on convdiff 256² over γ (γx, 0.01), γx in
    P27_EIG_GAMMAS (the eig program's start for every lane): every pair's
    ‖A x − λ x‖ recomputed in numpy under tol, eigenvalues within 1e-6
    relative of the closed form. Each lane held to its sequential run to
    the bit."""
    import numpy as np
    import torch

    from gmres_tpu_torch.benchmarks import cli
    from gmres_tpu_torch.models.convection_diffusion import (
        convection_diffusion_apply,
        convection_diffusion_coefs,
        convection_diffusion_eigenvalues,
    )

    rows = []
    n, k = P27_N, EIG_K
    op = gt_torch.poisson_operator(n)
    shifts = torch.tensor(P27_SHIFTS, dtype=torch.float64, device=dev)

    def fam(v, s):
        return op(v) + s * v

    x0 = torch.as_tensor(np.random.default_rng(SEED + 277).standard_normal(
        (len(P27_SHIFTS), k, n, n)), device=dev)
    exact = poisson_smallest(n, k)

    def lobpcg_check(lane, out):
        lam = np.sort(out["eigenvalues"])
        return float(np.max(np.abs(lam - (exact + P27_SHIFTS[lane])))) / float(np.max(lam))

    rows.append(batched_row(
        gt_torch, f"(f) lobpcg k {k} + mg poisson {n}x{n} + s·I over s {list(P27_SHIFTS)}, "
                  "rtol 1e-4", gt_torch.lobpcg, fam, x0,
        dict(tol=0.0, rtol=1e-4, M=gt_torch.poisson_multigrid_preconditioner(n)),
        lobpcg_check, bound=1e-6, rule=between_launches, phase="phase 27",
        lane_args=(shifts,), lane_op=lambda lane: (lambda v: fam(v, shifts[lane])),
        outputs=("eigenvalues", "x", "residuals")))

    n, tol = EIG_CD_N, 1e-8
    g = torch.tensor(P27_EIG_GAMMAS, dtype=torch.float64, device=dev)

    def cd(v, gx):
        return convection_diffusion_apply(v, gx, 0.01)

    probe = cli._program_normal((n, n), torch.float64, dev)
    probes = torch.stack([probe] * len(P27_EIG_GAMMAS))

    def arnoldi_check(lane, out):
        coefs = convection_diffusion_coefs(P27_EIG_GAMMAS[lane], 0.01)
        lam, x = out["eigenvalues"], out["x"]
        np_res = np.array([np.linalg.norm(np_complex_apply(x[i], coefs) - lam[i] * x[i])
                           for i in range(k)])
        want = convection_diffusion_eigenvalues(n, P27_EIG_GAMMAS[lane], 0.01)
        want = cli._keyed(want[np.argsort(-np.abs(want))][:k])
        err = float(np.max(np.abs(cli._keyed(lam) - want)))
        print(f"phase 27 (g): γx {P27_EIG_GAMMAS[lane]}: numpy residuals "
              f"{np.array2string(np_res, precision=3)} (tol {tol:g}), max |λ − closed form| "
              f"{err:.3e}", flush=True)
        require(err < 1e-6 * np.max(np.abs(want)),
                f"phase 27 (g) γx {P27_EIG_GAMMAS[lane]}: eigenvalues {err} from the closed form")
        return float(np.max(np_res)) / tol

    rows.append(batched_row(
        gt_torch, f"(g) arnoldi_eigs complex basis convdiff {n}x{n} over γ (γx, 0.01), γx "
                  f"{list(P27_EIG_GAMMAS)}, k {k} steps {EIG_STEPS}", gt_torch.arnoldi_eigs,
        cd, probes, dict(nev=k, steps=EIG_STEPS, which="LM", tol=tol, max_restarts=200),
        arnoldi_check, bound=1.0, rule=between_launches, phase="phase 27", lane_args=(g,),
        lane_op=lambda lane: (lambda v: cd(v, g[lane])),
        outputs=("eigenvalues", "x", "residuals")))
    return rows


def phase_batched_spectral(gt_torch, dev):
    """Phase 27: batched_solve over the eigensolvers, matrix functions and
    time steppers beside the same lanes run one after another. Returns the
    launches over the rows (each row's counts summed) and the rows."""
    t_phase = time.perf_counter()
    rows = (p27_rows_poisson(gt_torch, dev) + p27_theta_rows(gt_torch, dev)
            + p27_eig_rows(gt_torch, dev))
    launches = dict.fromkeys(mg_counters(), 0)
    for r in rows:
        for k, v in r["launches"].items():
            launches[k] += v
    require(all(launches[f"{k} batched"] > 0 for k in KERNELS),
            f"phase 27: a batched kernel was not launched on the main path {launches}")
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s; launches over the rows: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 28: the halo route's batched form (a block of rows of a row-sharded
# grid: one exchange and one launch, as gmres_tpu's jax.vmap makes).
# ---------------------------------------------------------------------------

P28_LANES = 8
P28_LANE_FORMS = ((1024, "float64"), (2048, "float32"))  # (a): 8 lanes each
# (b): route: (N, dtype); "split" is a block of (2, N, N) stacks on [Shard(2)].
P28_BLOCK = {"halo": (1024, "float64"), "split": (1024, "float64"),
             "rdma": (2048, "float32")}
P28_SPLIT_KH2, P28_SPLIT_DAMPING = 0.3, 0.2
P28_N, P28_S = POISSON_1024, 8   # (c): block CG's side and right-hand sides
P28_SEED = SEED + 28
P28_BCG_TOL = 1e-6               # block CG float64: absolute per right-hand side
P28_BCG_F32_TOL = 1e-1           # block CG float32 (RDMA route): absolute, ‖bᵢ‖ ~4.6e3
# (c) LOBPCG: k, tol, max_iterations. With cbpr2 as M at 1024² neither
# package converges in hundreds of iterations (gmres_tpu: not at 400 with
# tol 1e-6, nor at 300 with rtol 1e-2), so the row is held to gmres_tpu's
# status and cap, and its Ritz values to gmres_tpu's after the cap.
P28_LOBPCG = (EIG_K, 1e-6, 100)
# The capped Ritz values against gmres_tpu's, relative: mid-iteration, the
# two packages' rounding moves them by ~1e-4 after 100 iterations (5.6e-5 to
# 8.3e-5 on an H100 against gmres_tpu on the CPU).
P28_RITZ_BAND = 1e-3
P28_NYSTROM_RANK = 20
P28_SLQ = (SLQ_N, SLQ_PROBES[0], SLQ_STEPS)  # 512², 8 probes, 40 steps
P28_BAND = 2                     # the card's counts within 2 of gmres_tpu's CPU counts
P28_WALL_REPS = 5                # (b): the median of 5 block calls, and of 5 loops
# gmres_tpu's counts for (c), on the CPU at the same sizes on the same numpy
# inputs (scripts/jax_phase28_counts.py): {row: its JSON line}.
JAX_PHASE28 = {
    "block_cg": {"iterations": 876, "status": 0},
    "lobpcg": {"iterations": 100, "status": 1, "converged": False,
               "eigenvalues": [0.00022287788313975134, 0.00032467258099876345,
                               0.00035594897856387937, 0.0004178772439535989]},
    "nystrom": {"lam_ends": [6.020137368740048, 6.048131689082068]},
    "block_cg_rdma": {"iterations": 65, "status": 0},
}


def p28_jax(row):
    """(iterations, status) of gmres_tpu's run of a phase 28 row, or None
    where the table has none."""
    got = JAX_PHASE28.get(row)
    return None if got is None else (got["iterations"], got["status"])


def p28_inputs(kind: str):
    """(c)'s numpy inputs (scripts/jax_phase28_counts.py draws the same):
    block CG's right-hand sides (float64: standard normal; float32: A·x* for
    standard normal x*, whose true residual float32 can certify at
    P28_BCG_F32_TOL, where a standard normal b's smooth part makes x too
    large) and LOBPCG's start."""
    import numpy as np

    n, s = P28_N, P28_S
    seed, shape = {"bcg": (P28_SEED, (s, n, n)), "bcg_f32": (P28_SEED + 1, (s, n, n)),
                   "lobpcg": (P28_SEED + 2, (P28_LOBPCG[0], n, n))}[kind]
    a = np.random.default_rng(seed).standard_normal(shape)
    if kind == "bcg_f32":
        return np.stack([np_stencil(x) for x in a]).astype(np.float32)
    return a


def p28_counters(reset: bool = False) -> dict:
    """The halo route's launches (set to 0 first where `reset`): K1 (every
    launch), K1's halo form, K5, K8's interior and edges, each also on lane
    blocks ("… batched"), and the halo exchanges."""
    from gmres_tpu_torch.ops import fused, stencil, stencil_rdma
    from gmres_tpu_torch.parallel.halo import halo_exchange

    wrappers = {"K1": stencil.stencil5_cuda, "K1 halo": stencil.stencil_5pt_pallas_halo,
                "K5": fused.cheb2_cuda, "K8 interior": stencil_rdma.rdma_interior_cuda,
                "K8 edges": stencil_rdma.rdma_edges_cuda}
    if reset:
        for w in wrappers.values():
            w.launches = w.batched_launches = 0
        halo_exchange.exchanges = 0
    out = {name: w.launches for name, w in wrappers.items()}
    out.update({f"{name} batched": w.batched_launches for name, w in wrappers.items()})
    out["exchanges"] = halo_exchange.exchanges
    return out


def lanes_conv(x, top, bot, coefs7):
    """The lane forms' yardstick: one F.conv2d over the lanes (the batch) of
    the rows with their halo rows concatenated (zero rows for a null side,
    built here, outside the timed call), padded only at the sides:
    a·x + b·A(x) with per-lane halo rows."""
    import torch
    import torch.nn.functional as F

    c0, cw, ce, cs, cn, a, b = coefs7
    w = torch.tensor([[0.0, b * cs, 0.0], [b * cw, a + b * c0, b * ce],
                      [0.0, b * cn, 0.0]], dtype=x.dtype, device=x.device).reshape(1, 1, 3, 3)
    zero = torch.zeros_like(x[:, :1])
    ext = torch.cat([zero if top is None else top, x, zero if bot is None else bot], dim=1)
    return lambda: F.conv2d(ext[:, None], w, padding=(0, 1))[:, 0]


def p28_kernels(dev):
    """(a) K1's halo form, K5 and K8's interior and edges on 8 lanes of
    1024² float64 and 2048² float32, with random per-lane halo rows and with
    a null side: each bitwise against its 8 single launches and against its
    plain lane form, with device ms by CUDA-graph replay, the bound and one
    F.conv2d over the lanes."""
    import numpy as np
    import torch

    from gmres_tpu_torch.ops import fused, stencil
    from gmres_tpu_torch.ops import stencil_rdma as rd

    gen = np.random.default_rng(P28_SEED)
    coefs = GENERAL_COEFS
    d, alpha = fused.chebyshev_ref_scalars(*REF_EIG)
    records = {"K1 halo lanes": [], "K5 lanes": [], "K8 interior lanes": [],
               "K8 edges lanes": []}
    print("phase 28 (a): K1's halo form, K5 and K8 on lane blocks with per-lane halo rows, "
          "against 8 single launches and their plain lane forms", flush=True)
    lanes = P28_LANES
    for n, dts in P28_LANE_FORMS:
        dt = getattr(torch, dts)
        item = torch.empty((), dtype=dt).element_size()
        xb = torch.as_tensor(gen.standard_normal((lanes, n, n))).to(dev, dt)
        tops = torch.as_tensor(gen.standard_normal((lanes, 1, n))).to(dev, dt)
        bots = torch.as_tensor(gen.standard_normal((lanes, 1, n))).to(dev, dt)
        reps = 20 if n >= 2048 else 50
        scal = fused.cheb2_scalars(d, alpha, coefs, dt)
        c_op = rd._coefs7((*coefs, 0.0, 1.0), dt)
        c_m = rd._coefs7((*coefs, 1.0 / d + alpha, -alpha / d), dt)
        tag = f"{lanes}x{n}x{n} {'f32' if dt == torch.float32 else 'f64'}"

        def lane(h, k):
            return None if h is None else h[k]

        for sides, top, bot in (("random halo rows", tops, bots),
                                ("null bottom", tops, None)):
            halo_bytes = item * n * lanes * (2 if bot is not None else 1)
            records["K1 halo lanes"].append(p24_kernel_row(
                f"K1 halo lanes {tag} {sides}",
                lambda: stencil.stencil5_cuda(xb, top, bot, coefs),
                lambda: [stencil.stencil5_cuda(xb[k], lane(top, k), lane(bot, k), coefs)
                         for k in range(lanes)],
                lambda: stencil.stencil_5pt_halo(xb, top, bot, coefs), 0.0,
                (2 * lanes * n * n * item + halo_bytes, 9 * lanes * n * n, dt), reps,
                library=lanes_conv(xb, top, bot, (*coefs, 0.0, 1.0))))
            records["K5 lanes"].append(p24_kernel_row(
                f"K5 lanes {tag} {sides}",
                lambda: fused.cheb2_apply(xb, top, bot, scal),
                lambda: [fused.cheb2_apply(xb[k], lane(top, k), lane(bot, k), scal)
                         for k in range(lanes)],
                lambda: fused.cheb2_plain(xb, top, bot, scal), 0.0,
                (2 * lanes * n * n * item + halo_bytes, 14 * lanes * n * n, dt), reps,
                library=lanes_conv(xb, top, bot, (*coefs, 1.0 / d + alpha, -alpha / d))))
            # The edge step works in place: each call adds the corrections to
            # its own buffer again, the first to the interior's output.
            y0 = rd.rdma_interior_cuda(xb, c_m)
            yw, yp, ys = y0.clone(), y0.clone(), [y0[k].clone() for k in range(lanes)]
            records["K8 edges lanes"].append(p24_kernel_row(
                f"K8 edges lanes {tag} {sides} cbpr2",
                lambda: rd.rdma_edges_cuda(yw, top, bot, c_m),
                lambda: [rd.rdma_edges_cuda(ys[k], lane(top, k), lane(bot, k), c_m)
                         for k in range(lanes)],
                lambda: rd.rdma_edges_plain(yp, top, bot, c_m), 0.0,
                (2 * halo_bytes + halo_bytes, 2 * lanes * n * (2 if bot is not None else 1),
                 dt), reps))
        for label, c in (("operator", c_op), ("cbpr2", c_m)):
            records["K8 interior lanes"].append(p24_kernel_row(
                f"K8 interior lanes {tag} {label}",
                lambda: rd.rdma_interior_cuda(xb, c),
                lambda: [rd.rdma_interior_cuda(xb[k], c) for k in range(lanes)],
                lambda: rd.rdma_interior_plain(xb, c), 0.0,
                (2 * lanes * n * n * item, 12 * lanes * n * n, dt), reps,
                library=lanes_conv(xb, None, None, c)))
    return records


def p28_wall(fn, reps=P28_WALL_REPS) -> float:
    """The median host wall of `reps` calls of fn, each to a synchronisation."""
    import numpy as np
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def p28_block_applications(gt_torch, dev, mesh):
    """(b) One block application of 8 rows placed [Shard(1)] through
    row_apply, beside the same rows applied one by one: the halo operator
    (K1's halo form), the halo cbpr2 (K5) and the order-4 halo Chebyshev at
    1024² float64, the split Helmholtz operator on 8 (2, 1024, 1024)
    float64 stacks placed [Shard(2)] (two launches of K1's halo form, one a
    plane), the RDMA operator and cbpr2 (K8) at 2048² float32. Held: the
    block makes one row's exchanges and launches (lane launches), the rows
    s times as many; the profiler's kernels a block application equal to a
    row's (device_events; the split block's two more: each plane's lanes
    made contiguous); each row bitwise its own call. The walls of both are
    printed."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply
    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )

    gen = np.random.default_rng(P28_SEED + 3)
    s = P28_S
    blocks = {}
    for route, (n, dts) in P28_BLOCK.items():
        stack = (2,) if route == "split" else ()
        dim = 1 + len(stack)
        x = torch.as_tensor(gen.standard_normal((s,) + stack + (n, n))).to(
            dev, getattr(torch, dts))
        blocks[route] = (x, distribute_tensor(x, mesh, [Shard(dim)]),
                         [distribute_tensor(x[i], mesh, [Shard(dim - 1)]) for i in range(s)])
    split = gt_torch.helmholtz_split_operator(P28_BLOCK["split"][0], P28_SPLIT_KH2,
                                              damping=P28_SPLIT_DAMPING)
    # (label, operator, route, exchanges, launches, kernel, the block's
    # kernels beyond a row's)
    cases = (
        ("halo operator", gt_torch.halo_poisson_operator(mesh), "halo", 1, 1, "K1 halo", 0),
        ("halo cbpr2", gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG), "halo", 1,
         1, "K5", 0),
        ("halo chebyshev order 4",
         gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG, order=4), "halo", 3, 3,
         "K1 halo", 0),
        ("helmholtz split operator", split, "split", 1, 2, "K1 halo", 2),
        ("rdma operator", rdma_stencil_operator(mesh), "rdma", 1, 1, "K8 interior", 0),
        ("rdma cbpr2", rdma_chebyshev_preconditioner(mesh, *REF_EIG), "rdma", 1, 1,
         "K8 interior", 0),
    )
    out = []
    for label, op, route, per, launches, kernel, extra in cases:
        x, blk, rows = blocks[route]
        n, dts = P28_BLOCK[route]
        tag = f"phase 28 (b) {label} {'x'.join(map(str, x.shape))} {dts}"

        def block():
            return row_apply(op, blk)

        def one_by_one():
            return [op(r) for r in rows]

        block()
        one_by_one()
        p28_counters(reset=True)
        y = block()
        torch.cuda.synchronize()
        count = p28_counters()
        p28_counters(reset=True)
        ys = one_by_one()
        torch.cuda.synchronize()
        count_rows = p28_counters()
        bitwise = all(torch.equal(y.to_local()[i], ys[i].to_local()) for i in range(s))
        wall, wall_rows = p28_wall(block), p28_wall(one_by_one)
        kernels, kernels_row = device_events(block), device_events(lambda: op(rows[0]))
        print(f"{tag}: block {count['exchanges']} exchanges, {count[kernel]} {kernel} "
              f"launches ({count[kernel + ' batched']} on the lane block), {kernels} kernels "
              f"(profiler); one by one {count_rows['exchanges']} exchanges, "
              f"{count_rows[kernel]} launches, a row {kernels_row} kernels; rows bitwise "
              f"{bitwise}; wall block {wall * 1e3:.3f} ms, rows one by one "
              f"{wall_rows * 1e3:.3f} ms ({wall_rows / wall:.2f}x)", flush=True)
        require(bitwise, f"{tag}: a row differs from its own call")
        require(count["exchanges"] == per
                and count[kernel] == count[kernel + " batched"] == launches,
                f"{tag}: block {count}")
        require(count_rows["exchanges"] == s * per and count_rows[kernel] == s * launches
                and count_rows[kernel + " batched"] == 0, f"{tag}: rows {count_rows}")
        require(count["K8 edges"] == count_rows["K8 edges"] == 0, f"{tag}: edge launches "
                "on one rank")
        require(kernels == kernels_row + extra, f"{tag}: {kernels} kernels a block "
                f"application, {kernels_row} a row's (+{extra} expected)")
        out.append({"label": label, "rows": s, "side": n, "dtype": dts, "count": count,
                    "count_rows": count_rows, "kernels": kernels, "kernels_row": kernels_row,
                    "wall_s": wall, "wall_rows_s": wall_rows})
    return out


def p28_solver_row(label, sharded, twin, counts, jax_counts, check, lanes_kernels,
                   warm=True):
    """One solver row of (c) on the one-rank mesh: the twin on plain tensors
    (the same operators on the rank's own block), then the row on the
    sharded block, each after an untimed run where `warm` (the rows of
    seconds go without: a first call's one-time costs are small beside
    them), timed to a synchronisation,
    the launch counts set to 0 just before and read just after. Held: the
    counts equal the twin's and, where `jax_counts` is given, (iterations
    within P28_BAND, status equal) gmres_tpu's; `check(res, twin)` true;
    each of `lanes_kernels` launched on lane blocks, and every exchange of
    the row followed by one launch of K1's halo form, K5 or K8."""
    import torch

    tag = f"phase 28 (c) {label}"
    walls, results, cnts = {}, {}, {}
    for key, call in (("twin", twin), ("row", sharded)):
        if warm:
            call()
        p28_counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[key] = call()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        cnts[key] = p28_counters()
    res, tw = results["row"], results["twin"]
    count = cnts["row"]
    got, want = counts(res), counts(tw)
    lane_launches = sum(count[f"{k} batched"] for k in ("K1 halo", "K5", "K8 interior"))
    print(f"{tag}: counts {got} (twin on plain tensors {want}; gmres_tpu {jax_counts}); "
          f"wall {walls['row']:.4f} s, twin {walls['twin']:.4f} s "
          f"({walls['row'] / walls['twin']:.2f}x); launches "
          + ", ".join(f"{k} {v}" for k, v in count.items()), flush=True)
    require(got == want, f"{tag}: counts {got}, twin {want}")
    if jax_counts is not None:
        require(got[-1] == jax_counts[-1] and abs(got[0] - jax_counts[0]) <= P28_BAND,
                f"{tag}: counts {got}, gmres_tpu {jax_counts}")
    require(check(res, tw), f"{tag}: check failed")
    for k in lanes_kernels:
        require(count[f"{k} batched"] > 0, f"{tag}: {k} not launched on a lane block")
    require(count["exchanges"] == count["K1 halo"] + count["K5"] + count["K8 interior"]
            and lane_launches > 0, f"{tag}: exchanges and launches {count}")
    return {"label": label, "counts": got, "twin_counts": want, "jax_counts": jax_counts,
            "wall_s": walls["row"], "twin_wall_s": walls["twin"], "count": count,
            "twin_count": cnts["twin"]}


def p28_solver_rows(gt_torch, dev, mesh):
    """(c) block CG (halo operator + halo cbpr2, 1024² float64, s 8), LOBPCG
    (halo operator, halo cbpr2 as M, 1024², k 4), the Nyström build on the
    halo operator (1024², rank 20), trace_funm on a sharded 512² x_like
    (8 probes) and block CG on the RDMA route (1024² float32, s 8), each
    beside its twin on plain tensors."""
    import numpy as np
    import torch

    from gmres_tpu_torch.parallel.halo import (
        rdma_chebyshev_preconditioner,
        rdma_stencil_operator,
    )
    from gmres_tpu_torch.solvers import funm
    from gmres_tpu_torch.solvers.lanczos import arnoldi_factorization

    def blk(a):
        from torch.distributed.tensor import Shard, distribute_tensor

        return distribute_tensor(torch.as_tensor(a).to(dev), mesh, [Shard(1)])

    def rel(a, b):
        a, b = whole(a).detach().cpu().numpy(), whole(b).detach().cpu().numpy()
        return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)

    rows = []
    n = P28_N
    op = gt_torch.halo_poisson_operator(mesh)
    plain_op = gt_torch.poisson_operator(n)
    cbpr2 = gt_torch.halo_chebyshev_preconditioner(mesh, *REF_EIG)
    b = p28_inputs("bcg")

    def residual_ok(b_np, tol, scale=1.0):
        """Status 0 and each column's numpy float64 ‖bᵢ − A xᵢ‖ under
        scale·tol (tol absolute, as block CG takes it)."""
        def check(res, twin):
            xs = whole(res.x).double().cpu().numpy()
            worst = max(float(np.linalg.norm(b_k - np_stencil(x_k)))
                        for b_k, x_k in zip(b_np.astype(np.float64), xs))
            print(f"  numpy ‖bᵢ − A xᵢ‖ at most {worst:.3e} (tol {tol:g}); x against the "
                  f"twin {rel(res.x, twin.x):.3e}", flush=True)
            return res.status == 0 and worst <= scale * tol
        return check

    rows.append(p28_solver_row(
        f"block_cg halo operator + halo cbpr2 {n}x{n} f64 s {P28_S}",
        lambda: gt_torch.block_cg(op, blk(b), tol=P28_BCG_TOL, M=cbpr2),
        lambda: gt_torch.block_cg(plain_op, torch.as_tensor(b).to(dev), tol=P28_BCG_TOL,
                                  M=cbpr2),
        lambda r: (r.iterations, r.status), p28_jax("block_cg"),
        residual_ok(b, P28_BCG_TOL, 1.01), ("K1 halo", "K5"), warm=False))
    k, tol, cap = P28_LOBPCG
    x0 = p28_inputs("lobpcg")
    _, lam_exact = p27_poisson_lanes(n)
    exact = np.sort(lam_exact.reshape(-1))[:k]
    jrow = JAX_PHASE28.get("lobpcg")

    def eig_ok(res, twin):
        """Converged: λ within 1e-6 of the closed form. At the cap (as
        gmres_tpu): Ritz values above the eigenvalues (Courant–Fischer) and
        within P28_RITZ_BAND of gmres_tpu's after the same iterations."""
        lam = res.eigenvalues.cpu().numpy()
        gap = float(np.max(np.abs(lam - exact) / exact))
        jgap = (float(np.max(np.abs(lam - np.array(jrow["eigenvalues"]))
                             / np.array(jrow["eigenvalues"]))) if jrow else None)
        print(f"  λ {np.array2string(lam, precision=10)} against the closed form "
              f"{np.array2string(exact, precision=10)} ({gap:.2e} relative), gmres_tpu's "
              f"{jgap} relative; twin {rel(res.eigenvalues, twin.eigenvalues):.2e}",
              flush=True)
        if res.status == 0:
            return gap <= 1e-6
        return bool(np.all(lam >= exact)) and (jgap is None or jgap <= P28_RITZ_BAND)

    rows.append(p28_solver_row(
        f"lobpcg halo operator + halo cbpr2 {n}x{n} k {k}",
        lambda: gt_torch.lobpcg(op, blk(x0), tol=tol, max_iterations=cap, M=cbpr2),
        lambda: gt_torch.lobpcg(plain_op, torch.as_tensor(x0).to(dev), tol=tol,
                                max_iterations=cap, M=cbpr2),
        lambda r: (r.iterations, r.status), p28_jax("lobpcg"), eig_ok, ("K1 halo", "K5")))
    r = P28_NYSTROM_RANK
    jlam = JAX_PHASE28.get("nystrom", {}).get("lam_ends")

    def nystrom_ok(res, twin):
        lam, lam_t = res[1].cpu().numpy(), twin[1].cpu().numpy()
        ends = np.array([lam[-1], lam[0]])
        print(f"  λ̂ ends {np.array2string(ends, precision=6)} (gmres_tpu's "
              f"{jlam}, held to {NYSTROM_LAM_BAND:g} relative); twin "
              f"{float(np.max(np.abs(lam - lam_t)) / lam_t[0]):.2e}", flush=True)
        ok = float(np.max(np.abs(lam - lam_t)) / lam_t[0]) <= 1e-10
        if jlam is not None:
            ok = ok and bool(np.all(np.abs(ends - np.array(jlam)) <= NYSTROM_LAM_BAND
                                    * np.array(jlam)))
        return ok

    zeros = torch.zeros((n, n), dtype=torch.float64, device=dev)
    rows.append(p28_solver_row(
        f"nystrom build halo operator {n}x{n} rank {r}",
        lambda: gt_torch.nystrom_preconditioner(op, gt_torch.shard_grid_vector(zeros, mesh),
                                                rank=r),
        lambda: gt_torch.nystrom_preconditioner(plain_op, zeros, rank=r),
        lambda res: (res[1].shape[0],), None, nystrom_ok, ("K1 halo",), warm=False))
    m, probes, steps = P28_SLQ
    slq_op, plain_op_slq = gt_torch.halo_poisson_operator(mesh), gt_torch.poisson_operator(m)
    like = torch.zeros((m, m), dtype=torch.float64, device=dev)
    like_sh = gt_torch.shard_grid_vector(like, mesh)
    c = 2.0 - 2.0 * np.cos(np.arange(1, m + 1) * np.pi / (m + 1))
    logdet = float(np.sum(np.log(c[:, None] + c[None, :])))

    def slq_ok(res, twin):
        z = funm.shard_rows_like(funm._rademacher(probes, (m, m), like.dtype, dev, 0), like_sh)
        hosts = [arnoldi_factorization(slq_op, z[i], steps)[1].to("cpu", torch.float64)
                 for i in range(probes)]
        seq = funm._trace_result(torch.log, z, hosts, steps, like_sh, probes)
        same = torch.equal(res.samples.cpu(), seq.samples.cpu())
        value, stderr = float(res.value), float(res.stderr)
        print(f"  log det {value:.6f} ± {stderr:.6f}, closed form {logdet:.6f} "
              f"({abs(value - logdet) / stderr:.2f} stderr); samples bitwise the probes one "
              f"by one {same}; host syncs {res.host_syncs}", flush=True)
        return same and abs(value - logdet) < 3 * stderr and res.host_syncs == 1

    rows.append(p28_solver_row(
        f"trace_funm log det halo operator {m}x{m} x_like [Shard(0)], {probes} probes, "
        f"{steps} steps",
        lambda: gt_torch.trace_funm(slq_op, torch.log, like_sh, n_probes=probes, steps=steps),
        lambda: gt_torch.trace_funm(plain_op_slq, torch.log, like, n_probes=probes,
                                    steps=steps),
        lambda res: (res.samples.shape[0],), None, slq_ok, ("K1 halo",)))
    rd_op, rd_m = rdma_stencil_operator(mesh), rdma_chebyshev_preconditioner(mesh, *REF_EIG)
    b32 = p28_inputs("bcg_f32")
    rows.append(p28_solver_row(
        f"block_cg rdma operator + rdma cbpr2 {n}x{n} f32 s {P28_S}",
        lambda: gt_torch.block_cg(rd_op, blk(b32), tol=P28_BCG_F32_TOL, M=rd_m),
        lambda: gt_torch.block_cg(rd_op, torch.as_tensor(b32).to(dev), tol=P28_BCG_F32_TOL,
                                  M=rd_m),
        lambda r: (r.iterations, r.status), p28_jax("block_cg_rdma"),
        residual_ok(b32, P28_BCG_F32_TOL, 2.0), ("K8 interior",)))
    return rows


def phase_halo_blocks(gt_torch, dev, workdir, kernels=True):
    """Phase 28: (a) the lane forms (where `kernels`), then on a one-rank
    NCCL group (b) the block applications and (c) the solver rows. Returns
    (a)'s records, the launches over (b) and (c), and the rows."""
    t_phase = time.perf_counter()
    records = p28_kernels(dev) if kernels else {}
    with one_rank_group(workdir, "rendezvous28"):
        mesh = gt_torch.solver_mesh(1)
        blocks = p28_block_applications(gt_torch, dev, mesh)
        rows = p28_solver_rows(gt_torch, dev, mesh)
    launches = dict.fromkeys(p28_counters(), 0)
    for r in blocks:
        for k, v in r["count"].items():
            launches[k] += v
    for r in rows:
        for k, v in r["count"].items():
            launches[k] += v
    for k in ("K1 halo", "K5", "K8 interior"):
        require(launches[f"{k} batched"] > 0, f"phase 28: {k} was not launched on a lane "
                f"block on the main path ({launches})")
    print(f"phase 28: {time.perf_counter() - t_phase:.1f} s; launches over (b) and (c): "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return records, launches, blocks + rows


# ---------------------------------------------------------------------------
# Phase 29: the distributed V-cycle and the sparse operators' rank rows on a
# sharded block of rows (one exchange a sharded-level application and one
# all-gather a block, as gmres_tpu's jax.vmap makes them).
# ---------------------------------------------------------------------------

P29_S = 8                        # rows in a block
P29_SEED = SEED + 29
P29_POISSON = (2048, "float32")  # (a): the mesh= Poisson cycle, mg 2048²'s dtype
P29_BELOW = 512                  # (a): its replicate_below: 256² and below whole
P29_NONE_N = 300                 # (a): the mesh=None cycle on a DTensor (mg 300²)
P29_CD_N = 1024                  # (a): BASELINE config 3's cycle (auto, float32 inside)
P29_CSL = (512, "float32")       # (a): the split CSL cycle, phase 19's 512² f32
P29_3D_N = 128                   # (a): the 3-D cycle (phase 18's 128³)
P29_HYB_N, P29_SPMV_N = 1000, 512   # (b): HYB f64; CSR, COO, ELL f64
P29_DIA = (2048, "float32")      # (b): DIA
P29_BCG = (1024, 8, 1e-6)        # (c): block CG + the mesh= cycle: side, s, abs tol
P29_LOBPCG = (1024, EIG_K, 1e-4, 200)   # (c): side, k, rtol, cap (phase 20's)
P29_HYB_BCG = (1000, 4, 1e-6)    # (c): block CG + cbpr2 on HYB: side, s, abs tol
P29_BAND = 2                     # the card's counts within 2 of gmres_tpu's CPU counts
P29_WALL_REPS = 5                # (a): medians of 5 block calls and of 5 loops
P29_KERNELS = ("K1", "K1 halo", "K1rr", "K1cr", "K2", "K3", "K4")
# gmres_tpu's counts for (c), on the CPU at the same sizes on the same numpy
# inputs (scripts/jax_phase29_counts.py): {row: its JSON line}.
JAX_PHASE29 = {
    "block_cg_mg": {"iterations": 13, "status": 0},
    "lobpcg_mg": {"iterations": 21, "status": 0, "converged": True,
                  "eigenvalues": [1.87880483994012e-05, 4.6970032750812776e-05,
                                  4.697003275081292e-05, 7.51520171023446e-05]},
    "block_cg_hyb": {"iterations": 1124, "status": 0},
}


def p29_inputs(kind: str):
    """(c)'s numpy inputs (scripts/jax_phase29_counts.py draws the same):
    the right-hand sides of block CG with the cycle (s, n, n) and on HYB (s,
    n²), standard normal, and LOBPCG's start (k, n, n)."""
    import numpy as np

    n, s, _ = P29_BCG
    seed, shape = {"bcg": (P29_SEED, (s, n, n)),
                   "lobpcg": (P29_SEED + 1, (P29_LOBPCG[1],) + (P29_LOBPCG[0],) * 2),
                   "bcg_hyb": (P29_SEED + 2, (P29_HYB_BCG[1], P29_HYB_BCG[0] ** 2))}[kind]
    return np.random.default_rng(seed).standard_normal(shape)


def p29_counters(reset: bool = False) -> dict:
    """p23_counters with each kernel's launches on lane blocks ("… batched":
    K1's halo form's apart from K1's)."""
    from gmres_tpu_torch.ops import sparse, stencil

    wrappers = {"K1 halo": stencil.stencil_5pt_pallas_halo, "K3": sparse.dia_spmv_cuda,
                "K4": sparse.bsr_spmv_cuda}
    if reset:
        for w in wrappers.values():
            w.batched_launches = 0
    out = p23_counters(reset)
    out.update({f"{name} batched": w.batched_launches for name, w in wrappers.items()})
    return out


def p29_block_row(label, fn, x, dim, mesh, *, gathers, needs, extra_kernels=0,
                  same_kernels=True, rtol=0.0):
    """One block application: `fn` on the (8, …) block x placed
    [Shard(dim)] through row_apply, beside its rows placed [Shard(dim − 1)]
    one by one, each after an untimed call, the counts set to 0 just before
    and read just after. Held: each row bitwise its own call (where `rtol`
    is 0; else within it, relative to the row's largest entry); the block's
    exchanges and explicit all-gathers one row's (`gathers` all-gathers);
    every kernel's launches one row's, all on lane blocks (the rows' none);
    each kernel of `needs` launched; and, where `same_kernels`, the
    profiler's kernels a block application a row's plus `extra_kernels`
    (copies of the lanes' strided planes). The walls of both are printed."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from gmres_tpu_torch.ops.blas import row_apply

    s = x.shape[0]
    blk = distribute_tensor(x, mesh, [Shard(dim)])
    rows = [distribute_tensor(x[i], mesh, [Shard(dim - 1)]) for i in range(s)]
    tag = f"phase 29 {label} {'x'.join(map(str, x.shape))} {str(x.dtype)[6:]}"

    def block():
        return row_apply(fn, blk)

    def one_by_one():
        return [fn(r) for r in rows]

    block()
    one_by_one()
    counts = {}
    for key, call in (("block", block), ("rows", one_by_one)):
        calls = {"all-gathers": 0}
        p29_counters(reset=True)
        with counted_all_gathers(calls):
            out = call()
            torch.cuda.synchronize()
        counts[key] = {**p29_counters(), "all-gathers": calls["all-gathers"]}
        if key == "block":
            y = out.to_local()
        else:
            ys = [r.to_local() for r in out]
    count, count_rows = counts["block"], counts["rows"]
    gap = max(float((y[i] - ys[i]).abs().max() / ys[i].abs().max()) for i in range(s))
    bitwise = all(torch.equal(y[i], ys[i]) for i in range(s))
    wall, wall_rows = p28_wall(block, P29_WALL_REPS), p28_wall(one_by_one, P29_WALL_REPS)
    kernels, kernels_row = device_events(block), device_events(lambda: fn(rows[0]))
    launched = {k: count[k] for k in P29_KERNELS if count[k]}
    print(f"{tag}: block {count['exchanges']} exchanges, {count['all-gathers']} "
          f"all-gathers, launches {launched} (on lane blocks "
          f"{ {k: count[k + ' batched'] for k in launched} }), "
          f"{kernels} kernels (profiler); one by one {count_rows['exchanges']} exchanges, "
          f"{count_rows['all-gathers']} all-gathers, launches "
          f"{ {k: count_rows[k] for k in P29_KERNELS if count_rows[k]} }, a row {kernels_row} "
          f"kernels; rows bitwise {bitwise} (largest gap {gap:.2e}); wall block "
          f"{wall * 1e3:.3f} ms, rows one by one "
          f"{wall_rows * 1e3:.3f} ms ({wall_rows / wall:.2f}x)", flush=True)
    require(bitwise if rtol == 0.0 else gap <= rtol,
            f"{tag}: a row differs from its own call by {gap:.2e} (held to {rtol:g})")
    require(count["all-gathers"] == gathers and count_rows["all-gathers"] == s * gathers,
            f"{tag}: all-gathers {count['all-gathers']}, rows {count_rows['all-gathers']}")
    require(count_rows["exchanges"] == s * count["exchanges"],
            f"{tag}: exchanges {count['exchanges']}, rows {count_rows['exchanges']}")
    for k in P29_KERNELS:
        require(count_rows[k] == s * count[k], f"{tag}: {k} {count[k]}, rows {count_rows[k]}")
        require(count[f"{k} batched"] == count[k] and count_rows[f"{k} batched"] == 0,
                f"{tag}: {k} on lane blocks {count[f'{k} batched']} of {count[k]}, rows "
                f"{count_rows[f'{k} batched']}")
    for k in needs:
        require(count[k] > 0, f"{tag}: {k} not launched")
    if same_kernels:
        require(kernels == kernels_row + extra_kernels,
                f"{tag}: {kernels} kernels a block application, {kernels_row} a row's "
                f"(+{extra_kernels} expected)")
    return {"label": label, "shape": list(x.shape), "dtype": str(x.dtype)[6:], "count": count,
            "count_rows": count_rows, "kernels": kernels, "kernels_row": kernels_row,
            "wall_s": wall, "wall_rows_s": wall_rows}


def p29_cycles(gt_torch, dev, mesh):
    """(a) One row_apply of 8 rows of each distributed cycle beside the rows
    one by one: the mesh= Poisson cycle at 2048² float32 with
    replicate_below at its default (every level sharded on one rank: K1's
    halo form on lanes only) and at 512 (one all-gather; 256² and below
    once under vmap: K1rr, K1cr and K2 on lane blocks); the mesh=None cycle
    on a DTensor at 300²; BASELINE config 3's convection–diffusion cycle
    (auto smoother, float32 inside) at 1024²; the split CSL cycle at 512²
    float32 (8 stacks placed [Shard(2)]: two K1 halo lane launches an
    exchange, each plane's lanes copied contiguous); the 3-D cycle at 128³
    (plain torch)."""
    import numpy as np
    import torch

    gen = np.random.default_rng(P29_SEED + 3)
    s = P29_S

    def block(shape, dts):
        return torch.as_tensor(gen.standard_normal((s,) + shape)).to(dev, getattr(torch, dts))

    rows = []
    n, dts = P29_POISSON
    x = block((n, n), dts)
    for below, gathers, needs in ((None, 0, ("K1 halo",)),
                                  (P29_BELOW, 1, ("K1 halo", "K1rr", "K1cr", "K2"))):
        m = gt_torch.poisson_multigrid_preconditioner(n, mesh=mesh, replicate_below=below)
        rows.append(p29_block_row(
            f"(a) mesh= poisson cycle replicate_below {below} (levels {m.replicate_from} of "
            f"{m.levels} sharded)", m, x, 1, mesh, gathers=gathers, needs=needs,
            extra_kernels=2 * gathers))
    n = P29_NONE_N
    rows.append(p29_block_row("(a) mesh=None poisson cycle on a DTensor",
                              gt_torch.poisson_multigrid_preconditioner(n),
                              block((n, n), "float64"), 1, mesh, gathers=0,
                              needs=("K1 halo",)))
    n = P29_CD_N
    m = gt_torch.convection_diffusion_multigrid_preconditioner(
        n, 0.4, 0.2, mesh=mesh, smoother="auto", internal_dtype=torch.float32)
    rows.append(p29_block_row("(a) mesh= convdiff cycle (BASELINE config 3: auto, float32 "
                              "inside)", m, block((n, n), "float64"), 1, mesh, gathers=0,
                              needs=("K1 halo",)))
    n, dts = P29_CSL
    kh2 = HELM_FACTOR * gt_torch.helmholtz_lambda_min(n, 0.0)
    m = gt_torch.csl_multigrid_preconditioner(n, kh2, layout="split", mesh=mesh)
    x = block((2, n, n), dts)
    rows.append(p29_block_row("(a) mesh= split CSL cycle, stacks [Shard(2)]", m, x, 2, mesh,
                              gathers=0, needs=("K1 halo",), same_kernels=False))
    csl = rows[-1]
    require(csl["count"]["K1 halo"] == 2 * csl["count"]["exchanges"],
            f"phase 29 split CSL: {csl['count']['K1 halo']} K1 halo launches for "
            f"{csl['count']['exchanges']} exchanges (two a stencil)")
    require(csl["kernels"] == csl["kernels_row"] + csl["count"]["K1 halo"],
            f"phase 29 split CSL: {csl['kernels']} kernels a block, {csl['kernels_row']} a "
            f"stack's (+{csl['count']['K1 halo']} expected: a plane's lanes copied a launch)")
    n = P29_3D_N
    rows.append(p29_block_row("(a) mesh= 3-D cycle (plain torch)",
                              gt_torch.poisson3d_multigrid_preconditioner(n, mesh=mesh),
                              block((n, n, n), "float64"), 1, mesh, gathers=0, needs=()))
    return rows


def p29_sparse(gt_torch, dev, mesh):
    """(b) One row_apply of each sparse operator to 8 rows placed [Shard(1)]
    beside the rows one by one: HYB 1000² float64 and DIA 2048² float32 (one
    exchange, one K3 lane launch), BSR of 16 block rows of 128² float32 (one
    exchange, one K4 lane launch), CSR, COO and ELL 512² float64 (one
    all-gather of the (8, n) block, plain torch; the lanes' transposes two
    more kernels, and vmap's gathers, so their kernels are printed, not
    held). CSR and COO sum into their rows with index_add, which on the
    card adds in atomic order, so a block's rows are held to phase 23's
    1e-12 of their own calls, not to their bits."""
    import torch

    from gmres_tpu_torch.ops.sparse import csr_row_ids

    gen = torch.Generator(device=dev).manual_seed(P29_SEED + 4)
    n = P29_SPMV_N
    csr = gt_torch.poisson_csr(n, device=dev)
    mats = {"hyb f64": gt_torch.csr_to_hyb(gt_torch.poisson_csr(P29_HYB_N, device=dev)),
            "dia f32": cast_dia(gt_torch, gt_torch.poisson_dia(P29_DIA[0], device=dev),
                                torch.float32),
            "bsr f32": block_tridiagonal(gt_torch, *P23_BSR, torch.float32, dev, gen),
            "csr f64": csr,
            "coo f64": gt_torch.COOMatrix(data=csr.data, row=csr_row_ids(csr),
                                          col=csr.indices, shape=csr.shape),
            "ell f64": gt_torch.csr_to_ell(csr)}
    rows = []
    for name, a in mats.items():
        dt = a.dia.data.dtype if hasattr(a, "dia") else a.data.dtype
        x = torch.randn((P29_S, a.shape[1]), generator=gen, device=dev,
                        dtype=torch.float64).to(dt)
        band = name[:3] in ("hyb", "dia", "bsr")
        kernel = "K4" if name.startswith("bsr") else "K3"
        rows.append(p29_block_row(f"(b) sparse_operator {name} {a.shape[0]} rows",
                                  gt_torch.sparse_operator(a), x, 1, mesh,
                                  gathers=0 if band else 1, needs=(kernel,) if band else (),
                                  same_kernels=band,
                                  rtol=1e-12 if name[:3] in ("csr", "coo") else 0.0))
        got = rows[-1]["count"]
        require(got["exchanges"] == int(band) and got[kernel] == int(band),
                f"phase 29 (b) {name}: {got['exchanges']} exchanges, {got[kernel]} {kernel}")
    return rows


def p29_solver_row(label, sharded, twin, counts, jax_counts, check, lanes_kernels):
    """One solver row of (c): the twin on plain tensors, then the row on the
    sharded block, each after an untimed run, timed to a synchronisation,
    the counts set to 0 just before and read just after. Held: the counts
    equal the twin's and, where gmres_tpu's are given, iterations within
    P29_BAND and status equal; `check(res, twin)`; each of `lanes_kernels`
    launched on lane blocks, and every exchange followed by one launch of
    K1's halo form or K3."""
    import torch

    tag = f"phase 29 (c) {label}"
    walls, results, cnts = {}, {}, {}
    for key, call in (("twin", twin), ("row", sharded)):
        call()
        calls = {"all-gathers": 0}
        p29_counters(reset=True)
        with counted_all_gathers(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[key] = call()
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
        cnts[key] = {**p29_counters(), "all-gathers": calls["all-gathers"]}
    res, tw = results["row"], results["twin"]
    count = cnts["row"]
    got, want = counts(res), counts(tw)
    print(f"{tag}: counts {got} (twin on plain tensors {want}; gmres_tpu {jax_counts}); "
          f"wall {walls['row']:.4f} s, twin {walls['twin']:.4f} s "
          f"({walls['row'] / walls['twin']:.2f}x); launches "
          + ", ".join(f"{k} {v}" for k, v in count.items()), flush=True)
    require(got == want, f"{tag}: counts {got}, twin {want}")
    if jax_counts is not None:
        require(got[-1] == jax_counts[-1] and abs(got[0] - jax_counts[0]) <= P29_BAND,
                f"{tag}: counts {got}, gmres_tpu {jax_counts}")
    require(check(res, tw), f"{tag}: check failed")
    for k in lanes_kernels:
        require(count[f"{k} batched"] > 0, f"{tag}: {k} not launched on a lane block")
    require(count["exchanges"] == count["K1 halo"] + count["K3"] and count["all-gathers"] == 0,
            f"{tag}: exchanges, launches and all-gathers {count}")
    return {"label": label, "counts": got, "twin_counts": want, "jax_counts": jax_counts,
            "wall_s": walls["row"], "twin_wall_s": walls["twin"], "count": count,
            "twin_count": cnts["twin"]}


def p29_jax(row):
    """(iterations, status) of gmres_tpu's run of a phase 29 row, or None."""
    got = JAX_PHASE29.get(row)
    return None if got is None else (got["iterations"], got["status"])


def p29_solvers(gt_torch, dev, mesh):
    """(c) block CG with the mesh= Poisson cycle (1024² float64, s 8),
    LOBPCG with the mesh=None cycle (1024², k 4, phase 20's rtol) and block
    CG with cbpr2 on the HYB operator (1000², s 4), each on a block placed
    [Shard(1)] beside its twin on plain tensors (the mesh=None cycle, the
    same operator)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    def blk(a):
        return distribute_tensor(torch.as_tensor(a).to(dev), mesh, [Shard(1)])

    def rel(a, b):
        a, b = whole(a).detach().cpu().numpy(), whole(b).detach().cpu().numpy()
        return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)

    def x_close(res, twin):
        gap = rel(res.x, twin.x)
        print(f"  x against the twin {gap:.3e}", flush=True)
        return res.status == 0 and gap <= 1e-10

    rows = []
    n, s, tol = P29_BCG
    op = gt_torch.poisson_operator(n)
    mg = gt_torch.poisson_multigrid_preconditioner(n, mesh=mesh)
    b = p29_inputs("bcg")
    rows.append(p29_solver_row(
        f"block_cg + the mesh= cycle {n}x{n} f64 s {s}",
        lambda: gt_torch.block_cg(op, blk(b), tol=tol, M=mg),
        lambda: gt_torch.block_cg(op, torch.as_tensor(b).to(dev), tol=tol,
                                  M=gt_torch.poisson_multigrid_preconditioner(n)),
        lambda r: (r.iterations, r.status), p29_jax("block_cg_mg"), x_close, ("K1 halo",)))
    n, k, rtol, cap = P29_LOBPCG
    x0 = p29_inputs("lobpcg")
    m_none = gt_torch.poisson_multigrid_preconditioner(n)
    _, lam_exact = p27_poisson_lanes(n)
    exact = np.sort(lam_exact.reshape(-1))[:k]

    def eig_ok(res, twin):
        lam = res.eigenvalues.cpu().numpy()
        gap = float(np.max(np.abs(lam - exact) / exact))
        print(f"  λ {np.array2string(lam, precision=10)} against the closed form "
              f"({gap:.2e} relative); twin {rel(res.eigenvalues, twin.eigenvalues):.2e}",
              flush=True)
        return res.status == 0 and gap <= 1e-6 and rel(res.eigenvalues,
                                                      twin.eigenvalues) <= 1e-10

    rows.append(p29_solver_row(
        f"lobpcg + the mesh=None cycle {n}x{n} k {k}",
        lambda: gt_torch.lobpcg(op, blk(x0), tol=0.0, rtol=rtol, max_iterations=cap, M=m_none),
        lambda: gt_torch.lobpcg(op, torch.as_tensor(x0).to(dev), tol=0.0, rtol=rtol,
                                max_iterations=cap, M=m_none),
        lambda r: (r.iterations, r.status), p29_jax("lobpcg_mg"), eig_ok, ("K1 halo",)))
    n, s, tol = P29_HYB_BCG
    hyb = gt_torch.sparse_operator(gt_torch.csr_to_hyb(gt_torch.poisson_csr(n, device=dev)))
    cbpr2 = gt_torch.chebyshev_preconditioner(hyb, *REF_EIG)
    b = p29_inputs("bcg_hyb")
    rows.append(p29_solver_row(
        f"block_cg + cbpr2 on HYB {n}x{n} f64 s {s}",
        lambda: gt_torch.block_cg(hyb, blk(b), tol=tol, M=cbpr2),
        lambda: gt_torch.block_cg(hyb, torch.as_tensor(b).to(dev), tol=tol, M=cbpr2),
        lambda r: (r.iterations, r.status), p29_jax("block_cg_hyb"), x_close, ("K3",)))
    return rows


def phase_cycle_blocks(gt_torch, dev, workdir):
    """Phase 29 on a one-rank NCCL group: (a) the cycles' and (b) the sparse
    operators' block applications, then (c) the solver rows. Returns the
    launches over (a)-(c) and the rows."""
    t_phase = time.perf_counter()
    with one_rank_group(workdir, "rendezvous29"):
        mesh = gt_torch.solver_mesh(1)
        rows = (p29_cycles(gt_torch, dev, mesh) + p29_sparse(gt_torch, dev, mesh)
                + p29_solvers(gt_torch, dev, mesh))
    launches = dict.fromkeys(p29_counters(), 0)
    for r in rows:
        for key, v in r["count"].items():
            if key in launches:
                launches[key] += v
    for key in ("K1 halo", "K1rr", "K1cr", "K2", "K3", "K4"):
        require(launches[f"{key} batched"] > 0, f"phase 29: {key} was not launched on a lane "
                f"block on the main path ({launches})")
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s; launches over (a)-(c): "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, rows


def run_phase(name, gt_torch, dev, workdir):
    """Run phase `name` (PHASE_RUNNERS; 21-23 on a one-rank NCCL group of
    their own) and return what the kernel report reads of it."""
    import numpy as np

    rank_group = (one_rank_group(workdir, f"rendezvous{name}") if name in ("21", "22", "23")
                  else contextlib.nullcontext())
    if name == "28":
        # (a) runs in the main process of the smoke run (its device times
        # want the card to itself); alone (--phase28) it runs here.
        return phase_halo_blocks(gt_torch, dev, workdir,
                                 kernels=sys.argv[1:2] == ["--phase28"])[1:]
    with rank_group:
        if name == "15":
            return phase_programs(gt_torch, dev, workdir)
        if name == "17":
            return phase_family(gt_torch, dev, workdir)[0]
        if name == "18":
            return phase_short(gt_torch, dev, workdir)[0]
        if name == "19":
            return phase_transpose(gt_torch, np.random.default_rng(SEED), dev, workdir)[0]
        if name == "20":
            return phase_spectral(gt_torch, dev, workdir)[0]
        if name == "21":
            return phase_distributed(gt_torch, dev, workdir)[:2]
        if name == "22":
            return phase_models_sharded(gt_torch, dev, workdir)[:2]
        if name == "23":
            return phase_sharded_spectral_sparse(gt_torch, dev, workdir)[:3]
        if name == "24":
            return phase_batched(gt_torch, dev, workdir)[:2]
        if name == "25":
            return phase_batched_family(gt_torch, dev)[:2]
        if name == "26":
            return phase_batched_rest(gt_torch, dev)[:2]
        if name == "29":
            return phase_cycle_blocks(gt_torch, dev, workdir)
        return phase_batched_spectral(gt_torch, dev)[0]


PHASE_RUNNERS = ("15", "17", "18", "19", "20", "21", "22", "23", "24", "25", "26", "27",
                 "28", "29")
# Phases 15, 17-23 and 27 time no kernel: after the kernel phases they run
# in these worker processes at once (each group one process, in order),
# which the card time-slices; their walls share the card and the host.
# Grouped by their walls on an H100 host (H100 80GB HBM3, 700 W; the four
# at once, 1.3x the times of the fastest host seen): phase 19 212 s; 15, 18
# and 28's (b)-(c) 133 + 37 + 61; 20, 21 and 27 101 + 57 + 70; 22, 17, 23
# and 29 65 + 59 + 39 + 77.
WORKER_GROUPS = (("19",), ("15", "18", "28"), ("20", "21", "27"), ("22", "17", "23", "29"))
# Lines of a failed worker's output repeated on standard error.
WORKER_TAIL_LINES = 40


def run_workers(groups) -> dict:
    """Run each group of phases in a `--worker` process of its own, all at
    once; print each one's output in turn, fail if one failed, and return
    the phases' results."""
    with tempfile.TemporaryDirectory() as workdir:
        procs = []
        try:
            for i, group in enumerate(groups):
                log = open(os.path.join(workdir, f"worker{i}.log"), "w+")
                out = os.path.join(workdir, f"worker{i}.pkl")
                procs.append((group, log, out, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--worker", out, *group],
                    stdout=log, stderr=subprocess.STDOUT, cwd=HERE)))
            for _, _, _, proc in procs:
                proc.wait()
        finally:
            for _, log, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        done, failed = {}, []
        for group, log, out, proc in procs:
            log.seek(0)
            text = log.read()
            log.close()
            print(f"== worker: phases {', '.join(group)} (exit {proc.returncode})", flush=True)
            print(text, end="", flush=True)
            if proc.returncode != 0:
                failed.append(f"phases {', '.join(group)}: the worker exited {proc.returncode}")
                # The end of a failed worker's output on standard error too,
                # beside the traceback of the require below.
                print(f"== worker: phases {', '.join(group)} (exit {proc.returncode}), "
                      "the end of its output:", *text.splitlines()[-WORKER_TAIL_LINES:],
                      sep="\n", file=sys.stderr, flush=True)
                continue
            with open(out, "rb") as f:
                done.update(pickle.load(f))
        require(not failed, "; ".join(failed))
        return done


def main() -> int:
    import torch

    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    import gmres_tpu_torch as gt_torch
    from gmres_tpu_torch.ops import _cuda, fused, stencil

    pkg_dir = os.path.dirname(os.path.abspath(gt_torch.__file__))
    require(pkg_dir == os.path.join(HERE, "gmres_tpu_torch"),
            f"gmres_tpu_torch imported from {pkg_dir}, not from this checkout")

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {kind} (capability {torch.cuda.get_device_capability(0)})",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "float32 matmuls must not use TF32")
    dev = torch.device("cuda", 0)

    # Phase 2: build.
    t0 = time.perf_counter()
    _cuda.load()
    print(f"phase 2: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds:.1f} s)",
          flush=True)
    for line in _cuda.build_log.splitlines():
        if "Used" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    if sys.argv[1:2] == ["--k2-paths"]:
        section = _cuda.build_log.split("== chebk.cu")[-1].split("\n== ")[0]
        print(f"  ptxas, chebk.cu:{section}", flush=True)
        k2_paths(dev, sys.argv[2] if len(sys.argv) > 2 else None)
        return 0
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode.startswith("--phase") and mode[len("--phase"):] in PHASE_RUNNERS:
        with tempfile.TemporaryDirectory() as workdir:
            run_phase(mode[len("--phase"):], gt_torch, dev, workdir)
        return 0
    if mode == "--worker":
        out = {}
        with tempfile.TemporaryDirectory() as workdir:
            for name in sys.argv[3:]:
                out[name] = run_phase(name, gt_torch, dev, workdir)
        with open(sys.argv[2], "wb") as f:
            pickle.dump(out, f)
        return 0

    # Phase 3: kernels against their plain versions.
    rng = np.random.default_rng(SEED)
    records = phase_kernels(gt_torch, rng, dev)
    redesigned, floor = phase_redesigned(gt_torch, rng, dev)
    for name, recs in redesigned.items():
        records.setdefault(name, []).extend(recs)

    # Phase 4: the mg configuration on the main path, fused and unfused.
    launches, mg = phase_mg(gt_torch, dev)

    # Phase 5: the reference configuration (float64 cbpr2, m=50) at 300².
    n = 300
    b_np = np_stencil(np.ones((n, n)))
    b = gt_torch.as_tensor(b_np, dev)
    op = gt_torch.poisson_operator(n)
    m_ref = gt_torch.chebyshev_preconditioner(op, 0.2, 8.2)

    def solve_ref():
        return gt_torch.gmres(op, b, restart=50, tol=TOL, M=m_ref,
                              compute_v_err=False, certify="true")

    res, t_warm = timed(solve_ref)
    stencil.stencil5_cuda.launches = 0
    res, t_ref = timed(solve_ref)
    rel = true_rel(b_np, res.x)
    total_inner = (res.restarts - 1) * 50 + res.iterations
    print(f"phase 5: reference 300x300 f64 cbpr2 m=50: status {res.status}, "
          f"{total_inner} inner iterations (JAX package recorded "
          f"{JAX_REFERENCE_INNER}), {res.restarts} restarts, {res.host_syncs} "
          f"host syncs, true rel residual {rel:.3e}, {t_ref:.4f} s (warm-up "
          f"{t_warm:.4f} s), K1 launches {stencil.stencil5_cuda.launches}",
          flush=True)
    require(res.status == 0 and rel <= TOL, "reference configuration failed")
    ref_inner = total_inner

    # Phase 6: GPU and CPU solves of the port agree at 64².
    n = 64
    counts = {}
    for where in (dev, torch.device("cpu")):
        b_np, _, solve = mg_solve(gt_torch, n, where)
        res = solve()
        rel = true_rel(b_np, res.x)
        counts[where.type] = ((res.restarts - 1) * 10 + res.iterations,
                              res.status, rel)
    print(f"phase 6: 64x64 mg, (inner iterations, status, true rel residual): "
          f"GPU {counts['cuda']}, CPU {counts['cpu']}", flush=True)
    require(counts["cuda"][1] == counts["cpu"][1] == 0, "phase 6: status")
    require(counts["cuda"][2] <= TOL and counts["cpu"][2] <= TOL,
            "phase 6: not converged")
    require(abs(counts["cuda"][0] - counts["cpu"][0]) <= 2,
            "phase 6: inner iteration counts differ by more than 2")

    # Phase 7: K3 and K4 against their plain versions.
    a_small = gt_torch.poisson_matrix(SMALL_GRID, device="cpu").numpy()
    sp_records, hyb, bsr_small = phase_sparse_kernels(gt_torch, rng, a_small,
                                                      dev)
    records.update(sp_records)

    # Phase 8: the cg program's sparse solve.
    for n in (CG_GRIDS[0], SMALL_GRID):
        hyb[n] = gt_torch.csr_to_hyb(gt_torch.poisson_csr(n, device=dev))
    launches["K3"] = phase_cg(gt_torch, hyb, dev)

    # Phases 9 and 10: the other operators on a solver path; CPU and GPU.
    launches["K4"] = phase_sparse_solvers(gt_torch, hyb, bsr_small, dev,
                                          ref_inner)

    # Phase 11: K5 and K7 against their plain versions; K7's per-shard calls.
    fused_records, k7_launches = phase_fused_kernels(gt_torch, rng, dev, floor)
    for name, recs in fused_records.items():
        records.setdefault(name, []).extend(recs)

    # Phase 12: the strong-scaling path (halo operator, K1 and K5, MGSR);
    # phase 13: K6 and the roofline program; phase 14: K8 and the RDMA route.
    with tempfile.TemporaryDirectory() as workdir:
        strong, (dd_records, roof), (rdma_records, k8) = phases_on_one_rank(
            gt_torch, rng, dev, workdir, floor)
        # Phase 16: convection-diffusion (BASELINE config 3).
        cd_records, cd, _ = phase_convdiff(gt_torch, rng, dev, floor, workdir)
        # Phase 24: batched solves and the batched launches.
        p24_records, p24 = run_phase("24", gt_torch, dev, workdir)
        # Phase 25: batched solves of the other solvers, SLQ's probes
        # batched, the batched launches of K3 and K4.
        p25_records, p25 = run_phase("25", gt_torch, dev, workdir)
        # Phase 26: the rest of the batched solvers (transposes, deflation,
        # recycling, blocks) and vmap(grad) through implicit_solve; K1's
        # per-lane transposed launch.
        p26_records, p26 = run_phase("26", gt_torch, dev, workdir)
        # Phase 28 (a): K1's halo form, K5 and K8 on lane blocks ((b) and (c)
        # run in a worker).
        p28_records = p28_kernels(dev)
    # Phases 15 and 17-23, which time no kernel, in worker processes at once.
    done = run_workers(WORKER_GROUPS)
    programs, family, short, p19, p20, p27 = (done[k] for k in ("15", "17", "18", "19", "20",
                                                                  "27"))
    (p21, p21_twins), (p22, p22_twins) = done["21"], done["22"]
    p23, p23_twins, rank_blocks = done["23"]
    p28, p28_rows = done["28"]
    p29, p29_rows = done["29"]
    print(f"chip_smoke: phases 1-29 in {time.perf_counter() - t_run:.1f} s", flush=True)
    records.update(dd_records)
    records.update(p24_records)
    records.update(p25_records)
    records.update(p26_records)
    records.update(p28_records)
    records["K8 lanes"] = records["K8 interior lanes"]
    records.update(rdma_records)
    records.update(cd_records)

    def report(name, src, replaces, also, n_launches, timed_at, **extra):
        recs = records[name]
        rec = [r for r in recs if r["case"] == timed_at][0]
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "also_replaces": also,
            "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "timed_at": timed_at,
            "l2_resident": rec.get("l2_resident"), **extra,
        }

    mg_count = {k: launches[300][k] + launches[2048][k] for k in launches[300]}
    programs_path = "bicgstab, lanczos and the reference's programs (phase 15)"
    mg_k1, mg_k2 = mg_count["K1"], mg_count["K2"]
    mg_k2_paths = {p: mg_count[f"K2 {p}"] for p in ("cluster", "tiled", "sweep")}
    redesign = {"launch_floor_ms": floor["slope_ms"],
                "launch_floor_host_us": floor["host_us"]}

    def timing(name, timed_at):
        rec = [r for r in records[name] if r["case"] == timed_at][0]
        return {"host_us": rec["host_us"], "floor_ms": rec["floor_ms"]}

    def k7_fields(name):
        rec = [r for r in records[name] if r["case"] == f"{name} {STRONG_N}x{STRONG_N} f64"][0]
        return {"kernels_per_call": rec["kernels_per_call"], "floor_ms": rec["floor_ms"],
                "host_us": rec["host_us"], "tensor_alpha_host_us": rec["tensor_alpha_host_us"],
                "torch_pair_ms": rec["torch_pair_ms"]}

    k8_path = f"K8 {STRONG_N}x{STRONG_N} f32 operator, no halo rows"
    mg_report = {n: {"kernels_per_solve": {v: mg[n]["profile"][v]["kernels"]
                                           for v in ("fused", "unfused")},
                     "device_busy_ms": {v: mg[n]["profile"][v]["busy_ms"]
                                        for v in ("fused", "unfused")},
                     "kernels_per_cycle": mg[n]["kernels_per_cycle"]} for n in mg}
    coarse = [r for r in records["K2"] if r["case"] == "K2 order 32 75x75 f32 (coarse solve)"][0]
    roofline_path = "roofline program (phase 13; launches captured in CUDA graphs)"
    convdiff_path = "convdiff rows (phase 16)"
    family_path = "GMRES family (phase 17)"
    short_path = "short-recurrence family and real models (phase 18)"
    p19_path = "Helmholtz, Aᵀ and J·v solvers (phase 19)"
    p20_path = "eigensolvers, matrix functions, time steppers (phase 20)"
    p21_path = "distributed solve, one-rank mesh (phase 21)"
    p21_twins_path = "mesh=None twins of phase 21's rows, plain tensors"
    p22_path = "models, cycles, preconditioners on a sharded b, one-rank mesh (phase 22)"
    p22_twins_path = "twins of phase 22's rows, plain tensors"
    p23_path = ("eigensolvers, matrix functions, time steppers, mesh=None cycles and "
                "sparse formats on a sharded b, one-rank mesh (phase 23)")
    p23_twins_path = "twins of phase 23's rows, plain tensors"
    p24_path = "block rows and batched solves (phase 24)"
    p25_path = ("batched short recurrences, GMRES family, Newton-Krylov, sparse CG and "
                "SLQ (phase 25)")
    p26_path = ("batched QMR, LSQR, LSMR, GMRES-DR, GCRO-DR, Newton gcrodr, block CG and "
                "GMRES, vmap(grad) through implicit_solve (phase 26)")
    p27_path = ("batched lanczos_bounds, funm_lanczos, expm_multiply, trace_funm, "
                "exponential_evolve, theta_evolve, LOBPCG and Krylov-Schur (phase 27)")
    p28_path = ("the halo route's block form: block applications and solver rows on a "
                "sharded block, one-rank mesh (phase 28)")
    p29_path = ("the distributed V-cycles' and the sparse operators' block form: block "
                "applications and solver rows on a sharded block, one-rank mesh (phase 29)")
    # Launches of the batched form (a block in one launch), by phase: the
    # block rows of phases 15-23 on plain tensors run their block
    # applications batched too (a DTensor block keeps one call a row).
    batched_by_phase = {programs_path: programs, family_path: family, short_path: short,
                        p19_path: p19, p20_path: p20, p21_path: p21,
                        p21_twins_path: p21_twins, p22_path: p22,
                        p22_twins_path: p22_twins, p23_path: p23,
                        p23_twins_path: p23_twins, p24_path: p24, p25_path: p25,
                        p26_path: p26, p27_path: p27, p28_path: p28, p29_path: p29}

    def batched_fields(name):
        by = {path: counts.get(f"{name} batched", 0)
              for path, counts in batched_by_phase.items()}
        return {"batched_launches": sum(by.values()),
                "batched_launches_by_path": {k: v for k, v in by.items() if v}}

    def lanes_rows(name):
        """Each lane count's row of a batched K3 or K4 (phase 25 (a))."""
        return [{k: r.get(k) for k in ("case", "lanes", "chunk", "chunks", "ms",
                                       "singles_ms", "plain_ms", "bound_ms",
                                       "library_ms", "max_abs_err")}
                for r in records[name]]

    def k2_paths_fields(name):
        """Each K2 record's routed path, its time and the per-sweep path's."""
        return {"paths": [{"case": r["case"], "path": r["path"], "param": r["param"],
                           "ms": r["ms"], "sweep_path_ms": r["sweep_ms"],
                           "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                           "max_abs_err": r["max_abs_err"]} for r in records[name]]}
    print(json.dumps({"kernels": [
        report("K1", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:139", ["gmres_tpu/ops/stencil.py:206"],
               mg_k1 + strong["K1"] + roof["K1"] + programs["K1"] + family["K1"]
               + short["K1"] + p19["K1"] + p20["K1"] + p21["K1"] + p21_twins["K1"]
               + p22["K1"] + p22_twins["K1"] + p23["K1"] + p23_twins["K1"] + p24["K1"]
               + p25["K1"] + p26["K1"] + p27["K1"] + p28["K1"] + p29["K1"],
               "K1 2048x2048 f32 null halo rows, 16-byte row chunks",
               launches_by_path={"mg (phase 4)": mg_k1,
                                 "strong-scaling (phase 12)": strong["K1"],
                                 roofline_path: roof["K1"],
                                 programs_path: programs["K1"],
                                 family_path: family["K1"],
                                 short_path: short["K1"],
                                 p19_path: p19["K1"], p20_path: p20["K1"],
                                 p21_path: p21["K1"], p21_twins_path: p21_twins["K1"],
                                 p22_path: p22["K1"], p22_twins_path: p22_twins["K1"],
                                 p23_path: p23["K1"], p23_twins_path: p23_twins["K1"],
                                 p24_path: p24["K1"], p25_path: p25["K1"],
                                 p26_path: p26["K1"], p27_path: p27["K1"],
                                 p28_path: p28["K1"], p29_path: p29["K1"]},
               **batched_fields("K1"),
               phase22_k1_halo=p22["K1 halo"], phase22_exchanges=p22["exchanges"],
               phase23_k1_halo=p23["K1 halo"], phase23_exchanges=p23["exchanges"],
               phase21_k1_halo=p21["K1 halo"],
               phase26_k1_by_role={
                   "forward": p26["K1 forward"],
                   "transpose (per-lane and shared backward rules, one launch a set of "
                   "lanes)": p26["K1 transpose"],
                   "tangent (jvp rule)": p26["K1 tangent"]},
               phase19_k1_by_role={
                   "forward": p19["K1"] - p19["K1 transpose"] - p19["K1 tangent"],
                   "transpose (backward rule, mirrored coefficients)": p19["K1 transpose"],
                   "tangent (jvp rule)": p19["K1 tangent"]},
               path_shape=f"K1 {STRONG_N}x{STRONG_N} f64 null halo rows, one point a thread",
               **timing("K1", f"K1 {STRONG_N}x{STRONG_N} f64 null halo rows, "
                              "one point a thread"),
               halo_applications=strong["applications"], **redesign),
        report("K1rr", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:139", ["gmres_tpu/precond/multigrid.py:206"],
               mg_count["K1rr"] + roof["K1rr"] + programs["K1rr"] + family["K1rr"]
               + short["K1rr"] + p19["K1rr"] + p20["K1rr"] + p21["K1rr"]
               + p21_twins["K1rr"] + p22["K1rr"] + p22_twins["K1rr"] + p23["K1rr"]
               + p23_twins["K1rr"] + p24["K1rr"] + p25["K1rr"] + p26["K1rr"] + p27["K1rr"]
               + p29["K1rr"],
               "K1 residual-restrict 300x300 -> 150 f32",
               form="residual-restrict: restrict_sum(r - A e) in one launch",
               launches_by_path={"mg (phase 4)": mg_count["K1rr"], roofline_path: roof["K1rr"],
                                 programs_path: programs["K1rr"],
                                 family_path: family["K1rr"],
                                 short_path: short["K1rr"],
                                 p19_path: p19["K1rr"], p20_path: p20["K1rr"],
                                 p21_path: p21["K1rr"],
                                 p21_twins_path: p21_twins["K1rr"],
                                 p22_path: p22["K1rr"], p22_twins_path: p22_twins["K1rr"],
                                 p23_path: p23["K1rr"], p23_twins_path: p23_twins["K1rr"],
                                 p24_path: p24["K1rr"], p25_path: p25["K1rr"],
                                 p26_path: p26["K1rr"], p27_path: p27["K1rr"],
                                 p29_path: p29["K1rr"]},
               **batched_fields("K1rr"),
               **timing("K1rr", "K1 residual-restrict 300x300 -> 150 f32"), mg=mg_report),
        report("K1cr", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:139", ["gmres_tpu/precond/multigrid.py:207"],
               mg_count["K1cr"] + roof["K1cr"] + programs["K1cr"] + family["K1cr"]
               + short["K1cr"] + p19["K1cr"] + p20["K1cr"] + p21["K1cr"]
               + p21_twins["K1cr"] + p22["K1cr"] + p22_twins["K1cr"] + p23["K1cr"]
               + p23_twins["K1cr"] + p24["K1cr"] + p25["K1cr"] + p26["K1cr"] + p27["K1cr"]
               + p29["K1cr"],
               "K1 correct-residual 300x300 <- 150 f32",
               form="correct-residual: e + prolong_repeat(ec) and r - A(e + prolong_repeat(ec))",
               launches_by_path={"mg (phase 4)": mg_count["K1cr"], roofline_path: roof["K1cr"],
                                 programs_path: programs["K1cr"],
                                 family_path: family["K1cr"],
                                 short_path: short["K1cr"],
                                 p19_path: p19["K1cr"], p20_path: p20["K1cr"],
                                 p21_path: p21["K1cr"],
                                 p21_twins_path: p21_twins["K1cr"],
                                 p22_path: p22["K1cr"], p22_twins_path: p22_twins["K1cr"],
                                 p23_path: p23["K1cr"], p23_twins_path: p23_twins["K1cr"],
                                 p24_path: p24["K1cr"], p25_path: p25["K1cr"],
                                 p26_path: p26["K1cr"], p27_path: p27["K1cr"],
                                 p29_path: p29["K1cr"]},
               **batched_fields("K1cr"),
               library_note="no single PyTorch call computes both outputs",
               **timing("K1cr", "K1 correct-residual 300x300 <- 150 f32")),
        report("K2", "gmres_tpu_torch/csrc/chebk.cu",
               "gmres_tpu/ops/fused.py:187", ["gmres_tpu/ops/fused.py:388"],
               mg_k2 + roof["K2"] + programs["K2"] + family["K2"] + short["K2"] + p19["K2"]
               + p20["K2"] + p21["K2"] + p21_twins["K2"] + p22["K2"] + p22_twins["K2"]
               + p23["K2"] + p23_twins["K2"] + p24["K2"] + p25["K2"] + p26["K2"] + p27["K2"]
               + p29["K2"],
               "K2 order 3 2048x2048 f32",
               launches_by_path=mg_k2_paths,
               launches_by_program={"mg (phase 4)": mg_k2, roofline_path: roof["K2"],
                                    programs_path: programs["K2"],
                                    family_path: family["K2"],
                                    short_path: short["K2"],
                                    p19_path: p19["K2"], p20_path: p20["K2"],
                                    p21_path: p21["K2"],
                                    p21_twins_path: p21_twins["K2"],
                                    p22_path: p22["K2"], p22_twins_path: p22_twins["K2"],
                                    p23_path: p23["K2"], p23_twins_path: p23_twins["K2"],
                                    p24_path: p24["K2"], p25_path: p25["K2"],
                                    p26_path: p26["K2"], p27_path: p27["K2"],
                                    p29_path: p29["K2"]},
               **batched_fields("K2"),
               family_launches_by_path={p: family[f"K2 {p}"]
                                        for p in ("cluster", "tiled", "sweep")},
               short_launches_by_path={p: short[f"K2 {p}"]
                                       for p in ("cluster", "tiled", "sweep")},
               phase19_launches_by_path={p: p19[f"K2 {p}"]
                                         for p in ("cluster", "tiled", "sweep")},
               phase20_launches_by_path={p: p20[f"K2 {p}"]
                                         for p in ("cluster", "tiled", "sweep")},
               phase21_launches_by_path={p: p21[f"K2 {p}"]
                                         for p in ("cluster", "tiled", "sweep")},
               path=[r["path"] for r in records["K2"]
                     if r["case"] == "K2 order 3 2048x2048 f32"][0],
               sweep_path_ms=[r["sweep_ms"] for r in records["K2"]
                              if r["case"] == "K2 order 3 2048x2048 f32"][0],
               coarse_timed_at=coarse["case"], coarse_path=coarse["path"],
               coarse_ms=coarse["ms"], coarse_plain_ms=coarse["plain_ms"],
               coarse_sweep_path_ms=coarse["sweep_ms"], coarse_bound_ms=coarse["bound_ms"],
               coarse_bound_by=coarse["bound_by"]),
        report("K1 batched", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:170", ["gmres_tpu/ops/stencil.py:340"],
               batched_fields("K1")["batched_launches"], "K1 batched 8x2048x2048 f32",
               form="a (lanes, rows, cols) block in one launch, the lane on gridDim.y "
                    "(jax.vmap's leading grid axis); per-lane coefficients optional",
               launches_by_path=batched_fields("K1")["batched_launches_by_path"],
               singles_ms=[r["singles_ms"] for r in records["K1 batched"]
                           if r["case"] == "K1 batched 8x2048x2048 f32"][0],
               library_note="F.conv2d on the block (grouped, one cross a lane, for "
                            "per-lane coefficients)",
               per_lane_transposed=[
                   {k: r.get(k) for k in ("case", "ms", "singles_ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "max_abs_err")}
                   for r in records["K1 per-lane transposed"] if "ms" in r],
               nested_host_us=[r for r in records["K1 per-lane transposed"]
                               if "ms" not in r][0]),
        report("K1rr batched", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/precond/multigrid.py:206", ["gmres_tpu/ops/stencil.py:170"],
               batched_fields("K1rr")["batched_launches"],
               "K1rr batched 8x2048x2048 -> 1024 f32",
               launches_by_path=batched_fields("K1rr")["batched_launches_by_path"],
               singles_ms=[r["singles_ms"] for r in records["K1rr batched"]
                           if r["case"] == "K1rr batched 8x2048x2048 -> 1024 f32"][0]),
        report("K1cr batched", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/precond/multigrid.py:207", ["gmres_tpu/ops/stencil.py:170"],
               batched_fields("K1cr")["batched_launches"],
               "K1cr batched 8x2048x2048 -> 1024 f32",
               launches_by_path=batched_fields("K1cr")["batched_launches_by_path"],
               singles_ms=[r["singles_ms"] for r in records["K1cr batched"]
                           if r["case"] == "K1cr batched 8x2048x2048 -> 1024 f32"][0],
               library_note="no single PyTorch call computes both outputs"),
        report("K2 batched", "gmres_tpu_torch/csrc/chebk.cu",
               "gmres_tpu/ops/fused.py:360", ["gmres_tpu/ops/fused.py:242",
                                              "gmres_tpu/ops/fused.py:300"],
               batched_fields("K2")["batched_launches"],
               "K2 batched tiled order 3 8x2048x2048 float32",
               launches_by_path=batched_fields("K2")["batched_launches_by_path"],
               paths=[{"case": r["case"], "path": r["path"], "ms": r["ms"],
                       "singles_ms": r["singles_ms"], "bound_ms": r["bound_ms"]}
                      for r in records["K2 batched"]],
               library_note="none: no single PyTorch call computes the polynomial"),
        report("K1 convdiff", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:340", ["gmres_tpu/ops/stencil.py:170"], cd["K1"],
               "K1 convdiff operator 1024x1024 f64 central", launched_by=convdiff_path,
               coefficients="convection-diffusion, central (γ 0.4, 0.2) and upwind",
               **timing("K1 convdiff", "K1 convdiff operator 1024x1024 f64 central")),
        report("K1rr convdiff", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:340", ["gmres_tpu/precond/multigrid.py:619"],
               cd["K1rr"], "K1 residual-restrict 1024x1024 -> 512 f64 central",
               launched_by=convdiff_path,
               **timing("K1rr convdiff", "K1 residual-restrict 1024x1024 -> 512 f64 central")),
        report("K1cr convdiff", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:340", ["gmres_tpu/precond/multigrid.py:620-621"],
               cd["K1cr"], "K1 correct-residual 1024x1024 <- 512 f64 central",
               launched_by=convdiff_path,
               library_note="no single PyTorch call computes both outputs",
               **timing("K1cr convdiff", "K1 correct-residual 1024x1024 <- 512 f64 central")),
        report("K2 convdiff", "gmres_tpu_torch/csrc/chebk.cu",
               "gmres_tpu/ops/fused.py:242", ["gmres_tpu/ops/fused.py:300"], cd["K2"],
               "K2 Jacobi order 3 1024x1024 f32 central", launched_by=convdiff_path,
               launches_by_path={p: cd[f"K2 {p}"] for p in ("cluster", "tiled", "sweep")},
               library_note="none: no single PyTorch call computes the polynomial",
               **k2_paths_fields("K2 convdiff")),
        report("K3", "gmres_tpu_torch/csrc/dia_spmv.cu",
               "gmres_tpu/ops/sparse.py:567", [],
               launches["K3"] + p23["K3"] + p23_twins["K3"] + p25["K3"] + p29["K3"],
               f"K3 HYB {CG_GRIDS[-1]}x{CG_GRIDS[-1]} f64",
               launches_by_path={"cg and the sparse solvers (phases 8-10)": launches["K3"],
                                 p23_path: p23["K3"], p23_twins_path: p23_twins["K3"],
                                 p25_path: p25["K3"], p29_path: p29["K3"]},
               rank_block_max_abs_err=max(rank_blocks["K3 torch.float32"],
                                          rank_blocks["K3 torch.float64"])),
        report("K4", "gmres_tpu_torch/csrc/bsr_spmv.cu",
               "gmres_tpu/ops/sparse.py:488", [],
               launches["K4"] + p23["K4"] + p23_twins["K4"] + p25["K4"] + p29["K4"],
               f"K4 {BSR_CASES[-1][0]} f32",
               launches_by_path={"the sparse solvers (phases 9-10)": launches["K4"],
                                 p23_path: p23["K4"], p23_twins_path: p23_twins["K4"],
                                 p25_path: p25["K4"], p29_path: p29["K4"]},
               rank_block_max_abs_err=rank_blocks["K4 float32"]),
        report("K3 batched", "gmres_tpu_torch/csrc/dia_spmv.cu",
               "gmres_tpu/ops/sparse.py:644", ["gmres_tpu/ops/sparse.py:567"],
               p25["K3 batched"] + p29["K3 batched"],
               f"K3 batched HYB {P25_K3_N}x{P25_K3_N} f64 {P25_LANES} lanes",
               form="a (lanes, n) block in one launch, one DIA matrix for every lane, the "
                    "lanes in chunks (gridDim.y): each matrix entry read once a chunk of "
                    "L lanes (sparse.spmv_lanes_plan)",
               launches_by_path={p25_path: p25["K3 batched"], p29_path: p29["K3 batched"]},
               singles_ms=records["K3 batched"][0]["singles_ms"],
               lanes_rows=lanes_rows("K3 batched"),
               single_retimed_ms=records["K3 single"][0]["ms"],
               library_note="torch.sparse_csr_tensor @ X, X = (n, lanes) (cuSPARSE SpMM)"),
        report("K4 batched", "gmres_tpu_torch/csrc/bsr_spmv.cu",
               "gmres_tpu/ops/sparse.py:544", ["gmres_tpu/ops/sparse.py:488"],
               p25["K4 batched"] + p29["K4 batched"],
               f"K4 batched {P25_K4[0]} block rows bs={P25_K4[1]} f32 {P25_K4_LANES[0][1]} lanes",
               form="a (lanes, n) block in one launch, one BSR matrix for every lane, the "
                    "lanes in chunks (the grid's fastest index): each matrix entry read "
                    "once a chunk of L lanes (sparse.spmv_lanes_plan)",
               launches_by_path={p25_path: p25["K4 batched"], p29_path: p29["K4 batched"]},
               singles_ms=records["K4 batched"][0]["singles_ms"],
               lanes_rows=lanes_rows("K4 batched"),
               single_retimed_ms=records["K4 single"][0]["ms"],
               library_note="torch.sparse_bsr_tensor @ X, X = (n, lanes)"),
        report("K5", "gmres_tpu_torch/csrc/cheb2_fused.cu",
               "gmres_tpu/ops/fused.py:129", [],
               strong["K5"] + p21["K5"] + p21_twins["K5"] + p28["K5"],
               f"K5 {STRONG_N}x{STRONG_N} f64 null halo rows",
               launches_by_path={"strong-scaling (phase 12)": strong["K5"],
                                 p21_path: p21["K5"], p21_twins_path: p21_twins["K5"],
                                 p28_path: p28["K5"]},
               **timing("K5", f"K5 {STRONG_N}x{STRONG_N} f64 null halo rows")),
        report("K7a", "gmres_tpu_torch/csrc/cg_fused.cu",
               "gmres_tpu/ops/fused.py:50", [], k7_launches[0],
               f"K7a {STRONG_N}x{STRONG_N} f64",
               launched_by="phase 11 per-shard call; no solver calls it, as in gmres_tpu",
               **k7_fields("K7a")),
        report("K7b", "gmres_tpu_torch/csrc/cg_fused.cu",
               "gmres_tpu/ops/fused.py:94", [], k7_launches[1],
               f"K7b {STRONG_N}x{STRONG_N} f64",
               launched_by="phase 11 per-shard call; no solver calls it, as in gmres_tpu",
               **k7_fields("K7b")),
        report("K6", "gmres_tpu_torch/csrc/stencil5_dd.cu",
               "gmres_tpu/ops/stencil.py:388", ["gmres_tpu/ops/stencil.py:519"],
               roof["K6"], f"K6 {ROOFLINE_GRIDS[-1]}x{ROOFLINE_GRIDS[-1]} poisson",
               launched_by=roofline_path,
               library_note="no PyTorch call computes the stencil on (hi, lo) "
               "pairs; nearest_library_ms is the float64 cross as one F.conv2d",
               nearest_library_ms=[r["nearest_library_ms"] for r in records["K6"]
                                   if "nearest_library_ms" in r][-1]),
        report("K8", "gmres_tpu_torch/csrc/stencil5_rdma.cu",
               "gmres_tpu/ops/stencil_rdma.py:41", [], k8["interior"] + p28["K8 interior"],
               k8_path,
               launches_by_path={"rdma gmres and cg (phase 14), interior": k8["interior"],
                                 p28_path: p28["K8 interior"]},
               edge_launches=k8["edges"] + p28["K8 edges"],
               kernels_per_application={op: k8["applications"][op]["kernels"]
                                        for op in k8["applications"]},
               four_launch_ms=[r["four_launch_ms"] for r in records["K8"]
                               if r["case"] == k8_path][0],
               hbm_timed_at="K8 2048x2048 f32 operator, no halo rows",
               hbm_ms=[r["ms"] for r in records["K8"]
                       if r["case"] == "K8 2048x2048 f32 operator, no halo rows"][0],
               **timing("K8", k8_path)),
        report("K1 halo lanes", "gmres_tpu_torch/csrc/stencil5.cu",
               "gmres_tpu/ops/stencil.py:170", ["gmres_tpu/parallel/halo.py:105-112"],
               p28["K1 halo batched"] + p29["K1 halo batched"],
               "K1 halo lanes 8x2048x2048 f32 random halo rows",
               form="K1's halo form on a (lanes, rows, cols) block with (lanes, 1, cols) halo "
                    "rows, lane ℓ's its own (null: a zero row), the lane on gridDim.y: a "
                    "block of rows of a row-sharded grid (jax.vmap of the halo operator)",
               launches_by_path={p28_path: p28["K1 halo batched"],
                                 p29_path: p29["K1 halo batched"]},
               singles_ms=[r["singles_ms"] for r in records["K1 halo lanes"]
                           if r["case"] == "K1 halo lanes 8x2048x2048 f32 random halo rows"][0],
               lanes_rows=lanes_rows("K1 halo lanes"),
               library_note="F.conv2d over the lanes of the rows with their halo rows "
                            "concatenated (the concatenation untimed)"),
        report("K5 lanes", "gmres_tpu_torch/csrc/cheb2_fused.cu",
               "gmres_tpu/ops/fused.py:157", ["gmres_tpu/parallel/halo.py:240-250"],
               p28["K5 batched"], "K5 lanes 8x2048x2048 f32 random halo rows",
               form="K5 on a (lanes, rows, cols) block with per-lane halo rows, the lane on "
                    "gridDim.y (jax.vmap of the halo cbpr2)",
               launches_by_path={p28_path: p28["K5 batched"]},
               singles_ms=[r["singles_ms"] for r in records["K5 lanes"]
                           if r["case"] == "K5 lanes 8x2048x2048 f32 random halo rows"][0],
               lanes_rows=lanes_rows("K5 lanes"),
               library_note="F.conv2d over the lanes of K5's affine cross on the rows with "
                            "their halo rows concatenated"),
        report("K8 lanes", "gmres_tpu_torch/csrc/stencil5_rdma.cu",
               "gmres_tpu/ops/stencil_rdma.py:186", ["gmres_tpu/parallel/halo.py:138-145",
                                                     "gmres_tpu/parallel/halo.py:178-185"],
               p28["K8 interior batched"], "K8 interior lanes 8x2048x2048 f32 operator",
               form="K8's interior and edges on a (lanes, rows, cols) block, per-lane halo "
                    "rows for the edges, the lane on gridDim.y (jax.vmap of the RDMA "
                    "operators); no edge launch on one rank",
               launches_by_path={p28_path: p28["K8 interior batched"]},
               edge_launches=p28["K8 edges batched"],
               singles_ms=[r["singles_ms"] for r in records["K8 lanes"]
                           if r["case"] == "K8 interior lanes 8x2048x2048 f32 operator"][0],
               lanes_rows=lanes_rows("K8 lanes"),
               edges_rows=lanes_rows("K8 edges lanes"),
               library_note="F.conv2d over the lanes of the affine cross (the interior; the "
                            "edges have no library call)"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
