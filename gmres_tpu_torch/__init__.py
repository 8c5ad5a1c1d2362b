"""gmres_tpu_torch — the PyTorch/CUDA port of ``gmres_tpu``.

The port covers, slice by slice (ROADMAP.md, queue 1):

* the flagship solve: restarted Householder and MGSR GMRES on the
  matrix-free 5-point Poisson operator, preconditioned by the reference's
  cbpr2 Chebyshev polynomial or by the geometric multigrid V-cycle, in
  full float64 or with float32 Arnoldi cycles certified on the float64
  true residual;
* the sparse path: the CSR/COO/ELL/DIA/HYB/BSR formats (``ops/sparse.py``)
  under classic and pipelined conjugate gradients (``solvers/cg.py``);
* the distributed explicit-halo path (``parallel/``): a 1-D device mesh,
  row-sharded DTensor grid vectors, the halo stencil operator and the
  fused cbpr2 preconditioner, under MGSR GMRES and CG; and the RDMA-route
  operators (``ops/stencil_rdma.py``, ``parallel/halo.py:rdma_*``, not
  exported here, as in ``gmres_tpu``);
* the float64-accurate stencil on (hi, lo) float32 pairs (``ops/dd.py``,
  ``ops/stencil.py``);
* the rest of the reference's own surface: BiCGSTAB with residual
  replacement (``solvers/bicgstab.py``), the Lanczos bounds and Arnoldi
  helpers (``solvers/lanczos.py``, ``precond/chebyshev.py:
  chebyshev_from_lanczos``), the Hilbert model (``models/hilbert.py``),
  the 3-D 7-point stencil, and the reference's eight programs with
  the ``roofline`` program, as ``python -m gmres_tpu_torch.benchmarks
  <program>`` (``benchmarks/cli.py``, ``utils/reporting.py``);
* BASELINE config 3, convection-diffusion: the nonsymmetric model
  (``models/convection_diffusion.py``), its multigrid cycle
  (``precond/multigrid.py``), CGS, TFQMR and BiCGStab(ℓ) (``solvers/``),
  the GMRES polynomial preconditioner (``precond/polynomial.py``) and the
  ``convdiff`` program;
* the GMRES family: s-step GMRES, FGMRES, LGMRES, block GMRES, IDR(s),
  GMRES-DR and GCRO-DR (``solvers/``), with the small dense solve and the
  host eigensolves they share (``ops/tri.py``, ``ops/hessenberg_eig.py``),
  the ``restart-sweep`` solvers and the ``multirhs`` program;
* the short-recurrence family: block CG, MINRES, s-step CG and the
  Chebyshev iteration (``solvers/block_cg.py``, ``minres.py``,
  ``sstep_cg.py``, ``chebyshev.py``); the 3-D Poisson, anisotropic and
  variable-coefficient models (``models/``) with their multigrid cycles
  (``precond/multigrid.py``, ``models/varcoef.py``), the batched PCR line
  solve (``ops/tridiag.py``), the coarse-space (deflation) preconditioner
  (``precond/deflation.py``) and the ``varcoef`` program. The 3-D and
  variable-coefficient operators, PCR and deflation are plain PyTorch, as
  they are plain jnp in ``gmres_tpu``: no kernel of either package serves
  them;
* Helmholtz (``models/helmholtz.py``) with its SPD shifted-Laplacian and
  complex-shifted (CSL) cycles (``precond/multigrid.py``), and the solvers
  that need Aᵀ or J·v: QMR, LSQR, LSMR (``solvers/qmr.py``, ``lsqr.py``,
  ``lsmr.py``; the transpose is the pullback of ``torch.func.vjp``),
  ``implicit_solve`` (``solvers/implicit.py``, a
  ``torch.autograd.Function``) and Newton-Krylov on the Bratu residual
  (``solvers/newton_krylov.py``, J·v by ``torch.func.jvp``;
  ``models/bratu.py``), with the ``helmholtz``, ``sequence`` and ``bratu``
  programs. On the card these differentiate through K1's full-grid route
  (``ops/stencil.py:Stencil5Grid``: backward one K1 launch with mirrored
  coefficients, jvp one K1 launch, tensor coefficients' gradients in
  torch); every other kernel raises under autograd or ``torch.func``;
* the eigensolvers and matrix functions: LOBPCG (``solvers/lobpcg.py``),
  Krylov–Schur on a complex and on a real Schur basis (``arnoldi.py``,
  ``krylov_schur_real.py``; the ordered Schur form from LAPACK on the host,
  reordered by JAX's swap network, ``ops/hessenberg_eig.py``), subspace
  iteration (``subspace_eigs.py``), f(A)·b, e^{−tA}·b and stochastic Lanczos
  quadrature (``funm.py``), θ-method and exponential stepping
  (``evolve.py``); the Nyström and SPAI preconditioners
  (``precond/nystrom.py``, ``spai.py``); checkpointing and the debug checks
  (``utils/checkpoint.py``, ``utils/debug.py``, not exported here, as in
  ``gmres_tpu``); and the ``eig``, ``slq`` and ``evolve`` programs. They run
  the kernels above through their operators and cycles and add none.

Layout and public names mirror ``gmres_tpu`` (``ops/``, ``models/``,
``precond/``, ``solvers/``, ``types.py``). The package imports ``torch``
and never ``jax``. On a CUDA tensor the stencil runs in kernel K1
(``csrc/stencil5.cu``, with its two fused V-cycle forms) and the order-k
Chebyshev smoothers in kernel K2 (``csrc/chebk.cu``), the DIA SpMV (DIA
and HYB operators) in kernel K3 (``csrc/dia_spmv.cu``) and the BSR SpMV in
kernel K4 (``csrc/bsr_spmv.cu``), the fused cbpr2 application in kernel K5
(``csrc/cheb2_fused.cu``), the stencil on pairs in kernel K6
(``csrc/stencil5_dd.cu``), the fused CG update and axpy-dot in kernel K7
(``csrc/cg_fused.cu``) and the RDMA route's affine stencil in kernel K8
(``csrc/stencil5_rdma.cu``), all built with ``nvcc`` for ``sm_90a`` at
first use; on a CPU tensor each takes its plain PyTorch version.
"""

from gmres_tpu_torch.types import (
    BlockSolveResult,
    EigResult,
    GmresResult,
    LinearOperator,
    NewtonResult,
    Preconditioner,
    SolveResult,
    SolverStatus,
    as_tensor,
)
from gmres_tpu_torch.solvers.qmr import qmr
from gmres_tpu_torch.solvers.arnoldi import arnoldi_eigs
from gmres_tpu_torch.solvers.krylov_schur_real import arnoldi_eigs_real
from gmres_tpu_torch.solvers.lobpcg import lobpcg
from gmres_tpu_torch.solvers.subspace_eigs import subspace_eigs
from gmres_tpu_torch.solvers.funm import (
    FunmResult,
    TraceResult,
    expm_multiply,
    funm_lanczos,
    trace_funm,
)
from gmres_tpu_torch.solvers.evolve import (
    EvolveResult,
    ExpEvolveResult,
    exponential_evolve,
    theta_evolve,
)
from gmres_tpu_torch.precond.nystrom import nystrom_preconditioner
from gmres_tpu_torch.precond.spai import spai_matrix, spai_preconditioner
from gmres_tpu_torch.solvers.lsmr import lsmr
from gmres_tpu_torch.solvers.lsqr import lsqr
from gmres_tpu_torch.solvers.newton_krylov import newton_krylov
from gmres_tpu_torch.solvers.implicit import implicit_solve
from gmres_tpu_torch.models.bratu import bratu_residual
from gmres_tpu_torch.models.helmholtz import (
    complex_to_split,
    helmholtz_apply,
    helmholtz_lambda_min,
    helmholtz_matrix,
    helmholtz_operator,
    helmholtz_split_operator,
    split_to_complex,
)
from gmres_tpu_torch.solvers.bicgstab import bicgstab
from gmres_tpu_torch.solvers.batched import batched_solve
from gmres_tpu_torch.solvers.block_cg import BlockCGResult, block_cg
from gmres_tpu_torch.solvers.chebyshev import chebyshev_solve
from gmres_tpu_torch.solvers.minres import minres
from gmres_tpu_torch.solvers.sstep_cg import sstep_cg
from gmres_tpu_torch.solvers.block_gmres import block_gmres
from gmres_tpu_torch.solvers.bicgstabl import bicgstabl
from gmres_tpu_torch.solvers.cg import cg
from gmres_tpu_torch.solvers.cgs import cgs
from gmres_tpu_torch.solvers.tfqmr import tfqmr
from gmres_tpu_torch.solvers.fgmres import fgmres
from gmres_tpu_torch.solvers.gcrodr import gcrodr
from gmres_tpu_torch.solvers.gmres import gmres
from gmres_tpu_torch.solvers.gmres_dr import gmres_dr
from gmres_tpu_torch.solvers.idrs import idrs
from gmres_tpu_torch.solvers.lgmres import lgmres
from gmres_tpu_torch.solvers.sstep import sstep_gmres
from gmres_tpu_torch.solvers.lanczos import lanczos_bounds, power_iteration_bound
from gmres_tpu_torch.precond.chebyshev import (
    chebyshev_preconditioner,
    chebyshev_stencil_preconditioner,
)
from gmres_tpu_torch.precond.multigrid import (
    MultigridPlan,
    anisotropic_multigrid_preconditioner,
    convection_diffusion_multigrid_preconditioner,
    csl_multigrid_preconditioner,
    helmholtz_shifted_laplacian_preconditioner,
    poisson3d_multigrid_preconditioner,
    poisson_multigrid_preconditioner,
    prolong_repeat,
    restrict_sum,
)
from gmres_tpu_torch.precond.polynomial import gmres_polynomial_preconditioner
from gmres_tpu_torch.precond.deflation import (
    coarse_space_preconditioner,
    dirichlet_poisson_modes,
)
from gmres_tpu_torch.models.anisotropic import (
    anisotropic_apply,
    anisotropic_matrix,
    anisotropic_operator,
)
from gmres_tpu_torch.models.poisson3d import (
    poisson3d_apply,
    poisson3d_matrix,
    poisson3d_operator,
    poisson3d_spectral_bounds,
)
from gmres_tpu_torch.models.varcoef import (
    varcoef_apply,
    varcoef_diagonal,
    varcoef_matrix,
    varcoef_multigrid_preconditioner,
    varcoef_operator,
)
from gmres_tpu_torch.models.convection_diffusion import (
    convection_diffusion_apply,
    convection_diffusion_operator,
)
from gmres_tpu_torch.models.hilbert import hilbert_matrix
from gmres_tpu_torch.models.poisson import (
    poisson_apply,
    poisson_matrix,
    poisson_operator,
    poisson_spectral_bounds,
    tuned_poisson_preconditioner,
)
from gmres_tpu_torch.ops.sparse import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
    HYBMatrix,
    bsr_from_dense,
    bsr_spmv_cuda,
    coo_from_dense,
    coo_to_hyb,
    csr_from_dense,
    csr_to_ell,
    csr_to_hyb,
    dia_from_dense,
    dia_spmv_cuda,
    ell_from_dense,
    poisson_csr,
    poisson_dia,
    sparse_from_numpy,
    sparse_operator,
)
from gmres_tpu_torch.ops.stencil import stencil5_cuda
from gmres_tpu_torch.ops.fused import (
    axpy_dot,
    axpy_dot_cuda,
    cg_fused_update,
    cg_fused_update_cuda,
    cheb2_cuda,
    chebk_cuda,
    chebyshev_poisson_fused,
)
from gmres_tpu_torch.parallel.mesh import (
    GRID_AXIS,
    grid_sharding,
    init_multihost,
    shard_grid_vector,
    solver_mesh,
)
from gmres_tpu_torch.parallel.halo import (
    halo_chebyshev_preconditioner,
    halo_exchange,
    halo_poisson_operator,
    halo_stencil_operator,
)

__all__ = [
    "BlockSolveResult",
    "EigResult",
    "lobpcg",
    "arnoldi_eigs",
    "arnoldi_eigs_real",
    "subspace_eigs",
    "funm_lanczos",
    "expm_multiply",
    "trace_funm",
    "FunmResult",
    "TraceResult",
    "theta_evolve",
    "EvolveResult",
    "exponential_evolve",
    "ExpEvolveResult",
    "nystrom_preconditioner",
    "spai_matrix",
    "spai_preconditioner",
    "GmresResult",
    "NewtonResult",
    "LinearOperator",
    "Preconditioner",
    "SolveResult",
    "SolverStatus",
    "as_tensor",
    "batched_solve",
    "bicgstab",
    "bicgstabl",
    "block_cg",
    "BlockCGResult",
    "cg",
    "chebyshev_solve",
    "lsmr",
    "lsqr",
    "newton_krylov",
    "bratu_residual",
    "implicit_solve",
    "minres",
    "sstep_cg",
    "cgs",
    "tfqmr",
    "qmr",
    "gmres",
    "sstep_gmres",
    "fgmres",
    "lgmres",
    "block_gmres",
    "idrs",
    "gmres_dr",
    "gcrodr",
    "lanczos_bounds",
    "power_iteration_bound",
    "chebyshev_preconditioner",
    "chebyshev_stencil_preconditioner",
    "MultigridPlan",
    "anisotropic_multigrid_preconditioner",
    "convection_diffusion_multigrid_preconditioner",
    "helmholtz_shifted_laplacian_preconditioner",
    "csl_multigrid_preconditioner",
    "poisson3d_multigrid_preconditioner",
    "poisson_multigrid_preconditioner",
    "gmres_polynomial_preconditioner",
    "coarse_space_preconditioner",
    "dirichlet_poisson_modes",
    "anisotropic_apply",
    "anisotropic_matrix",
    "anisotropic_operator",
    "poisson3d_apply",
    "poisson3d_matrix",
    "poisson3d_operator",
    "poisson3d_spectral_bounds",
    "varcoef_apply",
    "varcoef_diagonal",
    "varcoef_matrix",
    "varcoef_multigrid_preconditioner",
    "varcoef_operator",
    "convection_diffusion_apply",
    "convection_diffusion_operator",
    "helmholtz_apply",
    "helmholtz_split_operator",
    "complex_to_split",
    "split_to_complex",
    "helmholtz_lambda_min",
    "helmholtz_matrix",
    "helmholtz_operator",
    "prolong_repeat",
    "restrict_sum",
    "hilbert_matrix",
    "poisson_apply",
    "poisson_matrix",
    "poisson_operator",
    "poisson_spectral_bounds",
    "tuned_poisson_preconditioner",
    "BSRMatrix",
    "COOMatrix",
    "CSRMatrix",
    "DIAMatrix",
    "ELLMatrix",
    "HYBMatrix",
    "bsr_from_dense",
    "coo_from_dense",
    "coo_to_hyb",
    "csr_from_dense",
    "csr_to_ell",
    "csr_to_hyb",
    "dia_from_dense",
    "ell_from_dense",
    "poisson_csr",
    "poisson_dia",
    "sparse_from_numpy",
    "sparse_operator",
    "stencil5_cuda",
    "chebk_cuda",
    "dia_spmv_cuda",
    "bsr_spmv_cuda",
    "cheb2_cuda",
    "cg_fused_update_cuda",
    "axpy_dot_cuda",
    "chebyshev_poisson_fused",
    "cg_fused_update",
    "axpy_dot",
    "GRID_AXIS",
    "grid_sharding",
    "init_multihost",
    "shard_grid_vector",
    "solver_mesh",
    "halo_chebyshev_preconditioner",
    "halo_exchange",
    "halo_poisson_operator",
    "halo_stencil_operator",
]

__version__ = "0.1.0"
