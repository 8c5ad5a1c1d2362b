"""Build and load the port's CUDA kernels (``gmres_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface, loaded with ``ctypes``, at the first launch — never at import,
so the package imports on machines without ``nvcc`` or a card. Each source
is compiled by its own ``nvcc`` process, all started together, and the
objects are then linked into the library. The library name carries a hash
of the sources and flags; it is built to a temporary file and renamed into
place, so an interrupted or racing build never satisfies the existence
check (the scheme of ``native/loader.py``). The build directory,
``gmres_tpu_torch/_build/``, is listed in ``.gitignore``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import math
import os
import shutil
import subprocess
import time

import torch
import torch.autograd.forward_ad as fwad

from gmres_tpu_torch.ops.blas import is_dtensor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    # Products and sums round separately, as in the plain PyTorch versions.
    "-fmad=false",
    # Registers, shared memory and spills per kernel, kept in the build log.
    "-Xptxas", "-v",
)

_LIB = None
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME and os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _build() -> str:
    global build_log, build_seconds
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libgmres_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(s)}\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(s))
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            # K1, K1rr, K1cr and K2 take a lane count: the grids are one
            # contiguous (lanes, rows, cols) block (1 for one grid).
            # K1 also takes (lanes, cols) halo rows and a (lanes, 5) device
            # array of per-lane coefficients (null: the five values given).
            fn = getattr(lib, f"gt_stencil5_{suffix}")
            fn.argtypes = ([vp, vp, vp, vp, i32, i32, i32] + [real] * 5
                           + [vp, i32, vp])
            fn.restype = i32
            fn = getattr(lib, f"gt_residual_restrict_{suffix}")
            fn.argtypes = [vp, vp, vp, i32, i32, i32] + [real] * 5 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_correct_residual_{suffix}")
            fn.argtypes = [vp] * 5 + [i32, i32, i32] + [real] * 5 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_chebk_{suffix}")
            fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, real, vp, i32, vp,
                           i32, i32, i32, i32, i32, vp]
            fn.restype = i32
            # K5 and K8 take a lane count too, with (lanes, cols) halo rows.
            fn = getattr(lib, f"gt_cheb2_{suffix}")
            fn.argtypes = [vp, vp, vp, vp, i32, i32, i32] + [real] * 7 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_rdma_interior_{suffix}")
            fn.argtypes = [vp, vp, i32, i32, i32] + [real] * 7 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_rdma_edges_{suffix}")
            fn.argtypes = [vp, vp, vp, i32, i32, i32] + [real] * 3 + [i32, vp]
            fn.restype = i32
        lib.gt_stencil5_dd.argtypes = ([vp] * 4 + [i32, i32]
                                       + [ctypes.c_double] * 5 + [i32, vp])
        lib.gt_stencil5_dd.restype = i32
        for suffix in ("f32", "f64"):
            # K3 and K4 take a lane count: x and y are contiguous (lanes, n)
            # blocks (1 for one vector), one matrix for every lane; then the
            # launch of sparse.spmv_lanes_plan: chunk, grid (x, y, z),
            # threads, shared bytes.
            fn = getattr(lib, f"gt_dia_spmv_{suffix}")
            fn.argtypes = [vp, vp, vp, i32, i32, i32, vp] + [i32] * 9 + [vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_bsr_spmv_{suffix}")
            fn.argtypes = [vp, vp, vp, vp] + [i32] * 12 + [vp]
            fn.restype = i32
            # α (pointer, kind, value), the vectors, partials, counter, sum,
            # n, vector width, blocks, device, stream.
            fn = getattr(lib, f"gt_cg_update_{suffix}")
            fn.argtypes = ([vp, i32, ctypes.c_double] + [vp] * 9
                           + [ctypes.c_longlong, i32, i32, i32, vp])
            fn.restype = i32
            fn = getattr(lib, f"gt_axpy_dot_{suffix}")
            fn.argtypes = ([vp, i32, ctypes.c_double] + [vp] * 7
                           + [ctypes.c_longlong, i32, i32, i32, vp])
            fn.restype = i32
        lib.gt_empty.argtypes = [i32, vp]
        lib.gt_empty.restype = i32
        lib.gt_cuda_error_string.argtypes = [i32]
        lib.gt_cuda_error_string.restype = ctypes.c_char_p
        lib.gt_chebk_max_fused_steps.argtypes = []
        lib.gt_chebk_max_fused_steps.restype = i32
        lib.gt_chebk_max_active_clusters.argtypes = [i32] * 7
        lib.gt_chebk_max_active_clusters.restype = i32
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def entry(name: str, dtype: torch.dtype):
    """The C entry point ``{name}_{f32|f64}`` for ``dtype``, resolved once
    (raises TypeError on any other dtype, and builds the library at the
    first call)."""
    return getattr(load(), f"{name}_{suffix(dtype)}")


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = load().gt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def suffix(dtype: torch.dtype) -> str:
    """The C entry point suffix for a dtype; raises on any other dtype."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"CUDA kernels are built for float32 and float64, not {dtype}")


def scalar_array(vals, dtype: torch.dtype):
    """A host ctypes array of ``vals`` rounded to ``dtype``."""
    ct = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    return (ct * max(len(vals), 1))(*vals)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_fc = getattr(torch._C, "_functorch", None)
_functorch_wrapped = getattr(_fc, "is_functorch_wrapped_tensor", None)
_batched = getattr(_fc, "is_batchedtensor", None)


def vmapped(*ts) -> bool:
    """True where one of ``ts`` is a tensor that ``torch.func.vmap`` wraps
    at its innermost level (a batched operand or coefficient): the routed
    entries of K1–K4 then go through their vmap rules (``through_lanes``)."""
    return _batched is not None and any(
        isinstance(t, torch.Tensor) and _batched(t) for t in ts)


def _vmap_levels():
    """{level: batch size} of the ``torch.func.vmap`` transforms at the top
    of the transform stack, down to the first transform of another kind
    (empty where the innermost transform is not vmap)."""
    sizes = {}
    for interp in reversed(_fc.get_interpreter_stack() or ()):
        if interp.key() != _fc.TransformType.Vmap:
            break
        sizes[interp.level()] = _fc.CVmapInterpreterPtr(interp).batchSize()
    return sizes


def _peel(a, sizes):
    """(plain tensor, {level: its batch dim there}) for a tensor that vmap
    levels among ``sizes`` wrap as batched tensors, each directly over the
    next; None where any other transform wraps it."""
    found = {}
    while _functorch_wrapped(a):
        level = _fc.maybe_get_level(a)
        if not _batched(a) or level not in sizes:
            return None
        found[level] = _fc.maybe_get_bdim(a)
        a = _fc.get_unwrapped(a)
    return a, found


def _lanes_of(args):
    """(levels, their batch sizes, batch dims, plain args) where the innermost
    transforms are ``torch.func.vmap`` levels and each tensor among
    ``args`` that a transform wraps is batched at some of those levels
    directly over a plain tensor (the batch dims None for the other args,
    which stay as given), and neither autograd nor forward-mode AD tracks a
    plain arg; None otherwise (vmap composed with another transform, or a
    tracked operand or coefficient).

    One level (``torch.func.vmap`` of an operator): each batched tensor
    keeps its own batch dim, and the lanes are that level's batch size. Nested
    levels (a lane that is itself a block: ``row_apply`` inside vmap): the
    levels any arg is batched at, outermost first, are flattened into one
    leading lane axis of their product of batch sizes, a tensor that is
    not batched at one of them repeated along it."""
    sizes = _vmap_levels()
    if not sizes:
        return None
    peeled, used = [], set()
    for a in args:
        if isinstance(a, torch.Tensor) and _functorch_wrapped(a):
            got = _peel(a, sizes)
            if got is None:
                return None
            peeled.append(got)
            used.update(got[1])
        else:
            peeled.append((a, None))
    if not used or any(tracked_by(p) is not None for p, _ in peeled):
        return None
    levels = sorted(used)
    shape = [sizes[lv] for lv in levels]
    if len(levels) == 1:
        dims = [None if f is None else f[levels[0]] for _, f in peeled]
        return levels, shape, dims, [p for p, _ in peeled]
    dims, plain = [], []
    for p, found in peeled:
        if found is None:
            dims.append(None)
            plain.append(p)
            continue
        dims.append(0)
        plain.append(_flatten_levels(p, found, levels, shape))
    return levels, shape, dims, plain


def _flatten_levels(p, found, levels, shape):
    """A plain tensor batched at some of ``levels`` (``found``: level →
    batch dim, each counted in the tensor one level up) as (Π shape, …):
    the levels' batch dims moved first in order, the levels it is not
    batched at repeated."""
    # Unwrapping from the innermost level, each batch dim indexes the
    # tensor left once the levels inside it are removed: recover the
    # physical positions from the outermost level in.
    lead = 0
    for lv in levels:
        if lv in found:
            p = p.movedim(found[lv] + lead, lead)
        else:
            p = p.unsqueeze(lead).expand(*p.shape[:lead], shape[levels.index(lv)],
                                         *p.shape[lead:])
        lead += 1
    return p.reshape((-1,) + tuple(p.shape[lead:]))


def through_lanes(lanes_fn, function, *args):
    """A routed kernel entry under ``torch.func.vmap``: ``lanes_fn(dims,
    lanes, *plain args)`` (one batched call for all lanes; the same body as
    ``function``'s vmap rule) on the tensors vmap wraps, its output (a
    tensor or a tuple of them, lanes first) wrapped back at vmap's level.
    Unwrapping the one level here costs ~10 µs a call, against ~270 µs
    through an autograd.Function's vmap rule (functorch's Python
    ``custom_function_call``; on the CPU, torch 2.13). Nested vmap levels
    (a block of rows in each lane) are one lane axis of the product of
    their sizes for ``lanes_fn``, and the output is split back and wrapped
    at each level. Where vmap is composed with another transform, or
    autograd or forward-mode AD tracks an unwrapped operand or coefficient,
    ``function.apply(*args)``: functorch calls its vmap rule at each level,
    and the rule keeps what tracks the operands (K1's takes ``Stencil5Grid``
    or ``Stencil5Lanes`` on the block)."""
    found = _lanes_of(args)
    if found is None:
        return function.apply(*args)
    levels, shape, dims, plain = found
    out = lanes_fn(dims, math.prod(shape), *plain)
    if isinstance(out, tuple):
        return tuple(_rewrap(o, levels, shape) for o in out)
    return _rewrap(out, levels, shape)


@contextlib.contextmanager
def below_vmap():
    """The ``torch.func.vmap`` levels at the top of the transform stack set
    aside while the body runs: a block form that unwrapped its operands
    (``parallel/halo.py:BlockSharded``) runs on them as no transform sees
    them, so that DTensor's own autograd.Functions (``to_local``,
    ``from_local``) meet no active transform. It pops and pushes functorch's
    dynamic layer stack (``torch._functorch.pyfunctorch``), a private API
    that a torch release may change (ROADMAP queue 2; the block tests of
    tests/test_torch_halo_blocks.py fail first if it does)."""
    from torch._functorch.pyfunctorch import (
        pop_dynamic_layer_stack,
        push_dynamic_layer_stack,
    )

    popped = [pop_dynamic_layer_stack() for _ in range(len(_vmap_levels()))]
    try:
        yield
    finally:
        for layer in reversed(popped):
            push_dynamic_layer_stack(layer)


def _rewrap(out, levels, shape):
    """A (lanes, …) output wrapped back at ``levels`` (one lane axis of
    their batch sizes ``shape``, split back where they are nested)."""
    if len(levels) > 1:
        out = out.reshape(tuple(shape) + tuple(out.shape[1:]))
    for lv in levels:
        out = _fc._add_batch_dim(out, 0, lv)
    return out


def has_lanes(t) -> bool:
    """True where a ``torch.func.vmap`` level batches ``t`` under any
    wrappers of other transforms: its value differs by lane, and reading
    it as one number fails."""
    while isinstance(t, torch.Tensor) and _functorch_wrapped is not None \
            and _functorch_wrapped(t):
        if _batched(t):
            return True
        t = _fc.get_unwrapped(t)
    return False


def tracked_by(t) -> str | None:
    """What would see ``t`` pass through a kernel: "autograd" where it
    requires grad and grad mode is on, "forward-mode AD" where it carries a
    tangent, "a torch.func transform" where one wraps it; None otherwise
    (and for anything that is not a tensor)."""
    if not isinstance(t, torch.Tensor):
        return None
    if _functorch_wrapped is not None and _functorch_wrapped(t):
        return "a torch.func transform"
    if t.requires_grad and torch.is_grad_enabled():
        return "autograd (it requires grad)"
    if (getattr(fwad, "_current_level", -1) >= 0
            and fwad.unpack_dual(t).tangent is not None):
        return "forward-mode AD (it carries a tangent)"
    return None


def refuse_transforms(what: str, kernel: str, *tensors) -> None:
    """Raise where the ctypes wrapper ``what`` of ``kernel`` is handed a
    tensor (an operand, a halo row, a coefficient, a scalar) that
    ``tracked_by`` names. A kernel reads raw pointers and values: a tracked
    tensor would lose its gradient or tangent silently, and a wrapped one
    has no storage to read. Only K1's full-grid route
    (``ops/stencil.py:Stencil5Grid``) has autograd and forward-mode rules;
    it calls the wrapper with plain tensors from inside its
    autograd.Function. Under ``torch.func.vmap`` the routed entries of K1
    (with its V-cycle forms), K2, K3 and K4 take their vmap rules, which
    call the wrappers on the plain (lanes, …) block; a wrapper called
    directly on a batched tensor refuses it here like any other."""
    for t in tensors:
        why = tracked_by(t)
        if why is not None:
            raise RuntimeError(
                f"{what}: kernel {kernel} (route cuda) has no autograd or torch.func "
                f"rule, and a tensor it was handed is tracked by {why}. Only K1's "
                "full-grid route (stencil_5pt_pallas) is differentiable on the card; "
                "ROADMAP: transposes of K2–K8. Differentiate on CPU tensors (the "
                "plain versions), or run under torch.no_grad(). Under torch.func.vmap, "
                "call the routed entries of K1–K4 (stencil_5pt_pallas, "
                "residual_restrict, correct_residual, poly_stencil_smoother_pallas, "
                "the sparse operators), which batch; K5 and K8 batch on the halo route "
                "(a block of rows of a row-sharded grid through ops/blas.py:row_apply: "
                "one exchange, one launch); K6 and K7 have no vmap rule (ROADMAP: "
                "batched forms of K6 and K7).")


# Where a DTensor goes instead of a kernel wrapper, by kernel.
_DTENSOR_ROUTES = {
    "K1": "a plain operator takes a DTensor through the halo route "
          "(ops/stencil.py:stencil_5pt_pallas -> parallel/halo.py: one halo "
          "exchange and K1's halo form on each rank's block; a block of rows "
          "through ops/blas.py:row_apply, one exchange and one launch of the "
          "halo form on the rank's (rows, …) lane block)",
    "K1rr": "a cycle on a row-sharded DTensor runs on each rank's block: the mesh= "
            "cycle, or a mesh=None cycle's distributed cycle on the DTensor's mesh "
            "(precond/multigrid.py:_on_the_operands_mesh, ROADMAP item 8.6b)",
    "K2": "a cycle on a row-sharded DTensor runs on each rank's block: the mesh= "
          "cycle, or a mesh=None cycle's distributed cycle on the DTensor's mesh "
          "(precond/multigrid.py:_on_the_operands_mesh, ROADMAP item 8.6b); K2 sees "
          "the plain levels below its replicated level only",
    "K5": "cbpr2 on a row-sharded DTensor is halo_chebyshev_preconditioner(mesh, ...), "
          "and on a block of rows of one row_apply of it (one exchange, one launch on "
          "the rank's lane block)",
    "K6": "the pair stencils take each rank's block, never a DTensor",
    "K7a": "the CG updates take each rank's block, never a DTensor",
    "K8": "the RDMA route on a row-sharded DTensor is rdma_stencil_operator(mesh) or "
          "rdma_chebyshev_preconditioner(mesh, ...), and on a block of rows one "
          "row_apply of either (one message each way, one interior launch on the "
          "rank's lane block)",
    "K3": "a sparse operator on a row-sharded DTensor applies each rank's rows: K3 on "
          "the rank's DIA rows, x widened by a halo exchange "
          "(ops/sparse.py:_RankRows, ROADMAP item 8.7)",
    "K4": "a sparse operator on a row-sharded DTensor applies each rank's rows: K4 on "
          "the rank's block rows, x widened by a halo exchange "
          "(ops/sparse.py:_RankRows, ROADMAP item 8.7)",
}
_DTENSOR_ROUTES["K1cr"] = _DTENSOR_ROUTES["K1rr"]
_DTENSOR_ROUTES["K7b"] = _DTENSOR_ROUTES["K7a"]


def refuse_dtensor(what: str, kernel: str, *tensors) -> None:
    """Raise TypeError where the wrapper ``what`` of ``kernel`` is handed a
    ``DTensor``: a DTensor's ``data_ptr()`` is 0 and its shape is the whole
    grid's, so a launch would read and write through a null pointer. The
    message names the route a DTensor takes instead. Nothing is gathered
    and nothing falls back to the CPU."""
    for t in tensors:
        if is_dtensor(t):
            route = _DTENSOR_ROUTES[kernel]
            raise TypeError(
                f"{what}: kernel {kernel} takes a plain tensor, and was handed a "
                f"DTensor (placements {tuple(t.placements)}): {route}.")


# Lanes of one batched launch, at most (the lane is a grid dimension of
# its own: gridDim.y or gridDim.z, at most 65535).
MAX_LANES = 65535


def check_grid(what: str, kernel: str, *grids: torch.Tensor,
               lanes: bool = False) -> None:
    """``refuse_dtensor`` and ``refuse_transforms`` on every grid, then the
    device, dtype, rank and contiguity checks shared by the wrappers. With
    ``lanes`` (K1's forms and K2), every tensor may instead be a
    (lanes, rows, cols) block, all of one rank and with the same lanes: one
    launch takes the block, each lane a grid one launch takes."""
    refuse_dtensor(what, kernel, *grids)
    refuse_transforms(what, kernel, *grids)
    rank = grids[0].dim() if lanes and grids[0].dim() == 3 else 2
    for x in grids:
        if not x.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
        suffix(x.dtype)
        if x.dim() != rank:
            raise ValueError(f"{what}: expected a 2-D grid"
                             + (" or a (lanes, rows, cols) block" if lanes else "")
                             + f", got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous tensor")
        if rank == 3 and not 1 <= x.shape[0] == grids[0].shape[0] <= MAX_LANES:
            raise ValueError(f"{what}: {x.shape[0]} lanes (1 to {MAX_LANES}, the "
                             "same in every block)")
        grid = x.shape[-2:]
        if grid.numel() >= 2**31 or grid[0] > 65535 * 8:
            raise ValueError(f"{what}: grid {tuple(grid)} too large for one launch")

