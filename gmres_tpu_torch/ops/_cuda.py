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

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

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
            fn = getattr(lib, f"gt_stencil5_{suffix}")
            fn.argtypes = [vp, vp, vp, vp, i32, i32] + [real] * 5 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_chebk_{suffix}")
            fn.argtypes = [vp, vp, vp, vp, i32, i32, real, vp, i32, vp,
                           i32, i32, i32, i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_cheb2_{suffix}")
            fn.argtypes = [vp, vp, vp, vp, i32, i32] + [real] * 7 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_rdma_interior_{suffix}")
            fn.argtypes = [vp, vp, i32, i32] + [real] * 7 + [i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_rdma_edges_{suffix}")
            fn.argtypes = [vp, vp, vp, i32, i32] + [real] * 3 + [i32, vp]
            fn.restype = i32
        lib.gt_stencil5_dd.argtypes = ([vp] * 4 + [i32, i32]
                                       + [ctypes.c_double] * 5 + [i32, vp])
        lib.gt_stencil5_dd.restype = i32
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"gt_dia_spmv_{suffix}")
            fn.argtypes = [vp, vp, vp, i32, i32, vp, i32, i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_bsr_spmv_{suffix}")
            fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_cg_update_{suffix}")
            fn.argtypes = [vp] * 9 + [i32, i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"gt_axpy_dot_{suffix}")
            fn.argtypes = [vp] * 7 + [i32, i32, i32, vp]
            fn.restype = i32
        lib.gt_cuda_error_string.argtypes = [i32]
        lib.gt_cuda_error_string.restype = ctypes.c_char_p
        lib.gt_chebk_max_fused_steps.argtypes = []
        lib.gt_chebk_max_fused_steps.restype = i32
        lib.gt_chebk_max_active_clusters.argtypes = [i32] * 7
        lib.gt_chebk_max_active_clusters.restype = i32
        lib.gt_fused_reduce_blocks.argtypes = [i32]
        lib.gt_fused_reduce_blocks.restype = i32
        _LIB = lib
    return _LIB


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


def check_grid(x: torch.Tensor, what: str) -> None:
    """Device, dtype, rank and contiguity checks shared by the wrappers."""
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    suffix(x.dtype)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected a 2-D grid, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if x.numel() >= 2**31 or x.shape[0] > 65535 * 8:
        raise ValueError(f"{what}: grid {tuple(x.shape)} too large for one launch")
