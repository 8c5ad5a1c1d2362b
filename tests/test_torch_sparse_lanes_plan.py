"""K3's and K4's launch on a block of lanes, on the CPU.

``sparse.spmv_lanes_plan`` is plain Python: the chunk of lanes a CUDA block
carries, the chunk count, the grid, the threads and the shared memory. Its
decisions are pinned here for both kernels, both dtypes and lane counts 1–17,
64 and 65535 (the launch's limit), with what it refuses; and the compiled
chunk lists of ``csrc/dia_spmv.cu`` and ``csrc/bsr_spmv.cu`` against the
module's. The wrappers pass the plan's chunk, grid, threads and shared bytes
to the kernels' C entries as they are. (The operators under
``torch.func.vmap`` are held to the lanes one by one and to gmres_tpu's
``jax.vmap`` in test_torch_batched_newton.py.)"""

import os
import re

import pytest
import torch

from gmres_tpu_torch.ops import sparse as tsp

LANES = list(range(1, 18)) + [64, 65535]
MAX_GRID_X, MAX_GRID_YZ = 2**31 - 1, 65535
MAX_SHARED = 232448  # 227 KB, the most a CUDA block can ask for on the H100
CSRC = os.path.join(os.path.dirname(tsp.__file__), os.pardir, "csrc")
# (rows, bs): K3's matrix rows; K4's block rows and block size.
SHAPES = {"K3": [(1, None), (1000 * 1000, None), (4096 * 4096, None)],
          "K4": [(1, 4), (512, 128), (7, 48), (33, 4), (5, 200), (256, 1024)]}


def _chunks(plan, lanes):
    """The lanes each chunk covers, as the kernels index them."""
    return [list(range(c * plan.chunk, min((c + 1) * plan.chunk, lanes)))
            for c in range(plan.chunks)]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_plan_covers_the_lanes_within_the_limits(kernel, dtype, lanes):
    """Each lane in exactly one chunk, in order, every chunk non-empty; the
    grid within CUDA's limits and covering the rows (K4: every row of every
    block row); no more shared memory than a CUDA block can have."""
    for rows, bs in SHAPES[kernel]:
        plan = tsp.spmv_lanes_plan(kernel, lanes, dtype, rows, bs)
        covered = _chunks(plan, lanes)
        assert [l for c in covered for l in c] == list(range(lanes))
        assert all(covered)
        assert plan.grid[0] <= MAX_GRID_X and max(plan.grid[1:]) <= MAX_GRID_YZ
        assert plan.threads == 256 and 0 <= plan.shared_bytes <= MAX_SHARED
        if kernel == "K3":
            assert plan.chunk in tsp.K3_CHUNKS
            assert plan.grid == (-(-rows // 256), plan.chunks, 1)
        else:
            assert plan.chunk in tsp.K4_CHUNKS[dtype]
            tiles = plan.grid[0] // (rows * plan.chunks)
            assert plan.grid == (rows * tiles * plan.chunks, 1, 1)
            assert (tiles - 1) * 32 < bs <= tiles * 32   # a CUDA block 32 rows


@pytest.mark.parametrize("kernel,lanes,dtype,expected", [
    ("K3", 1, torch.float64, (1, 1)),      # one vector: the single launch
    ("K3", 4, torch.float64, (4, 1)),      # the cg path's 4 lanes
    ("K3", 8, torch.float64, (8, 1)),
    ("K3", 9, torch.float64, (16, 1)),     # one partial chunk
    ("K3", 17, torch.float32, (16, 2)),    # a full chunk and a partial one
    ("K3", 3, torch.float32, (4, 1)),
    ("K4", 1, torch.float32, (1, 1)),
    ("K4", 4, torch.float32, (4, 1)),
    ("K4", 8, torch.float32, (8, 1)),      # the headline: the matrix once
    ("K4", 9, torch.float32, (8, 2)),
    ("K4", 16, torch.float32, (8, 2)),
    ("K4", 8, torch.float64, (4, 2)),      # float64: two chunks of 4
    ("K4", 3, torch.float64, (4, 1)),
    ("K4", 1, torch.float64, (1, 1)),
])
def test_plan_routes_the_lane_counts(kernel, lanes, dtype, expected):
    plan = tsp.spmv_lanes_plan(kernel, lanes, dtype, 512, 128 if kernel == "K4" else None)
    assert (plan.chunk, plan.chunks) == expected


@pytest.mark.parametrize("call,error,match", [
    (lambda: tsp.spmv_lanes_plan("K4", 8, torch.float32, 512, 0), ValueError, "blocks of 1"),
    (lambda: tsp.spmv_lanes_plan("K4", 8, torch.float32, 512, 46341), ValueError,
     "blocks of 1"),
    (lambda: tsp.spmv_lanes_plan("K4", 8, torch.float32, 512), ValueError, "blocks of 1"),
    (lambda: tsp.spmv_lanes_plan("K3", 8, torch.float32, 512, 128), ValueError,
     "no block size"),
    (lambda: tsp.spmv_lanes_plan("K4", 65535, torch.float32, 2**20, 512), ValueError,
     "CUDA blocks"),
    (lambda: tsp.spmv_lanes_plan("K5", 8, torch.float32, 512), ValueError, "K3 or K4"),
    (lambda: tsp.spmv_lanes_plan("K3", 0, torch.float32, 512), ValueError, "0 lanes"),
    (lambda: tsp.spmv_lanes_plan("K3", 65536, torch.float32, 512), ValueError, "lanes"),
    (lambda: tsp.spmv_lanes_plan("K4", 8, torch.float16, 512, 128), TypeError, "float16"),
])
def test_plan_refuses_what_the_kernels_cannot_take(call, error, match):
    with pytest.raises(error, match=match):
        call()


def test_plan_takes_what_one_lane_took_and_more():
    """K4 stages nothing in shared memory (its chunk's x entries live in
    registers), so it takes blocks past the one-lane x staging's old 48 KB
    (12288 float32 columns, 6144 float64) at its largest chunk."""
    plan = tsp.spmv_lanes_plan("K4", 16, torch.float32, 4, 12289)
    assert (plan.chunk, plan.shared_bytes) == (8, 0)
    plan = tsp.spmv_lanes_plan("K4", 16, torch.float64, 4, 20000)
    assert (plan.chunk, plan.chunks, plan.shared_bytes) == (4, 4, 0)


def _compiled(source, macro):
    with open(os.path.join(CSRC, source)) as f:
        text = f.read().replace("\\\n", " ")
    line = re.search(rf"#define {macro}\(X\)(.*)", text).group(1)
    return [tuple(int(v) for v in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", line)]


def test_compiled_chunks_match_the_module():
    """The chunk sizes the sources compile are the module's, each dtype's
    (a launch with any other returns an error), and the plan routes every
    one of them."""
    assert [c for (c,) in _compiled("dia_spmv.cu", "K3_CHUNKS")] == list(tsp.K3_CHUNKS)
    for dtype, macro in ((torch.float32, "K4_CHUNKS_F32"), (torch.float64, "K4_CHUNKS_F64")):
        assert [c for (c,) in _compiled("bsr_spmv.cu", macro)] == list(tsp.K4_CHUNKS[dtype])
    for kernel, dtype, compiled, bs in (
            ("K3", torch.float32, tsp.K3_CHUNKS, None),
            ("K4", torch.float32, tsp.K4_CHUNKS[torch.float32], 128),
            ("K4", torch.float64, tsp.K4_CHUNKS[torch.float64], 128)):
        routed = {tsp.spmv_lanes_plan(kernel, lanes, dtype, 512, bs).chunk
                  for lanes in LANES}
        assert routed == set(compiled)
