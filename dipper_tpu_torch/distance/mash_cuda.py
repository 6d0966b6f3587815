"""ctypes wrappers of the Hopper mash kernels:

- csrc/mash_merge_count.cu, the port of dipper_tpu/distance/
  mash_pallas.py::mash_inter_pallas: int32 intersection counts;
- csrc/mash_rows_dist.cu, the port of mash_pallas.py::
  mash_rows_vs_bank_pallas: the distances those counts index in the host
  table, written directly (f32 or f64);
- csrc/mash_cluster_inter.cu, the port of dipper_tpu/dc/pipeline.py::
  _inter_blockdiag_pallas: for every cluster of a bucket, its members'
  counts against its own witnesses, rows picked from the rank bank by
  index lists inside the kernel.

The first two are one tile kernel (csrc/mash_walk.cuh: rows staged in shared
memory, a warp per pair, the walk split over the lanes by merge path) and
are built from the repository's sources at first use (csrc/build.py).
The third walks pairs the same way. They take rank rows, not the Pallas
kernel's tagged keys (2r+1 / 2r): the walk compares ranks directly, with
equal values resolved B-first. Their plain PyTorch versions are
distance/mash.py::merged_inter_count_ref, mash_rows_vs_bank and
cluster_inter_ref.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dipper_tpu_torch.csrc.build import check_launch, load

# Kernel launches made by this process, one counter per kernel;
# chip_smoke.py resets them and reads them to show that a run went
# through the kernels.
LAUNCHES = 0            # mash_merge_count
ROWS_DIST_LAUNCHES = 0  # mash_rows_dist
CLUSTER_LAUNCHES = 0    # mash_cluster_inter

# the launchers' return code for a sketch_size whose shared-memory staging
# does not fit (kSketchTooLarge in the .cu files)
_SKETCH_TOO_LARGE = -1
# the kernels' dynamic shared-memory budget (mash::kSmemBudget)
_SMEM_BYTES = 232448

_MERGE_COUNT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
_CLUSTER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ROWS_DIST_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]


def _smem_bytes(sketch_size: int, item: int | None) -> int:
    """Shared memory of the smallest tile (one row a side), as
    mash::launch_tiles reckons it: the [s+1] table of `item`-byte values
    (none for the counts), one query row and two bank rows of s + 1 ranks,
    each part rounded up to 16 bytes, and one result."""
    table = 0 if item is None else -(-item * (sketch_size + 1) // 16) * 16
    row = -(-(sketch_size + 1) // 4) * 16
    return table + 3 * row + (4 if item is None else item)


def max_sketch_size(dtype_name: str | None = None) -> int:
    """Largest sketch_size the merge-count kernel (dtype_name None) or the
    distance kernel in `dtype_name` takes: the smallest tile must fit the
    block's 232,448 bytes of shared memory."""
    item = None if dtype_name is None else np.dtype(dtype_name).itemsize
    s = _SMEM_BYTES // 12
    while _smem_bytes(s, item) > _SMEM_BYTES:
        s -= 1
    return s


def _check_ranks(bank_ranks: torch.Tensor, query_ranks: torch.Tensor,
                 sketch_size: int) -> None:
    for nm, t in (("bank_ranks", bank_ranks), ("query_ranks", query_ranks)):
        if t.device.type != "cuda":
            raise ValueError(f"{nm} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{nm} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{nm} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    if query_ranks.device != bank_ranks.device:
        raise ValueError("bank_ranks and query_ranks are on different devices")
    (N, M), (Q, Mq) = bank_ranks.shape, query_ranks.shape
    if Mq != M:
        raise ValueError(f"row widths differ: bank {M}, queries {Mq}")
    if not 1 <= sketch_size <= M:
        raise ValueError(f"sketch_size {sketch_size} outside [1, {M}]")
    if max(N, Q, M) >= 2**31:
        raise ValueError("shape too large for the kernel's int arguments")


def _too_large(sketch_size: int, what: str, limit: int) -> ValueError:
    return ValueError(
        f"sketch_size {sketch_size} is too large for the CUDA kernel: {what} "
        f"must fit a block's {_SMEM_BYTES:,} bytes of shared memory "
        f"(sketch_size <= {limit}); use "
        "--device cpu")


def mash_inter_cuda(bank_ranks: torch.Tensor, query_ranks: torch.Tensor, *,
                    sketch_size: int) -> torch.Tensor:
    """bank_ranks int32 [N, M] (rows ascending), query_ranks int32 [Q, M],
    both contiguous on one CUDA device, M >= sketch_size -> int32 [Q, N]
    intersection counts. Launches on the current stream and returns
    without synchronizing."""
    global LAUNCHES
    _check_ranks(bank_ranks, query_ranks, sketch_size)
    N, M = bank_ranks.shape
    Q = query_ranks.shape[0]
    out = torch.empty((Q, N), dtype=torch.int32, device=bank_ranks.device)
    if N == 0 or Q == 0:
        return out
    lib = load("mash_merge_count", _MERGE_COUNT_ARGS)
    with torch.cuda.device(bank_ranks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mash_merge_count(
            bank_ranks.data_ptr(), query_ranks.data_ptr(), out.data_ptr(),
            N, Q, M, sketch_size, stream)
    if rc == _SKETCH_TOO_LARGE:
        raise _too_large(sketch_size, "one query row and two bank rows",
                         max_sketch_size())
    check_launch(lib, "mash_merge_count", rc)
    LAUNCHES += 1
    return out


def mash_rows_dist_cuda(bank_ranks: torch.Tensor, query_ranks: torch.Tensor,
                        table: torch.Tensor, *, sketch_size: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """bank_ranks int32 [N, M] (rows ascending), query_ranks int32 [Q, M],
    both contiguous on one CUDA device, M >= sketch_size; table float32 or
    float64 [sketch_size + 1] on that device (distance/mash.py::
    _dist_table) -> [Q, N] distances table[inter], in the table's dtype.

    `out`, if given, is a [Q, N] tensor of the table's dtype whose rows are
    contiguous (stride(1) == 1, any row stride): the kernel writes into it
    in place, e.g. a block of rows of an [N, N] matrix. Launches on the
    current stream and returns without synchronizing."""
    global ROWS_DIST_LAUNCHES
    _check_ranks(bank_ranks, query_ranks, sketch_size)
    N, M = bank_ranks.shape
    Q = query_ranks.shape[0]
    if table.device != bank_ranks.device:
        raise ValueError(f"table is on {table.device}, the ranks on "
                         f"{bank_ranks.device}")
    if table.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"table must be float32 or float64, got {table.dtype}")
    if table.shape != (sketch_size + 1,) or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [{sketch_size + 1}] "
                         f"vector, got shape {tuple(table.shape)}")
    if out is None:
        out = torch.empty((Q, N), dtype=table.dtype, device=table.device)
    elif (out.shape != (Q, N) or out.dtype != table.dtype
          or out.device != table.device or (Q > 1 and out.stride(0) < N)
          or (N > 1 and out.stride(1) != 1)):
        raise ValueError(
            f"out must be a [{Q}, {N}] {table.dtype} tensor on {table.device} "
            f"with contiguous rows, got {tuple(out.shape)} {out.dtype} "
            f"{out.device} strides {out.stride()}")
    if N == 0 or Q == 0:
        return out
    lib = load("mash_rows_dist", _ROWS_DIST_ARGS)
    with torch.cuda.device(bank_ranks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mash_rows_dist(
            bank_ranks.data_ptr(), query_ranks.data_ptr(), table.data_ptr(),
            out.data_ptr(), N, Q, M, sketch_size, max(out.stride(0), N),
            int(table.dtype == torch.float64), stream)
    if rc == _SKETCH_TOO_LARGE:
        raise _too_large(sketch_size,
                         "the distance table, one query row and two bank rows",
                         max_sketch_size(str(table.dtype).split(".")[1]))
    check_launch(lib, "mash_rows_dist", rc)
    ROWS_DIST_LAUNCHES += 1
    return out


def mash_cluster_inter_cuda(ranks: torch.Tensor, wit: torch.Tensor,
                            mem: torch.Tensor, *,
                            sketch_size: int) -> torch.Tensor:
    """ranks int32 [N, M] (rows ascending), wit int32 [c, W] and mem int32
    [c, Q] (every index in [0, N)), on one CUDA device, M >= sketch_size
    -> int32 [c, Q, W]: out[i, q, w] the intersection count of bank row
    ranks[wit[i, w]] and query row ranks[mem[i, q]]. ranks and wit are
    contiguous; mem's rows are contiguous at any row stride, so that mem
    may be wit[:, W - Q:], a view of the witness lists' tail, as D&C's
    phase 3 builds them: the kernel then stages those rows once. Launches on the
    current stream and returns without synchronizing."""
    global CLUSTER_LAUNCHES
    _check_ranks(ranks, ranks, sketch_size)
    for nm, t in (("wit", wit), ("mem", mem)):
        if t.device != ranks.device:
            raise ValueError(f"{nm} is on {t.device}, ranks on {ranks.device}")
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{nm} must be a 2-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if wit.shape[0] != mem.shape[0]:
        raise ValueError(f"wit has {wit.shape[0]} clusters, mem "
                         f"{mem.shape[0]}")
    N, M = ranks.shape
    (c, W), Q = wit.shape, mem.shape[1]
    ld_mem = mem.stride(0) if c > 1 else Q
    if not wit.is_contiguous() or (Q > 1 and mem.stride(1) != 1) \
            or ld_mem < Q:
        raise ValueError("wit must be contiguous and mem's rows contiguous, "
                         f"got strides {wit.stride()} and {mem.stride()}")
    out = torch.empty((c, Q, W), dtype=torch.int32, device=ranks.device)
    if N == 0 or out.numel() == 0:
        return out
    lib = load("mash_cluster_inter", _CLUSTER_ARGS)
    with torch.cuda.device(ranks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mash_cluster_inter(
            ranks.data_ptr(), wit.data_ptr(), mem.data_ptr(), out.data_ptr(),
            N, c, W, Q, ld_mem, M, sketch_size, stream)
    if rc == _SKETCH_TOO_LARGE:
        raise _too_large(sketch_size, "one member row and two witness rows",
                         max_sketch_size())
    check_launch(lib, "mash_cluster_inter", rc)
    CLUSTER_LAUNCHES += 1
    return out
