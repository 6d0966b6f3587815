"""ctypes wrappers of D&C phase 3's Hopper kernels, built from the
repository's sources at first use (csrc/build.py). Both port the JAX
package's _cluster_step (dipper_tpu/dc/pipeline.py:180-225), an XLA
program:

- csrc/dc_stream_block.cu (kernel 8a): a row block of a streamed cluster's
  build (every member's masked score, splice, flags and walk) in one
  launch on a thread-block cluster (`stream_block`). Its plain version is
  dc/cluster.py::_stream_plain.
- csrc/dc_cluster_build.cu (kernel 8b): the whole local build of a chunk
  of clusters of one size bucket (`build_chunk`), by the bucket's plan
  (a warp a cluster or a block a cluster with the state in shared memory,
  or a block a cluster over device memory; `kernel_plan` reports it). Its
  plain version is dc/cluster.py::build_clusters_plain.

dc/cluster_model.py models both plans. Every entry point launches on the
current stream without synchronizing; on a CPU tensor each raises, its
caller taking the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.placement.kclosest import K, TreeState

# Launches made by this process of each kernel (chip_smoke.py resets them
# and reads them to show that a run went through the kernels)
STREAM_BLOCK_LAUNCHES = 0
CLUSTER_BUILD_LAUNCHES = 0

# blocks of kernel 8a's thread-block cluster (1 to 16): 16 took a row
# block of D&C 30K's streamed cluster in 10% less time than 8 (PERF.md, PR
# 18)
STREAM_CTAS = 16

_STREAM_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BUILD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2
               + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 4
               + [ctypes.c_void_p])
_PLANS = ("warp", "block", "global")


def kernel_plan(cmax: int, dtype) -> tuple:
    """Kernel 8b's plan at bucket width cmax for `dtype` (float32 or
    float64), as the built library's dc_cluster_build_plan reports it:
    (kind, threads a block, clusters a block, dynamic shared memory bytes a
    block); cluster_model.kernel_config mirrors it."""
    lib = load("dc_cluster_build", _BUILD_ARGS)
    fn = lib.dc_cluster_build_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    check_launch(lib, "dc_cluster_build",
                 fn(cmax, int(dtype == torch.float64), out))
    return _PLANS[out[0]], out[1], out[2], out[3]


def _check_state(st: TreeState, scoreable, what: str, batched: bool):
    """The state's arrays and flags on one CUDA device, contiguous, of the
    types and shapes the kernels take ([E] or, `batched`, [C, E]); raises
    ValueError otherwise. Returns (E, dtype, device)."""
    dev = st.e.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs a CUDA state, got one on {dev}")
    dtype = st.length.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"length must be float32 or float64, got {dtype}")
    lead = tuple(st.e.shape[:-1])
    if len(lead) != (1 if batched else 0):
        raise ValueError(f"{what} takes {'[C, E]' if batched else '[E]'} "
                         f"arrays, got e of shape {tuple(st.e.shape)}")
    E = st.e.shape[-1]
    want = {"e": (torch.int32, (E,)), "belong": (torch.int32, (E,)),
            "length": (dtype, (E,)), "rev": (torch.int32, (E,)),
            "cdis": (dtype, (E, K)), "cid": (torch.int32, (E, K))}
    arrays = {f: getattr(st, f) for f in want}
    arrays["scoreable"] = scoreable
    want["scoreable"] = (torch.bool, (E,))
    for name, a in arrays.items():
        dt, shape = want[name]
        if a.device != dev or a.dtype != dt or tuple(a.shape) != lead + shape:
            raise ValueError(f"{name} must be {dt} {lead + shape} on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{what} needs contiguous arrays: {name} has "
                             f"strides {a.stride()}")
    if not 1 <= E < 2**30:
        raise ValueError(f"{what} takes 1 to 2**30 - 1 edge slots, got {E}")
    return E, dtype, dev


def stream_block(st: TreeState, scoreable: torch.Tensor, rows: torch.Tensor,
                 kq0: int, cmax: int, ctas: int | None = None,
                 stream: int | None = None) -> tuple:
    """Launches kernel 8a: members kq0 .. kq0 + n - 1 of a streamed cluster
    (a state of one tree, [2 + 4 cmax] arrays, adjacency [2 + 2 cmax, 3],
    flags [E]) from their rows ([n, W], the state's float type, unit stride
    along a row), in place and in one launch on a cluster of `ctas` blocks
    (default STREAM_CTAS).
    Returns (out_i, out_f): the last member's eid, the splice's (xe, ye)
    (int32 [3]) and (frac, add). Does not move st.idx. No host sync."""
    global STREAM_BLOCK_LAUNCHES
    E, dtype, dev = _check_state(st, scoreable, "dc_stream_block", False)
    if E != 2 + 4 * cmax:
        raise ValueError(f"{E} edge slots for bucket width {cmax}")
    _check_adj(st.adj, (2 + 2 * cmax, 3), dev)
    n = rows.shape[0] if rows.dim() == 2 else 0
    if (rows.dtype != dtype or rows.device != dev or rows.dim() != 2
            or (rows.shape[1] > 1 and rows.stride(1) != 1)):
        raise ValueError(f"rows must be a 2-D {dtype} tensor with unit "
                         f"stride along a row on {dev}, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    if not (0 <= kq0 and 1 <= n and kq0 + n <= cmax):
        raise ValueError(f"members {kq0}..{kq0 + n - 1} of a bucket of "
                         f"width {cmax}")
    ctas = STREAM_CTAS if ctas is None else ctas
    if not 1 <= ctas <= 16:
        raise ValueError(f"a cluster of 1 to 16 blocks, got {ctas}")
    M = 2 + 2 * cmax
    f_ids = torch.empty((2, M), dtype=torch.int32, device=dev)
    f_frm = torch.empty((2, M), dtype=torch.int32, device=dev)
    f_dist = torch.empty((2, M), dtype=dtype, device=dev)
    out_i = torch.full((3,), -1, dtype=torch.int32, device=dev)
    out_f = torch.zeros((2,), dtype=dtype, device=dev)
    lib = load("dc_stream_block", _STREAM_ARGS)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dc_stream_block(
        st.e.data_ptr(), st.belong.data_ptr(), st.length.data_ptr(),
        st.rev.data_ptr(), st.cdis.data_ptr(), st.cid.data_ptr(),
        st.adj.data_ptr(), f_ids.data_ptr(), f_frm.data_ptr(),
        f_dist.data_ptr(), scoreable.data_ptr(), rows.data_ptr(),
        rows.stride(0), kq0, n, cmax, out_i.data_ptr(), out_f.data_ptr(),
        ctas, int(dtype == torch.float64), dev.index, stream)
    if rc != 0:
        check_launch(lib, "dc_stream_block", rc)
    STREAM_BLOCK_LAUNCHES += 1
    return out_i, out_f


def _check_adj(adj, shape: tuple, dev) -> None:
    if (adj is None or adj.device != dev or adj.dtype != torch.int32
            or tuple(adj.shape) != shape or not adj.is_contiguous()):
        raise ValueError(f"adj must be a contiguous int32 {shape} table on "
                         f"{dev}")


def upload_sizes(sizes, device) -> torch.Tensor:
    """A chunk's cluster sizes (host ints) as the int32 [C] tensor
    build_chunk takes, on `device` by an asynchronous copy from pinned
    memory on the current stream: no host sync."""
    host = torch.from_numpy(np.asarray(sizes, dtype=np.int32)).pin_memory()
    return host.to(device, non_blocking=True)


def build_chunk(st: TreeState, scoreable: torch.Tensor, Dq: torch.Tensor,
                sizes: torch.Tensor, cmax: int,
                stream: int | None = None) -> None:
    """Launches kernel 8b: the local builds of the C clusters of `st`
    ([C, 2 + 4 cmax] arrays at their initial state, adjacency [C, 2 +
    2 cmax, 3], flags [C, E]) from their distances Dq ([C, >= cmax, W],
    the state's float type, unit stride along a row) and sizes (int32 [C]
    on the card, each in 0..cmax: upload_sizes), in place and in one
    launch. No host sync."""
    global CLUSTER_BUILD_LAUNCHES
    E, dtype, dev = _check_state(st, scoreable, "dc_cluster_build", True)
    C = st.e.shape[0]
    M = 2 + 2 * cmax
    if E != 2 + 4 * cmax:
        raise ValueError(f"{E} edge slots for bucket width {cmax}")
    adj = st.adj
    _check_adj(adj, (C, M, 3), dev)
    if (Dq.device != dev or Dq.dtype != dtype or Dq.dim() != 3
            or Dq.shape[0] != C or Dq.shape[1] < cmax
            or (Dq.shape[2] > 1 and Dq.stride(2) != 1)):
        raise ValueError(f"Dq must be a [{C}, >= {cmax}, W] {dtype} tensor "
                         f"with unit stride along a row on {dev}, got "
                         f"{Dq.dtype} "
                         f"{tuple(Dq.shape)} strides {Dq.stride()} on "
                         f"{Dq.device}")
    if (sizes.device != dev or sizes.dtype != torch.int32
            or tuple(sizes.shape) != (C,) or not sizes.is_contiguous()):
        raise ValueError(f"sizes must be a contiguous int32 [{C}] on {dev}")
    # the global plan's frontier spill
    f_ids = torch.empty((C, 2, M), dtype=torch.int32, device=dev)
    f_frm = torch.empty((C, 2, M), dtype=torch.int32, device=dev)
    f_dist = torch.empty((C, 2, M), dtype=dtype, device=dev)
    lib = load("dc_cluster_build", _BUILD_ARGS)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dc_cluster_build(
        st.e.data_ptr(), st.belong.data_ptr(), st.length.data_ptr(),
        st.rev.data_ptr(), st.cdis.data_ptr(), st.cid.data_ptr(),
        adj.data_ptr(), f_ids.data_ptr(), f_frm.data_ptr(), f_dist.data_ptr(),
        scoreable.data_ptr(), Dq.data_ptr(), Dq.stride(0), Dq.stride(1),
        Dq.shape[2], sizes.data_ptr(), C, cmax, int(dtype == torch.float64),
        dev.index, stream)
    if rc != 0:
        check_launch(lib, "dc_cluster_build", rc)
    CLUSTER_BUILD_LAUNCHES += 1
