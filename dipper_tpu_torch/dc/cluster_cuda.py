"""ctypes wrappers of D&C phase 3's Hopper kernels, built from the
repository's sources at first use (csrc/build.py). Both port the JAX
package's _cluster_step (dipper_tpu/dc/pipeline.py:180-225), an XLA
program:

- csrc/score_masked.cu (kernel 8a): the masked scoring of one member of a
  streamed cluster, with the cluster's scoreable flags updated for its
  insertion. Its plain version is dc/cluster.py::_score_masked. A
  `MaskedScorer` holds one cluster state's checked arrays, the outputs
  (score_edges.cu's layout, which insert_cuda.insert_step_cursor reads)
  and the scratch. `score_masked` launches with the member from the host,
  `score_masked_cursor` with the member read from the state's insert
  cursor (insert_cuda.set_cursor), so that a captured CUDA graph of it and
  insert_step_cursor builds any stretch of a cluster (dc/cluster.py::
  build_streamed).
- csrc/dc_cluster_build.cu (kernel 8b): the whole local build of a chunk
  of clusters of one size bucket, one block a cluster (`build_chunk`). Its
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
from dipper_tpu_torch.placement import insert_cuda
from dipper_tpu_torch.placement.kclosest import (K, SCORE_EDGES_MAX_BLOCKS,
                                                 TreeState)

# Launches made by this process of each kernel, direct or by a graph's
# replay (chip_smoke.py resets them and reads them to show that a run went
# through the kernels)
SCORE_MASKED_LAUNCHES = 0
CLUSTER_BUILD_LAUNCHES = 0

_MASKED_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
_BUILD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2
               + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])

# devices whose score_masked kernels this process has loaded
_preloaded: set = set()


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


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


class MaskedScorer:
    """What one streamed cluster's score_masked launches share: the state
    and flags as checked, the entry points with their per-state
    arguments, the outputs out_i (int32 [4]: eid, belong, e, rev of the
    chosen edge) and out_f (frac, add) and the scratch. Launches through
    one scorer must be ordered on one stream."""

    def __init__(self, st: TreeState, scoreable: torch.Tensor):
        E, dtype, dev = _check_state(st, scoreable, "score_masked", False)
        self.arrays = (st.cid, st.cdis, st.belong, st.e, st.rev, st.length,
                       scoreable)
        self.dtype, self.device, self.n_edges = dtype, dev, E
        self.out_i = torch.full((4,), -1, dtype=torch.int32, device=dev)
        self.out_f = torch.zeros((2,), dtype=dtype, device=dev)
        self.scratch_i = torch.zeros((1 + SCORE_EDGES_MAX_BLOCKS,),
                                     dtype=torch.int32, device=dev)
        self.scratch_f = torch.empty((2 * SCORE_EDGES_MAX_BLOCKS,),
                                     dtype=dtype, device=dev)
        self.lib = load("score_masked", _MASKED_ARGS + [ctypes.c_void_p,
                                                        ctypes.c_int,
                                                        ctypes.c_void_p])
        self.fn = self.lib.score_masked
        self.fn_cursor = _entry(self.lib, "score_masked_cursor",
                                _MASKED_ARGS + [ctypes.c_void_p] * 2)
        if dev.index not in _preloaded:
            preload = _entry(self.lib, "score_masked_preload", [ctypes.c_int])
            check_launch(self.lib, "score_masked", preload(dev.index))
            _preloaded.add(dev.index)
        self.args = (*(a.data_ptr() for a in self.arrays),
                     self.scratch_f.data_ptr(), self.scratch_i.data_ptr(),
                     self.out_i.data_ptr(), self.out_f.data_ptr(), E,
                     SCORE_EDGES_MAX_BLOCKS, int(dtype == torch.float64),
                     dev.index)

    def owns(self, st: TreeState, scoreable) -> bool:
        return all(a is b for a, b in zip(self.arrays, (
            st.cid, st.cdis, st.belong, st.e, st.rev, st.length, scoreable)))

    def _stream(self, stream):
        return (torch.cuda.current_stream(self.device).cuda_stream
                if stream is None else stream)


def score_masked(sc: MaskedScorer, st: TreeState, scoreable, row,
                 stream: int | None = None) -> MaskedScorer:
    """Launches kernel 8a for the member whose slots in use are st.idx
    (2 + 4 kq), its distance row `row` ([W], the state's float type on its
    card, unit stride): the choice goes to sc.out_i / sc.out_f and the
    flags are updated for its insertion. Returns `sc`."""
    global SCORE_MASKED_LAUNCHES
    if not sc.owns(st, scoreable):
        raise ValueError("the scorer was made for other arrays")
    if (row.dtype != sc.dtype or row.device != sc.device or row.dim() != 1
            or (row.shape[0] > 1 and row.stride(0) != 1)):
        raise ValueError(f"row must be a 1-D {sc.dtype} tensor with unit "
                         f"stride on {sc.device}, got {row.dtype} "
                         f"{tuple(row.shape)} on {row.device}")
    if not 0 <= st.idx <= sc.n_edges:
        raise ValueError(f"{st.idx} slots in use of {sc.n_edges}")
    rc = sc.fn(*sc.args, row.data_ptr(), st.idx, sc._stream(stream))
    if rc != 0:
        check_launch(sc.lib, "score_masked", rc)
    SCORE_MASKED_LAUNCHES += 1
    return sc


def score_masked_cursor(sc: MaskedScorer, st: TreeState,
                        stream: int | None = None,
                        count: bool = True) -> MaskedScorer:
    """Launches kernel 8a for the member that the state's insert cursor
    (insert_cuda.set_cursor: member i, slots in use, the rows' address,
    their stride, their first member) holds. `count=False` for a launch
    being captured (insert_cuda.replay's caller counts a graph's
    launches)."""
    global SCORE_MASKED_LAUNCHES
    cursor = insert_cuda.inserter(st).cursor
    rc = sc.fn_cursor(*sc.args, cursor.data_ptr(), sc._stream(stream))
    if rc != 0:
        check_launch(sc.lib, "score_masked", rc)
    if count:
        SCORE_MASKED_LAUNCHES += 1
    return sc


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
    if (adj is None or adj.device != dev or adj.dtype != torch.int32
            or tuple(adj.shape) != (C, M, 3) or not adj.is_contiguous()):
        raise ValueError(f"adj must be a contiguous int32 ({C}, {M}, 3) "
                         f"table on {dev}")
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
        sizes.data_ptr(), C, cmax, int(dtype == torch.float64), dev.index,
        stream)
    if rc != 0:
        check_launch(lib, "dc_cluster_build", rc)
    CLUSTER_BUILD_LAUNCHES += 1
