"""ctypes wrapper of D&C phase 2's Hopper kernel, csrc/dc_assign.cu
(kernel 10), built from the repository's sources at first use
(csrc/build.py). It ports the JAX package's _phase2_all and
_phase2_chunk_{mash,matrix,msa} (dipper_tpu/dc/pipeline.py:57-133), an
XLA program: kclosest.score_edges vmapped over a chunk of distance rows.
Its plain version is placement/kclosest.py::score_edges_rows_plain;
dc/assign_model.py models its schedule.

`assign` launches on the current stream without synchronizing and writes
each row's slot into an int64 buffer, so that a phase's chunks fill one
device buffer that goes to the host once. The kernel needs no ticket and
no scratch (a block owns its rows). On a CPU state it raises, its caller
taking the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.placement.kclosest import K, TreeState

# kernel-10 launches made by this process (chip_smoke.py resets it and
# reads it to show that a run went through the kernel)
ASSIGN_LAUNCHES = 0

_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_longlong]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 4
         + [ctypes.c_void_p])


def plan(width: int, dtype) -> tuple:
    """The kernel's plan for rows of `width` elements of `dtype` (float32
    or float64), as the built library's dc_assign_plan reports it: (rows a
    block, staged in shared memory, threads a block, dynamic shared memory
    bytes a block); assign_model.kernel_plan mirrors it."""
    lib = load("dc_assign", _ARGS)
    fn = lib.dc_assign_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    check_launch(lib, "dc_assign",
                 fn(width, int(dtype == torch.float64), out))
    return out[0], bool(out[1]), out[2], out[3]


def _check_state(st: TreeState):
    """The state's six arrays on one CUDA device, contiguous, of the types
    and shapes the kernel takes; raises ValueError otherwise. Returns (E,
    dtype, device)."""
    dev = st.e.device
    if dev.type != "cuda":
        raise ValueError(f"dc_assign needs a CUDA state, got one on {dev}")
    dtype = st.length.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"length must be float32 or float64, got {dtype}")
    E = st.e.shape[0] if st.e.dim() == 1 else -1
    want = {"e": (torch.int32, (E,)), "belong": (torch.int32, (E,)),
            "length": (dtype, (E,)), "rev": (torch.int32, (E,)),
            "cdis": (dtype, (E, K)), "cid": (torch.int32, (E, K))}
    for name, (dt, shape) in want.items():
        a = getattr(st, name)
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape} on {dev}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"dc_assign needs contiguous arrays: {name} has "
                             f"strides {a.stride()}")
    if not 1 <= E < 2**30:
        raise ValueError(f"dc_assign takes 1 to 2**30 - 1 edge slots, got "
                         f"{E}")
    return E, dtype, dev


def assign(st: TreeState, rows: torch.Tensor, out: torch.Tensor | None = None,
           *, rows_per_block: int | None = None, staged: bool | None = None,
           stream: int | None = None) -> torch.Tensor:
    """Launches kernel 10: the chosen slot of each row of `rows` ([Q, W],
    the state's float type, unit stride along a row, any row stride; every
    witness id of the state < W) on the backbone state `st` ([E] arrays),
    written into `out` (int64 [Q], contiguous; made if None), which is
    returned. Equal to score_edges_rows_plain(st, rows) bit for bit.
    rows_per_block and staged override the kernel's plan (`plan`): 1, 2,
    4 or 8 rows a block staged in shared memory, or 8 read from device
    memory; the launch raises for another instance or for staged rows
    over 225 KB. One launch (none for Q = 0), no host sync."""
    global ASSIGN_LAUNCHES
    E, dtype, dev = _check_state(st)
    if (rows.dtype != dtype or rows.device != dev or rows.dim() != 2
            or rows.shape[1] < 1
            or (rows.shape[1] > 1 and rows.stride(1) != 1)
            or (rows.shape[0] > 1 and rows.stride(0) < rows.shape[1])):
        raise ValueError(f"rows must be a 2-D {dtype} tensor with unit "
                         f"stride along a row on {dev}, got {rows.dtype} "
                         f"{tuple(rows.shape)} strides {rows.stride()} on "
                         f"{rows.device}")
    Q, W = rows.shape
    if Q >= 2**31 or W >= 2**31:
        raise ValueError(f"too many rows or columns for the kernel: "
                         f"{tuple(rows.shape)}")
    if out is None:
        out = torch.empty((Q,), dtype=torch.int64, device=dev)
    elif (out.dtype != torch.int64 or out.device != dev
          or tuple(out.shape) != (Q,) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int64 [{Q}] on {dev}, "
                         f"got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if Q == 0:
        return out
    lib = load("dc_assign", _ARGS)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dc_assign(
        st.cid.data_ptr(), st.cdis.data_ptr(), st.belong.data_ptr(),
        st.e.data_ptr(), st.rev.data_ptr(), st.length.data_ptr(), E,
        rows.data_ptr(), rows.stride(0), Q, W, out.data_ptr(),
        -1 if rows_per_block is None else rows_per_block,
        -1 if staged is None else int(staged),
        int(dtype == torch.float64), dev.index, stream)
    if rc != 0:
        check_launch(lib, "dc_assign", rc)
    ASSIGN_LAUNCHES += 1
    return out
