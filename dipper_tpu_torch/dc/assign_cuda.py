"""ctypes wrapper of D&C phase 2's Hopper kernels, csrc/dc_assign.cu
(kernel 10 and its pack), built from the repository's sources at first use
(csrc/build.py). It ports the JAX package's _phase2_all and
_phase2_chunk_{mash,matrix,msa} (dipper_tpu/dc/pipeline.py:57-133), an
XLA program: kclosest.score_edges vmapped over a chunk of distance rows.
Its plain versions are placement/kclosest.py::score_edges_rows_plain and
pack_slots_plain; dc/assign_model.py models their schedule.

`pack` writes the state's valid slots as records once a phase (one
launch; the record count and the lowest invalid slot stay on the card);
`assign` launches kernel 10 over them on the current stream without
synchronizing and writes each row's slot into an int64 buffer, so that a
phase's chunks fill one device buffer that goes to the host once. A CPU
state raises, its caller taking the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.dc import assign_model as am
from dipper_tpu_torch.placement.kclosest import K, TreeState

# launches made by this process of kernel 10 and of its pack
# (chip_smoke.py resets them and reads them to show that a run went
# through the kernels)
ASSIGN_LAUNCHES = 0
PACK_LAUNCHES = 0

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_longlong]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 6
         + [ctypes.c_void_p])
_PACK_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
              + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
              + [ctypes.c_void_p])


class Records(NamedTuple):
    """A state's packed valid slots, as dc_assign_pack wrote them."""
    data: torch.Tensor      # uint8 [E, record bytes]; the first meta[0] hold records
    meta: torch.Tensor      # int32 [2]: record count, lowest invalid slot
    id_bytes: int           # 2 (uint16 ids) or 4 (int32)
    dtype: torch.dtype      # the state's float type
    n_edges: int


def _opt(v) -> int:
    return -1 if v is None else int(v)


def plan(width: int, dtype, *, rows_per_block: int | None = None,
         staged: bool | None = None, cluster: int | None = None,
         stages: int | None = None) -> am.Plan:
    """The kernel's plan for rows of `width` elements of `dtype` (float32
    or float64) with its overrides, as the built library's dc_assign_plan
    reports it; raises for an instance that the kernel refuses.
    assign_model.kernel_plan mirrors it."""
    lib = load("dc_assign", _ARGS)
    fn = lib.dc_assign_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = (ctypes.c_int * 10)()
    check_launch(lib, "dc_assign",
                 fn(width, int(dtype == torch.float64), _opt(rows_per_block),
                    _opt(staged), _opt(cluster), _opt(stages), out))
    v = list(out)
    return am.Plan(v[0], bool(v[1]), *v[2:])


def _check_state(st: TreeState):
    """The state's six arrays on one CUDA device, contiguous, of the types
    and shapes the kernels take; raises ValueError otherwise. Returns (E,
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


def pack(st: TreeState, width: int) -> Records:
    """Launches the pack: the valid slots of the backbone state `st` as
    records for rows of `width` elements (ids uint16 up to 65,535 wide,
    else int32), with the record count and the lowest invalid slot on the
    card. Equal to kclosest.pack_slots_plain bit for bit (the first count
    records). One launch (a block a tile of PACK_TILE slots, after a
    memset of its workspace), no host sync."""
    global PACK_LAUNCHES
    E, dtype, dev = _check_state(st)
    if not 1 <= width < 2**31:
        raise ValueError(f"width must be 1 to 2**31 - 1, got {width}")
    idb = am.id_bytes_of(width)
    rec = am.record_layout(idb, torch.finfo(dtype).bits // 8).bytes
    data = torch.empty((E, rec), dtype=torch.uint8, device=dev)
    meta = torch.empty((2,), dtype=torch.int32, device=dev)
    work = torch.empty((am.pack_work_words(E),), dtype=torch.int64,
                       device=dev)
    lib = load("dc_assign", _ARGS)
    fn = lib.dc_assign_pack
    fn.restype = ctypes.c_int
    fn.argtypes = _PACK_ARGS
    rc = fn(st.cid.data_ptr(), st.cdis.data_ptr(), st.belong.data_ptr(),
            st.e.data_ptr(), st.rev.data_ptr(), st.length.data_ptr(), E,
            width, data.data_ptr(), meta.data_ptr(), work.data_ptr(),
            int(dtype == torch.float64), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        check_launch(lib, "dc_assign", rc)
    PACK_LAUNCHES += 1
    return Records(data, meta, idb, dtype, E)


def assign(st: TreeState, rows: torch.Tensor, out: torch.Tensor | None = None,
           *, records: Records | None = None,
           rows_per_block: int | None = None, staged: bool | None = None,
           cluster: int | None = None, stages: int | None = None,
           stream: int | None = None) -> torch.Tensor:
    """Launches kernel 10: the chosen slot of each row of `rows` ([Q, W],
    the state's float type, unit stride along a row, any row stride; every
    witness id of the state < W) on the backbone state `st` ([E] arrays),
    over `records` (pack(st, W)'s; packed here, one launch more, if None),
    written into `out` (int64 [Q], contiguous; made if None), which is
    returned. Equal to score_edges_rows_plain(st, rows) bit for bit.
    rows_per_block, staged, cluster and stages override the kernel's plan
    (`plan`: 1, 2, 4 or 8 rows a block staged in shared memory, or
    GLOBAL_ROWS read from device memory; 1 or CLUSTER_CTAS blocks a
    cluster; MIN_STAGES to MAX_STAGES stages of the ring); the launch raises
    for an instance that does not exist or fit, or a cluster that finds
    no room. One launch (none for Q = 0), no host sync."""
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
    if records is None:
        records = pack(st, W)
    if (records.dtype != dtype or records.n_edges != E
            or records.data.device != dev):
        raise ValueError(f"records packed for {records.n_edges} {records.dtype}"
                         f" slots on {records.data.device}, not this state's "
                         f"{E} {dtype} on {dev}")
    if records.id_bytes != am.id_bytes_of(W):
        raise ValueError(f"records with {records.id_bytes}-byte ids do not "
                         f"fit rows of width {W} (their ids take "
                         f"{am.id_bytes_of(W)} bytes)")
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
        records.data.data_ptr(), records.meta.data_ptr(), records.id_bytes,
        rows.data_ptr(), rows.stride(0), Q, W, out.data_ptr(),
        _opt(rows_per_block), _opt(staged), _opt(cluster), _opt(stages),
        int(dtype == torch.float64), dev.index, stream)
    if rc != 0:
        check_launch(lib, "dc_assign", rc)
    ASSIGN_LAUNCHES += 1
    return out
