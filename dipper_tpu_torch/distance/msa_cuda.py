"""ctypes wrapper of kernel 12, csrc/msa_cluster_dist.cu: D&C phase 3's
per-cluster MSA distances of a chunk of clusters in one launch (the port
of the jax.vmap of dipper_tpu/distance/msa.py::_block_distance in
dipper_tpu/dc/pipeline.py::_dc_pair_distances), read by the witness lists'
indices from an aligned set's one-hot bit planes resident on the card;
and the pack that makes those planes. Built from the repository's
sources at first use (csrc/build.py). Their plain PyTorch versions are
distance/msa.py::cluster_dist_by_index_plain and pack_planes_plain, which
they equal bit for bit; distance/msa_cluster_model.py models both on the
CPU.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.distance.msa import (MAX_COLUMNS, check_lists,
                                           plane_words)
from dipper_tpu_torch.utils.device import torch_dtype

# Launches made by this process (kernel 12, and its pack); chip_smoke.py
# resets and reads them to show that a run went through the kernels.
CLUSTER_DIST_LAUNCHES = 0
PACK_LAUNCHES = 0

# host rows a pack launch takes at most: bytes of uint8 codes, copied to
# the card straight from the numpy array (a 20,000 x 10,000 set is one
# launch)
PACK_CHUNK_BYTES = 1 << 28

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_PACK_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAN_KEYS = ("m_tiles", "n_tiles", "groups", "ntg", "bm", "bg",
              "mem_chunks", "wit_chunks", "separate", "wit_slots", "rows",
              "warps", "smem", "blocks_per_cluster")


def _lib():
    return load("msa_cluster_dist", _ARGS)


def plan(n_wit: int, n_mem: int) -> dict:
    """The built kernel's plan for clusters of n_wit witnesses, the last
    n_mem the members (msa_cluster_model.plan's keys)."""
    lib = _lib()
    fn = lib.msa_cluster_dist_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    check_launch(lib, "msa_cluster_dist", fn(n_wit, n_mem, out))
    return dict(zip(_PLAN_KEYS, list(out)))


def _check_cuda(name: str, x: torch.Tensor, dtype: torch.dtype,
                dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype or x.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D {dtype} tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack(codes: torch.Tensor, planes: torch.Tensor,
         nongap: torch.Tensor) -> None:
    """uint8 [R, L] codes on the card (0-3 bases, 4 and above gaps) ->
    their planes written into int32 [R, 4, words] (uint32 bits) and their
    non-gap counts into int32 [R], in one launch on the current stream;
    returns without synchronizing."""
    global PACK_LAUNCHES
    _check_cuda("codes", codes, torch.uint8, 2)
    _check_cuda("planes", planes, torch.int32, 3)
    _check_cuda("nongap", nongap, torch.int32, 1)
    R, L = codes.shape
    if not 1 <= L <= MAX_COLUMNS:
        raise ValueError(f"alignment of {L} columns outside [1, "
                         f"{MAX_COLUMNS}]")
    words = plane_words(L)
    if tuple(planes.shape) != (R, 4, words) or nongap.shape[0] != R:
        raise ValueError(f"planes {tuple(planes.shape)} and nongap "
                         f"{tuple(nongap.shape)} do not fit codes "
                         f"{tuple(codes.shape)}: want ({R}, 4, {words})")
    if R == 0:
        return
    if R >= 2**31:
        raise ValueError("too many rows for one launch")
    lib = _lib()
    fn = lib.msa_cluster_dist_pack
    fn.restype = ctypes.c_int
    fn.argtypes = _PACK_ARGS
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(codes.data_ptr(), planes.data_ptr(), nongap.data_ptr(), R, L,
                words, stream)
    check_launch(lib, "msa_cluster_dist", rc)
    PACK_LAUNCHES += 1


def pack_bank(codes: np.ndarray, device, log=None) -> tuple:
    """The aligned set's resident planes: host uint8 [N, L] codes -> (int32
    [N, 4, words] planes, int32 [N] non-gap counts) on the card `device`,
    the rows copied to the card PACK_CHUNK_BYTES at a time straight from
    the array (pageable: in a fresh process that beats pinning a buffer
    for them, scripts/planes_upload_torch.py) and each chunk packed by one
    launch. Raises MemoryError when the planes do not fit the card's free
    memory. Synchronizes once, at the end, and logs the time, the host's
    time in the copies, and the bytes."""
    device = torch.device(device)
    N, L = codes.shape
    words = plane_words(L)
    need = N * 4 * words * 4 + N * 4
    free, _ = torch.cuda.mem_get_info(device)
    chunk = max(1, min(N, PACK_CHUNK_BYTES // max(L, 1)))
    if need + chunk * L > free:
        raise MemoryError(
            f"the aligned set's bit planes need {need} bytes on the card "
            f"({N} rows x 4 planes x {words} words) and {chunk * L} for "
            f"the upload, but only {free} are free")
    t0 = time.perf_counter()
    planes = torch.empty((N, 4, words), dtype=torch.int32, device=device)
    nongap = torch.empty((N,), dtype=torch.int32, device=device)
    launches, upload = 0, 0.0
    for r0 in range(0, N, chunk):
        r1 = min(N, r0 + chunk)
        t = time.perf_counter()
        staged = torch.from_numpy(np.ascontiguousarray(codes[r0:r1])).to(
            device)
        upload += time.perf_counter() - t
        pack(staged, planes[r0:r1], nongap[r0:r1])
        launches += 1
    torch.cuda.current_stream(device).synchronize()
    if log is not None:
        log(f"MSA planes in: {int((time.perf_counter() - t0) * 1000)} ms "
            f"({need} bytes on the card, {launches} pack launches; the "
            f"copies {int(upload * 1000)} ms)")
    return planes, nongap


def witness_lists(wit: np.ndarray, n_rows: int, device) -> torch.Tensor:
    """A chunk's witness lists [c, W] (host row ids) checked against the
    bank's n_rows and uploaded as int32 through pinned memory (no host
    sync)."""
    check_lists(wit, n_rows)
    w = torch.from_numpy(np.ascontiguousarray(wit, dtype=np.int32))
    return w.pin_memory().to(device, non_blocking=True)


def cluster_dist(planes: torch.Tensor, nongap: torch.Tensor,
                 wit: torch.Tensor, members: int, *, distance_type: int,
                 dtype_name: str) -> torch.Tensor:
    """planes int32 [N, 4, words] and nongap int32 [N] (pack's), wit int32
    [c, W] row ids on the same card (checked on the host where they were
    made: witness_lists), each cluster's last `members` (Q) witnesses its
    members -> [c, Q, W] distances d(member k, witness w) in `dtype_name`
    (float32 or float64) under model `distance_type` (1-6). Launches on the
    current stream and returns without synchronizing."""
    global CLUSTER_DIST_LAUNCHES
    _check_cuda("planes", planes, torch.int32, 3)
    _check_cuda("nongap", nongap, torch.int32, 1)
    _check_cuda("wit", wit, torch.int32, 2)
    if len({planes.device, nongap.device, wit.device}) != 1:
        raise ValueError("planes, nongap and wit must be on one device")
    dtype = torch_dtype(dtype_name)
    if distance_type not in range(1, 7):
        raise ValueError(f"distance_type must be 1-6, got {distance_type}")
    N, four, words = planes.shape
    if four != 4 or words < 8 or words % 8 or nongap.shape[0] != N:
        raise ValueError(f"planes {tuple(planes.shape)} and nongap "
                         f"{tuple(nongap.shape)} are not a pack's")
    if words * 32 > MAX_COLUMNS:
        raise ValueError(f"planes of {words} words are longer than "
                         f"{MAX_COLUMNS} columns, the most for which the "
                         "pair counts are exact")
    c, W = wit.shape
    if not 1 <= members <= W:
        raise ValueError(f"members {members} outside [1, {W}]")
    if N >= 2**31 or c >= 2**31:
        raise ValueError("shape too large for the kernel's int arguments")
    out = torch.empty((c, members, W), dtype=dtype, device=planes.device)
    if c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msa_cluster_dist(planes.data_ptr(), nongap.data_ptr(),
                                  wit.data_ptr(), out.data_ptr(), c, W,
                                  members, N, words, distance_type,
                                  int(dtype_name == "float64"), stream)
    check_launch(lib, "msa_cluster_dist", rc)
    CLUSTER_DIST_LAUNCHES += 1
    return out
