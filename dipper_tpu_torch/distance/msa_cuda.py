"""ctypes wrapper of kernel 12, csrc/msa_cluster_dist.cu: D&C phase 3's
per-cluster MSA distances of a chunk of clusters in one launch (the port
of the jax.vmap of dipper_tpu/distance/msa.py::_block_distance in
dipper_tpu/dc/pipeline.py::_dc_pair_distances). Built from the
repository's sources at first use (csrc/build.py). Its plain PyTorch
version is distance/msa.py::cluster_block_distances_plain, which it equals
bit for bit; distance/msa_cluster_model.py models its plan on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.distance.msa import MAX_COLUMNS
from dipper_tpu_torch.utils.device import torch_dtype

# Kernel launches made by this process; chip_smoke.py resets and reads it
# to show that a run went through the kernel.
CLUSTER_DIST_LAUNCHES = 0

_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def cluster_dist(codes: torch.Tensor, members: int, *, distance_type: int,
                 dtype_name: str) -> torch.Tensor:
    """codes uint8 [c, W, L] on a CUDA device (contiguous; 0-3 bases, 4 and
    above gaps): each cluster's W witness rows, of which the last `members`
    (Q) are its members -> [c, Q, W] distances d(member k, witness w) in
    `dtype_name` (float32 or float64) under model `distance_type` (1-6).
    Launches on the current stream and returns without synchronizing."""
    global CLUSTER_DIST_LAUNCHES
    if codes.device.type != "cuda":
        raise ValueError(f"codes must be a CUDA tensor, got {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 3:
        raise ValueError(f"codes must be a 3-D uint8 tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    dtype = torch_dtype(dtype_name)
    if distance_type not in range(1, 7):
        raise ValueError(f"distance_type must be 1-6, got {distance_type}")
    c, W, L = codes.shape
    if not 1 <= members <= W:
        raise ValueError(f"members {members} outside [1, {W}]")
    if L < 1 or L > MAX_COLUMNS:
        raise ValueError(f"alignment of {L} columns outside [1, "
                         f"{MAX_COLUMNS}], the lengths whose pair counts "
                         "are exact")
    if c >= 2**31 or W >= 2**31:
        raise ValueError("shape too large for the kernel's int arguments")
    out = torch.empty((c, members, W), dtype=dtype, device=codes.device)
    if c == 0:
        return out
    lib = load("msa_cluster_dist", _ARGS)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msa_cluster_dist(codes.data_ptr(), out.data_ptr(), c, W,
                                  members, L, distance_type,
                                  int(dtype_name == "float64"), stream)
    check_launch(lib, "msa_cluster_dist", rc)
    CLUSTER_DIST_LAUNCHES += 1
    return out
