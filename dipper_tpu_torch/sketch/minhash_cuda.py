"""ctypes wrapper of the Hopper MinHash sketch kernel (csrc/
minhash_sketch.cu), the port of the XLA program dipper_tpu/sketch/
minhash.py::sketch_batch_device_packed: packed 2-bit rows -> bottom-s
sketches, built from the repository's sources at first use (csrc/
build.py). Its plain PyTorch version is sketch/minhash.py::
sketch_batch_plain.

One call launches stage (a), a block per tile of TILE windows of a row
(hash, sort, keep the tile's bottom min(TILE, s)), and stage (b), the
rounds that merge each row's tile lists pairwise until one is left.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load

# Kernel calls made by this process (one a batch: stage (a) and its merge
# rounds); chip_smoke.py resets it and reads it to show that a run went
# through the kernel.
LAUNCHES = 0

# windows a stage-(a) block hashes and sorts (minhash::kTile)
TILE = 4096
# the largest sketch size the kernel takes (minhash::kMaxSketch): it keeps
# min(TILE, s) values a tile and merges through device memory, so no
# shared-memory limit applies; the bound makes a mistyped -s fail before
# any allocation
MAX_SKETCH_SIZE = 1 << 20
# `stages` of the C entry point: both stages; stage (a) or (b) alone, and
# stage (a) without its sort, for timing (chip_smoke.py)
STAGES_ALL, STAGE_TILES, STAGE_MERGE, STAGE_HASH_ONLY = 3, 1, 2, 5

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def plan(n_words: int, k: int, sketch_size: int):
    """(tiles a row, values kept a tile, [(lists, length) of each merge
    round]) for rows of n_words packed words, as minhash::make_plan
    reckons them."""
    n_tiles = -(-(16 * n_words - k + 1) // TILE)
    keep = min(TILE, sketch_size)
    rounds, n, length = [], n_tiles, keep
    while n > 1:
        n, length = (n + 1) // 2, min(2 * length, sketch_size)
        rounds.append((n, length))
    return n_tiles, keep, rounds


def scratch_elems(n_rows: int, n_words: int, k: int,
                  sketch_size: int) -> int:
    """u64 scratch of one call: the tile lists and two ping-pong buffers
    for the merge rounds before the last (which writes the output); none
    when a row is one tile."""
    n_tiles, keep, rounds = plan(n_words, k, sketch_size)
    if n_tiles == 1:
        return 0
    ping = max((n * length for n, length in rounds[:-1]), default=0)
    return n_rows * (n_tiles * keep + 2 * ping)


def minhash_sketch_cuda(words: torch.Tensor, lengths: torch.Tensor, *,
                        k: int, sketch_size: int,
                        stages: int = STAGES_ALL,
                        scratch: torch.Tensor | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """words int32 [B, W] (16 2-bit codes a word, LSB-first), lengths
    int32 [B], both contiguous on one CUDA device -> int64 [B,
    sketch_size] sketches (u64 bit patterns, ascending as u64,
    sentinel-padded). Launches on the current stream and returns without
    synchronizing; raises before the launch on inputs the kernel does
    not take and after it on a launch error. `stages`, `scratch` and
    `out` serve the smoke's stage timing: a later call with STAGE_MERGE
    reads the tile lists an earlier STAGE_TILES call left in `scratch`."""
    global LAUNCHES
    if words.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got {words.device}")
    if words.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"words and lengths must be int32, got "
                         f"{words.dtype} and {lengths.dtype}")
    if words.dim() != 2 or lengths.shape != (words.shape[0],):
        raise ValueError(f"words must be [B, W] and lengths [B], got "
                         f"{tuple(words.shape)} and {tuple(lengths.shape)}")
    if not (words.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("words and lengths must be contiguous")
    if lengths.device != words.device:
        raise ValueError("words and lengths are on different devices")
    if not 2 <= k <= 15:
        raise ValueError(f"k {k} outside [2, 15]")
    if not 1 <= sketch_size <= MAX_SKETCH_SIZE:
        raise ValueError(f"sketch_size {sketch_size} outside [1, "
                         f"{MAX_SKETCH_SIZE}], the sketch kernel's limit")
    B, W = words.shape
    if not (1 <= B < 2**31 and 1 <= W < 2**27):
        raise ValueError(f"shape {tuple(words.shape)} outside the kernel's "
                         "int arguments")
    need = scratch_elems(B, W, k, sketch_size)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.int64, device=words.device)
    if out is None:
        out = torch.empty((B, sketch_size), dtype=torch.int64,
                          device=words.device)
    for nm, t, ok in (("scratch", scratch, scratch.numel() >= need),
                      ("out", out, out.shape == (B, sketch_size))):
        if not (ok and t.dtype == torch.int64 and t.is_contiguous()
                and t.device == words.device):
            raise ValueError(f"{nm} must be a contiguous int64 tensor of "
                             f"the kernel's size on {words.device}")
    lib = load("minhash_sketch", _ARGS)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.minhash_sketch(words.data_ptr(), lengths.data_ptr(),
                            scratch.data_ptr(), scratch.numel(),
                            out.data_ptr(), B, W, k, sketch_size, stages,
                            stream)
    check_launch(lib, "minhash_sketch", rc)
    LAUNCHES += 1
    return out
