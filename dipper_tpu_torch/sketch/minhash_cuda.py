"""ctypes wrapper of the Hopper MinHash sketch kernel (csrc/
minhash_sketch.cu), the port of the XLA program dipper_tpu/sketch/
minhash.py::sketch_batch_device_packed: packed 2-bit rows -> bottom-s
sketches, built from the repository's sources at first use (csrc/
build.py). Its plain PyTorch version is sketch/minhash.py::
sketch_batch_plain.

One call launches stage 1 and, where a row has more than one list, the
rounds of stage 2 that merge each row's lists pairwise until one is
left. For s <= SELECT_MAX_SKETCH stage 1 is the select kernel: a block
walks a row's tiles of TILE windows (or a segment of them where the rows
are too few to fill the card), keeps the hashes below a running
threshold in shared memory, cuts them to about s by a histogram when the
buffer fills, and at the end orders what is left (sketch/
select_model.py models it). Larger s take the tile kernel: every tile of
SORT_TILE windows sorted whole, its bottom min(SORT_TILE, s) kept.
`plan` reckons which, as minhash::make_plan does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dipper_tpu_torch.csrc.build import check_launch, load

# Kernel calls made by this process (one a batch: stage 1 and its merge
# rounds); chip_smoke.py resets it and reads it to show that a run went
# through the kernel.
LAUNCHES = 0

# windows a select block hashes at once (minhash::kTile), and those a
# block of the tile path sorts (minhash::kSortTile)
TILE = 2048
SORT_TILE = 4096
# the largest sketch size the kernel takes (minhash::kMaxSketch); the
# bound makes a mistyped -s fail before any allocation
MAX_SKETCH_SIZE = 1 << 20
# the largest sketch size of the select path (minhash::kSelectMaxSketch)
SELECT_MAX_SKETCH = 8192
# rows fewer than FILL_BLOCKS are split into segments of at least
# MIN_SEGMENT_TILES tiles (minhash::kFillBlocks, kMinSegmentTiles)
FILL_BLOCKS = 4 * 132
MIN_SEGMENT_TILES = 4
# `stages` of the C entry point: both stages; stage 1 or 2 alone, and
# stage 1's hashing alone, for timing (chip_smoke.py)
STAGES_ALL, STAGE_TILES, STAGE_MERGE, STAGE_HASH_ONLY = 3, 1, 2, 5

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def n_lists(n_rows: int, n_words, k: int, sketch_size: int) -> np.ndarray:
    """Lists a row that stage 1 writes, for rows of n_words packed words
    (a numpy array of widths gives one count each): on the select path
    one, or segments of at least MIN_SEGMENT_TILES tiles where fewer than
    FILL_BLOCKS rows would leave the card idle; else one a SORT_TILE."""
    windows = 16 * np.asarray(n_words, dtype=np.int64) - k + 1
    if sketch_size > SELECT_MAX_SKETCH:
        return -(-windows // SORT_TILE)
    tiles = -(-windows // TILE)
    if n_rows >= FILL_BLOCKS:
        return np.ones_like(tiles)
    want = -(-FILL_BLOCKS // n_rows)
    return np.maximum(1, np.minimum(want, tiles // MIN_SEGMENT_TILES))


def plan(n_rows: int, n_words: int, k: int, sketch_size: int):
    """(select path, lists a row, values a list, [(lists, length) of each
    merge round]) for n_rows rows of n_words packed words, as
    minhash::make_plan reckons them."""
    select = sketch_size <= SELECT_MAX_SKETCH
    lists = int(n_lists(n_rows, n_words, k, sketch_size))
    keep = sketch_size if select else min(SORT_TILE, sketch_size)
    rounds, n, length = [], lists, keep
    while n > 1:
        n, length = (n + 1) // 2, min(2 * length, sketch_size)
        rounds.append((n, length))
    return select, lists, keep, rounds


def scratch_elems(n_rows: int, n_words: int, k: int,
                  sketch_size: int) -> int:
    """u64 scratch of one call: stage 1's lists and two ping-pong buffers
    for the merge rounds before the last (which writes the output); none
    when a row is one list."""
    _, lists, keep, rounds = plan(n_rows, n_words, k, sketch_size)
    if lists == 1:
        return 0
    ping = max((n * length for n, length in rounds[:-1]), default=0)
    return n_rows * (lists * keep + 2 * ping)


def row_scratch_bound(n_words: np.ndarray, k: int,
                      sketch_size: int) -> np.ndarray:
    """An upper bound of scratch_elems(B, W, ...) / B over every batch
    size B, for each W of `n_words`: a lone row has the most segments,
    and a round of n lists of length len holds at most (n + 1) / 2 lists
    of min(2 len, s), below lists x keep + 2 s."""
    lists = n_lists(1, n_words, k, sketch_size)
    keep = (sketch_size if sketch_size <= SELECT_MAX_SKETCH
            else min(SORT_TILE, sketch_size))
    return np.where(lists > 1, 3 * lists * keep + 4 * sketch_size, 0)


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
    reads the lists an earlier STAGE_TILES call left in `scratch`."""
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
