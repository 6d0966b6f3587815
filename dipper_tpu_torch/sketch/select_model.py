"""A numpy model of the sketch kernel's select path (csrc/
minhash_sketch.cu::select_kernel and the merge rounds), for the CPU
tests: a row segment's survivors (hashes below tau) appended unsorted to
a buffer of `capacity` values; where the next tile might not fit, the
histogram cut at s over [0, top] (top the largest value held: tau - 1,
or tau after an exact cut; the bin's upper edge the new tau), or,
where duplicates keep the cut from making room, a sort cut to s; at the
segment's end one cut, and the values placed by bins (or sorted where a
bin holds more than SMALL_BIN); the segments of a row merged into one
list. It holds the kernel's arithmetic (the bin shift, the cut, ties
at tau) to the plain version (sketch/minhash.py::sketch_batch_plain),
bit for bit; change it together with the kernel. What it cannot show
(the block's synchronisation, the order of the shared atomics) only the
card shows.
"""

from __future__ import annotations

import numpy as np

from dipper_tpu_torch.sketch.minhash_cuda import TILE, n_lists

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
BIN_BITS = 11
BINS = 1 << BIN_BITS
# a bin of at most this many values is sorted by one thread at the end
SMALL_BIN = 16


def bin_shift(top: np.uint64) -> int:
    """minhash::bin_shift: keys in [0, top] >> shift lie in [0, BINS)."""
    return max(0, int(top).bit_length() - BIN_BITS)


def capacity(s: int) -> int:
    """minhash::select_capacity: a power of two >= s + TILE."""
    cap = TILE
    while cap < s + TILE:
        cap *= 2
    return cap


def hist_cut(c: np.ndarray, shift: int, s: int) -> int:
    """minhash::hist_cut: the first bin at which the running count of
    c >> shift reaches s (the last bin where c holds at most s)."""
    bins = (c >> np.uint64(shift)).astype(np.int64)
    # the kernel's histogram has BINS counters in shared memory
    if bins.size and bins.max() >= BINS:
        raise IndexError(f"bin {bins.max()} outside the {BINS} of the "
                         "histogram")
    if c.size <= s:
        return BINS - 1
    cum = np.cumsum(np.bincount(bins, minlength=BINS))
    return int(np.argmax(cum >= s))


def select_segment(keys: np.ndarray, s: int, t0: int, t1: int,
                   stats: dict | None = None) -> np.ndarray:
    """One block of select_kernel: the bottom-s list (u64, ascending,
    sentinel-padded to s) of the windows of tiles [t0, t1) of a row whose
    valid windows' hashes are `keys` (u64, in window order). `stats`, if
    given, counts the cuts made on the way, the exact cuts, the ends
    placed by bins and those sorted, and the values ordered at the end."""
    stats = {} if stats is None else stats
    cap = capacity(s)
    c = np.zeros(0, dtype=np.uint64)
    tau = SENTINEL
    top = SENTINEL - np.uint64(1)  # every value held is <= top
    for t in range(t0, t1):
        tile = keys[t * TILE:(t + 1) * TILE]
        if tile.size == 0:
            break
        if c.size + TILE > cap:
            shift = bin_shift(top)
            cut = hist_cut(c, shift, s)
            edge = np.uint64(cut + 1) << np.uint64(shift)
            if cut < BINS - 1 and edge < tau:
                tau, top = edge, edge - np.uint64(1)
            c = c[(c >> np.uint64(shift)) <= np.uint64(cut)]
            stats["cuts"] = stats.get("cuts", 0) + 1
            if c.size + TILE > cap:
                c = np.sort(c)[:s]
                tau = top = c[s - 1]
                stats["exact_cuts"] = stats.get("exact_cuts", 0) + 1
        c = np.concatenate([c, tile[tile < tau]])
    shift = bin_shift(top)
    cut = hist_cut(c, shift, s)
    bins = (c >> np.uint64(shift)).astype(np.int64)
    c = c[bins <= cut]
    # placed by bins (behind all values held, or behind the kept ones
    # compacted) unless a bin is crowded or the kept fill over half of c
    most = int(np.bincount(bins[bins <= cut]).max(initial=0))
    path = ("by_bins" if most <= SMALL_BIN and 2 * c.size <= cap
            else "end_sorts")
    stats[path] = stats.get(path, 0) + 1
    stats["sorted"] = stats.get("sorted", 0) + c.size
    lst = np.sort(c)[:s]
    return np.concatenate([lst, np.full(s - lst.size, SENTINEL)])


def sketch_rows_model(keys_of_rows, n_words: int, k: int, s: int,
                      stats: dict | None = None) -> np.ndarray:
    """The select path's [B, s] sketches of B rows of n_words packed words
    (keys_of_rows: each row's valid windows' hashes, u64, in window
    order): each row's segments as the plan splits it, then their lists
    merged pairwise in rounds, each keeping the first min(2 len, s)."""
    B = len(keys_of_rows)
    tiles = -(-(16 * n_words - k + 1) // TILE)
    segs = int(n_lists(B, n_words, k, s))
    out = np.empty((B, s), dtype=np.uint64)
    for r, keys in enumerate(keys_of_rows):
        lists = [select_segment(keys, s, g * tiles // segs,
                                (g + 1) * tiles // segs, stats)
                 for g in range(segs)]
        while len(lists) > 1:
            lists = [np.sort(np.concatenate(lists[i:i + 2]))[:s]
                     for i in range(0, len(lists), 2)]
        out[r] = lists[0]
    return out
