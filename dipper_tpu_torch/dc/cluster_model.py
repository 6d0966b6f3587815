"""A numpy model of D&C phase 3's two kernels' plans: csrc/score_masked.cu
(kernel 8a, `score_masked`) and csrc/dc_cluster_build.cu (kernel 8b,
`build_chunk`). Used by the tests and by chip_smoke.py, never by a build:
a machine without a GPU holds the kernels' way of computing to the plain
version (dc/cluster.py: `_score_masked`, `cluster_step`, the streamed
loop) and to the JAX package (_cluster_build, _stream_range_run).

The kernels depart from the tensor code where the model does:
- only the 2 + 4 kq slots in use are scored; each is a candidate (score,
  mask position), (2.0, position) where its flag is off, and the one
  candidate (2.0, n_used) stands for every unused slot (the tensor code
  scores all E slots in mask order, the unused ones at 2.0);
- the first minimum is found by partial minima (a block's, in an order
  the hardware picks, then the blocks'), over a total order: NaN first,
  then the lower score, then the lower position;
- the flags are updated by the scorer (8a: from rev[eid] as it reads it)
  or after the splice (8b: from the splice's (xe, ye)), clearing first and
  then setting the new group;
- 8b's splice and BFS are insert_step.cu's (placement/insert_model.py:
  the warp's splice, the walk over the adjacency table with the block's
  threads and frontier buffers of `kernel_config(cmax)`), where the tensor
  code runs the dense BFS over all slots.

States are dicts of numpy arrays named as TreeState's fields (e, belong,
length, rev, cdis, cid, adj), as in insert_model, updated in place. The
per-slot arithmetic (side, clamp sequence) is the plain version's tensor
operations on the slots scored, so the model's bits are those of the
operations the kernels repeat one by one.
"""

from __future__ import annotations

import numpy as np
import torch

from dipper_tpu_torch.dc.cluster import new_group_scoreable
from dipper_tpu_torch.placement import insert_model as im
from dipper_tpu_torch.placement.kclosest import (SENT_DIS, _side_vector,
                                                 clamp_sequence)


def kernel_config(cmax: int) -> tuple[int, int]:
    """(threads a block, entries of a shared frontier buffer) of kernel 8b at
    bucket width cmax (dc_cluster_build.cu's launch_by_bucket)."""
    threads = 64 if cmax <= 32 else (128 if cmax <= 128 else 256)
    return threads, threads


def mask_position(s: int) -> int:
    """Slot s's place in the mask order (cluster.mask_order_perm's
    inverse, and the map is its own inverse)."""
    return s if s < 2 else s + 3 - 2 * ((s - 2) % 4)


def _before(a, b) -> bool:
    """(score, position, frac) a before b: NaN first, then the lower score,
    the lower position at equal scores."""
    a_nan, b_nan = a[0] != a[0], b[0] != b[0]
    if a_nan != b_nan:
        return a_nan
    if a_nan or a[0] == b[0]:
        return a[1] < b[1]
    return a[0] < b[0]


def candidates(s: dict, flags: np.ndarray, row: np.ndarray,
               n_used: int) -> list:
    """The (score, position, frac) of every slot below n_used, as the
    kernels' threads compute them."""
    dt = s["length"].dtype.type
    slots = np.flatnonzero(flags[:n_used])
    out = [(dt(SENT_DIS), mask_position(j), dt(0)) for j in range(n_used)]
    if len(slots):
        cid, cdis = torch.from_numpy(s["cid"]), torch.from_numpy(s["cdis"])
        sl = torch.from_numpy(slots)
        rev = torch.from_numpy(s["rev"])[sl].long().clamp(min=0)
        r = torch.from_numpy(np.ascontiguousarray(row))
        addi, frac = clamp_sequence(_side_vector(cid[sl], cdis[sl], r),
                                    _side_vector(cid[rev], cdis[rev], r),
                                    torch.from_numpy(s["length"])[sl])
        for j, a, f in zip(slots.tolist(), addi.numpy(), frac.numpy()):
            out[j] = (a, mask_position(j), f)
    return out


def first_minimum(cands: list, n_used: int, n_edges: int, dtype,
                  block_of=None, order=None):
    """The kernels' reduction: partial minima of the blocks (`block_of[j]`
    is slot j's block, default one; `order` the order in which a block's
    candidates meet, default ascending slots), then the blocks' minimum and
    the unused slots' candidate. Returns (eid, frac, score)."""
    dt = np.dtype(dtype).type
    block_of = np.zeros(n_used, np.int64) if block_of is None else block_of
    order = range(n_used) if order is None else order
    identity = (dt(np.inf), 2**31 - 1, dt(0))
    partial = {}
    for j in order:
        b = int(block_of[j])
        if _before(cands[j], partial.get(b, identity)):
            partial[b] = cands[j]
    best = identity
    for b in sorted(partial, reverse=True):  # any order gives the same
        if _before(partial[b], best):
            best = partial[b]
    if n_used < n_edges:
        unused = (dt(SENT_DIS), n_used, dt(0))
        if _before(unused, best):
            best = unused
    return mask_position(best[1]), best[2], best[0]


def clear_flags(flags: np.ndarray, xe: int, ye: int) -> None:
    """The flags of the edge an insertion split: xe and ye (indexed as a
    tensor index is) off."""
    for v in (xe, ye):
        if -flags.shape[0] <= v < flags.shape[0]:
            flags[v] = False


def set_group(flags: np.ndarray, base: int) -> None:
    """The flags of an insertion's four new slots from `base` (those that
    exist), after clear_flags."""
    for q, g in enumerate(new_group_scoreable()):
        if base + q < flags.shape[0]:
            flags[base + q] = g


def score_masked(s: dict, flags: np.ndarray, row: np.ndarray, n_used: int,
                 block_of=None, order=None) -> tuple:
    """Kernel 8a in place: the member whose slots in use are the first
    n_used scored, then its flags set. Returns (out_i, out_f) as the kernel
    writes them: (eid, belong[eid], e[eid], rev[eid]) and (frac, score)."""
    E = s["e"].shape[0]
    eid, frac, score = first_minimum(candidates(s, flags, row, n_used),
                                     n_used, E, s["length"].dtype, block_of,
                                     order)
    ye = int(s["rev"][eid])
    out_i = (eid, int(s["belong"][eid]), int(s["e"][eid]), ye)
    clear_flags(flags, eid, ye)
    set_group(flags, n_used)
    return out_i, (frac, score)


def build_cluster(s: dict, flags: np.ndarray, Dq: np.ndarray, size: int,
                  cmax: int, stats: dict | None = None) -> None:
    """Block c of kernel 8b in place: members 0 .. size - 1 of one cluster
    (arrays [E], adjacency [M, 3], flags [E]) from its rows Dq [>= size, W],
    each scored, spliced and walked with the block's plan."""
    threads, cap = kernel_config(cmax)
    E = s["e"].shape[0]
    for kq in range(min(size, cmax)):
        n_used = 2 + 4 * kq
        eid, frac, score = first_minimum(
            candidates(s, flags, Dq[kq], n_used), n_used, E,
            s["length"].dtype,
            block_of=np.zeros(n_used, np.int64),
            order=[j for t in range(threads)
                   for j in range(t, n_used, threads)])
        xy = im.insert_step(s, eid, frac, score, n_used, 2 + cmax + kq,
                            2 + kq, 10 + kq, block_slot=0, threads=threads,
                            cap=cap, stats=stats)
        if xy[0] >= 0:
            clear_flags(flags, *xy)
        set_group(flags, n_used)


def build_chunk(arrays: dict, flags: np.ndarray, Dq: np.ndarray, sizes,
                cmax: int, stats: dict | None = None) -> None:
    """Kernel 8b in place on a chunk's [C, ...] arrays (adjacency [C, M,
    3], flags [C, E]), Dq [C, >= max(sizes), W]: each cluster by its own
    block."""
    for c, size in enumerate(np.asarray(sizes).tolist()):
        build_cluster({f: a[c] for f, a in arrays.items()}, flags[c], Dq[c],
                      size, cmax, stats)


def stream_member(s: dict, flags: np.ndarray, cursor: list,
                  cmax: int) -> tuple:
    """One streamed member by the cursor route: kernel 8a reading the
    member and its row from `cursor` ([i, slots in use, rows, first
    member], insert_cuda's layout with the rows as an array), then
    insert_step's cursor entry with a streamed cluster's offsets and
    blocked slot 0. Returns (xe, ye)."""
    i, used, rows, lo = cursor
    out_i, out_f = score_masked(s, flags, np.asarray(rows[i - lo]), used)
    return im.insert_step_cursor(s, cursor, out_i, out_f,
                                 (2, 2 + cmax, 10), block_slot=0)


# ---------------------------------------------------------------------------
# Made-up inputs
# ---------------------------------------------------------------------------

# "random": distances in (0.05, 0.6); "ties": every value on a grid of
# eighths (lengths sixteenths), so that scores tie; "nan_row": member
# cmax // 2's row all NaN and member 1's every third entry NaN; "over_two":
# member 2's row 10.0, so that every valid score exceeds 2.0 and the
# smallest invalid position wins
CASES = ("random", "ties", "nan_row", "over_two")


def made_up_chunk(case: str, C: int, cmax: int, dtype: str, seed: int = 0):
    """A chunk of C clusters of bucket width cmax: (Dq [C, cmax, 10 +
    cmax], cd_init [C, 2, 5], cid_init [C, 2, 5], lens_init [C, 2], sizes
    ascending from 1 to cmax, ragged between), the witness lists of the
    cluster edge with empty entries in cluster 0's."""
    rng = np.random.default_rng(seed)
    W = 10 + cmax
    Dq = rng.uniform(0.05, 0.6, (C, cmax, W))
    cd = np.sort(rng.uniform(0, 0.3, (C, 2, 5)), axis=-1)
    cid = np.tile(np.arange(10, dtype=np.int32).reshape(2, 5), (C, 1, 1))
    cid[0, 1, 3:] = -1
    cd[0, 1, 3:] = SENT_DIS
    lens = rng.uniform(0.01, 0.2, (C, 2))
    if case == "ties":
        Dq = np.round(Dq * 8) / 8
        cd = np.where(cid != -1, np.round(cd * 8) / 8, cd)
        lens = np.maximum(np.round(lens * 16), 1) / 16
    elif case == "nan_row":
        Dq[:, cmax // 2] = np.nan
        Dq[:, min(1, cmax - 1), ::3] = np.nan
    elif case == "over_two":
        Dq[:, min(2, cmax - 1)] = 10.0
    elif case != "random":
        raise ValueError(f"unknown case {case!r}")
    lens[:, 1] = lens[:, 0]
    sizes = np.sort(rng.integers(1, cmax + 1, C))
    sizes[0], sizes[-1] = 1, cmax
    return (Dq.astype(dtype), cd.astype(dtype), cid, lens.astype(dtype),
            sizes)
