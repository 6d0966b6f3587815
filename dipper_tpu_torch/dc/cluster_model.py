"""A numpy model of D&C phase 3's two kernels' plans: csrc/dc_stream_block.cu
(kernel 8a, `stream_block`) and csrc/dc_cluster_build.cu (kernel 8b,
`build_chunk`). Used by the tests and by chip_smoke.py, never by a build:
a machine without a GPU holds the kernels' way of computing to the plain
version (dc/cluster.py: `_score_masked`, `cluster_step`, the streamed
loop) and to the JAX package (_cluster_build, _stream_range_run).

The kernels depart from the tensor code where the model does:
- only the 2 + 4 kq slots in use are scored; each is a candidate (score,
  mask position), (2.0, position) where its flag is off, and the one
  candidate (2.0, n_used) stands for every unused slot (the tensor code
  scores all E slots in mask order, the unused ones at 2.0);
- the first minimum is found by partial minima (a lane's, a warp's, a
  block's, in an order the hardware picks, then the blocks'), over a total
  order: NaN first, then the lower score, then the lower position;
- the flags are updated after the splice, from the splice's (xe, ye):
  cleared first, then the new group set;
- the splice and the walk are insert_step.cu's (placement/insert_model.py:
  the warp's splice, the walk over the adjacency table), where the tensor
  code runs the dense BFS over all slots.

Kernel 8b takes one of three plans by bucket (`kernel_config`):
- "warp" (cmax <= 32): a warp a cluster, WARPS_PER_BLOCK clusters a block,
  each warp's cluster state in its own slice of the block's shared memory
  (`slice_layout`): staged in at the start, written back at the end. A
  member's row entries that the lists can name (witness ids below 10 + kq)
  are staged into the slice one member ahead. The warp scores, reduces by
  shuffles, splices and walks every level in chunks of 32 pairs;
- "block" (cmax <= 512 where the slice fits): a block a cluster, its state
  in one slice; the block scores and reduces, warp 0 splices and walks;
- "global" (wider buckets): a block a cluster over the state in device
  memory, the frontier in shared buffers of `cap` entries that spill (PR
  15's plan).
Kernel 8a builds one row block of a streamed cluster in one launch on a
cluster of `ctas` blocks: block r scores the slots of the tiles r, r +
ctas, ... of `threads` slots, the partials meet in block 0 in rank order,
and block 0 splices and walks with insert_step.cu's block plan.

States are dicts of numpy arrays named as TreeState's fields (e, belong,
length, rev, cdis, cid, adj), as in insert_model, updated in place. The
per-slot arithmetic (side, clamp sequence) is the plain version's tensor
operations on the slots scored, so the model's bits are those of the
operations the kernels repeat one by one.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dipper_tpu_torch.dc.cluster import new_group_scoreable, stream_offsets
from dipper_tpu_torch.placement import insert_model as im
from dipper_tpu_torch.placement.kclosest import (SENT_DIS, _side_vector,
                                                 clamp_sequence)

K = im.K
WARP = 32
# kernel 8b: clusters (warps) a block of the warp plan; the dynamic shared
# memory a block may take (H100: 232,448 bytes a block, less 1 KB for the
# kernel's static shared memory); the widest bucket of the block plan
WARPS_PER_BLOCK = 4
SMEM_LIMIT = 232448 - 1024
BLOCK_PLAN_MAX = 512
# kernel 8a: blocks of the thread-block cluster, threads a block, entries
# of block 0's shared frontier buffers (insert_step.cuh's walk)
STREAM_CTAS = 16
STREAM_THREADS = 256
STREAM_CAP = 256

Plan = collections.namedtuple("Plan", "kind threads cap clusters smem")


def slice_layout(cmax: int, itemsize: int) -> tuple[dict, int]:
    """One cluster's state in shared memory (dc_cluster_build.cu's Slice):
    name -> (byte offset, entries, dtype code) and the slice's bytes (a
    multiple of 16). The float arrays first, then the int32 ones, then the
    flags: length [E], cdis [E, 5], the frontier's distances [2, M], the
    staged row [10 + cmax]; e, belong, rev [E], cid [E, 5], adj [M, 3], the
    frontier's nodes and origins [2, M]; flags [E]."""
    E, M, R = 2 + 4 * cmax, 2 + 2 * cmax, 10 + cmax
    parts = [("length", E, "f"), ("cdis", K * E, "f"), ("f_dist", 2 * M, "f"),
             ("row", R, "f"), ("e", E, "i"), ("belong", E, "i"),
             ("rev", E, "i"), ("cid", K * E, "i"), ("adj", 3 * M, "i"),
             ("f_ids", 2 * M, "i"), ("f_frm", 2 * M, "i"),
             ("flags", E, "b")]
    size = {"f": itemsize, "i": 4, "b": 1}
    out, at = {}, 0
    for name, n, code in parts:
        out[name] = (at, n, code)
        at += n * size[code]
    return out, -(-at // 16) * 16


def kernel_config(cmax: int, itemsize: int = 4) -> Plan:
    """Kernel 8b's plan at bucket width cmax for a float type of
    `itemsize` bytes (dc_cluster_build.cu's launch_by_bucket): its kind,
    threads a block, frontier entries in shared memory, clusters a block
    and dynamic shared memory bytes a block."""
    _, one = slice_layout(cmax, itemsize)
    M = 2 + 2 * cmax
    if cmax <= WARP:
        return Plan("warp", WARP * WARPS_PER_BLOCK, M, WARPS_PER_BLOCK,
                    WARPS_PER_BLOCK * one)
    threads = 128 if cmax <= 128 else 256
    if cmax <= BLOCK_PLAN_MAX and one <= SMEM_LIMIT:
        return Plan("block", threads, M, 1, one)
    return Plan("global", threads, threads, 1, 0)


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
    candidates meet, default ascending slots), then the blocks' minimum in
    rank order and the unused slots' candidate. Returns (eid, frac,
    score)."""
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
    for b in sorted(partial):
        if _before(partial[b], best):
            best = partial[b]
    if n_used < n_edges:
        unused = (dt(SENT_DIS), n_used, dt(0))
        if _before(unused, best):
            best = unused
    return mask_position(best[1]), best[2], best[0]


def lane_order(n_used: int, threads: int) -> list:
    """The order in which a group of `threads` lanes meets the slots in use:
    lane t takes t, t + threads, ... (the order does not change the
    minimum: `before` is a total order)."""
    return [j for t in range(threads) for j in range(t, n_used, threads)]


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
    """A member's masked score and its flags in place: the member whose
    slots in use are the first n_used scored, then the flags of its
    insertion set (the chosen edge and its reverse slot off, as rev[eid]
    reads, then the new group). Returns ((eid, belong[eid], e[eid],
    rev[eid]), (frac, score)): the choice and its edge's ends."""
    E = s["e"].shape[0]
    eid, frac, score = first_minimum(candidates(s, flags, row, n_used),
                                     n_used, E, s["length"].dtype, block_of,
                                     order)
    ye = int(s["rev"][eid])
    out_i = (eid, int(s["belong"][eid]), int(s["e"][eid]), ye)
    clear_flags(flags, eid, ye)
    set_group(flags, n_used)
    return out_i, (frac, score)


def _member(s: dict, flags: np.ndarray, row, kq: int, cmax: int,
            score_threads: int, walk_threads: int, cap: int,
            block_of=None, frontier=None, stats=None) -> tuple:
    """Member kq of a cluster in place, as every plan runs it: the masked
    score, the splice and walk with a streamed cluster's offsets and slot 0
    blocked, then the flags from the splice's (xe, ye). Returns ((eid, xe,
    ye), (frac, score))."""
    n_used = 2 + 4 * kq
    E = s["e"].shape[0]
    order = (lane_order(n_used, score_threads) if block_of is None
             else range(n_used))
    eid, frac, score = first_minimum(candidates(s, flags, row, n_used),
                                     n_used, E, s["length"].dtype, block_of,
                                     order)
    o, m, lab = stream_offsets(cmax)
    xy = im.insert_step(s, eid, frac, score, n_used, m + kq, o + kq,
                        lab + kq, block_slot=0, threads=walk_threads,
                        stats=stats, cap=cap, frontier=frontier)
    if xy[0] >= 0:
        clear_flags(flags, *xy)
    set_group(flags, n_used)
    return (eid, *xy), (frac, score)


# ---------------------------------------------------------------------------
# Kernel 8b
# ---------------------------------------------------------------------------


class _Slice:
    """One cluster's slice of a block's shared memory (a numpy buffer laid
    out by slice_layout): views named as the state's fields, the flags, the
    staged row and the walk's frontier (cap = M, nothing spills)."""

    def __init__(self, buf: np.ndarray, at: int, cmax: int, dtype):
        dt = np.dtype(dtype)
        layout, _ = slice_layout(cmax, dt.itemsize)
        code = {"f": dt, "i": np.dtype(np.int32), "b": np.dtype(np.bool_)}
        self.v = {name: buf[at + off:at + off + n * code[c].itemsize]
                  .view(code[c]) for name, (off, n, c) in layout.items()}
        E, M = 2 + 4 * cmax, 2 + 2 * cmax
        self.v["cdis"] = self.v["cdis"].reshape(E, K)
        self.v["cid"] = self.v["cid"].reshape(E, K)
        self.v["adj"] = self.v["adj"].reshape(M, 3)
        self.state = {f: self.v[f] for f in im.FIELDS}
        self.frontier = im._Frontier(M, M, dt)
        self.frontier.ids = self.v["f_ids"].reshape(2, M)
        self.frontier.frm = self.v["f_frm"].reshape(2, M)
        self.frontier.dist = self.v["f_dist"].reshape(2, M)

    def stage_in(self, s: dict, flags: np.ndarray) -> None:
        for f in im.FIELDS:
            self.state[f][...] = s[f]
        self.v["flags"][...] = flags

    def write_back(self, s: dict, flags: np.ndarray) -> None:
        for f in im.FIELDS:
            s[f][...] = self.state[f]
        flags[...] = self.v["flags"]

    def stage_row(self, Dq_c: np.ndarray, kq: int) -> None:
        """Row kq's entries that member kq's lists can name (witness ids
        below 10 + kq, within the row's W)."""
        n = min(10 + kq, Dq_c.shape[1])
        self.v["row"][:n] = Dq_c[kq, :n]


def build_cluster(s: dict, flags: np.ndarray, Dq: np.ndarray, size: int,
                  cmax: int, stats: dict | None = None,
                  plan: Plan | None = None) -> None:
    """One cluster of kernel 8b in place (arrays [E], adjacency [M, 3],
    flags [E]): members 0 .. size - 1 from its rows Dq [>= size, W] by
    `plan` (default: kernel_config's). The shared plans run on a slice of
    their own (build_chunk stages a block's slices together)."""
    plan = plan or kernel_config(cmax, s["length"].dtype.itemsize)
    if plan.kind == "global":
        for kq in range(min(size, cmax)):
            _member(s, flags, Dq[kq], kq, cmax, plan.threads, plan.threads,
                    plan.cap, stats=stats)
        return
    _, one = slice_layout(cmax, s["length"].dtype.itemsize)
    sl = _Slice(np.zeros(one, np.uint8), 0, cmax, s["length"].dtype)
    sl.stage_in(s, flags)
    _build_in_slice(sl, Dq, size, cmax, plan, stats)
    sl.write_back(s, flags)


def _build_in_slice(sl: _Slice, Dq: np.ndarray, size: int, cmax: int,
                    plan: Plan, stats) -> None:
    score_threads = WARP if plan.kind == "warp" else plan.threads
    for kq in range(min(size, cmax)):
        sl.stage_row(Dq, kq)
        _member(sl.state, sl.v["flags"], sl.v["row"], kq, cmax,
                score_threads, WARP, plan.cap, frontier=sl.frontier,
                stats=stats)


def build_chunk(arrays: dict, flags: np.ndarray, Dq: np.ndarray, sizes,
                cmax: int, stats: dict | None = None) -> None:
    """Kernel 8b in place on a chunk's [C, ...] arrays (adjacency [C, M,
    3], flags [C, E]), Dq [C, >= max(sizes), W], by kernel_config's plan:
    under a shared plan, each block's clusters staged into their slices of
    one buffer of the block's shared memory, built, then written back."""
    sizes = np.asarray(sizes).tolist()
    dtype = arrays["length"].dtype
    plan = kernel_config(cmax, dtype.itemsize)

    def cluster(c):
        return {f: a[c] for f, a in arrays.items()}

    if plan.kind == "global":
        for c, size in enumerate(sizes):
            build_cluster(cluster(c), flags[c], Dq[c], size, cmax, stats,
                          plan)
        return
    _, one = slice_layout(cmax, dtype.itemsize)
    for c0 in range(0, len(sizes), plan.clusters):
        cs = range(c0, min(len(sizes), c0 + plan.clusters))
        buf = np.zeros(plan.smem, np.uint8)
        slices = [_Slice(buf, w * one, cmax, dtype) for w in range(len(cs))]
        for sl, c in zip(slices, cs):
            sl.stage_in(cluster(c), flags[c])
        for sl, c in zip(slices, cs):
            _build_in_slice(sl, Dq[c], sizes[c], cmax, plan, stats)
        for sl, c in zip(slices, cs):
            sl.write_back(cluster(c), flags[c])


# ---------------------------------------------------------------------------
# Kernel 8a
# ---------------------------------------------------------------------------


def stream_shares(n_used: int, ctas: int = STREAM_CTAS,
                  threads: int = STREAM_THREADS) -> np.ndarray:
    """The block of the cluster that scores each slot in use: tile t of
    `threads` slots goes to block t mod ctas."""
    return (np.arange(n_used) // threads) % ctas


def stream_block(s: dict, flags: np.ndarray, rows: np.ndarray, kq0: int,
                 cmax: int, ctas: int = STREAM_CTAS,
                 threads: int = STREAM_THREADS, cap: int = STREAM_CAP,
                 stats: dict | None = None) -> tuple:
    """Kernel 8a in place: members kq0 .. kq0 + len(rows) - 1 of a streamed
    cluster (arrays [E], adjacency [M, 3], flags [E]), member kq's row
    rows[kq - kq0]. Each member's slots in use are scored by the cluster's
    blocks (stream_shares), their partial minima met in block 0 in rank
    order; block 0 splices and walks with its threads and frontier
    buffers. Returns the last member's ((eid, xe, ye), (frac, score)), as
    the kernel writes them to out_i and out_f."""
    out = ((-1, -1, -1), (0, 0))
    for j in range(len(rows)):
        kq = kq0 + j
        out = _member(s, flags, rows[j], kq, cmax, threads, threads, cap,
                      block_of=stream_shares(2 + 4 * kq, ctas, threads),
                      stats=stats)
    return out


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
