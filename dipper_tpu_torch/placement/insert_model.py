"""A numpy model of csrc/insert_step.cu's plan, and made-up inputs that
reach its corners. Used by the tests and by chip_smoke.py, never by a
build: a machine without a GPU holds the kernel's way of computing to
the plain version (`kclosest.splice` and
`kclosest._update_closest_bfs_compact`) and to the JAX package.

The kernel departs from the plain version where the model does:
- the splice is a warp's: each of the six writes of e, length and rev
  (at xe, yi, i0 .. i3, in the plain version's order) is one lane's, and
  a lane leaves out a write that a later one puts at the same address;
  the middle->outside list is made by a stable rank of the ten candidate
  values (NaN after every number), not by a sort;
- the BFS's first level after a splice (outside -> middle over slot i2)
  is written with the splice, and the walk starts at middle;
- a level's frontier sits in two buffers of `cap` entries (the kernel's
  shared memory); entries from `cap` on spill to [2, M] scratch;
- a level of at most `narrow` (entry, out-edge) pairs is one warp's, its
  next frontier placed by a ballot (the joining lanes below each lane);
  a wider level is the block's, in chunks of `threads` pairs placed by a
  prefix sum of each chunk's flags;
- the blocked nodes of an insert step are those of a slot after the
  splice.

Every placement keeps the flat (entry, out-edge) order, so the bits do
not depend on `cap`, `narrow` or `threads`; the tests vary them to reach
the spill and the switches between narrow and wide levels, which `stats`
counts.

A state is a dict of numpy arrays named as TreeState's fields (e,
belong, length, rev, cdis, cid, adj), updated in place; `arrays_of`
gives such a dict of views of a CPU TreeState's tensors. The made-up
inputs at the end reach the kernel's corners: ties, empty entries and
NaN in the ten-way merge, a choice whose writes overlap, and matrices
with NaN.
"""

from __future__ import annotations

import numpy as np

K = 5
SENT_DIS = 2.0
THREADS = 256   # insert_step.cu's kThreads
CAP = 256       # kCap: frontier entries a shared buffer holds
NARROW = 32     # kNarrow: pairs of a level that one warp takes
DEGREE = 3      # adjacency slots a node
MAX_BLOCKED = 2

FIELDS = ("e", "belong", "length", "rev", "cdis", "cid", "adj")


def arrays_of(st) -> dict:
    """Numpy views of a CPU TreeState's arrays (writes go to the state)."""
    return {f: getattr(st, f).numpy() for f in FIELDS}


def _before(a, b) -> bool:
    """a strictly before b in torch's sort order: NaN after every number."""
    return a == a and (b != b or a < b)


def sort_key(v) -> int:
    """The kernel's sort_key of a float32 or float64 value: its bits made
    to compare as the values do in torch's sort order (NaN after every
    number, all NaNs equal, -0 equal to +0), so that _before(a, b) holds
    exactly when sort_key(a) < sort_key(b)."""
    a = np.asarray(v)
    bits = 8 * a.dtype.itemsize
    ones = (1 << bits) - 1
    if a != a:
        return ones
    b = int(np.asarray(0 if a == 0 else a, a.dtype).view(f"u{bits // 8}"))
    sign = 1 << (bits - 1)
    return ~b & ones if b & sign else b | sign


def merge_ranks(v) -> list:
    """The stable rank of each of the values `v` (NaN last, earlier
    entries first among equals and among NaNs), as the kernel's lanes
    count it from the values' sort keys."""
    k = [sort_key(x) for x in np.asarray(v)]
    n = len(k)
    return [sum(k[j] <= k[i] for j in range(i))
            + sum(k[j] < k[i] for j in range(i + 1, n)) for i in range(n)]


def _add(dt, a, b):
    return dt(dt(a) + dt(b))


def splice(s: dict, eid: int, frac, add, i0: int, middle: int,
           outside: int):
    """The kernel's splice in place: returns (xe, ye) as the kernel writes
    them to out_xy, or (-1, -1) and no write when eid or its reverse slot
    is not a slot of the state. The lists of slot i2 are left empty (the
    BFS's first level is insert_step's)."""
    E = s["e"].shape[0]
    dt = s["length"].dtype.type
    frac, add = dt(frac), dt(add)
    if not 0 <= eid < E:
        return -1, -1
    xe = eid
    x, y = int(s["belong"][xe]), int(s["e"][xe])
    ye = int(s["rev"][xe])
    yi = ye + E if ye < 0 else ye
    if not 0 <= yi < E:
        return -1, -1
    i1, i2, i3 = i0 + 1, i0 + 2, i0 + 3
    # one round trip: lanes 0-9 the two lists, lane 10 the length
    orig = s["length"][xe]
    rest = dt(orig - frac)
    c = list(s["cdis"][xe]) + list(s["cdis"][yi])
    ids = [int(v) for v in s["cid"][xe]] + [int(v) for v in s["cid"][yi]]
    two = dt(SENT_DIS)
    # lane k: cd_i1 (k < 5), then cd_i0 ((cd + orig) - frac)
    v = [(_add(dt, c[k], frac) if k < K else dt(_add(dt, c[k], orig) - frac))
         if ids[k] != -1 else two for k in range(2 * K)]
    ranks = merge_ranks(v)
    # lane p of the six writes of e, length and rev, at `at[p]`, unless a
    # later lane writes there
    at = [xe, yi, i0, i1, i2, i3]
    ne = [middle, middle, x, y, middle, outside]
    nl = [frac, rest, frac, rest, add, add]
    nr = [i0, i1, xe, ye, i3, i2]
    for p in range(6):
        if at[p] not in at[p + 1:]:
            s["e"][at[p]], s["length"][at[p]], s["rev"][at[p]] = (
                ne[p], nl[p], nr[p])
    s["belong"][i0:i0 + 4] = [middle, middle, outside, middle]
    s["cdis"][i1], s["cid"][i1] = v[:K], ids[:K]
    s["cdis"][i0], s["cid"][i0] = v[K:], ids[K:]
    s["cdis"][i2], s["cid"][i2] = two, -1
    for k, r in enumerate(ranks):
        if r < K:
            s["cdis"][i3, r] = v[k]
            s["cid"][i3, r] = ids[k]
    if middle != outside:
        s["adj"][middle] = [i0, i1, i3]
    s["adj"][outside] = [i2, -1, -1]
    return xe, yi


class _Frontier:
    """The two frontier buffers: entries below `cap` in the shared ones,
    the others in the [2, M] spill at the same index."""

    def __init__(self, M: int, cap: int, dtype):
        self.cap = cap
        self.ids = np.full((2, min(cap, M)), -1, np.int64)
        self.frm = np.full((2, min(cap, M)), -1, np.int64)
        self.dist = np.zeros((2, min(cap, M)), dtype)
        self.s_ids = np.full((2, M), -1, np.int64)
        self.s_frm = np.full((2, M), -1, np.int64)
        self.s_dist = np.zeros((2, M), dtype)

    def get(self, buf: int, f: int):
        if f < self.cap:
            return self.ids[buf, f], self.frm[buf, f], self.dist[buf, f]
        return self.s_ids[buf, f], self.s_frm[buf, f], self.s_dist[buf, f]

    def put(self, buf: int, at: int, entry) -> bool:
        """Stores the entry; True when it spilled."""
        if at < self.cap:
            self.ids[buf, at], self.frm[buf, at], self.dist[buf, at] = entry
            return False
        self.s_ids[buf, at], self.s_frm[buf, at], self.s_dist[buf, at] = entry
        return True


def _visit(s: dict, node: int, frm: int, d, k: int, blocked, label: int,
           stats: dict | None):
    """One (frontier entry, out-edge k) pair: the far node's entry when it
    joins the next frontier (after (d, label) went into the edge's list),
    else None."""
    E, M = s["e"].shape[0], s["adj"].shape[0]
    dt = s["length"].dtype.type
    if not 0 <= node < M or node in blocked:
        return None
    eid = int(s["adj"][node, k])
    if not 0 <= eid < E:
        return None
    dst = int(s["e"][eid])
    if stats is not None:
        stats["edges"] = stats.get("edges", 0) + 1
    if dst == frm:
        return None
    cd = s["cdis"][eid]
    pos = int((cd <= d).sum())
    if stats is not None:
        stats["lists"] = stats.get("lists", 0) + 1
    if pos >= K:
        return None
    if stats is not None:
        stats["inserts"] = stats.get("inserts", 0) + 1
    # _insert_sorted
    s["cdis"][eid, pos + 1:] = s["cdis"][eid, pos:K - 1].copy()
    s["cid"][eid, pos + 1:] = s["cid"][eid, pos:K - 1].copy()
    s["cdis"][eid, pos] = d
    s["cid"][eid, pos] = label
    return dst, node, _add(dt, d, s["length"][eid])


def _walk(s: dict, fr: _Frontier, count: int, level: int, label: int,
          blocked, threads: int, narrow: int, levels: list | None,
          stats: dict | None) -> None:
    """The kernel's walk from the `count` entries of buffer 0 at `level`:
    narrow levels by a warp, wide ones by the block, each placing the next
    frontier in the other buffer; at most M levels, a frontier cut at M
    entries."""
    M = s["adj"].shape[0]
    cur, was_wide = 0, None

    def add(key, v=1):
        if stats is not None:
            stats[key] = stats.get(key, 0) + v

    while count > 0 and level < M:
        if levels is not None:
            levels.append(count)
        add("levels")
        add("entries", count)
        items = DEGREE * count
        wide = items > narrow
        add("wide_levels" if wide else "narrow_levels")
        if was_wide is not None and wide != was_wide:
            add("switches")
        was_wide = wide
        # a warp's ballot places the joining lanes of its one chunk; the
        # block's scan those of each chunk of `threads`, after the ones
        # before: both give the flat order
        width = threads if wide else narrow
        nxt = 0
        for c0 in range(0, items, width):
            joins = []
            for j in range(c0, min(items, c0 + width)):
                f = j // DEGREE
                node, frm, d = fr.get(cur, f)
                got = _visit(s, int(node), int(frm), d, j - f * DEGREE,
                             blocked, label, stats)
                if got is not None:
                    joins.append(got)
            for rank, entry in enumerate(joins):
                at = nxt + rank
                if at < M and fr.put(1 - cur, at, entry):
                    add("spilled")
            nxt += len(joins)
        count = min(nxt, M)
        cur = 1 - cur
        level += 1


def bfs(s: dict, leaf: int, label: int, blocked=(), threads: int = THREADS,
        levels: list | None = None, stats: dict | None = None,
        cap: int = CAP, narrow: int = NARROW) -> None:
    """The kernel's witness BFS from `leaf` in place (closest_bfs).
    `levels`, when given, gets each level's frontier width; `stats` adds
    up what the kernel reads, writes and how: levels, frontier entries,
    out-edges whose destination is read ("edges"), lists compared
    ("lists") and inserted into ("inserts"), narrow and wide levels, the
    switches between them, and frontier entries that spilled."""
    M = s["adj"].shape[0]
    fr = _Frontier(M, cap, s["length"].dtype)
    fr.put(0, 0, (leaf, -1, 0))
    _walk(s, fr, 1, 0, label, set(int(b) for b in blocked), threads, narrow,
          levels, stats)


def insert_step(s: dict, eid: int, frac, add, i0: int, middle: int,
                outside: int, label: int, block_slot: int = -1,
                threads: int = THREADS, stats: dict | None = None,
                cap: int = CAP, narrow: int = NARROW):
    """The kernel's insert_step in place: splice, then (if it spliced)
    the BFS's first level with it (unless `outside` is blocked) and the
    walk from middle, not expanding the endpoints of `block_slot` as they
    stand after the splice. Returns out_xy."""
    xy = splice(s, eid, frac, add, i0, middle, outside)
    if xy[0] < 0:
        return xy
    M = s["adj"].shape[0]
    dt = s["length"].dtype.type
    blocked = ({int(s["belong"][block_slot]), int(s["e"][block_slot])}
               if block_slot >= 0 else set())
    fr = _Frontier(M, cap, s["length"].dtype)
    count = 0
    if outside not in blocked:
        # level 0: slot i2 (outside -> middle, its list empty) gets (0,
        # label) in front, and middle is the next frontier
        i2 = i0 + 2
        s["cdis"][i2, 0], s["cid"][i2, 0] = 0, label
        fr.put(0, 0, (middle, outside, _add(dt, 0, s["length"][i2])))
        count = 1
        if stats is not None:
            for key in ("levels", "entries", "edges", "lists", "inserts",
                        "narrow_levels"):
                stats[key] = stats.get(key, 0) + 1
    _walk(s, fr, count, 1, label, blocked, threads, narrow, None, stats)
    return xy


def closest_bfs(s: dict, leaf: int, label: int | None = None, blocked=(),
                threads: int = THREADS, cap: int = CAP,
                narrow: int = NARROW, stats: dict | None = None) -> None:
    """The kernel's closest_bfs in place (at most MAX_BLOCKED nodes)."""
    if len(blocked) > MAX_BLOCKED:
        raise ValueError(f"at most {MAX_BLOCKED} blocked nodes")
    bfs(s, leaf, leaf if label is None else label, blocked, threads,
        stats=stats, cap=cap, narrow=narrow)


# ---------------------------------------------------------------------------
# Made-up inputs
# ---------------------------------------------------------------------------

NAN = float("nan")

# (x-side list, its ids, y-side list, its ids, length of the chosen edge,
# frac) of one splice on edge 0 of a two-taxon tree
SPLICE_CASES = {
    # equal values within and across the two lists
    "ties": ([0.0, 0.125, 0.125, 0.5, 1.0], [0, 1, 2, 3, 0],
             [0.0, 0.125, 0.125, 0.5, 1.0], [1, 2, 3, 0, 1], 0.5, 0.25),
    # empty entries become 2.0 and tie with a real 2.0
    "sentinels": ([0.0, 1.75, 2.0, 2.0, 2.0], [0, 1, -1, -1, -1],
                  [0.25, 2.0, 2.0, 2.0, 2.0], [1, -1, -1, -1, -1], 0.5,
                  0.25),
    "nan_entries": ([NAN, 0.125, NAN, 0.5, 2.0], [0, 1, 2, 3, -1],
                    [0.0, NAN, NAN, 2.0, 2.0], [1, 0, 3, -1, -1], 0.5, 0.25),
    "nan_frac": ([0.0, 0.125, 0.25, 0.5, 2.0], [0, 1, 2, 3, -1],
                 [0.0, 0.125, 2.0, 2.0, 2.0], [1, 2, -1, -1, -1], 0.5, NAN),
    "all_nan": ([NAN] * 5, [0, 1, 2, 3, 0], [NAN] * 5, [1, 2, 3, 0, 1], NAN,
                NAN),
}
SPLICE_ADD = 0.375


def overlap_state(dtype: str):
    """A choice whose writes overlap, on a four-taxon state (N = 4: 16
    slots, 8 nodes) whose slots 4 .. 11 are left unused and whose next
    slot is 12: eid 12 is unused (its ends and reverse -1), so xe is the
    first new slot and the reverse -1, indexed as a tensor index, is the
    last. Returns (state as numpy arrays with idx, eid, frac, add,
    middle, outside)."""
    dt = np.dtype(dtype)
    n, E = 4, 16
    d = {"e": np.full(E, -1, np.int32), "belong": np.full(E, -1, np.int32),
         "length": np.zeros(E, dt), "rev": np.full(E, -1, np.int32),
         "cdis": np.full((E, K), SENT_DIS, dt),
         "cid": np.full((E, K), -1, np.int32),
         "adj": np.full((2 * n, DEGREE), -1, np.int32), "idx": 12}
    d["e"][:4], d["belong"][:4] = [n, n, 0, 1], [0, 1, n, n]
    d["length"][:4], d["rev"][:4] = 0.25, [2, 3, 0, 1]
    d["adj"][0, 0], d["adj"][1, 0], d["adj"][n, :2] = 0, 1, [2, 3]
    d["cdis"][0, 0], d["cid"][0, 0] = 0.0, 0
    d["cdis"][2, 0], d["cid"][2, 0] = 0.0, 1
    return d, 12, dt.type(0.125), dt.type(0.375), 5, 2


def made_up_matrix(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """An n x n f64 distance matrix: "random" (symmetric, uniform),
    "caterpillar" (|i - j|, the deepest BFS), "some_nan" (random with
    15% of the pairs NaN) or "all_nan" (-d 3's saturated pairs)."""
    rng = np.random.default_rng(seed)
    if kind == "caterpillar":
        i = np.arange(n, dtype=np.float64)
        D = np.abs(i[:, None] - i[None, :])
        return D / (D.max() * 1.05)
    D = rng.random((n, n))
    D = (D + D.T) / 2.2
    if kind == "some_nan":
        bad = rng.random((n, n)) < 0.15
        D[bad | bad.T] = np.nan
    elif kind == "all_nan":
        D[:] = np.nan
    elif kind != "random":
        raise ValueError(f"unknown kind {kind!r}")
    np.fill_diagonal(D, 0)
    return D


def balanced_newick(n_leaves: int, rng) -> str:
    """A balanced binary tree over L0..L{n-1} with random lengths (levels
    of a BFS over it are wide)."""
    def sub(lo, hi):
        if hi - lo == 1:
            return f"L{lo}"
        mid = (lo + hi) // 2
        return (f"({sub(lo, mid)}:{rng.uniform(0.01, 0.1):.4f},"
                f"{sub(mid, hi)}:{rng.uniform(0.01, 0.1):.4f})")
    return sub(0, n_leaves) + ";"

