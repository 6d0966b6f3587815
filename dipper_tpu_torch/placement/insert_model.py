"""A numpy model of csrc/insert_step.cu's plan, and made-up inputs that
reach its corners. Used by the tests and by chip_smoke.py, never by a
build: a machine without a GPU holds the kernel's way of computing to
the plain version (`kclosest.splice` and
`kclosest._update_closest_bfs_compact`) and to the JAX package.

The kernel departs from the plain version in three places, which the
model follows: the middle->outside list of a splice is made by a stable
rank of the ten candidate values (NaN after every number), not by a
sort; the BFS takes a level's (frontier entry, out-edge) pairs in chunks
of THREADS and places the entries of the next frontier by a prefix sum
of each chunk's flags into [2, M] scratch; and the blocked nodes of an
insert step are read from a slot after the splice.

A state is a dict of numpy arrays named as TreeState's fields (e,
belong, length, rev, cdis, cid, adj), updated in place; `arrays_of`
gives such a dict of views of a CPU TreeState's tensors. The made-up
inputs at the end reach the kernel's corners: ties, empty entries and
NaN in the ten-way merge, and matrices with NaN.
"""

from __future__ import annotations

import numpy as np

K = 5
SENT_DIS = 2.0
THREADS = 256   # insert_step.cu's kThreads
DEGREE = 3      # adjacency slots a node
MAX_BLOCKED = 2

FIELDS = ("e", "belong", "length", "rev", "cdis", "cid", "adj")


def arrays_of(st) -> dict:
    """Numpy views of a CPU TreeState's arrays (writes go to the state)."""
    return {f: getattr(st, f).numpy() for f in FIELDS}


def _before(a, b) -> bool:
    """a strictly before b in torch's sort order: NaN after every number."""
    return a == a and (b != b or a < b)


def merge_ranks(v) -> list:
    """The stable rank of each of the values `v` (NaN last, earlier
    entries first among equals and among NaNs)."""
    n = len(v)
    return [sum(not _before(v[i], v[j]) for j in range(i))
            + sum(_before(v[j], v[i]) for j in range(i + 1, n))
            for i in range(n)]


def splice(s: dict, eid: int, frac, add, i0: int, middle: int,
           outside: int):
    """The kernel's splice in place: returns (xe, ye) as the kernel writes
    them to out_xy, or (-1, -1) and no write when eid or its reverse slot
    is not a slot of the state."""
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
    orig = s["length"][xe]
    rest = dt(orig - frac)
    cx, cy = s["cdis"][xe].copy(), s["cdis"][yi].copy()
    idx_, idy = s["cid"][xe].copy(), s["cid"][yi].copy()
    two = dt(SENT_DIS)
    # cd_i1 first, then cd_i0 ((cd + orig) - frac)
    v = ([dt(c + frac) if i != -1 else two for c, i in zip(cx, idx_)]
         + [dt(dt(c + orig) - frac) if i != -1 else two
            for c, i in zip(cy, idy)])
    ids = list(idx_) + list(idy)

    s["e"][xe] = middle
    s["e"][yi] = middle
    s["length"][xe] = frac
    s["length"][yi] = rest
    s["rev"][xe] = i0
    s["rev"][yi] = i1
    s["e"][i0:i0 + 4] = [x, y, middle, outside]
    s["belong"][i0:i0 + 4] = [middle, middle, outside, middle]
    s["rev"][i0:i0 + 4] = [xe, ye, i3, i2]
    s["length"][i0:i0 + 4] = [frac, rest, add, add]
    s["cdis"][i0] = v[K:]
    s["cid"][i0] = idy
    s["cdis"][i1] = v[:K]
    s["cid"][i1] = idx_
    s["cdis"][i2] = two
    s["cid"][i2] = -1
    for i, r in enumerate(merge_ranks(v)):
        if r < K:
            s["cdis"][i3, r] = v[i]
            s["cid"][i3, r] = ids[i]
    s["adj"][middle] = [i0, i1, i3]
    s["adj"][outside] = [i2, -1, -1]
    return xe, yi


def bfs(s: dict, leaf: int, label: int, blocked=(), threads: int = THREADS,
        levels: list | None = None, stats: dict | None = None) -> None:
    """The kernel's witness BFS from `leaf` in place: levels of chunks of
    `threads` (entry, out-edge) pairs, the next frontier placed by an
    exclusive prefix sum of each chunk's flags into the scratch's other
    half. `levels`, when given, gets each level's frontier width; `stats`
    adds up what the kernel reads and writes: levels, frontier entries,
    out-edges whose destination is read ("edges"), lists read
    ("lists") and lists inserted into ("inserts")."""
    E, M = s["e"].shape[0], s["adj"].shape[0]
    dt = s["length"].dtype.type
    ids = np.full((2, M), -1, np.int64)
    frm = np.full((2, M), -1, np.int64)
    dist = np.zeros((2, M), s["length"].dtype)
    ids[0, 0], frm[0, 0], dist[0, 0] = leaf, -1, 0
    blocked = np.asarray(list(blocked), np.int64)
    count, cur, level = 1, 0, 0
    while count > 0 and level < M:
        if levels is not None:
            levels.append(count)
        if stats is not None:
            stats["levels"] = stats.get("levels", 0) + 1
            stats["entries"] = stats.get("entries", 0) + count
        items = DEGREE * count
        nxt = 0
        for c0 in range(0, items, threads):
            j = np.arange(c0, min(items, c0 + threads))
            f = j // DEGREE
            node = ids[cur, f]
            expand = (node >= 0) & (node < M) & ~np.isin(node, blocked)
            eid = np.full(j.shape, -1, np.int64)
            eid[expand] = s["adj"][node[expand], (j - f * DEGREE)[expand]]
            live = (eid >= 0) & (eid < E)
            dst = np.full(j.shape, -1, np.int64)
            dst[live] = s["e"][eid[live]]
            n_edges = int(live.sum())
            live &= dst != frm[cur, f]
            rows = eid[live]
            d = dist[cur, f][live]
            cd = s["cdis"][rows]
            pos = (cd <= d[:, None]).sum(axis=1)
            ins = pos < K
            if stats is not None:
                for key, v in (("edges", n_edges), ("lists", len(rows)),
                               ("inserts", int(ins.sum()))):
                    stats[key] = stats.get(key, 0) + v
            rows, d, pos = rows[ins], d[ins], pos[ins]
            # _insert_sorted, row by row (the rows are distinct)
            for r, dd, p in zip(rows, d, pos):
                s["cdis"][r, p + 1:] = s["cdis"][r, p:K - 1].copy()
                s["cid"][r, p + 1:] = s["cid"][r, p:K - 1].copy()
                s["cdis"][r, p] = dd
                s["cid"][r, p] = label
            joins = np.zeros(j.shape, np.int64)
            where = np.flatnonzero(live)[ins]
            joins[where] = 1
            at = nxt + np.cumsum(joins) - joins      # exclusive scan
            keep = where[at[where] < M]
            ids[1 - cur, at[keep]] = dst[keep]
            frm[1 - cur, at[keep]] = node[keep]
            dist[1 - cur, at[keep]] = [dt(a + b) for a, b in zip(
                dist[cur, f[keep]], s["length"][eid[keep]])]
            nxt += int(joins.sum())
        count = min(nxt, M)
        cur = 1 - cur
        level += 1


def insert_step(s: dict, eid: int, frac, add, i0: int, middle: int,
                outside: int, label: int, block_slot: int = -1,
                threads: int = THREADS, stats: dict | None = None):
    """The kernel's insert_step in place: splice, then (if it spliced)
    the BFS from `outside`, not expanding the endpoints of `block_slot`
    as they stand after the splice. Returns out_xy."""
    xy = splice(s, eid, frac, add, i0, middle, outside)
    if xy[0] < 0:
        return xy
    blocked = ((int(s["belong"][block_slot]), int(s["e"][block_slot]))
               if block_slot >= 0 else ())
    bfs(s, outside, label, blocked, threads, stats=stats)
    return xy


def closest_bfs(s: dict, leaf: int, label: int | None = None, blocked=(),
                threads: int = THREADS) -> None:
    """The kernel's closest_bfs in place (at most MAX_BLOCKED nodes)."""
    if len(blocked) > MAX_BLOCKED:
        raise ValueError(f"at most {MAX_BLOCKED} blocked nodes")
    bfs(s, leaf, leaf if label is None else label, blocked, threads)


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

