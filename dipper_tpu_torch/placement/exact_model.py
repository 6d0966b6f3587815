"""A numpy model of csrc/exact_step.cu's plan: one insertion of exact
placement (the level order, both sweeps, the score, the splice and the
depth shift) as one block of threads computes it. Used by the tests and by
chip_smoke.py, never by a build: a machine without a GPU holds the
kernel's way of computing to the plain version (placement/exact.py:
`_compute_lims`, `_score_exact`, `_splice_exact`) and to the JAX package.

The kernel departs from the plain version where the model does:
- the tree is walked top-down from the root N over the adjacency table,
  level by level, into a list of positions: position p holds a node, its
  upward edge (node -> parent) and downward edge (parent -> node), the
  lengths of both, and where its children start in the next level and how
  many there are. A level's children are placed in the flat (entry,
  adjacency slot) order, as a block-wide prefix sum over chunks of
  `threads` entries places them, so the list does not depend on the
  chunk width. The greatest depth is the number of levels less one; the
  host never reads it. `dep` is not read by the sweeps: the level is the
  walk's;
- lim lives by position (limup: the upward edge's, limdn: the downward
  edge's), not by slot;
- the up-sweep (levels maxdep .. 1) takes, for each node, the maximum of
  its base (the row's value for a leaf, 0 otherwise) and its children's
  limup - lenup; the down-sweep (levels 0 .. maxdep - 1) takes each
  node's at most three incident edges in adjacency order (the upward
  edge's candidate first), and applies the plain version's top-2 rule
  (the first maximum, how many edges reach it, the maximum of the others)
  to each child: a NaN among them makes every child's value NaN;
- every used slot is one position's upward or downward edge, so the
  candidates are two a position: the downward edge's score, and the
  upward edge's (SENT_DIS, frac 0); the first minimum is taken over the
  order of torch.argmin (NaN first, then the lower score, the lower slot);
- the depth shift of ch's subtree walks down the list: the positions of a
  subtree's next level are the range from its first position's children
  to its last position's last child.

A state is a dict of numpy arrays named as ExactState's fields and its
adjacency table (e, belong, length, rev, parent, dep, adj), updated in
place; `arrays_of` gives such a dict of views of a CPU ExactState's
tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dipper_tpu_torch.placement.kclosest import SENT_DIS, clamp_sequence

THREADS = 1024  # exact_step.cu's kExactThreads
FIELDS = ("e", "belong", "length", "rev", "parent", "dep", "adj")


def arrays_of(st) -> dict:
    """Numpy views of a CPU ExactState's arrays (writes go to the state)."""
    return {f: getattr(st, f).numpy() for f in FIELDS}


def amax(a, b):
    """The plain version's scatter maximum and torch.maximum: a NaN wins
    (the first one met)."""
    if a != a:
        return a
    if b != b:
        return b
    return b if b > a else a


def clamp0(v):
    """torch.clamp(v, min=0): NaN stays NaN."""
    return v if (v != v or v > 0) else type(v)(0)


@dataclasses.dataclass
class Walk:
    """The level order of one insertion (the kernel's scratch lists)."""
    node: list
    up: list
    dn: list
    lenup: list
    lendn: list
    cs: list
    nc: list
    starts: list  # level l's positions: starts[l] .. starts[l + 1] - 1

    @property
    def maxdep(self) -> int:
        return len(self.starts) - 2

    def level(self, l: int) -> range:
        return range(self.starts[l], self.starts[l + 1])


def walk(s: dict, N: int, threads: int = THREADS) -> Walk:
    """The level order of the state's tree from the root N. Each level is
    taken in chunks of `threads` entries; an entry's children (its
    adjacency slots but its upward edge, in slot order) are placed after
    those of the entries before it."""
    e, rev, length, adj = s["e"], s["rev"], s["length"], s["adj"]
    E, M = e.shape[0], adj.shape[0]
    zero = length.dtype.type(0)
    w = Walk(node=[N], up=[-1], dn=[-1], lenup=[zero], lendn=[zero], cs=[],
             nc=[], starts=[0, 1])
    a, b = 0, 1
    while a < b:
        for base in range(a, b, threads):
            for p in range(base, min(b, base + threads)):
                u, up = w.node[p], w.up[p]
                if up >= 0:
                    w.lenup[p] = length[up]
                kids = [int(k) for k in adj[u] if 0 <= k < E and k != up]
                w.cs.append(len(w.node))
                w.nc.append(len(kids))
                for k in kids:
                    w.node.append(int(e[k]))
                    w.up.append(int(rev[k]))
                    w.dn.append(k)
                    w.lenup.append(zero)
                    w.lendn.append(length[k])
        if len(w.node) > M:
            raise ValueError(f"the walk found {len(w.node)} nodes, more "
                             f"than the {M} node slots")
        a, b = b, len(w.node)
        w.starts.append(b)
    w.starts.pop()  # the last level is empty
    return w


def sweeps(w: Walk, row, N: int) -> tuple[list, list]:
    """(limup, limdn) by position: the up-sweep, then the down-sweep."""
    zero = type(w.lendn[0])(0)
    ninf = type(zero)(-np.inf)
    limup = [zero] * len(w.node)
    limdn = [zero] * len(w.node)
    for l in range(w.maxdep, 0, -1):
        for p in w.level(l):
            u = w.node[p]
            base = row[u] if u < N else zero
            cm = ninf
            for q in range(w.cs[p], w.cs[p] + w.nc[p]):
                cm = amax(cm, limup[q] - w.lenup[q])
            limup[p] = amax(base, cm)
    for l in range(w.maxdep):
        for p in w.level(l):
            kids = range(w.cs[p], w.cs[p] + w.nc[p])
            if not kids:
                continue
            v = ([limdn[p] - w.lenup[p]] if p > 0 else []) + [
                limup[q] - w.lendn[q] for q in kids]
            max1 = ninf
            for x in v:
                max1 = amax(max1, x)
            is_max = [x == max1 for x in v]
            max2 = ninf
            for x, m in zip(v, is_max):
                if not m:
                    max2 = amax(max2, x)
            first = 1 if p > 0 else 0
            for j, q in enumerate(kids):
                excl = ((max1 if sum(is_max) > 1 else max2)
                        if is_max[first + j] else max1)
                limdn[q] = clamp0(excl)
    return limup, limdn


def lims_by_slot(w: Walk, limup, limdn, n_used: int, dtype) -> np.ndarray:
    """The sweeps' values as the plain version's lim over the used slots."""
    lim = np.zeros(n_used, dtype)
    for p in range(1, len(w.node)):
        lim[w.up[p]] = limup[p]
        lim[w.dn[p]] = limdn[p]
    return lim


def _before(a, b) -> bool:
    """(score, slot) a before b in the order of torch.argmin."""
    a_nan, b_nan = a[0] != a[0], b[0] != b[0]
    if a_nan != b_nan:
        return a_nan
    if a_nan or a[0] == b[0]:
        return a[1] < b[1]
    return a[0] < b[0]


def score(w: Walk, limup, limdn, threads: int = THREADS):
    """The first minimum over the used slots: (eid, frac, add, position).
    Each thread keeps the best of its positions (p = t + 1, t + 1 +
    threads, ...), then the block's minimum is taken over the threads'."""
    P = len(w.node)
    dtype = np.asarray(w.lendn[0]).dtype
    if P < 2:
        raise ValueError("a tree of one node has no edge to score")
    addi, frac = clamp_sequence(
        torch.from_numpy(np.array(limdn[1:], dtype)),
        torch.from_numpy(np.array(limup[1:], dtype)),
        torch.from_numpy(np.array(w.lendn[1:], dtype)))
    addi, frac = addi.numpy(), frac.numpy()
    sent, zero = dtype.type(SENT_DIS), dtype.type(0)
    best = None
    for t in range(threads):
        mine = None
        for p in range(1 + t, P, threads):
            for c in ((addi[p - 1], w.dn[p], frac[p - 1], p),
                      (sent, w.up[p], zero, p)):
                if mine is None or _before(c, mine):
                    mine = c
        if mine is not None and (best is None or _before(mine, best)):
            best = mine
    sc, eid, fr, pos = best
    return eid, fr, sc, pos


def splice(s: dict, w: Walk, eid: int, frac, add, pos: int, i0: int,
           place_id: int, N: int) -> dict:
    """The plain version's splice of taxon place_id through middle node
    N + place_id - 1 onto edge eid at slots i0 .. i0 + 3, the depth shift
    of ch's subtree by the list's ranges, and the adjacency rows of the
    two new nodes, in place. Returns the subtree's levels and nodes, pa,
    ch and ch's depth before the shift."""
    e, belong, length, rev = s["e"], s["belong"], s["length"], s["rev"]
    parent, dep, adj = s["parent"], s["dep"], s["adj"]
    middle, outside = place_id + N - 1, place_id
    x, y, ye = int(belong[eid]), int(e[eid]), int(rev[eid])
    orig = length[eid]
    dx, dy = dep[x], dep[y]
    pa, ch, dpa = (x, y, dx) if dx < dy else (y, x, dy)
    if w.node[pos] != ch:
        raise ValueError(f"position {pos} holds node {w.node[pos]}, not the "
                         f"chosen edge's deeper end {ch}")
    rest = orig - frac
    i1, i2, i3 = i0 + 1, i0 + 2, i0 + 3
    for slot, to, r, ln in ((eid, middle, i0, frac), (ye, middle, i1, rest),
                            (i0, x, eid, frac), (i1, y, ye, rest),
                            (i2, middle, i3, add), (i3, outside, i2, add)):
        e[slot], rev[slot], length[slot] = to, r, ln
    belong[i0:i0 + 4] = (middle, middle, outside, middle)
    a, b, levels, nodes = pos, pos + 1, 0, 0
    while a < b:
        for q in range(a, b):
            dep[w.node[q]] += 1
        nodes += b - a
        a, b = w.cs[a], w.cs[b - 1] + w.nc[b - 1]
        levels += 1
    dep[middle], dep[outside] = dpa + 1, dpa + 2
    parent[ch], parent[middle], parent[outside] = middle, pa, middle
    adj[middle] = (i0, i1, i3)
    adj[outside] = (i2, -1, -1)
    return {"subtree_levels": levels, "subtree_nodes": nodes, "pa": pa,
            "ch": ch,
            "ch_depth": int(dpa) + 1}


def exact_step(s: dict, row, i: int, i0: int, N: int,
               threads: int = THREADS) -> dict:
    """Insertion i with its distance row at slots i0 .. i0 + 3, in place,
    as exact_step.cu makes it; returns what the launch's `out` records
    (eid, maxdep, positions, subtree levels and nodes), the choice's
    position, its
    ends (pa, ch) and ch's depth, and the lims by slot before the
    splice."""
    w = walk(s, N, threads)
    row = np.asarray(row, dtype=s["length"].dtype)
    limup, limdn = sweeps(w, row, N)
    lim = lims_by_slot(w, limup, limdn, i0, s["length"].dtype)
    eid, frac, add, pos = score(w, limup, limdn, threads)
    out = splice(s, w, eid, frac, add, pos, i0, i, N)
    return {"eid": eid, "maxdep": w.maxdep, "positions": len(w.node),
            "pos": pos, "lim": lim, **out}


def exact_step_cursor(s: dict, cursor: list, N: int) -> dict:
    """exact_step for the insertion the cursor [i, slots in use, rows, lo]
    holds (rows: the range's rows, row j of insertion lo + j); the cursor
    advances by one insertion."""
    i, used, rows, lo = cursor
    out = exact_step(s, np.asarray(rows[i - lo]), i, used, N)
    cursor[0], cursor[1] = i + 1, used + 4
    return out
