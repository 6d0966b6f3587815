"""A numpy model of csrc/exact_step.cu's plan: one insertion of exact
placement (the level order, both sweeps, the score, the splice and the
depth shift) as a cluster of blocks of threads computes it. Used by the
tests and by chip_smoke.py, never by a build: a machine without a GPU
holds the kernel's way of computing to the plain version (placement/
exact.py: `_compute_lims`, `_score_exact`, `_splice_exact`) and to the JAX
package.

The kernel departs from the plain version where the model does:
- node records (`node_records`): each node's adjacency row's slots, each
  with its neighbour e[r], its reverse slot rev[r] and its length, derived
  from the state as `adj` is; the kernel's cursor write rebuilds them and
  its splice keeps them (x's and y's entries of the split edge, middle's and
  outside's records);
- the tree is walked top-down from the root N over the records, level by
  level, into a list of positions: position p holds a node, its upward edge
  (node -> parent) and downward edge (parent -> node) with the downward
  length (written by its parent's entry), and its position record (node,
  child count, children's first position, upward length: written by its
  own entry, which finds its upward length in its node's record). A level's
  children are placed in the flat (entry, record slot) order. A level of
  at most `wide` entries (or any level when ctas is 1) is one block's, in
  chunks of `threads` entries with a prefix sum a chunk; a wider one is
  taken in rounds of at most ctas x threads entries, each block a
  contiguous range: a block's prefix sum, then the counts of the blocks
  before it. The list does not depend on the split. The greatest depth is
  the number of levels less one; `dep` is not read by the sweeps: the
  level is the walk's. A leaf's limup (its row value) is written by the
  walk. (The kernel keeps a level's first entries in block 0's shared
  memory when block 0 alone wrote them: a change of place, not of
  values);
- lim lives by position (limup: the upward edge's, limdn: the downward
  edge's), not by slot;
- the up-sweep (levels maxdep .. 0) takes, for each node with children,
  the maximum of 0 and its children's v = limup - lenup, and keeps their
  w = limup - lendn; every position passes its own v and w to its parent
  (the kernel through block 0's shared memory for a level that block 0
  computed alone, else through the scratch). The down-sweep (levels 0 ..
  maxdep - 1) takes each node's at most three incident edges in record
  order (its own limdn less its upward length first, then its children's
  w), and applies the plain version's top-2 rule (the first maximum, how
  many edges reach it, the maximum of the others) to each child: a NaN
  among them makes every child's value NaN. A sweep level wider than
  `wide` is split over the blocks in contiguous ranges; narrower ones are
  block 0's (the kernel loads each thread's inputs for the next level
  ahead of it: a change of timing, not of values);
- the score, after the sweeps, over every thread of the cluster: every
  used slot is one position's upward or downward edge, so the candidates
  are two a position: the downward edge's score, and the upward edge's
  (SENT_DIS, frac 0). Each thread keeps the first of its candidates in
  the order of torch.argmin (NaN first, then the lower score, the lower
  slot), each block the first of its threads', block 0 the first of the
  blocks';
- the depth shift of ch's subtree walks down the list: the positions of a
  subtree's next level are the range from its first position's children
  to its last position's last child.

The kernel's other choices change where and when values are computed, not
the values: warp 0 alone walks runs of levels of at most 32 entries, and a
launch runs on block 0 alone where the last launch's walk found fewer than
CLUSTER_LEVELS levels wider than `wide` (`exact_step`'s `prev_wide`, which
the model takes as the kernel does: it then runs at ctas = 1; the list,
the lims and the choice do not depend on ctas, threads or wide, which the
tests check).

A state is a dict of numpy arrays named as ExactState's fields and its
adjacency table (e, belong, length, rev, parent, dep, adj), and optionally
its node records ("rec", kept by the splice), updated in place;
`arrays_of` gives such a dict of views of a CPU ExactState's tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dipper_tpu_torch.placement.exact_cuda import (CLUSTER_CTAS,
                                                   CLUSTER_LEVELS, THREADS,
                                                   WIDE)
from dipper_tpu_torch.placement.kclosest import SENT_DIS, clamp_sequence

FIELDS = ("e", "belong", "length", "rev", "parent", "dep", "adj")
REC = ("slot", "nb", "rv", "len")


def arrays_of(st) -> dict:
    """Numpy views of a CPU ExactState's arrays (writes go to the state)."""
    return {f: getattr(st, f).numpy() for f in FIELDS}


def node_records(s: dict) -> dict:
    """The node records of state `s`, rebuilt from it: [M, 3] arrays slot
    (adj's, -1 where empty or out of range), nb (e of the slot), rv (rev of
    the slot), len (its length), each -1 (0 for len) where there is no
    slot."""
    adj, E = s["adj"], s["e"].shape[0]
    ok = (adj >= 0) & (adj < E)
    k = np.where(ok, adj, 0)
    return {"slot": np.where(ok, adj, -1).astype(np.int32),
            "nb": np.where(ok, s["e"][k], -1).astype(np.int32),
            "rv": np.where(ok, s["rev"][k], -1).astype(np.int32),
            "len": np.where(ok, s["length"][k],
                            s["length"].dtype.type(0))}


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
    """The level order of one insertion (the kernel's scratch lists): by
    position, the parent entry's writes (node, up, dn, lendn), the position
    record (nc, cs, lenup) and the leaves' limup."""
    node: list
    up: list
    dn: list
    lendn: list
    lenup: list
    cs: list
    nc: list
    limup: dict   # the leaves' (their row values), when a row was given
    starts: list  # level l's positions: starts[l] .. starts[l + 1] - 1

    @property
    def maxdep(self) -> int:
        return len(self.starts) - 2

    def level(self, l: int) -> range:
        return range(self.starts[l], self.starts[l + 1])


def _ranges(a: int, b: int, ctas: int, threads: int, wide: int) -> list:
    """How the kernel's walk splits level [a, b): a list of steps, each a
    list of (block, [positions]) taken together. One block's level is one
    step a chunk of `threads`; a wide level is one step a round of at most
    ctas x threads entries, a contiguous range a block."""
    if ctas == 1 or b - a <= wide:
        return [[(0, list(range(base, min(b, base + threads))))]
                for base in range(a, b, threads)]
    steps = []
    for r0 in range(a, b, ctas * threads):
        r = min(b - r0, ctas * threads)
        per = -(-r // ctas)
        steps.append([(k, list(range(r0 + k * per,
                                     min(r0 + r, r0 + (k + 1) * per))))
                      for k in range(ctas)])
    return steps


def walk(s: dict, N: int, threads: int = THREADS, row=None,
         ctas: int = CLUSTER_CTAS, wide: int = WIDE) -> Walk:
    """The level order of the state's tree from the root N over its node
    records (s["rec"], or rebuilt). An entry's children (its record's
    slots but its upward edge, in slot order) are placed after those of the
    entries before it, by the kernel's split of the level (`_ranges`)."""
    rec = s.get("rec") or node_records(s)
    E, M = s["e"].shape[0], s["adj"].shape[0]
    zero = s["length"].dtype.type(0)
    w = Walk(node=[N], up=[-1], dn=[-1], lendn=[zero], lenup=[], cs=[],
             nc=[], limup={}, starts=[0, 1])

    def read(p):
        u, up = w.node[p], w.up[p]
        kids, lenup = [], zero
        if 0 <= u < M:
            for j in range(3):
                r = int(rec["slot"][u, j])
                if not 0 <= r < E:
                    continue
                if r == up:
                    lenup = rec["len"][u, j]
                else:
                    kids.append(j)
        return u, kids, lenup

    def write(p, u, kids, lenup, at):
        w.lenup.append(lenup)
        w.cs.append(at)
        w.nc.append(len(kids))
        if not kids and row is not None:
            w.limup[p] = row[u] if 0 <= u < N else zero
        for q, j in enumerate(kids, at):
            assert q == len(w.node)
            w.node.append(int(rec["nb"][u, j]))
            w.up.append(int(rec["rv"][u, j]))
            w.dn.append(int(rec["slot"][u, j]))
            w.lendn.append(rec["len"][u, j])

    a, b = 0, 1
    while a < b:
        nxt = b
        for step in _ranges(a, b, ctas, threads, wide):
            entries = [[(p, *read(p)) for p in ps] for _, ps in step]
            counts = [sum(len(x[2]) for x in es) for es in entries]
            for k, es in enumerate(entries):
                at = nxt + sum(counts[:k])   # the blocks before this one
                for p, u, kids, lenup in es:
                    write(p, u, kids, lenup, at)
                    at += len(kids)
            nxt += sum(counts)
        if nxt > M:
            raise ValueError(f"the walk found {nxt} nodes, more than the "
                             f"{M} node slots")
        a, b = b, nxt
        w.starts.append(b)
    w.starts.pop()  # the last level is empty
    return w


def _before(a, b) -> bool:
    """(score, slot) a before b in the order of torch.argmin."""
    a_nan, b_nan = a[0] != a[0], b[0] != b[0]
    if a_nan != b_nan:
        return a_nan
    if a_nan or a[0] == b[0]:
        return a[1] < b[1]
    return a[0] < b[0]


def _first(cands):
    best = None
    for c in cands:
        if c is not None and (best is None or _before(c, best)):
            best = c
    return best


def sweeps(w: Walk, row, N: int, threads: int = THREADS,
           ctas: int = CLUSTER_CTAS, wide: int = WIDE):
    """(limup, limdn, choice) by position: the up-sweep (each position's v
    = limup - lenup and w = limup - lendn, passed to its parent, which
    keeps its children's w), the down-sweep (from the children's w), then
    the score; the choice is the first minimum (score, eid, frac,
    position) as the kernel's threads, blocks and cluster take it."""
    dtype = np.asarray(w.lendn[0]).dtype
    zero, ninf = dtype.type(0), dtype.type(-np.inf)
    sent = dtype.type(SENT_DIS)
    P = len(w.node)
    if P < 2:
        raise ValueError("a tree of one node has no edge to score")
    limup = [zero] * P
    limdn = [zero] * P
    vup, wdn = [zero] * P, [zero] * P
    kw = {}   # each position's children's w
    for p, v in w.limup.items():
        limup[p] = v
    for l in range(w.maxdep, -1, -1):
        for p in w.level(l):
            ks = range(w.cs[p], w.cs[p] + w.nc[p])
            if ks:
                u = w.node[p]
                base = row[u] if u < N else zero
                cm = ninf
                for q in ks:
                    cm = amax(cm, vup[q])
                limup[p] = amax(base, cm)
                kw[p] = [wdn[q] for q in ks]
            vup[p] = limup[p] - w.lenup[p]
            wdn[p] = limup[p] - w.lendn[p]
    for l in range(w.maxdep):
        for p in w.level(l):
            ks = list(range(w.cs[p], w.cs[p] + w.nc[p]))
            if not ks:
                continue
            v = ([limdn[p] - w.lenup[p]] if p > 0 else []) + kw[p]
            max1 = ninf
            for x in v:
                max1 = amax(max1, x)
            is_max = [x == max1 for x in v]
            max2 = ninf
            for x, m in zip(v, is_max):
                if not m:
                    max2 = amax(max2, x)
            first = 1 if p > 0 else 0
            for j, q in enumerate(ks):
                excl = ((max1 if sum(is_max) > 1 else max2)
                        if is_max[first + j] else max1)
                limdn[q] = clamp0(excl)
    # the score: position p's two candidates are thread (p - 1) % (ctas x
    # threads)'s, of block (p - 1) % (ctas x threads) // threads
    addi, frac = clamp_sequence(
        *(torch.from_numpy(np.array(x[1:], dtype))
          for x in (limdn, limup, w.lendn)))
    addi, frac = addi.numpy(), frac.numpy()
    best = {}
    for p in range(1, P):
        t = (p - 1) % (ctas * threads)
        for c in ((addi[p - 1], w.dn[p], frac[p - 1], p),
                  (sent, w.up[p], zero, p)):
            if t not in best or _before(c, best[t]):
                best[t] = c
    blocks = {}
    for t, c in sorted(best.items()):
        blocks.setdefault(t // threads, []).append(c)
    sc, eid, fr, pos = _first(_first(cs) for _, cs in sorted(blocks.items()))
    return limup, limdn, (sc, eid, fr, pos)


def lims_by_slot(w: Walk, limup, limdn, n_used: int, dtype) -> np.ndarray:
    """The sweeps' values as the plain version's lim over the used slots."""
    lim = np.zeros(n_used, dtype)
    for p in range(1, len(w.node)):
        lim[w.up[p]] = limup[p]
        lim[w.dn[p]] = limdn[p]
    return lim


def splice(s: dict, w: Walk, eid: int, frac, add, pos: int, i0: int,
           place_id: int, N: int) -> dict:
    """The plain version's splice of taxon place_id through middle node
    N + place_id - 1 onto edge eid at slots i0 .. i0 + 3, the depth shift
    of ch's subtree by the list's ranges, the adjacency rows of the two new
    nodes, and (where the state has them) the records of x, y, middle and
    outside, in place. Returns the subtree's levels and nodes, pa, ch and
    ch's depth before the shift."""
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
    rec = s.get("rec")
    if rec is not None:
        for node, slot, r, ln in ((x, eid, i0, frac), (y, ye, i1, rest)):
            for j in range(3):
                if rec["slot"][node, j] == slot:
                    rec["nb"][node, j], rec["rv"][node, j] = middle, r
                    rec["len"][node, j] = ln
        for node, entries in (
                (middle, ((i0, x, eid, frac), (i1, y, ye, rest),
                          (i3, outside, i2, add))),
                (outside, ((i2, middle, i3, add), (-1, -1, -1, 0),
                           (-1, -1, -1, 0)))):
            for j, vals in enumerate(entries):
                for f, v in zip(REC, vals):
                    rec[f][node, j] = v
    return {"subtree_levels": levels, "subtree_nodes": nodes, "pa": pa,
            "ch": ch,
            "ch_depth": int(dpa) + 1}


def exact_step(s: dict, row, i: int, i0: int, N: int,
               threads: int = THREADS, ctas: int = CLUSTER_CTAS,
               wide: int = WIDE, prev_wide: int | None = None) -> dict:
    """Insertion i with its distance row at slots i0 .. i0 + 3, in place,
    as exact_step.cu makes it with a cluster of `ctas` blocks of `threads`
    that splits levels wider than `wide`; given `prev_wide` (the last
    launch's `wide_levels`, -1 before the first), on block 0 alone where it
    is below CLUSTER_LEVELS, as the kernel; None runs at `ctas` whatever
    the tree. Returns what the launch's `out` records (eid, maxdep,
    positions, subtree levels and nodes, wide_levels: the levels wider
    than `wide`), the blocks the launch ran on (`ctas_run`), the choice's
    position, its ends (pa, ch) and ch's depth, and the lims by slot
    before the splice."""
    if prev_wide is not None and prev_wide < CLUSTER_LEVELS:
        ctas = 1
    row = np.asarray(row, dtype=s["length"].dtype)
    w = walk(s, N, threads, row, ctas, wide)
    limup, limdn, (add, eid, frac, pos) = sweeps(w, row, N, threads, ctas,
                                                 wide)
    lim = lims_by_slot(w, limup, limdn, i0, s["length"].dtype)
    nwide = sum(len(w.level(l)) > wide for l in range(w.maxdep + 1))
    out = splice(s, w, eid, frac, add, pos, i0, i, N)
    return {"eid": eid, "maxdep": w.maxdep, "positions": len(w.node),
            "wide_levels": nwide, "ctas_run": ctas, "pos": pos, "lim": lim,
            **out}


def exact_step_cursor(s: dict, cursor: list, N: int,
                      prev_wide: int = -1) -> dict:
    """exact_step for the insertion the cursor [i, slots in use, rows, lo,
    records] holds (rows: the range's rows, row j of insertion lo + j; the
    records as the cursor's write rebuilt them, kept by the splices), after
    a launch that found `prev_wide` wide levels (-1: none before it); the
    cursor advances by one insertion."""
    i, used, rows, lo, rec = cursor
    out = exact_step({**s, "rec": rec}, np.asarray(rows[i - lo]), i, used, N,
                     prev_wide=prev_wide)
    cursor[0], cursor[1] = i + 1, used + 4
    return out
