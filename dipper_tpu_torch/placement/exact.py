"""Exact incremental placement (placemode 0) on PyTorch tensors.

Behavioral spec (src/placement.cu), as in the JAX reference
dipper_tpu/placement/exact.py: like k-closest placement, but the
per-edge bounds are exact: for every directed edge (s->t),

    lim[s->t] = max over leaves x on the s-side of the edge of
                ( d(new, x) - dist_tree(s, x) ),   floored at 0

computed per insertion by a bottom-up pass over BFS levels
(updateFromBottomToTop :297-328) and a top-down pass
(updateFromTopToBottom :330-363); scoring then uses dis1 = lim[edge],
dis2 = lim[rev edge] on parent->child edges with the same clamp
sequence and (addi, eid) argmin as k-closest (calculateBranchLength
:156-198); splice as in placement.cu:200-253.

The state carries only `parent[node]` and `dep[node]` beside the edge
arrays. Each insertion runs
- an UP-SWEEP over levels deepest->1: nodes of the level compute
  mx = max(0, d_new[leaf], scatter-max of children's lim - len) and
  write it to their parent edge;
- a DOWN-SWEEP over levels 0->deepest-1: for each downward edge (u->c),
  the max over u's OTHER incident edges of lim[rev] - len, computed
  with per-node top-2 scatter statistics (exclusive max without
  adjacency lists);
- splice + parent/dep maintenance (the child-side subtree's depths
  shift by one, marked by parent-pointer propagation).

PyTorch design. On the card a state inserts a range through csrc/exact_step.cu (placement/exact_cuda.py): one launch an
insertion does the level order, both sweeps, the score, the splice and the
depth shift, reading the insertion, the slots in use and its row from a
cursor on the card; the range is one cursor write, replays of a captured
CUDA graph of exact_cuda.GRAPH_INSERTIONS launches and the remainder by
direct launches, with no host sync (`_replay_exact`). The tensor code
below is the plain version: the CPU path, and on the card the yardstick,
which runs there only when a caller asks for it (`plain=True`). Its
sweeps are a fixed set of masked vector operations over the used edge
slots a level; an insertion syncs the host three times: for the tree's
greatest depth, which fixes the number of levels of both sweeps and
bounds the marking's propagation; for the chosen edge with its endpoints
and their depths; and for the upload of the splice's slots and values (a
write `t[i] = number` would cost a copy and a sync each). The float
operations and their order are the reference's, so states are bitwise
equal to its on the same rows; the kernel's are the plain version's.

The adjacency table `adj` [M, 3] (each node's out-edges, in slot order) is
derived data beside the reference's fields: it is not in FIELDS, so
checkpoints keep the reference's schema, and a state read from numpy
rebuilds it from `belong`. The kernel's node records (each out-edge's
neighbour, reverse slot and length beside its slot) are derived from `adj`
in turn: they live in the state's stepper, are rebuilt by each range's
cursor write and kept by the kernel's splices.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from dipper_tpu_torch.placement import exact_cuda, insert_cuda
from dipper_tpu_torch.placement.kclosest import (
    ROW_BLOCK, SENT_DIS, _ROWS_BYTES, _i32, _rows, _slice_frontend,
    adjacency_from_edges, load_tree_state, nan_minimum, save_tree_state)
from dipper_tpu_torch.utils.device import synchronize, torch_dtype

# depth of a node that is not in the tree; part of the checkpoint, as is
# the pad index M = 2N that `parent` holds for "no parent"
BIG_DEP = 1 << 30


@dataclasses.dataclass
class ExactState:
    # checkpoint arrays, in the reference ExactState's field order
    FIELDS = ("e", "belong", "length", "rev", "parent", "dep", "idx")

    e: torch.Tensor        # [E] int32 dst node (-1 unused)
    belong: torch.Tensor   # [E] int32 src node (-1 unused)
    length: torch.Tensor   # [E] f
    rev: torch.Tensor      # [E] int32 reverse edge id
    parent: torch.Tensor   # [M] int32 (M = pad index for none)
    dep: torch.Tensor      # [M] int32 (BIG_DEP = not in tree)
    idx: int               # next free edge slot (host-side counter)
    # [M, 3] int32 out-edges of each node in slot order, -1 empty (derived
    # from belong; a splice rewrites only the two new nodes' rows)
    adj: torch.Tensor
    # the kernel's checked pointers, scratch, cursor and graph
    # (exact_cuda._Stepper, made by exact_cuda.prepare_stepper)
    stepper: "exact_cuda._Stepper | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @classmethod
    def from_numpy(cls, d, device) -> "ExactState":
        """The reference's ExactState as numpy arrays (jax.device_get of
        it, or a checkpoint .npz of either package) -> ExactState on
        `device`, with its adjacency table rebuilt from `belong`."""
        def t(a, dtype=None):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

        belong = t(d["belong"], np.int32)
        return exact_cuda.prepare_stepper(cls(
            e=t(d["e"], np.int32), belong=belong, length=t(d["length"]),
            rev=t(d["rev"], np.int32), parent=t(d["parent"], np.int32),
            dep=t(d["dep"], np.int32), idx=int(d["idx"]),
            adj=adjacency_from_edges(belong, belong.shape[0] // 2)))


def _init_state(N: int, dtype: torch.dtype, device) -> ExactState:
    E = 4 * N
    M = 2 * N
    i32 = dict(dtype=torch.int32, device=device)
    return ExactState(
        e=torch.full((E,), -1, **i32),
        belong=torch.full((E,), -1, **i32),
        length=torch.zeros((E,), dtype=dtype, device=device),
        rev=torch.full((E,), -1, **i32),
        parent=torch.full((M,), M, **i32),
        dep=torch.full((M,), BIG_DEP, **i32),
        idx=0,
        adj=torch.full((M, 3), -1, **i32),
    )


def _build_initial(st: ExactState, d01: torch.Tensor, N: int) -> None:
    """Edges 0..3 joining taxa 0 and 1 through the root N, in place."""
    dev = st.e.device
    st.e[:4] = _i32([N, N, 0, 1], dev)
    st.belong[:4] = _i32([0, 1, N, N], dev)
    st.length[:4] = d01 / 2
    st.rev[:4] = _i32([2, 3, 0, 1], dev)
    st.parent[:2] = N
    st.dep[N] = 0
    st.dep[:2] = 1
    st.adj[0] = _i32([0, -1, -1], dev)
    st.adj[1] = _i32([1, -1, -1], dev)
    st.adj[N] = _i32([2, 3, -1], dev)
    st.idx = 4


def _scatter_amax(index: torch.Tensor, src: torch.Tensor, M: int):
    """[M] per-node maxima of `src` scattered to `index` (slot M takes
    what is masked out), -inf where nothing lands; a NaN wins, as in the
    reference's `.at[].max`."""
    out = torch.full((M + 1,), float("-inf"), dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce_(0, index, src, "amax", include_self=True)[:M]


def _compute_lims(st: ExactState, dist_row: torch.Tensor, N: int,
                  maxdep: int | None = None) -> torch.Tensor:
    """lim of the state's used edge slots [st.idx] for the current tree
    and distance row (the unused slots' lim is 0). `maxdep` is the tree's
    greatest depth where the caller has read it; without it it is read
    here (a host sync)."""
    M = 2 * N
    u = st.idx
    belong, e, length = st.belong[:u], st.e[:u], st.length[:u]
    rev = st.rev[:u].long()
    in_edge = belong >= 0
    src = torch.where(in_edge, belong, 0).long()
    dst = torch.where(in_edge, e, 0).long()
    dep_src = st.dep[src]
    dep_dst = st.dep[dst]
    # depth of an edge's source node, by the edge's direction (-1: not
    # such an edge), so that a level's mask is one comparison
    src_dep = torch.where(in_edge, dep_src, -1)
    up_dep = torch.where(dep_src > dep_dst, src_dep, -1)     # child->parent
    down_dep = torch.where(dep_src < dep_dst, src_dep, -1)
    if maxdep is None:
        maxdep = _max_depth(st)
    neg_inf = float("-inf")

    lim = torch.zeros_like(length)

    # ---- up-sweep: levels maxdep .. 1 (upward edges out of level-l nodes)
    # reference: mx = 0, overwritten by dist[u] for leaves (:317-318)
    leaf_base = torch.zeros((M,), dtype=length.dtype, device=length.device)
    leaf_base[:N] = torch.where(st.dep[:N] < BIG_DEP, dist_row[:N], 0.0)
    assign = up_dep == maxdep + 1                            # none
    for level in range(maxdep, 0, -1):
        # children contributions into their parent nodes: upward edges
        # whose source is at depth `level+1` (the last level's `assign`)
        contrib_mask = assign
        vals = torch.where(contrib_mask, lim - length, neg_inf)
        tgt = torch.where(contrib_mask, dst, M)
        mx = torch.maximum(leaf_base, _scatter_amax(tgt, vals, M))
        # assign to upward edges out of level-l nodes
        assign = up_dep == level
        lim = torch.where(assign, mx[src], lim)

    # ---- down-sweep: levels 0 .. maxdep-1 (no downward edge leaves the
    # deepest level)
    for level in range(maxdep):
        # candidate value of every incident edge j of node u at this level:
        # lim[rev j] - len j (parent edge's rev is downward, already
        # assigned at level-1; child edges' rev are upward)
        atlvl = src_dep == level
        v = torch.where(atlvl, lim[rev] - length, neg_inf)
        tgt = torch.where(atlvl, src, M)
        max1 = _scatter_amax(tgt, v, M)[src]
        is_max = atlvl & (v == max1)
        cnt = torch.zeros((M + 1,), dtype=torch.int32, device=v.device)
        cnt.scatter_add_(0, tgt, is_max.to(torch.int32))
        v2 = torch.where(is_max, neg_inf, v)
        max2 = _scatter_amax(torch.where(atlvl & ~is_max, src, M), v2, M)
        excl = torch.where(
            is_max, torch.where(cnt[src] > 1, max1, max2[src]), max1)
        mx = excl.clamp(min=0.0)  # reference mx starts at 0
        lim = torch.where(down_dep == level, mx, lim)
    return lim


def _max_depth(st: ExactState) -> int:
    """Greatest depth of a node in the tree (host sync)."""
    return int(torch.where(st.dep < BIG_DEP, st.dep, 0).max())


def _score_exact(st: ExactState, lim: torch.Tensor):
    """Clamp sequence and first-minimum argmin over parent->child edges
    with dis1 = lim[edge], dis2 = lim[rev edge]. Returns (eid, frac, add)
    as 0-d tensors (no host sync)."""
    u = st.idx
    belong, e, L = st.belong[:u], st.e[:u], st.length[:u]
    in_edge = belong >= 0
    src = torch.where(in_edge, belong, 0).long()
    dst = torch.where(in_edge, e, 0).long()
    valid = in_edge & (st.dep[src] < st.dep[dst])
    dis1 = lim
    dis2 = lim[st.rev[:u].long()]
    addi = ((dis1 + dis2 - L) * 0.5).clamp(min=0.0)
    dis1 = (dis1 - addi).clamp(min=0.0)
    dis2 = (dis2 - addi).clamp(min=0.0)
    addi = addi + (dis1 - L).clamp(min=0.0) + (dis2 - L).clamp(min=0.0)
    dis1 = nan_minimum(dis1, L)
    dis2 = nan_minimum(dis2, L)
    rest = L - dis1 - dis2
    dis1 = dis1 + rest * 0.5
    score = torch.where(valid, addi, SENT_DIS)
    frac = torch.where(valid, dis1, 0.0)
    # first minimum == lowest eid; a [1] index gathers on the device (a
    # 0-d tensor index would be read back to the host)
    eid = torch.argmin(score).reshape(1)
    return eid[0], frac[eid][0], score[eid][0]


def _splice_exact(st: ExactState, eid, frac, add, place_id: int, N: int,
                  maxdep: int | None = None) -> None:
    """Taxon place_id attaches through middle node N+place_id-1 onto edge
    `eid` (0-d tensor or int), in place, with the parent/dep maintenance.
    `maxdep`: the tree's greatest depth before the splice, as for
    _compute_lims. One read of six ints from the device and one upload of
    the slots and values to write; every write is then an indexed put on
    the device."""
    M = 2 * N
    dev = st.e.device
    middle = place_id + N - 1
    outside = place_id
    if maxdep is None:
        maxdep = _max_depth(st)
    eid_t = torch.as_tensor(eid, device=dev).reshape(1)
    x_t, y_t = st.belong[eid_t].long(), st.e[eid_t].long()
    xe, x, y, ye, dx, dy = torch.cat(
        (eid_t.long(), x_t, y_t, st.rev[eid_t].long(), st.dep[x_t].long(),
         st.dep[y_t].long())).tolist()  # host sync
    i0 = st.idx
    i1, i2, i3 = i0 + 1, i0 + 2, i0 + 3
    # parent/dep maintenance: pa = shallower endpoint, ch = deeper
    pa, ch, dpa = (x, y, dx) if dx < dy else (y, x, dy)
    (slots, e_new, rev_new, belong_new, nodes, parent_new, dep_new,
     adj_at, adj_new) = torch.tensor([
        [xe, ye, i0, i1, i2, i3],
        [middle, middle, x, y, middle, outside],
        [i0, i1, xe, ye, i3, i2],
        [-1, -1, middle, middle, outside, middle],    # belong: new slots only
        [ch, middle, outside, -1, -1, -1],
        [middle, pa, middle, -1, -1, -1],
        [-1, dpa + 1, dpa + 2, -1, -1, -1],           # dep: new nodes only
        [3 * middle, 3 * middle + 1, 3 * middle + 2, 3 * outside,
         3 * outside + 1, 3 * outside + 2],           # the new nodes' rows
        [i0, i1, i3, i2, -1, -1],
    ]).to(dev)

    frac = torch.as_tensor(frac, dtype=st.length.dtype, device=dev)
    add = torch.as_tensor(add, dtype=st.length.dtype, device=dev)
    rest = st.length[slots[:1]][0] - frac
    st.e[slots] = e_new.int()
    st.rev[slots] = rev_new.int()
    st.belong[slots[2:]] = belong_new[2:].int()
    st.length[slots] = torch.stack([frac, rest, frac, rest, add, add])

    # subtree(ch) marking by parent-pointer propagation (old pointers).
    # The marks are a fixed point that one more level of the subtree
    # reaches per pass, and the subtree is at most maxdep - dep[ch]
    # levels high: that many passes give the reference's marks.
    mark = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
    mark.index_fill_(0, nodes[:1], True)
    par = st.parent.long()          # M (the pad slot, never marked) = none
    for _ in range(maxdep - (dpa + 1)):
        mark[:M] |= mark[par]
    st.dep += mark[:M]
    st.dep[nodes[1:3]] = dep_new[1:3].int()
    st.parent[nodes[:3]] = parent_new[:3].int()
    # x and y keep their edge ids (xe/ye now point at middle)
    st.adj.view(-1)[adj_at] = adj_new.int()
    st.idx += 4


def exact_insertion_step(st: ExactState, row: torch.Tensor, i: int,
                         N: int) -> None:
    """Place taxon i given its distance row to the bank (in place)."""
    maxdep = _max_depth(st)
    lim = _compute_lims(st, row, N, maxdep)
    eid, frac, add = _score_exact(st, lim)
    _splice_exact(st, eid, frac, add, i, N, maxdep)


def init_exact_state(frontend_args, *, num_sequences: int, frontend: str,
                     frontend_static=(), dtype_name: str) -> ExactState:
    """Tree of taxa 0 and 1 on the device of the frontend's bank."""
    N = num_sequences
    fa2 = _slice_frontend(frontend_args, frontend, 2)
    d01 = _rows(fa2, frontend, frontend_static, dtype_name, 1, 2)[0, 0]
    st = _init_state(N, torch_dtype(dtype_name), frontend_args[0].device)
    _build_initial(st, d01.to(st.length.dtype), N)
    return exact_cuda.prepare_stepper(st)


def uses_exact_kernel(st: ExactState) -> bool:
    """Whether a range of this state runs on csrc/exact_step.cu: a state
    on the card."""
    return st.e.device.type == "cuda"


def run_exact_range(st: ExactState, lo: int, hi: int, rows: torch.Tensor,
                    num_sequences: int, plain: bool = False) -> None:
    """Insertions lo..hi-1; rows[j] is the distance row of insertion
    lo+j. The range runs on the stream that is current at its start: by
    the kernel's cursor route on the card (no host sync; a failed
    insertion stops the range's launches and shows at
    exact_cuda.check_done), by the plain version on the CPU, or anywhere
    with `plain=True`."""
    if not plain and uses_exact_kernel(st):
        _replay_exact(st, lo, hi, rows, num_sequences)
        return
    for i in range(lo, hi):
        exact_insertion_step(st, rows[i - lo], i, num_sequences)


def _replay_exact(st: ExactState, lo: int, hi: int, rows: torch.Tensor,
                  num_sequences: int) -> None:
    """The cursor route of an insert range, the counterpart of the JAX
    package's fori_loop over one: the state's cursor is written once (lo,
    st.idx, the rows), a captured CUDA graph of exact_cuda.GRAPH_INSERTIONS
    launches is replayed (hi - lo) // GRAPH_INSERTIONS times, and the
    remainder runs by direct cursor launches. st.idx advances by
    4 (hi - lo)."""
    n = hi - lo
    if n <= 0:
        return
    E = st.e.shape[0]
    if rows.shape[0] < n:
        raise ValueError(f"{rows.shape[0]} rows for {n} insertions")
    if 2 * num_sequences != st.parent.shape[0]:
        raise ValueError(f"a state of {st.parent.shape[0]} nodes is not "
                         f"one of {num_sequences} taxa")
    if lo < 2 or hi > num_sequences or st.idx + 4 * n > E:
        raise ValueError(f"insertions [{lo}, {hi}) at slot {st.idx} do not "
                         f"fit {num_sequences} taxa and {E} edge slots")
    exact_cuda.set_cursor(st, lo, rows, lo)
    reps, rest = divmod(n, exact_cuda.GRAPH_INSERTIONS)
    if reps:
        insert_cuda.replay(exact_cuda.range_graph(st), reps,
                           exact_cuda.count_replays)
    for _ in range(rest):
        exact_cuda.exact_step_cursor(st)
    st.idx += 4 * n


def run_exact_chunked(frontend_args, *, num_sequences: int, frontend: str,
                      frontend_static=(), dtype_name: str,
                      chunk: int = 8192, save_state: str | None = None,
                      load_state: str | None = None,
                      fingerprint: dict | None = None,
                      log=None, plain: bool = False) -> ExactState:
    """Whole exact build in bounded insert ranges on the frontend's
    device, with checkpoint/resume in the reference's schema (either
    package resumes the other's file). The sweeps run over the whole
    bank's width, so there are no prefix caps; mash and MSA rows of a
    range are computed in one call before its loop, under the same bytes
    budget as k-closest ranges. `plain=True` runs the plain version on the
    card too (run_exact_range). A range of the kernel route in which an
    insertion failed raises after the range (exact_cuda.check_done)."""
    N = num_sequences
    dev = frontend_args[0].device
    itemsize = torch.empty((), dtype=torch_dtype(dtype_name)).element_size()
    fp = dict(fingerprint or {})
    fp.update(frontend=frontend, dtype=dtype_name, placement="exact")
    if load_state and os.path.exists(load_state):
        st, i0 = load_tree_state(load_state, N, dtype_name, fp, device=dev,
                                 cls=ExactState)
        if log:
            log(f"Resumed exact placement at insertion {i0}/{N}")
    else:
        st = init_exact_state(frontend_args, num_sequences=N,
                              frontend=frontend,
                              frontend_static=frontend_static,
                              dtype_name=dtype_name)
        i0 = 2
    kernel = not plain and uses_exact_kernel(st)
    B = ROW_BLOCK
    # matrix rows are views of the resident matrix
    ce = chunk if frontend == "matrix" else max(
        B, min(chunk, (_ROWS_BYTES // (itemsize * N)) // B * B))
    lo = i0
    while lo < N:
        hi = min(N, lo + chunk, lo + ce)
        t0 = time.time()
        rows = _rows(frontend_args, frontend, frontend_static, dtype_name,
                     lo, hi)
        run_exact_range(st, lo, hi, rows, N, plain)
        del rows
        synchronize(dev)
        if kernel:
            exact_cuda.check_done(st)
        if log:
            log(f"Inserted {hi}/{N} "
                f"({(time.time() - t0) / max(hi - lo, 1) * 1e3:.2f} "
                f"ms/insertion)")
        if save_state and (hi == N or hi // chunk > lo // chunk):
            save_tree_state(save_state, st, hi, N, fp)
            if log:
                log(f"Checkpointed exact placement at insertion {hi}/{N}")
        lo = hi
    return st


def run_exact_placement(frontend_args, *, num_sequences: int, frontend: str,
                        frontend_static=(), dtype_name: str, **chunk_kw):
    """Whole build (placement/api.py's entry): returns the final
    (e, belong, length) edge arrays."""
    st = run_exact_chunked(
        frontend_args, num_sequences=num_sequences, frontend=frontend,
        frontend_static=frontend_static, dtype_name=dtype_name,
        **{"chunk": max(num_sequences, 2), **chunk_kw})
    return st.e, st.belong, st.length
