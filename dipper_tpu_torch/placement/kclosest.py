"""K-closest incremental placement on PyTorch tensors.

Behavioral spec (src/placement_close_k.cu), as in the JAX reference
dipper_tpu/placement/kclosest.py:
- tree stored as directed edge arrays (4 new directed edges per
  insertion; node ids: leaf i -> i, middle node of insertion i ->
  N+i-1; allocation contract 2N nodes / 4N-4 edges),
- every directed edge (a->b) keeps the K=5 closest leaves on the
  a-side with their tree distance from a, ascending, sentinel
  (id=-1, dis=2.0) (:56-84),
- per new taxon: distance row to placed taxa; score one direction per
  undirected edge (belong > e, :326); dis1/dis2 = max over witness
  entries of d(new,leaf) - closest_dis (:334-344); the clamp sequence
  (:346-355) yields (fracLen, additional_dis); minimize
  (additional_dis, eid) — first minimum == lowest eid (:807);
- splice (:446-528): the x-side edge keeps its id (becomes x->middle),
  the y-side becomes y->middle; 4 new edges middle->x / middle->y /
  outside->middle / middle->outside with closest lists copied+shifted
  from the severed halves, and middle->outside = stable insert-merge
  of (middle->y then middle->x) lists;
- closest lists then updated by a BFS from the new leaf that
  insert-sorts (leaf, d) into each visited edge's list and prunes when
  the leaf doesn't beat an edge's 5th entry (:86-124).

PyTorch design: the tree state is a dataclass of tensors updated in
place (a splice writes a few slots, a BFS level a few rows; copying the
[4N] arrays per insertion would dominate). Distance rows of a whole
insert range are computed before its loop (distance/mash.py: the Hopper
merge-count kernel on CUDA). On the card an insertion of a state with an
adjacency table is two kernels and no host sync: the scorer
csrc/score_edges.cu leaves the chosen edge and its two lengths on the
card, and csrc/insert_step.cu (placement/insert_cuda.py) reads them there
and runs the splice and the witness BFS, as the JAX package's jitted
insert loop does on its device. An insert range reads its insertions from
a cursor on the card and replays a captured CUDA graph of them
(_replay_insertions), the counterpart of the JAX package's fori_loop over
the range. The same kernel's BFS alone seeds states
(init_placement_state, --add's backbone, replayed likewise). The tensor code below (splice,
the compact and dense BFS, insertion_step) is the plain version: the CPU
path and the kernel's yardstick; its compact BFS sizes each level with
`nonzero`, a host sync a level. csrc/side_vector.cu is the scorer's side
vector on its own. D&C's phase 2 scores many rows on one state
(`score_edges_rows`): on the card one launch of csrc/dc_assign.cu
(dc/assign_cuda.py) a chunk over records of the valid slots packed once a
phase (`assign_records`), `score_edges_rows_plain` and `pack_slots_plain`
its plain versions.
The float operations and their order are the reference's, so trees are
bitwise equal to the JAX package's on the same rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.placement import insert_cuda
from dipper_tpu_torch.utils.device import synchronize, torch_dtype

K = 5
SENT_DIS = 2.0

@dataclasses.dataclass
class TreeState:
    # checkpoint arrays, in the reference TreeState's field order
    FIELDS = ("e", "belong", "length", "rev", "cdis", "cid", "idx", "adj",
              "nfb")

    e: torch.Tensor        # [E] int32 dst node (-1 unused)
    belong: torch.Tensor   # [E] int32 src node (-1 unused)
    length: torch.Tensor   # [E] f    branch length
    rev: torch.Tensor      # [E] int32 reverse edge id
    cdis: torch.Tensor     # [E, K] f closest distances (ascending)
    cid: torch.Tensor      # [E, K] int32 closest leaf ids (-1 empty)
    idx: int               # next free edge slot (host-side counter)
    # [2N, 3] int32 out-edge ids per node (-1 empty); a splice rewrites
    # only the two new nodes' rows. None forces the dense BFS.
    adj: torch.Tensor | None = None
    # the JAX state's count of compact-BFS frontier overflows. The port's
    # compact BFS has no frontier cap, so this reads 0 by construction; it
    # is kept for the checkpoint schema and the state comparisons
    nfb: int = 0
    # the CUDA scorer's checked pointers, outputs and scratch (`_Scorer`,
    # made by prepare_scorer); not a constructor argument, so
    # dataclasses.replace never carries it over to other arrays
    scorer: "_Scorer | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # the insertion-step kernel's checked pointers and scratch
    # (insert_cuda._Inserter, made by insert_cuda.prepare_inserter), alike
    inserter: "insert_cuda._Inserter | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @classmethod
    def from_numpy(cls, d, device) -> "TreeState":
        return tree_state_from_numpy(d, device)


def init_state(num_sequences: int, dtype: torch.dtype,
               device: torch.device) -> TreeState:
    E = 4 * num_sequences
    i32 = dict(dtype=torch.int32, device=device)
    return prepare_kernels(TreeState(
        e=torch.full((E,), -1, **i32),
        belong=torch.full((E,), -1, **i32),
        length=torch.zeros((E,), dtype=dtype, device=device),
        rev=torch.full((E,), -1, **i32),
        cdis=torch.full((E, K), SENT_DIS, dtype=dtype, device=device),
        cid=torch.full((E, K), -1, **i32),
        idx=0,
        adj=torch.full((2 * num_sequences, 3), -1, **i32),
        nfb=0,
    ))


def _i32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32).to(device)


def build_initial_tree(st: TreeState, d01: torch.Tensor,
                       num_sequences: int) -> None:
    """Edges 0..3 joining taxa 0,1 through node N (buildInitialTree,
    src/placement_close_k.cu:530-554 + rev wiring), in place."""
    N = num_sequences
    dev = st.e.device
    st.e[:4] = _i32([N, N, 0, 1], dev)
    st.belong[:4] = _i32([0, 1, N, N], dev)
    st.length[:4] = d01 / 2
    st.rev[:4] = _i32([2, 3, 0, 1], dev)
    if st.adj is not None:
        st.adj[0] = _i32([0, -1, -1], dev)
        st.adj[1] = _i32([1, -1, -1], dev)
        st.adj[N] = _i32([2, 3, -1], dev)
    st.idx = 4


def _insert_sorted(cd, ids, pos, d, label: int):
    """Insert (d[r], label) into ascending K-lists cd/ids [R, K] at
    position pos[r] (entries after it shift right, the last drops)."""
    slot = torch.arange(K, device=cd.device)
    before = slot < pos[:, None]
    at = slot == pos[:, None]
    shifted_cd = torch.cat([torch.full_like(cd[:, :1], SENT_DIS),
                            cd[:, :-1]], dim=1)
    shifted_id = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]],
                           dim=1)
    new_cd = torch.where(before, cd, torch.where(at, d[:, None], shifted_cd))
    new_id = torch.where(before, ids, torch.where(at, label, shifted_id))
    return new_cd, new_id


def update_closest_bfs(st: TreeState, leaf: int, num_nodes: int,
                       label=None, blocked_nodes=()) -> None:
    """Frontier equivalent of updateClosestNodes
    (src/placement_close_k.cu:86-124), in place. `leaf` is the BFS
    source node; `label` is the id recorded in witness lists (default:
    the node; D&C's cluster builds use local nodes with witness-space
    labels); `blocked_nodes` (host ints or 0-d tensors) are dequeued but
    not expanded (the cluster edge's endpoints in
    updateClosestNodesInClusterDC :334). States with an adjacency table
    run the frontier-compact BFS (on the card: insert_cuda.closest_bfs,
    one launch, no host sync), others the dense edge-parallel one; all
    give bitwise-identical states (each visited edge receives the same
    insert, and inserts into distinct edges commute)."""
    if uses_insert_kernel(st):
        insert_cuda.closest_bfs(
            st, leaf, label,
            _blocked_ids(blocked_nodes, st.e.device, torch.int32))
    else:
        _update_closest_bfs_plain(st, leaf, num_nodes, label, blocked_nodes)


def _update_closest_bfs_plain(st: TreeState, leaf: int, num_nodes: int,
                              label=None, blocked_nodes=()) -> None:
    """update_closest_bfs by tensor code alone: the compact BFS for
    states with an adjacency table, the dense one for the others."""
    if st.adj is not None:
        _update_closest_bfs_compact(st, leaf, num_nodes, label, blocked_nodes)
    else:
        _update_closest_bfs_dense(st, leaf, num_nodes, label, blocked_nodes)


def uses_insert_kernel(st: TreeState) -> bool:
    """Whether the state's insertions and BFSs go to csrc/insert_step.cu:
    a CUDA state with an adjacency table."""
    return st.adj is not None and st.e.device.type == "cuda"


def _blocked_ids(blocked_nodes, device,
                 dtype=torch.int64) -> torch.Tensor | None:
    """The blocked nodes as one tensor on `device` (no host sync for
    tensor entries), or None."""
    if len(blocked_nodes) == 0:
        return None
    return torch.stack([torch.as_tensor(b, device=device).to(dtype)
                        .reshape(()) for b in blocked_nodes])


def _update_closest_bfs_dense(st: TreeState, leaf: int, num_nodes: int,
                              label=None, blocked_nodes=()) -> None:
    """Edge-parallel BFS: every level tests all E edge slots. The path of
    adj-less states (multifurcating --add backbones)."""
    M = num_nodes
    dev = st.e.device
    label = leaf if label is None else label
    frontier = torch.zeros((M,), dtype=torch.bool, device=dev)
    frontier[leaf] = True
    bids = _blocked_ids(blocked_nodes, dev)
    if bids is not None:
        # (index_fill_ takes the scalar as an argument: no copy, no sync)
        open_ = torch.ones((M,), dtype=torch.bool, device=dev)
        open_.index_fill_(0, bids, False)
    from_node = torch.full((M,), -1, dtype=torch.int32, device=dev)
    distx = torch.zeros((M,), dtype=st.length.dtype, device=dev)
    src = st.belong
    used = src >= 0
    srcc = src.clamp(min=0)
    while True:
        expand = frontier if bids is None else frontier & open_
        act = used & expand[srcc] & (st.e != from_node[srcc])
        d = distx[srcc]
        pos = (st.cdis <= d[:, None]).sum(dim=1)
        sel = (act & (pos < K)).nonzero().squeeze(1)  # host sync
        if sel.numel() == 0:
            return
        new_cd, new_id = _insert_sorted(st.cdis[sel], st.cid[sel], pos[sel],
                                        d[sel], label)
        st.cdis[sel] = new_cd
        st.cid[sel] = new_id
        # in a tree each node is reached along its unique path, so the
        # destinations are distinct and these scatters never collide
        dst = st.e[sel]
        frontier = torch.zeros((M,), dtype=torch.bool, device=dev)
        frontier[dst] = True
        from_node[dst] = src[sel]
        distx[dst] = d[sel] + st.length[sel]


def _update_closest_bfs_compact(st: TreeState, leaf: int, num_nodes: int,
                                label=None, blocked_nodes=()) -> None:
    """Frontier-compact BFS: each level gathers only the <=3 out-edges
    of each frontier node through the adjacency rows, so its work is
    O(frontier), not O(E). Each level's width comes from `nonzero`, so
    no level is too wide: the JAX package's fixed frontier cap, its undo
    log and its dense re-run have no counterpart here."""
    dev = st.e.device
    label = leaf if label is None else label
    bids = _blocked_ids(blocked_nodes, dev)
    ids = _i32([leaf], dev)                 # frontier nodes
    frm = _i32([-1], dev)                   # node each was reached from
    dist = torch.zeros((1,), dtype=st.length.dtype, device=dev)
    while True:
        eids = st.adj[ids]                               # [F, 3]
        eidsc = eids.clamp(min=0)
        dstn = st.e[eidsc]                               # [F, 3]
        emask = (eids >= 0) & (dstn != frm[:, None])     # no backtracking
        if bids is not None:
            expand = ~(ids[:, None].long() == bids[None, :]).any(dim=1)
            emask = emask & expand[:, None]
        cd = st.cdis[eidsc]                              # [F, 3, K]
        pos = (cd <= dist[:, None, None]).sum(dim=-1)    # [F, 3]
        sel = (emask & (pos < K)).reshape(-1).nonzero().squeeze(1)  # sync
        if sel.numel() == 0:
            return
        rows = eidsc.reshape(-1)[sel]
        d = dist.repeat_interleave(3)[sel]
        new_cd, new_id = _insert_sorted(cd.reshape(-1, K)[sel], st.cid[rows],
                                        pos.reshape(-1)[sel], d, label)
        # distinct frontier nodes => distinct out-edges: rows are unique
        st.cdis[rows] = new_cd
        st.cid[rows] = new_id
        dist = d + st.length[rows]
        frm = ids.repeat_interleave(3)[sel]
        ids = dstn.reshape(-1)[sel]


def adjacency_from_edges(belong: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[M, 3] out-edge table recovered from the belong array (one-time
    seeding for pre-adjacency checkpoints): sort edge ids by source
    node, index each run; degree <= 3 in an unrooted binary tree."""
    E = belong.shape[0]
    belong = belong.to(torch.int32)
    order = torch.argsort(belong, stable=True)
    b_s = belong[order]
    idxs = torch.arange(E, device=belong.device)
    first = torch.ones_like(b_s, dtype=torch.bool)
    first[1:] = b_s[1:] != b_s[:-1]
    run_first = torch.where(first, idxs, 0).cummax(dim=0).values
    slotpos = idxs - run_first
    okm = (b_s >= 0) & (slotpos < 3)
    adj = torch.full((num_nodes, 3), -1, dtype=torch.int32,
                     device=belong.device)
    adj[b_s[okm].long(), slotpos[okm]] = order[okm].to(torch.int32)
    return adj


def _side_vector(cid, cdis, dist_row):
    """side[e] = max(max_j d(new, witness_j) - witness_dis_j, 0) — the
    dis1/dis2 maximization of calculateBranchLength
    (src/placement_close_k.cu:334-344). The plain PyTorch version of
    csrc/side_vector.cu."""
    dv = torch.where(cid != -1, dist_row[cid.clamp(min=0)] - cdis,
                     float("-inf"))
    return dv.amax(dim=-1).clamp(min=0.0)


# side_vector_cuda launches made by this process (chip_smoke.py resets it
# and reads it)
SIDE_VECTOR_LAUNCHES = 0


def side_vector_cuda(cid, cdis, dist_row):
    """The Hopper kernel csrc/side_vector.cu (the port of scripts/
    gather_micro.py's TPU gather, fused with the subtraction, the mask and
    the max over K): cid int32 [E, K] and cdis [E, K], contiguous, and
    dist_row [cap] with unit stride, float32 or float64, on one CUDA
    device, every witness id < cap -> side [E], bitwise equal to
    `_side_vector`. Launches on the current stream without
    synchronizing."""
    global SIDE_VECTOR_LAUNCHES
    dev = dist_row.device
    if dev.type != "cuda" or cid.device != dev or cdis.device != dev:
        raise ValueError(f"side_vector_cuda needs CUDA tensors on one device, "
                         f"got {cid.device}, {cdis.device}, {dev}")
    if cid.dtype != torch.int32 or cid.dim() != 2 or cid.shape[1] != K:
        raise ValueError(f"cid must be int32 [E, {K}], got {cid.dtype} "
                         f"{tuple(cid.shape)}")
    if cdis.shape != cid.shape or cdis.dtype != dist_row.dtype:
        raise ValueError(f"cdis must be [E, {K}] of dist_row's dtype, got "
                         f"{cdis.dtype} {tuple(cdis.shape)}")
    if dist_row.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dist_row must be float32 or float64, got "
                         f"{dist_row.dtype}")
    if dist_row.dim() != 1 or (dist_row.numel() > 1
                               and dist_row.stride(0) != 1):
        raise ValueError("dist_row must be a 1-D tensor with unit stride")
    if not (cid.is_contiguous() and cdis.is_contiguous()):
        raise ValueError("cid and cdis must be contiguous")
    E = cid.shape[0]
    if E >= 2**31:
        raise ValueError("too many edges for the kernel's int arguments")
    side = torch.empty((E,), dtype=dist_row.dtype, device=dev)
    if E == 0:
        return side
    lib = load("side_vector", [ctypes.c_void_p] * 4
               + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = lib.side_vector(cid.data_ptr(), cdis.data_ptr(),
                             dist_row.data_ptr(), side.data_ptr(), E,
                             int(dist_row.dtype == torch.float64),
                             torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "side_vector", rc)
    SIDE_VECTOR_LAUNCHES += 1
    return side


def side_vector(cid, cdis, dist_row):
    """`_side_vector` on the device of dist_row: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if dist_row.device.type == "cuda":
        return side_vector_cuda(cid, cdis, dist_row)
    if dist_row.device.type == "cpu":
        return _side_vector(cid, cdis, dist_row)
    raise ValueError(f"unsupported device {dist_row.device}")


def clamp_sequence(dis1, dis2, L):
    """The clamp sequence of calculateBranchLength
    (src/placement_close_k.cu:346-355) on the witness maxima of an edge
    (dis1) and of its reverse (dis2) and its length L, elementwise:
    returns (additional_dis, fracLen)."""
    addi = ((dis1 + dis2 - L) * 0.5).clamp(min=0.0)
    dis1 = (dis1 - addi).clamp(min=0.0)
    dis2 = (dis2 - addi).clamp(min=0.0)
    addi = addi + (dis1 - L).clamp(min=0.0) + (dis2 - L).clamp(min=0.0)
    dis1 = nan_minimum(dis1, L)
    dis2 = nan_minimum(dis2, L)
    rest = L - dis1 - dis2
    return addi, dis1 + rest * 0.5


def nan_minimum(a, b):
    """jnp.minimum: the smaller value, or the NaN operand itself (a's if
    both are NaN). torch.minimum on the CPU returns an all-ones NaN (sign
    bit set) instead, which the Newick shows as -nan where the JAX
    package writes nan."""
    return torch.where(a.isnan() | (a <= b), a, b)


def _finish_score(st: TreeState, side, dis2, lo: int = 0,
                  hi: int | None = None):
    """Clamp sequence + first-minimum argmin of calculateBranchLength
    (src/placement_close_k.cu:346-355, :807) over the slots [lo, hi)
    (default: all). `side`/`dis2` are the per-directed-edge witness
    maxima (dis1 of the edge, dis1 of its reverse). Returns (eid, a global
    slot id as a host int, frac, add as 0-d tensors)."""
    valid = st.belong > st.e
    addi, dis1 = clamp_sequence(side, dis2, st.length)
    # invalid slots carry the sentinel (frac=0, addi=2): if no real
    # candidate beats 2.0 the argmin lands on slot 0, as
    # thrust::min_element over the sentinel-filled minPos buffer does
    score = torch.where(valid, addi, SENT_DIS)
    frac = torch.where(valid, dis1, 0.0)
    # first minimum == lowest eid; host sync
    eid = lo + int(torch.argmin(score[lo:hi]))
    return eid, frac[eid], score[eid]


def _score_edges_plain(st: TreeState, dist_row, lo: int = 0,
                       hi: int | None = None):
    """The plain PyTorch version of csrc/score_edges.cu: the side vector,
    its reread through `rev`, the clamp sequence and the argmin over the
    slots [lo, hi) (default: all) as separate tensor operations, then the
    chosen edge's endpoints. Returns what `score_edges` returns."""
    side = _side_vector(st.cid, st.cdis, dist_row)     # [E]
    eid, frac, add = _finish_score(st, side, side[st.rev], lo, hi)
    x, y, ye = torch.stack(
        (st.belong[eid], st.e[eid], st.rev[eid])).tolist()  # host sync
    return eid, x, y, ye, frac, add


def score_edges_rows_plain(st: TreeState, rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of csrc/dc_assign.cu (kernel 10): the
    chosen edge of each of many rows on one state, the tree untouched
    (D&C's phase 2): rows [Q, cap] -> int64 eid [Q], on the rows' device,
    equal to score_edges' eid row by row (the same elementwise operations;
    ties -> lowest eid). Tensor code over the [Q, E, K] witness gather;
    callers bound Q."""
    dv = torch.where(st.cid != -1, rows[:, st.cid.clamp(min=0)] - st.cdis,
                     float("-inf"))
    side = dv.amax(dim=-1).clamp(min=0.0)                # [Q, E]
    addi, _ = clamp_sequence(side, side[:, st.rev], st.length)
    return torch.argmin(torch.where(st.belong > st.e, addi, SENT_DIS), dim=1)


def pack_slots_plain(st: TreeState, width: int) -> tuple:
    """The plain PyTorch version of csrc/dc_assign.cu's pack: the valid
    slots' records (uint8 [n, record bytes], in slot order; the layout of
    dc/assign_model.py::record_layout: the slot's and its reverse's five
    witness ids, uint16 with 0xFFFF for an empty entry where `width` <=
    65,535, else int32 with -1, the slot, its length, the ten distances,
    zeros to a multiple of 16 bytes) and meta int32 [2]: the record count
    and the lowest invalid slot (2**31 - 1 if none). Tensor code on the
    state's device; syncs the host (nonzero)."""
    from dipper_tpu_torch.dc import assign_model as am

    item = st.length.element_size()
    idb = am.id_bytes_of(width)
    lay = am.record_layout(idb, item)
    valid = st.belong > st.e
    s = torch.nonzero(valid).squeeze(1)
    r = st.rev[s].long()
    n = s.shape[0]
    ids = torch.cat([st.cid[s], st.cid[r]], dim=1)               # [n, 2K]
    dis = torch.cat([st.cdis[s], st.cdis[r]], dim=1)
    rec = torch.zeros((n, lay.bytes), dtype=torch.uint8, device=st.e.device)
    if idb == 2:
        code = torch.where(ids < 0, 0xFFFF, ids)
        rec[:, :lay.slot] = torch.stack(
            (code & 0xFF, code >> 8), dim=-1).reshape(n, lay.slot).to(
                torch.uint8)
    else:
        rec[:, :lay.slot] = ids.to(torch.int32).contiguous().view(
            torch.uint8).reshape(n, lay.slot)
    rec[:, lay.slot:lay.slot + 4] = s.to(torch.int32)[:, None].view(
        torch.uint8)
    rec[:, lay.length:lay.length + item] = st.length[s][:, None].view(
        torch.uint8)
    rec[:, lay.dist:lay.dist + 2 * K * item] = dis.contiguous().view(
        torch.uint8).reshape(n, 2 * K * item)
    invalid = torch.nonzero(~valid)
    first = int(invalid[0, 0]) if invalid.shape[0] else 2**31 - 1
    meta = torch.tensor([n, first], dtype=torch.int32, device=st.e.device)
    return rec, meta


def uses_assign_kernel(st: TreeState) -> bool:
    """Whether D&C's phase 2 scores on kernel 10: the state is on the
    card."""
    return st.e.device.type == "cuda"


def assign_records(st: TreeState, width: int):
    """The packed records that kernel 10 scores rows of `width` over: for a
    state on the card, one launch of the pack (dc/assign_cuda.py::pack,
    no host sync); None for a CPU state, whose plain version needs none."""
    if uses_assign_kernel(st):
        from dipper_tpu_torch.dc import assign_cuda

        return assign_cuda.pack(st, width)
    return None


def score_edges_rows(st: TreeState, rows: torch.Tensor,
                     out: torch.Tensor | None = None,
                     records=None) -> torch.Tensor:
    """`score_edges_rows_plain` on the state's device: for a state on the
    card, one launch of kernel 10 (dc/assign_cuda.py, which raises on a
    failed build or launch) over `records` (assign_records' for the rows'
    width; packed by one more launch if None), writing into `out` (int64
    [Q]) if given, with no host sync; for a CPU state the plain version.
    Returns the int64 [Q] slots."""
    if uses_assign_kernel(st):
        from dipper_tpu_torch.dc import assign_cuda

        return assign_cuda.assign(st, rows, out, records=records)
    got = score_edges_rows_plain(st, rows)
    if out is None:
        return got
    out.copy_(got)
    return out


# most blocks of one score_edges launch (4 on each of an H100's 132
# multiprocessors), and so the partial minima its last block reduces
SCORE_EDGES_MAX_BLOCKS = 528

# score_edges kernel launches made by this process (chip_smoke.py resets
# it and reads it)
SCORE_EDGES_LAUNCHES = 0


class _Scorer:
    """What one TreeState's score_edges launches share: the state's six
    arrays as checked (held so that a swapped array is noticed), the
    kernel's entry point with its per-state arguments, the outputs and
    the scratch. Launches through one _Scorer must be ordered on one
    stream: they share the outputs and the ticket."""

    __slots__ = ("arrays", "dtype", "device", "lib", "fn", "fn_cursor",
                 "args", "out_i", "out_f", "eid", "frac", "add", "scratch_i",
                 "scratch_f")

    def owns(self, st: TreeState) -> bool:
        a = self.arrays
        return (st.cid is a[0] and st.cdis is a[1] and st.belong is a[2]
                and st.e is a[3] and st.rev is a[4] and st.length is a[5])


def prepare_kernels(st: TreeState) -> TreeState:
    """prepare_scorer, then insert_cuda.prepare_inserter: a state's
    checks for both per-insertion kernels. Returns `st`."""
    return insert_cuda.prepare_inserter(prepare_scorer(st))


def prepare_scorer(st: TreeState) -> TreeState:
    """Checks a CUDA state's arrays against what csrc/score_edges.cu takes
    and gives the state its `_Scorer`; a CPU state is left as it is.
    Called wherever a state is made or its arrays are replaced, so that
    no check runs per insertion. Returns `st`."""
    dev = st.cid.device
    if dev.type != "cuda" or st.e.dim() != 1:
        # CPU states, and D&C's cluster states ([C, E] arrays), which the
        # kernel does not score
        st.scorer = None
        return st
    arrays = (st.cid, st.cdis, st.belong, st.e, st.rev, st.length)
    names = ("cid", "cdis", "belong", "e", "rev", "length")
    for name, a in zip(names, arrays):
        if a.device != dev:
            raise ValueError(f"score_edges needs the state's arrays on one "
                             f"CUDA device: {name} is on {a.device}, cid on "
                             f"{dev}")
        if not a.is_contiguous():
            raise ValueError(f"score_edges needs contiguous arrays: {name} "
                             f"has strides {a.stride()}")
    E = st.e.shape[0]
    dtype = st.length.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"length must be float32 or float64, got {dtype}")
    for name, a, want in zip(names, arrays, (
            torch.int32, dtype, torch.int32, torch.int32, torch.int32,
            dtype)):
        shape = (E, K) if name in ("cid", "cdis") else (E,)
        if a.dtype != want or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {want} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if not 1 <= E < 2**30:
        raise ValueError(f"score_edges takes 1 to 2**30 - 1 edge slots, got "
                         f"{E}")
    sc = _Scorer()
    sc.arrays, sc.dtype, sc.device = arrays, dtype, dev
    sc.out_i = torch.empty((4,), dtype=torch.int32, device=dev)
    sc.out_f = torch.empty((2,), dtype=dtype, device=dev)
    sc.eid, sc.frac, sc.add = sc.out_i[0], sc.out_f[0], sc.out_f[1]
    sc.scratch_i = torch.zeros((1 + SCORE_EDGES_MAX_BLOCKS,),
                               dtype=torch.int32, device=dev)
    sc.scratch_f = torch.empty((2 * SCORE_EDGES_MAX_BLOCKS,), dtype=dtype,
                               device=dev)
    sc.lib = load("score_edges", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
    sc.fn = sc.lib.score_edges
    sc.fn_cursor = sc.lib.score_edges_cursor
    sc.fn_cursor.restype = ctypes.c_int
    sc.fn_cursor.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p] + [ctypes.c_int] * 2
                             + [ctypes.c_void_p])
    sc.args = (*(a.data_ptr() for a in arrays), sc.scratch_f.data_ptr(),
               sc.scratch_i.data_ptr(), sc.out_i.data_ptr(),
               sc.out_f.data_ptr(), E, SCORE_EDGES_MAX_BLOCKS,
               int(dtype == torch.float64), dev.index)
    st.scorer = sc
    return st


def _slot_range(st: TreeState, lo: int, hi: int | None) -> tuple[int, int]:
    E = st.e.shape[0]
    hi = E if hi is None else hi
    if not 0 <= lo < hi <= E:
        raise ValueError(f"slot range [{lo}, {hi}) is not a non-empty range "
                         f"of [0, {E})")
    return lo, hi


def scorer(st: TreeState) -> _Scorer:
    """The state's `_Scorer`, re-made if the state's arrays were swapped
    since it was made; raises for a state off the card."""
    sc = st.scorer
    if sc is None or not sc.owns(st):
        if st.cid.device.type != "cuda":
            raise ValueError(f"score_edges_cuda needs a CUDA state, got one "
                             f"on {st.cid.device}")
        sc = prepare_scorer(st).scorer
    return sc


def score_edges_launch(st: TreeState, dist_row, stream: int | None = None,
                       lo: int = 0, hi: int | None = None):
    """Launches csrc/score_edges.cu for a CUDA state on `stream` (a raw
    CUDA stream handle; default: the device's current stream) without
    synchronizing, and returns the state's `_Scorer`, whose `out_i` (eid,
    belong[eid], e[eid], rev[eid]) and `frac`, `add` the launch fills.
    dist_row [cap]: the state's float type and device, unit stride, every
    witness id < cap. The slots [lo, hi) (default: all) are scored; of
    them, those below `st.idx` are used, the rest must be unused."""
    global SCORE_EDGES_LAUNCHES
    sc = scorer(st)
    if (dist_row.dtype != sc.dtype or dist_row.device != sc.device
            or dist_row.dim() != 1
            or (dist_row.shape[0] > 1 and dist_row.stride(0) != 1)):
        raise ValueError(
            f"dist_row must be a 1-D {sc.dtype} tensor with unit stride on "
            f"{sc.device}, got {dist_row.dtype} {tuple(dist_row.shape)} "
            f"strides {dist_row.stride()} on {dist_row.device}")
    lo, hi = _slot_range(st, lo, hi)
    if stream is None:
        stream = torch.cuda.current_stream(sc.device).cuda_stream
    rc = sc.fn(*sc.args, dist_row.data_ptr(), st.idx, lo, hi, stream)
    if rc != 0:
        check_launch(sc.lib, "score_edges", rc)
    SCORE_EDGES_LAUNCHES += 1
    return sc


def score_edges_cursor_launch(st: TreeState, stream: int | None = None,
                              count: bool = True):
    """score_edges_launch for the insertion that the state's insert-range
    cursor holds (insert_cuda.set_cursor): n_used and the distance row are
    read from the cursor on the card, and the grid covers every slot, so
    one captured launch serves every insertion of a range. Returns the
    state's `_Scorer`. `count=False` for a launch being captured."""
    global SCORE_EDGES_LAUNCHES
    sc = scorer(st)
    ins = insert_cuda.inserter(st)
    if stream is None:
        stream = torch.cuda.current_stream(sc.device).cuda_stream
    E = st.e.shape[0]
    rc = sc.fn_cursor(*sc.args, ins.cursor.data_ptr(), 0, E, stream)
    if rc != 0:
        check_launch(sc.lib, "score_edges", rc)
    if count:
        SCORE_EDGES_LAUNCHES += 1
    return sc


def score_edges_cuda(st: TreeState, dist_row, stream: int | None = None,
                     lo: int = 0, hi: int | None = None):
    """`score_edges` by the Hopper kernel: one launch, then one copy of
    four ints to the host (the insertion's only sync for scoring and
    splice). frac and add are 0-d views of the state's output buffer,
    which the state's next launch overwrites: use them (on the launch's
    stream) or clone them before scoring again. Equal to
    `_score_edges_plain` in all six values, bit for bit, on any slot
    range."""
    sc = score_edges_launch(st, dist_row, stream, lo, hi)
    eid, x, y, ye = sc.out_i.tolist()  # host sync
    return eid, x, y, ye, sc.frac, sc.add


def score_edges(st: TreeState, dist_row, stream: int | None = None,
                lo: int = 0, hi: int | None = None):
    """Vectorized calculateBranchLength (src/placement_close_k.cu:309-358)
    on the device of dist_row: the kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (eid, x, y, ye, fracLen, addLen):
    the chosen edge (ties -> lowest eid) as host ints with its source
    node, destination node and reverse edge, and the two lengths as 0-d
    tensors. With a slot range [lo, hi) the choice is among its slots
    (a rank's share of a sharded build: parallel/sharded.py merges the
    ranges' choices in the same order)."""
    if dist_row.device.type == "cuda":
        return score_edges_cuda(st, dist_row, stream, lo, hi)
    if dist_row.device.type == "cpu":
        lo, hi = _slot_range(st, lo, hi)
        return _score_edges_plain(st, dist_row, lo, hi)
    raise ValueError(f"unsupported device {dist_row.device}")


def _insert_merge_lists(cd1, id1, cd2, id2):
    """Stable merge of two ascending K-lists (first list wins ties),
    reproducing the sequential insert-sort of updateTreeStructure
    (src/placement_close_k.cu:500-526). Sentinel entries sort last."""
    vals = torch.cat([cd1, cd2])
    ids = torch.cat([id1, id2])
    order = torch.argsort(vals, stable=True)[:K]
    return vals[order], ids[order]


def splice(st: TreeState, eid: int, frac, add, place_id: int,
           num_sequences: int, ends=None, middle: int | None = None,
           outside: int | None = None) -> None:
    """updateTreeStructure (src/placement_close_k.cu:446-528), in place:
    taxon place_id attaches through middle node N+place_id-1 onto edge
    eid at fracLen `frac` with pendant length `add`. `ends` is edge eid's
    (source node, destination node, reverse edge) as host ints where the
    scorer has read them; without it they are read here. `middle` and
    `outside` override the node numbering (D&C's cluster builds)."""
    dev = st.e.device
    N = num_sequences
    if middle is None:
        middle = place_id + N - 1
    if outside is None:
        outside = place_id
    if ends is None:
        ends = torch.stack(
            (st.belong[eid], st.e[eid], st.rev[eid])).tolist()  # host sync
    x, y, ye = ends
    xe = eid
    i0 = st.idx
    i1, i2, i3 = i0 + 1, i0 + 2, i0 + 3

    # every new value is computed before the first write: the reads of
    # slots xe/ye below must not see this splice's own updates
    orig = st.length[xe].clone()
    rest = orig - frac
    cd_xe, id_xe = st.cdis[xe].clone(), st.cid[xe].clone()
    cd_ye, id_ye = st.cdis[ye].clone(), st.cid[ye].clone()
    # NB: (cd + orig) - frac, the reference's left-to-right float
    # association (:398) — bit parity matters at score ties
    cd_i0 = torch.where(id_ye != -1, cd_ye + orig - frac, SENT_DIS)
    cd_i1 = torch.where(id_xe != -1, cd_xe + frac, SENT_DIS)
    cd_i3, id_i3 = _insert_merge_lists(cd_i1, id_xe, cd_i0, id_ye)

    st.e[xe] = middle
    st.e[ye] = middle
    st.length[xe] = frac
    st.length[ye] = rest
    st.rev[xe] = i0
    st.rev[ye] = i1
    st.e[i0:i0 + 4] = _i32([x, y, middle, outside], dev)
    st.belong[i0:i0 + 4] = _i32([middle, middle, outside, middle], dev)
    st.rev[i0:i0 + 4] = _i32([xe, ye, i3, i2], dev)
    st.length[i0:i0 + 4] = torch.stack([frac, rest, add, add])
    st.cdis[i0:i0 + 4] = torch.stack(
        [cd_i0, cd_i1, torch.full_like(cd_i0, SENT_DIS), cd_i3])
    st.cid[i0:i0 + 4] = torch.stack(
        [id_ye, id_xe, torch.full_like(id_ye, -1), id_i3])
    if st.adj is not None:
        # x and y keep their edge ids (xe/ye now point at middle), so
        # only the two new nodes' rows change
        st.adj[middle] = _i32([i0, i1, i3], dev)
        st.adj[outside] = _i32([i2, -1, -1], dev)
    st.idx += 4


def insertion_step(st: TreeState, row: torch.Tensor, i: int,
                   num_sequences: int) -> None:
    """Place taxon i given its distance row to the bank (in place), by
    the plain version of splice and BFS (the CPU path, adj-less states,
    and the kernels' yardstick on the card)."""
    eid, x, y, ye, frac, add = score_edges(st, row)
    splice(st, eid, frac, add, i, num_sequences, (x, y, ye))
    _update_closest_bfs_plain(st, i, 2 * num_sequences)


def kernel_insertion_step(st: TreeState, row: torch.Tensor, i: int,
                          num_sequences: int, stream: int) -> None:
    """insertion_step on the card, for a state with an adjacency table:
    one score_edges launch, then one insert_step launch that reads the
    choice where the scorer left it. No host sync."""
    sc = score_edges_launch(st, row, stream)
    insert_cuda.insert_step(st, sc.eid, sc.frac, sc.add,
                            middle=i + num_sequences - 1, outside=i, label=i,
                            stream=stream)


# ---------------------------------------------------------------------------
# Distance rows
# ---------------------------------------------------------------------------

ROW_BLOCK = 256  # row-block granularity of the reference's range sizing


def _rows(frontend_args, frontend: str, frontend_static, dtype_name: str,
          lo: int, hi: int) -> torch.Tensor:
    """[hi-lo, bank] distance rows of insertions lo..hi-1 against the
    frontend's bank (the whole bank, or its capped prefix)."""
    bank_rows = frontend_args[0].shape[0]
    if not 0 <= lo <= hi <= bank_rows:
        raise ValueError(f"rows [{lo}, {hi}) run past the {bank_rows}-row "
                         "bank")
    if frontend == "matrix":
        (D,) = frontend_args
        return D[lo:hi]
    if frontend == "mash":
        from dipper_tpu_torch.distance.mash import (inter_to_dist,
                                                    mash_pairwise_inter)

        (ranks,) = frontend_args
        k, sketch_size = frontend_static
        # counts, then the table gather: the merge-count kernel's route on
        # CUDA (moving it to the fused distance kernel is queued in
        # ROADMAP.md's perf_opt list)
        inter = mash_pairwise_inter(ranks, ranks[lo:hi],
                                    sketch_size=sketch_size)
        return inter_to_dist(inter, k, sketch_size, dtype_name)
    if frontend == "msa":
        from dipper_tpu_torch.distance.msa import msa_tiled_block

        codes, nongap = frontend_args
        (distance_type,) = frontend_static
        return msa_tiled_block(codes[lo:hi], nongap[lo:hi], codes, nongap,
                               distance_type=distance_type,
                               dtype_name=dtype_name)
    raise ValueError(f"unknown frontend {frontend!r}")


def _slice_frontend(frontend_args, frontend: str, cap: int):
    if frontend == "mash":
        (ranks,) = frontend_args
        return (ranks[:cap],)
    if frontend == "matrix":
        (D,) = frontend_args
        return (D[:cap, :cap],)
    if frontend == "msa":
        codes, nongap = frontend_args
        return (codes[:cap], nongap[:cap])
    raise ValueError(f"unknown frontend {frontend!r}")


# ---------------------------------------------------------------------------
# Full builds
# ---------------------------------------------------------------------------


def init_placement_state(frontend_args, *, num_sequences: int, frontend: str,
                         frontend_static=(), dtype_name: str) -> TreeState:
    """Tree of taxa 0 and 1 with their witness lists, on the device of
    the frontend's bank."""
    N = num_sequences
    dev = frontend_args[0].device
    fa2 = _slice_frontend(frontend_args, frontend, 2)
    d01 = _rows(fa2, frontend, frontend_static, dtype_name, 1, 2)[0, 0]
    st = init_state(N, torch_dtype(dtype_name), dev)
    build_initial_tree(st, d01.to(st.length.dtype), N)
    update_closest_bfs(st, 0, 2 * N)
    update_closest_bfs(st, 1, 2 * N)
    return st


# insertions (or seeded leaves) one captured CUDA graph of the cursor
# route holds: 2 kernel nodes an insertion (score_edges, insert_step), 1 a
# leaf. A replay costs the host one graph launch, so 64 insertions keep the
# host far ahead of the card; a capture runs once per state.
GRAPH_INSERTIONS = 64


def _insert_range(st: TreeState, lo: int, hi: int, rows: torch.Tensor,
                  num_sequences: int) -> None:
    """Insertions lo..hi-1; rows[j] is the distance row of insertion
    lo+j. The range runs on the stream that is current at its start. On
    the card a state with an adjacency table takes the cursor route
    (_replay_insertions): no host sync between its first insertion and
    its last, and no host launch per insertion."""
    if uses_insert_kernel(st):
        _replay_insertions(st, lo, hi, rows, num_sequences)
        return
    for i in range(lo, hi):
        insertion_step(st, rows[i - lo], i, num_sequences)


def _replay_insertions(st: TreeState, lo: int, hi: int, rows: torch.Tensor,
                       num_sequences: int) -> None:
    """The cursor route of an insert range, the counterpart of the JAX
    package's fori_loop over one: the state's cursor is written once (lo,
    st.idx, the rows), a captured CUDA graph of GRAPH_INSERTIONS
    insertions (score_edges_cursor_launch, then
    insert_cuda.insert_step_cursor, each reading the cursor on the card)
    is replayed (hi - lo) // GRAPH_INSERTIONS times, and the remainder
    runs by direct cursor launches. st.idx advances by 4 (hi - lo)."""
    global SCORE_EDGES_LAUNCHES
    n = hi - lo
    if n <= 0:
        return
    E, M = st.e.shape[0], st.adj.shape[0]
    if rows.shape[0] < n:
        raise ValueError(f"{rows.shape[0]} rows for {n} insertions")
    if lo < 0 or st.idx + 4 * n > E or hi + num_sequences - 2 >= M:
        raise ValueError(f"insertions [{lo}, {hi}) at slot {st.idx} do not "
                         f"fit {E} edge slots and {M} nodes")
    dev = st.e.device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    insert_cuda.set_cursor(st, lo, rows, lo, stream)
    offsets = insert_cuda.cursor_offsets(num_sequences)

    def insertion(s, count):
        sc = score_edges_cursor_launch(st, s, count)
        insert_cuda.insert_step_cursor(st, sc, offsets=offsets, stream=s,
                                       count=count)

    G = GRAPH_INSERTIONS
    reps, rest = divmod(n, G)
    if reps:
        sc = scorer(st) if dev.type == "cuda" else None
        graph = insert_cuda.range_graph(
            st, ("insert", num_sequences, G, id(sc)),
            lambda s: [insertion(s, False) for _ in range(G)], steps=G,
            keep=(sc,))
        insert_cuda.replay(graph, reps)
        SCORE_EDGES_LAUNCHES += reps * G
    for _ in range(rest):
        insertion(stream, True)
    st.idx += 4 * n


def _replay_seeding(st: TreeState, lo: int, hi: int) -> None:
    """The BFS alone from each leaf lo..hi-1 (--add's seeding of a
    backbone) by the cursor route: one cursor write, (hi - lo) //
    GRAPH_INSERTIONS replays of a captured graph of that many
    insert_cuda.closest_bfs_cursor launches, the remainder direct."""
    n = hi - lo
    if n <= 0:
        return
    if lo < 0 or hi > st.adj.shape[0]:
        raise ValueError(f"leaves [{lo}, {hi}) are not nodes of "
                         f"[0, {st.adj.shape[0]})")
    dev = st.e.device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    insert_cuda.set_cursor(st, lo, None, lo, stream)
    G = GRAPH_INSERTIONS
    reps, rest = divmod(n, G)
    if reps:
        graph = insert_cuda.range_graph(
            st, ("seed", G),
            lambda s: [insert_cuda.closest_bfs_cursor(st, s, False)
                       for _ in range(G)], bfs=G)
        insert_cuda.replay(graph, reps)
    for _ in range(rest):
        insert_cuda.closest_bfs_cursor(st, stream, True)


def run_placement_full(frontend_args, *, num_sequences: int, frontend: str,
                       frontend_static=(), dtype_name: str) -> TreeState:
    """Whole build on uncapped arrays, rows ROW_BLOCK insertions at a
    time; returns the full TreeState."""
    N = num_sequences
    st = init_placement_state(frontend_args, num_sequences=N,
                              frontend=frontend,
                              frontend_static=frontend_static,
                              dtype_name=dtype_name)
    for lo in range(2, N, ROW_BLOCK):
        hi = min(N, lo + ROW_BLOCK)
        rows = _rows(frontend_args, frontend, frontend_static, dtype_name,
                     lo, hi)
        _insert_range(st, lo, hi, rows, N)
    return st


def run_placement(frontend_args, *, num_sequences: int, frontend: str,
                  frontend_static=(), dtype_name: str):
    """Builds the whole placement tree. Returns the final edge arrays
    (e, belong, length)."""
    st = run_placement_full(
        frontend_args, num_sequences=num_sequences, frontend=frontend,
        frontend_static=frontend_static, dtype_name=dtype_name)
    return st.e, st.belong, st.length


# ---------------------------------------------------------------------------
# Checkpoint/resume: the reference's .npz schema, dtypes and fingerprint, so
# a checkpoint written by either package resumes in the other
# ---------------------------------------------------------------------------


def tree_state_to_numpy(st) -> dict:
    """A state (TreeState, or exact.ExactState) -> dict of host numpy
    arrays named as the reference's fields: tensors as arrays, host
    counters (idx, nfb) as 0-d int32, an absent adj as None."""
    out = {}
    for f in type(st).FIELDS:
        v = getattr(st, f)
        if isinstance(v, torch.Tensor):
            out[f] = v.cpu().numpy()
        else:
            out[f] = None if v is None else np.asarray(v, dtype=np.int32)
    return out


def tree_state_from_numpy(d, device) -> TreeState:
    """The reference's TreeState as numpy arrays (jax.device_get of it,
    or its checkpoint .npz) -> TreeState on `device`. adj and nfb are
    optional. A D&C cluster state (dipper_tpu/dc/pipeline.py's vmapped
    build: a leading cluster axis on every array, idx one per cluster)
    gives a TreeState with [C, E] and [C, E, K] arrays; its clusters must
    have taken the same number of steps, so that idx is one int."""
    def t(a, dtype=None):
        # np.array copies: the input may be a read-only device_get view
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    def get(f):
        return d[f] if f in d else None

    adj = get("adj")
    nfb = get("nfb")
    return prepare_kernels(TreeState(
        e=t(d["e"], np.int32), belong=t(d["belong"], np.int32),
        length=t(d["length"]), rev=t(d["rev"], np.int32),
        cdis=t(d["cdis"]), cid=t(d["cid"], np.int32), idx=_one_idx(d["idx"]),
        adj=None if adj is None else t(adj, np.int32),
        nfb=0 if nfb is None else int(nfb)))


def _one_idx(idx) -> int:
    idx = np.unique(np.asarray(idx))
    if idx.size != 1:
        raise ValueError(f"cluster states at different steps (idx {idx})")
    return int(idx[0])


def save_tree_state(path: str, st, next_i: int, num_sequences: int,
                    fingerprint: dict | None = None) -> None:
    """Persist a build state (TreeState here, exact.ExactState likewise)
    atomically (temp file + os.replace, so a crash mid-write cannot
    destroy the previous good checkpoint) with a run fingerprint so a
    resume on mismatched inputs is refused."""
    host = tree_state_to_numpy(st)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(
                f, next_i=next_i, num_sequences=num_sequences,
                state_kind=type(st).__name__,
                fingerprint=json.dumps(fingerprint or {}, sort_keys=True),
                **{f2: v for f2, v in host.items() if v is not None})
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_tree_state(path: str, num_sequences: int, dtype_name: str,
                    fingerprint: dict | None = None, *, device,
                    cls=TreeState):
    """Checkpoint -> (state of class `cls` on `device`, next insertion
    id)."""
    d = np.load(path)
    if int(d["num_sequences"]) != num_sequences:
        raise SystemExit(
            f"tree-state mismatch: checkpoint has N={int(d['num_sequences'])},"
            f" run wants N={num_sequences}")
    if "state_kind" in d and str(d["state_kind"]) != cls.__name__:
        raise SystemExit(
            f"tree-state mismatch: checkpoint holds {d['state_kind']}, "
            f"run wants {cls.__name__} (exact vs k-closest placement "
            "states are not interchangeable)")
    if fingerprint is not None:
        saved = json.loads(str(d["fingerprint"])) if "fingerprint" in d else {}
        want = json.loads(json.dumps(fingerprint, sort_keys=True))
        if saved != want:
            raise SystemExit(
                "tree-state mismatch: checkpoint fingerprint "
                f"{saved!r} != run fingerprint {want!r}; refusing to "
                "resume on mismatched inputs")
    missing = [f for f in cls.FIELDS
               if f not in d and f not in ("adj", "nfb")]
    if missing:
        raise SystemExit(f"tree-state file is missing arrays: {missing}")
    st = cls.from_numpy(d, device)
    if cls is TreeState and st.adj is None:
        # (an ExactState's table is rebuilt by ExactState.from_numpy)
        # pre-adjacency checkpoint: rebuild the out-edge table — only
        # if out-degree <= 3 everywhere (a multifurcating backbone
        # would overflow the 3-slot rows; the dense BFS handles it)
        bel = np.asarray(d["belong"])
        deg_ok = (np.bincount(bel[bel >= 0]).max(initial=0) <= 3
                  if (bel >= 0).any() else True)
        if deg_ok:
            st.adj = adjacency_from_edges(st.belong, 2 * num_sequences)
    dtype = torch_dtype(dtype_name)
    for f in ("length", "cdis"):
        if f in cls.FIELDS:
            setattr(st, f, getattr(st, f).to(dtype))
    return (prepare_kernels(st) if cls is TreeState else st), int(d["next_i"])


# ---------------------------------------------------------------------------
# Chunked driver with prefix caps
#
# Insertions lo..hi-1 can only ever touch edge slots < 4*hi and bank rows
# < hi (node ids still span [0, 2N), so adj keeps full width). Each range
# therefore runs on pow2-bucketed prefixes of the [E] and [E, K] arrays and
# of the bank; trailing slots are sentinel-initialized exactly like unused
# slots of the full arrays, so every result is bitwise identical to the
# uncapped build. The pow2 buckets and the row budget keep the reference's
# range boundaries, so checkpoints land at the same insertions.
# ---------------------------------------------------------------------------

_CAP_MIN = 2048

# resident distance-rows budget per insert range; ranges shrink below the
# checkpoint chunk when cap * range rows would exceed it
_ROWS_BYTES = 3 * 2 ** 29


def _cap_for(hi: int, N: int) -> int:
    c = _CAP_MIN
    while c < hi:
        c *= 2
    return min(N, c)


def _resize_state(st: TreeState, E: int) -> TreeState:
    """The state with its edge arrays cut (views) or sentinel-padded
    (copies) to E slots; adj is node-indexed and keeps its width."""
    cur = st.e.shape[0]
    if cur == E:
        return st
    if cur > E:
        return prepare_kernels(dataclasses.replace(
            st, e=st.e[:E], belong=st.belong[:E], length=st.length[:E],
            rev=st.rev[:E], cdis=st.cdis[:E], cid=st.cid[:E]))
    p = E - cur

    def pad(x, fill):
        return torch.cat([x, torch.full((p,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    return prepare_kernels(dataclasses.replace(
        st, e=pad(st.e, -1), belong=pad(st.belong, -1),
        length=pad(st.length, 0), rev=pad(st.rev, -1),
        cdis=pad(st.cdis, SENT_DIS), cid=pad(st.cid, -1)))


def run_placement_chunked(frontend_args, *, num_sequences: int, frontend: str,
                          frontend_static=(), dtype_name: str,
                          chunk: int = 8192, save_state: str | None = None,
                          load_state: str | None = None,
                          fingerprint: dict | None = None,
                          use_caps: bool = True, log=None) -> TreeState:
    """Whole build in bounded insert ranges on the frontend's device,
    checkpointing every `chunk` insertions; identical output to
    run_placement_full. Each range's distance rows are computed in one
    call before its insertion loop."""
    N = num_sequences
    dev = frontend_args[0].device
    itemsize = torch.empty((), dtype=torch_dtype(dtype_name)).element_size()
    fp = dict(fingerprint or {})
    fp.update(frontend=frontend, dtype=dtype_name)
    if load_state and os.path.exists(load_state):
        st, i0 = load_tree_state(load_state, N, dtype_name, fp, device=dev)
        if log:
            log(f"Resumed placement at insertion {i0}/{N}")
    else:
        st = init_placement_state(frontend_args, num_sequences=N,
                                  frontend=frontend,
                                  frontend_static=frontend_static,
                                  dtype_name=dtype_name)
        i0 = 2
    B = ROW_BLOCK

    def _range_of(lo):
        """(hi, cap) of the insert range starting at lo."""
        hi_ck = min(N, lo + chunk)
        cap = _cap_for(hi_ck, N) if use_caps else N
        if frontend == "matrix":  # rows are views of the resident matrix
            return hi_ck, cap
        ce = max(B, min(chunk, (_ROWS_BYTES // (itemsize * cap)) // B * B))
        return min(hi_ck, lo + ce), cap

    cap = None
    fa_cap = frontend_args
    captures = insert_cuda.GRAPH_CAPTURES
    rows_s = ins_s = 0.0
    steady = 0.0
    lo = i0
    while lo < N:
        hi, want = _range_of(lo)
        t0 = time.time()
        if want != cap:
            cap = want
            fa_cap = (_slice_frontend(frontend_args, frontend, cap)
                      if use_caps else frontend_args)
            st = _resize_state(st, 4 * cap)
        rows = _rows(fa_cap, frontend, frontend_static, dtype_name, lo, hi)
        synchronize(dev)
        t_rows = time.time() - t0
        _insert_range(st, lo, hi, rows, N)
        del rows
        synchronize(dev)
        t_ins = time.time() - t0 - t_rows
        rows_s += t_rows
        ins_s += t_ins
        steady = t_ins / max(hi - lo, 1) * 1e3
        if log:
            per = (t_rows + t_ins) / max(hi - lo, 1) * 1e3
            rows_ms = t_rows / max(hi - lo, 1) * 1e3
            log(f"Inserted {hi}/{N} ({per:.2f} ms/insertion, rows "
                f"{rows_ms:.2f})")
        # checkpoint when a range crosses the chunk grid (ranges can be
        # shorter than `chunk` under the rows-buffer budget); checkpoints
        # always hold the full [4N] layout
        if save_state and (hi == N or hi // chunk > lo // chunk):
            save_tree_state(save_state, _resize_state(st, 4 * N), hi, N, fp)
            if log:
                log(f"Checkpointed placement at insertion {hi}/{N}")
        lo = hi
    if log:
        log(f"Placement rows: {rows_s * 1e3:.1f} ms, insertions: "
            f"{ins_s * 1e3:.1f} ms (steady {steady:.3f} ms/insertion); "
            f"graph captures {insert_cuda.GRAPH_CAPTURES - captures}")
    return _resize_state(st, 4 * N)


# ---------------------------------------------------------------------------
# --add: queries onto a loaded backbone
# ---------------------------------------------------------------------------


def run_add_queries(frontend_args, e0, belong0, length0, rev0, *,
                    num_sequences: int, backbone_size: int, frontend: str,
                    frontend_static=(), dtype_name: str, use_adj: bool = True,
                    log=None):
    """--add: seed closest lists from the loaded backbone (one BFS per
    backbone leaf, initializeDeviceArrays :241-260), then insert queries
    i = B..N-1 with the edge cursor at 4B-4 (addQuery :887). e0, belong0,
    length0, rev0: the backbone's [4N] edge arrays
    (api.backbone_tree_to_arrays) on the frontend's device. Returns the
    final (e, belong, length).

    `use_adj=False` skips the [M,3] adjacency table and runs the dense
    BFS throughout — required for multifurcating backbones (parse_newick
    accepts them), whose out-degree > 3 would overflow the 3-slot table.
    The caller checks degrees host-side."""
    N = num_sequences
    B = backbone_size
    dev = frontend_args[0].device
    dtype = torch_dtype(dtype_name)
    E = 4 * N
    # copies: the state is updated in place, the caller's arrays are not
    st = prepare_kernels(TreeState(
        e=e0.clone(), belong=belong0.clone(),
        length=length0.to(dtype, copy=True), rev=rev0.clone(),
        cdis=torch.full((E, K), SENT_DIS, dtype=dtype, device=dev),
        cid=torch.full((E, K), -1, dtype=torch.int32, device=dev),
        idx=4 * B - 4,
        adj=adjacency_from_edges(belong0, 2 * N) if use_adj else None))
    captures = insert_cuda.GRAPH_CAPTURES
    t0 = time.time()
    if uses_insert_kernel(st):
        _replay_seeding(st, 0, B)
    else:
        for i in range(B):
            update_closest_bfs(st, i, 2 * N)
    synchronize(dev)
    t_seed = time.time() - t0
    # rows of a block of queries against the whole bank, sized as an
    # insert range's
    step = max(ROW_BLOCK, (_ROWS_BYTES // (st.length.element_size() * N))
               // ROW_BLOCK * ROW_BLOCK)
    rows_s = ins_s = 0.0
    for lo in range(B, N, step):
        hi = min(N, lo + step)
        t0 = time.time()
        rows = _rows(frontend_args, frontend, frontend_static, dtype_name,
                     lo, hi)
        synchronize(dev)
        t1 = time.time()
        _insert_range(st, lo, hi, rows, N)
        synchronize(dev)
        rows_s += t1 - t0
        ins_s += time.time() - t1
    if log:
        log(f"Backbone of {B} seeded in: {t_seed * 1e3:.1f} ms; {N - B} "
            f"queries: rows {rows_s * 1e3:.1f} ms, insertions "
            f"{ins_s * 1e3:.1f} ms; graph captures "
            f"{insert_cuda.GRAPH_CAPTURES - captures}")
    return st.e, st.belong, st.length


# ---------------------------------------------------------------------------
# Host-side finalization
# ---------------------------------------------------------------------------


def edges_to_newick(e, belong, length, names, num_sequences: int,
                    root: int | None = None) -> str:
    """Serialize the edge arrays (printTree recursion,
    src/placement_close_k.cu:568-643; root = node N)."""
    from dipper_tpu_torch.io.newick import edge_arrays_newick

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    N = num_sequences
    return edge_arrays_newick(N, names, host(belong), host(e), host(length),
                              N if root is None else root)
