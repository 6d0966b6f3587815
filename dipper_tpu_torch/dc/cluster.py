"""Divide-and-conquer phase 3: the local cluster builds.

Behavioral spec as dipper_tpu/dc/pipeline.py:135-447 (findClusterTreeDC,
src/divide_and_conquer/placement_close_k.cu:1251-1535): each cluster
builds in a LOCAL index space. Nodes 0 and 1 are the endpoints of its
backbone edge, edges 0 and 1 that edge's two directions with the
witness lists of the backbone state (witness labels 0..9); member kq is
leaf 2 + kq, its middle node 2 + cmax + kq, its witness label 10 + kq,
and its four edges take slots 2 + 4kq .. 5 + 4kq. A member scores only
slots already inserted that are scoreable in the global id order (mask
order, `mask_order_perm`), attaches with explicit middle and outside
nodes, and its witness BFS does not expand through the cluster edge's
endpoints as they stand after the splice.

PyTorch design. `build_clusters` builds a chunk of clusters of one size
bucket from their distances Dq [C, cmax, W]; the state is a TreeState
whose arrays carry a leading cluster axis ([C, E], [C, E, K], E = 2 +
4 cmax). On the card the whole chunk is one launch of kernel 8b
(csrc/dc_cluster_build.cu, through cluster_cuda.build_chunk): a warp or
a block a cluster, each with an adjacency table, no host sync. On the CPU
(and as the kernel's yardstick on the card) `build_clusters_plain` steps all
clusters together in tensor code: scoring, splice and the dense BFS
written over the cluster axis, one `nonzero` (host sync) a BFS level for
the whole chunk. Clusters come sorted by size, so the ones still
inserting at step kq are a suffix, stepped as views; the others are left
as they are (the JAX package's `kq < sz` mask).

Clusters of _STREAM_CLUSTER_MIN members and more run `build_streamed`:
one at a time, distance rows a block at a time from `block_fn`, an
adjacency table. On the card a row block is one launch of kernel 8a
(csrc/dc_stream_block.cu, through cluster_cuda.stream_block: every
member's masked score, splice, flags and walk on a thread-block cluster):
the host syncs only in `block_fn`. On the CPU `_score_masked`, the plain
splice and the compact BFS of placement/kclosest.py run a member at a
time. dc/cluster_model.py models both kernels' plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dipper_tpu_torch.dc import cluster_cuda
from dipper_tpu_torch.placement import kclosest
from dipper_tpu_torch.placement.kclosest import K, SENT_DIS, TreeState

# steps (member indices kq stepped over a chunk's clusters) and host syncs
# (BFS levels: 0 on the kernel route) of this process's batched builds;
# chip_smoke.py resets and reads them
BFS_LEVELS = 0
STEPS = 0


def mask_order_perm(cmax: int) -> np.ndarray:
    """Mask-scan order -> local edge id. Positions: 0 -> edge 0 (eid),
    1 -> edge 1 (otheid), then per insertion g: idx-1, idx-2, idx-3,
    idx-4 == local edges 5+4g, 4+4g, 3+4g, 2+4g
    (updateClusterInfoDC :567-569)."""
    perm = np.zeros(2 + 4 * cmax, dtype=np.int32)
    perm[0] = 0
    perm[1] = 1
    for g in range(cmax):
        base = 2 + 4 * g
        perm[2 + 4 * g : 6 + 4 * g] = [base + 3, base + 2, base + 1, base]
    return perm


def new_group_scoreable() -> np.ndarray:
    """belong>e in GLOBAL numbering for the 4 edges of an insertion:
    middles exceed every prior id, so i0 (middle->x), i1 (middle->y),
    i3 (middle->outside) are scoreable and i2 (outside->middle) is not."""
    return np.array([True, True, False, True])


@dataclasses.dataclass
class _Order:
    """A bucket width's mask order on the device: perm [E], the insertion
    group of each mask position (-1 for the cluster edge) [E], and the
    scoreable flags of a new group [4]."""
    perm: torch.Tensor
    pos_group: torch.Tensor
    grp: torch.Tensor

    @classmethod
    def of(cls, cmax: int, device) -> "_Order":
        pos_group = np.concatenate([[-1, -1],
                                    np.repeat(np.arange(cmax), 4)])
        return cls(torch.from_numpy(mask_order_perm(cmax)).long().to(device),
                   torch.from_numpy(pos_group).to(device),
                   torch.from_numpy(new_group_scoreable()).to(device))


def cluster_init_state(cd_init, cid_init, lens_init, cmax: int,
                       with_adj: bool = False):
    """Initial local cluster trees. cd_init [C, 2, K] (float), cid_init
    [C, 2, K] (int32), lens_init [C, 2] tensors -> (TreeState with [C, E]
    arrays, scoreable [C, E] bool). `with_adj` adds the [C, 2 + 2 cmax, 3]
    adjacency tables of the compact BFS."""
    C = cd_init.shape[0]
    dev, dtype = cd_init.device, cd_init.dtype
    E = 2 + 4 * cmax
    i32 = dict(dtype=torch.int32, device=dev)
    e = torch.full((C, E), -1, **i32)
    belong = torch.full((C, E), -1, **i32)
    rev = torch.full((C, E), -1, **i32)
    e[:, 0], e[:, 1] = 1, 0
    belong[:, 0], belong[:, 1] = 0, 1
    rev[:, 0], rev[:, 1] = 1, 0
    length = torch.zeros((C, E), dtype=dtype, device=dev)
    length[:, :2] = lens_init
    cdis = torch.full((C, E, K), SENT_DIS, dtype=dtype, device=dev)
    cdis[:, :2] = cd_init
    cid = torch.full((C, E, K), -1, **i32)
    cid[:, :2] = cid_init
    scoreable = torch.zeros((C, E), dtype=torch.bool, device=dev)
    scoreable[:, 0] = True
    if not with_adj:
        return TreeState(e=e, belong=belong, length=length, rev=rev,
                         cdis=cdis, cid=cid, idx=2), scoreable
    adj = torch.full((C, 2 + 2 * cmax, 3), -1, **i32)
    adj[:, 0, 0], adj[:, 1, 0] = 0, 1
    return TreeState(e=e, belong=belong, length=length, rev=rev, cdis=cdis,
                     cid=cid, idx=2, adj=adj), scoreable


def one_cluster(st: TreeState, scoreable):
    """The first cluster of a batched state as a state of one tree: views
    of its arrays ([E], [E, K], adjacency [2 + 2 cmax, 3]) and flags [E]
    (a streamed build's state)."""
    return TreeState(e=st.e[0], belong=st.belong[0], length=st.length[0],
                     rev=st.rev[0], cdis=st.cdis[0], cid=st.cid[0],
                     idx=st.idx,
                     adj=None if st.adj is None else st.adj[0]), scoreable[0]


def _score_masked(st: TreeState, scoreable, rows, kq: int, order: _Order):
    """Masked-edge scoring of member kq of every cluster
    (calculateBranchLengthSpecialIDDC :180-234): arrays [C, E], rows
    [C, W] -> (eid, frac, add), each [C], the first minimum in mask
    order over scoreable slots of groups already inserted."""
    C, E = st.e.shape
    ids = st.cid.clamp(min=0).long().reshape(C, E * K)
    got = torch.gather(rows, 1, ids).reshape(C, E, K)
    dv = torch.where(st.cid != -1, got - st.cdis, float("-inf"))
    side = dv.amax(dim=-1).clamp(min=0.0)
    dis2 = torch.gather(side, 1, st.rev.clamp(min=0).long())
    addi, dis1 = kclosest.clamp_sequence(side, dis2, st.length)
    live = (order.pos_group < kq) | (order.pos_group < 0)
    valid = scoreable[:, order.perm] & live
    score = torch.where(valid, addi[:, order.perm], SENT_DIS)
    frac = torch.where(valid, dis1[:, order.perm], 0.0)
    pos = torch.argmin(score, dim=1, keepdim=True)
    return (order.perm[pos[:, 0]], frac.gather(1, pos)[:, 0],
            score.gather(1, pos)[:, 0])


def _splice_batched(st: TreeState, eid, frac, add, middle: int,
                    outside: int) -> torch.Tensor:
    """kclosest.splice for every cluster at once ([C, E] arrays, eid
    frac add [C]; the new slots are st.idx .. st.idx + 3 in all of them).
    Returns the reverse slot of each chosen edge."""
    C = st.e.shape[0]
    dev = st.e.device
    ar = torch.arange(C, device=dev)
    i0 = st.idx
    xe = eid
    ye = st.rev[ar, xe].long()
    x, y = st.belong[ar, xe], st.e[ar, xe]
    orig = st.length[ar, xe]
    rest = orig - frac
    cd_xe, id_xe = st.cdis[ar, xe], st.cid[ar, xe]
    cd_ye, id_ye = st.cdis[ar, ye], st.cid[ar, ye]
    # (cd + orig) - frac, the reference's association (:398)
    cd_i0 = torch.where(id_ye != -1, cd_ye + orig[:, None] - frac[:, None],
                        SENT_DIS)
    cd_i1 = torch.where(id_xe != -1, cd_xe + frac[:, None], SENT_DIS)
    # stable merge of (middle->y then middle->x) lists, as
    # kclosest._insert_merge_lists does one pair at a time
    vals = torch.cat([cd_i1, cd_i0], dim=1)
    order = torch.argsort(vals, dim=1, stable=True)[:, :K]
    cd_i3 = vals.gather(1, order)
    id_i3 = torch.cat([id_xe, id_ye], dim=1).gather(1, order)

    def full(v):
        return torch.full((C,), v, dtype=torch.int32, device=dev)

    mid, out = full(middle), full(outside)
    st.e[ar, xe] = mid
    st.e[ar, ye] = mid
    st.length[ar, xe] = frac
    st.length[ar, ye] = rest
    st.rev[ar, xe] = full(i0)
    st.rev[ar, ye] = full(i0 + 1)
    st.e[:, i0:i0 + 4] = torch.stack([x, y, mid, out], dim=1)
    st.belong[:, i0:i0 + 4] = torch.stack([mid, mid, out, mid], dim=1)
    st.rev[:, i0:i0 + 4] = torch.stack(
        [xe.to(torch.int32), ye.to(torch.int32), full(i0 + 3), full(i0 + 2)],
        dim=1)
    st.length[:, i0:i0 + 4] = torch.stack([frac, rest, add, add], dim=1)
    st.cdis[:, i0:i0 + 4] = torch.stack(
        [cd_i0, cd_i1, torch.full_like(cd_i0, SENT_DIS), cd_i3], dim=1)
    st.cid[:, i0:i0 + 4] = torch.stack(
        [id_ye, id_xe, torch.full_like(id_ye, -1), id_i3], dim=1)
    st.idx += 4
    return ye


def _bfs_dense_batched(st: TreeState, leaf: int, num_nodes: int,
                       label: int, blocked) -> None:
    """kclosest._update_closest_bfs_dense for every cluster at once, from
    local node `leaf`, recording `label`; blocked [C, 2] nodes are
    dequeued but not expanded. One `nonzero` (host sync) a level, for
    all clusters together."""
    global BFS_LEVELS
    C, E = st.e.shape
    M = num_nodes
    dev = st.e.device
    ar = torch.arange(C, device=dev)
    # (writes of a Python scalar through tensor indices copy it to the
    # card and sync; fill and scatter take it as an argument)
    frontier = torch.zeros((C, M), dtype=torch.bool, device=dev)
    frontier[:, leaf] = True
    block = torch.zeros((C, M), dtype=torch.bool, device=dev)
    block.scatter_(1, blocked, True)
    from_node = torch.full((C, M), -1, dtype=torch.int32, device=dev)
    distx = torch.zeros((C, M), dtype=st.length.dtype, device=dev)
    src = st.belong
    used = src >= 0
    srcc = src.clamp(min=0).long()
    while True:
        act = (used & torch.gather(frontier & ~block, 1, srcc)
               & (st.e != torch.gather(from_node, 1, srcc)))
        d = torch.gather(distx, 1, srcc)
        pos = (st.cdis <= d[..., None]).sum(dim=-1)
        ci, ei = (act & (pos < K)).nonzero(as_tuple=True)  # host sync
        BFS_LEVELS += 1
        if ci.numel() == 0:
            return
        dsel = d[ci, ei]
        new_cd, new_id = kclosest._insert_sorted(
            st.cdis[ci, ei], st.cid[ci, ei], pos[ci, ei], dsel, label)
        st.cdis[ci, ei] = new_cd
        st.cid[ci, ei] = new_id
        # a node of a tree is reached along one path: no collisions
        dst = st.e[ci, ei].long()
        frontier = torch.zeros((C, M), dtype=torch.bool, device=dev)
        frontier.view(-1).index_fill_(0, ci * M + dst, True)
        from_node[ci, dst] = src[ci, ei]
        distx[ci, dst] = dsel + st.length[ci, ei]


def cluster_step(st: TreeState, scoreable, kq: int, rows, cmax: int,
                 order: _Order | None = None) -> None:
    """Member kq of every cluster of `st` ([C, E] arrays at st.idx =
    2 + 4kq) given its distance rows [C, W] to the cluster's witnesses, in
    place (_cluster_step, dipper_tpu/dc/pipeline.py:180-225)."""
    global STEPS
    order = order or _Order.of(cmax, st.e.device)
    eid, frac, add = _score_masked(st, scoreable, rows, kq, order)
    middle, outside = 2 + cmax + kq, 2 + kq
    base = st.idx
    ye = _splice_batched(st, eid, frac, add, middle, outside)
    scoreable.scatter_(1, torch.stack([eid, ye], dim=1), False)
    scoreable[:, base:base + 4] = order.grp
    # the endpoints of slot 0 (the cluster edge) as they stand after the
    # splice, as the reference reads them when the BFS starts (:329)
    blocked = torch.stack([st.belong[:, 0], st.e[:, 0]], dim=1).long()
    _bfs_dense_batched(st, outside, 2 + 2 * cmax, 10 + kq, blocked)
    STEPS += 1


def _views(st: TreeState, scoreable, c0: int):
    return (dataclasses.replace(
        st, e=st.e[c0:], belong=st.belong[c0:], length=st.length[c0:],
        rev=st.rev[c0:], cdis=st.cdis[c0:], cid=st.cid[c0:]), scoreable[c0:])


def uses_cluster_kernel(Dq: torch.Tensor) -> bool:
    """Whether a chunk's build goes to kernel 8b: its distances are on the
    card."""
    return Dq.device.type == "cuda"


def build_clusters(Dq, cd_init, cid_init, lens_init, sizes, cmax: int):
    """The local builds of C clusters at once (_cluster_build, vmapped).
    Dq [C, cmax, W] distances (member k vs witness w) on the build's
    device, cd_init/cid_init [C, 2, K] and lens_init [C, 2] tensors there,
    sizes: host ints, ascending, each in 1..cmax. Returns the local
    (e, belong, length), each [C, 2 + 4 cmax]. On the card one launch of
    kernel 8b and no host sync; on the CPU the plain version."""
    global STEPS
    sizes = np.asarray(sizes)
    if len(sizes) and (np.any(np.diff(sizes) < 0) or sizes[0] < 1
                       or sizes[-1] > cmax):
        raise ValueError("cluster sizes must ascend within 1..cmax")
    if not uses_cluster_kernel(Dq):
        return build_clusters_plain(Dq, cd_init, cid_init, lens_init, sizes,
                                    cmax)
    st, scoreable = cluster_init_state(cd_init, cid_init, lens_init, cmax,
                                       with_adj=True)
    cluster_cuda.build_chunk(st, scoreable, Dq,
                             cluster_cuda.upload_sizes(sizes, Dq.device),
                             cmax)
    STEPS += int(sizes.max(initial=0))
    return st.e, st.belong, st.length


def build_clusters_plain(Dq, cd_init, cid_init, lens_init, sizes,
                         cmax: int):
    """build_clusters in tensor code (the CPU path, and kernel 8b's
    yardstick on the card): cluster_step a member index over the
    chunk's clusters still inserting, one host sync a BFS level."""
    sizes = np.asarray(sizes)
    st, scoreable = cluster_init_state(cd_init, cid_init, lens_init, cmax)
    order = _Order.of(cmax, Dq.device)
    for kq in range(int(sizes.max(initial=0))):
        c0 = int(np.searchsorted(sizes, kq, side="right"))  # sizes > kq
        sv, scv = _views(st, scoreable, c0)
        sv.idx = 2 + 4 * kq
        cluster_step(sv, scv, kq, Dq[c0:, kq], cmax, order)
    return st.e, st.belong, st.length


def uses_stream_kernels(st: TreeState) -> bool:
    """Whether a streamed cluster's members go to kernel 8a: its state is
    on the card (kclosest.uses_insert_kernel)."""
    return kclosest.uses_insert_kernel(st)


def build_streamed(block_fn, cd_init, cid_init, lens_init, size: int,
                   cmax: int, row_block: int):
    """One big cluster's build with streamed distance rows
    (_cluster_build_stream, _stream_range_run): `block_fn(start)` gives
    the [<= row_block, W] rows of members start.. (the last block
    ragged), computed when the loop reaches them, so no [cmax, W] tensor
    is held. The state has an adjacency table. On the card each row block
    is one launch of kernel 8a: no host sync outside `block_fn`. On the
    CPU `_score_masked`, the plain splice and the compact BFS run a member
    at a time, with one host sync for the chosen edge. cd_init/cid_init
    [2, K], lens_init [2]. Returns the local (e, belong, length), each
    [2 + 4 cmax]."""
    st, scoreable = one_cluster(*cluster_init_state(
        cd_init[None], cid_init[None], lens_init[None], cmax, with_adj=True))
    if uses_stream_kernels(st):
        _stream_by_kernels(st, scoreable, block_fn, size, cmax, row_block)
    else:
        _stream_plain(st, scoreable, block_fn, size, cmax, row_block)
    return st.e, st.belong, st.length


def _stream_plain(st: TreeState, scoreable, block_fn, size: int, cmax: int,
                  row_block: int) -> None:
    """build_streamed's members by tensor code (the CPU path, and the
    kernels' yardstick on the card)."""
    order = _Order.of(cmax, st.e.device)
    blk = None
    for kq in range(size):
        if kq % row_block == 0:
            blk = block_fn(kq)
        stream_member_plain(st, scoreable, blk[kq % row_block], kq, cmax,
                            order)


def stream_member_plain(st: TreeState, scoreable, row, kq: int, cmax: int,
                        order: _Order) -> tuple:
    """Member kq of a streamed cluster by tensor code, in place (st.idx =
    2 + 4 kq): the masked score, the splice, the flags, the BFS. Returns
    (eid, frac, add), frac and add as [] tensors."""
    batched = dataclasses.replace(
        st, e=st.e[None], belong=st.belong[None], length=st.length[None],
        rev=st.rev[None], cdis=st.cdis[None], cid=st.cid[None], adj=None)
    eid, frac, add = _score_masked(batched, scoreable[None], row[None], kq,
                                   order)
    base = st.idx
    e0 = eid[0]
    xe, x, y, ye = torch.stack(
        (e0, st.belong[e0], st.e[e0], st.rev[e0])).tolist()  # host sync
    kclosest.splice(st, xe, frac[0], add[0], 0, 0, (x, y, ye),
                    middle=2 + cmax + kq, outside=2 + kq)
    scoreable[xe] = False
    scoreable[ye] = False
    scoreable[base:base + 4] = order.grp
    kclosest._update_closest_bfs_plain(
        st, 2 + kq, 2 + 2 * cmax, label=10 + kq,
        blocked_nodes=(st.belong[0], st.e[0]))
    return xe, frac[0], add[0]


def stream_offsets(cmax: int) -> tuple:
    """A cluster's offsets of member kq's outside node, middle node and
    label (2 + kq, 2 + cmax + kq, 10 + kq), as insert_cuda.
    insert_step_cursor takes them."""
    return (2, 2 + cmax, 10)


def _stream_by_kernels(st: TreeState, scoreable, block_fn, size: int,
                       cmax: int, row_block: int) -> None:
    """build_streamed's members on the card: one launch of kernel 8a a row
    block. Every launch is on the current stream, so the caching allocator
    reuses a row block's memory only after the launch that reads it."""
    n_edges = st.e.shape[0]
    if 2 + 4 * size > n_edges:
        raise ValueError(f"{size} members do not fit {n_edges} edge slots")
    for kq0 in range(0, size, row_block):
        blk = block_fn(kq0)
        n = min(row_block, size - kq0)
        if blk.shape[0] < n:
            raise ValueError(f"{blk.shape[0]} rows for members {kq0}.."
                             f"{kq0 + n - 1}")
        cluster_cuda.stream_block(st, scoreable, blk[:n], kq0, cmax)
    st.idx += 4 * size
