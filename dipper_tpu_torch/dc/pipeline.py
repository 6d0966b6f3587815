"""Divide-and-conquer pipeline (N >= 1M auto mode; -m 3).

Behavioral spec as dipper_tpu/dc/pipeline.py (itself
src/divide_and_conquer/placement_close_k.cu):
- Phase 1 (findBackboneTreeDC :731-935): k-closest placement of the
  first B = N/20 taxa.
- Phase 2 (findClustersDC :937-1113): for each remaining taxon, its best
  backbone edge (the same scoring, the tree untouched) -> cluster id.
- Phase 3 (findClusterTreeDC :1251-1535): every cluster builds in a local
  index space (dc/cluster.py); global ids come back by arithmetic on
  cluster-size prefix sums: middle node k of cluster c is
  N + B - 1 + prefix[c] + k, and its edges follow slot 4B - 4.

PyTorch design. Phase 1 is placement/kclosest.py's build. Phase 2 scores
chunks of [Q, B] distance rows at once with `score_edges_rows`: on the card
the backbone's valid slots are packed once (one launch of
csrc/dc_assign.cu's pack), then one launch of kernel 10 a chunk over the
records, Q sized from the rows' bytes, each chunk's slots written into one
device buffer that is
copied to the host once, after the last chunk (no host sync in between);
on the CPU its plain version, Q sized from the bytes of its [Q, E, K]
witness gather. Phase 3 sorts the clusters by size
into pow2 buckets (which bound the padding) and builds each bucket's
clusters together, PHASE3_BUDGET // cmax_b at a time, from one [c, cmax_b,
W] distance tensor: for mash the per-cluster count kernel
(csrc/mash_cluster_inter.cu, one launch a chunk), for a matrix a double
gather, for aligned sequences codes staged from the host; on the card a
chunk's build is one launch of csrc/dc_cluster_build.cu. Clusters of
_STREAM_CLUSTER_MIN members and more build one at a time with rows
streamed _STREAM_ROW_BLOCK at a time (on the card, one launch of
csrc/dc_stream_block.cu a row block). Each bucket's
log line counts its distance launches, steps, host syncs (BFS levels)
and build-kernel launches. Assembly and Newick are host NumPy,
as in the JAX package.

Sharded (mesh, parallel/sharded.py; the JAX package's _shard_batch over
the same two phases): phase 1 runs on every rank alike. In phase 2 each
rank scores one contiguous share of all the queries, chunk by chunk, and
the cluster ids are all-gathered once (a row's slot does not depend on its
chunk). In phase 3 each rank takes a contiguous share of
each size bucket's clusters, batched or streamed (streamed clusters are
dealt out whole), builds them, and the buckets' edge arrays are
all-gathered in cluster order; assembly runs on every rank, so every rank
holds the same tree. A cluster's build does not depend on which clusters
share its batch, so the bytes are the single-process build's.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np
import torch

from dipper_tpu_torch.dc import cluster
from dipper_tpu_torch.placement import kclosest
from dipper_tpu_torch.placement.kclosest import K
from dipper_tpu_torch.utils.device import synchronize, torch_dtype
from dipper_tpu_torch.utils.params import Param

# Memory budgets (tests shrink them to force the multi-chunk paths):
# queries per phase-2 chunk at most, and bytes of one chunk's [Q, B] rows
# on the card (kernel 10) or of its [Q, E, K] witness gather on the CPU
# (the plain version); cluster members (clusters x cmax_b) per phase-3 build;
# members from which a cluster builds alone with streamed rows (bounds
# the quadratic [cmax, W] distance tensor), and its rows per block.
PHASE2_CHUNK = 4096
PHASE2_BYTES = 1 << 28
PHASE3_BUDGET = 1 << 16
_STREAM_CLUSTER_MIN = 1024
_STREAM_ROW_BLOCK = 256

last_debug = None


def _log(m):
    print(m, file=sys.stderr)


def build_dc_tree_from_matrix(D, names, params: Param, *, device,
                              log=None, mesh=None) -> str:
    """D&C from a distance matrix (an extension over the reference, which
    rejects matrix input in D&C mode, as the CLI does)."""
    return build_dc_tree(None, names, params, matrix=D, device=device,
                         log=log, mesh=mesh)


def _frontend(seqs, params: Param, matrix, device, dtype, log):
    """(frontend, payload, backbone args, frontend_static) for the run."""
    B = params.backbone_size
    if matrix is not None:
        Dm = torch.from_numpy(np.asarray(matrix)).to(dtype).to(device)
        return "matrix", Dm, (Dm[:B, :B],), ()
    if params.in_format == "r":
        from dipper_tpu_torch.distance.mash import mash_rank_bank

        ranks = mash_rank_bank(seqs, params, device, log=log)
        return ("mash", ranks, (ranks[:B],),
                (params.kmer_size, params.sketch_size))
    if params.in_format == "m":
        # the aligned bank stays on the host (dc/msa.cu's pattern): the
        # backbone's codes live on the device, query blocks and cluster
        # gathers upload on demand
        from dipper_tpu_torch.distance.msa import nongap_counts
        from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes

        codes_host, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
        codes_bb = torch.from_numpy(codes_host[:B]).to(device)
        return ("msa", codes_host,
                (codes_bb, nongap_counts(codes_bb, params.dtype)),
                (params.distance_type,))
    raise SystemExit("Error: Input type must be unaligned or aligned for "
                     "clustering based approach")


def _phase2_rows(frontend, payload, bb_args, params: Param, q0: int,
                 q1: int, device):
    """[q1 - q0, B] distance rows of taxa q0..q1-1 to the backbone."""
    B = params.backbone_size
    if frontend == "matrix":
        return payload[q0:q1, :B]
    if frontend == "mash":
        from dipper_tpu_torch.distance.mash import mash_pairwise

        return mash_pairwise(payload[:B], payload[q0:q1],
                             k=params.kmer_size,
                             sketch_size=params.sketch_size,
                             dtype_name=params.dtype)
    from dipper_tpu_torch.distance.msa import msa_tiled_block, nongap_counts

    codes_q = torch.from_numpy(payload[q0:q1])
    if torch.device(device).type == "cuda":
        # staged through pinned memory: an upload without a host sync
        codes_q = codes_q.pin_memory().to(device, non_blocking=True)
    return msa_tiled_block(codes_q, nongap_counts(codes_q, params.dtype),
                           *bb_args, distance_type=params.distance_type,
                           dtype_name=params.dtype)


def _pair_distances(frontend, payload, params: Param, wit, mem, device):
    """[c, cmax, W] distances Dq[c, k, w] = d(witness w placed, member k
    new) of a chunk of clusters; wit [c, W], mem [c, cmax] host ids, the
    witness lists ending with the member lists (wit = [head, mem], as
    phase 3 builds them)."""
    dtype = params.dtype
    if frontend == "mash":
        from dipper_tpu_torch.distance.mash import (inter_to_dist,
                                                    mash_cluster_inter)

        Q = mem.shape[1]
        assert wit.shape[1] >= Q, (wit.shape, mem.shape)
        wit_d = torch.from_numpy(wit.astype(np.int32)).to(device)
        # mem as a view of the witness lists' tail: the kernel then
        # stages those rows once
        inter = mash_cluster_inter(payload, wit_d, wit_d[:, -Q:],
                                   sketch_size=params.sketch_size)
        return inter_to_dist(inter, params.kmer_size, params.sketch_size,
                             dtype)
    if frontend == "matrix":
        w = torch.from_numpy(wit).to(device)
        m = torch.from_numpy(mem).to(device)
        return payload[m[:, :, None], w[:, None, :]]
    from dipper_tpu_torch.distance.msa import (_block_distance,
                                               nongap_counts,
                                               one_hot_channels)

    codes_w = torch.from_numpy(payload[wit]).to(device)    # [c, W, L]
    codes_m = torch.from_numpy(payload[mem]).to(device)    # [c, cmax, L]
    return torch.stack([
        _block_distance(one_hot_channels(m), one_hot_channels(w),
                        nongap_counts(m, dtype), nongap_counts(w, dtype),
                        distance_type=params.distance_type, dtype_name=dtype)
        for w, m in zip(codes_w, codes_m)])


def _stream_block_fn(frontend, payload, params: Param, wit, mem, device):
    """block_fn(start) of one streamed cluster: its members start.. (at
    most _STREAM_ROW_BLOCK) against its W witnesses."""
    Bb = _STREAM_ROW_BLOCK
    if frontend == "mash":
        from dipper_tpu_torch.distance.mash import (inter_to_dist,
                                                    mash_pairwise_inter)

        bank = payload[torch.from_numpy(wit).to(device)]           # [W, M]
        mem_d = torch.from_numpy(mem).to(device)

        def block_fn(start):
            q = payload[mem_d[start:start + Bb]]
            inter = mash_pairwise_inter(bank, q,
                                        sketch_size=params.sketch_size)
            return inter_to_dist(inter, params.kmer_size,
                                 params.sketch_size, params.dtype)
        return block_fn
    if frontend == "matrix":
        w = torch.from_numpy(wit).to(device)
        m = torch.from_numpy(mem).to(device)
        return lambda start: payload[m[start:start + Bb]][:, w]
    from dipper_tpu_torch.distance.msa import msa_tiled_block, nongap_counts

    codes_w = torch.from_numpy(payload[wit]).to(device)
    codes_m = torch.from_numpy(payload[mem]).to(device)
    ng_w = nongap_counts(codes_w, params.dtype)
    ng_m = nongap_counts(codes_m, params.dtype)
    return lambda start: msa_tiled_block(
        codes_m[start:start + Bb], ng_m[start:start + Bb], codes_w, ng_w,
        distance_type=params.distance_type, dtype_name=params.dtype)


def _assign_launches() -> tuple:
    """This process's launches of phase 2's kernel 10 and of its pack."""
    from dipper_tpu_torch.dc import assign_cuda

    return assign_cuda.ASSIGN_LAUNCHES, assign_cuda.PACK_LAUNCHES


def _phase2_chunk(state, B: int) -> int:
    """Queries of one phase-2 chunk: PHASE2_CHUNK at most, and within
    PHASE2_BYTES of [Q, B] rows for kernel 10 or of the plain version's
    [Q, E, K] witness gather."""
    item = state.length.element_size()
    per_row = (B * item if kclosest.uses_assign_kernel(state)
               else state.e.shape[0] * K * item)
    return max(1, min(PHASE2_CHUNK, PHASE2_BYTES // per_row))


def _phase2_assign(state, frontend, payload, bb_args, params: Param, N: int,
                   device, mesh=None) -> tuple:
    """Phase 2's launches: the chosen backbone slot of each of this
    process's queries (all of B..N-1, or this rank's contiguous share of
    them), chunk by chunk, into one int64 tensor on `device`, with no host
    sync (on the card: the state's valid slots packed once, then one
    kernel-10 launch a chunk). Returns (the slots, queries a chunk,
    chunks)."""
    B = params.backbone_size
    lo, hi = (0, N - B) if mesh is None else mesh.share(N - B)
    chunk = _phase2_chunk(state, B)
    ids = torch.empty((hi - lo,), dtype=torch.int64, device=device)
    records = kclosest.assign_records(state, B) if hi > lo else None
    chunks = 0
    for a in range(B + lo, B + hi, chunk):
        b = min(B + hi, a + chunk)
        rows = _phase2_rows(frontend, payload, bb_args, params, a, b, device)
        kclosest.score_edges_rows(state, rows,
                                  out=ids[a - B - lo:b - B - lo],
                                  records=records)
        chunks += 1
    return ids, chunk, chunks


def _phase3_kernel_launches() -> int:
    """This process's launches of phase 3's build kernels: 8b (a batched
    chunk) and 8a (a streamed cluster's row block)."""
    from dipper_tpu_torch.dc import cluster_cuda

    return (cluster_cuda.CLUSTER_BUILD_LAUNCHES
            + cluster_cuda.STREAM_BLOCK_LAUNCHES)


def _phase3_plan(device, stream: bool, cmax_b: int, dtype) -> str:
    """How a bucket builds: "plain" off the card; on it a streamed row
    block's launch ("cluster", kernel 8a) or kernel 8b's plan."""
    if torch.device(device).type != "cuda":
        return "plain"
    if stream:
        return "cluster"
    from dipper_tpu_torch.dc import cluster_cuda

    return cluster_cuda.kernel_plan(cmax_b, dtype)[0]


def _buckets(szs: np.ndarray, cmax: int):
    """(cmax_b, b0, b1) of the pow2 size buckets over the ascending
    sizes `szs`: clusters b0..b1-1 pad to cmax_b members."""
    b0, n = 0, len(szs)
    while b0 < n:
        cmax_b = 8
        while cmax_b < szs[b0]:
            cmax_b *= 2
        cmax_b = min(cmax_b, cmax)
        b1 = (int(np.searchsorted(szs, cmax_b, side="right"))
              if cmax_b < cmax else n)
        yield cmax_b, b0, b1
        b0 = b1


def build_dc_tree(seqs, names, params: Param, matrix=None, *, device,
                  log=None, mesh=None) -> str:
    """The D&C tree (Newick) of `seqs` (params.in_format "r" or "m") or of
    a host distance `matrix`, built on `device`, or with phases 2 and 3
    split over the ranks of `mesh` (parallel.sharded.Mesh) on
    mesh.device; every rank returns the same tree."""
    global last_debug
    log = log or _log
    if mesh is not None:
        device = mesh.device
    N = len(names)
    B = params.backbone_size
    if B < 4:
        raise SystemExit("backbone too small for divide-and-conquer")
    dtype = torch_dtype(params.dtype)
    frontend, payload, bb_args, static = _frontend(seqs, params, matrix,
                                                   device, dtype, log)

    # ---- Phase 1: backbone (local ids, remapped at assembly)
    log("DC phase 1: backbone placement")
    t = time.time()
    kw = dict(num_sequences=B, frontend=frontend, frontend_static=static,
              dtype_name=params.dtype)
    if B >= 8192:
        state = kclosest.run_placement_chunked(
            bb_args, chunk=params.state_chunk or 8192,
            save_state=params.save_state, load_state=params.load_state,
            fingerprint={"dc_backbone": B}, use_caps=params.prefix_caps,
            log=log, **kw)
    else:
        state = kclosest.run_placement_full(bb_args, **kw)
    synchronize(device)
    log(f"DC phase 1 in: {int((time.time() - t) * 1000)} ms")

    # ---- Phase 2: cluster assignment, [Q, B] row chunks scored at once
    log("DC phase 2: cluster assignment")
    t = time.time()
    cluster_id = np.empty(N, dtype=np.int64)
    launches0, packs0 = _assign_launches()
    ids, chunk, chunks = _phase2_assign(state, frontend, payload, bb_args,
                                        params, N, device, mesh)
    ids = ids.cpu().numpy()  # the phase's one copy to the host
    cluster_id[B:N] = ids if mesh is None else mesh.all_gather_host(ids)
    on_card = torch.device(device).type == "cuda"
    launches1, packs1 = _assign_launches()
    log(f"DC phase 2: chunks={chunks} rows_per_chunk={chunk} "
        f"kernel_launches={launches1 - launches0} "
        f"host_syncs={int(on_card)} "
        f"route={'kernel' if kclosest.uses_assign_kernel(state) else 'plain'}"
        f" pack_launches={packs1 - packs0}")
    log(f"DC phase 2 in: {int((time.time() - t) * 1000)} ms "
        f"[assign {hashlib.md5(cluster_id[B:N].tobytes()).hexdigest()[:10]}]")
    t = time.time()

    # ---- Phase 3: local cluster builds, assembled to global ids
    log("DC phase 3: cluster trees")
    qcid = cluster_id[B:N]
    order = np.argsort(qcid, kind="stable")
    sorted_q = np.arange(B, N, dtype=np.int64)[order]
    cluster_eids, starts, sizes = np.unique(
        qcid[order], return_index=True, return_counts=True)
    prefix = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cmax = int(sizes.max()) if len(sizes) else 0

    e_h, belong_h, rev_h, cid_h = (getattr(state, f).cpu().numpy()
                                   for f in ("e", "belong", "rev", "cid"))
    len_h = state.length.cpu().numpy().astype(np.float64)
    cd_h = state.cdis.cpu().numpy().astype(np.float64)

    def bb_final_vec(v):
        # backbone-local node ids -> final ids: leaf v < B stays, internal
        # v in [B, 2B-2] -> N + (v - B) (initial node N_total, middles
        # placeId + N_total - 1)
        v = np.asarray(v, np.int64)
        return np.where(v < 0, -1, np.where(v < B, v, N + (v - B)))

    g_e = np.full(4 * N, -1, np.int64)
    g_belong = np.full(4 * N, -1, np.int64)
    g_len = np.zeros(4 * N, np.float64)
    nb_used = 4 * B - 4
    g_e[:nb_used] = bb_final_vec(e_h[:nb_used])
    g_belong[:nb_used] = bb_final_vec(belong_h[:nb_used])
    g_len[:nb_used] = len_h[:nb_used]

    if cmax > 0:
        nclusters = len(cluster_eids)
        pair = np.stack([cluster_eids, rev_h[cluster_eids]], axis=1)  # [C,2]
        gid = cid_h[pair].astype(np.int64)                            # [C,2,K]
        slot = (np.arange(2)[None, :, None] * K
                + np.arange(K)[None, None, :])
        cid_init = np.where(gid != -1, slot, -1).astype(np.int32)
        cd_init = cd_h[pair]
        lens_init = len_h[pair]
        wit_head = np.maximum(gid, 0).reshape(nclusters, 2 * K)
        x_f = bb_final_vec(belong_h[cluster_eids])
        y_f = bb_final_vec(e_h[cluster_eids])

        def assemble(rr, le, lb, ll, cmax_b, members_b):
            """Bucket-local (e, belong, length) [c, 2 + 4 cmax_b] of
            clusters `rr` -> final global ids, written into the global
            arrays. Middle k of cluster ci -> N + B - 1 + prefix[ci] + k
            (insertLeafCount + N_total - 1, insertLeafCount = B + t)."""
            ll = ll.astype(np.float64)

            def node_map(V):
                V = V.astype(np.int64)
                leaf = members_b[np.arange(len(rr))[:, None],
                                 np.clip(V - 2, 0, cmax_b - 1)]
                mid = N + B - 1 + prefix[rr][:, None] + (V - 2 - cmax_b)
                return np.where(V >= 2 + cmax_b, mid,
                                np.where(V >= 2, leaf,
                                         np.where(V == 1, y_f[rr][:, None],
                                                  x_f[rr][:, None])))

            map_e, map_b = node_map(le), node_map(lb)
            # the cluster edge's two slots
            g_e[pair[rr]] = map_e[:, :2]
            g_belong[pair[rr]] = map_b[:, :2]
            g_len[pair[rr]] = ll[:, :2]
            # local slot 2 + 4g + m -> global nb_used + 4(prefix + g) + m
            span = np.arange(4 * cmax_b, dtype=np.int64)[None, :]
            gslots = nb_used + 4 * prefix[rr][:, None] + span
            valid = span < 4 * sizes[rr][:, None]
            g_e[gslots[valid]] = map_e[:, 2:][valid]
            g_belong[gslots[valid]] = map_b[:, 2:][valid]
            g_len[gslots[valid]] = ll[:, 2:][valid]

        def dev(a, dt=dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)

        corder = np.argsort(sizes, kind="stable")
        log(f"DC phase 3: {nclusters} clusters, size p50="
            f"{int(np.median(sizes))} p99={int(np.quantile(sizes, .99))} "
            f"max={cmax}")
        for cmax_b, b0, b1 in _buckets(sizes[corder], cmax):
            rows = corder[b0:b1]
            # members in encounter order, padded by repeating the last
            # (pads are never inserted: a cluster stops at its size)
            colj = np.arange(cmax_b, dtype=np.int64)[None, :]
            take = starts[rows][:, None] + np.minimum(
                colj, sizes[rows][:, None] - 1)
            mem_b = sorted_q[take]                             # [c, cmax_b]
            wit_b = np.concatenate([wit_head[rows], mem_b], axis=1)
            stream = cmax_b >= _STREAM_CLUSTER_MIN
            tb = time.time()
            steps0, levels0 = cluster.STEPS, cluster.BFS_LEVELS
            kernels0 = _phase3_kernel_launches()
            launches = 0
            # this rank's share of the bucket's clusters, all of them
            # without a mesh; their edge arrays, in cluster order
            j0, j1 = (0, len(rows)) if mesh is None else mesh.share(len(rows))
            parts = []
            if stream:
                for j in range(j0, j1):
                    ci = rows[j]
                    fn = _stream_block_fn(frontend, payload, params,
                                          wit_b[j], mem_b[j], device)
                    le, lb, ll = cluster.build_streamed(
                        fn, dev(cd_init[ci]),
                        dev(cid_init[ci], torch.int32), dev(lens_init[ci]),
                        int(sizes[ci]), cmax_b,
                        min(_STREAM_ROW_BLOCK, cmax_b))
                    launches += -(-int(sizes[ci]) // _STREAM_ROW_BLOCK)
                    parts.append((le[None], lb[None], ll[None]))
            else:
                c_in = max(1, PHASE3_BUDGET // cmax_b)
                for s in range(j0, j1, c_in):
                    sl = slice(s, min(j1, s + c_in))
                    rr = rows[sl]
                    Dq = _pair_distances(frontend, payload, params,
                                         wit_b[sl], mem_b[sl], device)
                    launches += 1
                    parts.append(cluster.build_clusters(
                        Dq, dev(cd_init[rr]), dev(cid_init[rr], torch.int32),
                        dev(lens_init[rr]), sizes[rr], cmax_b))
            arrays = []
            for f, dt in enumerate((np.int32, np.int32, params.dtype)):
                arr = (np.concatenate([p[f].cpu().numpy() for p in parts])
                       if parts else np.empty((0, 2 + 4 * cmax_b), dt))
                arrays.append(arr if mesh is None
                              else mesh.all_gather_host(arr))
            assemble(rows, *arrays, cmax_b, mem_b)
            log(f"DC phase 3: bucket cmax_b={cmax_b} clusters={len(rows)} "
                f"path={'stream' if stream else 'batch'} "
                f"members={int(sizes[rows].sum())} "
                f"launches={launches} steps={cluster.STEPS - steps0} "
                f"bfs_levels={cluster.BFS_LEVELS - levels0} "
                f"kernel_launches={_phase3_kernel_launches() - kernels0} "
                f"plan={_phase3_plan(device, stream, cmax_b, dtype)} "
                f"in {time.time() - tb:.3f}s")

    log(f"DC phase 3 in: {int((time.time() - t) * 1000)} ms "
        f"[edges {hashlib.md5(g_e.tobytes() + g_belong.tobytes() + g_len.tobytes()).hexdigest()[:10]}]")

    from dipper_tpu_torch.io.newick import edge_arrays_newick

    last_debug = {"e": g_e, "belong": g_belong, "len": g_len}
    # root = N_total + bd - 2 = N (printTreeDC :708)
    return edge_arrays_newick(N, list(names), g_belong, g_e, g_len, N)
