"""Mash sketch distances.

Behavioral spec (src/mash.cu:426-455): for sketches A (an already
placed taxon) and B (the new row's taxon), walk the two sorted
sketch_size-element hash lists, counting `inter` (B elements equal to an
A element — ALL equal B copies match, an asymmetric multiset rule) and
`uni` (A elements + unmatched B elements), stopping when uni reaches
sketchSize; then

    j = max(inter, 1) / sketchSize
    d = min(1, |ln(2j / (1+j))| / k)

u64 hashes are rank-compressed once (order- and equality-preserving) so
every comparison is int32, and rank rows are padded to a power of two
with ranks that sort last. Placement, D&C and --add (`mash_rank_bank`)
sketch on the device and rank there by `rank_compress_dense`, whose
consecutive ranks equal the host route's np.unique ranks bit for bit;
the host route (native sketcher, `rank_compress_host`, one upload)
serves --save-sketches/--load-sketches and banks whose transients would
not fit the card. The NJ matrix and -o d (`mash_rank_bank_device`) rank
on the device by `rank_compress` (first-of-run ranks), as the JAX package
does. For CUDA tensors,
the Hopper kernels of distance/mash_cuda.py run the walk, a warp per
pair (`partitioned_walk_inter` models how): one returns intersection
counts (`mash_pairwise_inter`), the other the distances
(`mash_pairwise`, `mash_distance_matrix`). CPU tensors take
`merged_inter_count_ref`, the plain PyTorch restatement of the walk as a
bitonic merge plus scans (dipper_tpu/distance/mash.py::
_merged_inter_count). Distances go through one host lookup table, so
equal counts give bitwise-equal distances on every device.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from dipper_tpu_torch.utils.device import synchronize, torch_dtype

_PAD_KEY = np.int32(2**31 - 1)
_BIG = 2**30

# ranks of a bank stay below this: the tagged keys 2r+1 and the pad rank
# must fit int32 (rank_compress_dense's rule)
_RANK_LIMIT = 2**30
# device bytes a bank value costs on mash_rank_bank's device route, an
# upper estimate: the int64 bank, its sign-flipped copy, the sort's
# values and int64 order with the radix sort's alternate buffers, the
# cumulative count and the ranks
_DEVICE_ROUTE_BYTES = 64

# bytes of the [queries, bank, 2M] int32 transient of one
# merged_inter_count_ref chunk (its scans hold a few such arrays)
_REF_CHUNK_BYTES = 2**27


def rank_compress_host(sketches_u64: np.ndarray) -> np.ndarray:
    """u64 [N, S] sketch bank -> int32 ranks [N, S] preserving order and
    equality globally: consecutive ranks 0..U-1 via np.unique. Max rank
    < N*S must stay < 2^30 so that the tagged keys 2r+1 fit int32."""
    flat = np.ascontiguousarray(sketches_u64).reshape(-1)
    _, inv = np.unique(flat, return_inverse=True)
    return inv.astype(np.int32).reshape(sketches_u64.shape)


def rank_compress(sketches: torch.Tensor) -> torch.Tensor:
    """int64 [N, S] sketch bank (u64 bit patterns) -> int32 ranks [N, S]
    on its device, preserving order and equality globally: each value's
    rank is the sorted position of the first element of its run of equal
    values, dipper_tpu/distance/mash.py::rank_compress's ranks bit for bit
    (its pow2 sentinel pad sorts after every real element and moves no
    run's start). Raises when N*S >= 2^30: the ranks, below N*S, must
    leave the tagged keys 2r+1 and the pad rank in int32."""
    N, S = sketches.shape
    P = N * S
    if P >= 2**30:
        raise ValueError(f"sketch bank of {N} x {S} = {P} values: device "
                         "rank compression takes fewer than 2^30")
    flat = sketches.reshape(-1) ^ torch.iinfo(torch.int64).min
    vals, order = torch.sort(flat, stable=True)
    newseg = torch.ones(P, dtype=torch.bool, device=flat.device)
    newseg[1:] = vals[1:] != vals[:-1]
    iota = torch.arange(P, dtype=torch.int32, device=flat.device)
    rank_sorted = torch.cummax(torch.where(newseg, iota, 0), 0).values
    ranks = torch.empty(P, dtype=torch.int32, device=flat.device)
    ranks[order] = rank_sorted
    return ranks.view(N, S)


def rank_compress_dense(sketches: torch.Tensor) -> torch.Tensor:
    """int64 [N, S] sketch bank (u64 bit patterns) -> int32 ranks [N, S]
    on its device: consecutive ranks 0..U-1 of the U distinct values,
    rank_compress_host's np.unique inverse bit for bit. One stable sort of
    the values with their sign bit flipped (signed order is unsigned
    order), the starts of runs of equal values, their cumulative count
    less one scattered back by the sort's order. Raises when U >=
    _RANK_LIMIT (the tagged keys 2r+1 and the pad rank must stay in
    int32): the host route's rule."""
    N, S = sketches.shape
    P = N * S
    if P == 0:
        return torch.empty((N, S), dtype=torch.int32,
                           device=sketches.device)
    flat = sketches.reshape(-1) ^ torch.iinfo(torch.int64).min
    vals, order = torch.sort(flat, stable=True)
    del flat
    dense = torch.zeros(P, dtype=torch.int64, device=vals.device)
    torch.cumsum(vals[1:] != vals[:-1], 0, out=dense[1:])
    del vals
    U = int(dense[-1]) + 1
    if U >= _RANK_LIMIT:
        raise ValueError(f"sketch bank of {N} x {S} holds {U} distinct "
                         f"values: ranks take fewer than {_RANK_LIMIT}")
    ranks = torch.empty(P, dtype=torch.int32, device=dense.device)
    ranks[order] = dense.to(torch.int32)
    return ranks.view(N, S)


def _device_room(device: torch.device) -> int | None:
    """Bytes the device route may take on `device`: the card's total less
    what this process holds, so that the route depends on the run and not
    on other processes on the card; None off the card (no limit)."""
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return total - torch.cuda.memory_allocated(device)


def ingest_route(n: int, params, device: torch.device) -> tuple:
    """("device" or "host", the reason) of mash_rank_bank for n
    sequences, decided before any launch. The host route keeps the
    checkpoints' bank on the host, and takes a bank whose device route
    (the int64 bank, the sketch batches, rank_compress_dense's sort) would
    not fit `_device_room`, reckoned from N x S."""
    if params.save_sketches or params.load_sketches:
        return "host", ("--save-sketches/--load-sketches keep the sketch "
                        "bank on the host")
    room = _device_room(device)
    if room is None:
        return "device", f"plain versions on {device}"
    from dipper_tpu_torch.sketch.minhash import _BATCH_BYTES

    need = n * params.sketch_size * _DEVICE_ROUTE_BYTES + _BATCH_BYTES
    if need > room:
        return "host", (f"the device route needs ~{need} bytes, the card "
                        f"has {room} beside this process's tensors")
    return "device", (f"~{need} bytes of the {room} beside this process's "
                      "tensors")


def mash_rank_bank(seqs, params, device, log=None) -> torch.Tensor:
    """The padded int32 rank bank [N, M] on `device`: the ingest of
    placement, D&C and --add. The device route (ingest_route) sketches
    with sketch/minhash.py on `device` (the kernel on the card, its plain
    version on the CPU) and ranks with rank_compress_dense there; the
    host route hashes with the native sketcher (or loads the bank), ranks
    with np.unique and uploads once. Both give the same bytes. `log`, if
    given, receives the route, and "Sketch in" and "Rank bank in", each
    after a synchronize."""
    from dipper_tpu_torch.sketch.bank import get_sketch_bank

    route, why = ingest_route(len(seqs), params, device)
    if log:
        log(f"Rank bank route: {route} ({why})")
    t0 = time.time()
    sk = get_sketch_bank(seqs, params, as_device=route == "device",
                         device=device)
    synchronize(device)
    if log:
        log(f"Sketch in: {int((time.time() - t0) * 1000)} ms")
    t0 = time.time()
    if route == "device":
        dense = rank_compress_dense(sk)
        del sk
        ranks = pad_ranks(dense)
    else:
        ranks = torch.from_numpy(pad_ranks(rank_compress_host(
            np.asarray(sk)))).to(device)
    synchronize(device)
    if log:
        log(f"Rank bank in: {int((time.time() - t0) * 1000)} ms")
    return ranks


def mash_rank_bank_device(seqs, params, device, log=None) -> torch.Tensor:
    """The padded int32 rank bank [N, M] of the NJ matrix and -o d, as
    dipper_tpu/driver.py::_distance_matrix makes it: the device sketch
    bank (a host bank uploaded where --save-sketches or --load-sketches
    asks for the host route), then `rank_compress` and `pad_ranks` on
    `device`. `log` receives "Sketch in" and "Rank bank in", each after
    a synchronize."""
    from dipper_tpu_torch.sketch.bank import get_sketch_bank

    t0 = time.time()
    sk = get_sketch_bank(seqs, params, as_device=True, device=device)
    if isinstance(sk, np.ndarray):
        sk = torch.from_numpy(np.ascontiguousarray(sk).view(np.int64))
    sk = sk.to(device)
    synchronize(device)
    if log:
        log(f"Sketch in: {int((time.time() - t0) * 1000)} ms")
    t0 = time.time()
    ranks = pad_ranks(rank_compress(sk))
    synchronize(device)
    if log:
        log(f"Rank bank in: {int((time.time() - t0) * 1000)} ms")
    return ranks


def _pad_pow2(S: int) -> int:
    return int(2 ** np.ceil(np.log2(max(S, 2))))


def pad_ranks(ranks):
    """Pad rank rows to the next power of two with PAD_KEY//2 so that
    tagged keys (2r, 2r+1) stay below int32 max and pads sort last. A
    host np.ndarray gives np, a tensor a tensor on its device."""
    N, S = ranks.shape
    M = _pad_pow2(S)
    if M == S:
        return ranks
    if isinstance(ranks, torch.Tensor):
        pad = torch.full((N, M - S), int((_PAD_KEY - 1) // 2),
                         dtype=torch.int32, device=ranks.device)
        return torch.cat([ranks, pad], dim=1)
    pad = np.full((N, M - S), (_PAD_KEY - 1) // 2, np.int32)
    return np.concatenate([ranks, pad], axis=1)


@functools.lru_cache(maxsize=None)
def _dist_table(k: int, sketch_size: int, dtype_name: str) -> np.ndarray:
    """Host-computed [S+1] lookup table d(inter) for the only possible
    intersection counts 0..S. NumPy's libm log gives ONE deterministic
    set of values, so distances are bitwise identical across devices,
    batch shapes and packages given equal counts."""
    dt = np.dtype(dtype_name)
    t = np.arange(sketch_size + 1, dtype=dt)
    j = np.maximum(t, dt.type(1.0)) / dt.type(sketch_size)
    return np.minimum(
        dt.type(1.0),
        np.abs(np.log(dt.type(2.0) * j / (dt.type(1.0) + j)) / dt.type(k)))


def inter_to_dist(inter: torch.Tensor, k: int, sketch_size: int,
                  dtype_name: str) -> torch.Tensor:
    """d = min(1, |ln(2j/(1+j))|/k), j = max(inter,1)/S (mash.cu:453),
    as a gather from the host table on inter's device."""
    tab = _dist_table_on(inter.device, k, sketch_size, dtype_name)
    return tab[inter.clamp(0, sketch_size)]


def _dist_table_on(device: torch.device, k: int, sketch_size: int,
                   dtype_name: str) -> torch.Tensor:
    return torch.from_numpy(_dist_table(k, sketch_size, dtype_name)).to(device)


def _bitonic_merge(keys: torch.Tensor) -> torch.Tensor:
    """keys [..., 2M] with [..., :M] ascending and [..., M:] descending
    -> fully sorted along the last axis."""
    n = keys.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic merge width {n} is not a power of two")
    d = n // 2
    while d >= 1:
        r = keys.reshape(keys.shape[:-1] + (n // (2 * d), 2, d))
        lo = torch.minimum(r[..., 0, :], r[..., 1, :])
        hi = torch.maximum(r[..., 0, :], r[..., 1, :])
        keys = torch.stack([lo, hi], dim=-2).reshape(keys.shape)
        d //= 2
    return keys


def _merged_inter_count(a_keys: torch.Tensor, b_keys: torch.Tensor,
                        sketch_size: int) -> torch.Tensor:
    """a_keys [..., M] ascending (tagged 2r+1), b_keys [..., M] ascending
    (tagged 2r) -> int32 inter counts [...]. Equal values sort B first
    (tag 0 < 1), which is the walk's tie order."""
    merged = _bitonic_merge(torch.cat([a_keys, b_keys.flip(-1)], dim=-1))
    is_a = (merged & 1) == 1
    val = merged >> 1
    a_vals = torch.where(is_a, val, _BIG)
    # reverse running min: the nearest A value at or after each slot
    next_a = a_vals.flip(-1).cummin(dim=-1).values.flip(-1)
    matched_b = ~is_a & (next_a == val)
    uni_inc = (~matched_b).to(torch.int32)
    cum_before = uni_inc.cumsum(dim=-1) - uni_inc
    return (matched_b & (cum_before < sketch_size)).sum(
        dim=-1, dtype=torch.int32)


def merged_inter_count_ref(bank_ranks: torch.Tensor,
                           query_ranks: torch.Tensor, *,
                           sketch_size: int) -> torch.Tensor:
    """Plain PyTorch version of the merge-count kernel: bank_ranks int32
    [N, M], query_ranks int32 [Q, M] (M a power of two, rows ascending)
    -> int32 [Q, N] counts. Chunked over queries to bound the
    [chunk, N, 2M] transient."""
    N, M = bank_ranks.shape
    Q = query_ranks.shape[0]
    a_keys = bank_ranks * 2 + 1
    out = torch.empty((Q, N), dtype=torch.int32, device=bank_ranks.device)
    step = max(1, _REF_CHUNK_BYTES // max(1, N * 2 * M * 4))
    for q0 in range(0, Q, step):
        b_keys = query_ranks[q0:q0 + step] * 2
        c = b_keys.shape[0]
        out[q0:q0 + c] = _merged_inter_count(
            a_keys.unsqueeze(0).expand(c, N, M),
            b_keys.unsqueeze(1).expand(c, N, M), sketch_size)
    return out


# csrc/mash_walk.cuh's kMaxStepsPerLane and kRoundMargin
_MAX_STEPS_PER_LANE = 26
_ROUND_MARGIN = 16


def _select_bit(mask: int, k: int) -> int:
    """Position of the k-th (1-based) set bit of the 32-bit `mask`, which
    has at least k set bits: a binary search on popcounts, as
    csrc/mash_walk.cuh::select_bit does it."""
    p, half = 0, 16
    while half:
        c = bin((mask >> p) & ((1 << half) - 1)).count("1")
        if c < k:
            k -= c
            p += half
        half //= 2
    return p


def _round_steps_per_lane(need: int, uni: int, inter: int, lanes: int,
                         max_steps: int) -> int:
    """Steps each lane takes in the next round of the partitioned walk:
    the `need` steps that are certain to run, plus the matches they are
    expected to bring at the rate seen so far and a margin, spread over
    the lanes and capped by `max_steps`."""
    est = need
    if uni + inter > 0:
        est += need * inter // max(uni, 1) + _ROUND_MARGIN
    return min(max_steps, (est + lanes - 1) // lanes)


def partitioned_walk_inter(a, b, sketch_size: int, lanes: int = 32,
                           max_steps: int = _MAX_STEPS_PER_LANE) -> int:
    """Slow per-pair model of the algorithm of csrc/mash_walk.cuh, for
    tests: the serial walk's `inter` for bank row `a` and query row `b`
    (ascending ints, at least sketch_size long), computed the way one
    warp of `lanes` lanes computes it.

    The walk's steps are the merged order of A and B with B first on
    equal values; step t stands on diagonal ai + bi = t. A round covers
    lanes * w consecutive steps. Each lane finds the split (ai, bi) of
    its first diagonal by binary search, walks its w steps, and keeps one
    bit a step: the step is a B element equal to the A head (a match).
    Every other step raises `uni`. While the round's steps leave uni
    below sketch_size they all ran in the serial walk too, and the next
    round starts where this one ended. In the round where uni reaches
    sketch_size, a prefix sum over the lanes gives each lane the uni
    count at its first step, and the lane in which it crosses counts only
    the matches up to its (sketch_size - uni)-th raising step: a match
    that stands at uni == sketch_size does not count."""
    s = sketch_size
    if not 1 <= max_steps <= 32:
        raise ValueError(f"max_steps {max_steps} outside [1, 32], the step "
                         "bits a lane keeps")
    a = [int(v) for v in a[:s]] + [2**31 - 1]  # a[s]: the head of an
    b = [int(v) for v in b[:s]] + [2**31 - 1]  # exhausted side
    uni = inter = t0 = bi0 = 0
    while True:
        w = _round_steps_per_lane(s - uni, uni, inter, lanes, max_steps)
        masks, counts, ends = [], [], []
        for lane in range(lanes):
            t = t0 + lane * w
            n = max(0, min(w, 2 * s - t))
            mm = bi = 0
            if n:
                lo = max(0, t - s, bi0)
                hi = min(t, s, bi0 + (t - t0))
                while lo < hi:
                    mid = (lo + hi) // 2
                    if b[mid] <= a[t - mid - 1]:
                        lo = mid + 1
                    else:
                        hi = mid
                bi, ai = lo, t - lo
                for j in range(n):
                    take_b = b[bi] <= a[ai] and bi < s
                    if take_b and b[bi] == a[ai]:
                        mm |= 1 << j
                    if take_b:
                        bi += 1
                    else:
                        ai += 1
            masks.append(mm)
            counts.append(n)
            ends.append(bi)
        lm = [bin(m).count("1") for m in masks]
        lu = [n - c for n, c in zip(counts, lm)]
        if uni + sum(lu) < s:
            inter += sum(lm)
            uni += sum(lu)
            t0 += lanes * w
            bi0 = ends[-1]
            continue
        base = 0
        for lane in range(lanes):
            k = s - uni - base
            if k > 0:
                if lu[lane] < k:
                    inter += lm[lane]
                else:
                    raising = ~masks[lane] & ((1 << counts[lane]) - 1)
                    p = _select_bit(raising, k)
                    inter += bin(masks[lane] & ((2 << p) - 1)).count("1")
            base += lu[lane]
        return inter


def mash_pairwise_inter(bank_ranks: torch.Tensor, query_ranks: torch.Tensor,
                        *, sketch_size: int) -> torch.Tensor:
    """[N, M] bank x [Q, M] queries -> int32 [Q, N] intersection counts.
    CUDA tensors go to the Hopper kernel (which raises on failure), CPU
    tensors to the plain version."""
    if bank_ranks.device.type == "cuda":
        from dipper_tpu_torch.distance.mash_cuda import mash_inter_cuda

        return mash_inter_cuda(bank_ranks, query_ranks,
                               sketch_size=sketch_size)
    if bank_ranks.device.type == "cpu":
        return merged_inter_count_ref(bank_ranks, query_ranks,
                                      sketch_size=sketch_size)
    raise ValueError(f"unsupported device {bank_ranks.device}")


def cluster_inter_ref(ranks: torch.Tensor, wit: torch.Tensor,
                      mem: torch.Tensor, *, sketch_size: int) -> torch.Tensor:
    """Plain PyTorch version of the per-cluster count kernel (csrc/
    mash_cluster_inter.cu): ranks int32 [N, M], wit int32 [c, W], mem int32
    [c, Q] -> int32 [c, Q, W], cluster i's member rows ranks[mem[i]] as
    queries against its witness rows ranks[wit[i]] as the bank: the
    merged_inter_count_ref walk on the gathered rows, clusters chunked to
    bound the [chunk, Q, W, 2M] transient."""
    c, W = wit.shape
    Q = mem.shape[1]
    M = ranks.shape[1]
    out = torch.empty((c, Q, W), dtype=torch.int32, device=ranks.device)
    step = max(1, _REF_CHUNK_BYTES // max(1, Q * W * 2 * M * 4))
    for c0 in range(0, c, step):
        a_keys = ranks[wit[c0:c0 + step].long()] * 2 + 1     # [n, W, M]
        b_keys = ranks[mem[c0:c0 + step].long()] * 2         # [n, Q, M]
        n = a_keys.shape[0]
        out[c0:c0 + n] = _merged_inter_count(
            a_keys.unsqueeze(1).expand(n, Q, W, M),
            b_keys.unsqueeze(2).expand(n, Q, W, M), sketch_size)
    return out


def mash_cluster_inter(ranks: torch.Tensor, wit: torch.Tensor,
                       mem: torch.Tensor, *, sketch_size: int) -> torch.Tensor:
    """Per-cluster counts [c, Q, W] (see cluster_inter_ref). CUDA tensors
    go to the Hopper kernel (which raises on failure), CPU tensors to the
    plain version."""
    if ranks.device.type == "cuda":
        from dipper_tpu_torch.distance.mash_cuda import mash_cluster_inter_cuda

        return mash_cluster_inter_cuda(ranks, wit, mem,
                                       sketch_size=sketch_size)
    if ranks.device.type == "cpu":
        return cluster_inter_ref(ranks, wit, mem, sketch_size=sketch_size)
    raise ValueError(f"unsupported device {ranks.device}")


def mash_rows_vs_bank(bank_ranks: torch.Tensor, query_ranks: torch.Tensor,
                      *, k: int, sketch_size: int,
                      dtype_name: str) -> torch.Tensor:
    """Plain PyTorch version of the distance kernel (csrc/
    mash_rows_dist.cu): [N, M] bank x [Q, M] queries -> [Q, N] distances,
    or a single [M] query -> [N], as dipper_tpu/distance/mash_pallas.py::
    mash_rows_vs_bank_pallas returns them."""
    single = query_ranks.dim() == 1
    q = query_ranks[None] if single else query_ranks
    d = inter_to_dist(merged_inter_count_ref(bank_ranks, q,
                                             sketch_size=sketch_size),
                      k, sketch_size, dtype_name)
    return d[0] if single else d


def mash_pairwise(bank_ranks: torch.Tensor, query_ranks: torch.Tensor, *,
                  k: int, sketch_size: int, dtype_name: str,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """[N, M] bank x [Q, M] queries -> [Q, N] distances (d[q, a] =
    distance with bank row a as the placed side). CUDA tensors go to the
    fused distance kernel (which raises on failure and, given `out`,
    writes into it in place), CPU tensors to the plain version."""
    if bank_ranks.device.type == "cuda":
        from dipper_tpu_torch.distance.mash_cuda import mash_rows_dist_cuda

        table = _dist_table_on(bank_ranks.device, k, sketch_size, dtype_name)
        return mash_rows_dist_cuda(bank_ranks, query_ranks, table,
                                   sketch_size=sketch_size, out=out)
    if bank_ranks.device.type == "cpu":
        d = mash_rows_vs_bank(bank_ranks, query_ranks, k=k,
                              sketch_size=sketch_size, dtype_name=dtype_name)
        if out is None:
            return d
        out.copy_(d)
        return out
    raise ValueError(f"unsupported device {bank_ranks.device}")


# query rows per distance-matrix launch (bounds one launch's run time)
MATRIX_ROW_BLOCK = 4096


def mash_distance_matrix(ranks, k: int, sketch_size: int, dtype_name: str,
                         device) -> torch.Tensor:
    """The symmetric [N, N] mash distance matrix of padded int32 rank rows
    `ranks` [N, M] (host array or tensor), on `device`. As in
    dipper_tpu/distance/mash.py::mash_distance_matrix_device, entry (i, j)
    with j < i is the distance with row i as the query (B) and row j as
    the bank (A), mirrored into the upper triangle; the diagonal is 0.
    The Mash walk is asymmetric, so that orientation is part of the
    result."""
    r = torch.as_tensor(ranks).to(device)
    N = r.shape[0]
    out = torch.empty((N, N), dtype=torch_dtype(dtype_name), device=device)
    for q0 in range(0, N, MATRIX_ROW_BLOCK):
        q1 = min(N, q0 + MATRIX_ROW_BLOCK)
        mash_pairwise(r, r[q0:q1], k=k, sketch_size=sketch_size,
                      dtype_name=dtype_name, out=out[q0:q1])
    lower = out.tril_(-1)
    return lower + lower.T
