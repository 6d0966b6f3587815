// The splice and the witness BFS of one insertion, shared by
// insert_step.cu (kernel 6: one block an insertion), dc_stream_block.cu
// (kernel 8a: block 0 of a cluster inserts a streamed D&C cluster's
// members) and dc_cluster_build.cu (kernel 8b: a batched D&C chunk). The
// plan is described at the top of insert_step.cu; placement/
// insert_model.py models it. Each function is templated on the value type
// T (float or double), the block's threads and the entries `Cap` of a
// shared frontier buffer, so that a caller sizes both to its trees.
//
// The functions at the end (visit_local, walk_lanes, splice_lanes) run the
// same plan on a state that one warp alone reads and writes, through
// generic pointers (kernel 8b's cluster state in shared memory): `lane` is
// the lane within the warp, every level of the walk is the warp's, and
// nothing goes through ld.global.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics.

#pragma once

#include "edge_score.cuh"

namespace dipper {

constexpr int kDegree = 3;      // adjacency slots a node
constexpr int kMaxBlocked = 2;  // nodes a BFS may dequeue without expanding
constexpr int kNarrow = kWarp;  // pairs of a level that warp 0 takes alone
constexpr unsigned kFull = 0xffffffffu;

// v's key in torch's sort order: keys compare as the values do, with NaN
// after every number (all NaNs equal) and -0 equal to +0, so that a is
// strictly before b (a == a && (b != b || a < b)) exactly when key(a) <
// key(b)
__device__ __forceinline__ unsigned sort_key(float v)
{
    if (v != v) return 0xffffffffu;
    const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
    return (b & 0x80000000u) != 0 ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ unsigned long long sort_key(double v)
{
    if (v != v) return ~0ull;
    const unsigned long long b =
        (unsigned long long)__double_as_longlong(v == 0.0 ? 0.0 : v);
    return (b >> 63) != 0 ? ~b : (b | (1ull << 63));
}

template <typename T>
struct State {
    int32_t* e;       // [E] destination node
    int32_t* belong;  // [E] source node
    T* length;        // [E]
    int32_t* rev;     // [E]
    T* cdis;          // [E, K]
    int32_t* cid;     // [E, K]
    int32_t* adj;     // [M, 3] out-edges of each node, -1 empty
    int32_t* f_ids;   // [2, M] frontier spill: node
    int32_t* f_frm;   // [2, M] node it was reached from
    T* f_dist;        // [2, M] distance from the source
    int n_edges, n_nodes;
};

template <typename T, int Threads, int Cap>
struct Shared {
    static_assert(Threads % kWarp == 0 && Threads >= kWarp
                      && Threads <= 32 * kWarp,
                  "a block of whole warps, at most 32");
    static_assert(Cap >= kNarrow, "a narrow level's frontier stays shared");
    int32_t ids[2][Cap];  // the frontier's first Cap entries, ping-pong
    int32_t frm[2][Cap];
    T dist[2][Cap];
    int warp_sum[Threads / kWarp];
    int blocked[kMaxBlocked];
    int n_blocked;
    int label;
    int count, cur, level;  // the walk, handed from warp 0 to the block
};

template <typename T, int Threads, int Cap>
__device__ __forceinline__ void get_entry(const State<T>& s,
                                          const Shared<T, Threads, Cap>& sh,
                                          int buf, int f, int& id, int& frm,
                                          T& d)
{
    if (f < Cap) {
        id = sh.ids[buf][f];
        frm = sh.frm[buf][f];
        d = sh.dist[buf][f];
    } else {
        const size_t o = (size_t)buf * s.n_nodes + f;
        id = s.f_ids[o];
        frm = s.f_frm[o];
        d = s.f_dist[o];
    }
}

template <typename T, int Threads, int Cap>
__device__ __forceinline__ void put_entry(const State<T>& s,
                                          Shared<T, Threads, Cap>& sh,
                                          int buf, int at, int id, int frm,
                                          T d)
{
    if (at < Cap) {
        sh.ids[buf][at] = id;
        sh.frm[buf][at] = frm;
        sh.dist[buf][at] = d;
    } else {
        const size_t o = (size_t)buf * s.n_nodes + at;
        s.f_ids[o] = id;
        s.f_frm[o] = frm;
        s.f_dist[o] = d;
    }
}

// Exclusive prefix sum of v over the block of Threads threads; *total gets
// the sum. Every thread of the block must call it.
template <int Threads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total)
{
    constexpr int kWarpsB = Threads / kWarp;
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    int x = v;
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
    }
    if (lane == kWarp - 1) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < kWarpsB ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 1; off < kWarpsB; off *= 2) {
            const int y = __shfl_up_sync(kFull, w, off);
            if (lane >= off) w += y;
        }
        if (lane < kWarpsB) s_warp[lane] = w;
    }
    __syncthreads();
    const int excl = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
    *total = s_warp[kWarpsB - 1];
    __syncthreads();  // s_warp is written again by the next scan
    return excl;
}

// A load that stays where it is written, before the branches that follow
// (a plain load whose value only a branch uses is moved into it): the
// reads of a visited edge are one round trip. Plain ld.global, never the
// read-only path: the launch writes these arrays.
__device__ __forceinline__ int load_now(const int32_t* p)
{
    int v;
    asm volatile("ld.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ float load_now(const float* p)
{
    float v;
    asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ double load_now(const double* p)
{
    double v;
    asm volatile("ld.global.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
    return v;
}

// A frontier entry
template <typename T>
struct Entry {
    int node, from;
    T dist;
};

// The nodes a walk dequeues but does not expand (n of them, at most two)
struct Blocked {
    int n, b0, b1;
};

// One (frontier entry, out-edge eid) pair: true when the far node joins
// the next frontier (at distance *nd, as *dst), after (d, label) went into
// the edge's list; false for an eid that is no slot of the state.
template <typename T>
__device__ __forceinline__ bool visit_edge(const State<T>& s, int eid,
                                           int from, T d, int label,
                                           int* dst, T* nd)
{
    const int E = s.n_edges;
    if (eid < 0 || eid >= E) return false;
    // the edge's destination, list, ids and length in one round trip
    T* cd = s.cdis + (size_t)eid * kK;
    int32_t* ci = s.cid + (size_t)eid * kK;
    const int to = load_now(s.e + eid);
    const T len = load_now(s.length + eid);
    T c[kK];
    int32_t id[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) {
        c[q] = load_now(cd + q);
        id[q] = load_now(ci + q);
    }
    int pos = 0;
#pragma unroll
    for (int q = 0; q < kK; ++q) pos += c[q] <= d;
    if (to == from || pos >= kK) return false;
    // _insert_sorted: from pos on, one place right
#pragma unroll
    for (int q = kK - 1; q >= 1; --q) {
        if (q > pos) {
            cd[q] = c[q - 1];
            ci[q] = id[q - 1];
        }
    }
    cd[pos] = d;
    ci[pos] = label;
    *dst = to;
    *nd = add_rn(d, len);
    return true;
}

// Out-edge slot k of a frontier entry's node: its adjacency slot, or -1
// for a node that is not expanded (out of range, or blocked)
template <typename T>
__device__ __forceinline__ int slot_of(const State<T>& s, int node, int k,
                                       Blocked bl)
{
    const int M = s.n_nodes;
    const bool expand = node >= 0 && node < M && !(bl.n > 0 && node == bl.b0)
                        && !(bl.n > 1 && node == bl.b1);
    return expand ? s.adj[(size_t)node * kDegree + k] : -1;
}

// One (frontier entry, out-edge slot k) pair: visit_edge of the node's
// slot k, when the node is expanded.
template <typename T>
__device__ __forceinline__ bool visit(const State<T>& s, int node, int from,
                                      T d, int k, int label, Blocked bl,
                                      int* dst, T* nd)
{
    return visit_edge(s, slot_of(s, node, k, bl), from, d, label, dst, nd);
}

// Warp 0's narrow levels, the frontier in shared buffer `cur`: a lane a
// (entry, out-edge) pair, the next frontier placed by a ballot (the
// joining lanes below each lane) and the level ended by __syncwarp, with
// no block barrier. Returns when the walk is done (no entry, or M levels)
// or a level turns wide.
template <typename T, int Threads, int Cap>
__device__ void narrow_levels(const State<T>& s, Shared<T, Threads, Cap>& sh,
                              int& cur, int& count, int& level, int label,
                              Blocked bl)
{
    const int lane = threadIdx.x;
    const int M = s.n_nodes;
    while (count > 0 && level < M && kDegree * count <= kNarrow) {
        bool joins = false;
        int node = -1, dst = -1;
        T nd = T(0);
        if (lane < kDegree * count) {
            const int f = lane / kDegree;
            node = sh.ids[cur][f];
            joins = visit(s, node, sh.frm[cur][f], sh.dist[cur][f],
                          lane % kDegree, label, bl, &dst, &nd);
        }
        const unsigned ballot = __ballot_sync(kFull, joins);
        const int at = __popc(ballot & ((1u << lane) - 1u));
        if (joins && at < M) {
            sh.ids[1 - cur][at] = dst;
            sh.frm[1 - cur][at] = node;
            sh.dist[1 - cur][at] = nd;
        }
        __syncwarp();  // the next level reads what this one wrote
        const int all = __popc(ballot);
        count = all < M ? all : M;
        cur ^= 1;
        ++level;
    }
}

// A level of more than kNarrow pairs, by the whole block in chunks of
// Threads; returns the next frontier's width.
template <typename T, int Threads, int Cap>
__device__ int wide_level(const State<T>& s, Shared<T, Threads, Cap>& sh,
                          int cur, int count, int label, Blocked bl)
{
    const int M = s.n_nodes;
    const int items = kDegree * count;
    int next = 0;
    for (int c0 = 0; c0 < items; c0 += Threads) {
        const int j = c0 + threadIdx.x;
        bool joins = false;
        int node = -1, dst = -1;
        T nd = T(0);
        if (j < items) {
            const int f = j / kDegree;
            int from;
            T d;
            get_entry(s, sh, cur, f, node, from, d);
            joins = visit(s, node, from, d, j - f * kDegree, label, bl, &dst,
                          &nd);
        }
        int total;
        const int at =
            next + block_exclusive_scan<Threads>(joins, sh.warp_sum, &total);
        if (joins && at < M) put_entry(s, sh, 1 - cur, at, dst, node, nd);
        next += total;
    }
    __syncthreads();  // the next level reads what this one wrote
    return next < M ? next : M;
}

// A walk's two kinds of level over the [M, 3] rows: narrow_levels and
// wide_level. insert_step.cu gives walk another pair for trees with wider
// nodes.
template <typename T, int Threads, int Cap>
struct RowLevels {
    __device__ void narrow(const State<T>& s, Shared<T, Threads, Cap>& sh,
                           int& cur, int& count, int& level, int label,
                           Blocked bl) const
    {
        narrow_levels(s, sh, cur, count, level, label, bl);
    }
    __device__ int wide(const State<T>& s, Shared<T, Threads, Cap>& sh,
                        int cur, int count, int label, Blocked bl) const
    {
        return wide_level(s, sh, cur, count, label, bl);
    }
};

// The walk, by every thread of the block, from the one entry `e` (the
// others' arguments are not read) at `level`; warp 0 has written the
// label and the blocked nodes to shared memory. Warp 0 walks the narrow
// levels alone (lv.narrow); the other warps wait at a barrier that it
// reaches when a level turns wide or the walk ends, and the block takes
// the wide level (lv.wide). Every thread returns after the same barrier.
template <typename T, int Threads, int Cap,
          typename Levels = RowLevels<T, Threads, Cap>>
__device__ void walk(const State<T>& s, Shared<T, Threads, Cap>& sh,
                     Entry<T> e, int count, int level, int label, Blocked bl,
                     Levels lv = Levels{})
{
    const int M = s.n_nodes;
    int cur = 0;
    if (threadIdx.x == 0) {
        sh.ids[0][0] = e.node;
        sh.frm[0][0] = e.from;
        sh.dist[0][0] = e.dist;
    }
    if (threadIdx.x < kWarp) __syncwarp();  // before warp 0 reads it
    for (;;) {
        if (threadIdx.x < kWarp) {
            lv.narrow(s, sh, cur, count, level, label, bl);
            if (threadIdx.x == 0) {
                sh.count = count;
                sh.cur = cur;
                sh.level = level;
            }
        }
        __syncthreads();  // the other warps join for a wide level, or leave
        count = sh.count;
        cur = sh.cur;
        level = sh.level;
        if (count == 0 || level >= M) return;
        label = sh.label;
        bl = {sh.n_blocked, sh.blocked[0], sh.blocked[1]};
        count = lv.wide(s, sh, cur, count, label, bl);
        cur ^= 1;
        ++level;
    }
}

// Whether write p of the plain version's six writes to e, length and rev
// (at xe, yi, i0, i1, i2, i3, in its order) is the last at its address.
__device__ __forceinline__ bool last_write(const int (&at)[6], int p, int a)
{
    bool last = true;
#pragma unroll
    for (int q = 0; q < 6; ++q) last = last && !(q > p && at[q] == a);
    return last;
}

// splice (updateTreeStructure) by warp 0, then the BFS's first level (from
// `outside` over slot i2, unless outside is blocked): returns whether it
// spliced (nothing is written when eid or its reverse slot is not a slot
// of the state) and, when it did, the frontier after that level (*count
// entries: middle, or none) and the blocked nodes. With `ends` (the
// scorer's belong, e, rev of the chosen edge) the edge's own fields are
// not read again. The choice (eid_p, ends, frac_p, add_p) and out_xy may
// be in device or shared memory.
template <typename T>
__device__ bool warp_splice(const State<T>& s, const int32_t* eid_p,
                            const int32_t* ends, const T* frac_p,
                            const T* add_p, int i0, int middle, int outside,
                            int label, int block_slot, int32_t* out_xy,
                            int* count, Entry<T>* first, Blocked* bl)
{
    const int lane = threadIdx.x;
    const int E = s.n_edges;
    // the choice (and the chosen edge's ends, where the scorer read them):
    // one load a lane, the addresses chosen without a branch
    const int32_t* ip = lane == 0 ? eid_p
                        : (lane <= 3 && ends != nullptr ? ends + lane - 1
                                                        : nullptr);
    const T* fp = lane == 4 ? frac_p : (lane == 5 ? add_p : nullptr);
    int iv = ip != nullptr ? *ip : 0;
    const T fv = fp != nullptr ? *fp : T(0);
    const int xe = __shfl_sync(kFull, iv, 0);
    const T frac = __shfl_sync(kFull, fv, 4);
    const T add = __shfl_sync(kFull, fv, 5);
    *count = 0;
    if (xe < 0 || xe >= E) {
        if (lane < 2) out_xy[lane] = -1;
        return false;
    }
    if (ends == nullptr) {
        const int32_t* ep = lane == 1 ? s.belong + xe
                            : (lane == 2 ? s.e + xe
                                         : (lane == 3 ? s.rev + xe : nullptr));
        iv = ep != nullptr ? *ep : 0;
    }
    const int x = __shfl_sync(kFull, iv, 1);
    const int y = __shfl_sync(kFull, iv, 2);
    const int ye = __shfl_sync(kFull, iv, 3);  // stored as read
    const int yi = ye < 0 ? ye + E : ye;       // indexed as a tensor index is
    if (yi < 0 || yi >= E) {
        if (lane < 2) out_xy[lane] = -1;
        return false;
    }
    const int i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3;

    // one round trip: both halves' lists (lanes 0-9), the edge's length
    // (10), the blocked slot's ends (11, 12)
    const size_t at_list = (size_t)(lane < kK ? xe : yi) * kK + lane % kK;
    const T* lp = lane == 2 * kK ? s.length + xe : nullptr;
    const int32_t* bp =
        block_slot < 0 ? nullptr
        : (lane == 2 * kK + 1 ? s.belong + block_slot
                              : (lane == 2 * kK + 2 ? s.e + block_slot
                                                    : nullptr));
    T c = T(0);
    int32_t id = -1;
    if (lane < 2 * kK) {
        c = s.cdis[at_list];
        id = s.cid[at_list];
    }
    const T len = lp != nullptr ? *lp : T(0);
    const int bv = bp != nullptr ? *bp : -1;
    const T orig = __shfl_sync(kFull, len, 2 * kK);
    const T rest = sub_rn(orig, frac);
    // the ten candidates: cd_i1 (lanes 0-4), then cd_i0 (5-9), which is
    // (cd + orig) - frac, the reference's association
    T v = T(2);
    if (lane < kK) v = id != -1 ? add_rn(c, frac) : T(2);
    else if (lane < 2 * kK) v = id != -1 ? sub_rn(add_rn(c, orig), frac) : T(2);
    // _insert_merge_lists: the stable rank of each of the ten (the first
    // list wins ties, NaNs keep their order after every number), by the
    // values' keys in that order
    const auto key = sort_key(v);
    int r = 0;
#pragma unroll
    for (int j = 0; j < 2 * kK; ++j) {
        const auto kj = __shfl_sync(kFull, key, j);
        r += j < lane ? kj <= key : (j > lane ? kj < key : false);
    }
    // the six writes to e, length and rev in the plain version's order,
    // lane p's: at at[p], e, length and rev values below
    const int at[6] = {xe, yi, i0, i1, i2, i3};
    const int ne[6] = {middle, middle, x, y, middle, outside};
    // the blocked slot's ends as they stand after the splice
    int n_blocked = 0, b0 = -1, b1 = -1;
    if (block_slot >= 0) {
        b0 = __shfl_sync(kFull, bv, 2 * kK + 1);
        b1 = __shfl_sync(kFull, bv, 2 * kK + 2);
        if (block_slot >= i0 && block_slot <= i3)
            b0 = block_slot == i2 ? outside : middle;
#pragma unroll
        for (int p = 0; p < 6; ++p)
            if (at[p] == block_slot) b1 = ne[p];
        n_blocked = 2;
    }
    const bool outside_open = n_blocked == 0
                              || (outside != b0 && outside != b1);
    __syncwarp();  // every read above is done before the first write

    const int a = lane == 0 ? xe : (lane == 1 ? yi : i0 + lane - 2);
    if (lane < 6 && last_write(at, lane, a)) {
        s.e[a] = lane < 2 || lane == 4 ? middle
                 : (lane == 2 ? x : (lane == 3 ? y : outside));
        s.length[a] = lane == 0 || lane == 2 ? frac
                      : (lane == 1 || lane == 3 ? rest : add);
        s.rev[a] = lane == 0 ? i0 : (lane == 1 ? i1 : (lane == 2 ? xe
                   : (lane == 3 ? ye : (lane == 4 ? i3 : i2))));
    }
    if (lane < 4) s.belong[i0 + lane] = lane == 2 ? outside : middle;
    if (lane < kK) {
        s.cdis[(size_t)i1 * kK + lane] = v;
        s.cid[(size_t)i1 * kK + lane] = id;
    } else if (lane < 2 * kK) {
        s.cdis[(size_t)i0 * kK + lane - kK] = v;
        s.cid[(size_t)i0 * kK + lane - kK] = id;
    } else if (lane < 3 * kK) {
        // slot i2 (outside -> middle) after the BFS's first level: (0,
        // label) in front of the empty entries
        const bool first = lane == 2 * kK && outside_open;
        s.cdis[(size_t)i2 * kK + lane - 2 * kK] = first ? T(0) : T(2);
        s.cid[(size_t)i2 * kK + lane - 2 * kK] = first ? label : -1;
    } else if (lane >= 16 && lane < 22) {
        const int q = lane - 16;
        if (q >= 3 || middle != outside) {
            const int row = q < 3 ? middle : outside;
            s.adj[(size_t)row * kDegree + q % 3] =
                q == 0 ? i0 : (q == 1 ? i1 : (q == 2 ? i3 : (q == 3 ? i2 : -1)));
        }
    }
    if (lane < 2 * kK && r < kK) {
        s.cdis[(size_t)i3 * kK + r] = v;
        s.cid[(size_t)i3 * kK + r] = id;
    }
    if (lane == 0) {
        out_xy[0] = xe;
        out_xy[1] = yi;
    }
    *first = {middle, outside, add_rn(T(0), add)};
    *bl = {n_blocked, b0, b1};
    *count = outside_open ? 1 : 0;
    return true;
}


// D&C's member insertion by a block over a state in device memory (kernel
// 8a's block 0, kernel 8b's plan for buckets too wide for shared memory):
// warp 0 splices the choice in shared memory (eid, frac, add) at the
// member's slots i0 = n_used with middle 2 + cmax + kq, outside 2 + kq and
// label 10 + kq, clears the flags of the split edge's two slots and sets
// the new group's (true, true, false, true); then the block walks with
// slot 0's endpoints, as they stand after the splice, blocked. Every
// thread of the block calls it; it ends at a barrier of every thread.
// out_xy (shared) gets the splice's (xe, ye).
template <typename T, int Threads, int Cap>
__device__ void insert_member(const State<T>& s, Shared<T, Threads, Cap>& sh,
                              uint8_t* flags, const int32_t* eid,
                              const T* frac, const T* add, int n_used,
                              int kq, int cmax, int32_t* out_xy)
{
    const int label = 10 + kq;
    int count = 0;
    Entry<T> first = {-1, -1, T(0)};
    Blocked bl = {0, -1, -1};
    if (threadIdx.x < kWarp) {
        const int lane = threadIdx.x;
        const bool ok = warp_splice(s, eid, nullptr, frac, add, n_used,
                                    2 + cmax + kq, 2 + kq, label, 0, out_xy,
                                    &count, &first, &bl);
        __syncwarp();  // (xe, ye) written
        if (ok && lane < 2) flags[out_xy[lane]] = 0;
        __syncwarp();  // cleared before the new group is set
        if (lane >= 2 && lane < 6 && n_used + lane - 2 < s.n_edges)
            flags[n_used + lane - 2] = lane != 4;
        if (!ok) count = 0;
        if (lane == 0) {
            sh.label = label;
            sh.n_blocked = bl.n;
            sh.blocked[0] = bl.b0;
            sh.blocked[1] = bl.b1;
        }
        __syncwarp();  // the splice's writes before the walk's reads
    }
    walk(s, sh, first, count, 1, label, bl);
}

// visit on a state the calling warp alone touches: plain (generic) loads
template <typename T>
__device__ __forceinline__ bool visit_local(const State<T>& s, int node,
                                            int from, T d, int k, int label,
                                            Blocked bl, int* dst, T* nd)
{
    const int M = s.n_nodes, E = s.n_edges;
    const bool expand = node >= 0 && node < M && !(bl.n > 0 && node == bl.b0)
                        && !(bl.n > 1 && node == bl.b1);
    const int eid = expand ? s.adj[node * kDegree + k] : -1;
    if (eid < 0 || eid >= E) return false;
    T* cd = s.cdis + eid * kK;
    int32_t* ci = s.cid + eid * kK;
    const int to = s.e[eid];
    T c[kK];
    int32_t id[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) {
        c[q] = cd[q];
        id[q] = ci[q];
    }
    int pos = 0;
#pragma unroll
    for (int q = 0; q < kK; ++q) pos += c[q] <= d;
    if (to == from || pos >= kK) return false;
#pragma unroll
    for (int q = kK - 1; q >= 1; --q) {
        if (q > pos) {
            cd[q] = c[q - 1];
            ci[q] = id[q - 1];
        }
    }
    cd[pos] = d;
    ci[pos] = label;
    *dst = to;
    *nd = add_rn(d, s.length[eid]);
    return true;
}

// The walk by one warp alone from the one entry `e` at `level`: every
// level in chunks of kWarp (entry, out-edge) pairs, each chunk's joining
// lanes placed after the chunks before by a ballot (the flat order of
// every plan), the frontier in s.f_ids, s.f_frm, s.f_dist ([2, M],
// nothing spills). Ends at a __syncwarp.
template <typename T>
__device__ void walk_lanes(const State<T>& s, int lane, Entry<T> e,
                           int count, int level, int label, Blocked bl)
{
    const int M = s.n_nodes;
    int cur = 0;
    if (lane == 0) {
        s.f_ids[0] = e.node;
        s.f_frm[0] = e.from;
        s.f_dist[0] = e.dist;
    }
    __syncwarp();
    while (count > 0 && level < M) {
        const int items = kDegree * count;
        const int in = cur * M, out = (1 - cur) * M;
        int next = 0;
        for (int c0 = 0; c0 < items; c0 += kWarp) {
            const int j = c0 + lane;
            bool joins = false;
            int node = -1, dst = -1;
            T nd = T(0);
            if (j < items) {
                const int f = j / kDegree;
                node = s.f_ids[in + f];
                joins = visit_local(s, node, s.f_frm[in + f], s.f_dist[in + f],
                                    j - f * kDegree, label, bl, &dst, &nd);
            }
            const unsigned ballot = __ballot_sync(kFull, joins);
            const int at = next + __popc(ballot & ((1u << lane) - 1u));
            if (joins && at < M) {
                s.f_ids[out + at] = dst;
                s.f_frm[out + at] = node;
                s.f_dist[out + at] = nd;
            }
            next += __popc(ballot);
        }
        __syncwarp();  // the next level reads what this one wrote
        count = next < M ? next : M;
        cur ^= 1;
        ++level;
    }
}

// warp_splice on a state the calling warp alone touches, the choice (xe,
// frac, add) in every lane's registers: the same reads, rank of the ten
// candidates, writes and first level. *xy gets (xe, ye), or (-1, -1) and
// no write when xe or its reverse slot is not a slot of the state. Ends
// at a __syncwarp.
template <typename T>
__device__ bool splice_lanes(const State<T>& s, int lane, int xe, T frac,
                             T add, int i0, int middle, int outside,
                             int label, int block_slot, int* xy, int* count,
                             Entry<T>* first, Blocked* bl)
{
    const int E = s.n_edges;
    *count = 0;
    xy[0] = xy[1] = -1;
    if (xe < 0 || xe >= E) return false;
    const int x = s.belong[xe], y = s.e[xe], ye = s.rev[xe];
    const int yi = ye < 0 ? ye + E : ye;
    if (yi < 0 || yi >= E) return false;
    const int i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3;
    const int at_list = (lane < kK ? xe : yi) * kK + lane % kK;
    T c = T(0);
    int32_t id = -1;
    if (lane < 2 * kK) {
        c = s.cdis[at_list];
        id = s.cid[at_list];
    }
    const T orig = s.length[xe];
    const T rest = sub_rn(orig, frac);
    T v = T(2);
    if (lane < kK) v = id != -1 ? add_rn(c, frac) : T(2);
    else if (lane < 2 * kK) v = id != -1 ? sub_rn(add_rn(c, orig), frac) : T(2);
    const auto key = sort_key(v);
    int r = 0;
#pragma unroll
    for (int j = 0; j < 2 * kK; ++j) {
        const auto kj = __shfl_sync(kFull, key, j);
        r += j < lane ? kj <= key : (j > lane ? kj < key : false);
    }
    const int at[6] = {xe, yi, i0, i1, i2, i3};
    const int ne[6] = {middle, middle, x, y, middle, outside};
    int n_blocked = 0, b0 = -1, b1 = -1;
    if (block_slot >= 0) {
        b0 = s.belong[block_slot];
        b1 = s.e[block_slot];
        if (block_slot >= i0 && block_slot <= i3)
            b0 = block_slot == i2 ? outside : middle;
#pragma unroll
        for (int p = 0; p < 6; ++p)
            if (at[p] == block_slot) b1 = ne[p];
        n_blocked = 2;
    }
    const bool outside_open = n_blocked == 0
                              || (outside != b0 && outside != b1);
    __syncwarp();  // every read above is done before the first write

    const int a = lane == 0 ? xe : (lane == 1 ? yi : i0 + lane - 2);
    if (lane < 6 && last_write(at, lane, a)) {
        s.e[a] = lane < 2 || lane == 4 ? middle
                 : (lane == 2 ? x : (lane == 3 ? y : outside));
        s.length[a] = lane == 0 || lane == 2 ? frac
                      : (lane == 1 || lane == 3 ? rest : add);
        s.rev[a] = lane == 0 ? i0 : (lane == 1 ? i1 : (lane == 2 ? xe
                   : (lane == 3 ? ye : (lane == 4 ? i3 : i2))));
    }
    if (lane < 4) s.belong[i0 + lane] = lane == 2 ? outside : middle;
    if (lane < kK) {
        s.cdis[i1 * kK + lane] = v;
        s.cid[i1 * kK + lane] = id;
    } else if (lane < 2 * kK) {
        s.cdis[i0 * kK + lane - kK] = v;
        s.cid[i0 * kK + lane - kK] = id;
    } else if (lane < 3 * kK) {
        const bool first_entry = lane == 2 * kK && outside_open;
        s.cdis[i2 * kK + lane - 2 * kK] = first_entry ? T(0) : T(2);
        s.cid[i2 * kK + lane - 2 * kK] = first_entry ? label : -1;
    } else if (lane >= 16 && lane < 22) {
        const int q = lane - 16;
        if (q >= 3 || middle != outside) {
            const int row = q < 3 ? middle : outside;
            s.adj[row * kDegree + q % 3] =
                q == 0 ? i0 : (q == 1 ? i1 : (q == 2 ? i3 : (q == 3 ? i2 : -1)));
        }
    }
    if (lane < 2 * kK && r < kK) {
        s.cdis[i3 * kK + r] = v;
        s.cid[i3 * kK + r] = id;
    }
    xy[0] = xe;
    xy[1] = yi;
    *first = {middle, outside, add_rn(T(0), add)};
    *bl = {n_blocked, b0, b1};
    *count = outside_open ? 1 : 0;
    __syncwarp();  // the splice's writes before any later read
    return true;
}

}  // namespace dipper
