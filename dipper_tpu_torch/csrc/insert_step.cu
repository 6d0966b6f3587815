// The k-closest insertion step on Hopper (sm_90a): the splice of a new
// taxon onto its chosen edge and the witness BFS from it, in one launch
// that reads the choice on the card, so that an insertion needs no host
// round trip.
//
// Replaces the body of the JAX package's device-resident insert loop,
// dipper_tpu/placement/kclosest.py::_blocked_insert_loop (:857-882), an XLA
// program and not Pallas: after the scorer it runs `splice` (:542-613, with
// `_insert_merge_lists` :532-539) and the compact witness BFS
// `_update_closest_bfs_compact` (:221-311, a lax.while_loop over levels).
// The plain version is the port's tensor code, placement/kclosest.py::
// splice and _update_closest_bfs_compact (the CPU path, and this kernel's
// yardstick on the card); placement/insert_model.py is a numpy model of
// this file's plan.
//
// Entry points, each one block of kThreads threads on the caller's stream,
// none synchronizing:
//
// - insert_step: the splice, then the BFS from `outside`. With block_slot
//   >= 0 the endpoints of that slot as they stand after the splice are
//   dequeued but not expanded (D&C's cluster edge). (xe, ye) of the choice
//   go to out_xy.
// - closest_bfs: the BFS alone, from `leaf`, with up to kMaxBlocked
//   blocked nodes read from a device array.
// - insert_step_cursor, closest_bfs_cursor: the same, with the insertion
//   (or leaf) i and the slots in use read from a cursor on the card and
//   advanced by the launch (i + 1; slots + 4), so that one captured CUDA
//   graph of them serves every stretch of an insert range
//   (kclosest._insert_range, the counterpart of the JAX package's
//   fori_loop over a range). insert_step_cursor takes the scorer's
//   outputs: the chosen edge with its ends, and (frac, add).
// - insert_cursor_set writes a cursor; insert_step_preload loads every
//   kernel of this library, so that a capture loads none.
//
// The plan, for a card where one insertion is a chain of dependent L2
// reads and nothing else:
//
// - The splice is warp 0's: lanes read the choice, then both halves'
//   K-lists and the edge's length in one round trip; lane i ranks value i
//   of the ten candidates of the middle->outside list by integer keys (a
//   stable rank, NaN after every number, as torch.argsort(stable=True)
//   orders them); each
//   slot is written by one lane, and where two of the plain version's
//   statements write one address (only on a malformed choice) the later
//   statement's lane writes it. The BFS's first level (outside -> middle
//   over the fresh slot i2) is known from the splice and is written with
//   it, so the walk starts at middle.
// - A level's frontier (node, node it was reached from, distance) sits in
//   shared ping-pong buffers of kCap entries; entries from kCap on spill
//   to the [2, M] device scratch at the same index.
// - A level of at most kNarrow (entry, out-edge) pairs is warp 0's: each
//   lane visits one pair, __ballot_sync and __popc of the lanes below give
//   each joining entry its place, and __syncwarp ends the level. The other
//   warps wait at a block barrier that warp 0 reaches only when a level
//   turns wide; a wide level is the block's, in chunks of kThreads pairs
//   placed by a block-wide scan. Both place the next frontier in the flat
//   (entry, out-edge) order, the plain version's, whatever the chunk
//   width, so the kernel is deterministic.
// - A pair's visit reads the adjacency slot, then the edge's destination,
//   list, ids and length in one round trip: two dependent L2 reads a
//   level. The pair is skipped when the edge is empty, leads back or
//   leaves a blocked node; otherwise pos = #(cdis <= d) (a comparison with
//   NaN is false) and, when pos < K, (d, label) goes in at pos, the entries
//   from pos shift right and the last drops, and the far node joins the
//   next frontier at distance d + length.
// - Data the launch writes (e, length, rev, cdis, cid, adj, the scratch)
//   is read with plain loads, never through the read-only path.
//
// In a tree a level's frontier holds distinct nodes, so no two threads of
// a level touch one edge, and it never exceeds M; the walk ends within M
// levels on any input, and a frontier is cut at M entries, which also
// bounds a malformed state.
//
// What bounds it: neither bytes nor operations. An insertion at 30,000
// taxa touches some tens of edges in 6-10 levels (a few KB); the floor is
// the levels times two dependent L2 round trips. One block keeps the chain
// on one multiprocessor; the rest of the card is idle, as it is for the
// JAX package's loop body.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics; T = float or double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 5;  // placement/kclosest.py::K
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kDegree = 3;      // adjacency slots a node
constexpr int kMaxBlocked = 2;  // nodes a BFS may dequeue without expanding
// frontier entries a shared buffer holds (6 KB for both buffers in f32, 8 KB
// in f64): levels at 30,000 taxa hold a few nodes, the first BFSs over a
// balanced 1,024-leaf backbone up to 512 (those spill)
constexpr int kCap = 256;
constexpr int kNarrow = kWarp;  // pairs of a level that warp 0 takes alone
constexpr unsigned kFull = 0xffffffffu;

// the cursor of an insert range: insertion (or leaf) i, slots in use, the
// address of the range's first distance row, the rows' stride in elements,
// and the range's first insertion (int64 each)
enum { kCurI = 0, kCurUsed, kCurRows, kCurStride, kCurLo };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

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

template <typename T>
struct Shared {
    int32_t ids[2][kCap];  // the frontier's first kCap entries, ping-pong
    int32_t frm[2][kCap];
    T dist[2][kCap];
    int warp_sum[kWarps];
    int blocked[kMaxBlocked];
    int n_blocked;
    int label;
    int count, cur, level;  // the walk, handed from warp 0 to the block
};

template <typename T>
__device__ __forceinline__ void get_entry(const State<T>& s, const Shared<T>& sh,
                                          int buf, int f, int& id, int& frm,
                                          T& d)
{
    if (f < kCap) {
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

template <typename T>
__device__ __forceinline__ void put_entry(const State<T>& s, Shared<T>& sh,
                                          int buf, int at, int id, int frm,
                                          T d)
{
    if (at < kCap) {
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

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total)
{
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
        int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 1; off < kWarps; off *= 2) {
            const int y = __shfl_up_sync(kFull, w, off);
            if (lane >= off) w += y;
        }
        if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();
    const int excl = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
    *total = s_warp[kWarps - 1];
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

// One (frontier entry, out-edge k) pair: true when the far node joins the
// next frontier (at distance *nd, as *dst), after (d, label) went into the
// edge's list.
template <typename T>
__device__ __forceinline__ bool visit(const State<T>& s, int node, int from,
                                      T d, int k, int label, Blocked bl,
                                      int* dst, T* nd)
{
    const int M = s.n_nodes, E = s.n_edges;
    const bool expand = node >= 0 && node < M && !(bl.n > 0 && node == bl.b0)
                        && !(bl.n > 1 && node == bl.b1);
    const int eid = expand ? s.adj[(size_t)node * kDegree + k] : -1;
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

// Warp 0's narrow levels, the frontier in shared buffer `cur`: a lane a
// (entry, out-edge) pair, the next frontier placed by a ballot (the
// joining lanes below each lane) and the level ended by __syncwarp, with
// no block barrier. Returns when the walk is done (no entry, or M levels)
// or a level turns wide.
template <typename T>
__device__ void narrow_levels(const State<T>& s, Shared<T>& sh, int& cur,
                              int& count, int& level, int label, Blocked bl)
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
// kThreads; returns the next frontier's width.
template <typename T>
__device__ int wide_level(const State<T>& s, Shared<T>& sh, int cur,
                          int count, int label, Blocked bl)
{
    const int M = s.n_nodes;
    const int items = kDegree * count;
    int next = 0;
    for (int c0 = 0; c0 < items; c0 += kThreads) {
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
        const int at = next + block_exclusive_scan(joins, sh.warp_sum, &total);
        if (joins && at < M) put_entry(s, sh, 1 - cur, at, dst, node, nd);
        next += total;
    }
    __syncthreads();  // the next level reads what this one wrote
    return next < M ? next : M;
}

// The walk, by every thread of the block, from the one entry `e` (the
// others' arguments are not read) at `level`; warp 0 has written the
// label and the blocked nodes to shared memory. Warp 0 walks the narrow
// levels alone; the other warps wait at a barrier that it reaches when a
// level turns wide or the walk ends.
template <typename T>
__device__ void walk(const State<T>& s, Shared<T>& sh, Entry<T> e,
                     int count, int level, int label, Blocked bl)
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
            narrow_levels(s, sh, cur, count, level, label, bl);
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
        count = wide_level(s, sh, cur, count, label, bl);
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
// not read again.
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

// insert_step and insert_step_cursor; the cursor, when given, supplies i
// (middle = i + num_sequences - 1, outside = label = i) and i0 (the slots
// in use), and is advanced at the end
template <typename T>
__global__ void __launch_bounds__(kThreads)
insert_step_kernel(State<T> s, const int32_t* eid, const int32_t* ends,
                   const T* frac, const T* add, int i0, int middle,
                   int outside, int label, int block_slot, int32_t* out_xy,
                   long long* cursor, int num_sequences)
{
    __shared__ Shared<T> sh;
    long long ci = 0, cu = 0;
    int count = 0;
    Entry<T> first = {-1, -1, T(0)};
    Blocked bl = {0, -1, -1};
    if (threadIdx.x < kWarp) {
        bool ok = true;
        if (cursor != nullptr) {
            long long a = 0;
            if (threadIdx.x < 2) a = cursor[threadIdx.x];
            ci = __shfl_sync(kFull, a, kCurI);
            cu = __shfl_sync(kFull, a, kCurUsed);
            const long long mid = ci + num_sequences - 1;
            ok = cu >= 0 && cu <= s.n_edges - 4 && ci >= 0
                 && ci < s.n_nodes && mid >= 0 && mid < s.n_nodes;
            i0 = (int)cu;
            outside = label = (int)ci;
            middle = (int)mid;
        }
        if (ok) {
            ok = warp_splice(s, eid, ends, frac, add, i0, middle, outside,
                             label, block_slot, out_xy, &count, &first, &bl);
        } else if (threadIdx.x < 2) {
            out_xy[threadIdx.x] = -1;
        }
        if (!ok) count = 0;
        if (threadIdx.x == 0) {
            sh.label = label;
            sh.n_blocked = bl.n;
            sh.blocked[0] = bl.b0;
            sh.blocked[1] = bl.b1;
        }
        __syncwarp();  // the splice's writes before the walk's reads
    }
    walk(s, sh, first, count, 1, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) {
        cursor[kCurI] = ci + 1;
        cursor[kCurUsed] = cu + 4;
    }
}

// closest_bfs and closest_bfs_cursor; the cursor, when given, supplies the
// leaf (= label) and is advanced at the end
template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_kernel(State<T> s, int leaf, int label, const int32_t* blocked,
                   int n_blocked, long long* cursor)
{
    __shared__ Shared<T> sh;
    long long ci = 0;
    Blocked bl = {n_blocked, -1, -1};
    if (threadIdx.x < kWarp) {
        if (cursor != nullptr) {
            ci = cursor[kCurI];
            leaf = label = (int)(ci >= 0 && ci < s.n_nodes ? ci : -1);
        }
        if (n_blocked > 0) bl.b0 = blocked[0];
        if (n_blocked > 1) bl.b1 = blocked[1];
        if (threadIdx.x == 0) {
            sh.label = label;
            sh.n_blocked = bl.n;
            sh.blocked[0] = bl.b0;
            sh.blocked[1] = bl.b1;
        }
    }
    walk(s, sh, Entry<T>{leaf, -1, T(0)}, 1, 0, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) cursor[kCurI] = ci + 1;
}

// One thread follows `steps` links of `next` (a random cycle, read past
// L1): the latency of one dependent L2 round trip, the unit of this
// kernel's floor (chip_smoke.py phase 25 times it).
__global__ void chase_kernel(const int32_t* next, int steps, int32_t* out)
{
    int j = 0;
    for (int t = 0; t < steps; ++t) j = __ldcg(next + j);
    *out = j;
}

__global__ void cursor_set_kernel(long long* cursor, long long i,
                                  long long used, long long rows,
                                  long long stride, long long lo)
{
    cursor[kCurI] = i;
    cursor[kCurUsed] = used;
    cursor[kCurRows] = rows;
    cursor[kCurStride] = stride;
    cursor[kCurLo] = lo;
}

template <typename T>
State<T> make_state(void* e, void* belong, void* length, void* rev,
                    void* cdis, void* cid, void* adj, void* f_ids,
                    void* f_frm, void* f_dist, int n_edges, int n_nodes)
{
    return State<T>{(int32_t*)e, (int32_t*)belong, (T*)length,
                    (int32_t*)rev, (T*)cdis, (int32_t*)cid, (int32_t*)adj,
                    (int32_t*)f_ids, (int32_t*)f_frm, (T*)f_dist, n_edges,
                    n_nodes};
}

// cudaSetDevice(device) for the life of the object, the caller's device
// back after
struct OnDevice {
    int prev = -1;
    cudaError_t err = cudaSuccess;
    explicit OnDevice(int device)
    {
        err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    }
    ~OnDevice()
    {
        int now = -1;
        if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
            cudaSetDevice(prev);
    }
};

bool state_ok(int n_edges, int n_nodes)
{
    return n_edges >= 1 && n_nodes >= 1 && n_nodes <= (1 << 29);
}

template <typename T>
void launch_step(void* const* p, int n_edges, int n_nodes, const void* eid,
                 const void* ends, const void* frac, const void* add, int i0,
                 int middle, int outside, int label, int block_slot,
                 void* cursor, int num_sequences, cudaStream_t st)
{
    insert_step_kernel<T><<<1, kThreads, 0, st>>>(
        make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                      p[9], n_edges, n_nodes),
        (const int32_t*)eid, (const int32_t*)ends, (const T*)frac,
        (const T*)add, i0, middle, outside, label, block_slot,
        (int32_t*)p[10], (long long*)cursor, num_sequences);
}

template <typename T>
void launch_bfs(void* const* p, int n_edges, int n_nodes, int leaf,
                int label, const void* blocked, int n_blocked, void* cursor,
                cudaStream_t st)
{
    closest_bfs_kernel<T><<<1, kThreads, 0, st>>>(
        make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                      p[9], n_edges, n_nodes),
        leaf, label, (const int32_t*)blocked, n_blocked, (long long*)cursor);
}

}  // namespace

// State arguments of every entry point: e, belong, length, rev, cdis, cid,
// adj, f_ids, f_frm, f_dist (the [2, M] frontier spill), out_xy (int32
// [2]); n_edges, n_nodes; is_f64 (float or double lengths and lists); the
// device. Each launches on `stream` without synchronizing and returns the
// CUDA error code (0 on success).
#define STATE_PARAMS                                                          \
    void *e, void *belong, void *length, void *rev, void *cdis, void *cid,    \
        void *adj, void *f_ids, void *f_frm, void *f_dist, void *out_xy,      \
        int n_edges, int n_nodes, int is_f64, int device
#define STATE_PTRS {e, belong, length, rev, cdis, cid, adj, f_ids, f_frm, \
                    f_dist, out_xy}

// The splice and BFS of one insertion: the choice eid (int32), frac and add
// (T) are one element each on the card; the new slots are i0 .. i0 + 3;
// `label` is written into witness lists.
extern "C" int insert_step(STATE_PARAMS, const void* eid, const void* frac,
                           const void* add, int i0, int middle, int outside,
                           int label, int block_slot, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || i0 < 0 || i0 > n_edges - 4
        || middle < 0 || middle >= n_nodes || outside < 0
        || outside >= n_nodes || block_slot >= n_edges)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_step<double>(p, n_edges, n_nodes, eid, nullptr, frac, add, i0,
                            middle, outside, label, block_slot, nullptr, 0,
                            st);
    else
        launch_step<float>(p, n_edges, n_nodes, eid, nullptr, frac, add, i0,
                           middle, outside, label, block_slot, nullptr, 0, st);
    return (int)cudaGetLastError();
}

// The BFS alone from `leaf` (blocked: n_blocked <= 2 node ids on the card,
// or none).
extern "C" int closest_bfs(STATE_PARAMS, int leaf, int label,
                           const void* blocked, int n_blocked, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || leaf < 0 || leaf >= n_nodes
        || n_blocked < 0 || n_blocked > kMaxBlocked
        || (n_blocked > 0 && blocked == nullptr))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_bfs<double>(p, n_edges, n_nodes, leaf, label, blocked,
                           n_blocked, nullptr, st);
    else
        launch_bfs<float>(p, n_edges, n_nodes, leaf, label, blocked,
                          n_blocked, nullptr, st);
    return (int)cudaGetLastError();
}

// insert_step for insertion i = cursor[0] at slots cursor[1] ..: choice_i
// is the scorer's int32 [4] (eid, belong[eid], e[eid], rev[eid]), choice_f
// its T [2] (frac, add); the cursor (int64 [5]) advances by one insertion.
extern "C" int insert_step_cursor(STATE_PARAMS, const void* choice_i,
                                  const void* choice_f, void* cursor,
                                  int num_sequences, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr
        || choice_i == nullptr || choice_f == nullptr || num_sequences < 1)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* ci = (const int32_t*)choice_i;
    if (is_f64) {
        const double* cf = (const double*)choice_f;
        launch_step<double>(p, n_edges, n_nodes, ci, ci + 1, cf, cf + 1, 0, 0,
                            0, 0, -1, cursor, num_sequences, st);
    } else {
        const float* cf = (const float*)choice_f;
        launch_step<float>(p, n_edges, n_nodes, ci, ci + 1, cf, cf + 1, 0, 0,
                           0, 0, -1, cursor, num_sequences, st);
    }
    return (int)cudaGetLastError();
}

// closest_bfs from leaf = label = cursor[0], no blocked node; the cursor
// advances by one leaf.
extern "C" int closest_bfs_cursor(STATE_PARAMS, void* cursor, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_bfs<double>(p, n_edges, n_nodes, 0, 0, nullptr, 0, cursor, st);
    else
        launch_bfs<float>(p, n_edges, n_nodes, 0, 0, nullptr, 0, cursor, st);
    return (int)cudaGetLastError();
}

// Writes the cursor (int64 [5]): i, slots in use, the address of the
// range's first distance row (0 for none), the rows' stride in elements,
// the range's first insertion.
extern "C" int insert_cursor_set(void* cursor, long long i, long long used,
                                 long long rows, long long stride,
                                 long long lo, int device, void* stream)
{
    if (cursor == nullptr) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cursor_set_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long*)cursor, i, used, rows, stride, lo);
    return (int)cudaGetLastError();
}

// Launches chase_kernel: `steps` dependent reads through `next` (int32, a
// cycle), the last index to `out`.
extern "C" int insert_step_chase(const void* next, int steps, void* out,
                                 int device, void* stream)
{
    if (next == nullptr || out == nullptr || steps < 0)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next,
                                                     steps, (int32_t*)out);
    return (int)cudaGetLastError();
}

// Loads every kernel of the library on `device` (under lazy module loading
// a kernel is loaded at its first launch, which a stream capture must not
// be).
extern "C" int insert_step_preload(int device)
{
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cudaFuncAttributes a;
    const void* fns[] = {(const void*)insert_step_kernel<float>,
                         (const void*)insert_step_kernel<double>,
                         (const void*)closest_bfs_kernel<float>,
                         (const void*)closest_bfs_kernel<double>,
                         (const void*)cursor_set_kernel,
                         (const void*)chase_kernel};
    for (const void* f : fns) {
        const cudaError_t err = cudaFuncGetAttributes(&a, f);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

extern "C" const char* insert_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
