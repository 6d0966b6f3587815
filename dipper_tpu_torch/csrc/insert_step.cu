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
// this file's plan. The splice and the walk are in insert_step.cuh, which
// D&C's cluster build (dc_cluster_build.cu) shares.
//
// Entry points, each one block of kThreads threads on the caller's stream,
// none synchronizing:
//
// - insert_step: the splice, then the BFS from `outside`. (xe, ye) of the
//   choice go to out_xy.
// - closest_bfs: the BFS alone, from `leaf`, with up to kMaxBlocked
//   blocked nodes read from a device array.
// - insert_step_cursor, closest_bfs_cursor: the same, with the insertion
//   (or leaf) i and the slots in use read from a cursor on the card and
//   advanced by the launch (i + 1; slots + 4), so that one captured CUDA
//   graph of them serves every stretch of an insert range
//   (kclosest._insert_range, the counterpart of the JAX package's
//   fori_loop over a range). insert_step_cursor takes the scorer's
//   outputs: the chosen edge with its ends, and (frac, add), and places
//   insertion i by offsets: outside i + o, middle i + m, label i + l, and a
//   blocked slot (placement: 0, N - 1, 0 and none; a D&C streamed cluster:
//   2, 2 + cmax, 10 and slot 0).
// - insert_cursor_set writes a cursor; insert_step_preload loads every
//   kernel of this library, so that a capture loads none.
// Each of the four launches the wide instantiation when it is given a
// wide table (below).
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
// The wide instantiation (insert_step_wide_kernel, closest_bfs_wide_kernel;
// the same entry points, given a wide table) takes a tree whose nodes may
// have any degree: a multifurcating --add backbone, the port of the JAX
// package's run_add_queries(use_adj=False) (kclosest.py:1207) and its
// dense witness BFS _update_closest_bfs_dense (:143-219), whose plain
// version is kclosest._update_closest_bfs_dense. Node w of degree > 3 has
// the adjacency row (-2 - w, -1, -1) and its out-edges in eid[off[w] ..
// off[w + 1]) (kclosest.wide_adjacency_from_edges); the table never
// changes, since a splice rewrites only the two new nodes' rows, both of
// degree <= 3. A level's pairs are its entries' three slots, as above,
// then the wide entries' out-edges: the prefix sum of their degrees.
// - A level is warp 0's when it has at most kNarrow slots and at most
//   kNarrow wide pairs: the slot lanes read the rows, a wide entry's lane
//   its degree, a warp scan sums the degrees, and a lane of the second
//   round finds its entry by a binary search over the lanes' sums
//   (shuffles); its joins are placed after the slots' joins.
// - Otherwise the block takes the level whole: the slots in chunks of
//   kThreads, one scan placing both the joins and the wide entries on a
//   list (shared memory, kCap entries, the rest in a [3, M] scratch), a
//   scan of the list's degrees, then the wide pairs in chunks of
//   kThreads, each thread finding its entry by a binary search over the
//   list's first pairs.
// In a tree the BFS visits each directed edge at most once and inserts
// into distinct edges commute, so the order of a frontier does not change
// the state: it equals the dense BFS's bit for bit. The binary
// instantiation is compiled as before (the wide code is in templates
// that it does not instantiate).
//
// What bounds it: neither bytes nor operations. An insertion at 30,000
// taxa touches some tens of edges in 6-10 levels (a few KB); the floor is
// the levels times two dependent L2 round trips. One block keeps the chain
// on one multiprocessor; the rest of the card is idle, as it is for the
// JAX package's loop body.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics; T = float or double.

#include "insert_step.cuh"

namespace {

using namespace dipper;

// frontier entries a shared buffer holds (6 KB for both buffers in f32, 8 KB
// in f64): levels at 30,000 taxa hold a few nodes, the first BFSs over a
// balanced 1,024-leaf backbone up to 512 (those spill)
constexpr int kCap = 256;

static_assert(kCap >= 2 * kNarrow, "a narrow level's two rounds of joins "
              "stay shared");

// A tree's out-edges beyond the [M, 3] rows (see the top of the file)
struct WideTable {
    const int32_t* off;  // [n_wide + 1]
    const int32_t* eid;  // [off[n_wide]]
    int32_t* list;       // [3, M] scratch: a level's wide entries past kCap
    int n_wide;
};

// A wide level's list of wide entries (frontier index, first out-edge,
// first pair), the first kCap in shared memory
struct WideList {
    int f[kCap], base[kCap], start[kCap];
};

__device__ __forceinline__ int* list_at(const WideTable& wt, WideList& wl,
                                        int q, int i, int M)
{
    if (i < kCap) return q == 0 ? &wl.f[i] : (q == 1 ? &wl.base[i]
                                                     : &wl.start[i]);
    return wt.list + (size_t)q * M + i;
}

// The wide node that a first slot marks: true, with its first out-edge
// and degree, when `slot` is a mark of the table
__device__ __forceinline__ bool wide_node(const WideTable& wt, int slot,
                                          int* base, int* deg)
{
    const int w = -2 - slot;
    if (slot > -2 || w >= wt.n_wide) return false;
    *base = load_now(wt.off + w);
    *deg = load_now(wt.off + w + 1) - *base;
    return true;
}

// Warp 0's narrow levels of the wide instantiation: a lane a slot of the
// first round, then a lane a wide pair. Returns as narrow_levels does, or
// when a level has more than kNarrow wide pairs (nothing of it visited).
template <typename T>
__device__ void narrow_levels_wide(const State<T>& s, const WideTable& wt,
                                   Shared<T, kThreads, kCap>& sh, int& cur,
                                   int& count, int& level, int label,
                                   Blocked bl)
{
    const int lane = threadIdx.x;
    const int M = s.n_nodes;
    while (count > 0 && level < M && kDegree * count <= kNarrow) {
        const int f = lane / kDegree;
        int node = -1, from = -1, slot = -1, base = 0, deg = 0;
        T d = T(0);
        if (lane < kDegree * count) {
            node = sh.ids[cur][f];
            from = sh.frm[cur][f];
            d = sh.dist[cur][f];
            slot = slot_of(s, node, lane - f * kDegree, bl);
        }
        wide_node(wt, slot, &base, &deg);
        int incl = deg;  // the degrees' inclusive sum over the lanes
#pragma unroll
        for (int o = 1; o < kWarp; o *= 2) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
        }
        const int pairs = __shfl_sync(kFull, incl, kWarp - 1);
        if (pairs > kNarrow) return;  // the block's level
        // a mark is no slot: visit_edge takes none
        int dst = -1;
        T nd = T(0);
        bool joins = visit_edge(s, slot, from, d, label, &dst, &nd);
        unsigned ballot = __ballot_sync(kFull, joins);
        int at = __popc(ballot & ((1u << lane) - 1u));
        if (joins && at < M) {
            sh.ids[1 - cur][at] = dst;
            sh.frm[1 - cur][at] = node;
            sh.dist[1 - cur][at] = nd;
        }
        int next = __popc(ballot);
        if (pairs > 0) {
            // lane j's entry: the first lane whose sum exceeds j
            int owner = 0;
#pragma unroll
            for (int step = kWarp / 2; step >= 1; step /= 2) {
                const int v = __shfl_sync(kFull, incl, owner + step - 1);
                if (v <= lane) owner += step;
            }
            const int o_node = __shfl_sync(kFull, node, owner);
            const int o_from = __shfl_sync(kFull, from, owner);
            const T o_d = __shfl_sync(kFull, d, owner);
            const int o_first = __shfl_sync(kFull, base - (incl - deg),
                                            owner);
            joins = lane < pairs
                    && visit_edge(s, load_now(wt.eid + o_first + lane),
                                  o_from, o_d, label, &dst, &nd);
            ballot = __ballot_sync(kFull, joins);
            at = next + __popc(ballot & ((1u << lane) - 1u));
            if (joins && at < M) {
                sh.ids[1 - cur][at] = dst;
                sh.frm[1 - cur][at] = o_node;
                sh.dist[1 - cur][at] = nd;
            }
            next += __popc(ballot);
        }
        __syncwarp();  // the next level reads what this one wrote
        count = next < M ? next : M;
        cur ^= 1;
        ++level;
    }
}

// A level of the wide instantiation by the whole block; returns the next
// frontier's width.
template <typename T>
__device__ int wide_level_wide(const State<T>& s, const WideTable& wt,
                               Shared<T, kThreads, kCap>& sh, WideList& wl,
                               int cur, int count, int label, Blocked bl)
{
    const int M = s.n_nodes;
    const int items = kDegree * count;
    int next = 0, n_wide = 0;
    // the slots; a wide entry's mark puts it on the list, its degree in
    // the place of its first pair
    for (int c0 = 0; c0 < items; c0 += kThreads) {
        const int j = c0 + threadIdx.x;
        bool joins = false, wide = false;
        int node = -1, dst = -1, f = 0, base = 0, deg = 0;
        T nd = T(0);
        if (j < items) {
            f = j / kDegree;
            int from;
            T d;
            get_entry(s, sh, cur, f, node, from, d);
            const int slot = slot_of(s, node, j - f * kDegree, bl);
            wide = wide_node(wt, slot, &base, &deg);
            joins = visit_edge(s, slot, from, d, label, &dst, &nd);
        }
        int total;
        const int ex = block_exclusive_scan<kThreads>(
            (int)joins | ((int)wide << 16), sh.warp_sum, &total);
        const int at = next + (ex & 0xffff);
        if (joins && at < M) put_entry(s, sh, 1 - cur, at, dst, node, nd);
        if (wide) {
            const int i = n_wide + (ex >> 16);
            *list_at(wt, wl, 0, i, M) = f;
            *list_at(wt, wl, 1, i, M) = base;
            *list_at(wt, wl, 2, i, M) = deg;
        }
        next += total & 0xffff;
        n_wide += total >> 16;
    }
    __syncthreads();  // the list is written
    if (n_wide > 0) {
        // each wide entry's first pair: the exclusive sum of the degrees
        int pairs = 0;
        for (int c0 = 0; c0 < n_wide; c0 += kThreads) {
            const int i = c0 + threadIdx.x;
            int* at = i < n_wide ? list_at(wt, wl, 2, i, M) : nullptr;
            const int deg = at != nullptr ? *at : 0;
            int total;
            const int ex =
                block_exclusive_scan<kThreads>(deg, sh.warp_sum, &total);
            if (at != nullptr) *at = pairs + ex;
            pairs += total;
        }
        __syncthreads();  // the first pairs are written
        for (int c0 = 0; c0 < pairs; c0 += kThreads) {
            const int j = c0 + threadIdx.x;
            bool joins = false;
            int node = -1, dst = -1;
            T nd = T(0);
            if (j < pairs) {
                // the last list entry whose first pair is at most j
                int lo = 0, hi = n_wide;
                while (hi - lo > 1) {
                    const int mid = (lo + hi) / 2;
                    if (*list_at(wt, wl, 2, mid, M) <= j) lo = mid;
                    else hi = mid;
                }
                int from;
                T d;
                get_entry(s, sh, cur, *list_at(wt, wl, 0, lo, M), node, from,
                          d);
                const int eid = load_now(wt.eid + *list_at(wt, wl, 1, lo, M)
                                         + j - *list_at(wt, wl, 2, lo, M));
                joins = visit_edge(s, eid, from, d, label, &dst, &nd);
            }
            int total;
            const int at =
                next + block_exclusive_scan<kThreads>(joins, sh.warp_sum,
                                                      &total);
            if (joins && at < M) put_entry(s, sh, 1 - cur, at, dst, node, nd);
            next += total;
        }
        __syncthreads();  // the next level reads what this one wrote
    }
    return next < M ? next : M;
}

// walk's levels over a wide table: narrow_levels_wide and wide_level_wide
template <typename T>
struct WideLevels {
    const WideTable& wt;
    WideList& wl;
    __device__ void narrow(const State<T>& s, Shared<T, kThreads, kCap>& sh,
                           int& cur, int& count, int& level, int label,
                           Blocked bl) const
    {
        narrow_levels_wide(s, wt, sh, cur, count, level, label, bl);
    }
    __device__ int wide(const State<T>& s, Shared<T, kThreads, kCap>& sh,
                        int cur, int count, int label, Blocked bl) const
    {
        return wide_level_wide(s, wt, sh, wl, cur, count, label, bl);
    }
};

// the cursor of an insert range: insertion (or leaf) i, slots in use, the
// address of the range's first distance row, the rows' stride in elements,
// and the range's first insertion (int64 each)
enum { kCurI = 0, kCurUsed, kCurRows, kCurStride, kCurLo };

// The offsets of a cursor launch's nodes and label from its insertion i
struct Offsets {
    int outside, middle, label;
};

// insert_step and insert_step_cursor, over the [M, 3] rows or (Wide) a
// wide table; the cursor, when given, supplies i (outside = i +
// off.outside, middle = i + off.middle, label = i + off.label) and i0 (the
// slots in use), and is advanced at the end
template <typename T, bool Wide>
__device__ __forceinline__ void insert_step_body(
    State<T> s, Shared<T, kThreads, kCap>& sh, const int32_t* eid,
    const int32_t* ends, const T* frac, const T* add, int i0, int middle,
    int outside, int label, int block_slot, int32_t* out_xy,
    long long* cursor, Offsets off, WideTable wt, WideList* wl)
{
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
            const long long out = ci + off.outside, mid = ci + off.middle;
            ok = cu >= 0 && cu <= s.n_edges - 4 && out >= 0
                 && out < s.n_nodes && mid >= 0 && mid < s.n_nodes;
            i0 = (int)cu;
            outside = (int)out;
            middle = (int)mid;
            label = (int)(ci + off.label);
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
    if constexpr (Wide)
        walk(s, sh, first, count, 1, label, bl, WideLevels<T>{wt, *wl});
    else
        walk(s, sh, first, count, 1, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) {
        cursor[kCurI] = ci + 1;
        cursor[kCurUsed] = cu + 4;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
insert_step_kernel(State<T> s, const int32_t* eid, const int32_t* ends,
                   const T* frac, const T* add, int i0, int middle,
                   int outside, int label, int block_slot, int32_t* out_xy,
                   long long* cursor, Offsets off)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    insert_step_body<T, false>(s, sh, eid, ends, frac, add, i0, middle,
                               outside, label, block_slot, out_xy, cursor,
                               off, WideTable{}, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
insert_step_wide_kernel(State<T> s, const int32_t* eid, const int32_t* ends,
                        const T* frac, const T* add, int i0, int middle,
                        int outside, int label, int block_slot,
                        int32_t* out_xy, long long* cursor, Offsets off,
                        WideTable wt)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    __shared__ WideList wl;
    insert_step_body<T, true>(s, sh, eid, ends, frac, add, i0, middle,
                              outside, label, block_slot, out_xy, cursor, off,
                              wt, &wl);
}

// closest_bfs and closest_bfs_cursor (Wide: over a wide table); the
// cursor, when given, supplies the leaf (= label) and is advanced at the
// end
template <typename T, bool Wide>
__device__ __forceinline__ void closest_bfs_body(
    State<T> s, Shared<T, kThreads, kCap>& sh, int leaf, int label,
    const int32_t* blocked, int n_blocked, long long* cursor, WideTable wt,
    WideList* wl)
{
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
    if constexpr (Wide)
        walk(s, sh, Entry<T>{leaf, -1, T(0)}, 1, 0, label, bl,
             WideLevels<T>{wt, *wl});
    else
        walk(s, sh, Entry<T>{leaf, -1, T(0)}, 1, 0, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) cursor[kCurI] = ci + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_kernel(State<T> s, int leaf, int label, const int32_t* blocked,
                   int n_blocked, long long* cursor)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    closest_bfs_body<T, false>(s, sh, leaf, label, blocked, n_blocked, cursor,
                               WideTable{}, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_wide_kernel(State<T> s, int leaf, int label,
                        const int32_t* blocked, int n_blocked,
                        long long* cursor, WideTable wt)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    __shared__ WideList wl;
    closest_bfs_body<T, true>(s, sh, leaf, label, blocked, n_blocked, cursor,
                              wt, &wl);
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
                 void* cursor, Offsets off, const WideTable& wt,
                 cudaStream_t st)
{
    const State<T> s = make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5],
                                     p[6], p[7], p[8], p[9], n_edges,
                                     n_nodes);
    if (wt.off != nullptr)
        insert_step_wide_kernel<T><<<1, kThreads, 0, st>>>(
            s, (const int32_t*)eid, (const int32_t*)ends, (const T*)frac,
            (const T*)add, i0, middle, outside, label, block_slot,
            (int32_t*)p[10], (long long*)cursor, off, wt);
    else
        insert_step_kernel<T><<<1, kThreads, 0, st>>>(
            s, (const int32_t*)eid, (const int32_t*)ends, (const T*)frac,
            (const T*)add, i0, middle, outside, label, block_slot,
            (int32_t*)p[10], (long long*)cursor, off);
}

template <typename T>
void launch_bfs(void* const* p, int n_edges, int n_nodes, int leaf,
                int label, const void* blocked, int n_blocked, void* cursor,
                const WideTable& wt, cudaStream_t st)
{
    const State<T> s = make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5],
                                     p[6], p[7], p[8], p[9], n_edges,
                                     n_nodes);
    if (wt.off != nullptr)
        closest_bfs_wide_kernel<T><<<1, kThreads, 0, st>>>(
            s, leaf, label, (const int32_t*)blocked, n_blocked,
            (long long*)cursor, wt);
    else
        closest_bfs_kernel<T><<<1, kThreads, 0, st>>>(
            s, leaf, label, (const int32_t*)blocked, n_blocked,
            (long long*)cursor);
}

// The wide table of the entry points' arguments: none where wide_off is
// null; else it needs the list scratch and n_wide >= 1
bool wide_ok(const void* wide_off, const void* wide_eid,
             const void* wide_list, int n_wide)
{
    return wide_off == nullptr
           || (wide_eid != nullptr && wide_list != nullptr && n_wide >= 1);
}

}  // namespace

// State arguments of every entry point: e, belong, length, rev, cdis, cid,
// adj, f_ids, f_frm, f_dist (the [2, M] frontier spill), out_xy (int32
// [2]); the wide table, or null pointers and 0 for a binary state:
// wide_off (int32 [n_wide + 1]), wide_eid, wide_list (int32 [3, M]
// scratch), n_wide; n_edges, n_nodes; is_f64 (float or double lengths and
// lists); the device. Each launches on `stream` without synchronizing and
// returns the CUDA error code (0 on success).
#define STATE_PARAMS                                                          \
    void *e, void *belong, void *length, void *rev, void *cdis, void *cid,    \
        void *adj, void *f_ids, void *f_frm, void *f_dist, void *out_xy,      \
        void *wide_off, void *wide_eid, void *wide_list, int n_wide,          \
        int n_edges, int n_nodes, int is_f64, int device
#define STATE_PTRS {e, belong, length, rev, cdis, cid, adj, f_ids, f_frm, \
                    f_dist, out_xy}
#define WIDE_TABLE WideTable{(const int32_t*)wide_off,               \
                             (const int32_t*)wide_eid,               \
                             (int32_t*)wide_list, n_wide}

// The splice and BFS of one insertion: the choice eid (int32), frac and add
// (T) are one element each on the card; the new slots are i0 .. i0 + 3;
// `label` is written into witness lists.
extern "C" int insert_step(STATE_PARAMS, const void* eid, const void* frac,
                           const void* add, int i0, int middle, int outside,
                           int label, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || i0 < 0 || i0 > n_edges - 4
        || middle < 0 || middle >= n_nodes || outside < 0
        || outside >= n_nodes
        || !wide_ok(wide_off, wide_eid, wide_list, n_wide))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_step<double>(p, n_edges, n_nodes, eid, nullptr, frac, add, i0,
                            middle, outside, label, -1, nullptr, Offsets{},
                            WIDE_TABLE, st);
    else
        launch_step<float>(p, n_edges, n_nodes, eid, nullptr, frac, add, i0,
                           middle, outside, label, -1, nullptr, Offsets{},
                           WIDE_TABLE, st);
    return (int)cudaGetLastError();
}

// The BFS alone from `leaf` (blocked: n_blocked <= 2 node ids on the card,
// or none).
extern "C" int closest_bfs(STATE_PARAMS, int leaf, int label,
                           const void* blocked, int n_blocked, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || leaf < 0 || leaf >= n_nodes
        || n_blocked < 0 || n_blocked > kMaxBlocked
        || (n_blocked > 0 && blocked == nullptr)
        || !wide_ok(wide_off, wide_eid, wide_list, n_wide))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_bfs<double>(p, n_edges, n_nodes, leaf, label, blocked,
                           n_blocked, nullptr, WIDE_TABLE, st);
    else
        launch_bfs<float>(p, n_edges, n_nodes, leaf, label, blocked,
                          n_blocked, nullptr, WIDE_TABLE, st);
    return (int)cudaGetLastError();
}

// insert_step for insertion i = cursor[0] at slots cursor[1] ..: choice_i
// is the scorer's int32 [4] (eid, belong[eid], e[eid], rev[eid]), choice_f
// its T [2] (frac, add); outside i + off_outside, middle i + off_middle,
// label i + off_label; with block_slot >= 0 the endpoints of that slot as
// they stand after the splice are dequeued but not expanded (D&C's cluster
// edge), -1 for none. The cursor (int64 [5]) advances by one insertion.
extern "C" int insert_step_cursor(STATE_PARAMS, const void* choice_i,
                                  const void* choice_f, void* cursor,
                                  int off_outside, int off_middle,
                                  int off_label, int block_slot, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr
        || choice_i == nullptr || choice_f == nullptr
        || block_slot >= n_edges
        || !wide_ok(wide_off, wide_eid, wide_list, n_wide))
        return (int)cudaErrorInvalidValue;
    const Offsets off = {off_outside, off_middle, off_label};
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* ci = (const int32_t*)choice_i;
    if (is_f64) {
        const double* cf = (const double*)choice_f;
        launch_step<double>(p, n_edges, n_nodes, ci, ci + 1, cf, cf + 1, 0, 0,
                            0, 0, block_slot, cursor, off, WIDE_TABLE, st);
    } else {
        const float* cf = (const float*)choice_f;
        launch_step<float>(p, n_edges, n_nodes, ci, ci + 1, cf, cf + 1, 0, 0,
                           0, 0, block_slot, cursor, off, WIDE_TABLE, st);
    }
    return (int)cudaGetLastError();
}

// closest_bfs from leaf = label = cursor[0], no blocked node; the cursor
// advances by one leaf.
extern "C" int closest_bfs_cursor(STATE_PARAMS, void* cursor, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr
        || !wide_ok(wide_off, wide_eid, wide_list, n_wide))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_bfs<double>(p, n_edges, n_nodes, 0, 0, nullptr, 0, cursor,
                           WIDE_TABLE, st);
    else
        launch_bfs<float>(p, n_edges, n_nodes, 0, 0, nullptr, 0, cursor,
                          WIDE_TABLE, st);
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
                         (const void*)insert_step_wide_kernel<float>,
                         (const void*)insert_step_wide_kernel<double>,
                         (const void*)closest_bfs_wide_kernel<float>,
                         (const void*)closest_bfs_wide_kernel<double>,
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
