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
// - closest_bfs_range (a wide table only): the BFS alone from a range of
//   leaves in one persistent launch, the seeding of a multifurcating --add
//   backbone (see "The seeding range" below); closest_bfs_range_budget
//   gives the shared memory it may take.
// - closest_bfs_wide_stamped: closest_bfs_cursor's wide instantiation
//   with clock64 stamps by part on thread 0 (the launch, the narrow
//   levels, the wide levels' slot passes, degree scans and wide-pair
//   passes, thread 0's reads past the shared buffers), as the range
//   kernel's stamped instance has them a leaf: what the per-leaf route's
//   time is made of.
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
//   its degree; where the level has a wide entry, a warp scan sums the
//   degrees and a lane of the second round finds its entry by a binary
//   search over the lanes' sums (shuffles). A lane's slot pair and wide
//   pair are read in one round trip, and the wide pairs' joins are placed
//   after the slots' joins.
// - Otherwise the block takes the level whole: the slots in chunks of the
//   block's width, one scan placing both the joins and the wide entries on
//   a list (shared memory, the rest in a [3, M] scratch), a scan of the
//   list's degrees, then the wide pairs in chunks, each thread finding its
//   entry by a binary search over the list's first pairs.
// - The walk (wide_walk) runs over a WideMem: the frontier's buffers, the
//   list and the table, wherever they lie. The per-leaf kernels' is
//   static, kCap entries each; the range kernel's is sized at launch.
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

// frontier entries, and wide-list items, that the per-leaf kernels' shared
// buffers hold (6 KB for both frontier buffers in f32, 8 KB in f64, 3 KB
// of list): levels at 30,000 taxa hold a few nodes, the first BFSs over a
// balanced 1,024-leaf backbone up to 512 (those spill)
constexpr int kCap = 256;

// the range kernel's block (see "The seeding range" below): its wide
// levels go in chunks of 512 pairs, its narrow levels stay warp 0's. On
// phase 30's backbone 512 threads took the early leaves' wide levels
// nearly as fast as 1,024 and the late leaves' fastest (PERF.md, PR 23).
constexpr int kRangeThreads = 512;

// A tree's out-edges beyond the [M, 3] rows (see the top of the file)
struct WideTable {
    const int32_t* off;  // [n_wide + 1]
    const int32_t* eid;  // [off[n_wide]]
    int32_t* list;       // [3, M] scratch: a level's wide entries past the
                         // shared list
    int n_wide;
};

// A per-leaf kernel's wide list: (frontier index, first out-edge, first
// pair) of a level's first kCap wide entries
struct WideList {
    int f[kCap], base[kCap], start[kCap];
};

// the walk's hand-over from warp 0 to the block: the frontier's width and
// buffer, the level, the label and the blocked nodes
enum {
    kCtlCount = 0, kCtlCur, kCtlLevel, kCtlLabel, kCtlBlocked, kCtlB0,
    kCtlB1, kCtlWords
};

// The memory of a walk over a wide table: the frontier's two buffers of
// `cap` entries and the wide list's `lcap` items in shared memory, the
// entries past them in the [2, M] and [3, M] scratch; the table's offsets
// and out-edges (in shared memory where a range launch staged them, else
// the table's own); the block's scan words and the hand-over (ctl). A
// per-leaf kernel's is static (kCap each); a range launch's is carved from
// its dynamic shared memory at capacities chosen at launch.
template <typename T>
struct WideMem {
    T* dist;                       // [2, cap]
    int32_t *ids, *frm;            // [2, cap]
    int32_t *lf, *lbase, *lstart;  // [lcap] each
    const int32_t *off, *eid;
    int32_t* list;
    int* warp_sum;
    int* ctl;  // [kCtlWords]
    int cap, lcap, n_wide;
};

// The stamped instances' words a leaf (int64): clock64 at the leaf's start
// (a launch's first leaf: at the launch's), at its walk's first level and
// at its end; cycles in narrow levels, in wide levels' slot passes, degree
// scans and wide-pair passes, and in thread 0's reads past the shared
// buffers (frontier entries, wide-list items); %globaltimer (ns) at the
// start and the end; narrow and wide levels; thread 0's reads past the
// buffers; a sink that the timed reads store to
enum {
    kStStart = 0, kStFirst, kStEnd, kStNarrow, kStSlots, kStScan, kStPairs,
    kStSpill, kStTimerStart, kStTimerEnd, kStNarrowLevels, kStWideLevels,
    kStSpillReads, kStSink, kStampWords = 16
};

__device__ __forceinline__ long long global_ns()
{
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// *p; in a stamped instance, thread 0's read past the shared buffers
// (`past`) is timed: its value goes to the sink before the clock is read
// again, so the read has landed
template <bool Stamp, typename V>
__device__ __forceinline__ V read_past(const V* p, bool past, long long* acc)
{
    if constexpr (Stamp) {
        if (threadIdx.x == 0 && past) {
            const long long t = clock64();
            const V v = *(const volatile V*)p;
            *(volatile long long*)&acc[kStSink] = (long long)v;
            acc[kStSpill] += clock64() - t;
            acc[kStSpillReads] += 1;
            return v;
        }
    }
    return *p;
}

// thread 0 of a stamped instance adds the cycles since `t` to word k and
// returns the clock
template <bool Stamp>
__device__ __forceinline__ long long lap(long long* acc, int k, long long t)
{
    if constexpr (Stamp) {
        if (threadIdx.x == 0) {
            const long long now = clock64();
            acc[k] += now - t;
            return now;
        }
    }
    return t;
}

template <bool Stamp>
__device__ __forceinline__ long long clock_if()
{
    if constexpr (Stamp) return clock64();
    return 0;
}

// frontier entry f of buffer `buf`: shared below cap, else the scratch
template <bool Stamp, typename T>
__device__ __forceinline__ void wide_get(const State<T>& s,
                                         const WideMem<T>& m, int buf, int f,
                                         int& id, int& frm, T& d,
                                         long long* acc)
{
    if (f < m.cap) {
        const int o = buf * m.cap + f;
        id = m.ids[o];
        frm = m.frm[o];
        d = m.dist[o];
    } else {
        const size_t o = (size_t)buf * s.n_nodes + f;
        id = read_past<Stamp>(s.f_ids + o, true, acc);
        frm = read_past<Stamp>(s.f_frm + o, true, acc);
        d = read_past<Stamp>(s.f_dist + o, true, acc);
    }
}

template <typename T>
__device__ __forceinline__ void wide_put(const State<T>& s,
                                         const WideMem<T>& m, int buf,
                                         int at, int id, int frm, T d)
{
    if (at < m.cap) {
        const int o = buf * m.cap + at;
        m.ids[o] = id;
        m.frm[o] = frm;
        m.dist[o] = d;
    } else {
        const size_t o = (size_t)buf * s.n_nodes + at;
        s.f_ids[o] = id;
        s.f_frm[o] = frm;
        s.f_dist[o] = d;
    }
}

// word q (0 frontier index, 1 first out-edge, 2 first pair) of wide-list
// item i: shared below lcap, else the [3, M] scratch
template <typename T>
__device__ __forceinline__ int* wide_list_at(const WideMem<T>& m, int q,
                                             int i, int M)
{
    if (i < m.lcap)
        return (q == 0 ? m.lf : (q == 1 ? m.lbase : m.lstart)) + i;
    return m.list + (size_t)q * M + i;
}

// The wide node that a first slot marks: true, with its first out-edge
// and degree, when `slot` is a mark of the table
template <typename T>
__device__ __forceinline__ bool wide_node(const WideMem<T>& m, int slot,
                                          int* base, int* deg)
{
    const int w = -2 - slot;
    if (slot > -2 || w >= m.n_wide) return false;
    *base = m.off[w];
    *deg = m.off[w + 1] - *base;
    return true;
}

// visit_edge in two halves, so that a lane's two pairs read in one round
// trip: read_edge issues the edge's reads, finish_visit is the rest
template <typename T>
struct EdgeRead {
    int to;
    T len;
    T c[kK];
    int32_t id[kK];
};

template <typename T>
__device__ __forceinline__ void read_edge(const State<T>& s, int eid,
                                          EdgeRead<T>& r)
{
    if (eid < 0 || eid >= s.n_edges) return;
    const T* cd = s.cdis + (size_t)eid * kK;
    const int32_t* ci = s.cid + (size_t)eid * kK;
    r.to = load_now(s.e + eid);
    r.len = load_now(s.length + eid);
#pragma unroll
    for (int q = 0; q < kK; ++q) {
        r.c[q] = load_now(cd + q);
        r.id[q] = load_now(ci + q);
    }
}

template <typename T>
__device__ __forceinline__ bool finish_visit(const State<T>& s, int eid,
                                             const EdgeRead<T>& r, int from,
                                             T d, int label, int* dst, T* nd)
{
    if (eid < 0 || eid >= s.n_edges) return false;
    int pos = 0;
#pragma unroll
    for (int q = 0; q < kK; ++q) pos += r.c[q] <= d;
    if (r.to == from || pos >= kK) return false;
    T* cd = s.cdis + (size_t)eid * kK;
    int32_t* ci = s.cid + (size_t)eid * kK;
#pragma unroll
    for (int q = kK - 1; q >= 1; --q) {
        if (q > pos) {
            cd[q] = r.c[q - 1];
            ci[q] = r.id[q - 1];
        }
    }
    cd[pos] = d;
    ci[pos] = label;
    *dst = r.to;
    *nd = add_rn(d, r.len);
    return true;
}

// Warp 0's narrow levels of a wide walk: a lane a slot of the level's
// entries (its row read, or its wide entry's degree), then, where the
// level has a wide entry, a lane a wide pair, found by a binary search
// over the lanes' degree sums (a warp scan); a lane's two pairs' reads go
// out together, and the joins are placed in the flat order, the slots'
// first. Returns as narrow_levels does, or when a level has more than
// kNarrow wide pairs (nothing of it visited).
template <typename T, bool Stamp>
__device__ void wide_narrow_levels(const State<T>& s, const WideMem<T>& m,
                                   int& cur, int& count, int& level,
                                   int label, Blocked bl, long long* acc)
{
    const int lane = threadIdx.x;
    const int M = s.n_nodes;
    while (count > 0 && level < M && kDegree * count <= kNarrow) {
        const int f = lane / kDegree;
        int node = -1, from = -1, slot = -1, base = 0, deg = 0;
        T d = T(0);
        if (lane < kDegree * count) {
            wide_get<Stamp>(s, m, cur, f, node, from, d, acc);
            slot = slot_of(s, node, lane - f * kDegree, bl);
        }
        wide_node(m, slot, &base, &deg);
        int o_node = -1, o_from = -1, weid = -1;
        T o_d = T(0);
        // a level without a wide entry (most of them) has no second round
        if (__ballot_sync(kFull, deg > 0) != 0) {
            int incl = deg;  // the degrees' inclusive sum over the lanes
#pragma unroll
            for (int o = 1; o < kWarp; o *= 2) {
                const int y = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += y;
            }
            const int pairs = __shfl_sync(kFull, incl, kWarp - 1);
            if (pairs > kNarrow) return;  // the block's level
            // lane j's wide pair: the first lane whose sum exceeds j
            int owner = 0;
#pragma unroll
            for (int step = kWarp / 2; step >= 1; step /= 2) {
                const int v = __shfl_sync(kFull, incl, owner + step - 1);
                if (v <= lane) owner += step;
            }
            o_node = __shfl_sync(kFull, node, owner);
            o_from = __shfl_sync(kFull, from, owner);
            o_d = __shfl_sync(kFull, d, owner);
            const int o_first =
                __shfl_sync(kFull, base - (incl - deg), owner);
            weid = lane < pairs ? m.eid[o_first + lane] : -1;
        }
        // a mark is no slot: read_edge and finish_visit take none
        EdgeRead<T> r1, r2;
        read_edge(s, slot, r1);
        read_edge(s, weid, r2);
        int dst1 = -1, dst2 = -1;
        T nd1 = T(0), nd2 = T(0);
        const bool j1 = finish_visit(s, slot, r1, from, d, label, &dst1, &nd1);
        const bool j2 =
            finish_visit(s, weid, r2, o_from, o_d, label, &dst2, &nd2);
        const unsigned b1 = __ballot_sync(kFull, j1);
        const unsigned b2 = __ballot_sync(kFull, j2);
        const unsigned below = (1u << lane) - 1u;
        int at = __popc(b1 & below);
        if (j1 && at < M) wide_put(s, m, 1 - cur, at, dst1, node, nd1);
        at = __popc(b1) + __popc(b2 & below);
        if (j2 && at < M) wide_put(s, m, 1 - cur, at, dst2, o_node, nd2);
        const int next = __popc(b1) + __popc(b2);
        __syncwarp();  // the next level reads what this one wrote
        count = next < M ? next : M;
        cur ^= 1;
        ++level;
    }
}

// A level of a wide walk by the whole block of NT threads: the slots in
// chunks of NT, one scan placing both the joins and the wide entries on
// the list, a scan of the list's degrees, then the wide pairs in chunks of
// NT, each thread finding its entry by a binary search over the list's
// first pairs; returns the next frontier's width. A stamped instance times
// its passes (acc).
template <typename T, int NT, bool Stamp>
__device__ int wide_block_level(const State<T>& s, const WideMem<T>& m,
                                int cur, int count, int label, Blocked bl,
                                long long* acc)
{
    const int M = s.n_nodes;
    const int items = kDegree * count;
    int next = 0, n_wide = 0;
    long long t = clock_if<Stamp>();
    // the slots; a wide entry's mark puts it on the list, its degree in
    // the place of its first pair
    for (int c0 = 0; c0 < items; c0 += NT) {
        const int j = c0 + threadIdx.x;
        bool joins = false, wide = false;
        int node = -1, dst = -1, f = 0, base = 0, deg = 0;
        T nd = T(0);
        if (j < items) {
            f = j / kDegree;
            int from;
            T d;
            wide_get<Stamp>(s, m, cur, f, node, from, d, acc);
            const int slot = slot_of(s, node, j - f * kDegree, bl);
            wide = wide_node(m, slot, &base, &deg);
            joins = visit_edge(s, slot, from, d, label, &dst, &nd);
        }
        int total;
        const int ex = block_exclusive_scan<NT>(
            (int)joins | ((int)wide << 16), m.warp_sum, &total);
        const int at = next + (ex & 0xffff);
        if (joins && at < M) wide_put(s, m, 1 - cur, at, dst, node, nd);
        if (wide) {
            const int i = n_wide + (ex >> 16);
            *wide_list_at(m, 0, i, M) = f;
            *wide_list_at(m, 1, i, M) = base;
            *wide_list_at(m, 2, i, M) = deg;
        }
        next += total & 0xffff;
        n_wide += total >> 16;
    }
    __syncthreads();  // the list is written
    t = lap<Stamp>(acc, kStSlots, t);
    if (n_wide > 0) {
        // each wide entry's first pair: the exclusive sum of the degrees
        int pairs = 0;
        for (int c0 = 0; c0 < n_wide; c0 += NT) {
            const int i = c0 + threadIdx.x;
            int* at = i < n_wide ? wide_list_at(m, 2, i, M) : nullptr;
            const int deg = at != nullptr ? *at : 0;
            int total;
            const int ex = block_exclusive_scan<NT>(deg, m.warp_sum, &total);
            if (at != nullptr) *at = pairs + ex;
            pairs += total;
        }
        __syncthreads();  // the first pairs are written
        t = lap<Stamp>(acc, kStScan, t);
        for (int c0 = 0; c0 < pairs; c0 += NT) {
            const int j = c0 + threadIdx.x;
            bool joins = false;
            int node = -1, dst = -1;
            T nd = T(0);
            if (j < pairs) {
                // the last list entry whose first pair is at most j
                int lo = 0, hi = n_wide;
                while (hi - lo > 1) {
                    const int mid = (lo + hi) / 2;
                    if (read_past<Stamp>(wide_list_at(m, 2, mid, M),
                                         mid >= m.lcap, acc) <= j)
                        lo = mid;
                    else
                        hi = mid;
                }
                const bool past = lo >= m.lcap;
                int from;
                T d;
                wide_get<Stamp>(s, m, cur,
                                read_past<Stamp>(wide_list_at(m, 0, lo, M),
                                                 past, acc),
                                node, from, d, acc);
                const int eid =
                    m.eid[read_past<Stamp>(wide_list_at(m, 1, lo, M), past,
                                           acc)
                          + j
                          - read_past<Stamp>(wide_list_at(m, 2, lo, M), past,
                                             acc)];
                joins = visit_edge(s, eid, from, d, label, &dst, &nd);
            }
            int total;
            const int at =
                next + block_exclusive_scan<NT>(joins, m.warp_sum, &total);
            if (joins && at < M) wide_put(s, m, 1 - cur, at, dst, node, nd);
            next += total;
        }
        __syncthreads();  // the next level reads what this one wrote
        lap<Stamp>(acc, kStPairs, t);
    }
    return next < M ? next : M;
}

// The walk over a wide table by every thread of a block of NT: walk's plan
// (insert_step.cuh) over m, with wide_narrow_levels and wide_block_level.
// Thread 0's entry `e`, and warp 0's count, level, label and blocked
// nodes, start it (the other threads' are not read); every thread returns
// after the same barrier. A stamped instance times its levels into acc.
template <typename T, int NT, bool Stamp>
__device__ void wide_walk(const State<T>& s, const WideMem<T>& m, Entry<T> e,
                          int count, int level, int label, Blocked bl,
                          long long* acc)
{
    const int M = s.n_nodes;
    int cur = 0;
    if (threadIdx.x == 0) wide_put(s, m, 0, 0, e.node, e.from, e.dist);
    if (threadIdx.x < kWarp) __syncwarp();  // before warp 0 reads it
    for (;;) {
        if (threadIdx.x < kWarp) {
            const long long t = clock_if<Stamp>();
            const int l0 = level;
            wide_narrow_levels<T, Stamp>(s, m, cur, count, level, label, bl,
                                         acc);
            if (threadIdx.x == 0) {
                m.ctl[kCtlCount] = count;
                m.ctl[kCtlCur] = cur;
                m.ctl[kCtlLevel] = level;
                m.ctl[kCtlLabel] = label;
                m.ctl[kCtlBlocked] = bl.n;
                m.ctl[kCtlB0] = bl.b0;
                m.ctl[kCtlB1] = bl.b1;
                if constexpr (Stamp) {
                    acc[kStNarrow] += clock64() - t;
                    acc[kStNarrowLevels] += level - l0;
                }
            }
        }
        __syncthreads();  // the other warps join for a wide level, or leave
        count = m.ctl[kCtlCount];
        cur = m.ctl[kCtlCur];
        level = m.ctl[kCtlLevel];
        if (count == 0 || level >= M) return;
        label = m.ctl[kCtlLabel];
        bl = {m.ctl[kCtlBlocked], m.ctl[kCtlB0], m.ctl[kCtlB1]};
        if constexpr (Stamp)
            if (threadIdx.x == 0) acc[kStWideLevels] += 1;
        // every thread has read ctl before the level's first barrier, so
        // warp 0 writes it again only after
        count = wide_block_level<T, NT, Stamp>(s, m, cur, count, label, bl,
                                               acc);
        cur ^= 1;
        ++level;
    }
}

// a per-leaf kernel's WideMem over its static shared memory
template <typename T>
__device__ __forceinline__ WideMem<T> static_mem(
    Shared<T, kThreads, kCap>& sh, WideList& wl, int* ctl,
    const WideTable& wt)
{
    return WideMem<T>{&sh.dist[0][0], &sh.ids[0][0], &sh.frm[0][0],
                      wl.f,           wl.base,       wl.start,
                      wt.off,         wt.eid,        wt.list,
                      sh.warp_sum,    ctl,           kCap,
                      kCap,           wt.n_wide};
}

// the cursor of an insert range: insertion (or leaf) i, slots in use, the
// address of the range's first distance row, the rows' stride in elements,
// and the range's first insertion (int64 each)
enum { kCurI = 0, kCurUsed, kCurRows, kCurStride, kCurLo };

// The offsets of a cursor launch's nodes and label from its insertion i
struct Offsets {
    int outside, middle, label;
};

// insert_step and insert_step_cursor, over the [M, 3] rows or (Wide) a
// wide table (m); the cursor, when given, supplies i (outside = i +
// off.outside, middle = i + off.middle, label = i + off.label) and i0 (the
// slots in use), and is advanced at the end
template <typename T, bool Wide>
__device__ __forceinline__ void insert_step_body(
    State<T> s, Shared<T, kThreads, kCap>& sh, const int32_t* eid,
    const int32_t* ends, const T* frac, const T* add, int i0, int middle,
    int outside, int label, int block_slot, int32_t* out_xy,
    long long* cursor, Offsets off, const WideMem<T>* m)
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
        wide_walk<T, kThreads, false>(s, *m, first, count, 1, label, bl,
                                      nullptr);
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
                               off, nullptr);
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
    __shared__ int ctl[kCtlWords];
    const WideMem<T> m = static_mem(sh, wl, ctl, wt);
    insert_step_body<T, true>(s, sh, eid, ends, frac, add, i0, middle,
                              outside, label, block_slot, out_xy, cursor, off,
                              &m);
}

// closest_bfs and closest_bfs_cursor (Wide: over a wide table, m); the
// cursor, when given, supplies the leaf (= label) and is advanced at the
// end. A stamped instance (Stamp) times the launch's parts into acc.
template <typename T, bool Wide, bool Stamp = false>
__device__ __forceinline__ void closest_bfs_body(
    State<T> s, Shared<T, kThreads, kCap>& sh, int leaf, int label,
    const int32_t* blocked, int n_blocked, long long* cursor,
    const WideMem<T>* m, long long* acc = nullptr)
{
    long long ci = 0;
    Blocked bl = {n_blocked, -1, -1};
    if constexpr (Stamp) {
        if (threadIdx.x == 0) {
            for (int q = 0; q < kStampWords; ++q) acc[q] = 0;
            acc[kStStart] = clock64();
            acc[kStTimerStart] = global_ns();
        }
    }
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
    if constexpr (Stamp)
        if (threadIdx.x == 0) acc[kStFirst] = clock64();
    if constexpr (Wide)
        wide_walk<T, kThreads, Stamp>(s, *m, Entry<T>{leaf, -1, T(0)}, 1, 0,
                                      label, bl, acc);
    else
        walk(s, sh, Entry<T>{leaf, -1, T(0)}, 1, 0, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) cursor[kCurI] = ci + 1;
    if constexpr (Stamp) {
        if (threadIdx.x == 0) {
            acc[kStEnd] = clock64();
            acc[kStTimerEnd] = global_ns();
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_kernel(State<T> s, int leaf, int label, const int32_t* blocked,
                   int n_blocked, long long* cursor)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    closest_bfs_body<T, false>(s, sh, leaf, label, blocked, n_blocked, cursor,
                               nullptr);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_wide_kernel(State<T> s, int leaf, int label,
                        const int32_t* blocked, int n_blocked,
                        long long* cursor, WideTable wt)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    __shared__ WideList wl;
    __shared__ int ctl[kCtlWords];
    const WideMem<T> m = static_mem(sh, wl, ctl, wt);
    closest_bfs_body<T, true>(s, sh, leaf, label, blocked, n_blocked, cursor,
                              &m);
}

// closest_bfs_wide_kernel's cursor launch, stamped: kStampWords to stamps
template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_wide_stamped_kernel(State<T> s, long long* cursor, WideTable wt,
                                long long* stamps)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    __shared__ WideList wl;
    __shared__ int ctl[kCtlWords];
    __shared__ long long acc[kStampWords];
    const WideMem<T> m = static_mem(sh, wl, ctl, wt);
    closest_bfs_body<T, true, true>(s, sh, 0, 0, nullptr, 0, cursor, &m, acc);
    if (threadIdx.x == 0)
        for (int q = 0; q < kStampWords; ++q) stamps[q] = acc[q];
}

// ---------------------------------------------------------------------------
// The seeding range (closest_bfs_range, the wide instantiation): the BFS
// alone from leaves i .. i + n - 1 in order, in one launch of one block
// (the counterpart of the JAX package's fori_loop over the backbone,
// kclosest.py:1233-1236). The per-leaf launch above reads the cursor,
// fills its shared memory from nothing and writes the cursor back for
// every leaf; this one reads the cursor once, stages the wide table once
// and writes the cursor once (i + n). Each leaf's walk is wide_walk, the
// per-leaf kernels' own, over the launch's memory.
//
// Its shared memory is dynamic and sized at launch (up to the card's
// opt-in, 227 KB on an H100): the wide table's offsets and, where they
// fit, its out-edges, staged once by cp.async (the table never changes
// while a backbone is seeded); then the frontier's two buffers and the
// wide list, of capacities that the caller chooses from what is left
// (placement/insert_model.py::range_plan). Entries past them spill to
// the same [2, M] and [3, M] scratch as above, so any tree runs at any
// capacity. The block is kRangeThreads threads.
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t pad16(size_t b)
{
    return (b + 15) & ~(size_t)15;
}

// bytes of a range launch's dynamic shared memory: the frontier's
// distances, nodes and sources ([2, cap] each), the wide list ([3, lcap]),
// then n_off staged offsets and n_eid staged out-edges (0: not staged);
// insert_model.range_bytes mirrors it
__host__ __device__ __forceinline__ size_t range_bytes(int item, int cap,
                                                       int lcap, int n_off,
                                                       int n_eid)
{
    return pad16((size_t)2 * cap * item) + 2 * pad16((size_t)2 * cap * 4)
           + 3 * pad16((size_t)lcap * 4) + pad16((size_t)n_off * 4)
           + pad16((size_t)n_eid * 4);
}

// A range launch's WideMem, carved from its dynamic shared memory in
// range_bytes's order; *off_s and *eid_s get where the table's words are
// staged (m.off and m.eid point there where staged, else at the table)
template <typename T>
__device__ __forceinline__ WideMem<T> carve(unsigned char* dyn,
                                            const WideTable& wt,
                                            int* warp_sum, int* ctl, int cap,
                                            int lcap, int n_off, int n_eid,
                                            int32_t** off_s, int32_t** eid_s)
{
    WideMem<T> m;
    size_t o = 0;
    m.dist = reinterpret_cast<T*>(dyn);
    o += pad16((size_t)2 * cap * sizeof(T));
    m.ids = reinterpret_cast<int32_t*>(dyn + o);
    o += pad16((size_t)2 * cap * 4);
    m.frm = reinterpret_cast<int32_t*>(dyn + o);
    o += pad16((size_t)2 * cap * 4);
    m.lf = reinterpret_cast<int32_t*>(dyn + o);
    o += pad16((size_t)lcap * 4);
    m.lbase = reinterpret_cast<int32_t*>(dyn + o);
    o += pad16((size_t)lcap * 4);
    m.lstart = reinterpret_cast<int32_t*>(dyn + o);
    o += pad16((size_t)lcap * 4);
    *off_s = reinterpret_cast<int32_t*>(dyn + o);
    o += pad16((size_t)n_off * 4);
    *eid_s = reinterpret_cast<int32_t*>(dyn + o);
    m.off = n_off > 0 ? *off_s : wt.off;
    m.eid = n_eid > 0 ? *eid_s : wt.eid;
    m.list = wt.list;
    m.warp_sum = warp_sum;
    m.ctl = ctl;
    m.cap = cap;
    m.lcap = lcap;
    m.n_wide = wt.n_wide;
    return m;
}

// cp.async of n int32 words into shared memory (16 bytes a copy where the
// source is 16-byte aligned; dst is); the caller commits and waits
__device__ __forceinline__ void stage_words(int32_t* dst, const int32_t* src,
                                            int n)
{
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int body = vec ? (n & ~3) : 0;
    for (int i = 4 * threadIdx.x; i < body; i += 4 * kRangeThreads) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src + i)
                     : "memory");
    }
    for (int i = body + threadIdx.x; i < n; i += kRangeThreads) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(src + i)
                     : "memory");
    }
}

// closest_bfs_range: leaves i .. i + n_leaves - 1 from the cursor's i (a
// leaf out of [0, M) walks nothing, as closest_bfs_cursor's), the cursor
// read once and advanced once (i + n_leaves); n_off and n_eid words of the
// table staged (0: read from device memory). A stamped instance writes
// kStampWords a leaf to stamps.
template <typename T, bool Stamp>
__global__ void __launch_bounds__(kRangeThreads)
closest_bfs_range_kernel(State<T> s, WideTable wt, long long* cursor,
                         int n_leaves, int cap, int lcap, int n_off,
                         int n_eid, long long* stamps)
{
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int warp_sum[kRangeThreads / kWarp];
    __shared__ int ctl[kCtlWords];
    __shared__ long long first_leaf;
    __shared__ long long acc[Stamp ? kStampWords : 1];
    long long t_start = 0, ns_start = 0;
    if constexpr (Stamp) {
        if (threadIdx.x == 0) {
            t_start = clock64();
            ns_start = global_ns();
        }
    }
    int32_t *off_s, *eid_s;
    const WideMem<T> m = carve<T>(dyn, wt, warp_sum, ctl, cap, lcap, n_off,
                                  n_eid, &off_s, &eid_s);
    if (n_off > 0) stage_words(off_s, wt.off, n_off);
    if (n_eid > 0) stage_words(eid_s, wt.eid, n_eid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (threadIdx.x == 0) first_leaf = cursor[kCurI];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the table and the first leaf, for every thread
    const long long lo = first_leaf;
    const int M = s.n_nodes;
    for (int k = 0; k < n_leaves; ++k) {
        const long long ci = lo + k;
        const int leaf = (int)(ci >= 0 && ci < M ? ci : -1);
        if constexpr (Stamp) {
            if (threadIdx.x == 0) {
                for (int q = 0; q < kStampWords; ++q) acc[q] = 0;
                acc[kStStart] = k == 0 ? t_start : clock64();
                acc[kStTimerStart] = k == 0 ? ns_start : global_ns();
                acc[kStFirst] = clock64();
            }
        }
        wide_walk<T, kRangeThreads, Stamp>(s, m, Entry<T>{leaf, -1, T(0)}, 1,
                                           0, leaf, Blocked{0, -1, -1}, acc);
        if constexpr (Stamp) {
            if (threadIdx.x == 0) {
                acc[kStEnd] = clock64();
                acc[kStTimerEnd] = global_ns();
                for (int q = 0; q < kStampWords; ++q)
                    stamps[(size_t)k * kStampWords + q] = acc[q];
            }
        }
        __syncthreads();  // the next leaf's first entry and ctl after every
                          // thread's last read of this one's
    }
    if (threadIdx.x == 0) cursor[kCurI] = lo + n_leaves;
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

// a range launch: its instance by type and stamps; the dynamic shared
// memory allowed first (a launch past the card's opt-in fails, and its
// error is taken off the thread's last error, so that the next launch's
// check does not report it)
template <typename T, bool Stamp>
cudaError_t launch_range(void* const* p, int n_edges, int n_nodes,
                         const WideTable& wt, long long* cursor, int n_leaves,
                         int cap, int lcap, int n_off, int n_eid,
                         long long* stamps, cudaStream_t st)
{
    const State<T> s = make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5],
                                     p[6], p[7], p[8], p[9], n_edges,
                                     n_nodes);
    const size_t bytes = range_bytes((int)sizeof(T), cap, lcap, n_off, n_eid);
    const auto kernel = closest_bfs_range_kernel<T, Stamp>;
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    kernel<<<1, kRangeThreads, bytes, st>>>(s, wt, cursor, n_leaves, cap,
                                             lcap, n_off, n_eid, stamps);
    return cudaGetLastError();
}

// the dynamic shared memory a range launch may take: the card's opt-in
// less the kernel's static shared memory (the stamped instance's, which
// is the larger)
template <typename T>
cudaError_t range_budget(int device, int* out)
{
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaFuncAttributes a;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(
            &a, (const void*)closest_bfs_range_kernel<T, true>);
    if (err == cudaSuccess) *out = optin - (int)a.sharedSizeBytes;
    else cudaGetLastError();
    return err;
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

// The BFS alone from leaves i .. i + n_leaves - 1, i = cursor[0], in one
// launch of one block of kRangeThreads over a wide table (a binary state
// is refused); the cursor advances by n_leaves. cap and list_cap: the
// frontier's and the wide list's entries in shared memory; n_off (0 or
// n_wide + 1) and n_eid (0 or wide_off[n_wide]): the table's words staged
// there. Their bytes (range_bytes) must be within
// closest_bfs_range_budget's. stamps: null, or int64 [n_leaves, 16] for
// the stamped instance.
extern "C" int closest_bfs_range(STATE_PARAMS, void* cursor, int n_leaves,
                                 int cap, int list_cap, int n_off, int n_eid,
                                 void* stamps, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr || n_leaves < 1
        || wide_off == nullptr
        || !wide_ok(wide_off, wide_eid, wide_list, n_wide) || cap < 1
        || list_cap < 1 || (n_off != 0 && n_off != n_wide + 1) || n_eid < 0)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    long long* c = (long long*)cursor;
    long long* sp = (long long*)stamps;
    cudaError_t err;
    if (is_f64)
        err = sp != nullptr
                  ? launch_range<double, true>(p, n_edges, n_nodes,
                                               WIDE_TABLE, c, n_leaves, cap,
                                               list_cap, n_off, n_eid, sp, st)
                  : launch_range<double, false>(p, n_edges, n_nodes,
                                                WIDE_TABLE, c, n_leaves, cap,
                                                list_cap, n_off, n_eid, sp,
                                                st);
    else
        err = sp != nullptr
                  ? launch_range<float, true>(p, n_edges, n_nodes,
                                              WIDE_TABLE, c, n_leaves, cap,
                                              list_cap, n_off, n_eid, sp, st)
                  : launch_range<float, false>(p, n_edges, n_nodes,
                                               WIDE_TABLE, c, n_leaves, cap,
                                               list_cap, n_off, n_eid, sp,
                                               st);
    return (int)err;
}

// closest_bfs_range's dynamic shared memory budget in bytes (for is_f64)
// on `device`, to *out.
extern "C" int closest_bfs_range_budget(int is_f64, int device, int* out)
{
    if (out == nullptr) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    return (int)(is_f64 ? range_budget<double>(device, out)
                        : range_budget<float>(device, out));
}

// closest_bfs_cursor over a wide table by its stamped instance: stamps
// (int64 [16]) get the launch's parts.
extern "C" int closest_bfs_wide_stamped(STATE_PARAMS, void* cursor,
                                        void* stamps, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr
        || stamps == nullptr || wide_off == nullptr
        || !wide_ok(wide_off, wide_eid, wide_list, n_wide))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        closest_bfs_wide_stamped_kernel<double><<<1, kThreads, 0, st>>>(
            make_state<double>(p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                               p[7], p[8], p[9], n_edges, n_nodes),
            (long long*)cursor, WIDE_TABLE, (long long*)stamps);
    else
        closest_bfs_wide_stamped_kernel<float><<<1, kThreads, 0, st>>>(
            make_state<float>(p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                              p[7], p[8], p[9], n_edges, n_nodes),
            (long long*)cursor, WIDE_TABLE, (long long*)stamps);
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
                         (const void*)closest_bfs_wide_stamped_kernel<float>,
                         (const void*)closest_bfs_wide_stamped_kernel<double>,
                         (const void*)closest_bfs_range_kernel<float, false>,
                         (const void*)closest_bfs_range_kernel<double, false>,
                         (const void*)closest_bfs_range_kernel<float, true>,
                         (const void*)closest_bfs_range_kernel<double, true>,
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
