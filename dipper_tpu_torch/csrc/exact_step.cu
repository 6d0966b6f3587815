// One insertion of exact placement on Hopper (sm_90a), in one launch: the
// level order of the tree, both sweeps, the score, the splice and the depth
// shift of the splice's subtree. The insertion, the slots in use and
// the distance row come from a cursor on the card, which the launch
// advances, so one captured CUDA graph of launches serves every stretch of
// an insert range and an insertion needs no host round trip.
//
// Replaces the body of the JAX package's exact insert loop,
// dipper_tpu/placement/exact.py::_exact_insert_loop (:231-270), an XLA
// program and not Pallas: `_compute_lims` (:84-157, the up and down
// while_loops over levels), `_score_exact` (:159-181) and `_splice_exact`
// (:183-229, with the parent-pointer propagation of the depth shift). The
// plain version is the port's tensor code, placement/exact.py::
// exact_insertion_step (the CPU path, and this kernel's yardstick on the
// card); placement/exact_model.py is a numpy model of this file's plan.
//
// Entry points, none synchronizing:
//
// - exact_step: a cluster of `ctas` blocks (kMaxCtas = 8, portable, in the
//   main path; fewer only to test the split) of kExactThreads = 512
//   threads on the caller's stream; insertion i = cursor[0] at slots
//   cursor[1] .. cursor[1] + 3, distance row cursor[2] + (i - cursor[4]) *
//   cursor[3] elements; the cursor advances by one insertion (i + 1; slots
//   + 4). `out` gets the chosen slot, the tree's greatest depth, the
//   positions walked, the levels and nodes of the depth shift, the walk's
//   count of levels wider than `wide` and a status (0: done). A launch
//   runs on the whole cluster only where the last launch's walk (in `out`;
//   -1 before the state's first) found at least kClusterLevels levels wider
//   than `wide`; else the other blocks leave at once and block 0 runs as a
//   cluster of one, which takes any tree. Every block reads the cursor and
//   `out` before it arrives at the launch's first cluster barrier, and
//   block 0 writes them only after it has waited there (in a launch on
//   block 0 alone too, whose other blocks arrive and leave), so no block
//   reads a word that this launch wrote.
//   The last word of `out` is sticky: a failed insertion leaves the tree
//   and the cursor as they are and writes its status there, and a launch
//   that finds it nonzero does nothing, so a failure inside a replayed
//   graph survives to the host's check after the range. Given `stamps`, the
//   launch is the stamped instance (a template flag): block 0's thread 0
//   writes clock64() at its start and at the end of the walk, the up-sweep,
//   the down-sweep, the score and the splice with the depth shift (words 0
//   to 5 of int64 [8 + 3 x 512]), and at the end of each of the first 512
//   levels of the walk, the up-sweep and the down-sweep (from word 8, 512
//   words a pass).
// - exact_cursor_set writes a cursor and rebuilds every node's record from
//   the state (the records are derived data, as `adj` is); exact_step_
//   preload loads every kernel of this library and reports how many
//   clusters of `ctas` blocks the card can hold at once;
//   exact_cluster_sync_probe times cluster barriers.
//
// The plan (the state and the scratch stay in L2). Its levels are a chain
// of dependent steps, so the plan keeps each level's chain short: one trip
// to L2 a walk level, the sweeps' values through block 0's shared memory
// and their inputs copied there levels ahead.
//
// - Node records: each node's at most three out-edges, each with its slot,
//   the neighbour e[r], the reverse slot rev[r] and the length (48 bytes a
//   node in f32, 64 in f64: three or four 16-byte loads). A walk entry
//   reads its node's record, which holds its upward edge's length and
//   every child's node, slots and length, and its row value, in one trip.
// - Position records: a position's node with its child count, its
//   children's first position and its upward length, one 16-byte word.
// - The walk: position 0 is the root N. Each entry of a level places its
//   children (record entries but the upward edge) by a prefix sum in flat
//   (entry, slot) order, writes their node, slots and length (also into
//   block 0's frontier in shared memory, the next level's first kCap
//   entries, which the next level reads there), and writes its own position
//   record; a leaf writes its limup (its row value). Block 0 takes a level
//   two chunks of `threads` at a time (their reads in flight together), and
//   a run of levels of at most 32 entries in warp 0 alone (a prefix sum by
//   shuffles, no block barrier). It ends at an empty level: the greatest
//   depth is the number of levels less one.
// - The up-sweep, levels maxdep .. 0: a position with children takes the
//   maximum of 0 and its children's v = limup - lenup and keeps their
//   w = limup - lendn; every position passes on its own v and w. NaN wins,
//   as in the plain version's scatter maximum.
// - The down-sweep, levels 0 .. maxdep - 1, a position with children: its
//   own limdn less its upward length, then its children's w (the values of
//   its incident edges), and the plain version's top-2 rule for each child.
// - In both sweeps a level that block 0 computes alone passes its values to
//   the next level through block 0's shared memory (the first kCap of
//   them), and each thread copies its first position's inputs (its
//   position record, lengths, a leaf's limup, the children's w: nothing
//   that a level of the sweep writes) into a ring in shared memory up to
//   four levels ahead with cp.async, which the level barriers do not wait
//   for, so such a level waits on shared memory only.
// - The score, after the sweeps, over every thread of the cluster: each
//   position's downward edge by edge_score and its upward edge at SENT_DIS
//   (frac 0); each thread keeps the first of its candidates in
//   torch.argmin's order (a total order, so the order of meeting does not
//   matter), block_min the block's, block 0 the cluster's.
// - Levels wider than `wide` are split over the cluster: the walk's level
//   in rounds of at most ctas x threads entries, each block a contiguous
//   range, its children's count published to every block's shared memory,
//   a cluster barrier, then each block adds the counts of the blocks before
//   it; a sweep level a contiguous range a block. Such a level passes its
//   values through the scratch and ends at a cluster barrier. Runs of
//   narrower levels are block 0's alone, with a block barrier a level,
//   while the other blocks wait at one cluster barrier at the end of the
//   run.
// - The splice: block 0's thread 0 reads the chosen edge's ends, reverse,
//   length and the ends' depths, and hands the choice to every block before
//   a cluster barrier; the cluster shifts the depths of ch's subtree (the
//   chosen position's), whose positions at each level are the range from
//   the first one's children to the last one's last child, with no barrier;
//   thread 0 writes the six slots, the three nodes' parents, the two new
//   nodes' depths, adjacency rows and records, the entries of x and y that
//   lead to middle, `out` and the cursor.
//
// Data the launch writes (the scratch, the records, the state) is read with
// plain loads, never through the read-only path, and what another block
// wrote is read only after a cluster barrier (release, acquire). Level
// starts (the first kLevels), the first kCap entries of block 0's levels
// and the blocks' counts and choices go through shared memory; everything
// scaled by the tree stays in device memory, so any M the state allows
// runs. A walk that finds more nodes than M, a cursor out of range or a
// choice the splice cannot take leaves the tree and the cursor as they
// are and sets the status and the sticky error.
//
// What bounds it: neither bytes nor operations. An insertion at 30,000
// taxa moves ~1.5 MB (0.0004 ms at the card's memory rate); its levels are
// a chain of dependent steps (3 x 84 at 30,000 taxa). The stamped instance
// measured on an H100 (700 W) about 0.6-0.8 us a level of fixed cost in
// each pass (the walk's L2 trip, the barriers and the bookkeeping of a
// level) and, on one block, some 6 cycles a position in the walk (its
// records' scattered loads) and 2-3 in each sweep; a wide level split
// over the cluster costs those cycles over every block but adds a cluster
// barrier (0.7 us) or two.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics; T = float or double.

#include "insert_step.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using namespace dipper;

// level starts kept in shared memory; deeper ones are read from scratch
constexpr int kLevels = 2048;
// threads a block: an H100 timed 512 faster than 1,024 at every W
constexpr int kExactThreads = 512;
// blocks of a cluster at most, the main path's (8 is the portable
// cluster size; 16 timed no faster on an H100)
constexpr int kMaxCtas = 8;
// levels wider than `wide` that a tree needs for a launch to take the
// whole cluster: a split level costs two or three cluster barriers (0.7 us
// each) and saves ~5 ns a position, so a few levels just past `wide` do
// not pay for the cluster's own barriers
constexpr int kClusterLevels = 8;
constexpr double kSentDis = 2.0;  // placement/kclosest.py::SENT_DIS
// the stamped instance's buffer: kParts part ends, then the end of each of
// a pass's first kStampLevels levels (walk, up-sweep, down-sweep)
constexpr int kParts = 8;
constexpr int kStampLevels = 512;

// the cursor: insertion i, slots in use, the address of the range's first
// distance row, the rows' stride in elements, the range's first insertion
enum { kCurI = 0, kCurUsed, kCurRows, kCurStride, kCurLo };
// out: chosen slot, greatest depth, positions, depth-shift levels and
// nodes, the levels wider than `wide`, status, and the sticky error (the
// first failed status; 0: none)
enum {
    kOutEid = 0, kOutMaxdep, kOutPositions, kOutShift, kOutShiftNodes,
    kOutWideLevels, kOutStatus, kOutError, kOutLen
};
enum { kDone = 0, kBadCursor = 1, kOverflow = 2, kBadChoice = 3 };

// A node's record: its out-edges in adjacency order (slot -1: none), each
// with its neighbour, its reverse slot and its length
template <typename T>
struct alignas(16) NodeRec {
    int32_t slot[kDegree];
    int32_t nb[kDegree];
    int32_t rv[kDegree];
    T len[kDegree];
};
static_assert(sizeof(NodeRec<float>) == 48, "three 16-byte loads");
static_assert(sizeof(NodeRec<double>) == 64, "four 16-byte loads");

// A position's record: its node (low 30 bits) and child count (high 2),
// its children's first position, its upward edge's length
template <typename T>
struct alignas(16) PosRec {
    uint32_t node_nc;
    int32_t cs;
    T lenup;
};
static_assert(sizeof(PosRec<float>) == 16 && sizeof(PosRec<double>) == 16,
              "one 16-byte load");

template <typename T>
struct ExactState {
    int32_t* e;       // [E] destination node
    int32_t* belong;  // [E] source node
    T* length;        // [E]
    int32_t* rev;     // [E]
    int32_t* parent;  // [M] (M: none)
    int32_t* dep;     // [M]
    int32_t* adj;     // [M, 3] out-edges of each node, -1 empty
    NodeRec<T>* rec;  // [M] derived from the above
    int n_edges, n_nodes, n_leaves;
};

// The level order, by position: node, upward edge (node -> parent),
// downward edge (parent -> node) and downward length (written by the
// parent's entry), the position record (written by the position's own
// entry), level starts ([M + 2]); limup (a leaf's by the walk), limdn, the
// up-sweep's v = limup - lenup and w = limup - lendn, and each position's
// children's w ([M, 4], the fourth unused).
template <typename T>
struct Scratch {
    int32_t *node, *up, *dn, *lstart;
    T *lendn, *limup, *limdn, *vup, *wdn;
    T* kw;
    PosRec<T>* pos;
};

// Block 0's dynamic shared memory: the walk's frontier (node, upward slot)
// of a level's first kCap entries; over it once the walk is done, the
// sweeps' channels (the up-sweep's v and w, the down-sweep's limdn) of a
// level's first kCap positions, two levels each (by the level's parity),
// and a ring of slots a thread for its inputs of the levels ahead
constexpr int kCap = 2048;

// a ring slot: a position record, then the up-sweep's downward length and
// leaf limup, or the down-sweep's children's w
template <typename T>
__host__ __device__ constexpr int slot_bytes()
{
    return 16 + 4 * (int)sizeof(T);
}

// the ring's levels: as many as 168 KB hold, at most 5 (the level being
// swept and up to 4 ahead: a trip to L2 takes about as long as 4 short
// levels)
template <typename T, int NT>
__host__ __device__ constexpr int ring_levels()
{
    return 168 * 1024 / (NT * slot_bytes<T>()) < 5
               ? 168 * 1024 / (NT * slot_bytes<T>())
               : 5;
}

template <typename T, int NT>
__host__ __device__ constexpr int dyn_smem_bytes()
{
    return 4 * kCap * (int)sizeof(T)
           + ring_levels<T, NT>() * NT * slot_bytes<T>();
}

template <typename T>
struct Chan {
    int32_t* fnode;       // [2][kCap]
    int32_t* fup;         // [2][kCap]
    T* cv;                // [2][kCap], over the frontier
    T* cw;                // [2][kCap]
    unsigned char* ring;  // [kRing][NT] slots
};

template <typename T>
__device__ __forceinline__ Chan<T> channels(unsigned char* dyn)
{
    Chan<T> c;
    c.fnode = reinterpret_cast<int32_t*>(dyn);
    c.fup = c.fnode + 2 * kCap;
    c.cv = reinterpret_cast<T*>(dyn);
    c.cw = c.cv + 2 * kCap;
    c.ring = dyn + 4 * kCap * sizeof(T);
    return c;
}

// cp.async: a copy from global to shared memory that no barrier waits for
// (async_wait does)
template <int Bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (Bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                     "l"(src), "n"(Bytes)
                     : "memory");
}

__device__ __forceinline__ void async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's newest N groups of copies have landed
template <int N>
__device__ __forceinline__ void async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two halves of a cluster barrier (release, acquire), for one that
// need not hold a block up
__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int NT>
struct ExactShared {
    int warp_sum[NT / kWarp];
    Cand<T> part[NT / kWarp];
    int lstart[kLevels];
    long long cur[5];
    // written by other blocks: children's counts by round parity, the
    // blocks' choices (block 0's copy), the walk's state after block 0's
    // run, the splice's choice
    int count[2][kMaxCtas];
    Cand<T> cand[kMaxCtas];
    int cand_pos[kMaxCtas];
    int walk[5];  // a, b, levels, overflow, levels wider than `wide`
    int run[5];   // the same, handed from warp 0 to block 0
    int sp[6];    // eid, x, y, ye, pa, ch
    int sp_dpa, status, win_pos;
    T sp_orig;
    Cand<T> win;
    int halted, prev_wide;
};

// torch.maximum and the scatter maximum: NaN wins, a's first
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b)
{
    return a != a ? a : (b != b ? b : (b > a ? b : a));
}

template <typename T>
__device__ __forceinline__ NodeRec<T> load_rec(const NodeRec<T>* r)
{
    union {
        uint4 v[sizeof(NodeRec<T>) / 16];
        NodeRec<T> rec;
    } u;
    const uint4* src = reinterpret_cast<const uint4*>(r);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(NodeRec<T>) / 16); ++i) u.v[i] = src[i];
    return u.rec;
}

// Stores a node record with its padding zero (the plain version's layout,
// exact_cuda.node_records, has a zero word there in f64)
template <typename T>
__device__ __forceinline__ void store_rec(NodeRec<T>* dst, const NodeRec<T>& r)
{
    constexpr int kVec = (int)(sizeof(NodeRec<T>) / 16);
    union {
        uint4 v[kVec];
        NodeRec<T> rec;
    } u;
#pragma unroll
    for (int i = 0; i < kVec; ++i) u.v[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < kDegree; ++j) {
        u.rec.slot[j] = r.slot[j];
        u.rec.nb[j] = r.nb[j];
        u.rec.rv[j] = r.rv[j];
        u.rec.len[j] = r.len[j];
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < kVec; ++i) d[i] = u.v[i];
}

template <typename T>
__device__ __forceinline__ PosRec<T> load_pos(const PosRec<T>* p)
{
    union {
        uint4 v;
        PosRec<T> rec;
    } u;
    u.v = *reinterpret_cast<const uint4*>(p);
    return u.rec;
}

template <typename T>
__device__ __forceinline__ void store_pos(PosRec<T>* p, int node, int nc,
                                          int cs, T lenup)
{
    union {
        uint4 v;
        PosRec<T> rec;
    } u;
    u.v = make_uint4(0u, 0u, 0u, 0u);
    u.rec.node_nc = ((uint32_t)node & 0x3fffffffu) | ((uint32_t)nc << 30);
    u.rec.cs = cs;
    u.rec.lenup = lenup;
    *reinterpret_cast<uint4*>(p) = u.v;
}

__device__ __forceinline__ int pos_node(uint32_t node_nc)
{
    return (int)(node_nc & 0x3fffffffu);
}
__device__ __forceinline__ int pos_nc(uint32_t node_nc)
{
    return (int)(node_nc >> 30);
}

template <typename T, int NT>
__device__ __forceinline__ int level_start(const ExactShared<T, NT>& sh,
                                           const Scratch<T>& w, int l)
{
    return l < kLevels ? sh.lstart[l] : w.lstart[l];
}

template <bool Stamp>
__device__ __forceinline__ void stamp(long long* stamps, int k)
{
    if (Stamp && blockIdx.x == 0 && threadIdx.x == 0) stamps[k] = clock64();
}

// The end of level l of pass `pass` (0 walk, 1 up-sweep, 2 down-sweep) in
// the stamped instance (lv: its level stamps, null otherwise)
__device__ __forceinline__ void stamp_level(long long* lv, int pass, int l)
{
    if (lv != nullptr && blockIdx.x == 0 && threadIdx.x == 0
        && l < kStampLevels)
        lv[pass * kStampLevels + l] = clock64();
}

// One walk entry: position p's node and upward slot, its node's record, the
// row value of a node that may be a leaf, its children counted
template <typename T>
struct Entry {
    NodeRec<T> r;
    int node, up, kids;
    bool kid[kDegree];
    T lenup, base;
};

// Reads walk entry p of the level starting at `lo`: its (node, upward
// slot) from block 0's frontier buffer `buf` when `smem` and p - lo <
// kCap, else from the scratch; then its node's record and its row value
// together (one dependent trip)
template <typename T>
__device__ __forceinline__ void read_entry(const ExactState<T>& s,
                                           const Scratch<T>& w,
                                           const Chan<T>& ch,
                                           const T* __restrict__ row, int p,
                                           int lo, int buf, bool smem,
                                           Entry<T>& x)
{
    const int k = p - lo;
    if (smem && k < kCap) {
        x.node = ch.fnode[buf * kCap + k];
        x.up = ch.fup[buf * kCap + k];
    } else {
        x.node = w.node[p];
        x.up = w.up[p];
    }
    x.kids = 0;
    x.lenup = T(0);
    const bool ok = x.node >= 0 && x.node < s.n_nodes;
    if (ok) x.r = load_rec(s.rec + x.node);
    x.base = (x.node >= 0 && x.node < s.n_leaves) ? __ldg(row + x.node) : T(0);
#pragma unroll
    for (int j = 0; j < kDegree; ++j) {
        const int r = ok ? x.r.slot[j] : -1;
        const bool valid = r >= 0 && r < s.n_edges;
        if (valid && r == x.up) x.lenup = x.r.len[j];
        x.kid[j] = valid && r != x.up;
        x.kids += x.kid[j] ? 1 : 0;
    }
}

// The entry's writes once its children's first position `at` is known: its
// position record, a leaf's limup (the up-sweep's nan_max(base, -inf) is
// the base itself), and each child's node, slots and length, the child's
// (node, upward slot) also into frontier buffer `nbuf` (the level starting
// at `nlo`) when `smem`
template <typename T>
__device__ __forceinline__ void write_entry(const ExactState<T>& s,
                                            const Scratch<T>& w,
                                            const Chan<T>& ch, int p,
                                            const Entry<T>& x, int at, int nlo,
                                            int nbuf, bool smem)
{
    store_pos(w.pos + p, x.node, x.kids, at, x.lenup);
    if (x.kids == 0) w.limup[p] = x.base;
    int q = at;
#pragma unroll
    for (int j = 0; j < kDegree; ++j) {
        if (!x.kid[j] || q >= s.n_nodes) continue;
        w.node[q] = x.r.nb[j];
        w.up[q] = x.r.rv[j];
        w.dn[q] = x.r.slot[j];
        w.lendn[q] = x.r.len[j];
        if (smem && q - nlo < kCap) {
            ch.fnode[nbuf * kCap + q - nlo] = x.r.nb[j];
            ch.fup[nbuf * kCap + q - nlo] = x.r.rv[j];
        }
        ++q;
    }
}

// Level `level` [a, b) of the walk by block 0 alone, two chunks of NT
// entries at a time (their reads in flight together, then a prefix sum
// each), its entries in the frontier when `smem`; its children go to the
// frontier too. Returns the end of the next level; ends at a block
// barrier.
template <typename T, int NT>
__device__ int walk_level_block(const ExactState<T>& s, const Scratch<T>& w,
                                ExactShared<T, NT>& sh, const Chan<T>& ch,
                                const T* __restrict__ row, int a, int b,
                                int level, bool smem)
{
    int next = b;
    for (int base = a; base < b; base += 2 * NT) {
        const int p0 = base + threadIdx.x, p1 = p0 + NT;
        Entry<T> x0, x1;
        x0.kids = 0;
        x1.kids = 0;
        if (p0 < b) read_entry(s, w, ch, row, p0, a, level & 1, smem, x0);
        if (p1 < b) read_entry(s, w, ch, row, p1, a, level & 1, smem, x1);
        int total;
        int at = next + block_exclusive_scan<NT>(x0.kids, sh.warp_sum,
                                                 &total);
        if (p0 < b) write_entry(s, w, ch, p0, x0, at, b, (level + 1) & 1, true);
        next += total;
        if (base + NT < b) {
            __syncthreads();  // the scan's words
            at = next + block_exclusive_scan<NT>(x1.kids, sh.warp_sum,
                                                 &total);
            if (p1 < b)
                write_entry(s, w, ch, p1, x1, at, b, (level + 1) & 1, true);
            next += total;
        }
        __syncthreads();  // the scan's words, and these chunks' writes
    }
    return next;
}

// Levels of at most kWarp entries from [a, b) (level `level`, its entries
// in the frontier when `smem`) by warp 0 alone: a prefix sum by shuffles,
// __syncwarp between levels, while they stay that narrow and the walk
// finds no more nodes than M. Updates a, b, level, over, nwide (the
// levels wider than `wide`) and smem in every lane.
template <typename T, int NT>
__device__ void walk_levels_warp(const ExactState<T>& s, const Scratch<T>& w,
                                 ExactShared<T, NT>& sh, const Chan<T>& ch,
                                 const T* __restrict__ row, int& a, int& b,
                                 int& level, int& over, int& nwide,
                                 int wide, bool& smem, long long* lv)
{
    const int lane = threadIdx.x;
    while (a < b && b - a <= kWarp) {
        const int p = a + lane;
        Entry<T> x;
        x.kids = 0;
        if (p < b) read_entry(s, w, ch, row, p, a, level & 1, smem, x);
        int inc = x.kids;
#pragma unroll
        for (int off = 1; off < kWarp; off *= 2) {
            const int y = __shfl_up_sync(kFull, inc, off);
            if (lane >= off) inc += y;
        }
        const int total = __shfl_sync(kFull, inc, kWarp - 1);
        if (p < b)
            write_entry(s, w, ch, p, x, b + inc - x.kids, b, (level + 1) & 1,
                        true);
        __syncwarp();  // this level's writes before the next's reads
        stamp_level(lv, 0, level);
        int next = b + total;
        if (next > s.n_nodes) {
            over = 1;
            next = b;  // end the walk
        }
        a = b;
        b = next;
        ++level;
        smem = true;
        nwide += b - a > wide ? 1 : 0;
        if (lane == 0) {
            if (level + 1 < kLevels) sh.lstart[level + 1] = b;
            w.lstart[level + 1] = b;
        }
    }
}

// The walk from the root; returns the positions and the levels (0 on
// overflow, with sh.status set), the same in every block, and whether no
// level is wider than `wide` (*solo: the sweeps are block 0's alone, and
// only block 0 holds the level starts, in sh.lstart; else every block
// does). The kernel's first cluster
// barrier was arrived at, not waited for: block 0 waits before it first
// writes another block's shared memory, the others before they first
// read theirs.
template <typename T, int NT>
__device__ int walk(const ExactState<T>& s, const Scratch<T>& w,
                    ExactShared<T, NT>& sh, const Chan<T>& ch,
                    const T* __restrict__ row, int C, int wide,
                    int* n_levels, bool* solo, int* wide_out,
                    long long* lv)
{
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int M = s.n_nodes;
    if (rank == 0 && threadIdx.x == 0) {
        w.node[0] = s.n_leaves;
        w.up[0] = -1;
        w.dn[0] = -1;
        w.lendn[0] = T(0);
        ch.fnode[0] = s.n_leaves;
        ch.fup[0] = -1;
        sh.lstart[0] = 0;
        sh.lstart[1] = 1;
        w.lstart[0] = 0;
        w.lstart[1] = 1;
    }
    __syncthreads();
    // smem: the current level's entries are in block 0's frontier (block 0
    // alone wrote them)
    int a = 0, b = 1, levels = 0, over = 0, nwide = 0;
    bool smem = true, waited = C == 1;
    while (a < b) {
        if (C == 1 || b - a <= wide) {
            // a run of narrow levels, block 0's alone
            if (rank == 0) {
                while (a < b && (C == 1 || b - a <= wide)) {
                    if (b - a <= kWarp) {
                        // a run of levels of at most a warp's entries:
                        // warp 0's alone, then handed to the block
                        if (threadIdx.x < kWarp) {
                            walk_levels_warp(s, w, sh, ch, row, a, b, levels,
                                             over, nwide, wide, smem, lv);
                            if (threadIdx.x == 0) {
                                sh.run[0] = a;
                                sh.run[1] = b;
                                sh.run[2] = levels;
                                sh.run[3] = over;
                                sh.run[4] = nwide;
                            }
                        }
                        __syncthreads();
                        a = sh.run[0];
                        b = sh.run[1];
                        levels = sh.run[2];
                        over = sh.run[3];
                        nwide = sh.run[4];
                        smem = true;
                        continue;
                    }
                    int next =
                        walk_level_block(s, w, sh, ch, row, a, b, levels, smem);
                    stamp_level(lv, 0, levels);
                    if (next > M) {
                        over = 1;
                        next = b;  // end the walk
                    }
                    a = b;
                    b = next;
                    ++levels;
                    smem = true;
                    nwide += b - a > wide ? 1 : 0;
                    if (threadIdx.x == 0) {
                        if (levels + 1 < kLevels) sh.lstart[levels + 1] = b;
                        w.lstart[levels + 1] = b;
                    }
                }
                if (!waited) {
                    cluster_wait();
                    waited = true;
                }
                if (C > 1 && threadIdx.x < C) {
                    int* o = cl.map_shared_rank(sh.walk, threadIdx.x);
                    o[0] = a;
                    o[1] = b;
                    o[2] = levels;
                    o[3] = over;
                    o[4] = nwide;
                }
            }
            if (!waited) {
                cluster_wait();
                waited = true;
            }
            if (C > 1) {
                cl.sync();
                a = sh.walk[0];
                b = sh.walk[1];
                levels = sh.walk[2];
                over = sh.walk[3];
                nwide = sh.walk[4];
                smem = true;
            }
        } else {
            // a wide level over the cluster, in rounds of at most C x NT
            // entries, each block a contiguous range, through the scratch
            int next = b;
            for (int r0 = a, round = 0; r0 < b; r0 += C * NT, ++round) {
                const int r = min(b - r0, C * NT), per = (r + C - 1) / C;
                const int lo = r0 + rank * per, hi = min(r0 + r, lo + per);
                const int p = lo + threadIdx.x;
                Entry<T> x;
                x.kids = 0;
                if (p < hi) read_entry(s, w, ch, row, p, a, 0, false, x);
                int total;
                const int at =
                    block_exclusive_scan<NT>(x.kids, sh.warp_sum, &total);
                const int par = round & 1;
                if (threadIdx.x < C)
                    cl.map_shared_rank(sh.count[par], threadIdx.x)[rank] =
                        total;
                cl.sync();
                int before = 0, all = 0;
                for (int q = 0; q < C; ++q) {
                    const int v = sh.count[par][q];
                    before += q < rank ? v : 0;
                    all += v;
                }
                if (p < hi)
                    write_entry(s, w, ch, p, x, next + before + at, b, 0,
                                false);
                next += all;
            }
            if (next > M) {
                over = 1;
                next = b;
            }
            cl.sync();  // the children's writes before the next level's reads
            stamp_level(lv, 0, levels);
            a = b;
            b = next;
            ++levels;
            smem = false;
            nwide += b - a > wide ? 1 : 0;
            if (threadIdx.x == 0) {
                if (levels + 1 < kLevels) sh.lstart[levels + 1] = b;
                if (rank == 0) w.lstart[levels + 1] = b;
            }
        }
    }
    // the sweeps split no level: block 0 sweeps alone
    *solo = C == 1 || nwide == 0;
    *wide_out = nwide;
    if (C > 1 && !*solo) {
        // the level starts that block 0 wrote in its runs
        cl.sync();
        for (int l = threadIdx.x; l <= levels + 1 && l < kLevels; l += NT)
            sh.lstart[l] = w.lstart[l];
    }
    __syncthreads();
    *n_levels = over ? 0 : levels;
    if (rank == 0 && threadIdx.x == 0 && over) sh.status = kOverflow;
    return b;
}

// Four values at a 16-byte aligned address in 16-byte words
template <typename T>
__device__ __forceinline__ void store4(T* dst, const T (&v)[4])
{
    union {
        uint4 u[sizeof(T) / 4];
        T v[4];
    } x;
#pragma unroll
    for (int j = 0; j < 4; ++j) x.v[j] = v[j];
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 4; ++i)
        reinterpret_cast<uint4*>(dst)[i] = x.u[i];
}

template <typename T>
__device__ __forceinline__ void load4(const T* src, T (&v)[4])
{
    union {
        uint4 u[sizeof(T) / 4];
        T v[4];
    } x;
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 4; ++i)
        x.u[i] = reinterpret_cast<const uint4*>(src)[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = x.v[j];
}

// What a position's up-sweep reads that no sweep writes: its record, its
// downward length, a leaf's limup from the walk
template <typename T>
struct UpIn {
    PosRec<T> pr;
    T lendn, leaf;
};

template <typename T>
__device__ __forceinline__ UpIn<T> up_in(const Scratch<T>& w, int p)
{
    UpIn<T> x;
    x.pr = load_pos(w.pos + p);
    x.lendn = w.lendn[p];
    x.leaf = w.limup[p];
    return x;
}

// Where a level's channel values are: its first position, its buffer, and
// whether block 0 holds its first kCap in shared memory
struct Lane {
    int lo, buf;
    bool smem;
};

// The up-sweep at position p (level `me`, children at level `kids`): a
// position with children takes the maximum of its base and its children's
// v = limup - lenup, and keeps their w = limup - lendn for the down-sweep;
// every position then passes on its own v and w, through the scratch too
// where its parents' level will not read block 0's channel (`spill`, or
// past its first kCap)
template <typename T>
__device__ __forceinline__ void up_step(const ExactState<T>& s,
                                        const Scratch<T>& w,
                                        const Chan<T>& ch,
                                        const T* __restrict__ row, int p,
                                        const UpIn<T>& x, Lane me, Lane kids,
                                        bool spill)
{
    const int nc = pos_nc(x.pr.node_nc);
    T lim = x.leaf;  // the walk wrote a leaf's
    if (nc > 0) {
        const int u = pos_node(x.pr.node_nc);
        const T base = u < s.n_leaves ? __ldg(row + u) : T(0);
        T cm = T(-INFINITY), kw[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int j = 0; j < kDegree; ++j) {
            if (j >= nc) break;
            const int c = x.pr.cs + j, k = c - kids.lo;
            T v, ww;
            if (kids.smem && k < kCap) {
                v = ch.cv[kids.buf * kCap + k];
                ww = ch.cw[kids.buf * kCap + k];
            } else {
                v = w.vup[c];
                ww = w.wdn[c];
            }
            cm = nan_max(cm, v);
            kw[j] = ww;
        }
        lim = nan_max(base, cm);
        w.limup[p] = lim;
        store4(w.kw + (size_t)p * 4, kw);
    }
    const T v = sub_rn(lim, x.pr.lenup), ww = sub_rn(lim, x.lendn);
    const int k = p - me.lo;
    if (me.smem && k < kCap) {
        ch.cv[me.buf * kCap + k] = v;
        ch.cw[me.buf * kCap + k] = ww;
    }
    if (spill || !me.smem || k >= kCap) {
        w.vup[p] = v;
        w.wdn[p] = ww;
    }
}

// What a position's down-sweep reads that no down-sweep level writes: its
// record and its children's w
template <typename T>
struct DownIn {
    PosRec<T> pr;
    T kw[4];
};

template <typename T>
__device__ __forceinline__ DownIn<T> down_in(const Scratch<T>& w, int p)
{
    DownIn<T> x;
    x.pr = load_pos(w.pos + p);
    load4(w.kw + (size_t)p * 4, x.kw);
    return x;
}

// A position's sweep inputs into its ring slot (cp.async), and back
template <bool Up, typename T>
__device__ __forceinline__ void copy_in(unsigned char* slot,
                                        const Scratch<T>& w, int p)
{
    copy_async<16>(slot, w.pos + p);
    if constexpr (Up) {
        copy_async<sizeof(T)>(slot + 16, w.lendn + p);
        copy_async<sizeof(T)>(slot + 16 + sizeof(T), w.limup + p);
    } else {
        const unsigned char* k =
            reinterpret_cast<const unsigned char*>(w.kw + (size_t)p * 4);
#pragma unroll
        for (int i = 0; i < (int)sizeof(T) / 4; ++i)
            copy_async<16>(slot + 16 + 16 * i, k + 16 * i);
    }
}

template <typename T>
__device__ __forceinline__ void read_in(const unsigned char* slot, UpIn<T>& x)
{
    x.pr = *reinterpret_cast<const PosRec<T>*>(slot);
    x.lendn = *reinterpret_cast<const T*>(slot + 16);
    x.leaf = *reinterpret_cast<const T*>(slot + 16 + sizeof(T));
}

template <typename T>
__device__ __forceinline__ void read_in(const unsigned char* slot,
                                        DownIn<T>& x)
{
    x.pr = *reinterpret_cast<const PosRec<T>*>(slot);
    const T* k = reinterpret_cast<const T*>(slot + 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) x.kw[j] = k[j];
}

// The down-sweep at position p with children (level `me`, children at
// level `kids`): the values of its at most three incident edges (its own
// limdn less its upward length first, then its children's w), and each
// child's limdn by the top-2 rule
template <typename T>
__device__ __forceinline__ void down_step(const Scratch<T>& w,
                                          const Chan<T>& ch, int p,
                                          const DownIn<T>& x, Lane me,
                                          Lane kids)
{
    const int nc = pos_nc(x.pr.node_nc);
    if (nc == 0) return;
    T v[kDegree + 1];
    bool has[kDegree + 1];
    has[0] = p > 0;
    v[0] = T(0);
    if (has[0]) {
        const int k = p - me.lo;
        const T ld = (me.smem && k < kCap) ? ch.cv[me.buf * kCap + k]
                                           : w.limdn[p];
        v[0] = sub_rn(ld, x.pr.lenup);
    }
#pragma unroll
    for (int j = 0; j < kDegree; ++j) {
        has[j + 1] = j < nc;
        v[j + 1] = has[j + 1] ? x.kw[j] : T(0);
    }
    T max1 = T(-INFINITY);
#pragma unroll
    for (int j = 0; j <= kDegree; ++j)
        if (has[j]) max1 = nan_max(max1, v[j]);
    int cnt = 0;
    T max2 = T(-INFINITY);
#pragma unroll
    for (int j = 0; j <= kDegree; ++j) {
        if (!has[j]) continue;
        if (v[j] == max1)
            ++cnt;
        else
            max2 = nan_max(max2, v[j]);
    }
#pragma unroll
    for (int j = 0; j < kDegree; ++j) {
        if (!has[j + 1]) continue;
        const T excl = v[j + 1] == max1 ? (cnt > 1 ? max1 : max2) : max1;
        const T lim = clamp0(excl);
        const int c = x.pr.cs + j, k = c - kids.lo;
        w.limdn[c] = lim;
        if (kids.smem && k < kCap) ch.cv[kids.buf * kCap + k] = lim;
    }
}

// The two sweeps over levels: the up-sweep (Up) from maxdep to 0, the
// down-sweep from 0 to maxdep - 1. A level wider than `wide` is split over
// the cluster (a contiguous range a block, through the scratch, a cluster
// barrier at its end); a run of narrower ones is block 0's alone, with a
// block barrier a level, its values also in block 0's channels, and each
// thread's first position's inputs copied kAhead levels ahead into its
// ring slot (cp.async, which the level barriers do not wait for); the other
// blocks wait at one cluster barrier at the end of the run.
template <bool Up, typename T, int NT>
__device__ void sweep(const ExactState<T>& s, const ExactShared<T, NT>& sh,
                      const Scratch<T>& w, const Chan<T>& ch,
                      const T* __restrict__ row, int maxdep, int C, int wide,
                      bool solo, long long* lv)
{
    using In = typename std::conditional<Up, UpIn<T>, DownIn<T>>::type;
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    if (solo && rank != 0) return;  // every level is block 0's
    const int t = threadIdx.x;
    const bool all_narrow = C == 1 || solo;
    const int first = Up ? maxdep : 0, last = Up ? 0 : maxdep - 1;
    const int step = Up ? -1 : 1;
    const auto more = [&](int l) { return Up ? l >= last : l <= last; };
    const auto lo_of = [&](int l) { return level_start(sh, w, l); };
    const auto width = [&](int l) { return lo_of(l + 1) - lo_of(l); };
    const auto narrow = [&](int l) {
        return all_narrow || width(l) <= wide;
    };
    // a level's channel: in block 0's shared memory when block 0 alone
    // computed it
    const auto lane = [&](int l, bool block0) {
        return Lane{lo_of(l), l & 1, block0 && l >= 0 && l <= maxdep
                                         && narrow(l)};
    };
    const auto load = [&](int p) {
        if constexpr (Up)
            return up_in(w, p);
        else
            return down_in(w, p);
    };
    // the channel a level writes (Up: its own v and w; down: its
    // children's limdn) and the one it reads (Up: its children's; down: its
    // own limdn, which its parents' level wrote)
    const auto writes = [&](int l, bool b0) {
        return Up ? lane(l, b0) : lane(l + 1, b0 && narrow(l));
    };
    const auto reads = [&](int l, bool b0) {
        return Up ? lane(l + 1, b0) : lane(l, b0 && l > 0 && narrow(l - 1));
    };
    // the up-sweep's values of level l go to the scratch too where level
    // l - 1 is split over the cluster
    const auto run = [&](int p, const In& x, Lane wr, Lane rd, int l) {
        if constexpr (Up)
            up_step(s, w, ch, row, p, x, wr, rd, l > 0 && !narrow(l - 1));
        else
            down_step(w, ch, p, x, rd, wr);
    };
    // block 0's run: each thread's first-chunk inputs of the level kAhead
    // levels ahead go to its ring slot of that level (one commit group a
    // level, empty where it has none)
    constexpr int kRing = ring_levels<T, NT>(), kAhead = kRing - 1;
    static_assert(kRing >= 2, "a ring of two levels at least");
    const auto slot_of = [&](int l) {
        const int idx = Up ? first - l : l - first;
        return ch.ring + ((size_t)(idx % kRing) * NT + t) * slot_bytes<T>();
    };
    const auto issue = [&](int l) {
        if (more(l) && t < width(l) && narrow(l))
            copy_in<Up>(slot_of(l), w, lo_of(l) + t);
        async_commit();
    };
    int l = first;
    while (more(l)) {
        if (!narrow(l)) {
            const int lo = lo_of(l), hi = lo_of(l + 1);
            const int per = (hi - lo + C - 1) / C;
            const int a = lo + rank * per, b = min(hi, a + per);
            if (a + t < b) {
                const Lane wr = writes(l, false), rd = reads(l, false);
                for (int p = a + t; p < b; p += NT)
                    run(p, load(p), wr, rd, l);
            }
            cl.sync();
            stamp_level(lv, Up ? 1 : 2, l);
            l += step;
            continue;
        }
        if (rank == 0) {
#pragma unroll
            for (int d = 0; d < kAhead; ++d) issue(l + d * step);
            // the level's bounds, kept as the run moves (one read a level)
            int lo = lo_of(l), hi = lo_of(l + 1);
            while (true) {
                issue(l + kAhead * step);
                async_wait<kAhead>();
                if (t < hi - lo) {
                    // only the threads with a position do the level's
                    // bookkeeping; where every level is block 0's, the
                    // channels are the level's and its neighbour's
                    const Lane wr = all_narrow
                                        ? (Up ? Lane{lo, l & 1, true}
                                              : Lane{hi, (l + 1) & 1, true})
                                        : writes(l, true);
                    const Lane rd = all_narrow
                                        ? (Up ? Lane{hi, (l + 1) & 1,
                                                     l < maxdep}
                                              : Lane{lo, l & 1, l > 0})
                                        : reads(l, true);
                    In x;
                    read_in(slot_of(l), x);
                    run(lo + t, x, wr, rd, l);
                    for (int p = lo + t + NT; p < hi; p += NT)
                        run(p, load(p), wr, rd, l);
                }
                __syncthreads();
                stamp_level(lv, Up ? 1 : 2, l);
                l += step;
                if (!more(l)) break;
                if (Up) {
                    hi = lo;
                    lo = lo_of(l);
                } else {
                    lo = hi;
                    hi = lo_of(l + 1);
                }
                if (!all_narrow && hi - lo > wide) break;
            }
            async_wait<0>();  // the ring is free for the next run
        } else {
            while (more(l) && narrow(l)) l += step;
        }
        if (!all_narrow) cl.sync();
    }
}

template <typename T, int NT, bool Stamp>
__global__ void __launch_bounds__(NT)
exact_step_kernel(ExactState<T> s, Scratch<T> w, long long* cursor,
                  int32_t* out, int wide, long long* stamps)
{
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    __shared__ ExactShared<T, NT> sh;
    extern __shared__ __align__(16) unsigned char dyn[];
    const Chan<T> ch = channels<T>(dyn);
    stamp<Stamp>(stamps, 0);
    if (threadIdx.x < 5) sh.cur[threadIdx.x] = cursor[threadIdx.x];
    if (threadIdx.x == 0) {
        sh.status = kDone;
        sh.win_pos = -1;
        sh.halted = out[kOutError];
        sh.prev_wide = out[kOutWideLevels];
    }
    __syncthreads();
    // an earlier insertion failed: every block leaves (no block of this
    // launch writes the word before every block has arrived below)
    if (sh.halted != 0) return;
    // A tree whose walk at the last insertion (unknown before the state's
    // first) found fewer than kClusterLevels levels wider than `wide` is
    // block 0's alone: the others leave, and block 0 runs as a cluster of
    // one (which takes any tree). Every block has read the cursor and the
    // words of `out` when it arrives here: block 0 waits for this barrier
    // before it writes them (the walk before any block's shared memory is
    // written by another), so every block reads the same words.
    const int nb = (int)cl.num_blocks();
    const int C = sh.prev_wide >= kClusterLevels ? nb : 1;
    if (nb > 1) cluster_arrive();
    if (rank >= C) return;
    const long long ci = sh.cur[kCurI], cu = sh.cur[kCurUsed];
    const int N = s.n_leaves;
    const bool cursor_ok = cu >= 4 && cu <= s.n_edges - 4 && ci >= 2
                           && ci < N && ci + N - 1 < s.n_nodes
                           && sh.cur[kCurRows] != 0 && ci >= sh.cur[kCurLo];
    int positions = 0, maxdep = -1, shift = 0, shifted = 0;
    if (!cursor_ok) {
        if (nb > 1) cluster_wait();
        if (rank == 0 && threadIdx.x == 0) {
            out[kOutEid] = -1;
            out[kOutMaxdep] = -1;
            out[kOutPositions] = 0;
            out[kOutShift] = 0;
            out[kOutShiftNodes] = 0;
            out[kOutStatus] = kBadCursor;
            out[kOutError] = kBadCursor;
        }
        return;
    }
    const T* row = reinterpret_cast<const T*>(sh.cur[kCurRows])
                   + (ci - sh.cur[kCurLo]) * sh.cur[kCurStride];
    long long* lv = Stamp ? stamps + kParts : nullptr;
    int levels, nwide;
    bool solo;
    positions =
        walk(s, w, sh, ch, row, C, wide, &levels, &solo, &nwide, lv);
    stamp<Stamp>(stamps, 1);
    maxdep = levels - 1;
    const bool ok = maxdep >= 0 && positions >= 2;
    if (ok) {
        sweep<true>(s, sh, w, ch, row, maxdep, C, wide, solo, lv);
        stamp<Stamp>(stamps, 2);
        sweep<false>(s, sh, w, ch, row, maxdep, C, wide, solo, lv);
        if (C > 1 && solo) cl.sync();  // block 0's sweeps before the score
        stamp<Stamp>(stamps, 3);
        // the score: two candidates a position past the root, over every
        // thread of the cluster
        Cand<T> best = no_cand<T>();
        int best_pos = -1;
        constexpr int kBatch = 8;  // positions whose loads are in flight
        const int G = C * NT;
        for (int p0 = 1 + rank * NT + threadIdx.x; p0 < positions;
             p0 += kBatch * G) {
            T ld[kBatch], lu[kBatch], ln[kBatch];
            int dn[kBatch], up[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int p = p0 + k * G;
                if (p >= positions) continue;
                ld[k] = w.limdn[p];
                lu[k] = w.limup[p];
                ln[k] = w.lendn[p];
                dn[k] = w.dn[p];
                up[k] = w.up[p];
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int p = p0 + k * G;
                if (p >= positions) continue;
                Cand<T> c;
                edge_score(ld[k], lu[k], ln[k], &c.score, &c.frac);
                c.slot = dn[k];
                if (before(c, best)) {
                    best = c;
                    best_pos = p;
                }
                const Cand<T> inv = {T(kSentDis), T(0), up[k]};
                if (before(inv, best)) {
                    best = inv;
                    best_pos = p;
                }
            }
        }
        const Cand<T> win = block_min<T, NT / kWarp>(best, sh.part);
        if (threadIdx.x == 0) sh.win = win;
        __syncthreads();
        if (best_pos >= 0 && best.slot == sh.win.slot) sh.win_pos = best_pos;
        __syncthreads();
        if (C > 1) {
            if (threadIdx.x == 0) {
                Cand<T>* dst = cl.map_shared_rank(sh.cand, 0);
                int* dpos = cl.map_shared_rank(sh.cand_pos, 0);
                dst[rank] = sh.win;
                dpos[rank] = sh.win_pos;
            }
            cl.sync();
            if (rank == 0 && threadIdx.x == 0) {
                Cand<T> m = sh.cand[0];
                int mp = sh.cand_pos[0];
                for (int q = 1; q < C; ++q) {
                    if (before(sh.cand[q], m)) {
                        m = sh.cand[q];
                        mp = sh.cand_pos[q];
                    }
                }
                sh.win = m;
                sh.win_pos = mp;
            }
        }
    } else if (rank == 0 && threadIdx.x == 0 && sh.status == kDone) {
        sh.status = kOverflow;
    }
    // the splice: block 0's thread 0 reads the choice's ends before any
    // block shifts a depth, and hands the choice to every block
    if (rank == 0 && threadIdx.x == 0) {
        if (sh.status == kDone) {
            const int eid = sh.win.slot, pos = sh.win_pos;
            if (eid < 0 || eid >= s.n_edges || pos < 1 || pos >= positions) {
                sh.status = kBadChoice;
            } else {
                const int x = s.belong[eid], y = s.e[eid], ye = s.rev[eid];
                if (x < 0 || x >= s.n_nodes || y < 0 || y >= s.n_nodes
                    || ye < 0 || ye >= s.n_edges) {
                    sh.status = kBadChoice;
                } else {
                    const int dx = s.dep[x], dy = s.dep[y];
                    const int pa = dx < dy ? x : y, ch = dx < dy ? y : x;
                    if (pos_node(load_pos(w.pos + pos).node_nc) != ch) {
                        sh.status = kBadChoice;
                    } else {
                        sh.sp[0] = eid;
                        sh.sp[1] = x;
                        sh.sp[2] = y;
                        sh.sp[3] = ye;
                        sh.sp[4] = pa;
                        sh.sp[5] = ch;
                        sh.sp_dpa = dx < dy ? dx : dy;
                        sh.sp_orig = s.length[eid];
                    }
                }
            }
        }
        for (int q = 1; q < C; ++q) {
            ExactShared<T, NT>* o = cl.map_shared_rank(&sh, q);
            o->status = sh.status;
            o->win_pos = sh.win_pos;
        }
    }
    if (C > 1)
        cl.sync();
    else
        __syncthreads();
    stamp<Stamp>(stamps, 4);
    const int status = sh.status;
    if (status == kDone) {
        // ch's subtree, level by level, over every thread of the cluster:
        // no barrier, the ranges are read-only
        const int g = rank * NT + threadIdx.x;
        int a = sh.win_pos, b = a + 1;
        while (a < b) {
            for (int q = a + g; q < b; q += C * NT) {
                const int v = pos_node(load_pos(w.pos + q).node_nc);
                s.dep[v] = s.dep[v] + 1;
            }
            const PosRec<T> fa = load_pos(w.pos + a),
                            fb = load_pos(w.pos + b - 1);
            shifted += b - a;
            a = fa.cs;
            b = fb.cs + pos_nc(fb.node_nc);
            ++shift;
        }
    }
    // on block 0 alone, the barrier that every block arrived at after its
    // reads of the cursor and `out`, before they are written
    if (C < nb) cluster_wait();
    if (rank == 0 && threadIdx.x == 0) {
        if (status == kDone) {
            const int eid = sh.sp[0], x = sh.sp[1], y = sh.sp[2],
                      ye = sh.sp[3];
            const int pa = sh.sp[4], ch = sh.sp[5];
            const int i = (int)ci, i0 = (int)cu;
            const int i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3;
            const int middle = i + N - 1, outside = i;
            const T frac = sh.win.frac, add = sh.win.score;
            const T rest = sub_rn(sh.sp_orig, frac);
            // the plain version's writes, in its order
            const int at[6] = {eid, ye, i0, i1, i2, i3};
            const int to[6] = {middle, middle, x, y, middle, outside};
            const int rv[6] = {i0, i1, eid, ye, i3, i2};
            const T ln[6] = {frac, rest, frac, rest, add, add};
#pragma unroll
            for (int j = 0; j < 6; ++j) {
                s.e[at[j]] = to[j];
                s.rev[at[j]] = rv[j];
                s.length[at[j]] = ln[j];
            }
            s.belong[i0] = middle;
            s.belong[i1] = middle;
            s.belong[i2] = outside;
            s.belong[i3] = middle;
            s.dep[middle] = sh.sp_dpa + 1;
            s.dep[outside] = sh.sp_dpa + 2;
            s.parent[ch] = middle;
            s.parent[middle] = pa;
            s.parent[outside] = middle;
            int32_t* am = s.adj + (size_t)middle * kDegree;
            int32_t* ao = s.adj + (size_t)outside * kDegree;
            am[0] = i0;
            am[1] = i1;
            am[2] = i3;
            ao[0] = i2;
            ao[1] = -1;
            ao[2] = -1;
            // the records: x's and y's entries of the split edge now lead
            // to middle; middle's and outside's as their adjacency rows
#pragma unroll
            for (int j = 0; j < kDegree; ++j) {
                NodeRec<T>* rx = s.rec + x;
                if (rx->slot[j] == eid) {
                    rx->nb[j] = middle;
                    rx->rv[j] = i0;
                    rx->len[j] = frac;
                }
                NodeRec<T>* ry = s.rec + y;
                if (ry->slot[j] == ye) {
                    ry->nb[j] = middle;
                    ry->rv[j] = i1;
                    ry->len[j] = rest;
                }
            }
            NodeRec<T> rm, ro;
            rm.slot[0] = i0, rm.nb[0] = x, rm.rv[0] = eid, rm.len[0] = frac;
            rm.slot[1] = i1, rm.nb[1] = y, rm.rv[1] = ye, rm.len[1] = rest;
            rm.slot[2] = i3, rm.nb[2] = outside, rm.rv[2] = i2, rm.len[2] = add;
            ro.slot[0] = i2, ro.nb[0] = middle, ro.rv[0] = i3, ro.len[0] = add;
#pragma unroll
            for (int j = 1; j < kDegree; ++j) {
                ro.slot[j] = -1;
                ro.nb[j] = -1;
                ro.rv[j] = -1;
                ro.len[j] = T(0);
            }
            store_rec(s.rec + middle, rm);
            store_rec(s.rec + outside, ro);
        }
        out[kOutEid] = status == kDone ? sh.win.slot : -1;
        out[kOutMaxdep] = maxdep;
        out[kOutPositions] = positions;
        out[kOutShift] = shift;
        out[kOutShiftNodes] = shifted;
        if (positions > 0) out[kOutWideLevels] = nwide;
        out[kOutStatus] = status;
        if (status == kDone) {
            cursor[kCurI] = ci + 1;
            cursor[kCurUsed] = cu + 4;
        } else {
            out[kOutError] = status;
        }
    }
    if (Stamp) {
        // the splice's and every block's shift before the last stamp
        if (C > 1)
            cl.sync();
        else
            __syncthreads();
        stamp<Stamp>(stamps, 5);
    }
}

// Writes the cursor (thread 0) and rebuilds every node's record from the
// state: its adjacency row's slots with each slot's e, rev and length
template <typename T>
__global__ void exact_cursor_set_kernel(long long* cursor, long long i,
                                        long long used, long long rows,
                                        long long stride, long long lo,
                                        const int32_t* e, const int32_t* rev,
                                        const T* length, const int32_t* adj,
                                        NodeRec<T>* rec, int n_edges,
                                        int n_nodes)
{
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g == 0 && cursor != nullptr) {
        cursor[kCurI] = i;
        cursor[kCurUsed] = used;
        cursor[kCurRows] = rows;
        cursor[kCurStride] = stride;
        cursor[kCurLo] = lo;
    }
    if (g >= n_nodes) return;
    NodeRec<T> r;
#pragma unroll
    for (int j = 0; j < kDegree; ++j) {
        const int k = adj[g * kDegree + j];
        const bool ok = k >= 0 && k < n_edges;
        r.slot[j] = ok ? k : -1;
        r.nb[j] = ok ? e[k] : -1;
        r.rv[j] = ok ? rev[k] : -1;
        r.len[j] = ok ? length[k] : T(0);
    }
    store_rec(rec + g, r);
}

// `reps` cluster barriers in a cluster of blocks of kExactThreads threads
__global__ void __launch_bounds__(kExactThreads)
    cluster_sync_probe_kernel(int reps)
{
    cg::cluster_group cl = cg::this_cluster();
    for (int k = 0; k < reps; ++k) cl.sync();
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

// A launch configuration of `ctas` blocks of `threads` as one cluster
struct ClusterLaunch {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    ClusterLaunch(int ctas, int threads, cudaStream_t st, size_t smem = 0)
    {
        cfg.gridDim = dim3(ctas, 1, 1);
        cfg.blockDim = dim3(threads, 1, 1);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = st;
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = ctas;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
};

template <typename T>
cudaError_t launch(const ExactState<T>& s, const Scratch<T>& w,
                   long long* cursor, int32_t* out, int ctas, int wide,
                   long long* stamps, cudaStream_t st)
{
    constexpr int NT = kExactThreads;
    ClusterLaunch L(ctas, NT, st, dyn_smem_bytes<T, NT>());
    if (stamps != nullptr)
        return cudaLaunchKernelEx(&L.cfg, exact_step_kernel<T, NT, true>, s,
                                  w, cursor, out, wide, stamps);
    return cudaLaunchKernelEx(&L.cfg, exact_step_kernel<T, NT, false>, s, w,
                              cursor, out, wide, stamps);
}

template <typename T>
cudaError_t launch_any(void* const* p, void* const* q, int n_edges,
                       int n_nodes, int n_leaves, void* cursor, void* out,
                       void* stamps, int ctas, int wide, cudaStream_t st)
{
    const ExactState<T> s = {(int32_t*)p[0], (int32_t*)p[1], (T*)p[2],
                             (int32_t*)p[3], (int32_t*)p[4], (int32_t*)p[5],
                             (int32_t*)p[6], (NodeRec<T>*)p[7], n_edges,
                             n_nodes, n_leaves};
    // int scratch [4, M + 2], float scratch [5, M], position records [M],
    // children's w [M, 4]
    int32_t* si = (int32_t*)q[0];
    T* sf = (T*)q[1];
    const size_t m2 = (size_t)n_nodes + 2, m = (size_t)n_nodes;
    const Scratch<T> w = {si,         si + m2,    si + 2 * m2, si + 3 * m2,
                          sf,         sf + m,     sf + 2 * m,  sf + 3 * m,
                          sf + 4 * m, (T*)q[3],   (PosRec<T>*)q[2]};
    return launch<T>(s, w, (long long*)cursor, (int32_t*)out, ctas, wide,
                     (long long*)stamps, st);
}

template <typename K>
cudaError_t allow_and_count(K kernel, int ctas, int smem, int* clusters)
{
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    cudaFuncAttributes a;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&a, (const void*)kernel);
    if (err != cudaSuccess) return err;
    ClusterLaunch L(ctas, kExactThreads, nullptr, smem);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &L.cfg);
    if (err == cudaSuccess && (*clusters < 0 || n < *clusters)) *clusters = n;
    return err;
}

template <typename T>
cudaError_t allow_both(int ctas, int* clusters)
{
    constexpr int NT = kExactThreads;
    cudaError_t err = allow_and_count(exact_step_kernel<T, NT, false>, ctas,
                                      dyn_smem_bytes<T, NT>(), clusters);
    if (err == cudaSuccess)
        err = allow_and_count(exact_step_kernel<T, NT, true>, ctas,
                              dyn_smem_bytes<T, NT>(), clusters);
    return err;
}

}  // namespace

// One insertion of exact placement from the cursor (int64 [5]). State: e,
// belong, length, rev, parent, dep, adj ([M, 3]), rec (node records [M],
// 48 or 64 bytes each); scratch: int32 [4, M + 2], T [5, M], position
// records [M] (16 bytes each) and T [M, 4]; out: int32 [8], its count of
// wide levels -1 and its last word (the sticky error) 0 before the
// state's first launch; stamps: int64 [8 + 3 x 512] for the stamped
// instance, else null;
// n_edges, n_nodes (M), n_leaves (N, also the root's id); is_f64 (float or
// double lengths and rows); a cluster of `ctas` (1 to 8) blocks of
// kExactThreads; levels wider than `wide` (>= 1) split over the cluster; the
// device. Launches on `stream` without synchronizing;
// returns the CUDA error code.
extern "C" int exact_step(void* e, void* belong, void* length, void* rev,
                          void* parent, void* dep, void* adj, void* rec,
                          void* scratch_i, void* scratch_f, void* scratch_p,
                          void* scratch_w, void* out, void* cursor,
                          void* stamps, int n_edges,
                          int n_nodes, int n_leaves, int is_f64, int ctas,
                          int wide, int device, void* stream)
{
    if (n_edges < 4 || n_nodes < 3 || n_nodes > (1 << 29) || n_leaves < 2
        || n_leaves >= n_nodes || cursor == nullptr || out == nullptr
        || rec == nullptr || scratch_w == nullptr || ctas < 1
        || ctas > kMaxCtas || wide < 1)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[8] = {e, belong, length, rev, parent, dep, adj, rec};
    void* const q[4] = {scratch_i, scratch_f, scratch_p, scratch_w};
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err =
        is_f64 ? launch_any<double>(p, q, n_edges, n_nodes, n_leaves, cursor,
                                    out, stamps, ctas, wide, st)
               : launch_any<float>(p, q, n_edges, n_nodes, n_leaves, cursor,
                                   out, stamps, ctas, wide, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Writes the cursor (int64 [5]), unless it is null: i, slots in use, the
// address of the range's first distance row, the rows' stride in elements,
// the range's first insertion; and rebuilds the node records `rec` [M]
// from e, rev, length and adj ([M, 3]).
extern "C" int exact_cursor_set(void* cursor, long long i, long long used,
                                long long rows, long long stride,
                                long long lo, void* e, void* rev,
                                void* length, void* adj, void* rec,
                                int n_edges, int n_nodes, int is_f64,
                                int device, void* stream)
{
    if (rec == nullptr || n_nodes < 1) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    const int threads = 256;
    const int blocks = (n_nodes + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        exact_cursor_set_kernel<double><<<blocks, threads, 0, st>>>(
            (long long*)cursor, i, used, rows, stride, lo, (const int32_t*)e,
            (const int32_t*)rev, (const double*)length, (const int32_t*)adj,
            (NodeRec<double>*)rec, n_edges, n_nodes);
    else
        exact_cursor_set_kernel<float><<<blocks, threads, 0, st>>>(
            (long long*)cursor, i, used, rows, stride, lo, (const int32_t*)e,
            (const int32_t*)rev, (const float*)length, (const int32_t*)adj,
            (NodeRec<float>*)rec, n_edges, n_nodes);
    return (int)cudaGetLastError();
}

// Loads every kernel of the library on `device` (under lazy module loading
// a kernel is loaded at its first launch, which a stream capture must not
// be), and writes to *clusters the number of clusters of `ctas` (1 to 8)
// blocks of kExactThreads that the card can hold at once
// (cudaOccupancyMaxActiveClusters, the least over the two types and both
// instances; 0: such a launch cannot be scheduled).
extern "C" int exact_step_preload(int device, int ctas, int* clusters)
{
    if (ctas < 1 || ctas > kMaxCtas || clusters == nullptr)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    *clusters = -1;
    cudaError_t err = allow_both<float>(ctas, clusters);
    if (err == cudaSuccess) err = allow_both<double>(ctas, clusters);
    cudaFuncAttributes a;
    const void* fns[] = {(const void*)exact_cursor_set_kernel<float>,
                         (const void*)exact_cursor_set_kernel<double>,
                         (const void*)cluster_sync_probe_kernel};
    for (const void* f : fns)
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, f);
    return (int)err;
}

// One launch of `reps` cluster barriers in a cluster of kMaxCtas blocks of
// kExactThreads (the main path's shape): timed against reps = 0, the cost of
// one barrier.
extern "C" int exact_cluster_sync_probe(int reps, int device, void* stream)
{
    if (reps < 0) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    ClusterLaunch L(kMaxCtas, kExactThreads, (cudaStream_t)stream);
    const cudaError_t err =
        cudaLaunchKernelEx(&L.cfg, cluster_sync_probe_kernel, reps);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* exact_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
