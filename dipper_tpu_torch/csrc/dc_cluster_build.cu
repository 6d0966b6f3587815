// D&C's batched cluster build on Hopper (sm_90a): the whole local build of
// a chunk of clusters in one launch.
//
// Replaces the JAX package's _cluster_build (dipper_tpu/dc/pipeline.py:
// 228-263) as _cluster_build_vmapped (:451-454) runs it over a chunk: one
// jitted, vmapped fori_loop of _cluster_step (:180-225), an XLA program and
// not Pallas. The plain version is the port's tensor code, dc/cluster.py::
// build_clusters_plain (cluster_step a member index over the chunk: masked
// scoring, _splice_batched, _bfs_dense_batched with one host sync a BFS
// level); dc/cluster_model.py::build_chunk models this file's plans.
//
// Cluster c builds alone: for kq = 0 .. sizes[c] - 1 it reads row kq of the
// cluster's distances Dq[c] and
//
// 1. scores the 2 + 4 kq slots in use (a slot valid where scoreable, (2.0,
//    frac 0) elsewhere, the candidate (2.0, position n_used) for the unused
//    slots, the minimum over (score, mask position) with NaN first);
// 2. splices member kq onto the chosen edge (insert_step.cuh's splice:
//    middle 2 + cmax + kq, outside 2 + kq, the reference's (cd + orig) -
//    frac and the stable merge of the two lists), clears the flags of the
//    chosen edge and its reverse and sets the new group's (true, true,
//    false, true);
// 3. runs the witness BFS from outside with label 10 + kq, slot 0's
//    endpoints as they stand after the splice dequeued but not expanded.
//
// Nothing needs the host between members: the chunk's distances are on the
// card before the launch, as they are before the JAX package's one program a
// chunk. A padded member is never inserted: a cluster stops at its size.
//
// State: the chunk's [C, E] arrays that dc/cluster.py::cluster_init_state
// makes (E = 2 + 4 cmax), an adjacency table [C, M, 3] and flags [C, E]
// (M = 2 + 2 cmax); e, belong and length are the build's output.
//
// Three plans, by bucket (launch_by_bucket; cluster_model.kernel_config
// mirrors the choice and dc_cluster_build_plan reports it):
//
// - warp (cmax <= 32): a warp a cluster, kWarpsPerBlock clusters a block,
//   each warp's cluster state (the arrays, flags, adjacency, the walk's
//   whole frontier and the staged row) in its own slice of the block's
//   shared memory: staged in at the start, written back at the end. The
//   warp scores (a lane a slot, shuffles for the minimum), splices and
//   walks every level in chunks of 32 pairs placed by a ballot: no block
//   barrier, and no trip to L2 inside a member but its row's entries,
//   loaded one member ahead (witness ids below 10 + kq: those the lists can
//   name);
// - block (cmax <= 512 where a slice fits the block's shared memory): a
//   block a cluster over one slice; the block scores, warp 0 splices and
//   walks as the warp plan's warp does;
// - global (wider buckets): a block a cluster over the state in device
//   memory, warp 0's splice and the block's walk through insert_step.cuh's
//   functions (frontier buffers of Cap entries that spill to [C, 2, M]
//   scratch): the plan of the first port.
//
// What bounds it: latency. In the shared plans a member is one dependent
// trip to L2 (its row's entries, hidden behind the member before) and a
// chain of shared-memory accesses: the score's, the splice's and two a BFS
// level. A chunk's clusters run side by side, 8,192 of them at bucket 8.

#include <cuda_pipeline.h>

#include "insert_step.cuh"

namespace {

using namespace dipper;

// clusters (warps) a block of the warp plan; dynamic shared memory a block
// may take (H100: 232,448 bytes, less 1 KB for the static part); the
// widest bucket of the block plan
constexpr int kWarpsPerBlock = 4;
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kBlockPlanMax = 512;

enum Plan { kPlanWarp = 0, kPlanBlock = 1, kPlanGlobal = 2 };

// A chunk of clusters: [C, E] state arrays, [C, M, 3] adjacency, [C, 2, M]
// frontier scratch (the global plan's), [C, E] flags; Dq's rows (unit
// stride along a row, W entries), sizes [C]
template <typename T>
struct Chunk {
    int32_t* e;
    int32_t* belong;
    T* length;
    int32_t* rev;
    T* cdis;
    int32_t* cid;
    int32_t* adj;
    int32_t* f_ids;
    int32_t* f_frm;
    T* f_dist;
    uint8_t* scoreable;
    const T* dq;
    long long dq_c, dq_k;  // strides of Dq's cluster and member axes
    const int32_t* sizes;
    int n_clusters, n_edges, n_nodes, cmax, row_w;
};

// One cluster's slice of shared memory: byte offsets (cluster_model.
// slice_layout): the float arrays, then the int32 ones, then the flags
struct SliceLayout {
    int length, cdis, f_dist, row, e, belong, rev, cid, adj, f_ids, f_frm,
        flags, bytes;
};

inline SliceLayout slice_layout(int cmax, int item)
{
    const int E = 2 + 4 * cmax, M = 2 + 2 * cmax, R = 10 + cmax;
    SliceLayout L;
    int at = 0;
    L.length = at; at += E * item;
    L.cdis = at; at += kK * E * item;
    L.f_dist = at; at += 2 * M * item;
    L.row = at; at += R * item;
    L.e = at; at += 4 * E;
    L.belong = at; at += 4 * E;
    L.rev = at; at += 4 * E;
    L.cid = at; at += 4 * kK * E;
    L.adj = at; at += 4 * kDegree * M;
    L.f_ids = at; at += 4 * 2 * M;
    L.f_frm = at; at += 4 * 2 * M;
    L.flags = at; at += E;
    L.bytes = (at + 15) / 16 * 16;
    return L;
}

inline int plan_of(int cmax, int item)
{
    if (cmax <= kWarp) return kPlanWarp;
    if (cmax <= kBlockPlanMax && slice_layout(cmax, item).bytes <= kSmemLimit)
        return kPlanBlock;
    return kPlanGlobal;
}

// A cluster's state, flags and staged row in its slice
template <typename T>
struct Slice {
    State<T> s;  // f_ids, f_frm, f_dist: the walk's frontier [2, M]
    uint8_t* flags;
    T* row;
};

template <typename T>
__device__ Slice<T> slice_at(unsigned char* b, const SliceLayout& L, int E,
                             int M)
{
    const State<T> s = {(int32_t*)(b + L.e), (int32_t*)(b + L.belong),
                        (T*)(b + L.length), (int32_t*)(b + L.rev),
                        (T*)(b + L.cdis), (int32_t*)(b + L.cid),
                        (int32_t*)(b + L.adj), (int32_t*)(b + L.f_ids),
                        (int32_t*)(b + L.f_frm), (T*)(b + L.f_dist), E, M};
    return {s, b + L.flags, (T*)(b + L.row)};
}

template <typename V>
__device__ __forceinline__ void copy_n(V* dst, const V* src, int n, int t,
                                       int lanes)
{
    for (int i = t; i < n; i += lanes) dst[i] = src[i];
}

// dst[i] = src[i] (4- or 8-byte entries, shared <- device memory) by
// cp.async: every copy in flight at once, awaited by stage
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src, int n,
                                           int t, int lanes)
{
    static_assert(sizeof(V) == 4 || sizeof(V) == 8, "4- or 8-byte entries");
    for (int i = t; i < n; i += lanes)
        __pipeline_memcpy_async(dst + i, src + i, sizeof(V));
}

// Cluster c's arrays, adjacency and flags from device memory into its slice
// (`in`: one round of asynchronous copies, the flags by plain loads
// meanwhile; the caller's barrier then publishes them) or back, by `lanes`
// threads of which this is number t
template <typename T>
__device__ void stage(const Chunk<T>& ch, size_t c, const Slice<T>& sl,
                      int t, int lanes, bool in)
{
    const int E = ch.n_edges, M = ch.n_nodes;
    const size_t oe = c * E, ol = c * E * kK, oa = c * M * kDegree;
    if (in) {
        copy_async(sl.s.e, ch.e + oe, E, t, lanes);
        copy_async(sl.s.belong, ch.belong + oe, E, t, lanes);
        copy_async(sl.s.rev, ch.rev + oe, E, t, lanes);
        copy_async(sl.s.length, ch.length + oe, E, t, lanes);
        copy_async(sl.s.cdis, ch.cdis + ol, kK * E, t, lanes);
        copy_async(sl.s.cid, ch.cid + ol, kK * E, t, lanes);
        copy_async(sl.s.adj, ch.adj + oa, kDegree * M, t, lanes);
        __pipeline_commit();
        copy_n(sl.flags, ch.scoreable + oe, E, t, lanes);
        __pipeline_wait_prior(0);
    } else {
        copy_n(ch.e + oe, sl.s.e, E, t, lanes);
        copy_n(ch.belong + oe, sl.s.belong, E, t, lanes);
        copy_n(ch.rev + oe, sl.s.rev, E, t, lanes);
        copy_n(ch.length + oe, sl.s.length, E, t, lanes);
        copy_n(ch.cdis + ol, sl.s.cdis, kK * E, t, lanes);
        copy_n(ch.cid + ol, sl.s.cid, kK * E, t, lanes);
        copy_n(ch.adj + oa, sl.s.adj, kDegree * M, t, lanes);
        copy_n(ch.scoreable + oe, sl.flags, E, t, lanes);
    }
}

// A member's row entries below n (Per a thread) into registers, then into
// the slice: the loads are issued one member ahead of their use
template <typename T, int Per>
__device__ __forceinline__ void row_load(const T* __restrict__ row, int n,
                                         int t, int lanes, T (&v)[Per])
{
#pragma unroll
    for (int r = 0; r < Per; ++r) {
        const int j = t + r * lanes;
        v[r] = j < n ? __ldg(row + j) : T(0);
    }
}

template <typename T, int Per>
__device__ __forceinline__ void row_store(T* dst, int n, int t, int lanes,
                                          const T (&v)[Per])
{
#pragma unroll
    for (int r = 0; r < Per; ++r) {
        const int j = t + r * lanes;
        if (j < n) dst[j] = v[r];
    }
}

// Member kq's row entries that its lists can name
template <typename T>
__device__ __forceinline__ int row_entries(const Chunk<T>& ch, int kq)
{
    return min(10 + kq, ch.row_w);
}

// slot j's candidate from the slice, its reads by level of dependence: the
// slot's flag, reverse slot, length and lists; the reverse slot's lists and
// the row entries of the slot's; those of the reverse slot's
template <typename T>
__device__ __forceinline__ Cand<T> slot_cand(const Slice<T>& sl, int j)
{
    const uint8_t on = sl.flags[j];
    const int r = max(sl.s.rev[j], 0);
    const T len = sl.s.length[j];
    int32_t c[kK], rc[kK];
    T d[kK], rd[kK], v[kK], rv[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) {
        c[q] = sl.s.cid[j * kK + q];
        d[q] = sl.s.cdis[j * kK + q];
    }
#pragma unroll
    for (int q = 0; q < kK; ++q) {
        rc[q] = sl.s.cid[r * kK + q];
        rd[q] = sl.s.cdis[r * kK + q];
        v[q] = sl.row[max(c[q], 0)];
    }
#pragma unroll
    for (int q = 0; q < kK; ++q) rv[q] = sl.row[max(rc[q], 0)];
    Cand<T> cand = {T(2), T(0), mask_position(j)};
    if (on != 0)
        edge_score(side_vals(c, d, v), side_vals(rc, rd, rv), len,
                   &cand.score, &cand.frac);
    return cand;
}

// The splice of member kq, its flags and its walk, by one warp on a slice
template <typename T>
__device__ void member_tail(const Slice<T>& sl, int lane, Cand<T> best,
                            int n_used, int kq, int cmax)
{
    const int label = 10 + kq;
    int count = 0, xy[2];
    Entry<T> first = {-1, -1, T(0)};
    Blocked bl = {0, -1, -1};
    const bool ok = splice_lanes(sl.s, lane, mask_position(best.slot),
                                 best.frac, best.score, n_used,
                                 2 + cmax + kq, 2 + kq, label, 0, xy, &count,
                                 &first, &bl);
    if (ok && lane < 2) sl.flags[xy[lane]] = 0;
    __syncwarp();  // cleared before the new group is set
    if (lane >= 2 && lane < 6 && n_used + lane - 2 < sl.s.n_edges)
        sl.flags[n_used + lane - 2] = lane != 4;
    if (!ok) count = 0;
    walk_lanes(sl.s, lane, first, count, 1, label, bl);
}

// The warp plan: warp w of block b builds cluster b * kWarpsPerBlock + w
template <typename T, int Per>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
cluster_warp_kernel(Chunk<T> ch, SliceLayout L)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    const size_t c = (size_t)blockIdx.x * kWarpsPerBlock + warp;
    if (c >= (size_t)ch.n_clusters) return;
    const int E = ch.n_edges;
    const Slice<T> sl = slice_at<T>(smem + warp * L.bytes, L, E, ch.n_nodes);
    stage(ch, c, sl, lane, kWarp, true);
    const int size = min(__ldg(ch.sizes + c), ch.cmax);
    const T* dq = ch.dq + (long long)c * ch.dq_c;
    T ahead[Per];
    if (size > 0) {
        row_load(dq, row_entries(ch, 0), lane, kWarp, ahead);
        row_store(sl.row, row_entries(ch, 0), lane, kWarp, ahead);
    }
    __syncwarp();
    for (int kq = 0; kq < size; ++kq) {
        const int n_used = 2 + 4 * kq;
        const bool next = kq + 1 < size;
        if (next)
            row_load(dq + (long long)(kq + 1) * ch.dq_k,
                     row_entries(ch, kq + 1), lane, kWarp, ahead);
        Cand<T> best = no_cand<T>();
        for (int j = lane; j < n_used; j += kWarp) {
            const Cand<T> cand = slot_cand(sl, j);
            if (before(cand, best)) best = cand;
        }
        best = warp_min_all(best);
        const Cand<T> unused = {T(2), T(0), n_used};
        if (n_used < E && before(unused, best)) best = unused;
        member_tail(sl, lane, best, n_used, kq, ch.cmax);
        // the next row behind the splice and the walk (which end at a
        // __syncwarp, after every read of this row)
        if (next) row_store(sl.row, row_entries(ch, kq + 1), lane, kWarp, ahead);
        __syncwarp();
    }
    __syncwarp();
    stage(ch, c, sl, lane, kWarp, false);
}

// The block plan: block c builds cluster c over one slice
template <typename T, int Threads, int Per>
__global__ void __launch_bounds__(Threads)
cluster_block_kernel(Chunk<T> ch, SliceLayout L)
{
    constexpr int kWarpsB = Threads / kWarp;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Cand<T> s_part[kWarpsB];
    __shared__ Cand<T> s_best;
    const size_t c = blockIdx.x;
    const int E = ch.n_edges, t = threadIdx.x;
    const Slice<T> sl = slice_at<T>(smem, L, E, ch.n_nodes);
    stage(ch, c, sl, t, Threads, true);
    const int size = min(__ldg(ch.sizes + c), ch.cmax);
    const T* dq = ch.dq + (long long)c * ch.dq_c;
    T ahead[Per];
    if (size > 0) {
        row_load(dq, row_entries(ch, 0), t, Threads, ahead);
        row_store(sl.row, row_entries(ch, 0), t, Threads, ahead);
    }
    __syncthreads();
    for (int kq = 0; kq < size; ++kq) {
        const int n_used = 2 + 4 * kq;
        const bool next = kq + 1 < size;
        if (next)
            row_load(dq + (long long)(kq + 1) * ch.dq_k,
                     row_entries(ch, kq + 1), t, Threads, ahead);
        Cand<T> best = no_cand<T>();
        for (int j = t; j < n_used; j += Threads) {
            const Cand<T> cand = slot_cand(sl, j);
            if (before(cand, best)) best = cand;
        }
        // its barrier also ends every read of the row
        best = block_min<T, kWarpsB>(best, s_part);
        if (t == 0) {
            const Cand<T> unused = {T(2), T(0), n_used};
            if (n_used < E && before(unused, best)) best = unused;
            s_best = best;
        }
        __syncthreads();  // the choice
        if (t < kWarp) member_tail(sl, t, s_best, n_used, kq, ch.cmax);
        if (next) row_store(sl.row, row_entries(ch, kq + 1), t, Threads, ahead);
        __syncthreads();  // the member's writes and the next row before
                          // the next member's reads
    }
    stage(ch, c, sl, t, Threads, false);
}

// The global plan: block c builds cluster c over the state in device
// memory (data the launch writes read with plain loads, Dq through the
// read-only path)
template <typename T, int Threads, int Cap>
__global__ void __launch_bounds__(Threads)
cluster_global_kernel(Chunk<T> ch)
{
    constexpr int kWarpsB = Threads / kWarp;
    __shared__ Shared<T, Threads, Cap> sh;
    __shared__ Cand<T> s_part[kWarpsB];
    __shared__ int32_t s_eid;
    __shared__ T s_frac, s_add;
    __shared__ int32_t s_xy[2];
    const size_t c = blockIdx.x;
    const int E = ch.n_edges, M = ch.n_nodes;
    const State<T> s = {ch.e + c * E, ch.belong + c * E, ch.length + c * E,
                        ch.rev + c * E, ch.cdis + c * E * kK,
                        ch.cid + c * E * kK, ch.adj + c * M * kDegree,
                        ch.f_ids + c * 2 * M, ch.f_frm + c * 2 * M,
                        ch.f_dist + c * 2 * M, E, M};
    uint8_t* flags = ch.scoreable + c * E;
    const int size = min(__ldg(ch.sizes + c), ch.cmax);
    for (int kq = 0; kq < size; ++kq) {
        const int n_used = 2 + 4 * kq;
        const T* row = ch.dq + (long long)c * ch.dq_c + kq * ch.dq_k;
        Cand<T> best = no_cand<T>();
        for (int j = threadIdx.x; j < n_used; j += Threads) {
            Cand<T> cand = {T(2), T(0), mask_position(j)};
            if (flags[j] != 0) {
                const int r = max(s.rev[j], 0);
                edge_score(side_written(s.cid, s.cdis, j, row),
                           side_written(s.cid, s.cdis, r, row), s.length[j],
                           &cand.score, &cand.frac);
            }
            if (before(cand, best)) best = cand;
        }
        best = block_min<T, kWarpsB>(best, s_part);
        if (threadIdx.x == 0) {
            const Cand<T> unused = {T(2), T(0), n_used};
            if (n_used < E && before(unused, best)) best = unused;
            s_eid = mask_position(best.slot);
            s_frac = best.frac;
            s_add = best.score;
        }
        __syncthreads();  // the choice, and every read of the flags
        insert_member(s, sh, flags, &s_eid, &s_frac, &s_add, n_used, kq,
                      ch.cmax, s_xy);
    }
}

template <typename K>
int launch_shared(K kernel, int blocks, int threads, int smem,
                  const void* ch, const SliceLayout* L, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    void* args[2] = {const_cast<void*>(ch), const_cast<SliceLayout*>(L)};
    err = cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(threads),
                           args, (size_t)smem, stream);
    return (int)err;
}

template <typename T>
int launch_by_bucket(void* const* p, const void* dq, long long dq_c,
                     long long dq_k, int row_w, const void* sizes,
                     int n_clusters, int n_edges, int n_nodes, int cmax,
                     cudaStream_t stream)
{
    const Chunk<T> ch = {(int32_t*)p[0], (int32_t*)p[1], (T*)p[2],
                         (int32_t*)p[3], (T*)p[4], (int32_t*)p[5],
                         (int32_t*)p[6], (int32_t*)p[7], (int32_t*)p[8],
                         (T*)p[9], (uint8_t*)p[10], (const T*)dq, dq_c,
                         dq_k, (const int32_t*)sizes, n_clusters, n_edges,
                         n_nodes, cmax, row_w};
    const int plan = plan_of(cmax, (int)sizeof(T));
    const SliceLayout L = slice_layout(plan == kPlanGlobal ? 1 : cmax,
                                       (int)sizeof(T));
    switch (plan) {
    case kPlanWarp:
        // 10 + cmax <= 42 row entries: two a lane
        return launch_shared(cluster_warp_kernel<T, 2>,
                             (n_clusters + kWarpsPerBlock - 1)
                                 / kWarpsPerBlock,
                             kWarp * kWarpsPerBlock,
                             kWarpsPerBlock * L.bytes, &ch, &L, stream);
    case kPlanBlock:
        // 10 + cmax row entries: at most 138 over 128 threads, 522 over 256
        if (cmax <= 128)
            return launch_shared(cluster_block_kernel<T, 128, 2>, n_clusters,
                                 128, L.bytes, &ch, &L, stream);
        return launch_shared(cluster_block_kernel<T, 256, 3>, n_clusters,
                             256, L.bytes, &ch, &L, stream);
    default:
        if (cmax <= 128)
            cluster_global_kernel<T, 128, 128>
                <<<n_clusters, 128, 0, stream>>>(ch);
        else
            cluster_global_kernel<T, 256, 256>
                <<<n_clusters, 256, 0, stream>>>(ch);
        return (int)cudaGetLastError();
    }
}

// One thread follows a cycle of n int32 links (at most kChaseMax) in shared
// memory for `steps` steps: one dependent shared-memory load a step, the
// unit of the shared plans' latency floor. out[0] gets the last link.
constexpr int kChaseMax = 8192;

__global__ void shared_chase_kernel(const int32_t* __restrict__ link, int n,
                                    int steps, int32_t* out)
{
    __shared__ int32_t s[kChaseMax];
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = link[i];
    __syncthreads();
    if (threadIdx.x != 0) return;
    int at = 0;
    for (int k = 0; k < steps; ++k) at = s[at];
    out[0] = at;
}

}  // namespace

// Builds n_clusters clusters of bucket width cmax in place: e, belong,
// length, rev, cdis, cid ([C, E], E = 2 + 4 cmax), adj ([C, M, 3], M = 2 +
// 2 cmax), f_ids, f_frm, f_dist ([C, 2, M] scratch of the global plan),
// scoreable (uint8 [C, E]); dq (T, member k of cluster c at dq + c dq_c +
// k dq_k, unit stride along a row of row_w entries, every witness id of a
// list a valid column, those of member k's lists below 10 + k); sizes
// (int32 [C], each at most cmax). Launches on `stream` of `device` without
// synchronizing; returns the CUDA error code (0 on success).
extern "C" int dc_cluster_build(void* e, void* belong, void* length,
                                void* rev, void* cdis, void* cid, void* adj,
                                void* f_ids, void* f_frm, void* f_dist,
                                void* scoreable, const void* dq,
                                long long dq_c, long long dq_k, int row_w,
                                const void* sizes, int n_clusters, int cmax,
                                int is_f64, int device, void* stream)
{
    if (n_clusters < 1 || cmax < 1 || cmax > (1 << 27) || row_w < 1
        || dq == nullptr || sizes == nullptr || e == nullptr
        || adj == nullptr || scoreable == nullptr)
        return (int)cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    void* const p[11] = {e, belong, length, rev, cdis, cid, adj, f_ids,
                         f_frm, f_dist, scoreable};
    const int E = 2 + 4 * cmax, M = 2 + 2 * cmax;
    cudaStream_t st = (cudaStream_t)stream;
    const int rc =
        is_f64 ? launch_by_bucket<double>(p, dq, dq_c, dq_k, row_w, sizes,
                                          n_clusters, E, M, cmax, st)
               : launch_by_bucket<float>(p, dq, dq_c, dq_k, row_w, sizes,
                                         n_clusters, E, M, cmax, st);
    if (current != device) cudaSetDevice(current);
    return rc;
}

// The plan dc_cluster_build takes at bucket width cmax: out[0] its kind (0
// warp, 1 block, 2 global), out[1] threads a block, out[2] clusters a
// block, out[3] dynamic shared memory bytes a block
extern "C" int dc_cluster_build_plan(int cmax, int is_f64, int* out)
{
    if (cmax < 1 || cmax > (1 << 27) || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const int item = is_f64 ? 8 : 4;
    const int plan = plan_of(cmax, item);
    const int bytes =
        plan == kPlanGlobal ? 0 : slice_layout(cmax, item).bytes;
    out[0] = plan;
    out[1] = plan == kPlanWarp ? kWarp * kWarpsPerBlock
                               : (cmax <= 128 ? 128 : 256);
    out[2] = plan == kPlanWarp ? kWarpsPerBlock : 1;
    out[3] = plan == kPlanWarp ? kWarpsPerBlock * bytes
                               : (plan == kPlanBlock ? bytes : 0);
    return 0;
}

// shared_chase_kernel over link (int32 [n], a cycle, n <= 8,192) on
// `stream` of `device`: out (int32 [1])
extern "C" int dc_cluster_build_chase(const void* link, int n, int steps,
                                      void* out, int device, void* stream)
{
    if (link == nullptr || out == nullptr || n < 1 || n > kChaseMax
        || steps < 0)
        return (int)cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    shared_chase_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)link, n, steps, (int32_t*)out);
    err = cudaGetLastError();
    if (current != device) cudaSetDevice(current);
    return (int)err;
}

extern "C" const char* dc_cluster_build_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
