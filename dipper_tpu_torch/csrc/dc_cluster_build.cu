// D&C's batched cluster build on Hopper (sm_90a): the whole local build of
// a chunk of clusters in one launch, one block a cluster.
//
// Replaces the JAX package's _cluster_build (dipper_tpu/dc/pipeline.py:
// 228-263) as _cluster_build_vmapped (:451-454) runs it over a chunk: one
// jitted, vmapped fori_loop of _cluster_step (:180-225), an XLA program and
// not Pallas. The plain version is the port's tensor code, dc/cluster.py::
// build_clusters_plain (cluster_step a member index over the chunk: masked
// scoring, _splice_batched, _bfs_dense_batched with one host sync a BFS
// level); dc/cluster_model.py::build_chunk models this file's plan.
//
// Block c builds cluster c alone: for kq = 0 .. sizes[c] - 1 it reads row
// kq of the cluster's distances Dq[c] and
//
// 1. scores the 2 + 4 kq slots in use (score_masked.cu's semantics: a
//    thread a slot, valid where scoreable, (2.0, frac 0) elsewhere, the
//    candidate (2.0, position n_used) for the unused slots, the minimum
//    over (score, mask position) with NaN first), reduced within the block;
// 2. splices member kq onto the chosen edge by warp 0 (insert_step.cuh's
//    warp_splice: middle 2 + cmax + kq, outside 2 + kq, the reference's
//    (cd + orig) - frac and the stable merge of the two lists), clears the
//    flags of the chosen edge and its reverse and sets the new group's
//    (true, true, false, true);
// 3. runs the witness BFS from outside with label 10 + kq, slot 0's
//    endpoints as they stand after the splice dequeued but not expanded
//    (insert_step.cuh's walk over the cluster's adjacency table).
//
// Nothing needs the host between members: the chunk's distances are on the
// card before the launch, as they are before the JAX package's one program a
// chunk. A padded member is never inserted: a block stops at its size.
//
// State: the chunk's [C, E] arrays that dc/cluster.py::cluster_init_state
// makes (E = 2 + 4 cmax), an adjacency table [C, M, 3] and frontier scratch
// [C, 2, M] (M = 2 + 2 cmax), all in device memory and updated in place;
// e, belong and length are the build's output. Data the launch writes is
// read with plain loads, never through the read-only path; Dq through it.
//
// The block's size follows the bucket (launch_by_bucket): 64 threads and
// frontier buffers of 64 entries up to cmax 32, 128 up to 128, 256 above,
// so that small clusters leave room for many blocks on a multiprocessor.
//
// What bounds it: latency. A member's score reads its slots in one round of
// L2 trips, its reduction costs block barriers, its splice two dependent L2
// trips, its BFS two a level; a chunk's clusters run side by side, 8,192 of
// them at bucket 8.

#include "insert_step.cuh"

namespace {

using namespace dipper;

// A chunk of clusters: [C, E] state arrays, [C, M, 3] adjacency, [C, 2, M]
// frontier scratch, [C, E] flags; Dq's rows (unit stride along a row),
// sizes [C]
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
    int n_edges, n_nodes, cmax;
};

template <typename T, int Threads, int Cap>
__global__ void __launch_bounds__(Threads)
cluster_build_kernel(Chunk<T> ch)
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
    int size = __ldg(ch.sizes + c);
    size = size < ch.cmax ? size : ch.cmax;
    for (int kq = 0; kq < size; ++kq) {
        const int n_used = 2 + 4 * kq;
        const T* row = ch.dq + (long long)c * ch.dq_c + kq * ch.dq_k;
        // 1. the masked score, a thread a slot
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
        // 2. the splice and the flags by warp 0
        const int label = 10 + kq;
        int count = 0;
        Entry<T> first = {-1, -1, T(0)};
        Blocked bl = {0, -1, -1};
        if (threadIdx.x < kWarp) {
            const int lane = threadIdx.x;
            const bool ok = warp_splice(s, &s_eid, nullptr, &s_frac, &s_add,
                                        n_used, 2 + ch.cmax + kq, 2 + kq,
                                        label, 0, s_xy, &count, &first, &bl);
            __syncwarp();  // (xe, ye) written
            if (ok && lane < 2) flags[s_xy[lane]] = 0;
            __syncwarp();  // cleared before the new group is set
            if (lane >= 2 && lane < 6 && n_used + lane - 2 < E)
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
        // 3. the BFS by the block; it ends at a barrier of every thread
        walk(s, sh, first, count, 1, label, bl);
    }
}

template <typename T, int Threads, int Cap>
int launch(const Chunk<T>& ch, int n_clusters, cudaStream_t stream)
{
    cluster_build_kernel<T, Threads, Cap>
        <<<n_clusters, Threads, 0, stream>>>(ch);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_by_bucket(void* const* p, const void* dq, long long dq_c,
                     long long dq_k, const void* sizes, int n_clusters,
                     int n_edges, int n_nodes, int cmax, cudaStream_t stream)
{
    const Chunk<T> ch = {(int32_t*)p[0], (int32_t*)p[1], (T*)p[2],
                         (int32_t*)p[3], (T*)p[4], (int32_t*)p[5],
                         (int32_t*)p[6], (int32_t*)p[7], (int32_t*)p[8],
                         (T*)p[9], (uint8_t*)p[10], (const T*)dq, dq_c,
                         dq_k, (const int32_t*)sizes, n_edges, n_nodes,
                         cmax};
    // the bucket's block (dc/cluster_model.py::kernel_config mirrors it)
    if (cmax <= 32) return launch<T, 64, 64>(ch, n_clusters, stream);
    if (cmax <= 128) return launch<T, 128, 128>(ch, n_clusters, stream);
    return launch<T, 256, 256>(ch, n_clusters, stream);
}

}  // namespace

// Builds n_clusters clusters of bucket width cmax in place: e, belong,
// length, rev, cdis, cid ([C, E], E = 2 + 4 cmax), adj ([C, M, 3], M = 2 +
// 2 cmax), f_ids, f_frm, f_dist ([C, 2, M] scratch), scoreable (uint8 [C,
// E]); dq (T, member k of cluster c at dq + c dq_c + k dq_k, unit stride
// along a row, every witness id of a list a valid column); sizes (int32
// [C], each at most cmax). Launches on `stream` of `device` without
// synchronizing; returns the CUDA error code (0 on success).
extern "C" int dc_cluster_build(void* e, void* belong, void* length,
                                void* rev, void* cdis, void* cid, void* adj,
                                void* f_ids, void* f_frm, void* f_dist,
                                void* scoreable, const void* dq,
                                long long dq_c, long long dq_k,
                                const void* sizes, int n_clusters, int cmax,
                                int is_f64, int device, void* stream)
{
    if (n_clusters < 1 || cmax < 1 || cmax > (1 << 27) || dq == nullptr
        || sizes == nullptr || e == nullptr || adj == nullptr
        || scoreable == nullptr)
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
        is_f64 ? launch_by_bucket<double>(p, dq, dq_c, dq_k, sizes,
                                          n_clusters, E, M, cmax, st)
               : launch_by_bucket<float>(p, dq, dq_c, dq_k, sizes,
                                         n_clusters, E, M, cmax, st);
    if (current != device) cudaSetDevice(current);
    return rc;
}

extern "C" const char* dc_cluster_build_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
