// D&C's streamed cluster on Hopper (sm_90a): a row block of a streamed
// cluster's build, every member's masked score, splice and walk, in one
// launch on a thread-block cluster.
//
// Replaces the JAX package's _stream_range_run (dipper_tpu/dc/
// pipeline.py:266-318): a fori_loop of _cluster_step (:180-225) over the
// members of a row block, an XLA program and not Pallas. The plain version
// is the port's tensor code, dc/cluster.py::_stream_plain (_score_masked,
// kclosest.splice and the compact BFS a member; the CPU path and this
// kernel's yardstick on the card); dc/cluster_model.py::stream_block
// models this file's plan.
//
// One launch builds members kq0 .. kq0 + n - 1 of one cluster (a state of
// E = 2 + 4 cmax slots and M = 2 + 2 cmax nodes with its adjacency table
// and scoreable flags, in device memory), member kq's distance row at rows
// + (kq - kq0) * stride. A cluster of `ctas` blocks (at most kCtasMax) of
// kBlockThreads threads loops over the members on the card:
//
// - scoring: block r scores the tiles r, r + ctas, ... of kBlockThreads slots
//   among the 2 + 4 kq in use (a thread a slot of kSlotsAThread tiles a round,
//   the round's loads issued by dependence level: the slots' flags, reverse
//   slots, lengths and lists by plain loads, then the reverse slots' lists and
//   the row entries through the read-only path, then the reverse lists' row
//   entries; a slot valid where scoreable, (2.0, frac 0) elsewhere), reduces
//   them to one candidate (score, mask position) and puts it in block 0's
//   shared memory (distributed shared memory) behind one cluster barrier: no
//   ticket, no scratch in device memory;
// - insertion: block 0 takes the first minimum over the blocks' candidates
//   in rank order and the unused slots' candidate (2.0, n_used), then
//   splices (warp 0), clears the split edge's flags, sets the new group's,
//   and walks with slot 0's endpoints blocked (insert_step.cuh's
//   insert_member: middle 2 + cmax + kq, outside 2 + kq, label 10 + kq);
//   the other blocks wait at the cluster barrier that ends the member.
//
// The barriers' release and acquire order block 0's writes of the state
// before every block's reads of the next member; data the launch writes is
// never read through the read-only path. The last member's choice goes to
// out_i (int32 [3]: eid, xe, ye) and out_f (frac, add).
//
// What bounds it: latency. A member is two cluster barriers, the scoring's
// dependent L2 trips (a slot's lists, its reverse slot's, their row
// entries) over the slots a thread holds, and block 0's splice and walk
// (two L2 trips a level). The host launches once a row block.

#include <cooperative_groups.h>

#include "insert_step.cuh"

namespace {

using namespace dipper;
namespace cg = cooperative_groups;

// most blocks of a cluster; threads a block (512 was not faster on D&C
// 30K's streamed cluster: PERF.md, PR 18); frontier entries of block 0's
// shared buffers; slots a thread scores in one round, their loads in
// flight together
constexpr int kCtasMax = 16;
constexpr int kBlockThreads = 256;
constexpr int kCap = 256;
constexpr int kSlotsAThread = 2;

template <typename T>
struct Stream {
    State<T> s;  // f_ids, f_frm, f_dist: block 0's frontier spill [2, M]
    uint8_t* flags;
    const T* rows;
    long long stride;
    int kq0, n, cmax;
    int32_t* out_i;
    T* out_f;
};

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
stream_block_kernel(Stream<T> p)
{
    __shared__ Shared<T, kBlockThreads, kCap> sh;
    __shared__ Cand<T> s_part[kBlockThreads / kWarp];
    __shared__ Cand<T> s_rank[kCtasMax];  // block 0: each block's candidate
    __shared__ int32_t s_eid;
    __shared__ T s_frac, s_add;
    __shared__ int32_t s_xy[2];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank(), ctas = (int)cl.num_blocks();
    const State<T>& s = p.s;
    const int E = s.n_edges;
    for (int j = 0; j < p.n; ++j) {
        const int kq = p.kq0 + j, n_used = 2 + 4 * kq;
        const T* row = p.rows + j * p.stride;
        Cand<T> best = no_cand<T>();
        constexpr int U = kSlotsAThread;
        const int tile = ctas * kBlockThreads;
        for (int s0 = rank * kBlockThreads; s0 < n_used; s0 += U * tile) {
            // a round's loads by dependence level: the slots' own fields,
            // their reverse slots' lists, the row entries of both
            int slot[U], r[U];
            uint8_t on[U];
            T len[U];
            int32_t c[U][kK], rc[U][kK];
            T d[U][kK], rd[U][kK], v[U][kK], rv[U][kK];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                slot[u] = s0 + u * tile + threadIdx.x;
                const int at = slot[u] < n_used ? slot[u] : 0;
                on[u] = slot[u] < n_used ? p.flags[at] : 0;
                r[u] = max(s.rev[at], 0);
                len[u] = s.length[at];
#pragma unroll
                for (int q = 0; q < kK; ++q) {
                    c[u][q] = s.cid[at * kK + q];
                    d[u][q] = s.cdis[at * kK + q];
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int q = 0; q < kK; ++q) {
                    rc[u][q] = s.cid[r[u] * kK + q];
                    rd[u][q] = s.cdis[r[u] * kK + q];
                    v[u][q] = __ldg(row + max(c[u][q], 0));
                }
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int q = 0; q < kK; ++q)
                    rv[u][q] = __ldg(row + max(rc[u][q], 0));
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (slot[u] >= n_used) continue;
                Cand<T> cand = {T(2), T(0), mask_position(slot[u])};
                if (on[u] != 0)
                    edge_score(side_vals(c[u], d[u], v[u]),
                               side_vals(rc[u], rd[u], rv[u]), len[u],
                               &cand.score, &cand.frac);
                if (before(cand, best)) best = cand;
            }
        }
        best = block_min<T, kBlockThreads / kWarp>(best, s_part);
        if (threadIdx.x == 0) cl.map_shared_rank(s_rank, 0)[rank] = best;
        cl.sync();  // every candidate in block 0, every read of the state done
        if (rank == 0) {
            if (threadIdx.x == 0) {
                Cand<T> m = s_rank[0];
                for (int q = 1; q < ctas; ++q)
                    if (before(s_rank[q], m)) m = s_rank[q];
                const Cand<T> unused = {T(2), T(0), n_used};
                if (n_used < E && before(unused, m)) m = unused;
                s_eid = mask_position(m.slot);
                s_frac = m.frac;
                s_add = m.score;
            }
            __syncthreads();  // the choice
            insert_member(s, sh, p.flags, &s_eid, &s_frac, &s_add, n_used,
                          kq, p.cmax, s_xy);
            if (j == p.n - 1 && threadIdx.x == 0) {
                p.out_i[0] = s_eid;
                p.out_i[1] = s_xy[0];
                p.out_i[2] = s_xy[1];
                p.out_f[0] = s_frac;
                p.out_f[1] = s_add;
            }
        }
        cl.sync();  // block 0's writes before the next member's reads
    }
}

template <typename T>
cudaError_t launch(const Stream<T>& p, int ctas, cudaStream_t st)
{
    const void* kernel = (const void*)stream_block_kernel<T>;
    if (ctas > 8) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(kBlockThreads, 1, 1);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, stream_block_kernel<T>, p);
}

}  // namespace

// Members kq0 .. kq0 + n - 1 of a streamed cluster of bucket width cmax, in
// place: e, belong, length, rev, cdis, cid ([E], E = 2 + 4 cmax), adj ([M,
// 3], M = 2 + 2 cmax), f_ids, f_frm, f_dist ([2, M] scratch), scoreable
// (uint8 [E]); rows (T, member kq's row at rows + (kq - kq0) * stride, unit
// stride along a row, every witness id of a list a valid column); out_i
// (int32 [3]), out_f (T [2]); a cluster of ctas blocks (1 to 16). Launches
// on `stream` of `device` without synchronizing; returns the CUDA error
// code (0 on success).
extern "C" int dc_stream_block(void* e, void* belong, void* length, void* rev,
                               void* cdis, void* cid, void* adj, void* f_ids,
                               void* f_frm, void* f_dist, void* scoreable,
                               const void* rows, long long stride, int kq0,
                               int n, int cmax, void* out_i, void* out_f,
                               int ctas, int is_f64, int device, void* stream)
{
    if (cmax < 1 || cmax > (1 << 27) || kq0 < 0 || n < 1 || kq0 + n > cmax
        || ctas < 1 || ctas > kCtasMax || rows == nullptr || e == nullptr
        || adj == nullptr || scoreable == nullptr || out_i == nullptr
        || out_f == nullptr)
        return (int)cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    const int E = 2 + 4 * cmax, M = 2 + 2 * cmax;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64) {
        const Stream<double> p = {
            {(int32_t*)e, (int32_t*)belong, (double*)length, (int32_t*)rev,
             (double*)cdis, (int32_t*)cid, (int32_t*)adj, (int32_t*)f_ids,
             (int32_t*)f_frm, (double*)f_dist, E, M},
            (uint8_t*)scoreable, (const double*)rows, stride, kq0, n, cmax,
            (int32_t*)out_i, (double*)out_f};
        err = launch(p, ctas, st);
    } else {
        const Stream<float> p = {
            {(int32_t*)e, (int32_t*)belong, (float*)length, (int32_t*)rev,
             (float*)cdis, (int32_t*)cid, (int32_t*)adj, (int32_t*)f_ids,
             (int32_t*)f_frm, (float*)f_dist, E, M},
            (uint8_t*)scoreable, (const float*)rows, stride, kq0, n, cmax,
            (int32_t*)out_i, (float*)out_f};
        err = launch(p, ctas, st);
    }
    if (current != device) cudaSetDevice(current);
    return (int)err;
}

extern "C" const char* dc_stream_block_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
