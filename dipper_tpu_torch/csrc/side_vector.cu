// The k-closest scorer's side vector on Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/gather_micro.py::pallas_gather / pk, the
// [E, 5] witness gather dist_row[cid] of placement/kclosest.py::
// _side_vector. The TPU kernel is the gather alone; its one consumer then
// subtracts the witness distances, masks the empty slots and reduces over
// K. Here one thread per directed edge does all four steps, so the
// [E, 5] intermediate never reaches device memory:
//
//   side[e] = max(max_{j < K, cid[e, j] != -1} (row[cid[e, j]] - cdis[e, j]), 0)
//
// with -inf (then 0) for an edge whose K slots are all empty. It is
// bitwise equal to the plain version, torch.where(...).amax(-1).clamp(min=0)
// in placement/kclosest.py::_side_vector, NaN included (side_vector.cuh).
// The insertion loop's scorer runs the same side inside score_edges.cu;
// this entry point is the [E] vector on its own, for other consumers.
//
// Types: cid int32 [E, K] and cdis T [E, K], contiguous; row T [cap] with
// every cid < cap (witness ids are leaves already placed); side T [E];
// T = float or double.
//
// What bounds it: memory. Each edge reads 20 bytes of ids, 20 or 40 bytes
// of witness distances and 5 scattered row entries (the row, at most
// 240 KB, stays in L2), and writes one value. A warp stages its 32 edges'
// lists in shared memory with coalesced 16-byte reads (side_vector.cuh):
// read edge by edge at a 20-byte stride, each of a warp's loads would
// touch 640 bytes for 128 useful ones.

#include "side_vector.cuh"

namespace {

using namespace dipper;

template <typename T>
__global__ void __launch_bounds__(kThreads)
side_vector_kernel(const int32_t* __restrict__ cid,
                   const T* __restrict__ cdis,
                   const T* __restrict__ row,
                   T* __restrict__ side, int n_edges)
{
    __shared__ __align__(16) int32_t s_id[kWarps][kTile];
    __shared__ __align__(16) T s_dis[kWarps][kTile];
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    const int e0 = (blockIdx.x * kWarps + warp) * kWarp;
    if (e0 >= n_edges) return;
    stage_lists(cid, s_id[warp], e0, n_edges, lane);
    stage_lists(cdis, s_dis[warp], e0, n_edges, lane);
    const int e = e0 + lane;
    if (e < n_edges) side[e] = side_staged(s_id[warp], s_dis[warp], lane, row);
}

template <typename T>
int launch(const void* cid, const void* cdis, const void* row, void* side,
           int n_edges, cudaStream_t stream)
{
    const int blocks = (n_edges + kThreads - 1) / kThreads;
    side_vector_kernel<T><<<blocks, kThreads, 0, stream>>>(
        (const int32_t*)cid, (const T*)cdis, (const T*)row, (T*)side,
        n_edges);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (0 on success). Pointers are device pointers: cid int32 [n_edges, 5],
// cdis [n_edges, 5], row [cap] and side [n_edges] of float (is_f64 == 0)
// or double (is_f64 != 0).
extern "C" int side_vector(const void* cid, const void* cdis, const void* row,
                           void* side, int n_edges, int is_f64, void* stream)
{
    if (n_edges < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return is_f64 ? launch<double>(cid, cdis, row, side, n_edges, st)
                  : launch<float>(cid, cdis, row, side, n_edges, st);
}

extern "C" const char* side_vector_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
