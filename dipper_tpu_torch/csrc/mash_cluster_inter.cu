// Per-cluster Mash intersection counts on Hopper (sm_90a): the
// block-diagonal count of divide-and-conquer's phase 3.
//
// Replaces the TPU kernel dipper_tpu/dc/pipeline.py::_inter_blockdiag_pallas
// (a composition around mash_inter_pallas). For each cluster c of a size
// bucket, the counts of its members (queries, side "B") against its own
// witnesses (the already-placed bank side "A"), both picked from the rank
// bank by index lists:
//
//     out[c, q, w] = inter(bank ranks[wit[c, w]], query ranks[mem[c, q]])
//
// with the merge walk's rules of mash_walk.cuh (every equal B copy matches,
// stop once uni reaches s). ranks int32 [n_rows, m], wit int32 [c, n_wit],
// mem int32 [c, n_mem], out int32 [c, n_mem, n_wit]. The TPU version stacks
// g = 8 clusters, runs the merge kernel on the whole [g*cmax, g*W] block
// and keeps the diagonal blocks: g times the pairs it needs, and the
// gathered rows written to memory first.
//
// What bounds it on this card: integer operations, as kernels 1 and 2 (a
// pair takes s + inter steps of about 4 operations); the bytes (each
// picked row once, the counts once) are two orders of magnitude below.
//
// What the design does about it. One launch for the whole bucket, its grid
// over (cluster, member tile, run of witness tiles): no pair outside a
// cluster's own block is walked. A block stages its member tile and, double
// buffered, the cluster's witness tiles in shared memory, fetching each row
// through the index list inside the cp.async copy (stage_rows_gathered), so
// ranks[wit] and ranks[mem] are never materialised. The walk is
// mash_walk.cuh's: a warp per pair, the walk split over the lanes by merge
// path, the exact stop. The tile is the largest that fits shared memory,
// cut to the member count where that is smaller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mash_walk.cuh"

namespace {

using namespace mash;

__global__ void __launch_bounds__(kThreads, 1)
cluster_kernel(const int32_t* __restrict__ ranks,
               const int32_t* __restrict__ wit, const int32_t* __restrict__ mem,
               int32_t* __restrict__ out, int n_wit, int n_mem, int m, int s,
               int sp, int lt, int tiles_per_block, int nvec)
{
    // [member tile] [witness tile 0] [witness tile 1] [results]
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile = 1 << lt;
    int32_t* sq = reinterpret_cast<int32_t*>(smem);
    int32_t* sb = sq + (size_t)tile * sp;
    int32_t* sres = sb + (size_t)2 * tile * sp;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t cl = blockIdx.x;
    const int32_t* wit_c = wit + cl * n_wit;
    const int32_t* mem_c = mem + cl * n_mem;
    int32_t* out_c = out + cl * n_mem * (size_t)n_wit;
    const int q0 = blockIdx.y * tile;
    const int nq = min(tile, n_mem - q0);
    const int wtiles = (n_wit + tile - 1) >> lt;
    const int bt0 = blockIdx.z * tiles_per_block;
    const int bt1 = min(wtiles, bt0 + tiles_per_block);
    if (bt0 >= bt1) return;

    stage_rows_gathered(sq, ranks, mem_c + q0, nq, m, s, sp, nvec);
    stage_rows_gathered(sb, ranks, wit_c + (size_t)bt0 * tile,
                        min(tile, n_wit - bt0 * tile), m, s, sp, nvec);
    cp_async_commit();

    for (int bt = bt0; bt < bt1; ++bt) {
        const int w0 = bt << lt;
        const int nb = min(tile, n_wit - w0);
        const int32_t* cur = sb + (size_t)((bt - bt0) & 1) * tile * sp;
        if (bt + 1 < bt1) {
            // the other buffer's walks ended before the last barrier
            stage_rows_gathered(sb + (size_t)((bt + 1 - bt0) & 1) * tile * sp,
                                ranks, wit_c + w0 + tile,
                                min(tile, n_wit - w0 - tile), m, s, sp, nvec);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // this tile (and, the first time, the members)
        for (int p = warp; p < (nq << lt); p += kThreads / 32) {
            const int q = p >> lt, w = p & (tile - 1);
            if (w >= nb) continue;
            const int r = pair_inter(cur + (size_t)w * sp,
                                     sq + (size_t)q * sp, s, lane);
            if (lane == 0) sres[p] = r;
        }
        __syncthreads();  // results complete, `cur` free
        for (int p = threadIdx.x; p < (nq << lt); p += kThreads) {
            const int q = p >> lt, w = p & (tile - 1);
            if (w < nb) out_c[(size_t)(q0 + q) * n_wit + w0 + w] = sres[p];
        }
    }
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (0 on success), or mash::kSketchTooLarge (-1) when one row a side does
// not fit the block's shared memory. Device pointers to contiguous int32
// arrays: ranks [n_rows, m] (rows ascending), wit [n_clusters, n_wit], mem
// [n_clusters, n_mem] (every index in [0, n_rows)), out [n_clusters, n_mem,
// n_wit].
extern "C" int mash_cluster_inter(const void* ranks, const void* wit,
                                  const void* mem, void* out, int n_rows,
                                  int n_clusters, int n_wit, int n_mem, int m,
                                  int s, void* stream)
{
    using namespace mash;
    if (s < 1 || s > m || n_rows < 1 || n_clusters < 1 || n_wit < 1
        || n_mem < 1)
        return (int)cudaErrorInvalidValue;
    const size_t sp = ((size_t)s + 1 + 3) & ~(size_t)3;
    const auto smem_of = [&](int lt) {
        const size_t tile = (size_t)1 << lt;
        return 3 * tile * sp * sizeof(int32_t) + tile * tile * sizeof(int32_t);
    };
    int lt = kMaxLogTile;
    while (smem_of(lt) > (size_t)kSmemBudget) {
        if (lt == 0) return kSketchTooLarge;
        --lt;
    }
    // no wider than the members need: a tile row past n_mem is idle
    while (lt > 0 && (1 << (lt - 1)) >= n_mem) --lt;
    int dev = 0, nsm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = smem_of(lt);
    err = cudaFuncSetAttribute(cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int tile = 1 << lt;
    const int qtiles = (n_mem + tile - 1) / tile;
    const int wtiles = (n_wit + tile - 1) / tile;
    if (qtiles > 65535) return (int)cudaErrorInvalidValue;
    // split a cluster's witness tiles over gridDim.z only while the
    // clusters and member tiles leave the card short of kBlocksPerSm
    // blocks a multiprocessor
    const long long base = (long long)n_clusters * qtiles;
    long long split = (kBlocksPerSm * (long long)nsm + base - 1) / base;
    split = split < 1 ? 1 : (split > wtiles ? wtiles : split);
    if (split > 65535) split = 65535;
    const int tiles_per_block = (int)((wtiles + split - 1) / split);
    split = (wtiles + tiles_per_block - 1) / tiles_per_block;
    const bool aligned = m % 4 == 0 && (uintptr_t)ranks % 16 == 0;
    dim3 grid((unsigned)n_clusters, (unsigned)qtiles, (unsigned)split);
    cluster_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ranks, (const int32_t*)wit, (const int32_t*)mem,
        (int32_t*)out, n_wit, n_mem, m, s, (int)sp, lt, tiles_per_block,
        aligned ? s / 4 : 0);
    return (int)cudaGetLastError();
}

extern "C" const char* mash_cluster_inter_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
