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
// mem int32 [c, n_mem] (rows ld_mem apart), out int32 [c, n_mem, n_wit].
// The TPU version stacks g = 8 clusters, runs the merge kernel on the whole
// [g*cmax, g*W] block and keeps the diagonal blocks: g times the pairs it
// needs, and the gathered rows written to memory first.
//
// What bounds it on this card: integer operations, as kernels 1 and 2 (a
// pair takes s + inter steps of about 4 operations); the bytes (each
// picked row once, the counts once) are two orders of magnitude below.
//
// What the design does about it. One launch for the whole bucket, and no
// pair outside a cluster's own block is walked. The walk is mash_walk.cuh's
// pair_inter for both paths: a warp per pair, the walk split over the lanes
// by merge path, the exact stop. The rows come straight from the rank bank
// through the index lists, so ranks[wit] and ranks[mem] are never
// materialised. Two paths, chosen by the member count:
//
//  - Narrow clusters (n_mem <= kNarrowMaxMembers, and a cluster's rows fit
//    one block's shared memory): D&C's common case, a p50 of 8-9 members
//    at 30K and 100K taxa. A block holds one cluster's rows whole, each
//    distinct row staged once: D&C's witness list ends with the member list
//    (dc/pipeline.py builds wit = [head, mem]), and when the caller passes
//    mem as that tail of wit (a view, ld_mem == n_wit) the member rows are
//    read from the witness slab (18 rows at 8 members, 26 at 16, 42 at 32,
//    ~4 KB each at s = 1000). A row arrives by one bulk asynchronous copy
//    (cp.async.bulk, completion counted in bytes on an mbarrier; the rank
//    bank is 16-byte aligned when m is a multiple of 4), then every pair of
//    the cluster is walked in one pass with no further barrier. Blocks are
//    sized to the work by the occupancy calculator: as many as a
//    multiprocessor's shared memory holds (three at 8 members, two at 16,
//    one at 32) with the warps that keep the most of them resident, so one
//    block's copies overlap the other blocks' walks. Where the clusters are
//    too few to give every multiprocessor its blocks, a cluster's pairs are
//    spread over several blocks (gridDim.y), each staging the cluster's
//    rows.
//  - Wide clusters (more members, or rows that do not fit): a block of
//    1,024 threads takes (cluster, member tile, run of witness tiles),
//    stages its member tile and, double buffered, the witness tiles
//    (stage_rows_gathered's 16-byte cp.async); the tile is the largest
//    that fits shared memory, cut to the member count where that is
//    smaller.
//
// The crossover, 32 members, from the wide path's times on an H100
// (chip_smoke.py phase 15 and scripts/profile_dc_torch.py): it reached
// 19-22% of its bound on buckets of 64 members and more but 15% at 8
// members, 19% at 16 and 20% at 32, where its tiles shrink to the member
// count and one 1,024-thread block a multiprocessor stages them in two or
// three rounds with nothing to overlap them. D&C's buckets are powers
// of two, and at s = 1000 the next one, 64 members, does not fit a block
// with its 10 head witnesses (74 rows), while its tiles are full.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "mash_walk.cuh"

namespace {

using namespace mash;

// the narrow path's largest member count (see the crossover above)
constexpr int kNarrowMaxMembers = 32;
// bytes before the narrow block's rows: its mbarrier, padded to 16
constexpr size_t kBarrierBytes = 16;

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity)
{
    unsigned done = 0;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory to 16-byte
// aligned shared memory; completion is counted on the mbarrier at `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(
            (unsigned)__cvta_generic_to_shared(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// The narrow path: block (c, y) stages cluster c's rows whole, witnesses
// first, then the members unless they are the witnesses' tail
// (mem_row0 = n_wit - n_mem) or after them (mem_row0 = n_wit), and walks
// pairs y*nw + warp, stepping nw * gridDim.y (nw warps a block).
__global__ void __launch_bounds__(kThreads, 1)
cluster_rows_kernel(const int32_t* __restrict__ ranks,
                    const int32_t* __restrict__ wit,
                    const int32_t* __restrict__ mem,
                    int32_t* __restrict__ out, int n_wit, int n_mem,
                    int ld_mem, int m, int s, int sp, int nvec, int mem_row0)
{
    // [mbarrier] [rows: mem_row0 + n_mem of sp ints]
    extern __shared__ __align__(16) unsigned char smem[];
    int32_t* rows = reinterpret_cast<int32_t*>(smem + kBarrierBytes);
    const unsigned bar = (unsigned)__cvta_generic_to_shared(smem);
    const int n_rows = mem_row0 + n_mem;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const size_t cl = blockIdx.x;
    const int32_t* wit_c = wit + cl * n_wit;
    const int32_t* mem_c = mem + cl * ld_mem;
    int32_t* out_c = out + cl * n_mem * (size_t)n_wit;
    const auto row_of = [&](int r) -> const int32_t* {
        const int id = r < n_wit ? __ldg(wit_c + r) : __ldg(mem_c + r - n_wit);
        return ranks + (size_t)id * m;
    };

    if (nvec > 0) {
        if (threadIdx.x == 0) mbar_init(bar, 1);
        __syncthreads();  // the barrier, before any thread waits on it
        if (warp == 0) {
            // the expected bytes go first, so the count cannot complete
            // before the last copy lands
            const unsigned bytes = 16u * nvec;
            if (lane == 0) mbar_arrive_expect_tx(bar, bytes * n_rows);
            __syncwarp();
            for (int r = lane; r < n_rows; r += 32)
                bulk_copy(rows + (size_t)r * sp, row_of(r), bytes, bar);
        }
    }
    // what the bulk copies leave: ranks past the last 16-byte piece, and
    // kExhausted at index s
    const int tail0 = 4 * nvec, ntail = s - tail0;
    for (int i = threadIdx.x; i < n_rows * ntail; i += blockDim.x) {
        const int r = i / ntail, c = tail0 + (i - r * ntail);
        rows[(size_t)r * sp + c] = __ldg(row_of(r) + c);
    }
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x)
        rows[(size_t)r * sp + s] = kExhausted;
    if (nvec > 0) mbar_wait(bar, 0);
    __syncthreads();

    const int pairs = n_mem * n_wit;
    for (int p = blockIdx.y * nw + warp; p < pairs; p += nw * gridDim.y) {
        const int q = p / n_wit, w = p - q * n_wit;
        const int r = pair_inter(rows + (size_t)w * sp,
                                 rows + (size_t)(mem_row0 + q) * sp, s, lane);
        if (lane == 0) out_c[p] = r;
    }
}

// The wide path: block (cluster, member tile, run of witness tiles), as
// described at the head of the file.
__global__ void __launch_bounds__(kThreads, 1)
cluster_kernel(const int32_t* __restrict__ ranks,
               const int32_t* __restrict__ wit, const int32_t* __restrict__ mem,
               int32_t* __restrict__ out, int n_wit, int n_mem, int ld_mem,
               int m, int s, int sp, int lt, int tiles_per_block, int nvec)
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
    const int32_t* mem_c = mem + cl * ld_mem;
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

// What a launch asks of the host once per device, not per launch: the
// multiprocessor count, the largest dynamic shared memory already granted
// to each kernel, and the narrow path's last block shape.
struct DeviceCache {
    int nsm = 0;
    size_t smem_granted[2] = {0, 0};  // cluster_rows_kernel, cluster_kernel
    size_t shape_smem = 0;            // the narrow shape below is for this
    int shape_blocks = 0, shape_warps = 0;
};
constexpr int kMaxDevices = 64;
DeviceCache g_cache[kMaxDevices];
std::mutex g_cache_mutex;

// Grants `kernel` (index `which` of smem_granted) `smem` bytes of dynamic
// shared memory on this device, unless a launch already did.
cudaError_t grant_smem(DeviceCache& dc, int which, const void* kernel,
                       size_t smem)
{
    if (smem <= dc.smem_granted[which]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) dc.smem_granted[which] = smem;
    return err;
}

// The narrow path's block shape for `smem` bytes a block: the warps a
// block (at most 32) that keep the most warps resident on a
// multiprocessor, as the occupancy calculator counts its shared memory and
// registers, and the blocks that are then resident on one.
cudaError_t narrow_shape(DeviceCache& dc, size_t smem, int* blocks,
                         int* warps)
{
    if (dc.shape_smem != smem) {
        int best_w = 1, best_fit = 0;
        for (int w = 1; w <= 32; ++w) {
            int fit = 0;
            const cudaError_t err =
                cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &fit, cluster_rows_kernel, 32 * w, smem);
            if (err != cudaSuccess) return err;
            if (fit * w >= best_fit * best_w) {
                best_w = w;
                best_fit = fit;
            }
        }
        if (best_fit < 1) return cudaErrorInvalidConfiguration;
        dc.shape_smem = smem;
        dc.shape_blocks = best_fit;
        dc.shape_warps = best_w;
    }
    *blocks = dc.shape_blocks;
    *warps = dc.shape_warps;
    return cudaSuccess;
}

}  // namespace

// Launches on `stream` without synchronizing; returns a cudaError_t value
// (0 on success), or mash::kSketchTooLarge (-1) when one member row and
// two witness rows do not fit the block's shared memory. Device pointers
// to int32 arrays: ranks [n_rows, m] (rows ascending), wit [n_clusters,
// n_wit] contiguous, mem [n_clusters, n_mem] with rows ld_mem apart (every
// index in [0, n_rows)), out [n_clusters, n_mem, n_wit] contiguous. mem may
// point into wit: mem == wit + n_wit - n_mem with ld_mem == n_wit says that
// each cluster's members are the tail of its witness list, and the narrow
// path then stages those rows once.
extern "C" int mash_cluster_inter(const void* ranks, const void* wit,
                                  const void* mem, void* out, int n_rows,
                                  int n_clusters, int n_wit, int n_mem,
                                  int ld_mem, int m, int s, void* stream)
{
    using namespace mash;
    if (s < 1 || s > m || n_rows < 1 || n_clusters < 1 || n_wit < 1
        || n_mem < 1 || (n_clusters > 1 && ld_mem < n_mem))
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(g_cache_mutex);
    DeviceCache& dc = g_cache[dev];
    if (dc.nsm == 0) {
        err = cudaDeviceGetAttribute(&dc.nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
    }
    const size_t sp = ((size_t)s + 1 + 3) & ~(size_t)3;
    const bool aligned = m % 4 == 0 && (uintptr_t)ranks % 16 == 0;
    const int nvec = aligned ? s / 4 : 0;
    const int32_t* wit_i = (const int32_t*)wit;
    const int32_t* mem_i = (const int32_t*)mem;
    const bool members_in_wit = n_mem <= n_wit
                                && mem_i == wit_i + (n_wit - n_mem)
                                && (n_clusters == 1 || ld_mem == n_wit);
    const int mem_row0 = members_in_wit ? n_wit - n_mem : n_wit;
    const size_t narrow_smem =
        kBarrierBytes + (size_t)(mem_row0 + n_mem) * sp * sizeof(int32_t);

    if (n_mem <= kNarrowMaxMembers && narrow_smem <= (size_t)kSmemBudget) {
        // the grant first: the occupancy calculator counts only the
        // shared memory a kernel may have
        int bps = 0, nw = 0;
        err = grant_smem(dc, 0, (const void*)cluster_rows_kernel,
                         narrow_smem);
        if (err == cudaSuccess) err = narrow_shape(dc, narrow_smem, &bps, &nw);
        if (err != cudaSuccess) return (int)err;
        // spread a cluster's pairs over gridDim.y only while the clusters
        // leave multiprocessors without their blocks
        const long long pairs = (long long)n_mem * n_wit;
        long long split = ((long long)bps * dc.nsm + n_clusters - 1)
                          / n_clusters;
        split = split < 1 ? 1 : (split > pairs ? pairs : split);
        if (split > 65535) split = 65535;
        const long long per_block = (pairs + split - 1) / split;
        if (per_block < nw) {
            nw = (int)per_block;
            split = (pairs + nw - 1) / nw;  // no block without a pair
        }
        dim3 grid((unsigned)n_clusters, (unsigned)split);
        cluster_rows_kernel<<<grid, 32 * nw, narrow_smem,
                              (cudaStream_t)stream>>>(
            (const int32_t*)ranks, wit_i, mem_i, (int32_t*)out, n_wit, n_mem,
            ld_mem, m, s, (int)sp, nvec, mem_row0);
        return (int)cudaGetLastError();
    }

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
    const size_t smem = smem_of(lt);
    err = grant_smem(dc, 1, (const void*)cluster_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int tile = 1 << lt;
    const int qtiles = (n_mem + tile - 1) / tile;
    const int wtiles = (n_wit + tile - 1) / tile;
    if (qtiles > 65535) return (int)cudaErrorInvalidValue;
    // split a cluster's witness tiles over gridDim.z only while the
    // clusters and member tiles leave the card short of kBlocksPerSm
    // blocks a multiprocessor
    const long long base = (long long)n_clusters * qtiles;
    long long split = (kBlocksPerSm * (long long)dc.nsm + base - 1) / base;
    split = split < 1 ? 1 : (split > wtiles ? wtiles : split);
    if (split > 65535) split = 65535;
    const int tiles_per_block = (int)((wtiles + split - 1) / split);
    split = (wtiles + tiles_per_block - 1) / tiles_per_block;
    dim3 grid((unsigned)n_clusters, (unsigned)qtiles, (unsigned)split);
    cluster_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ranks, wit_i, mem_i, (int32_t*)out, n_wit, n_mem,
        ld_mem, m, s, (int)sp, lt, tiles_per_block, nvec);
    return (int)cudaGetLastError();
}

extern "C" const char* mash_cluster_inter_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
