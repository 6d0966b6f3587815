// Mash sketch intersection counts on Hopper (sm_90a).
//
// Replaces the TPU kernel dipper_tpu/distance/mash_pallas.py::
// _merge_count_kernel (body _merge_count_one, launcher mash_inter_pallas).
// Same contract: bank ranks int32 [N, M] (the already-placed side "A",
// rows ascending), query ranks int32 [Q, M] (the new taxon "B"), both
// padded to M >= S columns; out int32 [Q, N] = the reference merge-walk's
// `inter` (src/mash.cu:426-449, tests/oracle.py::mash_distance): every B
// element equal to an A element counts (asymmetric multiset rule), and
// the walk stops once `uni` (A elements plus unmatched B elements)
// reaches S. Only the first S columns of a row are ever read, so pad
// columns and non-pow2 S need no special case.
//
// Design. The TPU kernel restates the walk as a bitonic network plus two
// scans because the TPU's vector unit has no cheap data-dependent control.
// A CUDA thread does: each thread runs the serial two-pointer walk for one
// (query, bank row) pair, O(2S) steps against the network's O(M log M),
// with the tie rule "B before A on equal value" (mash_walk.cuh, shared
// with mash_rows_dist.cu). A block of 256 threads
// covers 256 consecutive bank rows for a group of up to 8 queries, whose
// first S ranks are staged in shared memory (8 x 1000 x 4 B = 32 KB at
// S = 1000); each thread walks its bank row from global memory through
// L1/L2. Output stores are coalesced (consecutive threads, consecutive
// bank rows).
//
// What bounds it: the bank-row reads are uncoalesced (the 32 threads of a
// warp read 32 different rows, one 32-byte sector each per 8 steps), the
// row is re-read once per query of the group, and the walk is branchy
// integer work whose trip count differs per lane. A later version could
// give each pair a warp and split the walk by merge-path partitioning
// (coalesced reads, no divergence), or walk a transposed [M, N] bank so
// that a warp's reads coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mash_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQueriesPerBlock = 8;
// static shared-memory limit: no cudaFuncSetAttribute needed below it
constexpr int kSmemBytes = 48 * 1024;
// launcher return code for s > kSmemBytes / 4 (not a cudaError_t value)
constexpr int kSketchTooLarge = -1;

__global__ void __launch_bounds__(kThreads)
merge_count_kernel(const int32_t* __restrict__ bank,
                   const int32_t* __restrict__ query,
                   int32_t* __restrict__ out,
                   int n_bank, int n_query, int m, int s, int qb)
{
    extern __shared__ int32_t sq[];  // [qb, s] ranks of this query group
    const int n = blockIdx.x * kThreads + threadIdx.x;
    const int groups = (n_query + qb - 1) / qb;
    for (int g = blockIdx.y; g < groups; g += gridDim.y) {
        const int q0 = g * qb;
        const int nq = min(qb, n_query - q0);
        __syncthreads();  // the previous group's walks are done with sq
        for (int t = threadIdx.x; t < nq * s; t += kThreads) {
            const int r = t / s;
            sq[t] = query[(size_t)(q0 + r) * m + (t - r * s)];
        }
        __syncthreads();
        if (n >= n_bank) continue;
        const int32_t* a = bank + (size_t)n * m;
        for (int r = 0; r < nq; ++r)
            out[(size_t)(q0 + r) * n_bank + n] = mash_walk_inter(a, sq + r * s, s);
    }
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (0 on success), or kSketchTooLarge when one query row's s ranks do not
// fit the static shared-memory budget (s > 12,288). Pointers are device
// pointers to contiguous int32 arrays: bank [n_bank, m], query
// [n_query, m], out [n_query, n_bank].
extern "C" int mash_merge_count(const void* bank, const void* query,
                                void* out, int n_bank, int n_query, int m,
                                int s, void* stream)
{
    if (s < 1 || s > m || n_bank < 1 || n_query < 1)
        return (int)cudaErrorInvalidValue;
    int qb = kSmemBytes / (int)(sizeof(int32_t) * s);
    if (qb == 0) return kSketchTooLarge;
    if (qb > kMaxQueriesPerBlock) qb = kMaxQueriesPerBlock;
    const int groups = (n_query + qb - 1) / qb;
    dim3 grid((n_bank + kThreads - 1) / kThreads,
              groups < 65535 ? groups : 65535);
    const size_t smem = sizeof(int32_t) * (size_t)qb * s;
    merge_count_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)bank, (const int32_t*)query, (int32_t*)out,
        n_bank, n_query, m, s, qb);
    return (int)cudaGetLastError();
}

extern "C" const char* mash_merge_count_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
