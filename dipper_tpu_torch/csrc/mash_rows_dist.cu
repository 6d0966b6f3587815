// Mash sketch distances of query rows against a bank, on Hopper (sm_90a).
//
// Replaces the TPU kernel dipper_tpu/distance/mash_pallas.py::
// mash_rows_vs_bank_pallas: the merge-count kernel's intersection counts
// put through the [s+1] distance table. Contract: bank ranks int32 [N, M]
// (the already-placed side "A", rows ascending), query ranks int32 [Q, M]
// (the new taxon "B"), M >= s; table T [s+1] (the host's
// distance/mash.py::_dist_table, T = float or double); out T [Q, N] with
// row stride ldo >= N, out[q, n] = table[inter(bank n, query q)]. Equal
// counts index the same table entry, so the result is bitwise equal to
// the plain version, inter_to_dist(merged_inter_count_ref(...)).
//
// Design: mash_merge_count.cu's layout (one thread per pair running the
// shared serial walk of mash_walk.cuh, 256 bank rows per block, up to 8
// query rows staged in shared memory), plus the table, staged once per
// block in shared memory in front of the query rows (4 KB in f32, 8 KB
// in f64 at s = 1000). The distance is written straight into the output,
// so the int32 count never reaches device memory and no second gather
// pass runs. The row stride lets a caller fill a block of rows of a
// larger [N, N] matrix in place.
//
// What bounds it: as for mash_merge_count.cu, the uncoalesced bank-row
// reads (one row per lane) and the walk's divergent integer branches; the
// table lookup is one shared-memory read per pair.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mash_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQueriesPerBlock = 8;
// static shared-memory limit: no cudaFuncSetAttribute needed below it
constexpr int kSmemBytes = 48 * 1024;
// launcher return code for an s whose table and one query row do not fit
// kSmemBytes (not a cudaError_t value)
constexpr int kSketchTooLarge = -1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_dist_kernel(const int32_t* __restrict__ bank,
                 const int32_t* __restrict__ query,
                 const T* __restrict__ table,
                 T* __restrict__ out,
                 int n_bank, int n_query, int m, int s, int qb,
                 long long ldo)
{
    // [s+1] table, then [qb, s] ranks of the current query group; the
    // table comes first so that it keeps T's alignment
    extern __shared__ __align__(16) unsigned char smem[];
    T* st = reinterpret_cast<T*>(smem);
    int32_t* sq = reinterpret_cast<int32_t*>(smem + sizeof(T) * (s + 1));
    for (int t = threadIdx.x; t <= s; t += kThreads) st[t] = table[t];
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
        __syncthreads();  // sq (and, the first time, st) are complete
        if (n >= n_bank) continue;
        const int32_t* a = bank + (size_t)n * m;
        for (int r = 0; r < nq; ++r)
            out[(size_t)(q0 + r) * ldo + n] = st[mash_walk_inter(a, sq + r * s, s)];
    }
}

template <typename T>
int launch(const void* bank, const void* query, const void* table, void* out,
           int n_bank, int n_query, int m, int s, long long ldo,
           cudaStream_t stream)
{
    const int table_bytes = (int)sizeof(T) * (s + 1);
    int qb = (kSmemBytes - table_bytes) / (int)(sizeof(int32_t) * s);
    if (qb <= 0) return kSketchTooLarge;
    if (qb > kMaxQueriesPerBlock) qb = kMaxQueriesPerBlock;
    const int groups = (n_query + qb - 1) / qb;
    dim3 grid((n_bank + kThreads - 1) / kThreads,
              groups < 65535 ? groups : 65535);
    const size_t smem = table_bytes + sizeof(int32_t) * (size_t)qb * s;
    rows_dist_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const int32_t*)bank, (const int32_t*)query, (const T*)table, (T*)out,
        n_bank, n_query, m, s, qb, ldo);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (0 on success), or kSketchTooLarge when the [s+1] table and one query
// row's s ranks do not fit the static shared-memory budget (s > 6,143 in
// f32, s > 4,095 in f64). Pointers are device pointers: bank int32
// [n_bank, m] and query int32 [n_query, m], contiguous; table [s+1] and
// out [n_query, ldo] of float (is_f64 == 0) or double (is_f64 != 0).
extern "C" int mash_rows_dist(const void* bank, const void* query,
                              const void* table, void* out, int n_bank,
                              int n_query, int m, int s, long long ldo,
                              int is_f64, void* stream)
{
    if (s < 1 || s > m || n_bank < 1 || n_query < 1 || ldo < n_bank)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return is_f64 ? launch<double>(bank, query, table, out, n_bank, n_query,
                                   m, s, ldo, st)
                  : launch<float>(bank, query, table, out, n_bank, n_query,
                                  m, s, ldo, st);
}

extern "C" const char* mash_rows_dist_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
