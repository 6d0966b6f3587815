// NJ's selection on Hopper (sm_90a): the first minimum of
// Q[i, j] = (D[i, j] - U[i]/(n-2)) - U[j]/(n-2) over rows [r0, r1) of the
// active [n, n] block of D, with the diagonal at the type's largest
// finite value, in one launch that reads D once and writes no Q.
//
// Replaces the Q pass and argmin of the JAX package's merge step
// (dipper_tpu/nj/engine.py::_one_merge_step, an XLA program inside
// _run_bucket's fori_loop; no Pallas). The port's plain version is
// nj/engine.py::_q_rows + torch.argmin, which writes Q, rereads it to
// fill the diagonal and reads it again for the argmin.
//
// - A block scans a tile of rows and kTileCols columns: thread t holds the
//   columns c0 + t + k * kThreads (k < kCols), so a warp's loads of a row
//   are coalesced, and their U/(n-2) in registers; the rows' U/(n-2) are
//   staged in shared memory, kThreads rows at a time. U/(n-2) is a true
//   IEEE division (div_rn), as the plain version's division by a 0-d
//   tensor, computed once a block for each row and column it touches.
// - A thread meets its elements in increasing flat order, so it keeps the
//   first of its minima with a strict compare (a NaN replaces a number,
//   never another NaN). The block's candidates then meet in torch.argmin's
//   order (nj_step.cuh::before: NaN first, then the value, -0.0 == +0.0,
//   then the flat index); that order is total, so the result is
//   torch.argmin's whatever the tiles.
// - Stage 2: each block writes its candidate to the partials; the last
//   block to take a ticket (atomicAdd after __threadfence) reduces them,
//   writes the flat index i * n + j (int64) and, for a rank's share of a
//   sharded scan, the pair (value, flat) as two doubles, and resets the
//   ticket. No rows ([r0, r0)) give the pair (inf, 2^62), which every
//   real candidate beats.
// - Q has no product, and its two subtractions are sub_rn: no FMA.
//
// What bounds it: memory. A launch reads (r1 - r0) x n values of D once
// (1.6 GB at n = 20,000 in f32: 0.478 ms at 3.35 TB/s) and O(n) more;
// about eight instructions an element keep the arithmetic far below.
// Later: wide loads, a persistent grid, half of the symmetric D (both
// roundings of Q evaluated from one load).
//
// Inputs: D T [*, ld] (rows 0..n-1 of the active block, columns 0..n-1),
// U T [n]; 0 <= r0 <= r1 <= n. T = float or double.
// Scratch: part_v T [kMaxPartials], part_i int64 [kMaxPartials], ticket
// uint32 [1] (zero before the first launch). Launches that share scratch
// must be ordered on one stream.
// Outputs: out_flat int64 [1]; out_pair double [2] if not null.

#include "nj_step.cuh"

#include <math.h>

namespace {

using namespace nj;

constexpr int kCols = 4;                       // columns a thread holds
constexpr int kTileCols = kThreads * kCols;    // columns a block scans
constexpr int kMaxPartials = 4096;             // blocks a launch may have
constexpr long long kMinTileElems = 16384;     // elements a block scans
constexpr long long kNoRows = 1LL << 62;       // the empty share's index

template <typename T>
__global__ void __launch_bounds__(kThreads)
q_argmin_kernel(const T* __restrict__ D, long long ld,
                const T* __restrict__ U, int n, int r0, int r1,
                int tile_rows, T* part_v, long long* part_i,
                unsigned int* ticket, long long* out_flat, double* out_pair)
{
    __shared__ T s_un[kThreads];
    __shared__ Cand<T> s_part[kWarps];
    __shared__ int s_last;
    const T denom = T(n - 2);
    const T big = largest<T>();
    const int c0 = blockIdx.x * kTileCols;
    const int i0 = r0 + blockIdx.y * tile_rows;
    const int i1 = min(r1, i0 + tile_rows);

    int col[kCols];
    T unj[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
        col[k] = c0 + k * kThreads + threadIdx.x;
        unj[k] = col[k] < n ? div_rn(U[col[k]], denom) : T(0);
    }
    Cand<T> best{T(0), -1};
    for (int ic = i0; ic < i1; ic += kThreads) {
        const int rows = min(kThreads, i1 - ic);
        __syncthreads();
        if (threadIdx.x < rows) s_un[threadIdx.x] = div_rn(U[ic + threadIdx.x], denom);
        __syncthreads();
        for (int r = 0; r < rows; ++r) {
            const int i = ic + r;
            const T uni = s_un[r];
            const T* row = D + (long long)i * ld;
            T v[kCols];
#pragma unroll
            for (int k = 0; k < kCols; ++k)
                v[k] = col[k] < n ? __ldg(row + col[k]) : T(0);
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                if (col[k] >= n) continue;
                const T q = col[k] == i ? big : sub_rn(sub_rn(v[k], uni), unj[k]);
                // increasing flat order: only a strictly better value
                // replaces the first minimum held
                if (best.i < 0 || (q != q ? best.v == best.v : q < best.v)) {
                    best.v = q;
                    best.i = (long long)i * n + col[k];
                }
            }
        }
    }
    best = block_min(best, s_part);

    const int blocks = gridDim.x * gridDim.y;
    if (threadIdx.x == 0) {
        const int b = blockIdx.y * gridDim.x + blockIdx.x;
        part_v[b] = best.v;
        part_i[b] = best.i;
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == (unsigned int)(blocks - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    best = Cand<T>{T(0), -1};
    for (int p = threadIdx.x; p < blocks; p += kThreads) {
        const Cand<T> c{__ldcg(part_v + p), __ldcg(part_i + p)};
        if (before(c, best)) best = c;
    }
    best = block_min(best, s_part);
    if (threadIdx.x == 0) {
        if (best.i < 0) best = Cand<T>{T(INFINITY), kNoRows};
        *out_flat = best.i;
        if (out_pair != nullptr) {
            out_pair[0] = (double)best.v;
            out_pair[1] = (double)best.i;
        }
        *ticket = 0u;
    }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// The launch's grid: column tiles, row tiles and rows a tile (mirrored by
// dipper_tpu_torch/nj/step_model.py::q_plan). Enough rows a tile that a
// block scans kMinTileElems elements, few enough tiles that the grid fits
// the partials.
static int plan(int n, int rows, int* col_tiles, int* row_tiles,
                int* tile_rows)
{
    *col_tiles = (int)cdiv(n, kTileCols);
    if (*col_tiles > kMaxPartials) return -1;
    if (rows == 0) {
        *row_tiles = 1;
        *tile_rows = 0;
        return 0;
    }
    const long long min_rows = cdiv(kMinTileElems, n < kTileCols ? n : kTileCols);
    const long long by_grid = cdiv(rows, kMaxPartials / *col_tiles);
    *tile_rows = (int)(by_grid > min_rows ? by_grid : min_rows);
    *row_tiles = (int)cdiv(rows, *tile_rows);
    return 0;
}

extern "C" int nj_q_argmin(const void* D, long long ld, const void* U, int n,
                           int r0, int r1, void* part_v, void* part_i,
                           void* ticket, void* out_flat, void* out_pair,
                           int is_f64, int device, void* stream)
{
    if (n < 3 || ld < n || r0 < 0 || r0 > r1 || r1 > n)
        return (int)cudaErrorInvalidValue;
    int col_tiles, row_tiles, tile_rows;
    if (plan(n, r1 - r0, &col_tiles, &row_tiles, &tile_rows) != 0)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    const dim3 grid(col_tiles, row_tiles);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        q_argmin_kernel<double><<<grid, kThreads, 0, s>>>(
            (const double*)D, ld, (const double*)U, n, r0, r1, tile_rows,
            (double*)part_v, (long long*)part_i, (unsigned int*)ticket,
            (long long*)out_flat, (double*)out_pair);
    else
        q_argmin_kernel<float><<<grid, kThreads, 0, s>>>(
            (const float*)D, ld, (const float*)U, n, r0, r1, tile_rows,
            (float*)part_v, (long long*)part_i, (unsigned int*)ticket,
            (long long*)out_flat, (double*)out_pair);
    return (int)cudaGetLastError();
}

extern "C" const char* nj_q_argmin_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
