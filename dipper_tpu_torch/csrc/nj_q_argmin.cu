// NJ's selection on Hopper (sm_90a): the first minimum of
// Q[i, j] = (D[i, j] - U[i]/(n-2)) - U[j]/(n-2) over the active [n, n]
// block of D, with the diagonal at the type's largest finite value, in one
// launch that reads D once and writes no Q.
//
// Replaces the Q pass and argmin of the JAX package's merge step
// (dipper_tpu/nj/engine.py::_one_merge_step, an XLA program inside
// _run_bucket's fori_loop; no Pallas). The port's plain version is
// nj/engine.py::_q_rows + torch.argmin, which writes Q, rereads it to
// fill the diagonal and reads it again for the argmin.
//
// Two modes, one source:
// - the half read (every single-process NJ whose working copy is
//   symmetric bit for bit, nj/engine.py::_read_mode): only the upper
//   triangle and the diagonal are read. Each D[i, j] with j > i gives two
//   candidates, Q[i, j] = (v - Un[i]) - Un[j] at i * n + j and
//   Q[j, i] = (v - Un[j]) - Un[i] at j * n + i (Q's rounding is not
//   symmetric, so the two are kept apart); D[i, i] gives one, the largest
//   finite value at i * n + i. Elements with j < i are not read.
// - the full read over rows [r0, r1) (a matrix that is not symmetric, and a
//   rank's share of the sharded route, whose merge of the ranks' pairs
//   breaks ties by rank order): every element of those rows, one
//   candidate each, and the pair (value, flat) for the ranks' merge.
// Both take the same tiles, loads and grid:
// - Tiles of kTile columns (32 lanes x one 16-byte load: 128 f32, 64
//   f64) and kTile >> shift rows: a lane holds kV neighbouring columns,
//   read with one float4 or double2 load a row (a warp reads 512
//   contiguous bytes); the 8 warps take every 8th row; kUnroll rows' loads
//   are in flight before any is used. Tiles are square (shift 0) unless
//   that leaves fewer tiles than resident blocks (small n), then up to 8
//   times shorter. Rows start at i * ld, ld a multiple of kV and D 16-byte aligned
//   (the working copy's leading dimension is padded to 32 elements,
//   nj/engine.py::_State), so every load is aligned.
// - A persistent grid: as many blocks as the card holds at once (the
//   occupancy query x the SMs, at most kMaxPartials and at most the
//   tiles), each walking the tiles t = blockIdx.x, + gridDim.x, ... The
//   half read numbers its tiles band by band (band b holds the chunks
//   b >> shift .. C-1 of columns), so a block finds its tile by a binary
//   search over the bands' first tiles. Mirrored by
//   nj/step_model.py::q_plan.
// - U/(n-2) is a true IEEE division (div_rn), as the plain version's
//   division by a 0-d tensor: each tile's rows and columns are divided
//   once by the block into shared memory.
// - Within a tile a thread meets Q[i, j] in increasing flat order (rows
//   increase, then columns), and each of its columns' mirrored Q[j, i] in
//   increasing flat order too, so it keeps a running first minimum of each
//   (one, and kV mirrored ones) with a strict compare and no index
//   compare: a NaN replaces a number and never another NaN. A running
//   minimum starts at +inf with no index, so a +inf candidate never
//   enters it; that loses nothing, since every launch over a row holds
//   that row's diagonal candidate, the largest finite value, which comes
//   before +inf. At the tile's end the minima are merged into the
//   thread's candidate in torch.argmin's order (nj_step.cuh::before: NaN
//   first, then the value, -0.0 == +0.0, then the flat index). That order
//   is total, so the result is the full scan's, and torch.argmin's,
//   whatever the tiles and the grid.
// - Stage 2: each block writes its candidate to the partials; the last
//   block to take a ticket (atomicAdd after __threadfence) reduces the
//   gridDim.x partials, writes the flat index i * n + j (int64) and, for a
//   share of the rows, the pair (value, flat) as two doubles, and resets
//   the ticket. No rows ([r0, r0)) give the pair (inf, 2^62), which every
//   real candidate beats.
// - Q has no product, and its subtractions are sub_rn: no FMA.
// - Launched with programmatic dependent launch (nj_step.cuh::launch;
//   what it saves a merge step is in PERF.md): the blocks wait for the
//   previous kernel (the last step's nj_update) before their first read,
//   and let the next launch (this step's nj_update) be placed at once.
//
// What bounds it: memory. The half read moves n (n + 1) / 2 values of D
// (800 MB at n = 20,000 in f32: 0.239 ms at 3.35 TB/s), the full read
// (r1 - r0) x n; O(n) more. Two Q values and their compares an element
// are ~12 instructions, ~0.08 ms of issue at 20,000: below the bytes.
//
// Inputs: D T [*, ld] (rows 0..n-1 of the active block, columns 0..n-1),
// U T [n]; 0 <= r0 <= r1 <= n, the half read over all n rows. T = float
// or double.
// Scratch: part_v T [kMaxPartials], part_i int64 [kMaxPartials], ticket
// uint32 [1] (zero before the first launch). Launches that share scratch
// must be ordered on one stream.
// Outputs: out_flat int64 [1]; out_pair double [2] if not null.

#include "nj_step.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using namespace nj;

constexpr int kMaxPartials = 2048;         // blocks a launch may have
constexpr int kUnroll = 4;                 // rows a warp has in flight
constexpr int kBlocksPerSm = 4;            // the register budget's aim
constexpr int kMaxShift = 3;               // tiles of kTile / 8 rows at least
constexpr long long kNoRows = 1LL << 62;   // the empty share's index

// One 16-byte load of kN neighbouring elements.
template <typename T> struct Wide;
template <> struct Wide<float> {
    static constexpr int kN = 4;
    static __device__ __forceinline__ void load(const float* p, float (&e)[4])
    {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        e[0] = v.x;
        e[1] = v.y;
        e[2] = v.z;
        e[3] = v.w;
    }
};
template <> struct Wide<double> {
    static constexpr int kN = 2;
    static __device__ __forceinline__ void load(const double* p, double (&e)[2])
    {
        const double2 v = __ldg(reinterpret_cast<const double2*>(p));
        e[0] = v.x;
        e[1] = v.y;
    }
};

// A launch's tiles (mirrored by nj/step_model.py::q_plan)
struct Plan {
    int tile;          // columns of a tile: kWarp x Wide<T>::kN
    int shift;         // a tile's rows: tile >> shift
    int chunks;        // tiles across the n columns
    int bands;         // tiles down the rows scanned
    long long tiles;   // tiles of the launch
    int grid;          // blocks
};

// The first tile of band b in the half read: band b' holds the chunks
// from b' >> shift (the one that holds its first diagonal element) to
// chunks - 1.
__host__ __device__ __forceinline__ long long band_start(int b, int chunks,
                                                         int shift)
{
    const long long m = 1LL << shift, q = b >> shift, r = b & (m - 1);
    return (long long)b * chunks - (m * q * (q - 1) / 2 + r * q);
}

template <bool kHalf>
__device__ __forceinline__ void locate(long long t, const Plan& p, int& band,
                                       int& chunk)
{
    if (!kHalf) {
        band = (int)(t / p.chunks);
        chunk = (int)(t - (long long)band * p.chunks);
        return;
    }
    int lo = 0, hi = p.bands - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (band_start(mid, p.chunks, p.shift) <= t) lo = mid;
        else hi = mid - 1;
    }
    band = lo;
    chunk = (lo >> p.shift) + (int)(t - band_start(lo, p.chunks, p.shift));
}

// One thread's share of a tile: rows i0 + warp, + kWarps, ... below i1 at
// its columns j0..j0+kV-1; its first minima merged into `best`. kEdge: the
// tile holds the diagonal or columns past n, so each element is checked.
template <typename T, bool kHalf, bool kEdge>
__device__ __forceinline__ void scan(const T* __restrict__ D, long long ld,
                                     int n, int i0, int i1, int j0,
                                     const T* s_row, const T (&unj)[Wide<T>::kN],
                                     int warp, Cand<T>& best)
{
    constexpr int kV = Wide<T>::kN;
    const T big = largest<T>();
    T up_v = T(INFINITY);      // Q[i, j]: value, and i * kV + k (-1: none)
    int up_at = -1;
    T mi_v[kV];                // Q[j0 + k, i]: value, and i (-1: none)
    int mi_i[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
        mi_v[k] = T(INFINITY);
        mi_i[k] = -1;
    }
    for (int ib = i0 + warp; ib < i1; ib += kWarps * kUnroll) {
        T e[kUnroll][kV];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int i = ib + u * kWarps;
            const bool ok = i < i1
                && (!kEdge || (j0 < n && (!kHalf || j0 + kV > i)));
            if (ok) {
                Wide<T>::load(D + (long long)i * ld + j0, e[u]);
            } else {
#pragma unroll
                for (int k = 0; k < kV; ++k) e[u][k] = T(0);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int i = ib + u * kWarps;
            if (i >= i1) break;
            const T uni = s_row[i - i0];
#pragma unroll
            for (int k = 0; k < kV; ++k) {
                const int j = j0 + k;
                if (kEdge && (j >= n || (kHalf && j < i))) continue;
                const bool diag = kEdge && j == i;
                const T q = diag ? big : sub_rn(sub_rn(e[u][k], uni), unj[k]);
                if (!(q >= up_v) && up_v == up_v) {
                    up_v = q;
                    up_at = i * kV + k;
                }
                if (kHalf && !diag) {
                    const T m = sub_rn(sub_rn(e[u][k], unj[k]), uni);
                    if (!(m >= mi_v[k]) && mi_v[k] == mi_v[k]) {
                        mi_v[k] = m;
                        mi_i[k] = i;
                    }
                }
            }
        }
    }
    if (up_at >= 0) {
        const Cand<T> c{up_v, (long long)(up_at / kV) * n + j0 + up_at % kV};
        if (before(c, best)) best = c;
    }
    if (kHalf) {
#pragma unroll
        for (int k = 0; k < kV; ++k) {
            if (mi_i[k] < 0) continue;
            const Cand<T> c{mi_v[k], (long long)(j0 + k) * n + mi_i[k]};
            if (before(c, best)) best = c;
        }
    }
}

template <typename T, bool kHalf>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
q_argmin_kernel(const T* __restrict__ D, long long ld,
                const T* __restrict__ U, int n, int r0, int r1, Plan p,
                T* part_v, long long* part_i, unsigned int* ticket,
                long long* out_flat, double* out_pair)
{
    constexpr int kV = Wide<T>::kN;
    constexpr int kTile = kWarp * kV;
    static_assert(2 * kTile <= kThreads, "a thread divides one U a tile");
    __shared__ T s_un[2 * kTile];   // U/(n-2) of the tile's rows, columns
    __shared__ Cand<T> s_part[kWarps];
    __shared__ int s_last;
    wait_prior_grid();
    release_next_grid();
    const T denom = T(n - 2);
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    const int rows = kTile >> p.shift;

    Cand<T> best{T(0), -1};
    for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int band, chunk;
        locate<kHalf>(t, p, band, chunk);
        const int i0 = r0 + band * rows;
        const int i1 = min(r1, i0 + rows);
        const int c0 = chunk * kTile;
        __syncthreads();  // the last tile's reads of s_un are done
        if (threadIdx.x < 2 * kTile) {
            const int k = threadIdx.x;
            const int idx = k < kTile ? i0 + k : c0 + k - kTile;
            s_un[k] = idx < n ? div_rn(U[idx], denom) : T(0);
        }
        __syncthreads();
        const int j0 = c0 + lane * kV;
        T unj[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) unj[k] = s_un[kTile + lane * kV + k];
        const bool off_diag = kHalf ? c0 >= i1 : (c0 >= i1 || c0 + kTile <= i0);
        if (off_diag && c0 + kTile <= n)
            scan<T, kHalf, false>(D, ld, n, i0, i1, j0, s_un, unj, warp, best);
        else
            scan<T, kHalf, true>(D, ld, n, i0, i1, j0, s_un, unj, warp, best);
    }
    best = block_min(best, s_part);

    if (threadIdx.x == 0) {
        part_v[blockIdx.x] = best.v;
        part_i[blockIdx.x] = best.i;
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    best = Cand<T>{T(0), -1};
    for (int q = threadIdx.x; q < (int)gridDim.x; q += kThreads) {
        const Cand<T> c{__ldcg(part_v + q), __ldcg(part_i + q)};
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

template <typename T, bool kHalf>
void* kernel_of() { return (void*)q_argmin_kernel<T, kHalf>; }

// Blocks of the kernel that the card holds at once (the occupancy query x
// the SMs), per device, type and mode; 0 on an error.
int resident_blocks(int device, int is_f64, int half)
{
    static int cache[64][2][2];
    if (device < 0 || device >= 64) return 0;
    int& got = cache[device][is_f64 != 0][half != 0];
    if (got > 0) return got;
    void* k = is_f64 ? (half ? kernel_of<double, true>() : kernel_of<double, false>())
                     : (half ? kernel_of<float, true>() : kernel_of<float, false>());
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0)
            != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
            != cudaSuccess)
        return 0;
    got = per_sm * sms;
    return got;
}

Plan make_plan(int n, int rows, int half, int is_f64, int resident)
{
    Plan p;
    p.tile = kWarp * (is_f64 ? Wide<double>::kN : Wide<float>::kN);
    p.chunks = (int)cdiv(n, p.tile);
    for (p.shift = 0;; ++p.shift) {
        const int tile_rows = p.tile >> p.shift;
        p.bands = (int)cdiv(half ? n : rows, tile_rows);
        p.tiles = half ? band_start(p.bands, p.chunks, p.shift)
                       : (long long)p.bands * p.chunks;
        if (p.tiles >= resident || p.shift == kMaxShift) break;
    }
    long long grid = resident < kMaxPartials ? resident : kMaxPartials;
    if (grid > p.tiles) grid = p.tiles;
    p.grid = (int)(grid > 0 ? grid : 1);
    return p;
}

}  // namespace

extern "C" int nj_q_argmin(const void* D, long long ld, const void* U, int n,
                           int r0, int r1, int half, void* part_v,
                           void* part_i, void* ticket, void* out_flat,
                           void* out_pair, int is_f64, int device,
                           void* stream)
{
    const int vec = is_f64 ? Wide<double>::kN : Wide<float>::kN;
    if (n < 3 || ld < n || ld % vec != 0 || (uintptr_t)D % 16 != 0
        || r0 < 0 || r0 > r1 || r1 > n || (half && (r0 != 0 || r1 != n)))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    const int resident = resident_blocks(device, is_f64, half);
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
    const Plan p = make_plan(n, r1 - r0, half, is_f64, resident);
    const dim3 grid(p.grid);
    cudaStream_t s = (cudaStream_t)stream;
    const double* Dd = (const double*)D;
    const float* Df = (const float*)D;
    cudaError_t err;
    if (is_f64 && half)
        err = launch(q_argmin_kernel<double, true>, grid, s, Dd, ld,
                     (const double*)U, n, r0, r1, p, (double*)part_v,
                     (long long*)part_i, (unsigned int*)ticket,
                     (long long*)out_flat, (double*)out_pair);
    else if (is_f64)
        err = launch(q_argmin_kernel<double, false>, grid, s, Dd, ld,
                     (const double*)U, n, r0, r1, p, (double*)part_v,
                     (long long*)part_i, (unsigned int*)ticket,
                     (long long*)out_flat, (double*)out_pair);
    else if (half)
        err = launch(q_argmin_kernel<float, true>, grid, s, Df, ld,
                     (const float*)U, n, r0, r1, p, (float*)part_v,
                     (long long*)part_i, (unsigned int*)ticket,
                     (long long*)out_flat, (double*)out_pair);
    else
        err = launch(q_argmin_kernel<float, false>, grid, s, Df, ld,
                     (const float*)U, n, r0, r1, p, (float*)part_v,
                     (long long*)part_i, (unsigned int*)ticket,
                     (long long*)out_flat, (double*)out_pair);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* nj_q_argmin_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
