// The k-closest insertion scorer on Hopper (sm_90a): the whole of
// placement/kclosest.py::score_edges (calculateBranchLength,
// src/placement_close_k.cu:309-358, and the first-minimum argmin, :807) in
// one launch.
//
// Replaces the TPU kernel scripts/gather_micro.py::pallas_gather / pk. On
// the TPU the [E, 5] witness gather stood alone, because nothing could be
// fused into it; its consumers (subtract, mask, max over K, the same vector
// reread through `rev`, some 25 elementwise passes over [E], an argmin and
// two index reads) were separate device programs. Here:
//
// - one thread scores one undirected edge: the slot s of its valid
//   direction (belong[s] > e[s]) computes dis1 = side(s) from its warp's
//   staged lists and dis2 = side(rev[s]) from the reverse edge's lists,
//   then the clamp sequence, so no [E] vector is written or reread. The
//   reverse edge's lists are two scattered runs of 20 (or 40) bytes, a
//   third of the list bytes; they go through ld.global.nc and hit L2;
// - slots at or above n_used need no thread: they are all invalid and score
//   (2.0, slot), so the one candidate (2.0, max(lo, n_used)) stands for
//   them;
// - the result is the lexicographic minimum of (score, slot), a NaN score
//   before every number, as torch.argmin gives it: warp shuffles, then the
//   block's warps through shared memory, one partial a block. The last
//   block to take a ticket (atomicAdd after __threadfence) reduces the
//   partials, writes the outputs and resets the ticket. A minimum over a
//   total order does not depend on the order of reduction, so the result is
//   deterministic;
// - the arithmetic is the plain version's, operation by operation, with
//   round-to-nearest intrinsics so that no multiply and add contract into
//   one FMA (which rounds once where the plain version rounds twice), and
//   with clamp and minimum that propagate NaN as torch's do.
//
// A launch scores the slots of one range [lo, hi) of [0, E) and returns
// global slot ids, so that ranks holding the same state can each score a
// range and merge their candidates in the same order (parallel/
// sharded.py); the full range [0, E) is the single-process scorer. The
// range's first unused slot, max(lo, n_used) if it is below hi, stands for
// all of its unused slots; in the range that holds n_used that is n_used.
//
// Inputs: cid int32 [E, 5], cdis T [E, 5], belong, e, rev int32 [E],
// length T [E], all contiguous; row T [cap] with every witness id < cap;
// n_used <= E slots in use (every slot at or above it has belong <= e);
// rev[s] in [0, E) for every valid slot; 0 <= lo < hi <= E. T = float or
// double.
// Outputs: out_i int32 [4] = eid, belong[eid], e[eid], rev[eid];
// out_f T [2] = frac[eid], score[eid].
// Scratch: scratch_i int32 [1 + scratch_blocks] (the ticket, zero before
// the first launch, then the partials' slots), scratch_f T
// [2 * scratch_blocks] (the partials' scores and fracs). Launches that
// share scratch must be ordered on one stream.
//
// score_edges_cursor takes n_used and the row from the cursor of an insert
// range (csrc/insert_step.cu: int64 [5] = insertion i, slots in use, the
// address of the range's first row, the rows' stride in elements, the
// range's first insertion), read on the card, so that one launch captured
// in a CUDA graph scores every insertion the graph is replayed for. Its
// grid is fixed by the slot range alone; the grid-stride loop covers any
// n_used with any grid.
//
// What bounds it: memory, and at the insertion loop's sizes latency: 56
// (f64: 96) bytes a used slot and the row, 6.8 MB at 120,000 slots in f32,
// all of it resident in L2 from one insertion to the next.

#include "side_vector.cuh"

#include <limits.h>

namespace {

using namespace dipper;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// torch.clamp(v, min=0): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp0(T v)
{
    return v != v ? v : (v > T(0) ? v : T(0));
}

// torch.minimum(a, b): NaN wins, a's first
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b)
{
    return a != a ? a : (b != b ? b : (a < b ? a : b));
}

template <typename T>
struct Cand {
    T score;
    T frac;
    int slot;
};

// a before b in the order of torch.argmin: NaN first, then the lower
// score, the lower slot at equal scores (and among NaNs)
template <typename T>
__device__ __forceinline__ bool before(const Cand<T>& a, const Cand<T>& b)
{
    const bool a_nan = a.score != a.score, b_nan = b.score != b.score;
    if (a_nan != b_nan) return a_nan;
    if (a_nan || a.score == b.score) return a.slot < b.slot;
    return a.score < b.score;
}

// Minimum over the block; the result is thread 0's. `part` holds kWarps
// candidates in shared memory.
template <typename T>
__device__ __forceinline__ Cand<T> block_min(Cand<T> c, Cand<T>* part)
{
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
        Cand<T> o;
        o.score = __shfl_down_sync(0xffffffffu, c.score, off);
        o.frac = __shfl_down_sync(0xffffffffu, c.frac, off);
        o.slot = __shfl_down_sync(0xffffffffu, c.slot, off);
        if (before(o, c)) c = o;
    }
    if (lane == 0) part[warp] = c;
    __syncthreads();
    if (warp == 0) {
        if (lane < kWarps) c = part[lane];
#pragma unroll
        for (int off = kWarps / 2; off > 0; off /= 2) {
            Cand<T> o;
            o.score = __shfl_down_sync(0xffffffffu, c.score, off);
            o.frac = __shfl_down_sync(0xffffffffu, c.frac, off);
            o.slot = __shfl_down_sync(0xffffffffu, c.slot, off);
            if (lane + off < kWarps && before(o, c)) c = o;
        }
    }
    return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_edges_kernel(const int32_t* __restrict__ cid,
                   const T* __restrict__ cdis,
                   const int32_t* __restrict__ belong,
                   const int32_t* __restrict__ dst,
                   const int32_t* __restrict__ rev,
                   const T* __restrict__ length,
                   const T* __restrict__ row,
                   T* scratch_f, int32_t* scratch_i,
                   int32_t* __restrict__ out_i, T* __restrict__ out_f,
                   int n_used, int lo, int hi,
                   const long long* __restrict__ cursor)
{
    if (cursor != nullptr) {
        // the insert range's cursor (csrc/insert_step.cu): row i - lo of
        // the rows, and the slots in use, clamped to [0, hi]
        const long long used = __ldg(cursor + 1);
        n_used = used < 0 ? 0 : (used > hi ? hi : (int)used);
        row = reinterpret_cast<const T*>(
            __ldg(cursor + 2)
            + (__ldg(cursor) - __ldg(cursor + 4)) * __ldg(cursor + 3)
                  * (long long)sizeof(T));
    }
    __shared__ __align__(16) int32_t s_id[kWarps][kTile];
    __shared__ __align__(16) T s_dis[kWarps][kTile];
    __shared__ Cand<T> s_part[kWarps];
    __shared__ bool s_last;
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

    // tiles start on multiples of 32 slots (16-byte aligned lists); the
    // slots of the first tile below lo are staged but not scored
    const int end = min(hi, n_used);
    const int base = lo & ~(kWarp - 1);
    Cand<T> best = {T(INFINITY), T(0), INT_MAX};
    for (int s0 = base + (blockIdx.x * kWarps + warp) * kWarp; s0 < end;
         s0 += gridDim.x * kThreads) {
        const int s = s0 + lane;
        const bool mine = s >= lo && s < end;
        bool valid = false;
        int r = 0;
        T len = 0;
        if (mine) {
            valid = belong[s] > dst[s];
            r = rev[s];
            len = length[s];
        }
        stage_lists(cid, s_id[warp], s0, end, lane);
        stage_lists(cdis, s_dis[warp], s0, end, lane);
        if (mine) {
            Cand<T> c = {T(2), T(0), s};
            if (valid) {
                T dis1 = side_staged(s_id[warp], s_dis[warp], lane, row);
                T dis2 = side_global(cid, cdis, r, row);
                // _finish_score, in its order of operations
                T addi = clamp0(mul_rn(sub_rn(add_rn(dis1, dis2), len), T(0.5)));
                dis1 = clamp0(sub_rn(dis1, addi));
                dis2 = clamp0(sub_rn(dis2, addi));
                addi = add_rn(add_rn(addi, clamp0(sub_rn(dis1, len))),
                              clamp0(sub_rn(dis2, len)));
                dis1 = nan_min(dis1, len);
                dis2 = nan_min(dis2, len);
                const T rest = sub_rn(sub_rn(len, dis1), dis2);
                c.score = addi;
                c.frac = add_rn(dis1, mul_rn(rest, T(0.5)));
            }
            if (before(c, best)) best = c;
        }
        __syncwarp();  // the tile is reused by the next round
    }

    best = block_min(best, s_part);
    if (threadIdx.x == 0) {
        scratch_f[2 * blockIdx.x] = best.score;
        scratch_f[2 * blockIdx.x + 1] = best.frac;
        scratch_i[1 + blockIdx.x] = best.slot;
        __threadfence();
        s_last = atomicAdd((unsigned int*)scratch_i, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;

    // the last block: every partial is in device memory (each writer
    // fenced before its ticket); read them past L1
    __threadfence();
    best = {T(INFINITY), T(0), INT_MAX};
    for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
        const Cand<T> c = {__ldcg(scratch_f + 2 * b),
                           __ldcg(scratch_f + 2 * b + 1),
                           __ldcg(scratch_i + 1 + b)};
        if (before(c, best)) best = c;
    }
    best = block_min(best, s_part);
    if (threadIdx.x == 0) {
        // the range's slots at and above n_used, all invalid
        const int first_unused = max(lo, n_used);
        const Cand<T> unused = {T(2), T(0), first_unused};
        if (first_unused < hi && before(unused, best)) best = unused;
        const int eid = best.slot;
        out_i[0] = eid;
        out_i[1] = belong[eid];
        out_i[2] = dst[eid];
        out_i[3] = rev[eid];
        out_f[0] = best.frac;
        out_f[1] = best.score;
        scratch_i[0] = 0;
    }
}

// with a cursor, n_used and row are read on the card, and the grid covers
// the whole slot range
template <typename T>
int launch(const void* cid, const void* cdis, const void* belong,
           const void* dst, const void* rev, const void* length,
           const void* row, void* scratch_f, void* scratch_i, void* out_i,
           void* out_f, int n_used, int lo, int hi, int scratch_blocks,
           const void* cursor, cudaStream_t stream)
{
    const int end = cursor != nullptr ? hi : (n_used < hi ? n_used : hi);
    const int base = lo & ~(kWarp - 1);
    int blocks = end > base ? (end - base + kThreads - 1) / kThreads : 1;
    blocks = blocks < 1 ? 1 : (blocks > scratch_blocks ? scratch_blocks : blocks);
    score_edges_kernel<T><<<blocks, kThreads, 0, stream>>>(
        (const int32_t*)cid, (const T*)cdis, (const int32_t*)belong,
        (const int32_t*)dst, (const int32_t*)rev, (const T*)length,
        (const T*)row, (T*)scratch_f, (int32_t*)scratch_i, (int32_t*)out_i,
        (T*)out_f, n_used, lo, hi, (const long long*)cursor);
    return (int)cudaGetLastError();
}

int launch_any(const void* cid, const void* cdis, const void* belong,
               const void* dst, const void* rev, const void* length,
               void* scratch_f, void* scratch_i, void* out_i, void* out_f,
               int scratch_blocks, int is_f64, int device, const void* row,
               int n_used, int lo, int hi, const void* cursor,
               cudaStream_t stream)
{
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    const int rc =
        is_f64 ? launch<double>(cid, cdis, belong, dst, rev, length, row,
                                scratch_f, scratch_i, out_i, out_f, n_used,
                                lo, hi, scratch_blocks, cursor, stream)
               : launch<float>(cid, cdis, belong, dst, rev, length, row,
                               scratch_f, scratch_i, out_i, out_f, n_used,
                               lo, hi, scratch_blocks, cursor, stream);
    if (current != device) cudaSetDevice(current);
    return rc;
}

}  // namespace

// Launches on `stream` of `device` without synchronizing; returns the CUDA
// error code (0 on success). Pointers are device pointers of the shapes
// and types in the header comment, float (is_f64 == 0) or double; the
// slots [lo, hi) are scored. The calling thread's current device is left
// as it was.
extern "C" int score_edges(const void* cid, const void* cdis,
                           const void* belong, const void* dst,
                           const void* rev, const void* length,
                           void* scratch_f, void* scratch_i, void* out_i,
                           void* out_f, int n_edges, int scratch_blocks,
                           int is_f64, int device, const void* row,
                           int n_used, int lo, int hi, void* stream)
{
    if (n_edges < 1 || n_used < 0 || n_used > n_edges || scratch_blocks < 1
        || lo < 0 || lo >= hi || hi > n_edges)
        return (int)cudaErrorInvalidValue;
    return launch_any(cid, cdis, belong, dst, rev, length, scratch_f,
                      scratch_i, out_i, out_f, scratch_blocks, is_f64, device,
                      row, n_used, lo, hi, nullptr, (cudaStream_t)stream);
}

// score_edges with n_used and the row read from `cursor` on the card (an
// insert range's cursor, int64 [5]; see the header comment); the state's
// arguments as score_edges'.
extern "C" int score_edges_cursor(const void* cid, const void* cdis,
                                  const void* belong, const void* dst,
                                  const void* rev, const void* length,
                                  void* scratch_f, void* scratch_i,
                                  void* out_i, void* out_f, int n_edges,
                                  int scratch_blocks, int is_f64, int device,
                                  const void* cursor, int lo, int hi,
                                  void* stream)
{
    if (n_edges < 1 || cursor == nullptr || scratch_blocks < 1 || lo < 0
        || lo >= hi || hi > n_edges)
        return (int)cudaErrorInvalidValue;
    return launch_any(cid, cdis, belong, dst, rev, length, scratch_f,
                      scratch_i, out_i, out_f, scratch_blocks, is_f64, device,
                      nullptr, 0, lo, hi, cursor, (cudaStream_t)stream);
}

extern "C" const char* score_edges_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
