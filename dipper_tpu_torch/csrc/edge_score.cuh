// The score of one directed edge and the first minimum over candidates,
// shared by score_edges.cu (kernel 3), dc_stream_block.cu and
// dc_cluster_build.cu (kernel 8).
//
// edge_score is calculateBranchLength's clamp sequence
// (placement/kclosest.py::clamp_sequence, the plain version's), operation by
// operation, with round-to-nearest intrinsics so that no multiply and add
// contract into one FMA (which rounds once where the plain version rounds
// twice), and with clamp and minimum that propagate NaN as torch's do.
//
// A candidate is (score, frac, slot), where `slot` is its rank among equal
// scores: the slot itself for score_edges, the slot's mask position for
// D&C's masked scorers. `before` is the order of torch.argmin: NaN first,
// then the lower score, the lower slot at equal scores (and among NaNs). It
// is a total order, so a minimum does not depend on the order in which the
// candidates meet.

#pragma once

#include "side_vector.cuh"

#include <limits.h>

namespace dipper {

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

// _finish_score's clamp sequence on an edge's witness maximum dis1, its
// reverse's dis2 and its length: the pendant length (the score) and frac
template <typename T>
__device__ __forceinline__ void edge_score(T dis1, T dis2, T len, T* score,
                                           T* frac)
{
    T addi = clamp0(mul_rn(sub_rn(add_rn(dis1, dis2), len), T(0.5)));
    dis1 = clamp0(sub_rn(dis1, addi));
    dis2 = clamp0(sub_rn(dis2, addi));
    addi = add_rn(add_rn(addi, clamp0(sub_rn(dis1, len))),
                  clamp0(sub_rn(dis2, len)));
    dis1 = nan_min(dis1, len);
    dis2 = nan_min(dis2, len);
    const T rest = sub_rn(sub_rn(len, dis1), dis2);
    *score = addi;
    *frac = add_rn(dis1, mul_rn(rest, T(0.5)));
}

template <typename T>
struct Cand {
    T score;
    T frac;
    int slot;
};

template <typename T>
__device__ __forceinline__ Cand<T> no_cand()
{
    return {T(INFINITY), T(0), INT_MAX};
}

// a before b in the order of torch.argmin
template <typename T>
__device__ __forceinline__ bool before(const Cand<T>& a, const Cand<T>& b)
{
    const bool a_nan = a.score != a.score, b_nan = b.score != b.score;
    if (a_nan != b_nan) return a_nan;
    if (a_nan || a.score == b.score) return a.slot < b.slot;
    return a.score < b.score;
}

// Minimum over a block of Warps warps; the result is thread 0's. `part`
// holds Warps candidates in shared memory. Every thread of the block must
// call it; the caller puts a barrier between two calls on one `part`.
template <typename T, int Warps>
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
        if (lane < Warps) c = part[lane];
#pragma unroll
        for (int off = Warps / 2; off > 0; off /= 2) {
            Cand<T> o;
            o.score = __shfl_down_sync(0xffffffffu, c.score, off);
            o.frac = __shfl_down_sync(0xffffffffu, c.frac, off);
            o.slot = __shfl_down_sync(0xffffffffu, c.slot, off);
            if (lane + off < Warps && before(o, c)) c = o;
        }
    }
    return c;
}

// D&C's mask order (dc/cluster.py::mask_order_perm): slots 0 and 1 keep
// their place; slot 2 + 4g + j of insertion g takes position
// 2 + 4g + (3 - j). The map is its own inverse.
__device__ __forceinline__ int mask_position(int s)
{
    return s < 2 ? s : s + 3 - 2 * ((s - 2) & 3);
}

// side(e) of an edge whose lists the running launch may write: the lists
// by plain loads (never the read-only path), the row by __ldg
template <typename T>
__device__ __forceinline__ T side_written(const int32_t* cid, const T* cdis,
                                         int e, const T* __restrict__ row)
{
    int32_t c[kK];
    T d[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
        c[j] = cid[(size_t)e * kK + j];
        d[j] = cdis[(size_t)e * kK + j];
    }
    return side_of(c, d, row);
}


// Minimum over one warp, every lane getting it (a butterfly of shuffles:
// `before` is a total order, so every lane ends with the same candidate)
template <typename T>
__device__ __forceinline__ Cand<T> warp_min_all(Cand<T> c)
{
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
        Cand<T> o;
        o.score = __shfl_xor_sync(0xffffffffu, c.score, off);
        o.frac = __shfl_xor_sync(0xffffffffu, c.frac, off);
        o.slot = __shfl_xor_sync(0xffffffffu, c.slot, off);
        if (before(o, c)) c = o;
    }
    return c;
}

// side_of's rule on an edge's K ids and distances and the row's entries at
// those ids, loaded beforehand (all K, so that the loads of one level of
// dependence go out together)
template <typename T>
__device__ __forceinline__ T side_vals(const int32_t (&c)[kK],
                                       const T (&d)[kK], const T (&v)[kK])
{
    T best = -INFINITY;
    bool has_nan = false;
    T nan_value = 0;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
        if (c[j] == -1) continue;
        const T x = v[j] - d[j];
        if (x != x) {
            if (!has_nan) nan_value = x;
            has_nan = true;
        } else if (x > best) {
            best = x;
        }
    }
    return has_nan ? nan_value : (best > T(0) ? best : T(0));
}

}  // namespace dipper
