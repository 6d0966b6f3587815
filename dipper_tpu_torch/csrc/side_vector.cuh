// The witness side of one directed edge, shared by side_vector.cu (the
// standalone [E] vector) and score_edges.cu (the whole scorer).
//
//   side(e) = max(max_{j < K, cid[e, j] != -1} (row[cid[e, j]] - cdis[e, j]), 0)
//
// with 0 for an edge whose K slots are all empty, and NaN when any of its
// differences is NaN: the plain version's amax and clamp propagate NaN
// where fmax would drop it, so NaN is tested for explicitly.
//
// A warp's 32 consecutive edges own 32 * K contiguous ids and as many
// distances. stage_lists copies them into shared memory with coalesced
// 16-byte reads (4-byte reads for a ragged last tile or a base that is not
// 16-byte aligned); each lane then picks its K entries at a stride of K
// words, which is free of bank conflicts because K = 5 is odd. The row
// entries are scattered reads by nature and go through the read-only path
// (ld.global.nc): the row, at most 240 KB, stays in L2.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dipper {

constexpr int kK = 5;        // placement/kclosest.py::K
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTile = kWarp * kK;  // list entries of a warp's 32 edges

// The K-lists of edges [e0, min(e0 + 32, n_edges)) of `g` -> `s` (shared,
// 16-byte aligned, kTile entries), by the 32 lanes of one warp.
template <typename V>
__device__ __forceinline__ void stage_lists(const V* __restrict__ g, V* s,
                                            int e0, int n_edges, int lane)
{
    const V* src = g + (size_t)e0 * kK;
    const int n = min(kWarp, n_edges - e0) * kK;
    if (n == kTile && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        constexpr int kVec = kTile * (int)sizeof(V) / 16;
        const int4* src4 = reinterpret_cast<const int4*>(src);
        int4* dst4 = reinterpret_cast<int4*>(s);
        for (int i = lane; i < kVec; i += kWarp) dst4[i] = __ldg(src4 + i);
    } else {
        for (int i = lane; i < n; i += kWarp) s[i] = __ldg(src + i);
    }
    __syncwarp();
}

// side(e) from the K ids and distances of one edge (registers) and the row.
template <typename T>
__device__ __forceinline__ T side_of(const int32_t (&c)[kK], const T (&d)[kK],
                                     const T* __restrict__ row)
{
    T best = -INFINITY;
    bool has_nan = false;
    T nan_value = 0;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
        if (c[j] == -1) continue;
        const T v = __ldg(row + c[j]) - d[j];
        if (v != v) {
            if (!has_nan) nan_value = v;
            has_nan = true;
        } else if (v > best) {
            best = v;
        }
    }
    return has_nan ? nan_value : (best > T(0) ? best : T(0));
}

// side(e) of the edge at position `lane` of a staged tile.
template <typename T>
__device__ __forceinline__ T side_staged(const int32_t* s_id, const T* s_dis,
                                         int lane, const T* __restrict__ row)
{
    int32_t c[kK];
    T d[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
        c[j] = s_id[lane * kK + j];
        d[j] = s_dis[lane * kK + j];
    }
    return side_of(c, d, row);
}

// side(e) of any edge, its lists read from device memory (two scattered
// runs of K entries) through the read-only path.
template <typename T>
__device__ __forceinline__ T side_global(const int32_t* __restrict__ cid,
                                         const T* __restrict__ cdis, int e,
                                         const T* __restrict__ row)
{
    int32_t c[kK];
    T d[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
        c[j] = __ldg(cid + (size_t)e * kK + j);
        d[j] = __ldg(cdis + (size_t)e * kK + j);
    }
    return side_of(c, d, row);
}

}  // namespace dipper
