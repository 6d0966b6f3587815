// What NJ's two merge-step kernels share (csrc/nj_q_argmin.cu,
// csrc/nj_update.cu): the block shape, round-to-nearest arithmetic that
// cannot contract into an FMA, torch.argmin's order of candidates, and
// the launch that may overlap the previous kernel of the stream
// (programmatic dependent launch).
#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace nj {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;

// One rounding per operation, as the plain version's tensor ops round: an
// intrinsic is never contracted with a neighbour into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T> __device__ __forceinline__ T largest();
template <> __device__ __forceinline__ float largest<float>() { return FLT_MAX; }
template <> __device__ __forceinline__ double largest<double>() { return DBL_MAX; }

// A candidate of the first minimum: a value and its flat index; i < 0 is
// no candidate.
template <typename T>
struct Cand {
    T v;
    long long i;
};

// a before b in torch.argmin's order: a NaN before every number (the
// first NaN among NaNs), then the lower value (-0.0 == +0.0), then the
// lower index. A strict total order on real candidates, so a minimum over
// it does not depend on the order in which it is reduced.
template <typename T>
__device__ __forceinline__ bool before(const Cand<T>& a, const Cand<T>& b)
{
    if (b.i < 0) return a.i >= 0;
    if (a.i < 0) return false;
    const bool a_nan = a.v != a.v, b_nan = b.v != b.v;
    if (a_nan != b_nan) return a_nan;
    if (a_nan || a.v == b.v) return a.i < b.i;
    return a.v < b.v;
}

// The first minimum over the block; thread 0's result. `part` holds kWarps
// candidates in shared memory; every thread of the block calls it.
template <typename T>
__device__ __forceinline__ Cand<T> block_min(Cand<T> c, Cand<T>* part)
{
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
        Cand<T> o;
        o.v = __shfl_down_sync(0xffffffffu, c.v, off);
        o.i = __shfl_down_sync(0xffffffffu, c.i, off);
        if (before(o, c)) c = o;
    }
    __syncthreads();  // `part` may still be read by an earlier call
    if (lane == 0) part[warp] = c;
    __syncthreads();
    if (warp == 0) {
        c = lane < kWarps ? part[lane] : Cand<T>{T(0), -1};
#pragma unroll
        for (int off = kWarps / 2; off > 0; off /= 2) {
            Cand<T> o;
            o.v = __shfl_down_sync(0xffffffffu, c.v, off);
            o.i = __shfl_down_sync(0xffffffffu, c.i, off);
            if (before(o, c)) c = o;
        }
    }
    return c;
}

// The block's sum of one double a thread, in a fixed order (lanes by
// shuffles, then the warps' sums in warp order); thread 0's result.
__device__ __forceinline__ double block_sum(double s, double* part)
{
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
        s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    __syncthreads();
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        s = part[0];
        for (int w = 1; w < kWarps; ++w) s = __dadd_rn(s, part[w]);
    }
    return s;
}

// Programmatic dependent launch (Hopper): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// previous kernel of its stream runs; wait_prior_grid() returns once that
// kernel has finished and its writes are visible. Both kernels call it before their first global
// read or write. release_next_grid() lets the next such launch start.
__device__ __forceinline__ void wait_prior_grid()
{
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void release_next_grid()
{
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launches kernel<<<grid, kThreads>>>(args...) on `s` with programmatic
// dependent launch.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, cudaStream_t s,
                   Args... args)
{
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

struct OnDevice {
    int prev = -1;
    cudaError_t err = cudaSuccess;
    explicit OnDevice(int device)
    {
        err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    }
    ~OnDevice()
    {
        int now = -1;
        if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
            cudaSetDevice(prev);
    }
};

}  // namespace nj
