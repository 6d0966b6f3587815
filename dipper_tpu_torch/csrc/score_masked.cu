// D&C's masked scorer on Hopper (sm_90a): the scoring of one member of a
// streamed cluster build in one launch, with the cluster's scoreable flags
// updated for the insertion that follows.
//
// Replaces the scoring part of the JAX package's _cluster_step
// (dipper_tpu/dc/pipeline.py:180-206, calculateBranchLengthSpecialIDDC), an
// XLA program and not Pallas, as _stream_range_run (:266-318) runs it for a
// cluster too large to batch. The plain version is the port's tensor code,
// dc/cluster.py::_score_masked (the CPU path, and this kernel's yardstick on
// the card); dc/cluster_model.py::score_masked models this file's plan.
//
// The plan is score_edges.cu's (TPU kernel 3's port), with D&C's mask:
//
// - one thread scores one slot s below n_used, the slots in use (2 + 4 kq
//   for member kq): its lists staged by its warp, the reverse slot's read
//   through the read-only path, edge_score's clamp sequence. Slots at or
//   above n_used belong to members not yet inserted and need no thread;
// - s is valid when scoreable[s] holds (the tensor code's mask: a group's
//   slots are live once inserted, and the flags say which direction of an
//   edge counts). An invalid slot is the candidate (2.0, frac 0) as in the
//   tensor code, and the one candidate (2.0, n_used) stands for the unused
//   slots, whose mask positions are all at or above n_used;
// - the minimum is lexicographic over (score, mask position), a NaN score
//   before every number, as torch.argmin orders the scores in mask order:
//   position p(s) = s for s < 2, else 2 + 4g + (3 - j) for s = 2 + 4g + j
//   (mask_position, its own inverse). Warp shuffles, then the block's warps
//   through shared memory, one partial a block; the last block to take a
//   ticket (atomicAdd after __threadfence) reduces the partials, writes the
//   outputs and resets the ticket;
// - that last block then updates the flags as build_streamed does after
//   its splice: scoreable[eid] and scoreable[rev[eid]] (indexed as a tensor
//   index is) false, then slots n_used .. n_used + 3 true, true, false,
//   true. Every block has read the flags before it took its ticket.
//
// Inputs: cid int32 [E, 5], cdis T [E, 5], belong, e, rev int32 [E], length
// T [E], all contiguous; scoreable uint8 [E] (torch.bool); row T [W] with
// every witness id < W. Outputs, score_edges.cu's layout (so that
// insert_step_cursor reads them): out_i int32 [4] = eid, belong[eid],
// e[eid], rev[eid]; out_f T [2] = frac, score (the pendant length).
// Scratch: scratch_i int32 [1 + scratch_blocks] (the ticket, zero before
// the first launch), scratch_f T [2 * scratch_blocks]; launches that share
// scratch are ordered on one stream.
//
// score_masked_cursor reads n_used and the row from an insert range's
// cursor (csrc/insert_step.cu: int64 [5] = member i, slots in use, the
// address of the rows, their stride in elements, the rows' first member),
// so that one launch captured in a CUDA graph scores every member the
// graph is replayed for; its grid covers all E slots.
//
// What bounds it: memory, and at a cluster's sizes latency: 57 (f64: 97)
// bytes a used slot and its row entries, all of it resident in L2 from one
// member to the next.

#include "edge_score.cuh"

namespace {

using namespace dipper;

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_masked_kernel(const int32_t* __restrict__ cid,
                    const T* __restrict__ cdis,
                    const int32_t* __restrict__ belong,
                    const int32_t* __restrict__ dst,
                    const int32_t* __restrict__ rev,
                    const T* __restrict__ length, uint8_t* scoreable,
                    const T* __restrict__ row, T* scratch_f,
                    int32_t* scratch_i, int32_t* __restrict__ out_i,
                    T* __restrict__ out_f, int n_edges, int n_used,
                    const long long* __restrict__ cursor)
{
    if (cursor != nullptr) {
        const long long used = __ldg(cursor + 1);
        n_used = used < 0 ? 0 : (used > n_edges ? n_edges : (int)used);
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

    Cand<T> best = no_cand<T>();
    for (int s0 = (blockIdx.x * kWarps + warp) * kWarp; s0 < n_used;
         s0 += gridDim.x * kThreads) {
        const int s = s0 + lane;
        const bool mine = s < n_used;
        bool valid = false;
        int r = 0;
        T len = 0;
        if (mine) {
            // scoreable is written by this launch's last block, after every
            // block's reads: a plain load
            valid = scoreable[s] != 0;
            r = max(rev[s], 0);
            len = length[s];
        }
        stage_lists(cid, s_id[warp], s0, n_used, lane);
        stage_lists(cdis, s_dis[warp], s0, n_used, lane);
        if (mine) {
            Cand<T> c = {T(2), T(0), mask_position(s)};
            if (valid) {
                edge_score(side_staged(s_id[warp], s_dis[warp], lane, row),
                           side_global(cid, cdis, r, row), len, &c.score,
                           &c.frac);
            }
            if (before(c, best)) best = c;
        }
        __syncwarp();  // the tile is reused by the next round
    }

    best = block_min<T, kWarps>(best, s_part);
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
    best = no_cand<T>();
    for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
        const Cand<T> c = {__ldcg(scratch_f + 2 * b),
                           __ldcg(scratch_f + 2 * b + 1),
                           __ldcg(scratch_i + 1 + b)};
        if (before(c, best)) best = c;
    }
    best = block_min<T, kWarps>(best, s_part);
    if (threadIdx.x == 0) {
        // the unused slots, all invalid, at positions n_used and up
        const Cand<T> unused = {T(2), T(0), n_used};
        if (n_used < n_edges && before(unused, best)) best = unused;
        const int eid = mask_position(best.slot);
        const int ye = rev[eid];
        out_i[0] = eid;
        out_i[1] = belong[eid];
        out_i[2] = dst[eid];
        out_i[3] = ye;
        out_f[0] = best.frac;
        out_f[1] = best.score;
        // the insertion's flags, in build_streamed's order
        const int yi = ye < 0 ? ye + n_edges : ye;
        scoreable[eid] = 0;
        if (yi >= 0 && yi < n_edges) scoreable[yi] = 0;
        for (int q = 0; q < 4; ++q)
            if (n_used + q < n_edges) scoreable[n_used + q] = q != 2;
        scratch_i[0] = 0;
    }
}

int launch_any(const void* const* st, void* scoreable, void* scratch_f,
               void* scratch_i, void* out_i, void* out_f, int n_edges,
               int scratch_blocks, int is_f64, int device, const void* row,
               int n_used, const void* cursor, cudaStream_t stream)
{
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    // with a cursor the grid covers every slot, n_used being read on the
    // card
    const int end = cursor != nullptr ? n_edges : n_used;
    int blocks = (end + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks > scratch_blocks ? scratch_blocks : blocks);
    const int32_t* i32[4] = {(const int32_t*)st[0], (const int32_t*)st[2],
                             (const int32_t*)st[3], (const int32_t*)st[4]};
    if (is_f64)
        score_masked_kernel<double><<<blocks, kThreads, 0, stream>>>(
            i32[0], (const double*)st[1], i32[1], i32[2], i32[3],
            (const double*)st[5], (uint8_t*)scoreable, (const double*)row,
            (double*)scratch_f, (int32_t*)scratch_i, (int32_t*)out_i,
            (double*)out_f, n_edges, n_used, (const long long*)cursor);
    else
        score_masked_kernel<float><<<blocks, kThreads, 0, stream>>>(
            i32[0], (const float*)st[1], i32[1], i32[2], i32[3],
            (const float*)st[5], (uint8_t*)scoreable, (const float*)row,
            (float*)scratch_f, (int32_t*)scratch_i, (int32_t*)out_i,
            (float*)out_f, n_edges, n_used, (const long long*)cursor);
    const int rc = (int)cudaGetLastError();
    if (current != device) cudaSetDevice(current);
    return rc;
}

}  // namespace

// State arguments of both entry points: cid, cdis, belong, e, rev, length
// (device pointers of the shapes and types in the header comment, float
// (is_f64 == 0) or double), scoreable, scratch_f, scratch_i, out_i, out_f;
// n_edges, scratch_blocks, is_f64, device. Each launches on `stream` of
// `device` without synchronizing and returns the CUDA error code (0 on
// success); the calling thread's current device is left as it was.
#define MASKED_PARAMS                                                         \
    const void *cid, const void *cdis, const void *belong, const void *dst,   \
        const void *rev, const void *length, void *scoreable,                 \
        void *scratch_f, void *scratch_i, void *out_i, void *out_f,           \
        int n_edges, int scratch_blocks, int is_f64, int device
#define MASKED_STATE {cid, cdis, belong, dst, rev, length}

static bool masked_ok(int n_edges, int scratch_blocks, const void* scoreable,
                      const void* out_i, const void* out_f)
{
    return n_edges >= 1 && scratch_blocks >= 1 && scoreable != nullptr
           && out_i != nullptr && out_f != nullptr;
}

// The member whose slots in use are the first n_used (2 + 4 kq), its row
// `row` (T [W]).
extern "C" int score_masked(MASKED_PARAMS, const void* row, int n_used,
                            void* stream)
{
    if (!masked_ok(n_edges, scratch_blocks, scoreable, out_i, out_f)
        || row == nullptr || n_used < 0 || n_used > n_edges)
        return (int)cudaErrorInvalidValue;
    const void* st[6] = MASKED_STATE;
    return launch_any(st, scoreable, scratch_f, scratch_i, out_i, out_f,
                      n_edges, scratch_blocks, is_f64, device, row, n_used,
                      nullptr, (cudaStream_t)stream);
}

// The member that the insert range's cursor (int64 [5]) holds.
extern "C" int score_masked_cursor(MASKED_PARAMS, const void* cursor,
                                   void* stream)
{
    if (!masked_ok(n_edges, scratch_blocks, scoreable, out_i, out_f)
        || cursor == nullptr)
        return (int)cudaErrorInvalidValue;
    const void* st[6] = MASKED_STATE;
    return launch_any(st, scoreable, scratch_f, scratch_i, out_i, out_f,
                      n_edges, scratch_blocks, is_f64, device, nullptr, 0,
                      cursor, (cudaStream_t)stream);
}

// Loads both kernels on `device` (a capture must load none).
extern "C" int score_masked_preload(int device)
{
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    cudaFuncAttributes a;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&a, (const void*)score_masked_kernel<float>);
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&a,
                                    (const void*)score_masked_kernel<double>);
    if (current >= 0 && current != device) cudaSetDevice(current);
    return (int)err;
}

extern "C" const char* score_masked_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
