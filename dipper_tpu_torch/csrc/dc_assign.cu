// D&C phase 2's cluster assignment on Hopper (sm_90a), kernel 10: the
// chosen backbone edge of every row of a chunk of distance rows, in one
// launch.
//
// Replaces the JAX package's _phase2_all and _phase2_chunk_{mash,matrix,
// msa} (dipper_tpu/dc/pipeline.py:57-133), an XLA program (no Pallas): a
// vmap of kclosest.score_edges (dipper_tpu/placement/kclosest.py:374) over
// the chunk's rows, which the TPU ran as a [Q, E, 5] witness gather and
// some twenty passes over [Q, E]. Its plain version is placement/
// kclosest.py::score_edges_rows_plain; dc/assign_model.py models this
// schedule (change the two together).
//
// What it computes. Rows T [Q, width] (unit stride along a row, any row
// stride: the matrix frontend passes a view of its matrix) and the finished
// backbone's state: cid int32 [E, 5], cdis T [E, 5], belong, e, rev int32
// [E] and length T [E], contiguous. Slot s is valid where belong[s] > e[s];
// it scores edge_score(side(s), side(rev[s]), length[s]), the clamp
// sequence of calculateBranchLength, where side(x) = max(max_j row[cid[x,
// j]] - cdis[x, j], 0) over the entries with cid != -1 (NaN where a
// difference is NaN); an invalid slot scores SENT_DIS = 2.0. out[q] (int64)
// is the first minimum over the slots in the order of torch.argmin
// (edge_score.cuh's `before`: NaN first, the lower slot at equal scores), so
// it equals score_edges_rows_plain's row bit for bit. Every witness id must
// be below `width`.
//
// Design. The state is the same for every row, so the work is a batch. A
// block owns R consecutive rows and walks every slot once for all of them:
// thread t takes slots t, t + 256, ..., loads a valid slot's lists, its
// reverse's lists and its length into registers once, and scores them
// against its R rows. So the state crosses L2 once a block (Q / R times a
// chunk) and each row crosses device memory once. The R rows sit in shared
// memory where they fit ("staged": R = 8, 4 or 2 rows within 96 KB, so
// that two blocks share an SM, else one row up to 225 KB), and a witness's
// value is one shared-memory load; wider rows (f64 at B > 28,800) are read
// from device memory through the read-only path, 8 rows a block
// ("global"). At D&C's sizes in f32: B = 1,500 (30K taxa), rows of 6 KB, R
// = 8 (48 KB a block); B = 5,000 (100K), rows of 20 KB, R = 4 (80 KB); B =
// 50,000 (1M), one row of 200 KB a block. Keeping the row layout (a row
// staged whole) and not a transposed [B, rows] block, which would let one
// witness id fetch a vector of rows, avoids a transposing pass and holds at
// any B; the cost is a bank-conflicted shared-memory load a witness and
// row. Each thread keeps a candidate a row and its first invalid slot,
// which stands for all of its invalid slots (they all score 2.0); a row's
// candidates meet by warp shuffles and then across the warps in shared
// memory (edge_score.cuh's block_min), and thread 0 writes the slot. The
// minimum is over a total order, so it does not depend on the order of
// reduction. No ticket, no scratch, no host round trip.
//
// What bounds it: the operations, about 35 a row and valid slot (10
// differences and 10 maxima over the witnesses, the clamp sequence's 14, a
// compare), above the rows' bytes at D&C's sizes (100K: 95,000 rows x
// 10,000 valid slots x 35 = 3.3e10 operations, 1.9 GB of rows).

#include "edge_score.cuh"

namespace {

using namespace dipper;

constexpr int kAssignThreads = 256;
constexpr int kAssignWarps = kAssignThreads / kWarp;
// shared-memory budget of a block's rows when it holds two or more, and of
// a block's one row (the rest of the SM's 227 KB holds the static buffers)
constexpr long long kStagedBytes = 96 * 1024;
constexpr long long kStagedOneRow = 225 * 1024;
// rows a block where the rows are read from device memory
constexpr int kGlobalRows = 8;
constexpr double kSentDis = 2.0;

template <typename T, int R, bool Staged>
__global__ void __launch_bounds__(kAssignThreads)
dc_assign_kernel(const int32_t* __restrict__ cid, const T* __restrict__ cdis,
                 const int32_t* __restrict__ belong,
                 const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ rev,
                 const T* __restrict__ length, int n_edges,
                 const T* __restrict__ rows, long long row_stride,
                 int n_rows, int width, long long* __restrict__ out)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_rows = reinterpret_cast<T*>(smem_raw);
    __shared__ Cand<T> s_part[kAssignWarps];
    const int row0 = blockIdx.x * R;
    const int n_mine = min(R, n_rows - row0);
    const T* src = rows + (long long)row0 * row_stride;
    if (Staged) {
        for (int r = 0; r < n_mine; ++r)
            for (int w = threadIdx.x; w < width; w += kAssignThreads)
                s_rows[r * width + w] =
                    __ldg(src + (long long)r * row_stride + w);
        __syncthreads();
    }

    Cand<T> best[R];
#pragma unroll
    for (int r = 0; r < R; ++r) best[r] = no_cand<T>();
    int first_invalid = INT_MAX;
    for (int s = threadIdx.x; s < n_edges; s += kAssignThreads) {
        if (!(__ldg(belong + s) > __ldg(dst + s))) {
            // a thread's slots ascend: its first invalid one is its lowest
            if (first_invalid == INT_MAX) first_invalid = s;
            continue;
        }
        const int r_s = __ldg(rev + s);
        const T len = __ldg(length + s);
        int32_t c1[kK], c2[kK];
        T d1[kK], d2[kK];
#pragma unroll
        for (int j = 0; j < kK; ++j) {
            c1[j] = __ldg(cid + (size_t)s * kK + j);
            d1[j] = __ldg(cdis + (size_t)s * kK + j);
            c2[j] = __ldg(cid + (size_t)r_s * kK + j);
            d2[j] = __ldg(cdis + (size_t)r_s * kK + j);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if (r < n_mine) {
                // the plain version reads row[max(c, 0)] and masks the
                // empty entries (c == -1), which side_vals skips
                T v1[kK], v2[kK];
#pragma unroll
                for (int j = 0; j < kK; ++j) {
                    const int a = max(c1[j], 0), b = max(c2[j], 0);
                    if (Staged) {
                        v1[j] = s_rows[r * width + a];
                        v2[j] = s_rows[r * width + b];
                    } else {
                        v1[j] = __ldg(src + (long long)r * row_stride + a);
                        v2[j] = __ldg(src + (long long)r * row_stride + b);
                    }
                }
                Cand<T> c = {T(0), T(0), s};
                T frac;
                edge_score(side_vals(c1, d1, v1), side_vals(c2, d2, v2), len,
                           &c.score, &frac);
                if (before(c, best[r])) best[r] = c;
            }
        }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
        Cand<T> c = best[r];
        if (first_invalid != INT_MAX) {
            const Cand<T> inv = {T(kSentDis), T(0), first_invalid};
            if (before(inv, c)) c = inv;
        }
        c = block_min<T, kAssignWarps>(c, s_part);
        if (threadIdx.x == 0 && r < n_mine) out[row0 + r] = c.slot;
        __syncthreads();  // s_part is reused by the next row
    }
}

// The plan for rows of `width` elements of `item` bytes: rows a block,
// whether they are staged, and the block's dynamic shared memory.
void make_plan(int width, int item, int* rows_per_block, int* staged,
               long long* smem)
{
    const long long row_bytes = (long long)width * item;
    for (int r = 8; r >= 2; r /= 2) {
        if (r * row_bytes <= kStagedBytes) {
            *rows_per_block = r;
            *staged = 1;
            *smem = r * row_bytes;
            return;
        }
    }
    if (row_bytes <= kStagedOneRow) {
        *rows_per_block = 1;
        *staged = 1;
        *smem = row_bytes;
        return;
    }
    *rows_per_block = kGlobalRows;
    *staged = 0;
    *smem = 0;
}

template <typename T, int R, bool Staged>
int launch_t(const void* cid, const void* cdis, const void* belong,
             const void* dst, const void* rev, const void* length,
             int n_edges, const void* rows, long long row_stride, int n_rows,
             int width, void* out, cudaStream_t stream)
{
    const long long smem = Staged ? (long long)R * width * sizeof(T) : 0;
    auto kernel = dc_assign_kernel<T, R, Staged>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (n_rows + R - 1) / R;
    kernel<<<blocks, kAssignThreads, (size_t)smem, stream>>>(
        (const int32_t*)cid, (const T*)cdis, (const int32_t*)belong,
        (const int32_t*)dst, (const int32_t*)rev, (const T*)length, n_edges,
        (const T*)rows, row_stride, n_rows, width, (long long*)out);
    return (int)cudaGetLastError();
}

// the plan's instances: R = 1, 2, 4 or 8 staged rows, or kGlobalRows
// rows read from device memory
template <typename T>
int launch_plan(int rows_per_block, int staged, const void* cid,
                const void* cdis, const void* belong, const void* dst,
                const void* rev, const void* length, int n_edges,
                const void* rows, long long row_stride, int n_rows,
                int width, void* out, cudaStream_t stream)
{
#define DC_ASSIGN_LAUNCH(R, S)                                              \
    launch_t<T, R, S>(cid, cdis, belong, dst, rev, length, n_edges, rows,  \
                      row_stride, n_rows, width, out, stream)
    if (!staged)
        return rows_per_block == kGlobalRows
                   ? DC_ASSIGN_LAUNCH(kGlobalRows, false)
                   : (int)cudaErrorInvalidValue;
    switch (rows_per_block) {
    case 1: return DC_ASSIGN_LAUNCH(1, true);
    case 2: return DC_ASSIGN_LAUNCH(2, true);
    case 4: return DC_ASSIGN_LAUNCH(4, true);
    case 8: return DC_ASSIGN_LAUNCH(8, true);
    default: return (int)cudaErrorInvalidValue;
    }
#undef DC_ASSIGN_LAUNCH
}

}  // namespace

// Writes the plan for rows of `width` elements (float, or double if
// is_f64) into out int [4]: rows a block, staged (1) or read from device
// memory (0), threads a block, dynamic shared memory bytes a block.
extern "C" int dc_assign_plan(int width, int is_f64, int* out)
{
    if (width < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
    int rows_per_block, staged;
    long long smem;
    make_plan(width, is_f64 ? 8 : 4, &rows_per_block, &staged, &smem);
    out[0] = rows_per_block;
    out[1] = staged;
    out[2] = kAssignThreads;
    out[3] = (int)smem;
    return 0;
}

// Launches kernel 10 on `stream` of `device` without synchronizing and
// returns the CUDA error code (0 on success). The state's six arrays and
// the rows as in the header comment (float if is_f64 == 0, else double),
// n_rows >= 1 rows of `width` >= 1 elements `row_stride` apart (>= width
// unless n_rows == 1); out int64 [n_rows]. rows_per_block and staged
// override the plan where they are >= 0 (tests drive every instance with
// them): 1, 2, 4 or 8 staged rows within 225 KB, or 8 rows read from
// device memory. The calling thread's current device is left as it was.
extern "C" int dc_assign(const void* cid, const void* cdis, const void* belong,
                         const void* dst, const void* rev, const void* length,
                         int n_edges, const void* rows, long long row_stride,
                         int n_rows, int width, void* out, int rows_per_block,
                         int staged, int is_f64, int device, void* stream)
{
    if (n_edges < 1 || n_rows < 1 || width < 1
        || (n_rows > 1 && row_stride < width))
        return (int)cudaErrorInvalidValue;
    const int item = is_f64 ? 8 : 4;
    int plan_rows, plan_staged;
    long long plan_smem;
    make_plan(width, item, &plan_rows, &plan_staged, &plan_smem);
    const int R = rows_per_block >= 0 ? rows_per_block : plan_rows;
    const int st = staged >= 0 ? staged : plan_staged;
    if (st && (long long)R * width * item > kStagedOneRow)
        return (int)cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    const int rc =
        is_f64 ? launch_plan<double>(R, st, cid, cdis, belong, dst, rev,
                                     length, n_edges, rows, row_stride,
                                     n_rows, width, out, s)
               : launch_plan<float>(R, st, cid, cdis, belong, dst, rev,
                                    length, n_edges, rows, row_stride, n_rows,
                                    width, out, s);
    if (current != device) cudaSetDevice(current);
    return rc;
}

extern "C" const char* dc_assign_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
