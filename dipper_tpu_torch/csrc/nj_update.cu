// NJ's join and matrix update on Hopper (sm_90a): the rest of one merge
// step after the selection, in one launch that reads the selected flat
// index on the card, so that a step makes no host round trip.
//
// Replaces the join and the row and column rewrite of the JAX package's
// merge step (dipper_tpu/nj/engine.py::_one_merge_step, an XLA program
// inside _run_bucket's fori_loop; no Pallas). The port's plain version is
// nj/engine.py::_update_plain, some 40 small tensor launches. With
// x, y = min, max of (flat // n, flat % n), last = n - 1 and d = D[x, y]:
//
//   newrow = (D[x] + D[y] - d) * 0.5;  U += (newrow - D[x]) - D[y]
//   newrow[x] = 0;  U[x] = sum(newrow with entry y zeroed)
//   rl = D[last];  rl[x] = newrow[last];  rl[y] = 0;  newrow[y] = newrow[last]
//   rows and columns x and y of D <- newrow and rl;  U[y] = U[last]
//   the log row (real[x], real[y], blx, bly);  real[x] = new id,
//   real[y] = real[last]
//
// Read before write in one launch: thread j (j < n, j not x or y) owns
// column j. It reads D[x, j], D[y, j] and D[last, j] and writes D[x, j],
// D[y, j], D[j, x] and D[j, y]. No element that one thread reads is
// written by another: the column writes D[j, x], D[j, y] fall in rows x,
// y or last only at j in {x, y, last}, and the only elements of those
// rows in columns x and y that a thread reads are d and those at j in {x,
// y}. Columns x and y, d, the join and U[x], U[y] are the last block's:
// it runs after every other block has finished (a ticket taken with
// atomicAdd after __threadfence), so every read of d is done before it
// writes D[x, y]. It reads newrow[last] back from D[x, last] and U[last]
// from U, both written by thread last (or computes them where last == y).
// Where x == y (only if every off-diagonal Q exceeds the type's largest
// finite value) the later write wins, as in the plain version on the
// CPU.
//
// U[x] is summed as engine._sum_last sums: up to 128 active nodes in
// XLA:CPU's order (32-element blocks left to right, then the blocks'
// sums), from newrow read back from row x; above 128 in double, each
// block's threads in a fixed tree and the blocks' sums in block order,
// rounded once to the run's type. Every product and sum is a
// round-to-nearest intrinsic, so none contracts into an FMA: the f32
// branch lengths are the plain version's bytes.
//
// What bounds it: latency. O(n) work (3n reads, 2n coalesced and 2n
// strided writes) over ceil(n / 256) blocks, then one block's serial
// join.
//
// Inputs: D T [*, ld] (the active [n, n] block), U T [n], real int32 [n],
// flat int64 [1] (nj_q_argmin's), log_ids int32 [2] and log_bl T [2] (the
// step's log row), new_id; n >= 3. Scratch: part double [ceil(n / 256)],
// ticket uint32 [1] (zero before the first launch); launches that share
// scratch must be ordered on one stream.

#include "nj_step.cuh"

namespace {

using namespace nj;

constexpr int kSmallSum = 128;   // engine._MIN_BUCKET
constexpr int kXlaBlock = 32;    // engine._XLA_BLOCK

template <typename T>
__device__ __forceinline__ T clamp0(T v)   // torch.clamp(v, min=0) on the card
{
    return v != v ? v : fmax(v, T(0));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(T* D, long long ld, T* U, int* real, const long long* flat_p,
              int* log_ids, T* log_bl, double* part, unsigned int* ticket,
              int n, int new_id)
{
    __shared__ double s_sum[kWarps];
    __shared__ T s_row[kSmallSum];
    __shared__ T s_blk[kSmallSum / kXlaBlock];
    __shared__ int s_last;
    const long long flat = *flat_p;
    const int a = (int)(flat / n), b = (int)(flat - (long long)a * n);
    const int x = min(a, b), y = max(a, b), last = n - 1;
    T* rowx = D + (long long)x * ld;
    T* rowy = D + (long long)y * ld;
    const T d = rowx[y];
    const T half = T(0.5);

    const int j = blockIdx.x * kThreads + threadIdx.x;
    double s = 0.0;
    if (j < n && j != x && j != y) {
        const T rx = rowx[j], ry = rowy[j];
        const T rl = D[(long long)last * ld + j];
        const T nr = mul_rn(sub_rn(add_rn(rx, ry), d), half);
        U[j] = add_rn(U[j], sub_rn(sub_rn(nr, rx), ry));
        T* rowj = D + (long long)j * ld;
        rowx[j] = nr;
        rowj[x] = nr;
        rowy[j] = rl;
        rowj[y] = rl;
        s = (double)nr;
    }
    s = block_sum(s, s_sum);
    if (threadIdx.x == 0) {
        part[blockIdx.x] = s;
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    T ux;
    if (n > kSmallSum) {
        double t = 0.0;
        for (int p = threadIdx.x; p < (int)gridDim.x; p += kThreads)
            t = __dadd_rn(t, __ldcg(part + p));
        ux = (T)block_sum(t, s_sum);
    } else {
        // XLA:CPU's order over newrow with x and y zeroed, padded with
        // zeros to whole blocks
        const int nb = (n + kXlaBlock - 1) / kXlaBlock;
        if (threadIdx.x < nb * kXlaBlock) {
            const int k = threadIdx.x;
            s_row[k] = (k < n && k != x && k != y) ? __ldcg(rowx + k) : T(0);
        }
        __syncthreads();
        if (threadIdx.x < nb) {
            const T* blk = s_row + threadIdx.x * kXlaBlock;
            T acc = blk[0];
            for (int t = 1; t < kXlaBlock; ++t) acc = add_rn(acc, blk[t]);
            s_blk[threadIdx.x] = acc;
        }
        __syncthreads();
        ux = s_blk[0];
        for (int k = 1; k < nb; ++k) ux = add_rn(ux, s_blk[k]);
    }
    if (threadIdx.x != 0) return;

    T dxl, uy;  // newrow[last], and U[last] after the update
    if (last != y) {
        dxl = __ldcg(rowx + last);
        uy = __ldcg(U + last);
    } else {
        const T dyy = rowy[y];
        dxl = mul_rn(sub_rn(add_rn(d, dyy), d), half);
        uy = add_rn(U[y], sub_rn(sub_rn(dxl, d), dyy));
    }
    const T denom = T(n - 2);
    const T unx = div_rn(U[x], denom), uny = div_rn(U[y], denom);
    T blx = mul_rn(sub_rn(add_rn(d, unx), uny), half);
    T bly = sub_rn(d, blx);
    // negative-branch clamping, remainder shifted (reference order)
    bly = blx < T(0) ? add_rn(bly, blx) : bly;
    blx = clamp0(blx);
    blx = bly < T(0) ? add_rn(blx, bly) : blx;
    bly = clamp0(bly);
    log_ids[0] = real[x];
    log_ids[1] = real[y];
    log_bl[0] = blx;
    log_bl[1] = bly;
    const int real_last = real[last];

    rowx[x] = T(0);
    rowx[y] = dxl;
    rowy[x] = dxl;
    rowy[y] = T(0);
    U[x] = ux;
    U[y] = uy;
    real[x] = new_id;
    real[y] = real_last;
    *ticket = 0u;
}

}  // namespace

extern "C" int nj_update(void* D, long long ld, void* U, void* real,
                         const void* flat, void* log_ids, void* log_bl,
                         void* part, void* ticket, int n, int new_id,
                         int is_f64, int device, void* stream)
{
    if (n < 3 || ld < n) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        update_kernel<double><<<blocks, kThreads, 0, s>>>(
            (double*)D, ld, (double*)U, (int*)real, (const long long*)flat,
            (int*)log_ids, (double*)log_bl, (double*)part,
            (unsigned int*)ticket, n, new_id);
    else
        update_kernel<float><<<blocks, kThreads, 0, s>>>(
            (float*)D, ld, (float*)U, (int*)real, (const long long*)flat,
            (int*)log_ids, (float*)log_bl, (double*)part,
            (unsigned int*)ticket, n, new_id);
    return (int)cudaGetLastError();
}

extern "C" const char* nj_update_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
