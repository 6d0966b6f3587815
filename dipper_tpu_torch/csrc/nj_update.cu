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
// writes D[x, y]. D stays symmetric: row and column x (and y) get the
// same values.
//
// The last block's chain after the ticket is short: every scalar of the
// join that no thread of the launch writes (d = D[x, y], D[y, y], U[x],
// U[y], real[x], real[y], real[last]) is read by each block before its
// ticket, with its columns' loads, and the two that thread `last` writes
// (newrow[last], the updated U[last]) are left by that thread in a slot
// beside its block's partial, which the last block reads with the
// partials. Where last == y they are computed from d, D[y, y] and U[y].
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
// Launched with programmatic dependent launch (nj_step.cuh::launch): the
// blocks wait for nj_q_argmin before they read its index, and let the
// next step's nj_q_argmin be placed at once.
//
// What bounds it: latency. O(n) work (3n reads, 2n coalesced and 2n
// strided writes) over ceil(n / 256) blocks: the index, then the
// columns' and the join's reads in one trip, the ticket, the partials
// and the slot in one trip, and the last block's arithmetic.
//
// Inputs: D T [*, ld] (the active [n, n] block), U T [n], real int32 [n],
// flat int64 [1] (nj_q_argmin's), log_ids int32 [2] and log_bl T [2] (the
// step's log row), new_id; n >= 3. Scratch: part double [ceil(n / 256) +
// 2] (the blocks' partials, then the slot), ticket uint32 [1] (zero before
// the first launch); launches that share scratch must be ordered on one
// stream.

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
    __shared__ T s_slot[2];   // newrow[last] and U[last], by thread last
    __shared__ int s_last;
    wait_prior_grid();
    release_next_grid();
    const long long flat = *flat_p;
    const int a = (int)(flat / n), b = (int)(flat - (long long)a * n);
    const int x = min(a, b), y = max(a, b), last = n - 1;
    T* rowx = D + (long long)x * ld;
    T* rowy = D + (long long)y * ld;
    const T half = T(0.5);

    // the join's scalars that no thread of the launch writes, read with
    // the columns (thread 0 of every block: any block may be the last)
    const T d = rowx[y];
    T dyy = T(0), ux0 = T(0), uy0 = T(0);
    int real_x = 0, real_y = 0, real_last = 0;
    if (threadIdx.x == 0) {
        dyy = rowy[y];
        ux0 = U[x];
        uy0 = U[y];
        real_x = real[x];
        real_y = real[y];
        real_last = real[last];
    }
    const int j = blockIdx.x * kThreads + threadIdx.x;
    double s = 0.0;
    if (j < n && j != x && j != y) {
        const T rx = rowx[j], ry = rowy[j];
        const T rl = D[(long long)last * ld + j];
        const T uj = U[j];
        const T nr = mul_rn(sub_rn(add_rn(rx, ry), d), half);
        const T ujn = add_rn(uj, sub_rn(sub_rn(nr, rx), ry));
        U[j] = ujn;
        T* rowj = D + (long long)j * ld;
        rowx[j] = nr;
        rowj[x] = nr;
        rowy[j] = rl;
        rowj[y] = rl;
        s = (double)nr;
        if (j == last) {
            s_slot[0] = nr;
            s_slot[1] = ujn;
        }
    }
    s = block_sum(s, s_sum);   // its __syncthreads orders s_slot's write
    const int blocks = (int)gridDim.x;
    if (threadIdx.x == 0) {
        part[blockIdx.x] = s;
        if (last != x && last != y && blockIdx.x == last / kThreads) {
            part[blocks] = (double)s_slot[0];
            part[blocks + 1] = (double)s_slot[1];
        }
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == (unsigned int)(blocks - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    T dxl = T(0), uy = T(0);  // newrow[last], and U[last] after the update
    if (threadIdx.x == 0) {
        if (last != y) {
            dxl = (T)__ldcg(part + blocks);
            uy = (T)__ldcg(part + blocks + 1);
        } else {
            dxl = mul_rn(sub_rn(add_rn(d, dyy), d), half);
            uy = add_rn(uy0, sub_rn(sub_rn(dxl, d), dyy));
        }
    }
    T ux;
    if (n > kSmallSum) {
        double t = 0.0;
        for (int p = threadIdx.x; p < blocks; p += kThreads)
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

    const T denom = T(n - 2);
    const T unx = div_rn(ux0, denom), uny = div_rn(uy0, denom);
    T blx = mul_rn(sub_rn(add_rn(d, unx), uny), half);
    T bly = sub_rn(d, blx);
    // negative-branch clamping, remainder shifted (reference order)
    bly = blx < T(0) ? add_rn(bly, blx) : bly;
    blx = clamp0(blx);
    blx = bly < T(0) ? add_rn(blx, bly) : blx;
    bly = clamp0(bly);
    log_ids[0] = real_x;
    log_ids[1] = real_y;
    log_bl[0] = blx;
    log_bl[1] = bly;

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
    const dim3 grid((n + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (is_f64)
        err = launch(update_kernel<double>, grid, s, (double*)D, ld,
                     (double*)U, (int*)real, (const long long*)flat,
                     (int*)log_ids, (double*)log_bl, (double*)part,
                     (unsigned int*)ticket, n, new_id);
    else
        err = launch(update_kernel<float>, grid, s, (float*)D, ld,
                     (float*)U, (int*)real, (const long long*)flat,
                     (int*)log_ids, (float*)log_bl, (double*)part,
                     (unsigned int*)ticket, n, new_id);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* nj_update_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
