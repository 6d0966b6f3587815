// D&C phase 3's per-cluster MSA distances on Hopper (sm_90a): kernel 12.
//
// Replaces no Pallas kernel: the XLA program of dipper_tpu/dc/pipeline.py::
// _dc_pair_distances' aligned branch (:1190-1210), a jax.vmap of
// dipper_tpu/distance/msa.py::_block_distance over a chunk of clusters.
// For each cluster i of a chunk and each of its members k (the last
// n_mem of its n_wit witness rows, as D&C's phase 3 builds the lists:
// wit = [head, mem]) against each of its witnesses w:
//
//     out[i, k, w] = d(member k, witness w)
//
// under distance model 1-6, in f32 or f64, from the uint8 codes
// [n_clusters, n_wit, L] (0-3 bases A C G T, 4 and above a gap). It gives
// exactly what the plain version (distance/msa.py::
// cluster_block_distances_plain, a torch._int_mm pair-count product and
// the model's formula as PyTorch ops, one cluster at a time) gives on the
// card: the counts are exact integers, and the formula runs in PyTorch's
// order and rounding, one IEEE operation at a time (the *_rn intrinsics:
// nothing is contracted into an FMA), with libdevice's log and an IEEE
// square root. The traps that order sets: a tensor divided by a Python
// scalar is a product by the scalar's reciprocal (only "/ 2.0" here,
// which is exact either way); `1.0 / x` and `0.5 / x` are reciprocal(x)
// times the scalar; JC's "/ 0.75" is a true division (the plain version
// divides by a tensor).
//
// The counts. For a pair, the 4 x 4 histogram of the columns where both
// codes are bases gives every count the six models read: P(a, b) for
// a, b < 4; P(a, 4) its row sums, P(4, b) its column sums; tot = P(4, 4)
// the whole sum; and each row's non-gap count, a sum over its own columns.
// All are exact in int32 for L <= MAX_COLUMNS (2**24).
//
// What bounds it on this card: integer operations. A pair costs 16 AND,
// 16 POPC and 16 adds for every 32 columns; the bytes (each code once,
// each distance once) are one to two orders of magnitude below at D&C's
// buckets.
//
// The design, simple first. A block of 256 threads takes one cluster's
// tile of 8 members (a warp each) x 32 witnesses (a lane each): a thread a
// pair. Columns go in rounds of 8 words of 32: each warp stages its rows
// of the tile (the 32 witness rows, then the 8 member rows) by one
// coalesced byte load a lane a word and three warp ballots (non-gap, the
// code's two bits), which give the word's four one-hot masks (A, C, G, T)
// into shared memory, and each row's non-gap count; then every thread adds
// its pair's 16 bins, __popc of the AND of two masks. A code byte is read
// once a tile; the member rows, which are witness rows too, are staged
// again as members. Rows and columns past the ends stage as gaps.
// Later work: the one-hot channels through the int8 tensor cores (mma or
// wgmma) and TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a tile: kTileMembers members (a warp each) x kTileWitnesses witnesses (a
// lane each); kTileWords words of 32 columns staged a round
constexpr int kTileMembers = 8;
constexpr int kTileWitnesses = 32;
constexpr int kTileWords = 8;
constexpr int kThreads = kTileMembers * 32;
constexpr int kStagedRows = kTileWitnesses + kTileMembers;

// IEEE operations one at a time, as PyTorch's elementwise kernels do them
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float log_ref(float a) { return logf(a); }
__device__ __forceinline__ double log_ref(double a) { return log(a); }

// torch's `reciprocal(x) * s`, which is what `s / x` is for a Python
// scalar s
template <typename T>
__device__ __forceinline__ T rdiv(T s, T x)
{
    return mul_rn(div_rn(T(1), x), s);
}

// The distance of one pair from its bins (bins[a][b]: columns with member
// code a and witness code b) and the two rows' non-gap counts, in
// distance/msa.py::_block_distance's order (i the member, j the witness).
template <typename T>
__device__ __forceinline__ T model_distance(int dt, const int (&bins)[4][4],
                                           int ng_m, int ng_w)
{
    int row[4], col[4], total = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        row[a] = bins[a][0] + bins[a][1] + bins[a][2] + bins[a][3];
        col[a] = bins[0][a] + bins[1][a] + bins[2][a] + bins[3][a];
        total += row[a];
    }
    // P(a, b) as the plain version casts it to the run's type
    auto P = [&](int a, int b) -> T {
        return T(a == 4 ? (b == 4 ? total : col[b])
                        : (b == 4 ? row[a] : bins[a][b]));
    };
    const T one = T(1), two = T(2), half = T(0.5);
    const T tot = P(4, 4);
    const T match = add_rn(add_rn(add_rn(P(0, 0), P(1, 1)), P(2, 2)),
                           P(3, 3));
    if (dt == 1 || dt == 2) {
        const T useful = sub_rn(add_rn(T(ng_m), T(ng_w)), tot);
        const T uncor = sub_rn(one, div_rn(match, useful));
        if (dt == 1) return uncor;
        return mul_rn(T(-0.75),
                      log_ref(sub_rn(one, div_rn(uncor, T(0.75)))));
    }
    const T p = add_rn(add_rn(add_rn(P(0, 2), P(2, 0)), P(1, 3)), P(3, 1));
    if (dt == 3) {
        // "/ tot / 2.0": the second a product by 0.5
        const T frA = mul_rn(div_rn(add_rn(P(0, 4), P(4, 0)), tot), half);
        const T frC = mul_rn(div_rn(add_rn(P(1, 4), P(4, 1)), tot), half);
        const T frG = mul_rn(div_rn(add_rn(P(2, 4), P(4, 2)), tot), half);
        const T frT = mul_rn(div_rn(add_rn(P(3, 4), P(4, 3)), tot), half);
        const T prAG = add_rn(P(0, 2), P(2, 0));
        const T prAT = add_rn(P(0, 3), P(3, 0));
        const T prCG = add_rn(P(1, 2), P(2, 1));
        const T prCT = add_rn(P(1, 3), P(3, 1));
        const T h = mul_rn(half, add_rn(add_rn(add_rn(
            mul_rn(mul_rn(prAG, frA), frG), mul_rn(mul_rn(prAT, frA), frT)),
            mul_rn(mul_rn(prCG, frC), frG)), mul_rn(mul_rn(prCT, frC), frT)));
        const T DD = div_rn(sub_rn(tot, match), tot);
        const T b = mul_rn(half, add_rn(
            sub_rn(sub_rn(one, mul_rn(frA, frA)), mul_rn(frG, frG)),
            div_rn(mul_rn(DD, DD), h)));
        return mul_rn(-b, log_ref(sub_rn(one, div_rn(DD, b))));
    }
    const T q = sub_rn(sub_rn(tot, match), p);
    const T pp = div_rn(p, tot);
    const T qq = div_rn(q, tot);
    const T x1 = sub_rn(sub_rn(one, mul_rn(two, pp)), qq);  // 1 - 2pp - qq
    const T x2 = sub_rn(one, mul_rn(two, qq));              // 1 - 2qq
    if (dt == 4)
        return mul_rn(T(-0.5), log_ref(mul_rn(x1, sqrt_rn(x2))));
    if (dt == 6)
        return mul_rn(half, sub_rn(add_rn(rdiv(one, x1), rdiv(half, x2)),
                                   T(1.5)));
    if (dt == 5) {
        const T gc1 = add_rn(sub_rn(P(1, 4), P(1, 1)),
                             sub_rn(P(2, 4), P(2, 2)));
        const T gc2 = add_rn(sub_rn(P(4, 1), P(1, 1)),
                             sub_rn(P(4, 2), P(2, 2)));
        const T c = sub_rn(add_rn(div_rn(gc1, tot), div_rn(gc2, tot)),
                           div_rn(div_rn(mul_rn(mul_rn(two, gc1), gc2), tot),
                                  tot));
        return sub_rn(mul_rn(-c, log_ref(sub_rn(sub_rn(one, div_rn(pp, c)),
                                                 qq))),
                      mul_rn(mul_rn(half, sub_rn(one, c)), log_ref(x2)));
    }
    return T(0);
}

struct Staged {
    uint4 wit[kTileWords][kTileWitnesses];  // (A, C, G, T) masks of a word
    uint4 mem[kTileMembers][kTileWords];
    int nongap[kStagedRows];                // witnesses, then members
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_dist_kernel(const uint8_t* __restrict__ codes, T* __restrict__ out,
                    int n_wit, int n_mem, int L, int dt, int tiles_mem,
                    int tiles_wit)
{
    __shared__ Staged sm;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int blk = blockIdx.x;
    const int tw = blk % tiles_wit;
    blk /= tiles_wit;
    const int tm = blk % tiles_mem;
    const int cl = blk / tiles_mem;
    const int w0 = tw * kTileWitnesses, k0 = tm * kTileMembers;
    const uint8_t* base = codes + (size_t)cl * n_wit * L;
    if (threadIdx.x < kStagedRows) sm.nongap[threadIdx.x] = 0;

    int bins[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) bins[a][b] = 0;

    for (int col0 = 0; col0 < L; col0 += kTileWords * 32) {
        __syncthreads();  // the last round's masks are read
        // staged row s: witness w0 + s, then member k0 + s - 32 (the
        // cluster's row n_wit - n_mem + k)
        for (int s = warp; s < kStagedRows; s += kTileMembers) {
            int row;
            bool valid;
            if (s < kTileWitnesses) {
                row = w0 + s;
                valid = row < n_wit;
            } else {
                const int k = k0 + s - kTileWitnesses;
                row = n_wit - n_mem + k;
                valid = k < n_mem;
            }
            const uint8_t* rp = base + (size_t)(valid ? row : 0) * L;
            int v[kTileWords];
#pragma unroll
            for (int t = 0; t < kTileWords; ++t) {
                const int col = col0 + t * 32 + lane;
                v[t] = valid && col < L ? (int)__ldg(rp + col) : 4;
            }
            int count = 0;
#pragma unroll
            for (int t = 0; t < kTileWords; ++t) {
                const unsigned ng = __ballot_sync(0xffffffffu, v[t] < 4);
                const unsigned b0 = __ballot_sync(0xffffffffu, v[t] & 1);
                const unsigned b1 = __ballot_sync(0xffffffffu, v[t] & 2);
                if (lane == t) {
                    const uint4 m = make_uint4(ng & ~b1 & ~b0, ng & ~b1 & b0,
                                               ng & b1 & ~b0, ng & b1 & b0);
                    if (s < kTileWitnesses)
                        sm.wit[t][s] = m;
                    else
                        sm.mem[s - kTileWitnesses][t] = m;
                }
                count += __popc(ng);
            }
            if (lane == 0) sm.nongap[s] += count;
        }
        __syncthreads();
#pragma unroll
        for (int t = 0; t < kTileWords; ++t) {
            const uint4 m4 = sm.mem[warp][t];
            const uint4 w4 = sm.wit[t][lane];
            const unsigned m[4] = {m4.x, m4.y, m4.z, m4.w};
            const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) bins[a][b] += __popc(m[a] & w[b]);
        }
    }
    __syncthreads();  // every row's non-gap count is whole
    const int k = k0 + warp, w = w0 + lane;
    if (k < n_mem && w < n_wit)
        out[((size_t)cl * n_mem + k) * n_wit + w] = model_distance<T>(
            dt, bins, sm.nongap[kTileWitnesses + warp], sm.nongap[lane]);
}

}  // namespace

// codes uint8 [n_clusters, n_wit, L] (contiguous), out [n_clusters, n_mem,
// n_wit] f32 (f64 = 0) or f64; the members are each cluster's last n_mem
// witness rows. Launches on `stream`; returns a CUDA error code.
extern "C" int msa_cluster_dist(const void* codes, void* out, int n_clusters,
                                int n_wit, int n_mem, int L, int dt, int f64,
                                void* stream)
{
    if (n_clusters < 1 || n_wit < 1 || n_mem < 1 || n_mem > n_wit || L < 1
        || dt < 1 || dt > 6)
        return (int)cudaErrorInvalidValue;
    const int tiles_mem = (n_mem + kTileMembers - 1) / kTileMembers;
    const int tiles_wit = (n_wit + kTileWitnesses - 1) / kTileWitnesses;
    const long long blocks = (long long)n_clusters * tiles_mem * tiles_wit;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* c = (const uint8_t*)codes;
    if (f64)
        cluster_dist_kernel<double><<<(unsigned)blocks, kThreads, 0, s>>>(
            c, (double*)out, n_wit, n_mem, L, dt, tiles_mem, tiles_wit);
    else
        cluster_dist_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
            c, (float*)out, n_wit, n_mem, L, dt, tiles_mem, tiles_wit);
    return (int)cudaGetLastError();
}

extern "C" const char* msa_cluster_dist_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
