// D&C phase 3's per-cluster MSA distances on Hopper (sm_90a): kernel 12,
// and the pack that feeds it.
//
// Replaces no Pallas kernel: the XLA program of dipper_tpu/dc/pipeline.py::
// _dc_pair_distances' aligned branch (:1190-1210), a jax.vmap of
// dipper_tpu/distance/msa.py::_block_distance over a chunk of clusters,
// which gathers every cluster's witness codes on the host and uploads them.
// For each cluster i of a chunk and each of its members k (the last n_mem
// of its n_wit witness rows, as D&C's phase 3 builds the lists: wit =
// [head, mem]) against each of its witnesses w:
//
//     out[i, k, w] = d(member k, witness w)
//
// under distance model 1-6, in f32 or f64. It gives exactly what the plain
// version (distance/msa.py::cluster_dist_by_index_plain: the codes gathered
// by the lists, a torch._int_mm pair-count product and the model's formula
// as PyTorch ops, one cluster at a time) gives on the card: the counts are
// exact integers, and the formula runs in PyTorch's order and rounding, one
// IEEE operation at a time (the *_rn intrinsics: nothing is contracted
// into an FMA), with libdevice's log and an IEEE square root. The traps
// that order sets: a tensor divided by a Python scalar is a product by the
// scalar's reciprocal (only "/ 2.0" here, which is exact either way); `1.0
// / x` and `0.5 / x` are reciprocal(x) times the scalar; JC's "/ 0.75" is a
// true division (the plain version divides by a tensor).
//
// The bank. msa_cluster_dist_pack turns uint8 codes [R, L] (0-3 bases A C
// G T, 4 and above a gap) into one-hot bit planes uint32 [R, 4, words]:
// bit j of plane a, word t, is set when column 32 t + j holds base a;
// `words` is whole k-steps of 256 columns, and every column past L is a
// gap (0 in all four planes). It also writes each row's non-gap count. D&C
// packs its aligned set once a run; the planes stay on the card (half the
// codes' bytes) and kernel 12 reads its rows by the witness lists'
// indices, so no codes are gathered on the host or uploaded a chunk.
//
// The counts. For a pair, the 4 x 4 histogram of the columns where both
// rows hold bases gives every count the six models read: P(a, b) for a, b
// < 4; P(a, 4) its row sums, P(4, b) its column sums; tot = P(4, 4) the
// whole sum; and each row's non-gap count (the pack's). With the member's
// planes as the rows of A (row 4m + a) and the witness's as the columns of
// B (column 4w + b), the histogram is the product C = A B^T over the
// columns with AND for the multiply and popcount-add for the sum: C[4m +
// a, 4w + b] = bins[a][b]. The tensor cores do it in one-bit operands:
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc (BMMA in the
// SASS), a tile of 4 members x 2 witnesses x 256 columns an instruction.
// All counts are exact in int32 for L <= MAX_COLUMNS (2**24).
//
// What bounds it on this card (chip_smoke.py::planes_bound): each pair's
// 16 bins take 32 bit operations a column, and the one-bit tensor cores do
// about 16 Pops (an m16n8k256 at the card's int8 mma issue rate); each
// cluster's witnesses' planes are read once (W x 5,120 bytes at L =
// 10,000) and each distance written once. A 20K run's narrow chunks (W =
// Q + 10 <= 74) are bound by those bytes (13-18 us), its widest two (W =
// 138, 236) by the products (8 and 2 us).
//
// The design. A warp takes one m-tile (4 members: 16 rows of A) and a
// group of at most kMaxNTiles n-tiles (2 witnesses each: 8 columns of B),
// its accumulators in registers; a block a chunk of bm m-tiles x bg groups
// of one cluster (make_plan: the whole cluster where it takes at most
// kMaxWarps warps, so buckets 8 and 16 read each plane row once; else the
// witnesses whole with bm = 16 / groups, or 4 x 4). The block stages its
// rows' planes, one k-step a stage, in a ring of kStages by cp.async (16
// bytes a thread) from the rows the lists index; where its groups cover
// every witness the members are read from the staged witness rows (the
// lists' tail), else they are staged on their own. A staged row-plane
// takes kStageStride words (8 and 4 of padding), so the 32 lanes' fragment
// loads fall in 32 banks. The epilogue writes four n-tiles' accumulators
// at a time to shared memory (a pair's 16 bins, 17 words apart) and a
// lane a pair runs the model.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// words of one m16n8k256 k-step (256 columns); a plane's words are a
// multiple of it
constexpr int kStepWords = 8;
// the cp.async ring: k-steps in flight, and the words of a staged
// row-plane (8 and 4 of padding: conflict-free fragment loads)
constexpr int kStages = 4;
constexpr int kStageStride = 12;
// n-tiles (2 witnesses each) a warp, warps a block
constexpr int kMaxNTiles = 10;
constexpr int kMaxWarps = 16;
// n-tiles a round of the epilogue (32 pairs: a lane a pair), and the words
// of a pair's bins in shared memory
constexpr int kEpilogueNTiles = 4;
constexpr int kBinStride = 17;
constexpr int kPackThreads = 256;

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

// d += A B^T over one k-step: 16 x 256 one-bit A, 8 x 256 B, AND then
// popcount-add (the fragments' layout: distance/msa_cluster_model.py)
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2])
{
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A launch's shape for clusters of W witnesses, the last Q the members
// (distance/msa_cluster_model.py::plan mirrors it)
struct Plan {
    int m_tiles;     // tiles of 4 members
    int n_tiles;     // tiles of 2 witnesses
    int groups;      // groups of n-tiles, a warp's each
    int ntg;         // n-tiles a group
    int bm, bg;      // m-tiles and groups a block
    int mem_chunks, wit_chunks;  // blocks a cluster along each
    int separate;    // members staged apart from the witnesses
    int wit_slots;   // witness rows a block stages
    int rows;        // rows a block stages
    int warps;
    int smem;        // dynamic shared memory, bytes
};

Plan make_plan(int W, int Q)
{
    Plan p;
    p.m_tiles = (Q + 3) / 4;
    p.n_tiles = (W + 1) / 2;
    p.groups = (p.n_tiles + kMaxNTiles - 1) / kMaxNTiles;
    p.ntg = (p.n_tiles + p.groups - 1) / p.groups;
    if (p.m_tiles * p.groups <= kMaxWarps) {
        p.bm = p.m_tiles;
        p.bg = p.groups;
    } else if (p.groups <= kMaxWarps / 4) {
        p.bm = kMaxWarps / p.groups;
        p.bg = p.groups;
    } else {
        p.bm = 4;
        p.bg = 4;
    }
    p.mem_chunks = (p.m_tiles + p.bm - 1) / p.bm;
    p.wit_chunks = (p.groups + p.bg - 1) / p.bg;
    p.separate = p.wit_chunks > 1;
    p.wit_slots = 2 * p.ntg * p.bg;
    p.rows = p.wit_slots + (p.separate ? 4 * p.bm : 0);
    p.warps = p.bm * p.bg;
    const int stage = p.rows * 4 * kStageStride * 4 * kStages;
    const int bins = p.warps * kEpilogueNTiles * 8 * kBinStride * 4;
    // the row ids first, in whole 16 bytes: the ring's copies are aligned
    p.smem = (p.rows + 3) / 4 * 16 + (stage > bins ? stage : bins);
    return p;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
cluster_dist_kernel(const uint32_t* __restrict__ planes,
                    const int32_t* __restrict__ nongap,
                    const int32_t* __restrict__ wit, T* __restrict__ out,
                    int W, int Q, int n_rows, int words, int dt, Plan p)
{
    extern __shared__ __align__(16) uint32_t smem[];
    int* rowidx = (int*)smem;                        // [rows]
    uint32_t* ring = smem + (p.rows + 3) / 4 * 4;    // [stages][rows][4][stride]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int blk = blockIdx.x;
    const int wc = blk % p.wit_chunks;
    blk /= p.wit_chunks;
    const int mc = blk % p.mem_chunks;
    const int cl = blk / p.mem_chunks;
    const int32_t* wl = wit + (size_t)cl * W;
    const int w_base = wc * p.wit_slots, m_base = mc * p.bm * 4;

    // the staged rows: witness slots, then (apart) member slots; slots
    // past the lists repeat the last row (their results are not written)
    for (int s = tid; s < p.rows; s += blockDim.x) {
        const int i = s < p.wit_slots
            ? min(w_base + s, W - 1)
            : W - Q + min(m_base + s - p.wit_slots, Q - 1);
        rowidx[s] = min(max(wl[i], 0), n_rows - 1);
    }
    __syncthreads();

    const int ring_rows = p.rows * 4;
    const int jobs = ring_rows * 2;  // 16 bytes each: 2 a row-plane's step
    auto stage = [&](int ks, int buf) {
        uint32_t* dst0 = ring + (size_t)buf * ring_rows * kStageStride;
        for (int j = tid; j < jobs; j += blockDim.x) {
            const int rp = j >> 1, h = j & 1;
            const uint32_t* src = planes
                + ((size_t)rowidx[rp >> 2] * 4 + (rp & 3)) * words
                + ks * kStepWords + h * 4;
            __pipeline_memcpy_async(dst0 + rp * kStageStride + h * 4, src,
                                    16);
        }
    };

    // this warp's m-tile and group
    const int mt = mc * p.bm + warp / p.bg;
    const int grp = wc * p.bg + warp % p.bg;
    const bool active = mt < p.m_tiles && grp < p.groups;
    const int nt0 = grp * p.ntg;
    const int ntw = active ? min(p.n_tiles, nt0 + p.ntg) - nt0 : 0;
    // A's rows g and g + 8: members 4 mt + g / 4 and 4 mt + 2 + g / 4,
    // plane g % 4; as staged row-planes
    auto mem_rp = [&](int mi) {
        const int m = min(4 * mt + mi, Q - 1);
        const int s = p.separate ? p.wit_slots + m - m_base : W - Q + m;
        return s * 4 + (g & 3);
    };
    const int a_lo = mem_rp(g >> 2) * kStageStride + t;
    const int a_hi = mem_rp((g >> 2) + 2) * kStageStride + t;
    // B's column g of n-tile j: witness 2 (nt0 + j) + g / 4, plane g % 4
    const int b0 = ((2 * nt0 + (g >> 2) - w_base) * 4 + (g & 3))
        * kStageStride + t;

    int acc[kMaxNTiles][4];
#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0;

    const int ksteps = words / kStepWords;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < ksteps) stage(s, s);
        __pipeline_commit();
    }
    for (int ks = 0; ks < ksteps; ++ks) {
        __pipeline_wait_prior(kStages - 2);
        __syncthreads();  // step ks is in; step ks - 1's buffer is free
        const int nx = ks + kStages - 1;
        if (nx < ksteps) stage(nx, nx % kStages);
        __pipeline_commit();
        if (ntw > 0) {
            const uint32_t* buf = ring
                + (size_t)(ks % kStages) * ring_rows * kStageStride;
            const uint32_t a[4] = {buf[a_lo], buf[a_hi], buf[a_lo + 4],
                                   buf[a_hi + 4]};
#pragma unroll
            for (int j = 0; j < kMaxNTiles; ++j) {
                if (j < ntw) {
                    const int o = b0 + j * 8 * kStageStride;
                    const uint32_t b[2] = {buf[o], buf[o + 4]};
                    mma_b1(acc[j], a, b);
                }
            }
        }
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // the ring is free: the epilogue reuses it

    int* bins = (int*)ring + warp * (kEpilogueNTiles * 8 * kBinStride);
#pragma unroll
    for (int j0 = 0; j0 < kMaxNTiles; j0 += kEpilogueNTiles) {
        if (j0 >= ntw) break;
        // pair p = jj * 8 + mi * 2 + wi: member 4 mt + mi, witness
        // 2 (nt0 + j0 + jj) + wi; C's (g, 2t) is (mi = g / 4, a = g % 4,
        // wi = t / 2, b = 2 (t % 2))
#pragma unroll
        for (int jj = 0; jj < kEpilogueNTiles; ++jj) {
            if (j0 + jj < kMaxNTiles && j0 + jj < ntw) {
                const int pr = jj * 8 + (g >> 2) * 2 + (t >> 1);
                const int bi = (g & 3) * 4 + 2 * (t & 1);
                int* b_lo = bins + pr * kBinStride + bi;
                int* b_hi = bins + (pr + 4) * kBinStride + bi;
                b_lo[0] = acc[j0 + jj][0];
                b_lo[1] = acc[j0 + jj][1];
                b_hi[0] = acc[j0 + jj][2];
                b_hi[1] = acc[j0 + jj][3];
            }
        }
        __syncwarp();
        const int pr = lane, jj = pr >> 3;
        const int m = 4 * mt + ((pr >> 1) & 3);
        const int w = 2 * (nt0 + j0 + jj) + (pr & 1);
        if (j0 + jj < ntw && m < Q && w < W) {
            int b[4][4];
#pragma unroll
            for (int i = 0; i < 16; ++i)
                b[i >> 2][i & 3] = bins[pr * kBinStride + i];
            const int ng_m = nongap[min(max(wl[W - Q + m], 0), n_rows - 1)];
            const int ng_w = nongap[min(max(wl[w], 0), n_rows - 1)];
            out[((size_t)cl * Q + m) * W + w] =
                model_distance<T>(dt, b, ng_m, ng_w);
        }
        __syncwarp();
    }
}

// codes [rows, L] -> planes [rows, 4, words], nongap [rows]: a block a
// row, a warp a word at a time (a lane a column, a ballot a base)
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint8_t* __restrict__ codes, uint32_t* __restrict__ planes,
            int32_t* __restrict__ nongap, int L, int words)
{
    __shared__ int counts[kPackThreads / 32];
    const int row = blockIdx.x, warp = threadIdx.x >> 5,
              lane = threadIdx.x & 31;
    const uint8_t* src = codes + (size_t)row * L;
    uint32_t* dst = planes + (size_t)row * 4 * words;
    int count = 0;
    for (int w = warp; w < words; w += kPackThreads / 32) {
        const int col = w * 32 + lane;
        const int v = col < L ? (int)__ldg(src + col) : 4;
        const uint32_t m0 = __ballot_sync(0xffffffffu, v == 0);
        const uint32_t m1 = __ballot_sync(0xffffffffu, v == 1);
        const uint32_t m2 = __ballot_sync(0xffffffffu, v == 2);
        const uint32_t m3 = __ballot_sync(0xffffffffu, v == 3);
        if (lane < 4)
            dst[lane * words + w] =
                lane == 0 ? m0 : lane == 1 ? m1 : lane == 2 ? m2 : m3;
        count += __popc(m0 | m1 | m2 | m3);
    }
    if (lane == 0) counts[warp] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int i = 0; i < kPackThreads / 32; ++i) total += counts[i];
        nongap[row] = total;
    }
}

template <typename T>
int launch(const void* planes, const void* nongap, const void* wit,
           void* out, int n_clusters, int W, int Q, int n_rows, int words,
           int dt, cudaStream_t s)
{
    const Plan p = make_plan(W, Q);
    const long long blocks = (long long)n_clusters * p.mem_chunks
        * p.wit_chunks;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    auto kernel = cluster_dist_kernel<T>;
    if (p.smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            p.smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)blocks, p.warps * 32, p.smem, s>>>(
        (const uint32_t*)planes, (const int32_t*)nongap,
        (const int32_t*)wit, (T*)out, W, Q, n_rows, words, dt, p);
    return (int)cudaGetLastError();
}

}  // namespace

// planes uint32 [n_rows, 4, words] (msa_cluster_dist_pack's), nongap int32
// [n_rows], wit int32 [n_clusters, n_wit] row ids (contiguous), out
// [n_clusters, n_mem, n_wit] f32 (f64 = 0) or f64; the members are each
// cluster's last n_mem witnesses. Launches on `stream`; returns a CUDA
// error code.
extern "C" int msa_cluster_dist(const void* planes, const void* nongap,
                                const void* wit, void* out, int n_clusters,
                                int n_wit, int n_mem, int n_rows, int words,
                                int dt, int f64, void* stream)
{
    if (n_clusters < 1 || n_wit < 1 || n_mem < 1 || n_mem > n_wit
        || n_rows < 1 || words < kStepWords || words % kStepWords != 0
        || dt < 1 || dt > 6)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return f64 ? launch<double>(planes, nongap, wit, out, n_clusters, n_wit,
                                n_mem, n_rows, words, dt, s)
               : launch<float>(planes, nongap, wit, out, n_clusters, n_wit,
                               n_mem, n_rows, words, dt, s);
}

// codes uint8 [rows, L] (contiguous) -> planes uint32 [rows, 4, words],
// nongap int32 [rows]; words >= ceil(L / 32), a multiple of kStepWords.
extern "C" int msa_cluster_dist_pack(const void* codes, void* planes,
                                     void* nongap, int rows, int L,
                                     int words, void* stream)
{
    if (rows < 1 || L < 1 || words * 32LL < L || words % kStepWords != 0)
        return (int)cudaErrorInvalidValue;
    pack_kernel<<<rows, kPackThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (uint32_t*)planes, (int32_t*)nongap, L,
        words);
    return (int)cudaGetLastError();
}

// The plan for clusters of n_wit witnesses and n_mem members, as 14 ints
// in Plan's order (the tests hold it to the model's)
extern "C" int msa_cluster_dist_plan(int n_wit, int n_mem, int* out)
{
    if (n_wit < 1 || n_mem < 1 || n_mem > n_wit)
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(n_wit, n_mem);
    const int v[14] = {p.m_tiles, p.n_tiles, p.groups, p.ntg, p.bm, p.bg,
                       p.mem_chunks, p.wit_chunks, p.separate, p.wit_slots,
                       p.rows, p.warps, p.smem,
                       p.mem_chunks * p.wit_chunks};
    for (int i = 0; i < 14; ++i) out[i] = v[i];
    return 0;
}

extern "C" const char* msa_cluster_dist_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
