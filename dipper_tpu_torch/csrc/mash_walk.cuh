// The Mash merge walk on Hopper (sm_90a), shared by mash_merge_count.cu
// (the count) and mash_rows_dist.cu (the distance), so that the two kernels
// cannot drift apart: one tile kernel, instantiated with and without the
// distance table.
//
// The function. a: a bank row ("A", the already-placed taxon), b: a query
// row ("B", the new taxon), both ascending int32 ranks of which only the
// first s are read. The reference walk (src/mash.cu:426-449,
// tests/oracle.py::mash_distance) consumes the smaller head, B first on
// equal values; a B element equal to the A head raises `inter` (the A
// element stays, so every equal copy of B matches: the asymmetric multiset
// rule), every other step raises `uni`, and the walk stops once uni
// reaches s. A pair therefore takes exactly s + inter steps.
//
// What bounds it on this card: integer work, about 4 operations a step
// over s + inter steps a pair; the bytes (every row once, the output once)
// are two orders of magnitude below that. A thread that walks a pair alone
// is far from either bound: its 32 warp-mates read 32 different rows of
// device memory, 32 cache lines a load, in a dependent chain.
//
// The design.
//  1. Tiles of both sides in shared memory. A block keeps `tile` query rows
//     and walks them against bank tiles of `tile` rows, double-buffered:
//     the next bank tile arrives through cp.async (16 bytes a thread from
//     neighbouring addresses) while the current one is walked. A staged row
//     serves `tile` pairs. Blocks that run together hold different query
//     tiles and pass over the same bank tiles in the same order, so the
//     bank is read from device memory about once a wave and from the L2
//     otherwise.
//  2. A warp per pair, the walk split by merge path. The steps of the walk
//     are the merged order of A and B; step t stands on the diagonal
//     ai + bi = t. In a round, lane l takes w consecutive steps from
//     diagonal t0 + l*w: it finds that diagonal's split by a binary search
//     under the walk's tie rule (B before A on equal values), walks its w
//     steps from shared memory and keeps one bit a step (a match or not).
//  3. The stop. After a round uni = steps - inter, so s - uni more steps
//     are certain to run; the next round covers them plus the matches they
//     are expected to bring (round_steps_per_lane). While a round leaves
//     uni below s, all of its steps ran in the serial walk too. In the
//     round where uni reaches s, a prefix sum over the lanes gives each
//     lane the uni count at its first step, and the lane in which it
//     crosses s counts only the matches up to its (s - uni)-th raising
//     step, by a select on its step bits. Steps past the stop cost time
//     but are never counted, and a match at uni == s does not count.
//  4. Results go to a [tile, tile] block in shared memory and from there to
//     device memory as rows of `tile` neighbouring values.
//
// distance/mash.py::partitioned_walk_inter is a plain model of points 2 and
// 3 that the CPU tests hold against the serial walk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mash {

constexpr int kThreads = 1024;  // 32 warps, one block a multiprocessor
constexpr int kLanes = 32;
// Most steps a lane takes in a round (at most the 32 step bits it keeps).
// Neighbouring lanes then read about 13 words apart in each row, an odd
// stride that spreads a warp's reads over the banks; at 32 steps they sit
// about 16 apart, on two banks.
constexpr int kMaxStepsPerLane = 26;
// steps a round adds to its estimate of the walk's remaining length
constexpr int kRoundMargin = 16;
constexpr int kMaxLogTile = 6;  // up to 64 x 64 pairs a tile (small s)
// the dynamic shared memory one block may ask for on sm_90
constexpr int kSmemBudget = 232448;
// blocks aimed at per multiprocessor, so that the last wave is short
constexpr int kBlocksPerSm = 8;
// launcher return code when one row a side does not fit kSmemBudget (not
// a cudaError_t value)
constexpr int kSketchTooLarge = -1;
// the head of an exhausted side, stored at index s of every staged row
constexpr int32_t kExhausted = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                 "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                 "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Starts the copy of the first s ranks of `rows` rows (m apart in device
// memory) to shared memory (sp apart), and stores kExhausted at index s of
// each. nvec 16-byte pieces a row go as such (0 where rows are not 16-byte
// aligned); the rest of the row goes in 4-byte pieces, so nothing past
// index s - 1 of a device row is read.
__device__ __forceinline__ void stage_rows(int32_t* dst, const int32_t* src,
                                           int rows, int m, int s, int sp,
                                           int nvec)
{
    const int tail0 = nvec * 4, ntail = s - tail0;
    for (int i = threadIdx.x; i < rows * nvec; i += kThreads) {
        const int r = i / nvec, c = (i - r * nvec) * 4;
        cp_async16(dst + r * sp + c, src + (size_t)r * m + c);
    }
    for (int i = threadIdx.x; i < rows * ntail; i += kThreads) {
        const int r = i / ntail, c = tail0 + (i - r * ntail);
        cp_async4(dst + r * sp + c, src + (size_t)r * m + c);
    }
    for (int r = threadIdx.x; r < rows; r += kThreads)
        dst[r * sp + s] = kExhausted;
}

// stage_rows for rows picked by index: row r of the tile is device row
// idx[r] of `src` (m ints apart). The gather happens in the copy itself, so
// the picked rows are never assembled in device memory.
__device__ __forceinline__ void stage_rows_gathered(
    int32_t* dst, const int32_t* src, const int32_t* idx, int rows, int m,
    int s, int sp, int nvec)
{
    const int tail0 = nvec * 4, ntail = s - tail0;
    for (int i = threadIdx.x; i < rows * nvec; i += kThreads) {
        const int r = i / nvec, c = (i - r * nvec) * 4;
        cp_async16(dst + r * sp + c, src + (size_t)__ldg(idx + r) * m + c);
    }
    for (int i = threadIdx.x; i < rows * ntail; i += kThreads) {
        const int r = i / ntail, c = tail0 + (i - r * ntail);
        cp_async4(dst + r * sp + c, src + (size_t)__ldg(idx + r) * m + c);
    }
    for (int r = threadIdx.x; r < rows; r += kThreads)
        dst[r * sp + s] = kExhausted;
}

// Position of the k-th (1-based) set bit of m, which has at least k set
// bits: a binary search on popcounts.
__device__ __forceinline__ int select_bit(unsigned m, int k)
{
    int p = 0;
#pragma unroll
    for (int half = 16; half; half >>= 1) {
        const int c = __popc((m >> p) & ((1u << half) - 1u));
        if (c < k) {
            k -= c;
            p += half;
        }
    }
    return p;
}

// Steps each lane takes in the next round: the `need` steps that are
// certain to run, plus the matches they are expected to bring at the rate
// seen so far and a margin, spread over the lanes and capped by
// kMaxStepsPerLane.
__device__ __forceinline__ int round_steps_per_lane(int need, int uni,
                                                    int inter)
{
    int est = need;
    if (uni + inter > 0) est += need * inter / max(uni, 1) + kRoundMargin;
    return min(kMaxStepsPerLane, (est + kLanes - 1) / kLanes);
}

// One int32 from a 32-bit shared-memory address. The walk keeps addresses,
// not indices, so that a step is a compare, an add and a load.
__device__ __forceinline__ int32_t lds(unsigned addr)
{
    int32_t v;
    asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr));
    return v;
}

// `inter` of bank row a and query row b, both staged in shared memory with
// kExhausted at index s. Called by all 32 lanes of a warp, which all get
// the result. need * inter stays below 2^31 for every s that fits
// kSmemBudget.
__device__ __forceinline__ int pair_inter(const int32_t* a, const int32_t* b,
                                          int s, int lane)
{
    const unsigned sa = (unsigned)__cvta_generic_to_shared(a);
    const unsigned sb = (unsigned)__cvta_generic_to_shared(b);
    const unsigned pbe = sb + 4u * s;
    int uni = 0, inter = 0, t0 = 0, bi0 = 0;
    for (;;) {
        const int w = round_steps_per_lane(s - uni, uni, inter);
        const int t = t0 + lane * w;
        const int n = min(w, 2 * s - t);  // <= 0: past the last diagonal
        unsigned mm = 0;
        int bi = 0;
        if (n > 0) {
            // the split of diagonal t: B elements before it, the smallest
            // bi whose b[bi] goes after a[t - bi - 1]; the last round
            // ended at bi0 B elements on diagonal t0
            int lo = max(max(0, t - s), bi0);
            int hi = min(min(t, s), bi0 + (t - t0));
            const unsigned at = sa + 4u * (t - 1);
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (lds(sb + 4u * mid) <= lds(at - 4u * mid)) lo = mid + 1;
                else hi = mid;
            }
            // ai <= s and bi <= s: index s holds kExhausted
            unsigned pb = sb + 4u * lo, pa = sa + 4u * (t - lo);
            int32_t av = lds(pa), bv = lds(pb);
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                // ai == s only past the stop, where nothing is counted
                const bool tb = (bv <= av) & (pb < pbe);
                mm = mm + mm + (unsigned)(tb & (bv == av));
                if (tb) {
                    pb += 4;
                    bv = lds(pb);
                } else {
                    pa += 4;
                    av = lds(pa);
                }
            }
            bi = (int)(pb - sb) >> 2;
            mm = __brev(mm) >> (32 - n);  // bit j: step j is a match
        }
        const int lm = __popc(mm), lu = max(n, 0) - lm;
        const int tot = __reduce_add_sync(kFullMask, lu);
        if (uni + tot < s) {
            // every step of the round ran: no lane was cut short
            inter += __reduce_add_sync(kFullMask, lm);
            uni += tot;
            t0 += kLanes * w;
            bi0 = __shfl_sync(kFullMask, bi, kLanes - 1);
            continue;
        }
        int incl = lu;
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) {
            const int up = __shfl_up_sync(kFullMask, incl, d);
            if (lane >= d) incl += up;
        }
        // raising steps this lane may still take before the stop
        const int k = s - uni - (incl - lu);
        int cnt = 0;
        if (k > 0) {
            if (lu < k) {
                cnt = lm;
            } else {
                const unsigned raising = ~mm & (kFullMask >> (32 - n));
                const int p = select_bit(raising, k);
                cnt = __popc(mm & (kFullMask >> (31 - p)));
            }
        }
        return inter + __reduce_add_sync(kFullMask, cnt);
    }
}

// out[q, n] = inter(bank n, query q), or table[inter] when kTable. Block
// (x, y) holds query tile x and walks the y-th of gridDim.y runs of bank
// tiles; tile = 1 << lt rows a side, sp ints between staged rows.
template <typename T, bool kTable>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(const int32_t* __restrict__ bank,
            const int32_t* __restrict__ query, const T* __restrict__ table,
            T* __restrict__ out, int n_bank, int n_query, int m, int s,
            int sp, int lt, int tiles_per_block, int nvec, long long ldo)
{
    // [table] [query tile] [bank tile 0] [bank tile 1] [results]; every
    // part starts on a 16-byte boundary
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile = 1 << lt;
    const size_t table_bytes =
        kTable ? ((sizeof(T) * (size_t)(s + 1) + 15) & ~(size_t)15) : 0;
    const T* st = reinterpret_cast<const T*>(smem);
    int32_t* sq = reinterpret_cast<int32_t*>(smem + table_bytes);
    int32_t* sb = sq + (size_t)tile * sp;
    T* sres = reinterpret_cast<T*>(sb + (size_t)2 * tile * sp);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q0 = blockIdx.x * tile;
    const int nq = min(tile, n_query - q0);
    const int btiles = (n_bank + tile - 1) >> lt;
    const int bt0 = blockIdx.y * tiles_per_block;
    const int bt1 = min(btiles, bt0 + tiles_per_block);

    if (kTable)
        for (int t = threadIdx.x; t <= s; t += kThreads)
            reinterpret_cast<T*>(smem)[t] = table[t];
    stage_rows(sq, query + (size_t)q0 * m, nq, m, s, sp, nvec);
    stage_rows(sb, bank + (size_t)bt0 * tile * m,
               min(tile, n_bank - bt0 * tile), m, s, sp, nvec);
    cp_async_commit();

    for (int bt = bt0; bt < bt1; ++bt) {
        const int n0 = bt << lt;
        const int nb = min(tile, n_bank - n0);
        const int32_t* cur = sb + (size_t)((bt - bt0) & 1) * tile * sp;
        if (bt + 1 < bt1) {
            // the other buffer's walks ended before the last barrier
            stage_rows(sb + (size_t)((bt + 1 - bt0) & 1) * tile * sp,
                       bank + (size_t)(n0 + tile) * m,
                       min(tile, n_bank - n0 - tile), m, s, sp, nvec);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // this tile (and, the first time, sq and st)
        for (int p = warp; p < (nq << lt); p += kThreads / 32) {
            const int q = p >> lt, n = p & (tile - 1);
            if (n >= nb) continue;
            const int r = pair_inter(cur + (size_t)n * sp,
                                     sq + (size_t)q * sp, s, lane);
            if (lane == 0) {
                if (kTable) sres[p] = st[r];
                else sres[p] = (T)r;
            }
        }
        __syncthreads();  // results complete, `cur` free
        for (int p = threadIdx.x; p < (nq << lt); p += kThreads) {
            const int q = p >> lt, n = p & (tile - 1);
            if (n < nb) out[(size_t)(q0 + q) * ldo + n0 + n] = sres[p];
        }
    }
}

// Picks the largest tile that fits kSmemBudget (a smaller one for a problem
// too small to fill the card with it), splits the bank tiles over
// gridDim.y so that the card gets about kBlocksPerSm blocks a
// multiprocessor, and launches on `stream` without synchronizing. Returns
// a cudaError_t value (0 on success) or kSketchTooLarge.
template <typename T, bool kTable>
int launch_tiles(const void* bank, const void* query, const void* table,
                 void* out, int n_bank, int n_query, int m, int s,
                 long long ldo, cudaStream_t stream)
{
    const size_t sp = ((size_t)s + 1 + 3) & ~(size_t)3;
    const size_t table_bytes =
        kTable ? ((sizeof(T) * ((size_t)s + 1) + 15) & ~(size_t)15) : 0;
    const auto smem_of = [&](int lt) {
        const size_t tile = (size_t)1 << lt;
        return table_bytes + 3 * tile * sp * sizeof(int32_t)
               + tile * tile * sizeof(T);
    };
    const auto tiles_of = [](int rows, int lt) {
        return (int)(((long long)rows + (1 << lt) - 1) >> lt);
    };
    int lt = kMaxLogTile;
    while (smem_of(lt) > (size_t)kSmemBudget) {
        if (lt == 0) return kSketchTooLarge;
        --lt;
    }
    int dev = 0, nsm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    // a small problem takes smaller tiles, until every multiprocessor has
    // one
    while (lt > 0
           && (long long)tiles_of(n_query, lt) * tiles_of(n_bank, lt) < nsm)
        --lt;
    const size_t smem = smem_of(lt);
    err = cudaFuncSetAttribute(tile_kernel<T, kTable>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int qtiles = tiles_of(n_query, lt);
    const int btiles = tiles_of(n_bank, lt);
    int split = (kBlocksPerSm * nsm + qtiles - 1) / qtiles;
    split = split < 1 ? 1 : (split > btiles ? btiles : split);
    if (split > 65535) split = 65535;
    const int tiles_per_block = (btiles + split - 1) / split;
    split = (btiles + tiles_per_block - 1) / tiles_per_block;
    const bool aligned = m % 4 == 0 && (uintptr_t)bank % 16 == 0
                         && (uintptr_t)query % 16 == 0;
    dim3 grid(qtiles, split);
    tile_kernel<T, kTable><<<grid, kThreads, smem, stream>>>(
        (const int32_t*)bank, (const int32_t*)query, (const T*)table, (T*)out,
        n_bank, n_query, m, s, (int)sp, lt, tiles_per_block,
        aligned ? s / 4 : 0, ldo);
    return (int)cudaGetLastError();
}

}  // namespace mash
