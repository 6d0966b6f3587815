// MinHash (Mash) bottom-s sketches of packed DNA rows, on Hopper (sm_90a).
//
// Replaces the XLA program dipper_tpu/sketch/minhash.py::
// sketch_batch_device_packed (no Pallas kernel): for every window
// j <= len - k of a row, the canonical k-mer (the smaller of its
// lexicographic form and its reverse complement's), the low 64 bits of
// MurmurHash3_x64_128 (seed 42) of its ASCII spelling, and the row's
// s smallest hashes as a multiset, ascending, padded with
// 0xFFFF_FFFF_FFFF_FFFF. Contract: words int32 [rows, n_words], 16 2-bit
// codes a word LSB-first; lengths int32 [rows]; out u64 [rows, s]. The
// plain version is sketch/minhash.py::sketch_batch_plain, bit for bit.
//
// What bounds it on this card: integer operations. A window costs about
// 100 32-bit integer operations (the canonical form and the key bytes
// about 33, the murmur tail with its two 64-bit finalisers about 64, the
// mask and a compare), where it reads a quarter of a byte; at the card's
// int32 rate that is some 10^4 times the time of its bytes. The TPU
// program was written around the TPU's lack of u64 (u32 limb arithmetic,
// a tiled two-key sort over [B, L] intermediates in HBM).
//
// What the design does about it. Native unsigned long long arithmetic,
// and no [B, L] intermediate in device memory:
//  (a) A block takes one row's tile of kTile = 4,096 windows. Each thread
//      builds its windows' codes straight from at most two packed words
//      (a funnel shift: no rolling state crosses threads), reverses the
//      2-bit groups with __brev for the lexicographic form, picks the
//      canonical form, spells it into the two key words with __byte_perm
//      on the "ACGT" bytes, hashes it, and writes the sentinel where the
//      window is past the row's length. The block sorts the tile in
//      shared memory (cub::BlockRadixSort, 32 KB of keys) and writes its
//      bottom min(kTile, s) values. Tiles wholly past a row's length
//      write sentinels without hashing.
//  (b) Each row's sorted tile lists are merged pairwise, keeping the
//      first min(2 len, s) of each pair, in rounds until one list is
//      left, which goes to `out`. A thread writes kPerThread consecutive
//      outputs from a merge-path split that it finds by a binary search
//      in device memory, so no sketch size meets a shared-memory limit.
//      Keeping the first s of two sorted lists keeps duplicates: the
//      multiset rule.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

namespace minhash {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // windows a stage-(a) block sorts
constexpr int kMergeThreads = 256;
constexpr int kPerThread = 8;  // consecutive outputs a merge thread writes
constexpr int kMaxSketch = 1 << 20;
constexpr u64 kSentinel = 0xFFFFFFFFFFFFFFFFull;
// "ACGT" as bytes 0..3: __byte_perm's selector i picks the character of
// 2-bit code i; selector 4 picks a zero byte (from y = 0)
constexpr uint32_t kAscii = 0x54474341u;

// stage bits of minhash_sketch's `stages`
constexpr int kStageTiles = 1;
constexpr int kStageMerge = 2;
constexpr int kStageHashOnly = 4;  // stage (a) without the sort (timing)

__device__ __forceinline__ u64 rotl64(u64 x, int r)
{
    return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ u64 fmix64(u64 k)
{
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdull;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ull;
    k ^= k >> 33;
    return k;
}

// MurmurHash3_x64_128's low 64 bits for keys of 1..15 bytes (the tail
// path only), seed 42; k1/k2 the little-endian key words.
__device__ __forceinline__ u64 murmur_tail(u64 k1, u64 k2, int klen)
{
    const u64 c1 = 0x87c37b91114253d5ull;
    const u64 c2 = 0x4cf5ad432745937full;
    u64 h1 = 42, h2 = 42;
    if (klen > 8) {
        k2 *= c2;
        k2 = rotl64(k2, 33);
        k2 *= c1;
        h2 ^= k2;
    }
    k1 *= c1;
    k1 = rotl64(k1, 31);
    k1 *= c2;
    h1 ^= k1;
    h1 ^= (u64)klen;
    h2 ^= (u64)klen;
    h1 += h2;
    h2 += h1;
    h1 = fmix64(h1);
    h2 = fmix64(h2);
    return h1 + h2;
}

// 2-bit groups of the low 16 bits -> the low 2 bits of 8 nibbles
__device__ __forceinline__ uint32_t spread_nibbles(uint32_t x)
{
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    return (x | (x << 2)) & 0x33333333u;
}

// four key bytes from four selector nibbles
__device__ __forceinline__ u64 spell(uint32_t sel)
{
    return (u64)__byte_perm(kAscii, 0u, sel & 0xFFFFu)
        | ((u64)__byte_perm(kAscii, 0u, sel >> 16) << 32);
}

// The hash of window j of a row of packed words: `mask` keeps 2k bits;
// pad_lo / pad_hi hold selector 4 in the nibbles of characters >= k.
__device__ __forceinline__ u64 hash_window(const uint32_t* w, int n_words,
                                           long long j, int k,
                                           uint32_t mask, uint32_t pad_lo,
                                           uint32_t pad_hi)
{
    const long long wi = j >> 4;
    const uint32_t w0 = w[wi];
    const uint32_t w1 = wi + 1 < n_words ? w[wi + 1] : 0u;
    // code i of the window at bits 2i (LSB-first)
    const uint32_t fwd_lsb =
        __funnelshift_r(w0, w1, (unsigned)(j & 15) * 2u) & mask;
    // code i at bits 2(k-1-i): reverse the 16 groups, then drop 16-k
    uint32_t rev = __brev(fwd_lsb);
    rev = ((rev >> 1) & 0x55555555u) | ((rev & 0x55555555u) << 1);
    const uint32_t fwd_lex = rev >> (32 - 2 * k);
    const uint32_t rc_lex = ~fwd_lsb & mask;
    // the canonical form, LSB-first: character i at bits 2i
    const uint32_t canon = fwd_lex <= rc_lex ? fwd_lsb : (~fwd_lex & mask);
    const u64 k1 = spell(spread_nibbles(canon & 0xFFFFu) | pad_lo);
    const u64 k2 = k > 8 ? spell(spread_nibbles(canon >> 16) | pad_hi) : 0;
    return murmur_tail(k1, k2, k);
}

// Stage (a): block b hashes and sorts tile b % n_tiles of row
// b / n_tiles and writes its first `keep` values, then sentinels up to
// `width`, to dst + b * width.
__global__ void __launch_bounds__(kThreads)
tiles_kernel(const uint32_t* __restrict__ words,
             const int* __restrict__ lengths, int n_words, int k,
             int n_tiles, int keep, int width, int sort,
             u64* __restrict__ dst)
{
    typedef cub::BlockRadixSort<u64, kThreads, kItems> Sort;
    __shared__ typename Sort::TempStorage temp;

    const long long b = blockIdx.x;
    const long long row = b / n_tiles;
    const long long base = (b % n_tiles) * (long long)kTile;
    const long long len = min((long long)lengths[row], 16LL * n_words);
    const long long last = len - k;  // the last valid window
    u64* d = dst + b * width;
    if (base > last) {
        for (int i = threadIdx.x; i < width; i += kThreads)
            d[i] = kSentinel;
        return;
    }
    const uint32_t mask = (1u << (2 * k)) - 1u;
    uint32_t pad_lo = 0, pad_hi = 0;
    for (int i = k; i < 16; ++i) {
        if (i < 8)
            pad_lo |= 4u << (4 * i);
        else
            pad_hi |= 4u << (4 * (i - 8));
    }
    const uint32_t* w = words + row * n_words;
    // striped: item it of thread t is window base + it * kThreads + t
    u64 keys[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        const long long j = base + it * kThreads + threadIdx.x;
        keys[it] = j <= last ? hash_window(w, n_words, j, k, mask, pad_lo,
                                           pad_hi)
                             : kSentinel;
    }
    if (sort)
        Sort(temp).SortBlockedToStriped(keys);
    // striped: item it of thread t is rank it * kThreads + t
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        const int r = it * kThreads + threadIdx.x;
        if (r < keep)
            d[r] = keys[it];
    }
    for (int i = keep + threadIdx.x; i < width; i += kThreads)
        d[i] = kSentinel;
}

// Stage (b), one round: list pair (2p, 2p+1) of every row of src
// ([rows, n_src, len_src]) -> list p of dst ([rows, n_dst, width]): the
// first out_len values of the pair's merge, sentinels from there to
// width (an odd last list merges with nothing).
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const u64* __restrict__ src, int n_src, int len_src,
             u64* __restrict__ dst, int n_dst, int width, int out_len,
             long long n_items)
{
    const long long chunks = (width + kPerThread - 1) / kPerThread;
    for (long long item = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         item < n_items; item += (long long)gridDim.x * blockDim.x) {
        const long long list = item / chunks;
        const long long row = list / n_dst;
        const int pair = (int)(list % n_dst);
        const u64* a = src + (row * n_src + 2LL * pair) * len_src;
        const u64* bb = a + len_src;
        const int la = len_src;
        const int lb = 2 * pair + 1 < n_src ? len_src : 0;
        const int o0 = (int)(item % chunks) * kPerThread;
        // merge path: ai of the first o outputs, equal values A first
        const int o = min(o0, la + lb);
        int lo = max(0, o - lb), hi = min(o, la);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (a[mid] <= bb[o - 1 - mid])
                lo = mid + 1;
            else
                hi = mid;
        }
        int ai = lo, bi = o - lo;
        u64* d = dst + list * width;
        const int end = min(o0 + kPerThread, width);
        for (int t = o0; t < end; ++t) {
            u64 v = kSentinel;
            if (t < out_len) {
                if (ai < la && (bi >= lb || a[ai] <= bb[bi]))
                    v = a[ai++];
                else if (bi < lb)
                    v = bb[bi++];
            }
            d[t] = v;
        }
    }
}

struct Plan {
    int n_tiles;
    int keep;
    long long ping;  // u64 of one ping-pong buffer, per row
};

// must agree with sketch/minhash_cuda.py::plan and scratch_elems
__host__ Plan make_plan(int n_words, int k, int s)
{
    Plan p;
    const long long windows = 16LL * n_words - k + 1;
    p.n_tiles = (int)((windows + kTile - 1) / kTile);
    p.keep = s < kTile ? s : kTile;
    p.ping = 0;
    long long n = p.n_tiles, len = p.keep;
    while (n > 1) {
        n = (n + 1) / 2;
        len = 2 * len < s ? 2 * len : s;
        if (n > 1 && n * len > p.ping)
            p.ping = n * len;
    }
    return p;
}

}  // namespace minhash

// Sketches `n_rows` rows on `stream` without synchronizing; returns
// cudaGetLastError() after each launch (0 on success). Device pointers:
// words int32 [n_rows, n_words] and lengths int32 [n_rows], contiguous;
// out u64 [n_rows, s]; scratch u64 [scratch_elems], at least n_rows x
// (tiles x keep + 2 x ping) (sketch/minhash_cuda.py::scratch_elems; 0
// when a row is one tile). `stages`: 1 stage (a), 2 stage (b) on the
// tiles that a stage (a) left in scratch, 3 both, 5 stage (a) without its
// sort (a measurement of the hashing alone; the result is not a sketch).
extern "C" int minhash_sketch(const void* words, const void* lengths,
                              void* scratch, long long scratch_elems,
                              void* out, int n_rows, int n_words, int k,
                              int s, int stages, void* stream)
{
    using namespace minhash;
    if (n_rows < 1 || n_words < 1 || k < 2 || k > 15 || s < 1
        || s > kMaxSketch || !(stages == 1 || stages == 2 || stages == 3
                               || stages == 5))
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(n_words, k, s);
    const long long tiles_elems = (long long)p.n_tiles * p.keep;
    const long long need =
        p.n_tiles > 1 ? n_rows * (tiles_elems + 2 * p.ping) : 0;
    if (scratch_elems < need)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    u64* tiles = (u64*)scratch;
    u64* ping[2] = {tiles + n_rows * tiles_elems,
                    tiles + n_rows * (tiles_elems + p.ping)};
    u64* o = (u64*)out;
    if (stages & kStageTiles) {
        const bool direct = p.n_tiles == 1;
        tiles_kernel<<<(unsigned)((long long)n_rows * p.n_tiles), kThreads,
                       0, st>>>(
            (const uint32_t*)words, (const int*)lengths, n_words, k,
            p.n_tiles, p.keep, direct ? s : p.keep,
            (stages & kStageHashOnly) ? 0 : 1, direct ? o : tiles);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess)
            return (int)e;
    }
    if ((stages & kStageMerge) && p.n_tiles > 1) {
        const u64* src = tiles;
        int n_src = p.n_tiles, len_src = p.keep, round = 0;
        while (n_src > 1) {
            const int n_dst = (n_src + 1) / 2;
            const int len_dst = 2 * len_src < s ? 2 * len_src : s;
            const bool last = n_dst == 1;
            u64* dst = last ? o : ping[round & 1];
            const int width = last ? s : len_dst;
            const long long items = (long long)n_rows * n_dst
                * ((width + kPerThread - 1) / kPerThread);
            long long blocks = (items + kMergeThreads - 1) / kMergeThreads;
            if (blocks > 132LL * 64)
                blocks = 132LL * 64;
            merge_kernel<<<(unsigned)blocks, kMergeThreads, 0, st>>>(
                src, n_src, len_src, dst, n_dst, width, len_dst, items);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess)
                return (int)e;
            src = dst;
            n_src = n_dst;
            len_src = len_dst;
            ++round;
        }
    }
    return (int)cudaSuccess;
}

extern "C" const char* minhash_sketch_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
