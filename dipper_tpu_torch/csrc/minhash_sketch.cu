// MinHash (Mash) bottom-s sketches of packed DNA rows, on Hopper (sm_90a).
//
// Replaces the XLA program dipper_tpu/sketch/minhash.py::
// sketch_batch_device_packed (no Pallas kernel): for every window
// j <= len - k of a row, the canonical k-mer (the smaller of its
// lexicographic form and its reverse complement's), the low 64 bits of
// MurmurHash3_x64_128 (seed 42) of its ASCII spelling, and the row's
// s smallest hashes as a multiset, ascending, padded with
// 0xFFFF_FFFF_FFFF_FFFF. Contract: words int32 [rows, n_words], 16 2-bit
// codes a word LSB-first; lengths int32 [rows]; out u64 [rows, s];
// k in [2, 15], s in [1, 2^20]. The plain version is sketch/minhash.py::
// sketch_batch_plain, bit for bit.
//
// What bounds it on this card: integer instructions. Built for sm_90a, a
// window's hashing is about 150 instructions (chip_smoke.py counts them
// from this kernel's SASS): some 78 on the int32 ALU pipe (LOP3, SHF,
// ISETP, IADD3, PRMT, LEA, SEL) and 63 on the FMA pipe (IMAD: the 64-bit
// multiplies of the murmur tail, and the compiler's moves and shifts),
// each pipe 64 a clock an SM, where the window reads a quarter of a
// byte: some 10^4 times the time of its bytes. The TPU program was
// written around the TPU's lack of u64 (u32 limb arithmetic, a tiled
// two-key sort over [B, L] intermediates in HBM). The first
// port of it sorted every tile of 4,096 hashes whole (a block radix
// sort over all 64 bits) to keep s of them: 77% of its time.
//
// What the design does about it: drop, select, then sort what survives.
// Every window is hashed once, in registers (a funnel shift of at most
// two packed words, __brev for the lexicographic form, __byte_perm for
// the key bytes); no [B, L] intermediate reaches device memory.
//  (a) select_kernel, for s <= kSelectMaxSketch: one block walks a row's
//      tiles of kTile windows in order (or one segment of them, below)
//      with tau, a bound such that at least s hashes seen lie at or below
//      it (the sentinel until then). A tile's keys >= tau are dropped in
//      registers; a key equal to it cannot change the multiset, nor can
//      a real hash equal to the sentinel, which only pads. Survivors are
//      appended unsorted to a shared buffer (a warp's ballot, one shared
//      atomic a warp). Where the next tile might not fit, a shared
//      histogram of 2,048 bins over [0, top] (top the largest value the
//      buffer may hold: tau - 1, or tau after an exact cut below; one
//      shared atomic a value) and one block scan find the bin at which
//      the held values reach s;
//      only the values at or below it stay (compacted in place, about s
//      plus a bin), and that bin's upper edge is the new tau. Where
//      duplicates keep the cut from making room, the buffer is sorted and
//      cut to s exactly. At the end of the segment one more cut, and the
//      kept values (about s) are placed in order of their bins by the
//      histogram's running counts, each bin's few values sorted by the
//      thread that owns it; where a bin is crowded (duplicates), a
//      bitonic sort instead (its strides below 64 synchronise a warp, not
//      the block). A row of 10 kb thus orders about s values once, where
//      the first port sorted 4,096 three times. The cut keeps every copy
//      of a tied value up to s: the multiset rule. Blocks of 256 threads,
//      four an SM, so that one block's cuts overlap others' hashing.
//  (b) Rows too few to fill the card (fewer than kFillBlocks) are split
//      into segments of at least kMinSegmentTiles tiles, a block each;
//      each segment writes its list (sentinel-padded to s) and the rows'
//      lists are merged pairwise in rounds (merge_kernel) until one is
//      left. A thread writes kPerThread consecutive outputs from a
//      merge-path split that it finds by a binary search in device
//      memory.
//  (c) s > kSelectMaxSketch, where s values and a tile's survivors would
//      not sit in shared memory: the first port's tiles_kernel, blocks of
//      512 threads that sort tiles of kSortTile = 4,096 windows whole in
//      shared memory (cub::BlockRadixSort, 32 KB of keys) and keep
//      min(kSortTile, s); the rounds of (b) merge them. The plan picks
//      the path from the shape before the launch (sketch/minhash_cuda.py::
//      plan mirrors it).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

namespace minhash {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // windows a block hashes at once
// the tile path (s > kSelectMaxSketch) keeps the first port's blocks: 512
// threads sorting tiles of 4,096
constexpr int kSortThreads = 512;
constexpr int kSortTile = kSortThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeThreads = 256;
constexpr int kPerThread = 8;  // consecutive outputs a merge thread writes
constexpr int kMaxSketch = 1 << 20;
constexpr u64 kSentinel = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned kFull = 0xFFFFFFFFu;
// "ACGT" as bytes 0..3: __byte_perm's selector i picks the character of
// 2-bit code i; selector 4 picks a zero byte (from y = 0)
constexpr uint32_t kAscii = 0x54474341u;
// the select path: s up to kSelectMaxSketch (s values and a tile's
// survivors in shared memory, a power of two: 128 KB at the largest; 32
// KB up to s = 2,048, so that four blocks share an SM), a
// histogram of kBins over [0, top]
constexpr int kSelectMaxSketch = 8192;
constexpr int kBinBits = 11;
constexpr int kBins = 1 << kBinBits;
constexpr int kBinsPerThread = kBins / kThreads;
// a bin of at most this many values is sorted by one thread at the end
constexpr int kSmallBin = 16;
// rows fewer than this many blocks (four on each of the H100's 132 SMs)
// are split into segments of at least kMinSegmentTiles tiles
constexpr int kFillBlocks = 4 * 132;
constexpr int kMinSegmentTiles = 4;

// stage bits of minhash_sketch's `stages`
constexpr int kStageTiles = 1;   // select_kernel, or tiles_kernel
constexpr int kStageMerge = 2;   // the merge rounds
constexpr int kStageHashOnly = 4;  // stage 1 hashing alone (timing)

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

// The selector nibbles of characters k..15 (a zero byte each).
__device__ __forceinline__ void key_pads(int k, uint32_t& pad_lo,
                                         uint32_t& pad_hi)
{
    pad_lo = pad_hi = 0;
    for (int i = k; i < 16; ++i) {
        if (i < 8)
            pad_lo |= 4u << (4 * i);
        else
            pad_hi |= 4u << (4 * (i - 8));
    }
}

// A block-wide exclusive sum of one int a thread (kThreads threads);
// `total` receives the sum of all. Synchronises the block twice.
__device__ __forceinline__ int block_exclusive_sum(int v, int* ws,
                                                   int& total)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o)
            x += y;
    }
    if (lane == 31)
        ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int z = lane < kWarps ? ws[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, z, o);
            if (lane >= o)
                z += y;
        }
        if (lane < kWarps)
            ws[lane] = z;
    }
    __syncthreads();
    total = ws[kWarps - 1];
    return x - v + (warp ? ws[warp - 1] : 0);
}

// Ascending bitonic sort of a[0, n) in shared memory, n a power of two.
// A stage of stride j < 64 exchanges within one warp's 64 values, so two
// such stages in a row need only __syncwarp. Ends synchronised.
__device__ __forceinline__ void bitonic_sort(u64* a, int n)
{
    for (int kk = 2; kk <= n; kk <<= 1) {
        for (int j = kk >> 1; j > 0; j >>= 1) {
            for (int p = threadIdx.x; p < (n >> 1); p += kThreads) {
                const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                const u64 x = a[i], y = a[i + j];
                if ((x > y) == ((i & kk) == 0)) {
                    a[i] = y;
                    a[i + j] = x;
                }
            }
            // this stage or the next one crosses warps
            if (j >= 64 || (j == 1 && kk >= 64))
                __syncthreads();
            else
                __syncwarp();
        }
    }
    __syncthreads();
}

// The shift that maps keys in [0, top] onto kBins bins by their top bits.
__device__ __forceinline__ int bin_shift(u64 top)
{
    const int bits = top ? 64 - __clzll((long long)top) : 0;
    return bits > kBinBits ? bits - kBinBits : 0;
}

// Candidates a select block holds: room for s values and one tile's
// survivors, a power of two (the bitonic sort's padding).
__host__ __device__ inline int select_capacity(int s)
{
    int cap = kTile;
    while (cap < s + kTile)
        cap <<= 1;
    return cap;
}

__host__ __device__ inline size_t select_smem_bytes(int s)
{
    return (size_t)select_capacity(s) * sizeof(u64) + kBins * sizeof(int);
}

struct SelectShared {
    int warp_sums[kWarps];
    int cut, kept, fill, most;
    u64 least[kWarps];
};

// The cut of c[0, fill) (keys <= top, `shift` its bin shift): the first
// bin at which the histogram's running count reaches s (the last bin
// where fill <= s), and the count through it. hist must be zero. Each
// thread reads its own bins into `mine` and leaves them zero, or with
// kOffsets each bin's running count before it (a scatter's cursors);
// returns the count before the thread's first bin.
template <bool kOffsets>
__device__ __forceinline__ int hist_cut(const u64* c, int fill, int shift,
                                        int s, int* hist, SelectShared& sh,
                                        int (&mine)[kBinsPerThread],
                                        int& cut, int& kept)
{
    for (int i = threadIdx.x; i < fill; i += kThreads)
        atomicAdd(&hist[(int)(c[i] >> shift)], 1);
    __syncthreads();
    int* own = hist + threadIdx.x * kBinsPerThread;
    int local = 0;
#pragma unroll
    for (int i = 0; i < kBinsPerThread; ++i) {
        mine[i] = own[i];
        local += mine[i];
    }
    int total;
    const int excl = block_exclusive_sum(local, sh.warp_sums, total);
    cut = kBins - 1;
    kept = total;
    if (total > s) {
        if (excl < s && excl + local >= s) {
            int run = excl;
#pragma unroll
            for (int i = 0; i < kBinsPerThread; ++i) {
                run += mine[i];
                if (run >= s) {
                    sh.cut = threadIdx.x * kBinsPerThread + i;
                    sh.kept = run;
                    break;
                }
            }
        }
        __syncthreads();
        cut = sh.cut;
        kept = sh.kept;
    }
    int run = excl;
#pragma unroll
    for (int i = 0; i < kBinsPerThread; ++i) {
        own[i] = kOffsets ? run : 0;
        run += mine[i];
    }
    return excl;
}

// Keeps the values of c[0, fill) whose bin is at most `cut`, in place, in
// chunks of kTile: a chunk is read into registers before any of its
// kept values is written, and writes land below the next chunk. Returns
// how many were kept. Ends synchronised.
__device__ __forceinline__ int compact_below(u64* c, int fill, int shift,
                                             int cut, SelectShared& sh)
{
    int out = 0;
    for (int base = 0; base < fill; base += kTile) {
        u64 v[kItems];
        int n = 0;
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
            const int i = base + it * kThreads + threadIdx.x;
            v[it] = i < fill ? c[i] : kSentinel;
            if (i < fill && (int)(v[it] >> shift) <= cut)
                ++n;
            else
                v[it] = kSentinel;
        }
        int total;
        int at = out + block_exclusive_sum(n, sh.warp_sums, total);
#pragma unroll
        for (int it = 0; it < kItems; ++it)
            if (v[it] != kSentinel)
                c[at++] = v[it];
        out += total;
        __syncthreads();
    }
    return out;
}

// Stage 1 of the select path: block b takes segment b % n_seg (tiles
// [seg n_tiles / n_seg, (seg + 1) n_tiles / n_seg)) of row b / n_seg,
// and writes its bottom-s list, sentinel-padded, to dst + b * s.
// Survivors (keys < tau) accumulate unsorted in c; where the next tile
// might not fit, a histogram cut keeps the values up to the bin at which
// they reach s, and the bin's upper edge becomes tau (at least s values
// lie below it). Where duplicates keep the cut from freeing a tile's
// room, c is sorted and cut to s exactly. At the segment's end one cut,
// and the kept values ordered by their bins (or sorted where a bin is
// crowded). kHashOnly: the hashing alone (each block writes its least
// hash to dst[b * s]; a measurement, not a sketch).
template <bool kHashOnly>
__global__ void __launch_bounds__(kThreads, 4)
select_kernel(const uint32_t* __restrict__ words,
              const int* __restrict__ lengths, int n_words, int k,
              int n_tiles, int n_seg, int s, u64* __restrict__ dst)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int cap = select_capacity(s);
    u64* c = (u64*)smem;              // cap candidates
    int* hist = (int*)(c + cap);      // kBins
    __shared__ SelectShared sh;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long b = blockIdx.x;
    const long long row = b / n_seg;
    const long long seg = b % n_seg;
    const long long len = min((long long)lengths[row], 16LL * n_words);
    const long long last = len - k;  // the last valid window
    const long long t0 = seg * n_tiles / n_seg;
    const long long t1 = (seg + 1) * n_tiles / n_seg;
    u64* d = dst + b * (long long)s;
    const uint32_t mask = (1u << (2 * k)) - 1u;
    uint32_t pad_lo, pad_hi;
    key_pads(k, pad_lo, pad_hi);
    const uint32_t* w = words + row * n_words;

    if (!kHashOnly) {
        for (int i = tid; i < kBins; i += kThreads)
            hist[i] = 0;
        if (tid == 0)
            sh.fill = sh.most = 0;
        __syncthreads();
    }
    int fill = 0;           // candidates held (uniform)
    u64 tau = kSentinel;    // every key >= tau is out (uniform)
    u64 top = kSentinel - 1;  // every candidate held is <= top (uniform)
    u64 least = kSentinel;  // kHashOnly
    for (long long t = t0; t < t1; ++t) {
        const long long base = t * kTile;
        if (base > last)
            break;
        if (!kHashOnly && fill + kTile > cap) {
            // fill > cap - kTile >= s: the cut keeps at least s
            const int shift = bin_shift(top);
            int mine[kBinsPerThread], cut, kept;
            hist_cut<false>(c, fill, shift, s, hist, sh, mine, cut, kept);
            if (cut < kBins - 1) {
                const u64 edge = (u64)(cut + 1) << shift;
                if (edge < tau) {
                    tau = edge;
                    top = edge - 1;
                }
            }
            fill = compact_below(c, fill, shift, cut, sh);
            if (fill + kTile > cap) {
                for (int i = fill + tid; i < cap; i += kThreads)
                    c[i] = kSentinel;
                __syncthreads();
                bitonic_sort(c, cap);
                fill = s;
                // the held values reach tau itself
                tau = top = c[s - 1];
            }
            if (tid == 0)
                sh.fill = fill;
            __syncthreads();
        }
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
            const long long j = base + it * kThreads + tid;
            const u64 key = j <= last ? hash_window(w, n_words, j, k, mask,
                                                    pad_lo, pad_hi)
                                      : kSentinel;
            if (kHashOnly) {
                least = min(least, key);
                continue;
            }
            const bool keep = key < tau;
            const unsigned ballot = __ballot_sync(kFull, keep);
            if (ballot) {
                int at = 0;
                if (lane == 0)
                    at = atomicAdd(&sh.fill, __popc(ballot));
                at = __shfl_sync(kFull, at, 0);
                if (keep)
                    c[at + __popc(ballot & ((1u << lane) - 1u))] = key;
            }
        }
        if (!kHashOnly) {
            __syncthreads();
            fill = sh.fill;
        }
    }
    if (kHashOnly) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            least = min(least, __shfl_xor_sync(kFull, least, o));
        if (lane == 0)
            sh.least[warp] = least;
        __syncthreads();
        if (tid == 0) {
            for (int i = 1; i < kWarps; ++i)
                least = min(least, sh.least[i]);
            d[0] = least;
        }
        return;
    }
    // the end: the cut, then the kept values placed in order of their
    // bins behind c (each bin's few values sorted by the thread that owns
    // it); where a bin is crowded (duplicates) or the kept values fill
    // more than half of c, compaction and a bitonic sort instead
    const int shift = bin_shift(top);
    int mine[kBinsPerThread], cut, kept;
    const int excl =
        hist_cut<true>(c, fill, shift, s, hist, sh, mine, cut, kept);
    // the most values a bin at or below the cut holds
    int most = 0;
#pragma unroll
    for (int i = 0; i < kBinsPerThread; ++i)
        if (tid * kBinsPerThread + i <= cut)
            most = max(most, mine[i]);
    if (most > kSmallBin)
        atomicMax(&sh.most, most);
    __syncthreads();
    if (sh.most <= kSmallBin && 2 * kept <= cap) {
        // behind the values: where c has no room behind all it holds,
        // behind the kept ones, compacted first
        if (fill + kept > cap)
            fill = compact_below(c, fill, shift, cut, sh);
        u64* o = c + fill;
        for (int i = tid; i < fill; i += kThreads) {
            const u64 v = c[i];
            const int bin = (int)(v >> shift);
            if (bin <= cut)
                o[atomicAdd(&hist[bin], 1)] = v;
        }
        __syncthreads();
        int start = excl;
#pragma unroll
        for (int i = 0; i < kBinsPerThread; ++i) {
            if (tid * kBinsPerThread + i <= cut && mine[i] > 1) {
                for (int a = start + 1; a < start + mine[i]; ++a) {
                    const u64 v = o[a];
                    int z = a - 1;
                    while (z >= start && o[z] > v) {
                        o[z + 1] = o[z];
                        --z;
                    }
                    o[z + 1] = v;
                }
            }
            start += mine[i];
        }
        __syncthreads();
        for (int i = tid; i < s; i += kThreads)
            d[i] = i < kept ? o[i] : kSentinel;
        return;
    }
    fill = compact_below(c, fill, shift, cut, sh);
    int n = 1;
    while (n < fill)
        n <<= 1;
    for (int i = fill + tid; i < n; i += kThreads)
        c[i] = kSentinel;
    __syncthreads();
    bitonic_sort(c, n);
    for (int i = tid; i < s; i += kThreads)
        d[i] = i < fill ? c[i] : kSentinel;
}

// Stage 1 of the path for s > kSelectMaxSketch: block b hashes and
// sorts tile b % n_tiles of row b / n_tiles and writes its first `keep`
// values, then sentinels up to `width`, to dst + b * width.
__global__ void __launch_bounds__(kSortThreads)
tiles_kernel(const uint32_t* __restrict__ words,
             const int* __restrict__ lengths, int n_words, int k,
             int n_tiles, int keep, int width, int sort,
             u64* __restrict__ dst)
{
    typedef cub::BlockRadixSort<u64, kSortThreads, kItems> Sort;
    __shared__ typename Sort::TempStorage temp;

    const long long b = blockIdx.x;
    const long long row = b / n_tiles;
    const long long base = (b % n_tiles) * (long long)kSortTile;
    const long long len = min((long long)lengths[row], 16LL * n_words);
    const long long last = len - k;  // the last valid window
    u64* d = dst + b * width;
    if (base > last) {
        for (int i = threadIdx.x; i < width; i += kSortThreads)
            d[i] = kSentinel;
        return;
    }
    const uint32_t mask = (1u << (2 * k)) - 1u;
    uint32_t pad_lo, pad_hi;
    key_pads(k, pad_lo, pad_hi);
    const uint32_t* w = words + row * n_words;
    // striped: item it of thread t is window base + it * kSortThreads + t
    u64 keys[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        const long long j = base + it * kSortThreads + threadIdx.x;
        keys[it] = j <= last ? hash_window(w, n_words, j, k, mask, pad_lo,
                                           pad_hi)
                             : kSentinel;
    }
    if (sort)
        Sort(temp).SortBlockedToStriped(keys);
    // striped: item it of thread t is rank it * kSortThreads + t
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        const int r = it * kSortThreads + threadIdx.x;
        if (r < keep)
            d[r] = keys[it];
    }
    for (int i = keep + threadIdx.x; i < width; i += kSortThreads)
        d[i] = kSentinel;
}

// Stage 2, one round: list pair (2p, 2p+1) of every row of src
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
    bool select;     // select_kernel (else tiles_kernel)
    int n_tiles;     // tiles a row (of kTile windows, or kSortTile)
    int n_lists;     // lists a row that stage 1 writes (segments or tiles)
    int keep;        // values a list
    long long ping;  // u64 of one ping-pong buffer, per row
};

// must agree with sketch/minhash_cuda.py::plan and scratch_elems
__host__ Plan make_plan(int n_rows, int n_words, int k, int s)
{
    Plan p;
    const long long windows = 16LL * n_words - k + 1;
    p.select = s <= kSelectMaxSketch;
    const int tile = p.select ? kTile : kSortTile;
    p.n_tiles = (int)((windows + tile - 1) / tile);
    if (p.select) {
        p.n_lists = 1;
        if (n_rows < kFillBlocks) {
            const int want = (kFillBlocks + n_rows - 1) / n_rows;
            const int most = p.n_tiles / kMinSegmentTiles;
            p.n_lists = want < most ? want : most;
            if (p.n_lists < 1)
                p.n_lists = 1;
        }
        p.keep = s;
    } else {
        p.n_lists = p.n_tiles;
        p.keep = s < kSortTile ? s : kSortTile;
    }
    p.ping = 0;
    long long n = p.n_lists, len = p.keep;
    while (n > 1) {
        n = (n + 1) / 2;
        len = 2 * len < s ? 2 * len : s;
        if (n > 1 && n * len > p.ping)
            p.ping = n * len;
    }
    return p;
}

template <bool kHashOnly>
cudaError_t launch_select(const Plan& p, const uint32_t* words,
                          const int* lengths, int n_rows, int n_words, int k,
                          int s, u64* dst, cudaStream_t st)
{
    const size_t smem = select_smem_bytes(s);
    cudaError_t e = cudaFuncSetAttribute(
        select_kernel<kHashOnly>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess)
        return e;
    select_kernel<kHashOnly>
        <<<(unsigned)((long long)n_rows * p.n_lists), kThreads, smem, st>>>(
            words, lengths, n_words, k, p.n_tiles, p.n_lists, s, dst);
    return cudaGetLastError();
}

}  // namespace minhash

// Sketches `n_rows` rows on `stream` without synchronizing; returns
// cudaGetLastError() after each launch (0 on success). Device pointers:
// words int32 [n_rows, n_words] and lengths int32 [n_rows], contiguous;
// out u64 [n_rows, s]; scratch u64 [scratch_elems], at least n_rows x
// (lists x keep + 2 x ping) (sketch/minhash_cuda.py::scratch_elems; 0
// when a row is one list). `stages`: 1 stage 1 (select_kernel, or
// tiles_kernel where s > kSelectMaxSketch), 2 the merge rounds on the
// lists that a stage 1 left in scratch, 3 both, 5 stage 1's hashing alone
// (a measurement; the result is not a sketch).
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
    const Plan p = make_plan(n_rows, n_words, k, s);
    const long long lists_elems = (long long)p.n_lists * p.keep;
    const long long need =
        p.n_lists > 1 ? n_rows * (lists_elems + 2 * p.ping) : 0;
    if (scratch_elems < need)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    u64* lists = (u64*)scratch;
    u64* ping[2] = {lists + n_rows * lists_elems,
                    lists + n_rows * (lists_elems + p.ping)};
    u64* o = (u64*)out;
    const bool direct = p.n_lists == 1;
    if (stages & kStageTiles) {
        const uint32_t* w = (const uint32_t*)words;
        const int* len = (const int*)lengths;
        cudaError_t e;
        if (p.select && (stages & kStageHashOnly))
            e = launch_select<true>(p, w, len, n_rows, n_words, k, s,
                                    direct ? o : lists, st);
        else if (p.select)
            e = launch_select<false>(p, w, len, n_rows, n_words, k, s,
                                     direct ? o : lists, st);
        else {
            tiles_kernel<<<(unsigned)((long long)n_rows * p.n_tiles),
                           kSortThreads, 0, st>>>(
                w, len, n_words, k, p.n_tiles, p.keep, direct ? s : p.keep,
                (stages & kStageHashOnly) ? 0 : 1, direct ? o : lists);
            e = cudaGetLastError();
        }
        if (e != cudaSuccess)
            return (int)e;
    }
    if ((stages & kStageMerge) && !direct) {
        const u64* src = lists;
        int n_src = p.n_lists, len_src = p.keep, round = 0;
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
