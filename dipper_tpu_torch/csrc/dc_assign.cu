// D&C phase 2's cluster assignment on Hopper (sm_90a), kernel 10: the
// chosen backbone edge of every row of a chunk of distance rows, in one
// launch, scored over packed records of the backbone's valid slots.
//
// Replaces the JAX package's _phase2_all and _phase2_chunk_{mash,matrix,
// msa} (dipper_tpu/dc/pipeline.py:57-133), an XLA program (no Pallas): a
// vmap of kclosest.score_edges (dipper_tpu/placement/kclosest.py:374) over
// the chunk's rows, which the TPU ran as a [Q, E, 5] witness gather and
// some twenty passes over [Q, E]. Its plain versions are placement/
// kclosest.py::score_edges_rows_plain (the assignment) and
// pack_slots_plain (the records); dc/assign_model.py models this schedule
// (change the two together).
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
// Two kernels, one launch each:
// - dc_assign_pack, once a phase (the state is final after phase 1): a
//   block a tile of kPackTile slots compacts the tile's valid slots, in
//   ascending slot order, into records of one length. A record holds the
//   slot's five witness ids and distances, its reverse slot's, its length
//   and the slot itself (so that `before` breaks ties as on the slots). Ids
//   are uint16 where the row width is at most 65,535 (0xFFFF codes an empty
//   entry), else int32 (-1); the record is padded with zeros to a multiple
//   of 16 bytes: 80 bytes in f32 with uint16 ids, 112 in f64. A block
//   learns where its records start by a decoupled look-back over the
//   earlier tiles' counts in a workspace (its tile the ticket it draws, so
//   that every earlier tile has started); the last block to finish writes
//   meta[0], the record count, and meta[1], the lowest invalid slot
//   (INT_MAX if none), which stands for every invalid slot, since they all
//   score 2.0. Both stay on the device: no host sync.
// - dc_assign: every block owns R rows ("a row group") and walks every
//   record once for them. The records reach shared memory through a ring
//   of `stages` tiles of kTileRecords, each tile one bulk copy by the
//   Tensor Memory Accelerator (cp.async.bulk, completion counted in bytes
//   on the stage's `full` mbarrier). The blocks run as thread-block
//   clusters of C = kClusterCtas (or 1, forced): block 0's producer warp
//   issues each tile once, multicast to the C blocks, so the records cross
//   L2 once for C row groups. A block's consumer warps take the tiles'
//   32-record slices in order from a counter in shared memory, a record a
//   lane, copy it into registers, and release the stage at block 0's
//   `empty` mbarrier (C x 2 arrivals; the stage's first consumer re-arms
//   its own `full` barrier for the stage's next tile). A warp awaits a
//   stage's use only once its block has consumed every slice of the
//   stage's earlier uses (a count a stage in shared memory), so that a
//   parity wait never names a use two phases ahead. The producer re-fills
//   a stage once every block of the cluster has released it, so the next
//   tiles arrive while the current ones are scored.
//   Rows sit in shared memory transposed, [width][R], so that one witness
//   id fetches the R values of the group in one 8- or 16-byte load (two or
//   four for R = 8 or f64): R = 8, 4 or 2 rows a block of 16 consumer
//   warps, the largest R whose two row buffers and kPlanStages stages fit
//   227 KB; else one row a block of 31 consumer warps (1,024 threads with
//   the producer), two buffers where they fit, else one. Its ring takes
//   kRingRowBytes / (R x item) stages, as many as fit up to kMaxStages:
//   the fewer row values a record's witness fetches, the sooner the warps
//   are done with a record, so the more records must be in flight (4 at R
//   = 8 in f32, 8 at R = 4, all that fit at one row). f64 rows wider than
//   that (B > 27,152) are read from device memory through the read-only
//   path (kGlobalRows a block, a ring of kGlobalStages), over the same
//   records. The grid is
//   persistent: each cluster walks row groups cluster, cluster + n, ...
//   (n resident clusters, cudaOccupancyMaxActiveClusters), and with two
//   row buffers the next group's rows arrive by cp.async while the
//   current ones are scored. Each lane keeps a candidate a row; a row's
//   candidates meet by warp shuffles and then across the consumer warps
//   with the invalid slots' candidate, and lane 0 of warp r writes row
//   r's slot. A candidate is (key, slot), the key its score or -1 for NaN
//   (scores are >= 0 otherwise), so that (key, slot) ascending is the
//   order of `before`; the minimum is over a total order, so the order in
//   which slices are taken does not change it. The score is
//   edge_score.cuh's edge_score_only: edge_score's operations, with
//   clamps (and the sides' maxima) by max_nan, one instruction in f32.
//
// What bounds it: the operations, about 35 a row and valid record, and the
// shared-memory gathers of the witnesses' values (random over the row, so
// several bank wavefronts a warp load); at one row a block (B = 50,000,
// f32) also the ring's bytes in flight against the latency of a tile's
// copy, the row leaving 25-31 KB of shared memory for it.
//
// No fallback: a cluster launch that finds no room, a refused cluster size
// or instance returns a CUDA error, which the wrapper raises.

#include "edge_score.cuh"

#include <map>
#include <mutex>
#include <tuple>

namespace {

using namespace dipper;

// consumer warps of a block that holds R >= 2 rows or reads its rows from
// device memory, and of a block that holds one row; each block has one
// producer warp more
constexpr int kConsumerWarps = 16;
constexpr int kOneRowWarps = 31;
// records of a tile (one bulk copy) and of a slice (one warp, a record a
// lane)
constexpr int kTileRecords = 64;
constexpr int kSliceRecords = 32;
constexpr int kSlicesPerTile = kTileRecords / kSliceRecords;
// ring stages: a plan takes R rows where two row buffers and kPlanStages
// stages fit; its ring then takes kRingRowBytes / (R x item) stages as
// fit up to kMaxStages (at least kMinStages with one buffer), or
// kGlobalStages where its rows are read from device memory
constexpr int kPlanStages = 8;
constexpr int kRingRowBytes = 128;
constexpr int kGlobalStages = 4;
constexpr int kMaxStages = 16;
constexpr int kMinStages = 2;
// blocks of a cluster (the plan's; a launch may force 1)
constexpr int kClusterCtas = 2;
// a block's dynamic shared memory at most (an H100 block's 227 KB)
constexpr long long kSmemBytes = 227 * 1024;
// bytes before the partial minima: the stages' mbarriers, the slice
// counter and the stages' counts of consumed slices
constexpr int kBarrierBytes = 512;
// rows a block where the rows are read from device memory
constexpr int kGlobalRows = 2;
// widest row whose ids fit uint16 (0xFFFF codes an empty entry)
constexpr int kMaxId16Width = 65535;
constexpr int kPackThreads = 256;
constexpr int kPackSlots = 4;  // consecutive slots a pack thread takes
constexpr int kPackTile = kPackThreads * kPackSlots;  // slots a pack block
constexpr double kSentDis = 2.0;

__host__ __device__ constexpr int align_up(int x, int a)
{
    return (x + a - 1) / a * a;
}

// A record's layout: the 2K ids, the slot, the length, the 2K distances,
// zeros to a multiple of 16 bytes
__host__ __device__ constexpr int slot_offset(int id_bytes)
{
    return 2 * kK * id_bytes;
}
__host__ __device__ constexpr int length_offset(int id_bytes, int item)
{
    return align_up(slot_offset(id_bytes) + 4, item);
}
__host__ __device__ constexpr int dist_offset(int id_bytes, int item)
{
    return length_offset(id_bytes, item) + item;
}
__host__ __device__ constexpr int record_bytes(int id_bytes, int item)
{
    return align_up(dist_offset(id_bytes, item) + 2 * kK * item, 16);
}

// bytes before the ring: barriers, counter, the partial minima of `warps`
// warps x R rows (a T score and an int slot each)
__host__ __device__ constexpr int head_bytes(int warps, int rows, int item)
{
    return align_up(kBarrierBytes + warps * rows * (item + 4), 128);
}

template <int R, bool Staged>
__host__ __device__ constexpr int warps_of()
{
    return Staged && R == 1 ? kOneRowWarps : kConsumerWarps;
}

template <typename T, typename Id>
struct Rec {
    static constexpr int kIdBytes = (int)sizeof(Id);
    static constexpr int kItem = (int)sizeof(T);
    static constexpr int kBytes = record_bytes(kIdBytes, kItem);
    static constexpr int kWords = kBytes / 4;
    static constexpr int kSlotWord = slot_offset(kIdBytes) / 4;
    static constexpr int kLenWord = length_offset(kIdBytes, kItem) / 4;
    static constexpr int kDistWord = dist_offset(kIdBytes, kItem) / 4;

    // entry j's id, -1 where empty
    __device__ __forceinline__ static int id(const uint32_t (&w)[kWords],
                                             int j)
    {
        if constexpr (kIdBytes == 2) {
            const int v = (w[j >> 1] >> ((j & 1) * 16)) & 0xFFFF;
            return v == 0xFFFF ? -1 : v;
        } else {
            return (int)w[j];
        }
    }
    __device__ __forceinline__ static T value(const uint32_t (&w)[kWords],
                                              int word)
    {
        if constexpr (kItem == 4)
            return __uint_as_float(w[word]);
        else
            return __hiloint2double((int)w[word + 1], (int)w[word]);
    }
    __device__ __forceinline__ static void put(uint32_t (&w)[kWords],
                                               int word, T v)
    {
        if constexpr (kItem == 4) {
            w[word] = __float_as_uint(v);
        } else {
            w[word] = (uint32_t)__double2loint(v);
            w[word + 1] = (uint32_t)__double2hiint(v);
        }
    }
};

// ---- PTX: shared-memory addresses, mbarriers, bulk copies, clusters ----

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

// one arrival that also expects `bytes` more to land in this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
}

// a wait longer than this many clock cycles (~10 s) traps: a launch that
// breaks the ring's protocol fails instead of holding the card
constexpr long long kWaitTrapCycles = 20000000000LL;

// waits until the phase of parity `parity` of the barrier has completed;
// acquire at the cluster's scope where other blocks arrive on it
template <bool Cluster>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done = 0;
    const long long t0 = clock64();
    do {
        if (clock64() - t0 > kWaitTrapCycles) __trap();
        if constexpr (Cluster)
            asm volatile(
                "{\n.reg .pred p;\n"
                "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                "p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(bar), "r"(parity)
                : "memory");
        else
            asm volatile(
                "{\n.reg .pred p;\n"
                "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                "selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(bar), "r"(parity)
                : "memory");
    } while (!done);
}

// one arrival on the barrier at the same offset in block `cta` of the
// cluster
__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, uint32_t cta)
{
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(bar), "r"(cta));
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
        ::"r"(remote)
        : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory to the
// same 16-byte aligned offset of the shared memory of the blocks in
// `mask` (bit k: block k of the cluster), counted on each block's
// barrier at `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint16_t mask)
{
    if (mask == 1)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
            "l"(src), "r"(bytes), "r"(bar)
            : "memory");
    else
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
            "l"(src), "r"(bytes), "r"(bar), "h"(mask)
            : "memory");
}

__device__ __forceinline__ void cluster_sync_all()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::
                     : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank()
{
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_size()
{
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return r;
}

// the consumer warps' barrier (the producer warp never waits at it)
__device__ __forceinline__ void consumers_sync(int threads)
{
    asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <int Bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(Bytes)
                 : "memory");
}

__device__ __forceinline__ void async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the pack ----

// A tile's status word in the pack's workspace: the flag in the high 32
// bits (0 nothing yet, kTileCount the tile's own count, kTilePrefix the
// count of every slot up to and including the tile), the count below
constexpr unsigned long long kTileCount = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p)
{
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v)
{
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
                 : "memory");
}

// The pack's workspace (zeroed before the launch): a status word a tile,
// then the tickets drawn, the blocks finished and INT_MAX minus the lowest
// invalid slot (0: none yet)
struct PackWork {
    unsigned long long* status;
    unsigned* ticket;
    unsigned* done;
    unsigned* invalid;
};

// The records of the tile's valid slots before it: warp 0 reads the
// status of the 32 tiles below a window's top, waits until each has a
// flag, and sums the counts down to the nearest tile with a prefix (a
// tile below tile 0 reads as a prefix of 0), moving the window down while
// none has one.
__device__ __forceinline__ unsigned look_back(
    unsigned long long* status, int tile, int lane)
{
    unsigned below = 0;
    for (int top = tile - 1;; top -= kWarp) {
        const int k = top - lane;
        unsigned long long v = k >= 0 ? ld_relaxed(status + k) : kTilePrefix;
        const long long t0 = clock64();
        while (__any_sync(0xffffffffu, v < kTileCount)) {
            if (clock64() - t0 > kWaitTrapCycles) __trap();
            if (v < kTileCount) v = ld_relaxed(status + k);
        }
        const unsigned prefix = __ballot_sync(0xffffffffu, v >= kTilePrefix);
        // lane l reads tile top - l: the nearest prefix is the lowest lane
        const int stop = prefix ? __ffs(prefix) - 1 : kWarp - 1;
        unsigned n = lane <= stop ? (unsigned)v : 0u;
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2)
            n += __shfl_xor_sync(0xffffffffu, n, off);
        below += n;
        if (prefix) return below;
    }
}

template <typename T, typename Id>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const int32_t* __restrict__ cid, const T* __restrict__ cdis,
            const int32_t* __restrict__ belong,
            const int32_t* __restrict__ dst, const int32_t* __restrict__ rev,
            const T* __restrict__ length, int n_edges,
            uint4* __restrict__ records, int32_t* __restrict__ meta,
            const PackWork w)
{
    using RecT = Rec<T, Id>;
    __shared__ int s_warp[kPackThreads / kWarp];
    __shared__ int s_tile, s_invalid;
    __shared__ unsigned s_below;
    const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
    const int n_tiles = gridDim.x;
    if (tid == 0) {
        s_tile = (int)atomicAdd(w.ticket, 1u);
        s_invalid = INT_MAX;
    }
    __syncthreads();
    const int tile = s_tile;
    const int s0 = tile * kPackTile + tid * kPackSlots;
    bool valid[kPackSlots];
    int n = 0, first_invalid = INT_MAX;
#pragma unroll
    for (int p = 0; p < kPackSlots; ++p) {
        const int s = s0 + p;
        valid[p] = s < n_edges && __ldg(belong + s) > __ldg(dst + s);
        if (s < n_edges && !valid[p]) first_invalid = min(first_invalid, s);
        n += valid[p];
    }
    if (first_invalid != INT_MAX) atomicMin(&s_invalid, first_invalid);
    // the block's exclusive scan of the counts
    int inc = n;
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += v;
    }
    if (lane == kWarp - 1) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int v = lane < kPackThreads / kWarp ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 1; off < kWarp; off *= 2) {
            const int u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (lane < kPackThreads / kWarp) s_warp[lane] = v;  // inclusive
        const unsigned count = (unsigned)__shfl_sync(
            0xffffffffu, v, kPackThreads / kWarp - 1);
        // publish the tile's count, then its prefix once the tiles below
        // are known
        unsigned below = 0;
        if (tile > 0) {
            if (lane == 0) st_relaxed(w.status + tile, kTileCount | count);
            below = look_back(w.status, tile, lane);
        }
        if (lane == 0) {
            st_relaxed(w.status + tile, kTilePrefix | (below + count));
            s_below = below;
        }
    }
    __syncthreads();
    int at = (int)s_below + (warp > 0 ? s_warp[warp - 1] : 0) + inc - n;
#pragma unroll
    for (int p = 0; p < kPackSlots; ++p) {
        if (!valid[p]) continue;
        const int s = s0 + p, r = __ldg(rev + s);
        uint32_t v[RecT::kWords];
#pragma unroll
        for (int i = 0; i < RecT::kWords; ++i) v[i] = 0;
#pragma unroll
        for (int j = 0; j < 2 * kK; ++j) {
            const size_t x = (size_t)(j < kK ? s : r) * kK + j % kK;
            const int c = __ldg(cid + x);
            if constexpr (RecT::kIdBytes == 2)
                v[j >> 1] |= (uint32_t)(c < 0 ? 0xFFFF : c) << ((j & 1) * 16);
            else
                v[j] = (uint32_t)c;
            RecT::put(v, RecT::kDistWord + j * RecT::kItem / 4,
                      __ldg(cdis + x));
        }
        v[RecT::kSlotWord] = (uint32_t)s;
        RecT::put(v, RecT::kLenWord, __ldg(length + s));
        uint4* out = records + (size_t)at * (RecT::kBytes / 16);
#pragma unroll
        for (int i = 0; i < RecT::kBytes / 16; ++i)
            out[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                v[4 * i + 3]);
        ++at;
    }
    // the last block to finish writes meta: the count below the last tile
    // and its own, the lowest invalid slot of all
    if (tid == 0) {
        if (s_invalid != INT_MAX)
            atomicMax(w.invalid, (unsigned)(INT_MAX - s_invalid));
        __threadfence();
        if (atomicAdd(w.done, 1u) == (unsigned)n_tiles - 1) {
            __threadfence();
            const unsigned long long last =
                ld_relaxed(w.status + n_tiles - 1);
            const unsigned inv = atomicAdd(w.invalid, 0u);
            meta[0] = (int32_t)(unsigned)last;
            meta[1] = inv ? INT_MAX - (int)inv : INT_MAX;
        }
    }
}

// ---- the assignment ----

// the R values of witness `c` for the group's rows: one vector load from
// the transposed rows in shared memory, or R loads from device memory
template <typename T, int R, bool Staged>
__device__ __forceinline__ void load_values(const T* rows, long long stride,
                                            int c, int n_mine, T (&v)[R])
{
    if constexpr (!Staged) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            v[r] = r < n_mine ? __ldg(rows + r * stride + c) : T(0);
    } else if constexpr (R * sizeof(T) >= 16) {
        const uint4* p = reinterpret_cast<const uint4*>(rows + (size_t)c * R);
#pragma unroll
        for (int i = 0; i < (int)(R * sizeof(T) / 16); ++i) {
            const uint4 x = p[i];
            if constexpr (sizeof(T) == 4) {
                v[4 * i] = __uint_as_float(x.x);
                v[4 * i + 1] = __uint_as_float(x.y);
                v[4 * i + 2] = __uint_as_float(x.z);
                v[4 * i + 3] = __uint_as_float(x.w);
            } else {
                v[2 * i] = __hiloint2double((int)x.y, (int)x.x);
                v[2 * i + 1] = __hiloint2double((int)x.w, (int)x.z);
            }
        }
    } else if constexpr (R == 2) {
        const float2 x = *reinterpret_cast<const float2*>(rows + 2 * c);
        v[0] = x.x;
        v[1] = x.y;
    } else {
        v[0] = rows[c];
    }
}

// A candidate's key: its score, or -1 for a NaN score. Scores are >= 0 or
// NaN, so (key, slot) ascending is the order of torch.argmin (NaN first,
// the lower slot at equal scores).
template <typename T>
__device__ __forceinline__ T key_of(T score)
{
    return score != score ? T(-1) : score;
}

// (key, slot) of the lower of two candidates
template <typename T>
__device__ __forceinline__ bool key_before(T k, int s, T k2, int s2)
{
    return k < k2 || (k == k2 && s < s2);
}

// the minimum (key, slot) over one warp, every lane getting it
template <typename T>
__device__ __forceinline__ void warp_key_min(T* k, int* s)
{
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
        const T k2 = __shfl_xor_sync(0xffffffffu, *k, off);
        const int s2 = __shfl_xor_sync(0xffffffffu, *s, off);
        if (key_before(k2, s2, *k, *s)) {
            *k = k2;
            *s = s2;
        }
    }
}

// One record scored against the group's rows, each row's candidate kept
// as (key, slot). A thread's records ascend in slot order (it takes its
// slices in order), so a strictly lower key alone replaces a candidate
// once it holds one (slot INT_MAX: none yet).
template <typename T, typename Id, int R, bool Staged>
__device__ __forceinline__ void score_record(
    const uint32_t (&w)[Rec<T, Id>::kWords], const T* rows, long long stride,
    int n_mine, T (&best)[R], int (&slot_of)[R])
{
    using RecT = Rec<T, Id>;
    // side(): the maximum of the used entries' differences, NaN sticking
    // (the plain version's amax), then clamped at 0
    T m1[R], m2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m1[r] = m2[r] = T(-INFINITY);
#pragma unroll
    for (int j = 0; j < 2 * kK; ++j) {
        const int c = RecT::id(w, j);
        if (c < 0) continue;
        const T d = RecT::value(w, RecT::kDistWord + j * RecT::kItem / 4);
        T v[R];
        load_values<T, R, Staged>(rows, stride, c, n_mine, v);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            T& m = j < kK ? m1[r] : m2[r];
            m = max_nan(m, sub_rn(v[r], d));
        }
    }
    const T len = RecT::value(w, RecT::kLenWord);
    const int slot = (int)w[RecT::kSlotWord];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const T key = key_of(edge_score_only(max_nan(m1[r], T(0)),
                                             max_nan(m2[r], T(0)), len));
        if (key < best[r] || slot_of[r] == INT_MAX) {
            best[r] = key;
            slot_of[r] = slot;
        }
    }
}

template <typename T>
struct AssignArgs {
    const unsigned char* records;
    const int32_t* meta;
    const T* rows;
    long long row_stride;
    int n_rows, width, buffers, stages;
    long long* out;
};

template <typename T, typename Id, int R, bool Staged>
__global__ void __launch_bounds__((warps_of<R, Staged>() + 1) * kWarp, 1)
assign_kernel(const AssignArgs<T> a)
{
    using RecT = Rec<T, Id>;
    constexpr int NW = warps_of<R, Staged>();
    constexpr int NC = NW * kWarp;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t full0 = smem_u32(smem);
    const uint32_t empty0 = full0 + 8 * kMaxStages;
    int* s_next = reinterpret_cast<int*>(smem + 16 * kMaxStages);
    unsigned* s_used =
        reinterpret_cast<unsigned*>(smem + 16 * kMaxStages + 4);
    T* s_score = reinterpret_cast<T*>(smem + kBarrierBytes);
    int* s_slot = reinterpret_cast<int*>(s_score + NW * R);
    unsigned char* ring = smem + head_bytes(NW, R, (int)sizeof(T));
    constexpr int kStageBytes = kTileRecords * RecT::kBytes;
    T* s_rows = reinterpret_cast<T*>(ring + a.stages * kStageBytes);

    const int C = (int)cluster_size(), rank = (int)cluster_rank();
    const int cluster = blockIdx.x / C, n_clusters = gridDim.x / C;
    const int n_rec = __ldg(a.meta), first_invalid = __ldg(a.meta + 1);
    const int n_tiles = (n_rec + kTileRecords - 1) / kTileRecords;
    const int n_groups = (a.n_rows + R - 1) / R;
    const int n_super = (n_groups + C - 1) / C;
    const int rounds =
        cluster < n_super ? (n_super - cluster + n_clusters - 1) / n_clusters
                          : 0;
    const long long total = (long long)rounds * n_tiles;
    const int S = a.stages;
    // bytes of the tile that use u of the ring carries (tile u % n_tiles)
    auto tile_bytes = [&](int tile) {
        return (uint32_t)(min(kTileRecords, n_rec - tile * kTileRecords)
                          * RecT::kBytes);
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, C * kSlicesPerTile);
        }
        *s_next = 0;
        for (int s = 0; s < kMaxStages; ++s) s_used[s] = 0;
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int u = 0; u < S && u < total; ++u)
            mbar_expect(full0 + 8 * u, tile_bytes(u % n_tiles));
    }
    cluster_sync_all();

    if (threadIdx.x >= NC) {
        // the producer: block 0's first lane issues every tile of every
        // round, a stage once all C blocks have released its last tile
        if (rank == 0 && threadIdx.x == NC) {
            int s = 0, tile = 0;
            uint32_t phase = 0;
            const uint16_t mask = (uint16_t)((1u << C) - 1);
            for (long long u = 0; u < total; ++u) {
                if (u >= S) mbar_wait<true>(empty0 + 8 * s, phase ^ 1);
                bulk_copy(smem_u32(ring + s * kStageBytes),
                          a.records + (size_t)tile * kStageBytes,
                          tile_bytes(tile), full0 + 8 * s, mask);
                if (++tile == n_tiles) tile = 0;
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        __syncwarp();
        cluster_sync_all();
        return;
    }

    const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
    const int slices = n_tiles * kSlicesPerTile;
    auto group_of = [&](int rd) {
        return (cluster + rd * n_clusters) * C + rank;
    };
    // round rd's rows into buffer `buf`, transposed ([width][R]), one
    // cp.async an element; a commit in every thread whatever it copied
    auto stage_rows = [&](int rd, int buf) {
        const int g = group_of(rd);
        if (g < n_groups) {
            const int row0 = g * R, n = min(R, a.n_rows - row0);
            T* d = s_rows + (size_t)buf * R * a.width;
            const T* src = a.rows + (long long)row0 * a.row_stride;
            for (int r = 0; r < n; ++r)
                for (int c = tid; c < a.width; c += NC)
                    copy_async<(int)sizeof(T)>(d + (size_t)c * R + r,
                                               src + r * a.row_stride + c);
        }
        async_commit();
    };

    if (Staged && rounds > 0) stage_rows(0, 0);
    for (int rd = 0; rd < rounds; ++rd) {
        const int buf = a.buffers == 2 ? (rd & 1) : 0;
        if (Staged) {
            if (a.buffers == 2 && rd + 1 < rounds) {
                stage_rows(rd + 1, (rd + 1) & 1);
                async_wait<1>();
            } else {
                async_wait<0>();
            }
        }
        consumers_sync(NC);
        const int g = group_of(rd), row0 = g * R;
        const int n_mine = g < n_groups ? min(R, a.n_rows - row0) : 0;
        const T* rows = Staged ? s_rows + (size_t)buf * R * a.width
                               : a.rows + (long long)row0 * a.row_stride;
        T best[R];
        int best_slot[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            best[r] = T(INFINITY);
            best_slot[r] = INT_MAX;
        }
        // this round's first use of the ring: its stage and phase
        const long long base = (long long)rd * n_tiles;
        const int base_s = (int)(base % S);
        const uint32_t base_ph = (uint32_t)((base / S) & 1);
        for (;;) {
            int q = 0;
            if (lane == 0) q = atomicAdd(s_next, 1);
            q = __shfl_sync(0xffffffffu, q, 0);
            if (q >= slices) break;
            const int i = q / kSlicesPerTile, j = q % kSlicesPerTile;
            const int t = base_s + i, s = t % S;
            // slices are taken in order but finish out of order: before a
            // stage's use n is awaited by parity, this block must have
            // consumed every slice of its uses before n, so that the
            // parity names use n and not n - 2
            if (lane == 0) {
                const unsigned need = (unsigned)(kSlicesPerTile
                                                 * ((base + i) / S));
                const long long t0 = clock64();
                while (*reinterpret_cast<volatile unsigned*>(s_used + s)
                       < need)
                    if (clock64() - t0 > kWaitTrapCycles) __trap();
            }
            __syncwarp();
            mbar_wait<false>(full0 + 8 * s, (base_ph + t / S) & 1);
            if (j == 0 && lane == 0 && base + i + S < total)
                mbar_expect(full0 + 8 * s, tile_bytes((i + S) % n_tiles));
            const int k = i * kTileRecords + j * kSliceRecords + lane;
            uint32_t w[RecT::kWords];
            if (k < n_rec) {
                const uint4* src = reinterpret_cast<const uint4*>(
                    ring + s * kStageBytes
                    + (j * kSliceRecords + lane) * RecT::kBytes);
#pragma unroll
                for (int v = 0; v < RecT::kBytes / 16; ++v) {
                    const uint4 x = src[v];
                    w[4 * v] = x.x;
                    w[4 * v + 1] = x.y;
                    w[4 * v + 2] = x.z;
                    w[4 * v + 3] = x.w;
                }
            }
            __syncwarp();
            if (lane == 0) {
                atomicAdd(s_used + s, 1u);
                mbar_arrive_cta(empty0 + 8 * s, 0);
            }
            if (k < n_rec && n_mine > 0)
                score_record<T, Id, R, Staged>(w, rows, a.row_stride, n_mine,
                                               best, best_slot);
        }
        // the rows' minima: each warp's, then across the warps, then with
        // the invalid slots' candidate (key 2.0)
#pragma unroll
        for (int r = 0; r < R; ++r) {
            warp_key_min(&best[r], &best_slot[r]);
            if (lane == 0) {
                s_score[warp * R + r] = best[r];
                s_slot[warp * R + r] = best_slot[r];
            }
        }
        consumers_sync(NC);
        if (warp < R) {
            T k = T(INFINITY);
            int sl = INT_MAX;
            if (lane < NW) {
                k = s_score[lane * R + warp];
                sl = s_slot[lane * R + warp];
            }
            warp_key_min(&k, &sl);
            if (lane == 0 && warp < n_mine) {
                if (first_invalid != INT_MAX
                    && key_before(T(kSentDis), first_invalid, k, sl))
                    sl = first_invalid;
                a.out[row0 + warp] = sl;
            }
        }
        if (tid == 0) *s_next = 0;
        if (Staged && a.buffers == 1 && rd + 1 < rounds) stage_rows(rd + 1, 0);
    }
    cluster_sync_all();
}

// ---- plans and launches ----

struct Plan {
    int rows, staged, buffers, threads, tile, stages, cluster;
    long long smem;
    int record_bytes, id_bytes;
};

int id_bytes_of(int width) { return width <= kMaxId16Width ? 2 : 4; }

// The ring's stages that fit `room` bytes beside the rest: at most `most`,
// at most `stages` where that is >= 0.
int stages_in(long long room, long long stage, int most, int stages)
{
    long long n = room > 0 ? room / stage : 0;
    if (n > most) n = most;
    if (stages >= 0 && n > stages) n = stages;
    return (int)n;
}

// A staged plan of R rows a block at `width` x `item`, if it fits: two row
// buffers where they fit beside kPlanStages stages, else (R = 1) one
// buffer beside at least kMinStages; then a ring of kRingRowBytes / (R x
// item) stages as fit, up to kMaxStages (`stages` >= 0 asks for exactly
// that many).
bool staged_plan(int R, int width, int item, int cluster, int stages,
                 Plan* p)
{
    const int warps = R == 1 ? kOneRowWarps : kConsumerWarps;
    const int idb = id_bytes_of(width), rec = record_bytes(idb, item);
    const long long head = head_bytes(warps, R, item);
    const long long stage = (long long)kTileRecords * rec;
    const long long row = (long long)R * width * item;
    const int least = stages >= 0 ? stages : kPlanStages;
    int buffers = 2;
    if (head + least * stage + 2 * row > kSmemBytes) {
        if (R != 1) return false;
        buffers = 1;
    }
    const int ring = kRingRowBytes / (R * item);
    const int n = stages_in(kSmemBytes - head - buffers * row, stage,
                            stages >= 0 || ring > kMaxStages ? kMaxStages
                                                             : ring,
                            stages);
    if (n < kMinStages || (stages >= 0 && n != stages)) return false;
    *p = {R, 1, buffers, (warps + 1) * kWarp, kTileRecords, n, cluster,
          head + n * stage + buffers * row, rec, idb};
    return true;
}

bool global_plan(int width, int item, int cluster, int stages, Plan* p)
{
    const int idb = id_bytes_of(width), rec = record_bytes(idb, item);
    const long long head = head_bytes(kConsumerWarps, kGlobalRows, item);
    const long long stage = (long long)kTileRecords * rec;
    const int n = stages_in(kSmemBytes - head, stage,
                            stages >= 0 ? kMaxStages : kGlobalStages, stages);
    if (n < kMinStages || (stages >= 0 && n != stages)) return false;
    *p = {kGlobalRows, 0, 0, (kConsumerWarps + 1) * kWarp, kTileRecords, n,
          cluster, head + n * stage, rec, idb};
    return true;
}

// The plan with the caller's overrides (>= 0): rows a block (1, 2, 4 or 8
// staged, kGlobalRows read from device memory), the cluster's blocks (1 or
// kClusterCtas) and the ring's stages (kMinStages to kMaxStages). False
// for an instance that does not exist or fit.
bool plan_for(int width, int item, int rows_per_block, int staged,
              int cluster, int stages, Plan* p)
{
    if (cluster < 0) cluster = kClusterCtas;
    if (cluster != 1 && cluster != kClusterCtas) return false;
    if (stages >= 0 && (stages < kMinStages || stages > kMaxStages))
        return false;
    if (staged == 0) {
        if (rows_per_block >= 0 && rows_per_block != kGlobalRows) return false;
        return global_plan(width, item, cluster, stages, p);
    }
    if (rows_per_block >= 0) {
        if (rows_per_block != 1 && rows_per_block != 2 && rows_per_block != 4
            && rows_per_block != 8)
            return false;
        return staged_plan(rows_per_block, width, item, cluster, stages, p);
    }
    for (int r = 8; r >= 1; r /= 2)
        if (staged_plan(r, width, item, cluster, stages, p)) return true;
    return staged < 0 && global_plan(width, item, cluster, stages, p);
}

std::mutex g_mutex;
// resident clusters by (kernel, shared memory, cluster size)
std::map<std::tuple<const void*, long long, int>, int> g_clusters;

template <typename T, typename Id, int R, bool Staged>
cudaError_t launch_t(const Plan& p, const AssignArgs<T>& a, cudaStream_t st)
{
    auto kernel = assign_kernel<T, Id, R, Staged>;
    const void* key_fn = (const void*)kernel;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.blockDim = dim3(p.threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)p.smem;
    cfg.stream = st;
    cfg.gridDim = dim3(p.cluster, 1, 1);
    int resident;
    {
        std::lock_guard<std::mutex> lock(g_mutex);
        const auto key = std::make_tuple(key_fn, p.smem, p.cluster);
        auto it = g_clusters.find(key);
        if (it == g_clusters.end()) {
            cudaError_t err = cudaFuncSetAttribute(
                key_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)kSmemBytes);
            if (err != cudaSuccess) return err;
            int n = 0;
            err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
            if (err != cudaSuccess) return err;
            it = g_clusters.emplace(key, n).first;
        }
        resident = it->second;
    }
    if (resident < 1) return cudaErrorInvalidConfiguration;
    const int groups = (a.n_rows + R - 1) / R;
    const int supers = (groups + p.cluster - 1) / p.cluster;
    cfg.gridDim = dim3((supers < resident ? supers : resident) * p.cluster,
                       1, 1);
    return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T>
cudaError_t launch_plan(const Plan& p, const AssignArgs<T>& a,
                        cudaStream_t st)
{
    if (!p.staged)
        return p.id_bytes == 2
                   ? launch_t<T, uint16_t, kGlobalRows, false>(p, a, st)
                   : launch_t<T, int32_t, kGlobalRows, false>(p, a, st);
    if (p.id_bytes != 2) return cudaErrorInvalidValue;
    switch (p.rows) {
    case 1: return launch_t<T, uint16_t, 1, true>(p, a, st);
    case 2: return launch_t<T, uint16_t, 2, true>(p, a, st);
    case 4: return launch_t<T, uint16_t, 4, true>(p, a, st);
    case 8: return launch_t<T, uint16_t, 8, true>(p, a, st);
    default: return cudaErrorInvalidValue;
    }
}

// runs `fn` with `device` current, then puts the caller's device back
template <typename F>
int on_device(int device, F fn)
{
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return (int)err;
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return (int)err;
    }
    const int rc = fn();
    if (current != device) cudaSetDevice(current);
    return rc;
}

}  // namespace

// Writes into out int [10] the plan for rows of `width` elements (float,
// or double if is_f64) with the overrides of dc_assign (-1: the plan's):
// rows a block, staged in shared memory (1) or read from device memory
// (0), row buffers, threads a block (the producer warp's included),
// records a tile, ring stages, blocks a cluster, dynamic shared memory
// bytes a block, bytes a record, bytes an id.
extern "C" int dc_assign_plan(int width, int is_f64, int rows_per_block,
                              int staged, int cluster, int stages, int* out)
{
    if (width < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
    Plan p;
    if (!plan_for(width, is_f64 ? 8 : 4, rows_per_block, staged, cluster,
                  stages, &p))
        return (int)cudaErrorInvalidValue;
    const int v[10] = {p.rows,  p.staged,  p.buffers,      p.threads,
                       p.tile,  p.stages,  p.cluster,      (int)p.smem,
                       p.record_bytes,     p.id_bytes};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
}

// Packs the state's valid slots (the six arrays as in the header comment,
// n_edges of them) into `records` (n_edges records of the layout that
// `width`'s ids take: record_bytes each, 16-byte aligned) and writes the
// record count and the lowest invalid slot into meta int32 [2]. `work` is
// the pack's workspace, 8 x (ceil(n_edges / kPackTile) + 2) bytes of any
// content (zeroed here first). A block a tile of kPackTile slots, launched
// on `stream` of `device` after the workspace's memset without
// synchronizing; returns the CUDA error code (0 on success).
extern "C" int dc_assign_pack(const void* cid, const void* cdis,
                              const void* belong, const void* dst,
                              const void* rev, const void* length,
                              int n_edges, int width, void* records,
                              void* meta, void* work, int is_f64, int device,
                              void* stream)
{
    if (n_edges < 1 || width < 1 || work == nullptr)
        return (int)cudaErrorInvalidValue;
    const bool wide = id_bytes_of(width) == 4;
    const int n_tiles = (n_edges + kPackTile - 1) / kPackTile;
    unsigned long long* status = (unsigned long long*)work;
    unsigned* tail = (unsigned*)(status + n_tiles);
    const PackWork w = {status, tail, tail + 1, tail + 2};
    return on_device(device, [&]() {
        const cudaStream_t s = (cudaStream_t)stream;
        const cudaError_t err = cudaMemsetAsync(
            work, 0, sizeof(unsigned long long) * (n_tiles + 2), s);
        if (err != cudaSuccess) return (int)err;
#define DC_ASSIGN_PACK(T, Id)                                                \
    pack_kernel<T, Id><<<n_tiles, kPackThreads, 0, s>>>(                     \
        (const int32_t*)cid, (const T*)cdis, (const int32_t*)belong,         \
        (const int32_t*)dst, (const int32_t*)rev, (const T*)length, n_edges, \
        (uint4*)records, (int32_t*)meta, w)
        if (is_f64) {
            if (wide) DC_ASSIGN_PACK(double, int32_t);
            else DC_ASSIGN_PACK(double, uint16_t);
        } else {
            if (wide) DC_ASSIGN_PACK(float, int32_t);
            else DC_ASSIGN_PACK(float, uint16_t);
        }
#undef DC_ASSIGN_PACK
        return (int)cudaGetLastError();
    });
}

// Launches kernel 10 on `stream` of `device` without synchronizing and
// returns the CUDA error code (0 on success): records and meta as
// dc_assign_pack wrote them for ids of `id_bytes` (which must be the ids
// of `width`), the rows (float if is_f64 == 0, else double), n_rows >= 1
// rows of `width` >= 1 elements `row_stride` apart (>= width unless
// n_rows == 1), out int64 [n_rows]. rows_per_block, staged, cluster and
// stages override the plan where they are >= 0 (tests drive every
// instance with them): 1, 2, 4 or 8 rows a block staged, kGlobalRows read
// from device memory; 1 or kClusterCtas blocks a cluster; kMinStages to
// kMaxStages stages. An instance that does not exist or fit, or a cluster
// that finds no room on the card, returns an error.
extern "C" int dc_assign(const void* records, const void* meta, int id_bytes,
                         const void* rows, long long row_stride, int n_rows,
                         int width, void* out, int rows_per_block, int staged,
                         int cluster, int stages, int is_f64, int device,
                         void* stream)
{
    if (n_rows < 1 || width < 1 || (n_rows > 1 && row_stride < width)
        || id_bytes != id_bytes_of(width))
        return (int)cudaErrorInvalidValue;
    const int item = is_f64 ? 8 : 4;
    Plan p;
    if (!plan_for(width, item, rows_per_block, staged, cluster, stages, &p))
        return (int)cudaErrorInvalidValue;
    return on_device(device, [&]() {
        const cudaStream_t s = (cudaStream_t)stream;
        cudaError_t err;
        if (is_f64) {
            const AssignArgs<double> a = {
                (const unsigned char*)records, (const int32_t*)meta,
                (const double*)rows, row_stride, n_rows, width, p.buffers,
                p.stages, (long long*)out};
            err = launch_plan<double>(p, a, s);
        } else {
            const AssignArgs<float> a = {
                (const unsigned char*)records, (const int32_t*)meta,
                (const float*)rows, row_stride, n_rows, width, p.buffers,
                p.stages, (long long*)out};
            err = launch_plan<float>(p, a, s);
        }
        return (int)err;
    });
}

extern "C" const char* dc_assign_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
