// The k-closest insertion step on Hopper (sm_90a): the splice of a new
// taxon onto its chosen edge and the witness BFS from it, in one launch
// that reads the choice on the card, so that an insertion needs no host
// round trip.
//
// Replaces the body of the JAX package's device-resident insert loop,
// dipper_tpu/placement/kclosest.py::_blocked_insert_loop (:857-882), an XLA
// program and not Pallas: after the scorer it runs `splice` (:542-613, with
// `_insert_merge_lists` :532-539) and the compact witness BFS
// `_update_closest_bfs_compact` (:221-311, a lax.while_loop over levels).
// The plain version is the port's tensor code, placement/kclosest.py::
// splice and _update_closest_bfs_compact (the CPU path, and this kernel's
// yardstick on the card); placement/insert_model.py is a numpy model of
// this file's plan. The splice and the walk are in insert_step.cuh, which
// D&C's cluster build (dc_cluster_build.cu) shares.
//
// Entry points, each one block of kThreads threads on the caller's stream,
// none synchronizing:
//
// - insert_step: the splice, then the BFS from `outside`. (xe, ye) of the
//   choice go to out_xy.
// - closest_bfs: the BFS alone, from `leaf`, with up to kMaxBlocked
//   blocked nodes read from a device array.
// - insert_step_cursor, closest_bfs_cursor: the same, with the insertion
//   (or leaf) i and the slots in use read from a cursor on the card and
//   advanced by the launch (i + 1; slots + 4), so that one captured CUDA
//   graph of them serves every stretch of an insert range
//   (kclosest._insert_range, the counterpart of the JAX package's
//   fori_loop over a range). insert_step_cursor takes the scorer's
//   outputs: the chosen edge with its ends, and (frac, add), and places
//   insertion i by offsets: outside i + o, middle i + m, label i + l, and a
//   blocked slot (placement: 0, N - 1, 0 and none; a D&C streamed cluster:
//   2, 2 + cmax, 10 and slot 0).
// - insert_cursor_set writes a cursor; insert_step_preload loads every
//   kernel of this library, so that a capture loads none.
//
// The plan, for a card where one insertion is a chain of dependent L2
// reads and nothing else:
//
// - The splice is warp 0's: lanes read the choice, then both halves'
//   K-lists and the edge's length in one round trip; lane i ranks value i
//   of the ten candidates of the middle->outside list by integer keys (a
//   stable rank, NaN after every number, as torch.argsort(stable=True)
//   orders them); each
//   slot is written by one lane, and where two of the plain version's
//   statements write one address (only on a malformed choice) the later
//   statement's lane writes it. The BFS's first level (outside -> middle
//   over the fresh slot i2) is known from the splice and is written with
//   it, so the walk starts at middle.
// - A level's frontier (node, node it was reached from, distance) sits in
//   shared ping-pong buffers of kCap entries; entries from kCap on spill
//   to the [2, M] device scratch at the same index.
// - A level of at most kNarrow (entry, out-edge) pairs is warp 0's: each
//   lane visits one pair, __ballot_sync and __popc of the lanes below give
//   each joining entry its place, and __syncwarp ends the level. The other
//   warps wait at a block barrier that warp 0 reaches only when a level
//   turns wide; a wide level is the block's, in chunks of kThreads pairs
//   placed by a block-wide scan. Both place the next frontier in the flat
//   (entry, out-edge) order, the plain version's, whatever the chunk
//   width, so the kernel is deterministic.
// - A pair's visit reads the adjacency slot, then the edge's destination,
//   list, ids and length in one round trip: two dependent L2 reads a
//   level. The pair is skipped when the edge is empty, leads back or
//   leaves a blocked node; otherwise pos = #(cdis <= d) (a comparison with
//   NaN is false) and, when pos < K, (d, label) goes in at pos, the entries
//   from pos shift right and the last drops, and the far node joins the
//   next frontier at distance d + length.
// - Data the launch writes (e, length, rev, cdis, cid, adj, the scratch)
//   is read with plain loads, never through the read-only path.
//
// In a tree a level's frontier holds distinct nodes, so no two threads of
// a level touch one edge, and it never exceeds M; the walk ends within M
// levels on any input, and a frontier is cut at M entries, which also
// bounds a malformed state.
//
// What bounds it: neither bytes nor operations. An insertion at 30,000
// taxa touches some tens of edges in 6-10 levels (a few KB); the floor is
// the levels times two dependent L2 round trips. One block keeps the chain
// on one multiprocessor; the rest of the card is idle, as it is for the
// JAX package's loop body.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics; T = float or double.

#include "insert_step.cuh"

namespace {

using namespace dipper;

// frontier entries a shared buffer holds (6 KB for both buffers in f32, 8 KB
// in f64): levels at 30,000 taxa hold a few nodes, the first BFSs over a
// balanced 1,024-leaf backbone up to 512 (those spill)
constexpr int kCap = 256;

// the cursor of an insert range: insertion (or leaf) i, slots in use, the
// address of the range's first distance row, the rows' stride in elements,
// and the range's first insertion (int64 each)
enum { kCurI = 0, kCurUsed, kCurRows, kCurStride, kCurLo };

// The offsets of a cursor launch's nodes and label from its insertion i
struct Offsets {
    int outside, middle, label;
};

// insert_step and insert_step_cursor; the cursor, when given, supplies i
// (outside = i + off.outside, middle = i + off.middle, label = i +
// off.label) and i0 (the slots in use), and is advanced at the end
template <typename T>
__global__ void __launch_bounds__(kThreads)
insert_step_kernel(State<T> s, const int32_t* eid, const int32_t* ends,
                   const T* frac, const T* add, int i0, int middle,
                   int outside, int label, int block_slot, int32_t* out_xy,
                   long long* cursor, Offsets off)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    long long ci = 0, cu = 0;
    int count = 0;
    Entry<T> first = {-1, -1, T(0)};
    Blocked bl = {0, -1, -1};
    if (threadIdx.x < kWarp) {
        bool ok = true;
        if (cursor != nullptr) {
            long long a = 0;
            if (threadIdx.x < 2) a = cursor[threadIdx.x];
            ci = __shfl_sync(kFull, a, kCurI);
            cu = __shfl_sync(kFull, a, kCurUsed);
            const long long out = ci + off.outside, mid = ci + off.middle;
            ok = cu >= 0 && cu <= s.n_edges - 4 && out >= 0
                 && out < s.n_nodes && mid >= 0 && mid < s.n_nodes;
            i0 = (int)cu;
            outside = (int)out;
            middle = (int)mid;
            label = (int)(ci + off.label);
        }
        if (ok) {
            ok = warp_splice(s, eid, ends, frac, add, i0, middle, outside,
                             label, block_slot, out_xy, &count, &first, &bl);
        } else if (threadIdx.x < 2) {
            out_xy[threadIdx.x] = -1;
        }
        if (!ok) count = 0;
        if (threadIdx.x == 0) {
            sh.label = label;
            sh.n_blocked = bl.n;
            sh.blocked[0] = bl.b0;
            sh.blocked[1] = bl.b1;
        }
        __syncwarp();  // the splice's writes before the walk's reads
    }
    walk(s, sh, first, count, 1, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) {
        cursor[kCurI] = ci + 1;
        cursor[kCurUsed] = cu + 4;
    }
}

// closest_bfs and closest_bfs_cursor; the cursor, when given, supplies the
// leaf (= label) and is advanced at the end
template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_kernel(State<T> s, int leaf, int label, const int32_t* blocked,
                   int n_blocked, long long* cursor)
{
    __shared__ Shared<T, kThreads, kCap> sh;
    long long ci = 0;
    Blocked bl = {n_blocked, -1, -1};
    if (threadIdx.x < kWarp) {
        if (cursor != nullptr) {
            ci = cursor[kCurI];
            leaf = label = (int)(ci >= 0 && ci < s.n_nodes ? ci : -1);
        }
        if (n_blocked > 0) bl.b0 = blocked[0];
        if (n_blocked > 1) bl.b1 = blocked[1];
        if (threadIdx.x == 0) {
            sh.label = label;
            sh.n_blocked = bl.n;
            sh.blocked[0] = bl.b0;
            sh.blocked[1] = bl.b1;
        }
    }
    walk(s, sh, Entry<T>{leaf, -1, T(0)}, 1, 0, label, bl);
    if (cursor != nullptr && threadIdx.x == 0) cursor[kCurI] = ci + 1;
}

// One thread follows `steps` links of `next` (a random cycle, read past
// L1): the latency of one dependent L2 round trip, the unit of this
// kernel's floor (chip_smoke.py phase 25 times it).
__global__ void chase_kernel(const int32_t* next, int steps, int32_t* out)
{
    int j = 0;
    for (int t = 0; t < steps; ++t) j = __ldcg(next + j);
    *out = j;
}

__global__ void cursor_set_kernel(long long* cursor, long long i,
                                  long long used, long long rows,
                                  long long stride, long long lo)
{
    cursor[kCurI] = i;
    cursor[kCurUsed] = used;
    cursor[kCurRows] = rows;
    cursor[kCurStride] = stride;
    cursor[kCurLo] = lo;
}

template <typename T>
State<T> make_state(void* e, void* belong, void* length, void* rev,
                    void* cdis, void* cid, void* adj, void* f_ids,
                    void* f_frm, void* f_dist, int n_edges, int n_nodes)
{
    return State<T>{(int32_t*)e, (int32_t*)belong, (T*)length,
                    (int32_t*)rev, (T*)cdis, (int32_t*)cid, (int32_t*)adj,
                    (int32_t*)f_ids, (int32_t*)f_frm, (T*)f_dist, n_edges,
                    n_nodes};
}

// cudaSetDevice(device) for the life of the object, the caller's device
// back after
struct OnDevice {
    int prev = -1;
    cudaError_t err = cudaSuccess;
    explicit OnDevice(int device)
    {
        err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    }
    ~OnDevice()
    {
        int now = -1;
        if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
            cudaSetDevice(prev);
    }
};

bool state_ok(int n_edges, int n_nodes)
{
    return n_edges >= 1 && n_nodes >= 1 && n_nodes <= (1 << 29);
}

template <typename T>
void launch_step(void* const* p, int n_edges, int n_nodes, const void* eid,
                 const void* ends, const void* frac, const void* add, int i0,
                 int middle, int outside, int label, int block_slot,
                 void* cursor, Offsets off, cudaStream_t st)
{
    insert_step_kernel<T><<<1, kThreads, 0, st>>>(
        make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                      p[9], n_edges, n_nodes),
        (const int32_t*)eid, (const int32_t*)ends, (const T*)frac,
        (const T*)add, i0, middle, outside, label, block_slot,
        (int32_t*)p[10], (long long*)cursor, off);
}

template <typename T>
void launch_bfs(void* const* p, int n_edges, int n_nodes, int leaf,
                int label, const void* blocked, int n_blocked, void* cursor,
                cudaStream_t st)
{
    closest_bfs_kernel<T><<<1, kThreads, 0, st>>>(
        make_state<T>(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                      p[9], n_edges, n_nodes),
        leaf, label, (const int32_t*)blocked, n_blocked, (long long*)cursor);
}

}  // namespace

// State arguments of every entry point: e, belong, length, rev, cdis, cid,
// adj, f_ids, f_frm, f_dist (the [2, M] frontier spill), out_xy (int32
// [2]); n_edges, n_nodes; is_f64 (float or double lengths and lists); the
// device. Each launches on `stream` without synchronizing and returns the
// CUDA error code (0 on success).
#define STATE_PARAMS                                                          \
    void *e, void *belong, void *length, void *rev, void *cdis, void *cid,    \
        void *adj, void *f_ids, void *f_frm, void *f_dist, void *out_xy,      \
        int n_edges, int n_nodes, int is_f64, int device
#define STATE_PTRS {e, belong, length, rev, cdis, cid, adj, f_ids, f_frm, \
                    f_dist, out_xy}

// The splice and BFS of one insertion: the choice eid (int32), frac and add
// (T) are one element each on the card; the new slots are i0 .. i0 + 3;
// `label` is written into witness lists.
extern "C" int insert_step(STATE_PARAMS, const void* eid, const void* frac,
                           const void* add, int i0, int middle, int outside,
                           int label, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || i0 < 0 || i0 > n_edges - 4
        || middle < 0 || middle >= n_nodes || outside < 0
        || outside >= n_nodes)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_step<double>(p, n_edges, n_nodes, eid, nullptr, frac, add, i0,
                            middle, outside, label, -1, nullptr, Offsets{},
                            st);
    else
        launch_step<float>(p, n_edges, n_nodes, eid, nullptr, frac, add, i0,
                           middle, outside, label, -1, nullptr, Offsets{},
                           st);
    return (int)cudaGetLastError();
}

// The BFS alone from `leaf` (blocked: n_blocked <= 2 node ids on the card,
// or none).
extern "C" int closest_bfs(STATE_PARAMS, int leaf, int label,
                           const void* blocked, int n_blocked, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || leaf < 0 || leaf >= n_nodes
        || n_blocked < 0 || n_blocked > kMaxBlocked
        || (n_blocked > 0 && blocked == nullptr))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_bfs<double>(p, n_edges, n_nodes, leaf, label, blocked,
                           n_blocked, nullptr, st);
    else
        launch_bfs<float>(p, n_edges, n_nodes, leaf, label, blocked,
                          n_blocked, nullptr, st);
    return (int)cudaGetLastError();
}

// insert_step for insertion i = cursor[0] at slots cursor[1] ..: choice_i
// is the scorer's int32 [4] (eid, belong[eid], e[eid], rev[eid]), choice_f
// its T [2] (frac, add); outside i + off_outside, middle i + off_middle,
// label i + off_label; with block_slot >= 0 the endpoints of that slot as
// they stand after the splice are dequeued but not expanded (D&C's cluster
// edge), -1 for none. The cursor (int64 [5]) advances by one insertion.
extern "C" int insert_step_cursor(STATE_PARAMS, const void* choice_i,
                                  const void* choice_f, void* cursor,
                                  int off_outside, int off_middle,
                                  int off_label, int block_slot, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr
        || choice_i == nullptr || choice_f == nullptr
        || block_slot >= n_edges)
        return (int)cudaErrorInvalidValue;
    const Offsets off = {off_outside, off_middle, off_label};
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t* ci = (const int32_t*)choice_i;
    if (is_f64) {
        const double* cf = (const double*)choice_f;
        launch_step<double>(p, n_edges, n_nodes, ci, ci + 1, cf, cf + 1, 0, 0,
                            0, 0, block_slot, cursor, off, st);
    } else {
        const float* cf = (const float*)choice_f;
        launch_step<float>(p, n_edges, n_nodes, ci, ci + 1, cf, cf + 1, 0, 0,
                           0, 0, block_slot, cursor, off, st);
    }
    return (int)cudaGetLastError();
}

// closest_bfs from leaf = label = cursor[0], no blocked node; the cursor
// advances by one leaf.
extern "C" int closest_bfs_cursor(STATE_PARAMS, void* cursor, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || cursor == nullptr)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[11] = STATE_PTRS;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch_bfs<double>(p, n_edges, n_nodes, 0, 0, nullptr, 0, cursor, st);
    else
        launch_bfs<float>(p, n_edges, n_nodes, 0, 0, nullptr, 0, cursor, st);
    return (int)cudaGetLastError();
}

// Writes the cursor (int64 [5]): i, slots in use, the address of the
// range's first distance row (0 for none), the rows' stride in elements,
// the range's first insertion.
extern "C" int insert_cursor_set(void* cursor, long long i, long long used,
                                 long long rows, long long stride,
                                 long long lo, int device, void* stream)
{
    if (cursor == nullptr) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cursor_set_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long*)cursor, i, used, rows, stride, lo);
    return (int)cudaGetLastError();
}

// Launches chase_kernel: `steps` dependent reads through `next` (int32, a
// cycle), the last index to `out`.
extern "C" int insert_step_chase(const void* next, int steps, void* out,
                                 int device, void* stream)
{
    if (next == nullptr || out == nullptr || steps < 0)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)next,
                                                     steps, (int32_t*)out);
    return (int)cudaGetLastError();
}

// Loads every kernel of the library on `device` (under lazy module loading
// a kernel is loaded at its first launch, which a stream capture must not
// be).
extern "C" int insert_step_preload(int device)
{
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cudaFuncAttributes a;
    const void* fns[] = {(const void*)insert_step_kernel<float>,
                         (const void*)insert_step_kernel<double>,
                         (const void*)closest_bfs_kernel<float>,
                         (const void*)closest_bfs_kernel<double>,
                         (const void*)cursor_set_kernel,
                         (const void*)chase_kernel};
    for (const void* f : fns) {
        const cudaError_t err = cudaFuncGetAttributes(&a, f);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

extern "C" const char* insert_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
