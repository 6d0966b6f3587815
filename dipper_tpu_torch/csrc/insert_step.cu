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
// this file's plan.
//
// Two entry points, each one block of kThreads threads on the caller's
// stream, neither synchronizing:
//
// - insert_step: thread 0 reads the choice (eid, frac, add) from device
//   pointers (the scorer's outputs), reads edge eid's ends and both
//   halves' witness lists before any write, computes the four new lists
//   (the middle->outside list by a stable rank of ten values, NaN after
//   every number, as torch.argsort(stable=True) orders them) and writes
//   every slot in the plain version's order; then, after a block barrier,
//   the BFS from `outside`. With block_slot >= 0 the endpoints of that
//   slot as they stand after the splice are dequeued but not expanded
//   (D&C's cluster edge). (xe, ye) of the choice go to out_xy.
// - closest_bfs: the BFS alone, from `leaf`, with up to kMaxBlocked
//   blocked nodes read from a device array.
//
// The BFS walks levels. A level's frontier (node, node it was reached
// from, distance) sits in device scratch, [2, M] of each, ping-pong. Each
// thread takes one (frontier entry, out-edge) pair, 3 a node, in chunks
// of kThreads: the edge is skipped when it is empty, leads back, or leaves
// a blocked node; otherwise pos = #(cdis <= d) (a comparison with NaN is
// false) and, when pos < K, (d, label) goes in at pos, the entries from
// pos shift right and the last drops, and the edge's far node joins the
// next frontier at distance d + length. A block-wide exclusive scan of
// the "joins" flags gives each joining entry its place, so the frontier is
// compacted in the plain version's order and the kernel is deterministic
// (inserts into distinct edges commute, so the state would not depend on
// the order anyway). In a tree a level's frontier holds distinct nodes, so
// no two threads of a level touch one edge, and it never exceeds M; the
// walk ends within M levels on any input, which also bounds a malformed
// state.
//
// What bounds it: neither bytes nor operations. An insertion at 30,000
// taxa touches some tens of edges in 6-10 levels (a few KB); each level is
// a chain of dependent L2 reads (frontier entry, adjacency row, edge
// destination and list) and three block barriers, so the floor is levels
// times that latency. One block keeps the chain on one multiprocessor;
// the rest of the card is idle, as it is for the JAX package's loop body.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics; T = float or double.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 5;  // placement/kclosest.py::K
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kDegree = 3;      // adjacency slots a node
constexpr int kMaxBlocked = 2;  // nodes a BFS may dequeue without expanding

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// a strictly before b in torch's sort order: NaN after every number
template <typename T>
__device__ __forceinline__ bool before(T a, T b)
{
    return a == a && (b != b || a < b);
}

template <typename T>
struct State {
    int32_t* e;       // [E] destination node
    int32_t* belong;  // [E] source node
    T* length;        // [E]
    int32_t* rev;     // [E]
    T* cdis;          // [E, K]
    int32_t* cid;     // [E, K]
    int32_t* adj;     // [M, 3] out-edges of each node, -1 empty
    int32_t* f_ids;   // [2, M] frontier scratch: node
    int32_t* f_frm;   // [2, M] node it was reached from
    T* f_dist;        // [2, M] distance from the source
    int n_edges, n_nodes;
};

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total)
{
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    int x = v;
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
    }
    if (lane == kWarp - 1) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 1; off < kWarps; off *= 2) {
            const int y = __shfl_up_sync(0xffffffffu, w, off);
            if (lane >= off) w += y;
        }
        if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();
    const int excl = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
    *total = s_warp[kWarps - 1];
    __syncthreads();  // s_warp is written again by the next scan
    return excl;
}

// The witness BFS (_update_closest_bfs_compact) from the one entry that
// the caller wrote to frontier buffer 0 before a block barrier.
template <typename T>
__device__ void witness_bfs(const State<T>& s, int label,
                            const int* s_blocked, int n_blocked, int* s_warp)
{
    const int M = s.n_nodes, E = s.n_edges;
    int count = 1, cur = 0;
    for (int level = 0; count > 0 && level < M; ++level) {
        const int32_t* ids = s.f_ids + (size_t)cur * M;
        const int32_t* frm = s.f_frm + (size_t)cur * M;
        const T* dist = s.f_dist + (size_t)cur * M;
        int32_t* nids = s.f_ids + (size_t)(1 - cur) * M;
        int32_t* nfrm = s.f_frm + (size_t)(1 - cur) * M;
        T* ndist = s.f_dist + (size_t)(1 - cur) * M;
        const int items = kDegree * count;
        int next = 0;
        for (int c0 = 0; c0 < items; c0 += kThreads) {
            const int j = c0 + threadIdx.x;
            int joins = 0, node = -1, dst = -1;
            T nd = T(0);
            if (j < items) {
                const int f = j / kDegree;
                node = ids[f];
                bool expand = node >= 0 && node < M;
                for (int b = 0; b < n_blocked; ++b)
                    expand = expand && node != s_blocked[b];
                const int eid = expand ? s.adj[(size_t)node * kDegree
                                               + (j - f * kDegree)] : -1;
                if (eid >= 0 && eid < E) {
                    dst = s.e[eid];
                    if (dst != frm[f]) {
                        const T d = dist[f];
                        T* cd = s.cdis + (size_t)eid * kK;
                        int32_t* ci = s.cid + (size_t)eid * kK;
                        T c[kK];
                        int pos = 0;
#pragma unroll
                        for (int k = 0; k < kK; ++k) {
                            c[k] = cd[k];
                            pos += c[k] <= d;
                        }
                        if (pos < kK) {
                            int32_t id[kK];
#pragma unroll
                            for (int k = 0; k < kK; ++k) id[k] = ci[k];
                            // _insert_sorted: from pos on, one place right
#pragma unroll
                            for (int k = kK - 1; k >= 1; --k) {
                                if (k > pos) {
                                    cd[k] = c[k - 1];
                                    ci[k] = id[k - 1];
                                }
                            }
                            cd[pos] = d;
                            ci[pos] = label;
                            nd = add_rn(d, s.length[eid]);
                            joins = 1;
                        }
                    }
                }
            }
            int total;
            const int at = next + block_exclusive_scan(joins, s_warp, &total);
            if (joins && at < M) {
                nids[at] = dst;
                nfrm[at] = node;
                ndist[at] = nd;
            }
            next += total;
        }
        count = next < M ? next : M;
        cur = 1 - cur;
        __syncthreads();  // the next level reads what this one wrote
    }
}

// splice (updateTreeStructure) by one thread; false, with nothing
// written, when eid or its reverse slot is not a slot of the state.
template <typename T>
__device__ bool splice(const State<T>& s, int eid, T frac, T add, int i0,
                       int middle, int outside, int32_t* out_xy)
{
    const int E = s.n_edges;
    out_xy[0] = -1;
    out_xy[1] = -1;
    if (eid < 0 || eid >= E) return false;
    const int xe = eid;
    const int x = s.belong[xe], y = s.e[xe];
    const int ye = s.rev[xe];             // stored as read
    const int yi = ye < 0 ? ye + E : ye;  // indexed as a tensor index is
    if (yi < 0 || yi >= E) return false;
    const int i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3;

    // every value is read and computed before the first write
    const T orig = s.length[xe];
    const T rest = sub_rn(orig, frac);
    T v[2 * kK];        // cd_i1 (first list), then cd_i0
    int32_t id[2 * kK];  // id_xe, then id_ye
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        const T cx = s.cdis[(size_t)xe * kK + k];
        const T cy = s.cdis[(size_t)yi * kK + k];
        id[k] = s.cid[(size_t)xe * kK + k];
        id[kK + k] = s.cid[(size_t)yi * kK + k];
        // (cd + orig) - frac, the reference's association
        v[k] = id[k] != -1 ? add_rn(cx, frac) : T(2);
        v[kK + k] = id[kK + k] != -1 ? sub_rn(add_rn(cy, orig), frac) : T(2);
    }

    s.e[xe] = middle;
    s.e[yi] = middle;
    s.length[xe] = frac;
    s.length[yi] = rest;
    s.rev[xe] = i0;
    s.rev[yi] = i1;
    const int32_t ne[4] = {x, y, middle, outside};
    const int32_t nb[4] = {middle, middle, outside, middle};
    const int32_t nr[4] = {xe, ye, i3, i2};
    const T nl[4] = {frac, rest, add, add};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        s.e[i0 + q] = ne[q];
        s.belong[i0 + q] = nb[q];
        s.rev[i0 + q] = nr[q];
        s.length[i0 + q] = nl[q];
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        s.cdis[(size_t)i0 * kK + k] = v[kK + k];
        s.cid[(size_t)i0 * kK + k] = id[kK + k];
        s.cdis[(size_t)i1 * kK + k] = v[k];
        s.cid[(size_t)i1 * kK + k] = id[k];
        s.cdis[(size_t)i2 * kK + k] = T(2);
        s.cid[(size_t)i2 * kK + k] = -1;
    }
    // _insert_merge_lists: the stable rank of each of the ten values (the
    // first list wins ties, NaNs keep their order after every number);
    // the five first go to slot i3
#pragma unroll
    for (int i = 0; i < 2 * kK; ++i) {
        int r = 0;
#pragma unroll
        for (int j = 0; j < 2 * kK; ++j) {
            if (j < i) r += !before(v[i], v[j]);
            if (j > i) r += before(v[j], v[i]);
        }
        if (r < kK) {
            s.cdis[(size_t)i3 * kK + r] = v[i];
            s.cid[(size_t)i3 * kK + r] = id[i];
        }
    }
    // x and y keep their edge ids: only the two new nodes' rows change
    s.adj[(size_t)middle * kDegree + 0] = i0;
    s.adj[(size_t)middle * kDegree + 1] = i1;
    s.adj[(size_t)middle * kDegree + 2] = i3;
    s.adj[(size_t)outside * kDegree + 0] = i2;
    s.adj[(size_t)outside * kDegree + 1] = -1;
    s.adj[(size_t)outside * kDegree + 2] = -1;
    out_xy[0] = xe;
    out_xy[1] = yi;
    return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
insert_step_kernel(State<T> s, const int32_t* eid, const T* frac,
                   const T* add, int i0, int middle, int outside, int label,
                   int block_slot, int32_t* out_xy)
{
    __shared__ int s_warp[kWarps];
    __shared__ int s_blocked[kMaxBlocked];
    __shared__ int s_nblocked;
    __shared__ bool s_spliced;
    if (threadIdx.x == 0) {
        s_spliced = splice(s, *eid, *frac, *add, i0, middle, outside, out_xy);
        int nb = 0;
        if (block_slot >= 0) {
            // the slot's endpoints as they stand after the splice
            s_blocked[0] = s.belong[block_slot];
            s_blocked[1] = s.e[block_slot];
            nb = 2;
        }
        s_nblocked = nb;
        s.f_ids[0] = outside;
        s.f_frm[0] = -1;
        s.f_dist[0] = T(0);
    }
    __syncthreads();  // the splice's writes are seen by the whole block
    if (!s_spliced) return;
    witness_bfs(s, label, s_blocked, s_nblocked, s_warp);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
closest_bfs_kernel(State<T> s, int leaf, int label, const int32_t* blocked,
                   int n_blocked)
{
    __shared__ int s_warp[kWarps];
    __shared__ int s_blocked[kMaxBlocked];
    if (threadIdx.x == 0) {
        for (int b = 0; b < n_blocked; ++b) s_blocked[b] = blocked[b];
        s.f_ids[0] = leaf;
        s.f_frm[0] = -1;
        s.f_dist[0] = T(0);
    }
    __syncthreads();
    witness_bfs(s, label, s_blocked, n_blocked, s_warp);
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

}  // namespace

// Launches the splice and BFS of one insertion on `stream` of `device`
// without synchronizing; returns the CUDA error code (0 on success).
// State pointers as in State, float (is_f64 == 0) or double; the choice
// eid (int32), frac and add (T) are one element each on the card; the new
// slots are i0 .. i0 + 3; `label` is written into witness lists.
extern "C" int insert_step(void* e, void* belong, void* length, void* rev,
                           void* cdis, void* cid, void* adj, void* f_ids,
                           void* f_frm, void* f_dist, void* out_xy,
                           int n_edges, int n_nodes, int is_f64, int device,
                           const void* eid, const void* frac, const void* add,
                           int i0, int middle, int outside, int label,
                           int block_slot, void* stream)
{
    if (!state_ok(n_edges, n_nodes) || i0 < 0 || i0 > n_edges - 4
        || middle < 0 || middle >= n_nodes || outside < 0
        || outside >= n_nodes || block_slot >= n_edges)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64) {
        insert_step_kernel<double><<<1, kThreads, 0, st>>>(
            make_state<double>(e, belong, length, rev, cdis, cid, adj, f_ids,
                               f_frm, f_dist, n_edges, n_nodes),
            (const int32_t*)eid, (const double*)frac, (const double*)add, i0,
            middle, outside, label, block_slot, (int32_t*)out_xy);
    } else {
        insert_step_kernel<float><<<1, kThreads, 0, st>>>(
            make_state<float>(e, belong, length, rev, cdis, cid, adj, f_ids,
                              f_frm, f_dist, n_edges, n_nodes),
            (const int32_t*)eid, (const float*)frac, (const float*)add, i0,
            middle, outside, label, block_slot, (int32_t*)out_xy);
    }
    return (int)cudaGetLastError();
}

// Launches the BFS alone from `leaf` (blocked: n_blocked <= 2 node ids on
// the card, or none); as insert_step otherwise.
extern "C" int closest_bfs(void* e, void* belong, void* length, void* rev,
                           void* cdis, void* cid, void* adj, void* f_ids,
                           void* f_frm, void* f_dist, void* out_xy,
                           int n_edges, int n_nodes, int is_f64, int device,
                           int leaf, int label, const void* blocked,
                           int n_blocked, void* stream)
{
    (void)out_xy;
    if (!state_ok(n_edges, n_nodes) || leaf < 0 || leaf >= n_nodes
        || n_blocked < 0 || n_blocked > kMaxBlocked
        || (n_blocked > 0 && blocked == nullptr))
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64) {
        closest_bfs_kernel<double><<<1, kThreads, 0, st>>>(
            make_state<double>(e, belong, length, rev, cdis, cid, adj, f_ids,
                               f_frm, f_dist, n_edges, n_nodes),
            leaf, label, (const int32_t*)blocked, n_blocked);
    } else {
        closest_bfs_kernel<float><<<1, kThreads, 0, st>>>(
            make_state<float>(e, belong, length, rev, cdis, cid, adj, f_ids,
                              f_frm, f_dist, n_edges, n_nodes),
            leaf, label, (const int32_t*)blocked, n_blocked);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* insert_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
