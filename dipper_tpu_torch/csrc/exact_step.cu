// One insertion of exact placement on Hopper (sm_90a), in one launch: the
// level order of the tree, both sweeps, the score, the splice and the depth
// shift of the splice's subtree. The insertion, the slots in use and the
// distance row come from a cursor on the card, which the launch advances,
// so one captured CUDA graph of launches serves every stretch of an insert
// range and an insertion needs no host round trip.
//
// Replaces the body of the JAX package's exact insert loop,
// dipper_tpu/placement/exact.py::_exact_insert_loop (:231-270), an XLA
// program and not Pallas: `_compute_lims` (:84-157, the up and down
// while_loops over levels), `_score_exact` (:159-181) and `_splice_exact`
// (:183-229, with the parent-pointer propagation of the depth shift). The
// plain version is the port's tensor code, placement/exact.py::
// exact_insertion_step (the CPU path, and this kernel's yardstick on the
// card); placement/exact_model.py is a numpy model of this file's plan.
//
// Entry points, none synchronizing:
//
// - exact_step: one block of kExactThreads threads on the caller's
//   stream; insertion i = cursor[0] at slots cursor[1] .. cursor[1] + 3,
//   distance row cursor[2] + (i - cursor[4]) * cursor[3] elements; the
//   cursor advances by one insertion (i + 1; slots + 4). `out` gets the
//   chosen slot, the tree's greatest depth, the positions walked, the
//   levels and nodes of the depth shift and a status (0: done). Its last
//   word is sticky: a failed insertion leaves the tree and the cursor as
//   they are and writes its status there, and a launch that finds it
//   nonzero does nothing, so a failure inside a replayed graph survives
//   to the host's check after the range.
// - exact_cursor_set writes a cursor; exact_step_preload loads every
//   kernel of this library, so that a capture loads none.
//
// The plan (one block; the state and the scratch stay in L2):
//
// - The walk: position 0 is the root N. A level's entries are taken in
//   chunks of the block's threads; each entry reads its adjacency row and
//   its upward edge's length, its children (adjacency slots but the upward
//   edge) are placed by a block-wide prefix sum in flat (entry, slot)
//   order, and each child's downward edge, its reverse (the child's upward
//   edge), the child and the edge's length are written at its position.
//   The level starts go to shared memory (the first kLevels) and to the
//   scratch. The walk ends at an empty level: the greatest depth is the
//   number of levels less one.
// - The up-sweep, levels maxdep .. 1, a thread a position: the maximum of
//   the node's base (the row's value for a leaf, 0 otherwise) and its
//   children's limup - lenup (children sit next to each other in the next
//   level); NaN wins, as in the plain version's scatter maximum.
// - The down-sweep, levels 0 .. maxdep - 1, a thread a position with
//   children: the values of its at most three incident edges (lim of the
//   reverse less the edge's length), then the plain version's top-2 rule
//   for each child.
// - The score: each thread scores its positions' downward edges with
//   edge_score and their upward edges at SENT_DIS (frac 0), keeping the
//   first minimum in torch.argmin's order; block_min takes the block's, and
//   the thread that held it names its position.
// - The splice: thread 0 reads the chosen edge's ends, reverse, length and
//   the ends' depths; the block shifts the depths of ch's subtree (the
//   chosen position's), whose positions at each level are the range from
//   the first one's children to the last one's last child, with no barrier;
//   thread 0 writes the six slots, the three nodes' parents, the two new
//   nodes' depths and adjacency rows, and the cursor.
//
// Data the launch writes (the scratch) is read with plain loads, never
// through the read-only path. A walk that finds more nodes than M, a
// cursor out of range or a choice the splice cannot take leaves the tree
// and the cursor as they are and sets the status and the sticky error.
//
// What bounds it: neither bytes nor operations. An insertion at 30,000
// taxa moves ~1.5 MB (0.0004 ms at the card's memory rate); its levels
// are a chain of about 3 dependent L2 round trips a level in the walk and
// one or two in each sweep (~0.04 ms at depth 84). On an H100 (700 W) a
// launch took 0.43 ms at 49,155 nodes and depth 84, and 0.45 ms at 60,000
// nodes and depth 30: the time follows the nodes. Every position is read and
// written by the walk, both sweeps and the score, and one block on one
// multiprocessor has only so many loads in flight.
//
// Arithmetic as the plain version's, operation by operation, with
// round-to-nearest intrinsics; T = float or double.

#include "insert_step.cuh"

namespace {

using namespace dipper;

constexpr int kExactThreads = 1024;
constexpr int kExactWarps = kExactThreads / kWarp;
// level starts kept in shared memory; deeper ones are read from scratch
constexpr int kLevels = 2048;
constexpr double kSentDis = 2.0;  // placement/kclosest.py::SENT_DIS

// the cursor: insertion i, slots in use, the address of the range's first
// distance row, the rows' stride in elements, the range's first insertion
enum { kCurI = 0, kCurUsed, kCurRows, kCurStride, kCurLo };
// out: chosen slot, greatest depth, positions, depth-shift levels and
// nodes, status, and the sticky error (the first failed status; 0: none)
enum {
    kOutEid = 0, kOutMaxdep, kOutPositions, kOutShift, kOutShiftNodes,
    kOutStatus, kOutError, kOutLen
};
enum { kDone = 0, kBadCursor = 1, kOverflow = 2, kBadChoice = 3 };

template <typename T>
struct ExactState {
    int32_t* e;       // [E] destination node
    int32_t* belong;  // [E] source node
    T* length;        // [E]
    int32_t* rev;     // [E]
    int32_t* parent;  // [M] (M: none)
    int32_t* dep;     // [M]
    int32_t* adj;     // [M, 3] out-edges of each node, -1 empty
    int n_edges, n_nodes, n_leaves;
};

// The level order, by position: node, upward edge (node -> parent),
// downward edge (parent -> node), children's first position and count,
// level starts ([M + 2]); lengths and lims of both edges.
template <typename T>
struct Scratch {
    int32_t *node, *up, *dn, *cs, *nc, *lstart;
    T *lenup, *lendn, *limup, *limdn;
};

template <typename T>
struct ExactShared {
    int warp_sum[kExactWarps];
    Cand<T> part[kExactWarps];
    int lstart[kLevels];
    long long cur[5];
    Cand<T> win;
    int win_pos, status, n_levels, halted;
};

// torch.maximum and the scatter maximum: NaN wins, a's first
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b)
{
    return a != a ? a : (b != b ? b : (b > a ? b : a));
}

template <typename T>
__device__ __forceinline__ int level_start(const ExactShared<T>& sh,
                                           const Scratch<T>& w, int l)
{
    return l < kLevels ? sh.lstart[l] : w.lstart[l];
}

template <typename T>
__device__ __forceinline__ void set_level_start(ExactShared<T>& sh,
                                                const Scratch<T>& w, int l,
                                                int v)
{
    if (l < kLevels) sh.lstart[l] = v;
    w.lstart[l] = v;
}

// The walk from the root; returns the positions, sh.n_levels gets the
// levels (0 on overflow, with the status set)
template <typename T>
__device__ int walk_levels(const ExactState<T>& s, const Scratch<T>& w,
                           ExactShared<T>& sh)
{
    const int M = s.n_nodes, E = s.n_edges;
    if (threadIdx.x == 0) {
        w.node[0] = s.n_leaves;
        w.up[0] = -1;
        w.dn[0] = -1;
        w.lendn[0] = T(0);
        set_level_start(sh, w, 0, 0);
        set_level_start(sh, w, 1, 1);
    }
    __syncthreads();
    int a = 0, b = 1, levels = 0;
    bool overflow = false;
    while (a < b) {
        int next = b;
        for (int base = a; base < b; base += kExactThreads) {
            const int p = base + threadIdx.x;
            int r[kDegree] = {-1, -1, -1};
            bool kid[kDegree] = {false, false, false};
            int kids = 0;
            if (p < b) {
                const int u = w.node[p], up = w.up[p];
                if (u >= 0 && u < M) {
#pragma unroll
                    for (int j = 0; j < kDegree; ++j)
                        r[j] = s.adj[(size_t)u * kDegree + j];
                }
                w.lenup[p] = (up >= 0 && up < E) ? s.length[up] : T(0);
#pragma unroll
                for (int j = 0; j < kDegree; ++j) {
                    kid[j] = r[j] >= 0 && r[j] < E && r[j] != up;
                    kids += kid[j] ? 1 : 0;
                }
            }
            int total;
            const int at = next + block_exclusive_scan<kExactThreads>(
                                      kids, sh.warp_sum, &total);
            if (p < b) {
                w.cs[p] = at;
                w.nc[p] = kids;
                int q = at;
#pragma unroll
                for (int j = 0; j < kDegree; ++j) {
                    if (!kid[j] || q >= M) continue;
                    const int c = s.e[r[j]], rv = s.rev[r[j]];
                    const T len = s.length[r[j]];
                    w.node[q] = c;
                    w.up[q] = rv;
                    w.dn[q] = r[j];
                    w.lendn[q] = len;
                    ++q;
                }
            }
            next += total;
        }
        if (next > M) {
            overflow = true;
            next = b;  // end the walk
        }
        __syncthreads();  // this level's entries before the next's reads
        a = b;
        b = next;
        ++levels;
        if (threadIdx.x == 0) set_level_start(sh, w, levels + 1, b);
    }
    if (threadIdx.x == 0) {
        sh.n_levels = overflow ? 0 : levels;
        if (overflow) sh.status = kOverflow;
    }
    __syncthreads();
    return b;
}

template <typename T>
__device__ void up_sweep(const ExactState<T>& s, const Scratch<T>& w,
                         const ExactShared<T>& sh, const T* __restrict__ row,
                         int maxdep)
{
    for (int l = maxdep; l >= 1; --l) {
        const int lo = level_start(sh, w, l), hi = level_start(sh, w, l + 1);
        for (int p = lo + threadIdx.x; p < hi; p += kExactThreads) {
            const int u = w.node[p];
            const T base = (u >= 0 && u < s.n_leaves) ? __ldg(row + u) : T(0);
            const int c0 = w.cs[p], nc = w.nc[p];
            T cm = T(-INFINITY);
            for (int j = 0; j < nc; ++j)
                cm = nan_max(cm, sub_rn(w.limup[c0 + j], w.lenup[c0 + j]));
            w.limup[p] = nan_max(base, cm);
        }
        __syncthreads();
    }
}

template <typename T>
__device__ void down_sweep(const Scratch<T>& w, const ExactShared<T>& sh,
                           int maxdep)
{
    for (int l = 0; l < maxdep; ++l) {
        const int lo = level_start(sh, w, l), hi = level_start(sh, w, l + 1);
        for (int p = lo + threadIdx.x; p < hi; p += kExactThreads) {
            const int nc = w.nc[p];
            if (nc == 0) continue;
            const int c0 = w.cs[p];
            // the upward edge's value first, then the children's
            T v[kDegree + 1];
            bool has[kDegree + 1];
            has[0] = p > 0;
            v[0] = has[0] ? sub_rn(w.limdn[p], w.lenup[p]) : T(0);
#pragma unroll
            for (int j = 0; j < kDegree; ++j) {
                has[j + 1] = j < nc;
                v[j + 1] = has[j + 1]
                               ? sub_rn(w.limup[c0 + j], w.lendn[c0 + j])
                               : T(0);
            }
            T max1 = T(-INFINITY);
#pragma unroll
            for (int j = 0; j <= kDegree; ++j)
                if (has[j]) max1 = nan_max(max1, v[j]);
            int cnt = 0;
            T max2 = T(-INFINITY);
#pragma unroll
            for (int j = 0; j <= kDegree; ++j) {
                if (!has[j]) continue;
                if (v[j] == max1)
                    ++cnt;
                else
                    max2 = nan_max(max2, v[j]);
            }
#pragma unroll
            for (int j = 0; j < kDegree; ++j) {
                if (!has[j + 1]) continue;
                const T excl = v[j + 1] == max1 ? (cnt > 1 ? max1 : max2)
                                                : max1;
                w.limdn[c0 + j] = clamp0(excl);
            }
        }
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(kExactThreads)
exact_step_kernel(ExactState<T> s, Scratch<T> w, long long* cursor,
                  int32_t* out)
{
    __shared__ ExactShared<T> sh;
    if (threadIdx.x < 5) sh.cur[threadIdx.x] = cursor[threadIdx.x];
    if (threadIdx.x == 0) {
        sh.status = kDone;
        sh.win_pos = -1;
        sh.halted = out[kOutError];
    }
    __syncthreads();
    if (sh.halted != 0) return;  // an earlier insertion failed
    const long long ci = sh.cur[kCurI], cu = sh.cur[kCurUsed];
    const int N = s.n_leaves;
    const bool cursor_ok = cu >= 4 && cu <= s.n_edges - 4 && ci >= 2
                           && ci < N && ci + N - 1 < s.n_nodes
                           && sh.cur[kCurRows] != 0 && ci >= sh.cur[kCurLo];
    int positions = 0, maxdep = -1, shift = 0, shifted = 0;
    if (cursor_ok) {
        const T* row = reinterpret_cast<const T*>(sh.cur[kCurRows])
                       + (ci - sh.cur[kCurLo]) * sh.cur[kCurStride];
        positions = walk_levels(s, w, sh);
        maxdep = sh.n_levels - 1;
        if (maxdep >= 0 && positions >= 2) {
            up_sweep(s, w, sh, row, maxdep);
            down_sweep(w, sh, maxdep);
            // the score: two candidates a position past the root
            Cand<T> best = no_cand<T>();
            int best_pos = -1;
            for (int p = 1 + threadIdx.x; p < positions;
                 p += kExactThreads) {
                Cand<T> c;
                edge_score(w.limdn[p], w.limup[p], w.lendn[p], &c.score,
                           &c.frac);
                c.slot = w.dn[p];
                if (before(c, best)) {
                    best = c;
                    best_pos = p;
                }
                const Cand<T> inv = {T(kSentDis), T(0), w.up[p]};
                if (before(inv, best)) {
                    best = inv;
                    best_pos = p;
                }
            }
            const Cand<T> win = block_min<T, kExactWarps>(best, sh.part);
            if (threadIdx.x == 0) sh.win = win;
            __syncthreads();
            if (best_pos >= 0 && best.slot == sh.win.slot) sh.win_pos = best_pos;
            __syncthreads();
        } else if (threadIdx.x == 0 && sh.status == kDone) {
            sh.status = kOverflow;
        }
    } else if (threadIdx.x == 0) {
        sh.status = kBadCursor;
    }
    __syncthreads();
    // the splice: thread 0 reads the choice's ends before the depth shift
    __shared__ int sp[6];  // eid, x, y, ye, pa, ch
    __shared__ int sp_dpa;
    __shared__ T sp_orig;
    if (threadIdx.x == 0 && sh.status == kDone) {
        const int eid = sh.win.slot, pos = sh.win_pos;
        if (eid < 0 || eid >= s.n_edges || pos < 1 || pos >= positions) {
            sh.status = kBadChoice;
        } else {
            const int x = s.belong[eid], y = s.e[eid], ye = s.rev[eid];
            if (x < 0 || x >= s.n_nodes || y < 0 || y >= s.n_nodes || ye < 0
                || ye >= s.n_edges) {
                sh.status = kBadChoice;
            } else {
                const int dx = s.dep[x], dy = s.dep[y];
                const int pa = dx < dy ? x : y, ch = dx < dy ? y : x;
                if (w.node[pos] != ch) {
                    sh.status = kBadChoice;
                } else {
                    sp[0] = eid;
                    sp[1] = x;
                    sp[2] = y;
                    sp[3] = ye;
                    sp[4] = pa;
                    sp[5] = ch;
                    sp_dpa = dx < dy ? dx : dy;
                    sp_orig = s.length[eid];
                }
            }
        }
    }
    __syncthreads();
    if (sh.status == kDone) {
        // ch's subtree, level by level: no barrier, the ranges are read-only
        int a = sh.win_pos, b = a + 1;
        while (a < b) {
            for (int q = a + threadIdx.x; q < b; q += kExactThreads) {
                const int v = w.node[q];
                s.dep[v] = s.dep[v] + 1;
            }
            const int na = w.cs[a], nb = w.cs[b - 1] + w.nc[b - 1];
            shifted += b - a;
            a = na;
            b = nb;
            ++shift;
        }
        if (threadIdx.x == 0) {
            const int eid = sp[0], x = sp[1], y = sp[2], ye = sp[3];
            const int pa = sp[4], ch = sp[5];
            const int i = (int)ci, i0 = (int)cu;
            const int i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3;
            const int middle = i + N - 1, outside = i;
            const T frac = sh.win.frac, add = sh.win.score;
            const T rest = sub_rn(sp_orig, frac);
            // the plain version's writes, in its order
            const int at[6] = {eid, ye, i0, i1, i2, i3};
            const int to[6] = {middle, middle, x, y, middle, outside};
            const int rv[6] = {i0, i1, eid, ye, i3, i2};
            const T ln[6] = {frac, rest, frac, rest, add, add};
#pragma unroll
            for (int j = 0; j < 6; ++j) {
                s.e[at[j]] = to[j];
                s.rev[at[j]] = rv[j];
                s.length[at[j]] = ln[j];
            }
            s.belong[i0] = middle;
            s.belong[i1] = middle;
            s.belong[i2] = outside;
            s.belong[i3] = middle;
            s.dep[middle] = sp_dpa + 1;
            s.dep[outside] = sp_dpa + 2;
            s.parent[ch] = middle;
            s.parent[middle] = pa;
            s.parent[outside] = middle;
            int32_t* am = s.adj + (size_t)middle * kDegree;
            int32_t* ao = s.adj + (size_t)outside * kDegree;
            am[0] = i0;
            am[1] = i1;
            am[2] = i3;
            ao[0] = i2;
            ao[1] = -1;
            ao[2] = -1;
        }
    }
    if (threadIdx.x == 0) {
        out[kOutEid] = sh.status == kDone ? sh.win.slot : -1;
        out[kOutMaxdep] = maxdep;
        out[kOutPositions] = positions;
        out[kOutShift] = shift;
        out[kOutShiftNodes] = shifted;
        out[kOutStatus] = sh.status;
        if (sh.status == kDone) {
            cursor[kCurI] = ci + 1;
            cursor[kCurUsed] = cu + 4;
        } else {
            out[kOutError] = sh.status;
        }
    }
}

__global__ void exact_cursor_set_kernel(long long* cursor, long long i,
                                        long long used, long long rows,
                                        long long stride, long long lo)
{
    cursor[kCurI] = i;
    cursor[kCurUsed] = used;
    cursor[kCurRows] = rows;
    cursor[kCurStride] = stride;
    cursor[kCurLo] = lo;
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

template <typename T>
void launch(void* const* p, void* const* q, int n_edges, int n_nodes,
            int n_leaves, void* cursor, void* out, cudaStream_t st)
{
    const ExactState<T> s = {(int32_t*)p[0], (int32_t*)p[1], (T*)p[2],
                             (int32_t*)p[3], (int32_t*)p[4], (int32_t*)p[5],
                             (int32_t*)p[6], n_edges, n_nodes, n_leaves};
    // int scratch [6, M + 2], float scratch [4, M]
    int32_t* si = (int32_t*)q[0];
    T* sf = (T*)q[1];
    const size_t m2 = (size_t)n_nodes + 2, m = (size_t)n_nodes;
    const Scratch<T> w = {si, si + m2, si + 2 * m2, si + 3 * m2,
                          si + 4 * m2, si + 5 * m2, sf, sf + m, sf + 2 * m,
                          sf + 3 * m};
    exact_step_kernel<T><<<1, kExactThreads, 0, st>>>(
        s, w, (long long*)cursor, (int32_t*)out);
}

}  // namespace

// One insertion of exact placement from the cursor (int64 [5]). State: e,
// belong, length, rev, parent, dep, adj ([M, 3]); scratch: int32 [6, M + 2]
// and T [4, M]; out: int32 [7], its last word (the sticky error) 0 before
// the state's first launch; n_edges, n_nodes (M), n_leaves (N, also the
// root's id); is_f64 (float or double lengths and rows); the device.
// Launches on `stream` without synchronizing; returns the CUDA error code.
extern "C" int exact_step(void* e, void* belong, void* length, void* rev,
                          void* parent, void* dep, void* adj, void* scratch_i,
                          void* scratch_f, void* out, void* cursor,
                          int n_edges, int n_nodes, int n_leaves, int is_f64,
                          int device, void* stream)
{
    if (n_edges < 4 || n_nodes < 3 || n_nodes > (1 << 29) || n_leaves < 2
        || n_leaves >= n_nodes || cursor == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    void* const p[7] = {e, belong, length, rev, parent, dep, adj};
    void* const q[2] = {scratch_i, scratch_f};
    cudaStream_t st = (cudaStream_t)stream;
    if (is_f64)
        launch<double>(p, q, n_edges, n_nodes, n_leaves, cursor, out, st);
    else
        launch<float>(p, q, n_edges, n_nodes, n_leaves, cursor, out, st);
    return (int)cudaGetLastError();
}

// Writes the cursor (int64 [5]): i, slots in use, the address of the
// range's first distance row, the rows' stride in elements, the range's
// first insertion.
extern "C" int exact_cursor_set(void* cursor, long long i, long long used,
                                long long rows, long long stride,
                                long long lo, int device, void* stream)
{
    if (cursor == nullptr) return (int)cudaErrorInvalidValue;
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    exact_cursor_set_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long*)cursor, i, used, rows, stride, lo);
    return (int)cudaGetLastError();
}

// Loads every kernel of the library on `device` (under lazy module loading
// a kernel is loaded at its first launch, which a stream capture must not
// be).
extern "C" int exact_step_preload(int device)
{
    OnDevice on(device);
    if (on.err != cudaSuccess) return (int)on.err;
    cudaFuncAttributes a;
    const void* fns[] = {(const void*)exact_step_kernel<float>,
                         (const void*)exact_step_kernel<double>,
                         (const void*)exact_cursor_set_kernel};
    for (const void* f : fns) {
        const cudaError_t err = cudaFuncGetAttributes(&a, f);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

extern "C" const char* exact_step_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
