// Mash sketch distances of query rows against a bank, on Hopper (sm_90a).
//
// Replaces the TPU kernel dipper_tpu/distance/mash_pallas.py::
// mash_rows_vs_bank_pallas: the merge-count kernel's intersection counts
// put through the [s+1] distance table. Contract: bank ranks int32 [N, M]
// (the already-placed side "A", rows ascending), query ranks int32 [Q, M]
// (the new taxon "B"), M >= s; table T [s+1] (the host's
// distance/mash.py::_dist_table, T = float or double); out T [Q, N] with
// row stride ldo >= N, out[q, n] = table[inter(bank n, query q)]. Equal
// counts index the same table entry, so the result is bitwise equal to
// the plain version, inter_to_dist(merged_inter_count_ref(...)).
//
// What bounds it on this card: as for mash_merge_count.cu, the integer
// operations of the walk (s + inter steps a pair); the bytes are far below
// them, and the table lookup is one shared-memory read a pair.
//
// What the design does about it: mash_merge_count.cu's kernel (tiles of
// both sides staged in shared memory by coalesced cp.async copies, a warp
// a pair, the walk split over the lanes by merge path; mash_walk.cuh), with
// the table staged once per block in front of the tiles. The distance goes
// into the block's result tile and from there straight into the output, so
// the int32 count never reaches device memory and no second gather pass
// runs. The row stride lets a caller fill a block of rows of a larger
// [N, N] matrix in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mash_walk.cuh"

// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (0 on success), or mash::kSketchTooLarge (-1) when the [s+1] table and
// one row a side (a query row and two bank rows of s + 1 ranks, and one
// result) do not fit the block's 232,448 bytes of shared memory. Pointers
// are device pointers: bank int32 [n_bank, m] and query int32 [n_query, m],
// contiguous; table [s+1] and out [n_query, ldo] of float (is_f64 == 0) or
// double (is_f64 != 0).
extern "C" int mash_rows_dist(const void* bank, const void* query,
                              const void* table, void* out, int n_bank,
                              int n_query, int m, int s, long long ldo,
                              int is_f64, void* stream)
{
    if (s < 1 || s > m || n_bank < 1 || n_query < 1 || ldo < n_bank)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return is_f64 ? mash::launch_tiles<double, true>(
                        bank, query, table, out, n_bank, n_query, m, s, ldo,
                        st)
                  : mash::launch_tiles<float, true>(
                        bank, query, table, out, n_bank, n_query, m, s, ldo,
                        st);
}

extern "C" const char* mash_rows_dist_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
