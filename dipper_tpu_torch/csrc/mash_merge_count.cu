// Mash sketch intersection counts on Hopper (sm_90a).
//
// Replaces the TPU kernel dipper_tpu/distance/mash_pallas.py::
// _merge_count_kernel (body _merge_count_one, launcher mash_inter_pallas).
// Same contract: bank ranks int32 [N, M] (the already-placed side "A",
// rows ascending), query ranks int32 [Q, M] (the new taxon "B"), both
// padded to M >= S columns; out int32 [Q, N] = the reference merge-walk's
// `inter` (src/mash.cu:426-449, tests/oracle.py::mash_distance): every B
// element equal to an A element counts (asymmetric multiset rule), and
// the walk stops once `uni` (A elements plus unmatched B elements)
// reaches S. Only the first S columns of a row are ever read, so pad
// columns and non-pow2 S need no special case.
//
// What bounds it on this card: integer operations. A pair takes S + inter
// steps of about 4 operations (a compare, a pointer advance, two counter
// updates); at 30,000 x 8,192 pairs and S = 1,000 that is some 10^12
// operations, tens of milliseconds at the card's int32 rate, while the
// bytes (each row once, the [Q, N] output once) take a third of a
// millisecond. The TPU kernel restates the walk as a bitonic network plus
// two scans because its vector unit has no cheap data-dependent control;
// here the walk itself runs, split over the lanes of a warp.
//
// What the design does about it (mash_walk.cuh has the details): query and
// bank rows are staged in shared memory in tiles through 16-byte cp.async
// copies, the bank tiles double-buffered, so every device-memory read is
// coalesced and a staged row serves a whole tile of pairs; a warp takes a
// pair, its lanes split the walk by merge path and walk from shared memory;
// the stop at uni == S is found from the lanes' step bits, so the result is
// the serial walk's, bit for bit. Counts leave through a result tile in
// shared memory as rows of neighbouring values.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mash_walk.cuh"

// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (0 on success), or mash::kSketchTooLarge (-1) when one row a side (a
// query row and two bank rows of s + 1 ranks, and one result) does not fit
// the block's 232,448 bytes of shared memory. Pointers are device pointers
// to contiguous int32 arrays: bank [n_bank, m], query [n_query, m], out
// [n_query, n_bank].
extern "C" int mash_merge_count(const void* bank, const void* query,
                                void* out, int n_bank, int n_query, int m,
                                int s, void* stream)
{
    if (s < 1 || s > m || n_bank < 1 || n_query < 1)
        return (int)cudaErrorInvalidValue;
    return mash::launch_tiles<int32_t, false>(
        bank, query, nullptr, out, n_bank, n_query, m, s, n_bank,
        (cudaStream_t)stream);
}

extern "C" const char* mash_merge_count_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
