// The reference Mash merge walk for one (bank row, query row) pair, shared
// by mash_merge_count.cu (the count) and mash_rows_dist.cu (the distance),
// so that the two kernels cannot drift apart.
//
// a: the bank row ("A", the already-placed taxon), b: the query row ("B",
// the new taxon), both ascending int32 ranks of which only the first s are
// read. Returns the walk's `inter` (src/mash.cu:426-449,
// tests/oracle.py::mash_distance): every B element equal to an A element
// counts (asymmetric multiset rule), and the walk stops once `uni` (A
// elements plus unmatched B elements) reaches s. The result lies in
// [0, s].

#pragma once

#include <stdint.h>

__device__ __forceinline__ int mash_walk_inter(const int32_t* a,
                                               const int32_t* b, int s)
{
    int uni = 0, inter = 0, ai = 0, bi = 0;
    int aval = a[0], bval = b[0];
    // one step consumes the smaller head; on a tie B goes first and
    // matches. ai <= uni < s holds inside the loop, so the A reads stay in
    // the row's first s columns.
    while (uni < s) {
        if (bi < s && bval <= aval) {
            inter += (bval == aval);
            uni += (bval != aval);
            ++bi;
            bval = bi < s ? b[bi] : 0;
        } else {
            ++uni;
            ++ai;
            aval = ai < s ? a[ai] : 0;
        }
    }
    return inter;
}
