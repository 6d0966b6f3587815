"""A numpy model of csrc/msa_cluster_dist.cu (kernel 12, D&C phase 3's
per-cluster MSA distances, and its pack). Used by the tests, never by a
build: change it together with the kernel (a test reads the kernel's plan
constants, and a card test holds the built library's plan to `plan`).

What it models, as the kernels do it:
- the pack (`pack`): a row's uint8 codes -> four one-hot bit planes (A,
  C, G, T) of `plane_words(L)` words, bit j of word t the column 32 t + j,
  from four warp ballots a word; columns past L are gaps (0 in every
  plane); the row's non-gap count, the popcounts of the words' OR;
- the plan (`plan`): a cluster of Q members and W witnesses is a grid of
  m-tiles of 4 members (16 rows: member-major, plane-minor) and n-tiles
  of 2 witnesses (8 columns, the same order); a warp takes one m-tile and
  a group of at most MAX_NTILES n-tiles; a block a chunk of `bm` m-tiles x
  `bg` groups (MAX_WARPS warps at most); when one block's groups cover
  every witness, the members are read from the staged witness rows (they
  are the lists' tail), else they are staged on their own;
- the product (`mma_b1`, `a_fragment`, `b_fragment`, `c_scatter`):
  `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`, each of
  the warp's 32 lanes holding A's four registers (row g, k-word t), (g +
  8, t), (g, 4 + t), (g + 8, 4 + t), B's two (column g, t), (g, 4 + t) and
  C's four (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), with g =
  lane / 4, t = lane % 4; C[4m + a, 4w + b] += popcount(A & B) over a
  k-step of STEP_WORDS words is the pair (m, w)'s bin (a, b);
- the epilogue (`cluster_bins`): each warp's C registers written to its
  pairs' bins four n-tiles at a time; a pair's 16 bins through the plain
  version's formulas (`distance_from_bins`, distance/msa.py::
  distance_from_counts), which the kernel follows operation by operation.
"""

from __future__ import annotations

import numpy as np
import torch

from dipper_tpu_torch.distance.msa import PLANE_STEP_WORDS as STEP_WORDS
from dipper_tpu_torch.distance.msa import distance_from_counts, plane_words
from dipper_tpu_torch.utils.device import torch_dtype

WORD = 32
# the cp.async ring: k-steps in flight, and the words a staged row-plane
# takes (8 and 4 of padding, so that a fragment's 32 loads hit 32 banks)
STAGES = 4
STAGE_STRIDE = 12
# n-tiles (2 witnesses each) a warp, warps a block
MAX_NTILES = 10
MAX_WARPS = 16
# n-tiles a round of the epilogue (4 x 8 = 32 pairs: a lane a pair), and
# the words of a pair's bins in shared memory (16 and one of padding)
EPILOGUE_NTILES = 4
BIN_STRIDE = 17
PACK_THREADS = 256

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def _popcount(x: np.ndarray) -> np.ndarray:
    """Bits set in each uint32 of x (int64)."""
    b = np.ascontiguousarray(x, dtype=np.uint32).view(np.uint8)
    return _POP8[b].reshape(x.shape + (4,)).sum(axis=-1)


def pack(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 [R, L] codes (0-3 bases, 4 and above gaps) -> (uint32 [R, 4,
    plane_words(L)] planes, int32 [R] non-gap counts), as the pack kernel
    writes them: a warp a word, a lane a column, one ballot a base."""
    R, L = codes.shape
    words = plane_words(L)
    padded = np.full((R, words * WORD), 4, dtype=np.uint8)
    padded[:, :L] = codes
    v = padded.reshape(R, words, WORD)
    weights = np.uint64(1) << np.arange(WORD, dtype=np.uint64)

    def ballot(pred):
        return (pred.astype(np.uint64) * weights).sum(axis=-1).astype(
            np.uint32)

    planes = np.stack([ballot(v == a) for a in range(4)], axis=1)
    ng = planes[:, 0] | planes[:, 1] | planes[:, 2] | planes[:, 3]
    return planes, _popcount(ng).sum(axis=-1).astype(np.int32)


def plan(n_wit: int, n_mem: int) -> dict:
    """The launch's shape for a chunk of clusters of W = n_wit witnesses,
    the last Q = n_mem of them the members (csrc/msa_cluster_dist.cu::
    make_plan)."""
    m_tiles = -(-n_mem // 4)
    n_tiles = -(-n_wit // 2)
    groups = -(-n_tiles // MAX_NTILES)
    ntg = -(-n_tiles // groups)
    if m_tiles * groups <= MAX_WARPS:
        bm, bg = m_tiles, groups
    elif groups <= MAX_WARPS // 4:
        bm, bg = MAX_WARPS // groups, groups
    else:
        bm, bg = 4, 4
    mem_chunks = -(-m_tiles // bm)
    wit_chunks = -(-groups // bg)
    separate = wit_chunks > 1
    wit_slots = 2 * ntg * bg
    rows = wit_slots + (4 * bm if separate else 0)
    warps = bm * bg
    stage = rows * 4 * STAGE_STRIDE * 4 * STAGES
    bins = warps * EPILOGUE_NTILES * 8 * BIN_STRIDE * 4
    return {"m_tiles": m_tiles, "n_tiles": n_tiles, "groups": groups,
            "ntg": ntg, "bm": bm, "bg": bg, "mem_chunks": mem_chunks,
            "wit_chunks": wit_chunks, "separate": int(separate),
            "wit_slots": wit_slots, "rows": rows, "warps": warps,
            "blocks_per_cluster": mem_chunks * wit_chunks,
            "smem": -(-rows // 4) * 16 + max(stage, bins)}


def a_fragment(tile: np.ndarray) -> np.ndarray:
    """uint32 [16, STEP_WORDS] (rows x k-words) -> [32, 4] registers."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    return np.stack([tile[g, t], tile[g + 8, t], tile[g, 4 + t],
                     tile[g + 8, 4 + t]], axis=1)


def b_fragment(tile: np.ndarray) -> np.ndarray:
    """uint32 [8, STEP_WORDS] (columns x k-words) -> [32, 2] registers."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    return np.stack([tile[g, t], tile[g, 4 + t]], axis=1)


def c_scatter(regs: np.ndarray) -> np.ndarray:
    """[32, 4] accumulator registers -> the int64 [16, 8] tile they hold."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    C = np.zeros((16, 8), dtype=np.int64)
    C[g, 2 * t] = regs[:, 0]
    C[g, 2 * t + 1] = regs[:, 1]
    C[g + 8, 2 * t] = regs[:, 2]
    C[g + 8, 2 * t + 1] = regs[:, 3]
    return C


def mma_b1(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One warp's m16n8k256 .b1 .and.popc: the lanes' registers a [32, 4],
    b [32, 2], c [32, 4] -> d [32, 4]. The tiles are read back from the
    registers by the layout above, so a wrong layout gives wrong bins."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((16, STEP_WORDS), dtype=np.uint32)
    B = np.zeros((8, STEP_WORDS), dtype=np.uint32)
    A[g, t], A[g + 8, t], A[g, 4 + t], A[g + 8, 4 + t] = a.T
    B[g, t], B[g, 4 + t] = b.T
    C = _popcount(A[:, None, :] & B[None, :, :]).sum(axis=-1)
    d = np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                  C[g + 8, 2 * t + 1]], axis=1)
    return c + d


def cluster_bins(planes: np.ndarray, wit: np.ndarray,
                 members: int) -> np.ndarray:
    """The kernel's bins: planes uint32 [N, 4, words], wit [c, W] row ids
    (each cluster's last `members` (Q) its members) -> int64 [c, Q, W, 4,
    4], bins[i, k, w, a, b] the columns with member k's base a and witness
    w's base b, block by block, warp by warp and k-step by k-step."""
    c, W = wit.shape
    Q = members
    words = planes.shape[2]
    p = plan(W, Q)
    bins = np.zeros((c, Q, W, 4, 4), dtype=np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for cl in range(c):
        for mc in range(p["mem_chunks"]):
            for wc in range(p["wit_chunks"]):
                w_base = wc * p["wit_slots"]
                m_base = mc * p["bm"] * 4
                # the staged rows: witness slots, then member slots
                slots = [wit[cl, min(w_base + s, W - 1)]
                         for s in range(p["wit_slots"])]
                if p["separate"]:
                    slots += [wit[cl, W - Q + min(m_base + s, Q - 1)]
                              for s in range(4 * p["bm"])]
                staged = planes[np.asarray(slots)]        # [rows, 4, words]

                def mem_slot(m):
                    m = min(m, Q - 1)
                    return (p["wit_slots"] + m - m_base if p["separate"]
                            else W - Q + m)

                for warp in range(p["warps"]):
                    mt = mc * p["bm"] + warp // p["bg"]
                    grp = wc * p["bg"] + warp % p["bg"]
                    if mt >= p["m_tiles"] or grp >= p["groups"]:
                        continue
                    nt0 = grp * p["ntg"]
                    ntw = min(p["n_tiles"], nt0 + p["ntg"]) - nt0
                    # A's 16 rows: member 4 mt + r // 4, plane r % 4
                    arow = [staged[mem_slot(4 * mt + r // 4), r % 4]
                            for r in range(16)]
                    acc = np.zeros((ntw, 32, 4), dtype=np.int64)
                    for j in range(ntw):
                        bcol = [staged[2 * (nt0 + j) + n // 4 - w_base,
                                       n % 4] for n in range(8)]
                        for s in range(words // STEP_WORDS):
                            k = slice(s * STEP_WORDS, (s + 1) * STEP_WORDS)
                            a = a_fragment(np.stack([x[k] for x in arow]))
                            b = b_fragment(np.stack([x[k] for x in bcol]))
                            acc[j] = mma_b1(a, b, acc[j])
                    # the epilogue: lane regs -> pairs' bins
                    for j in range(ntw):
                        for r, (mi, ab) in enumerate(
                                [(g >> 2, 0), (g >> 2, 1),
                                 ((g >> 2) + 2, 0), ((g >> 2) + 2, 1)]):
                            m = 4 * mt + mi
                            w = 2 * (nt0 + j) + (t >> 1)
                            a_, b_ = g & 3, 2 * (t & 1) + ab
                            ok = (m < Q) & (w < W)
                            bins[cl, m[ok], w[ok], a_[ok], b_[ok]] = \
                                acc[j, ok, r]
    return bins


def counts_from_bins(bins: np.ndarray) -> np.ndarray:
    """[Q, W, 4, 4] bins -> int32 [Q, 5, W, 5] counts in pair_counts'
    layout (channel 4 the non-gap channel)."""
    Q, W = bins.shape[:2]
    P = np.zeros((Q, W, 5, 5), dtype=np.int64)
    P[:, :, :4, :4] = bins
    P[:, :, :4, 4] = bins.sum(axis=3)
    P[:, :, 4, :4] = bins.sum(axis=2)
    P[:, :, 4, 4] = bins.sum(axis=(2, 3))
    return P.transpose(0, 2, 1, 3).astype(np.int32)


def distance_from_bins(bins: np.ndarray, ng_m: np.ndarray, ng_w: np.ndarray,
                       distance_type: int, dtype_name: str) -> torch.Tensor:
    """One cluster's [Q, W] distances from its bins and the rows' non-gap
    counts (the member the row side), through distance/msa.py::
    distance_from_counts, the formulas whose order the kernel keeps."""
    dtype = torch_dtype(dtype_name)
    return distance_from_counts(
        torch.from_numpy(counts_from_bins(bins)),
        torch.as_tensor(ng_m, dtype=dtype), torch.as_tensor(ng_w, dtype=dtype),
        distance_type=distance_type, dtype_name=dtype_name)


def cluster_dist_model(planes, nongap, wit, members: int, *,
                       distance_type: int, dtype_name: str) -> torch.Tensor:
    """The kernel's output on the CPU: planes [N, 4, words] (uint32 bits,
    numpy or an int32 tensor), nongap [N], wit [c, W] row ids -> [c, Q,
    W] distances d(member k, witness w)."""
    def host(x):
        return np.asarray(x.cpu() if torch.is_tensor(x) else x)

    planes = host(planes).view(np.uint32)
    nongap, wit = host(nongap), host(wit).astype(np.int64)
    bins = cluster_bins(planes, wit, members)
    c, W = wit.shape
    out = torch.empty((c, members, W), dtype=torch_dtype(dtype_name))
    for i in range(c):
        out[i] = distance_from_bins(bins[i], nongap[wit[i, W - members:]],
                                    nongap[wit[i]], distance_type,
                                    dtype_name)
    return out
