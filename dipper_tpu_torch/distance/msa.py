"""MSA (aligned-FASTA) distances through one pair-count matrix product.

Behavioral spec: src/MSA.cu:81-268 — six distance models over 4-bit
codes (A=0 C=1 G=2 T=3, gap/other=4):

  1 uncorrected   1 - match/useful, useful = columns where EITHER side
                  is non-gap, match = both non-gap and equal (:89-100)
  2 JC            -0.75 ln(1 - p/0.75) over the same p (:233-236)
  3 Tajima-Nei    reference variant: pr[] counts only the AG/AT/CG/CT
                  unordered pairs and h uses raw pair counts (:239-251)
  4 K2P           -0.5 ln((1-2p-q) sqrt(1-2q)) (:253-257)
  5 Tamura        gc1/gc2 counted on mismatch columns only (:260-264)
  6 Jin-Nei       0.5 (1/(1-2p-q) + 0.5/(1-2q) - 1.5) (:258)

As in dipper_tpu/distance/msa.py, every pairwise count comes from one
matrix product. Each sequence i becomes 5 indicator channels Phi[i] in
{0,1}^[5, L] (A, C, G, T, nongap); then

    P = Phi_blk_i  @  Phi_blk_j^T     # [Bi*5, L] x [L, Bj*5]

holds every joint count needed by all six models:
    P[a,b] (a,b<4) = pair count; P[a,4] = a vs non-gap; P[4,4] = tot.
`useful` additionally needs per-sequence non-gap totals (vector).

The counts are exact integers on both devices (`pair_counts`): an int8
product with an int32 result on CUDA, a float32 product of 0/1 values
on the CPU. The formulas then run in the run's float type, in the
reference's operation order, on the [Bi, Bj] slices of P a model reads;
NaN (log of a negative), +-inf and 0/0 of divergent or all-gap pairs are
kept as the formulas give them. Blocks are ragged at the edges (no
padding rows), and their sizes are set from the bytes of the count block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dipper_tpu_torch.utils.device import torch_dtype

# Longest alignment taken: a count can reach L, and it passes through
# float32 (the CPU product's accumulator, and the cast to an f32 run's
# type), which holds every integer up to 2**24.
MAX_COLUMNS = 2 ** 24

# bytes of one block's int32 counts [Bi, Bj, 5, 5]; the blocks of
# msa_tiled_block and msa_distance_matrix are sized to stay below it
COUNT_BYTES = 2 ** 30
_PAIR_BYTES = 25 * 4


def build_channels(codes: np.ndarray) -> np.ndarray:
    """uint8 [N, L] codes -> int8 [N, 5, L] indicator channels (host)."""
    N, L = codes.shape
    out = np.zeros((N, 5, L), dtype=np.int8)
    for a in range(4):
        out[:, a, :] = codes == a
    out[:, 4, :] = codes < 4
    return out


def one_hot_channels(codes: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] codes -> int8 [..., 5, L] indicator channels on the
    codes' device (the twin of build_channels: the resident bank stays
    [N, L] bytes and is expanded a tile at a time)."""
    c = codes.unsqueeze(-2)
    a = torch.arange(4, dtype=codes.dtype, device=codes.device)[:, None]
    return torch.cat([c == a, c < 4], dim=-2).to(torch.int8)


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """x zero-padded along `dim` up to `size` entries."""
    if x.shape[dim] >= size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pair_counts(phi_i: torch.Tensor, phi_j: torch.Tensor) -> torch.Tensor:
    """phi_i int8 [Bi, 5, L], phi_j int8 [Bj, 5, L] -> int32 [Bi, 5, Bj, 5]
    joint counts P[i, a, j, b] = #columns with channel a of i and channel b
    of j set, exact on both devices for L <= MAX_COLUMNS.

    CUDA: torch._int_mm, an int8 product on the tensor cores summed in
    int32 (what the reference's int8 dot_general with an int32 result is
    on its device). It takes more than 16 rows and inner and outer sizes
    that are multiples of 8, so the operands are zero-padded up to that
    and the result is cut back; zero rows and columns count nothing.
    CPU: a float32 product of the 0/1 channels; every partial sum is an
    integer below 2**24, so the sum is exact in any order."""
    Bi, _, L = phi_i.shape
    Bj = phi_j.shape[0]
    if phi_j.shape[2] != L or phi_i.device != phi_j.device:
        raise ValueError(f"channel blocks differ: {tuple(phi_i.shape)} on "
                         f"{phi_i.device}, {tuple(phi_j.shape)} on "
                         f"{phi_j.device}")
    if L > MAX_COLUMNS:
        raise ValueError(f"alignment of {L} columns is longer than "
                         f"{MAX_COLUMNS}, the most for which the pair "
                         "counts are exact")
    A = phi_i.reshape(Bi * 5, L)
    B = phi_j.reshape(Bj * 5, L)
    if phi_i.device.type == "cuda":
        Lp = _round_up(L, 8)
        A = _pad_to(_pad_to(A, 1, Lp), 0, 24)
        B = _pad_to(_pad_to(B, 1, Lp), 0, _round_up(Bj * 5, 8))
        P = torch._int_mm(A, B.t())[:Bi * 5, :Bj * 5]
    elif phi_i.device.type == "cpu":
        P = (A.float() @ B.float().t()).to(torch.int32)
    else:
        raise ValueError(f"unsupported device {phi_i.device}")
    return P.reshape(Bi, 5, Bj, 5)


def _block_distance(phi_i, phi_j, nongap_i, nongap_j, *, distance_type: int,
                    dtype_name: str) -> torch.Tensor:
    """phi_i [Bi,5,L] int8, phi_j [Bj,5,L] int8, nongap_* in the run's
    type -> [Bi,Bj] distances. The counts a model reads are cast to the
    run's type one [Bi,Bj] slice at a time (the values the reference gets
    by casting all of P first); every operation after that is the
    reference's, in its order and type."""
    return distance_from_counts(pair_counts(phi_i, phi_j), nongap_i,
                                nongap_j, distance_type=distance_type,
                                dtype_name=dtype_name)


def distance_from_counts(P4, nongap_i, nongap_j, *, distance_type: int,
                         dtype_name: str) -> torch.Tensor:
    """int32 [Bi,5,Bj,5] pair counts (pair_counts' layout), nongap_* in
    the run's type -> [Bi,Bj] distances: _block_distance's formulas."""
    dtype = torch_dtype(dtype_name)

    def P(a: int, b: int) -> torch.Tensor:
        return P4[:, a, :, b].to(dtype)

    tot = P(4, 4)
    match = P(0, 0) + P(1, 1) + P(2, 2) + P(3, 3)

    if distance_type in (1, 2):
        useful = nongap_i[:, None] + nongap_j[None, :] - tot
        uncor = 1.0 - match / useful
        if distance_type == 1:
            return uncor
        # a tensor divisor: by a Python scalar, PyTorch's CUDA division
        # multiplies by the rounded reciprocal, which is not uncor / 0.75
        # in the last place (and this sits next to the model's pole)
        three_quarters = torch.full((), 0.75, dtype=dtype, device=tot.device)
        return -0.75 * torch.log(1.0 - uncor / three_quarters)

    p = P(0, 2) + P(2, 0) + P(1, 3) + P(3, 1)
    if distance_type == 3:
        frA = (P(0, 4) + P(4, 0)) / tot / 2.0
        frC = (P(1, 4) + P(4, 1)) / tot / 2.0
        frG = (P(2, 4) + P(4, 2)) / tot / 2.0
        frT = (P(3, 4) + P(4, 3)) / tot / 2.0
        prAG = P(0, 2) + P(2, 0)
        prAT = P(0, 3) + P(3, 0)
        prCG = P(1, 2) + P(2, 1)
        prCT = P(1, 3) + P(3, 1)
        h = 0.5 * (prAG * frA * frG + prAT * frA * frT
                   + prCG * frC * frG + prCT * frC * frT)
        DD = (tot - match) / tot
        b = 0.5 * (1.0 - frA * frA - frG * frG + DD * DD / h)
        return -b * torch.log(1.0 - DD / b)

    q = tot - match - p
    pp = p / tot
    qq = q / tot
    if distance_type == 4:
        return -0.5 * torch.log((1 - 2 * pp - qq) * torch.sqrt(1 - 2 * qq))
    if distance_type == 6:
        return 0.5 * (1.0 / (1 - 2 * pp - qq) + 0.5 / (1 - 2 * qq) - 1.5)
    if distance_type == 5:
        gc1 = (P(1, 4) - P(1, 1)) + (P(2, 4) - P(2, 2))
        gc2 = (P(4, 1) - P(1, 1)) + (P(4, 2) - P(2, 2))
        c = gc1 / tot + gc2 / tot - 2.0 * gc1 * gc2 / tot / tot
        return (-c * torch.log(1 - pp / c - qq)
                - 0.5 * (1 - c) * torch.log(1 - 2 * qq))
    return torch.zeros(tot.shape, dtype=dtype, device=tot.device)


def _fit_rows(row_block: int | None, cols: int) -> int:
    """Rows of a count block with `cols` columns: `row_block` if given,
    else as many as COUNT_BYTES holds (at least 8; a multiple of 64 where
    it can be, a shape the int8 product's library kernels tile)."""
    if row_block is not None:
        return max(1, row_block)
    rows = max(8, COUNT_BYTES // (_PAIR_BYTES * max(cols, 1)))
    return rows // 64 * 64 if rows >= 64 else rows


def msa_tiled_block(codes_q, nongap_q, codes_bank, nongap_bank, *,
                    distance_type: int, dtype_name: str,
                    bank_tile: int = 4096,
                    row_block: int | None = None) -> torch.Tensor:
    """[B, L] query codes x [Nb, L] bank codes -> [B, Nb] distances on
    the codes' device.

    The bank stays packed codes (1 byte a base); each tile of `bank_tile`
    rows is one-hot expanded as it is used, so the transient is one
    [tile, 5, L] int8 block and one count block, not a resident
    [N, 5, L] bank. Queries go `row_block` at a time (default: what
    keeps a count block under COUNT_BYTES). The last tile and block are
    ragged. The math of a pair does not depend on its block, so neither
    size changes a bit of the result."""
    B = codes_q.shape[0]
    Nb = codes_bank.shape[0]
    T = max(1, min(bank_tile, Nb))
    R = _fit_rows(row_block, T)
    out = torch.empty((B, Nb), dtype=torch_dtype(dtype_name),
                      device=codes_q.device)
    for s in range(0, Nb, T):
        phi_b = one_hot_channels(codes_bank[s:s + T])
        ng_b = nongap_bank[s:s + T]
        for r in range(0, B, R):
            out[r:r + R, s:s + T] = _block_distance(
                one_hot_channels(codes_q[r:r + R]), phi_b,
                nongap_q[r:r + R], ng_b, distance_type=distance_type,
                dtype_name=dtype_name)
    return out


@dataclasses.dataclass
class ClusterBank:
    """D&C's aligned set: the host's uint8 codes [N, L] (phase 2's query
    rows, streamed clusters and the plain route gather from them) and, on
    the card, their one-hot bit planes int32 [N, 4, plane_words(L)] and
    non-gap counts int32 [N], resident for kernel 12 (msa_cuda.pack_bank).
    """
    codes: np.ndarray
    planes: torch.Tensor | None = None
    nongap: torch.Tensor | None = None


# bytes of codes gathered on the host for cluster distances by this
# process (the plain route and streamed clusters); D&C's bucket lines log
# its growth, 0 on the card's batched route
GATHERED_BYTES = 0

# words of one m16n8k256 k-step (256 columns): a plane's words are whole
# k-steps (csrc/msa_cluster_dist.cu's kStepWords)
PLANE_STEP_WORDS = 8


def plane_words(L: int) -> int:
    """Words of one bit plane of a row of L columns: ceil(L / 32) rounded
    up to whole k-steps of the kernel's product."""
    return -(-L // (32 * PLANE_STEP_WORDS)) * PLANE_STEP_WORDS


def pack_planes_plain(codes: torch.Tensor) -> tuple:
    """uint8 [R, L] codes (0-3 bases, 4 and above gaps) -> (int32 [R, 4,
    plane_words(L)] planes, int32 [R] non-gap counts) on the codes' device:
    bit j of plane a, word t, set when column 32 t + j holds base a (the
    uint32 bits kept in int32); columns past L are gaps. The plain version
    of csrc/msa_cluster_dist.cu's pack: shifts and sums."""
    R, L = codes.shape
    words = plane_words(L)
    padded = torch.full((R, words * 32), 4, dtype=torch.uint8,
                        device=codes.device)
    padded[:, :L] = codes
    v = padded.view(R, words, 32)
    bit = torch.ones((), dtype=torch.int64, device=codes.device) << \
        torch.arange(32, dtype=torch.int64, device=codes.device)
    planes = torch.stack([((v == a).to(torch.int64) * bit).sum(dim=-1)
                          for a in range(4)], dim=1)
    planes = torch.where(planes >= 2**31, planes - 2**32, planes)
    return (planes.to(torch.int32),
            (codes < 4).sum(dim=1).to(torch.int32))


def check_lists(wit, n_rows: int) -> None:
    """Raises unless every row id of the witness lists `wit` (host) lies
    in [0, n_rows)."""
    wit = np.asarray(wit)
    if wit.size and (wit.min() < 0 or wit.max() >= n_rows):
        raise ValueError(f"witness ids span [{wit.min()}, {wit.max()}], "
                         f"outside the bank's [0, {n_rows})")


def packs_planes(device) -> bool:
    """Whether D&C packs its aligned set into resident planes: on the
    card."""
    return torch.device(device).type == "cuda"


def uses_cluster_dist_kernel(bank: ClusterBank) -> bool:
    """Whether a chunk's cluster distances go to kernel 12: the bank's
    planes are on the card."""
    return bank.planes is not None and bank.planes.device.type == "cuda"


def cluster_distances(bank: ClusterBank, wit: np.ndarray, members: int, *,
                      device, distance_type: int,
                      dtype_name: str) -> torch.Tensor:
    """D&C phase 3's distances of a chunk of clusters: wit [c, W] host row
    ids of `bank`, each cluster's witness list ending with its `members`
    (Q) members (wit = [head, mem], as phase 3 builds the lists) -> [c, Q,
    W] distances d(member k, witness w) on `device`. On the card one launch
    of kernel 12 on the resident planes (distance/msa_cuda.py), only the
    lists uploaded; else the plain version, from the host codes."""
    if uses_cluster_dist_kernel(bank):
        from dipper_tpu_torch.distance import msa_cuda

        wit_d = msa_cuda.witness_lists(wit, len(bank.codes),
                                       bank.planes.device)
        return msa_cuda.cluster_dist(bank.planes, bank.nongap, wit_d,
                                     members, distance_type=distance_type,
                                     dtype_name=dtype_name)
    return cluster_dist_by_index_plain(bank.codes, wit, members,
                                       distance_type=distance_type,
                                       dtype_name=dtype_name, device=device)


def cluster_dist_by_index_plain(codes, wit, members: int, *,
                                distance_type: int, dtype_name: str,
                                device=None) -> torch.Tensor:
    """Kernel 12's plain version: uint8 [N, L] codes, wit [c, W] row ids ->
    [c, Q, W] distances: the codes gathered by the lists and
    cluster_block_distances_plain on them. A tensor's are gathered on its
    device; a host array's on the host (its ids checked first), into
    pinned memory for a card `device` (default the CPU)."""
    global GATHERED_BYTES
    if torch.is_tensor(codes):
        if codes.device.type == "cpu":
            check_lists(np.asarray(torch.as_tensor(wit)), len(codes))
        codes_w = codes[torch.as_tensor(wit, device=codes.device).long()]
    else:
        wit = np.asarray(wit.cpu() if torch.is_tensor(wit) else wit)
        check_lists(wit, len(codes))
        if device is not None and torch.device(device).type == "cuda":
            # gathered straight into pinned memory: an upload without a
            # host sync (mode="clip": with the default "raise" numpy
            # gathers into a temporary and copies it out; the ids are
            # checked above)
            codes_w = torch.empty(wit.shape + codes.shape[1:],
                                  dtype=torch.uint8, pin_memory=True)
            np.take(codes, wit, axis=0, out=codes_w.numpy(), mode="clip")
            codes_w = codes_w.to(device, non_blocking=True)
        else:
            codes_w = torch.from_numpy(codes[wit])
        GATHERED_BYTES += codes_w.numel()
    return cluster_block_distances_plain(codes_w, members,
                                         distance_type=distance_type,
                                         dtype_name=dtype_name)


def cluster_block_distances_plain(codes_w: torch.Tensor, members: int, *,
                                  distance_type: int,
                                  dtype_name: str) -> torch.Tensor:
    """Distances of a chunk of clusters from their gathered codes: uint8
    [c, W, L], each cluster's W witness rows ending with its `members` (Q)
    member rows -> [c, Q, W], one _block_distance call a cluster on the
    codes' device (cluster_dist_by_index_plain's body)."""
    c, W, L = codes_w.shape
    if c == 0:
        return torch.empty((0, members, W), dtype=torch_dtype(dtype_name),
                           device=codes_w.device)
    codes_m = codes_w[:, W - members:]
    return torch.stack([
        _block_distance(one_hot_channels(m), one_hot_channels(w),
                        nongap_counts(m, dtype_name),
                        nongap_counts(w, dtype_name),
                        distance_type=distance_type, dtype_name=dtype_name)
        for w, m in zip(codes_w, codes_m)])


def nongap_counts(codes: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """Per-sequence non-gap column counts of uint8 [N, L] codes, in the
    run's type (as the reference holds them)."""
    return (codes < 4).sum(dim=1).to(torch_dtype(dtype_name))


def msa_distance_matrix(codes, distance_type: int, dtype_name: str, device,
                        row_block: int | None = None) -> torch.Tensor:
    """Full [N, N] distance matrix (symmetric, zero diagonal) of uint8
    [N, L] codes (host array or tensor), on `device`: the counterpart of
    dipper_tpu/distance/msa.py::msa_distance_matrix_device. The channel
    bank [N, 5, L] is resident and row blocks of it (default: what keeps a
    count block under COUNT_BYTES) meet the whole bank.

    Orientation: the count matrix P uses a = row-side code and b =
    column-side; every model is symmetric in (gc1, gc2)/(frac)/(pr), so
    whole row blocks are computed at once."""
    codes_d = torch.as_tensor(codes).to(device)
    N = codes_d.shape[0]
    nongap = nongap_counts(codes_d, dtype_name)
    phi = one_hot_channels(codes_d)
    rb = _fit_rows(row_block, N)
    out = torch.empty((N, N), dtype=torch_dtype(dtype_name), device=device)
    for s in range(0, N, rb):
        out[s:s + rb] = _block_distance(
            phi[s:s + rb], phi, nongap[s:s + rb], nongap,
            distance_type=distance_type, dtype_name=dtype_name)
    out.fill_diagonal_(0.0)
    return out
