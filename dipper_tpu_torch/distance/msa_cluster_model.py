"""A numpy model of csrc/msa_cluster_dist.cu (kernel 12, D&C phase 3's
per-cluster MSA distances). Used by the tests, never by a build: change it
together with the kernel (a test reads the kernel's plan constants).

What it models, as the kernel does it:
- the plan (`plan`): a block a tile of TILE_MEMBERS members (a warp each)
  x TILE_WITNESSES witnesses (a lane each) of one cluster, the grid every
  cluster's tiles; columns in rounds of TILE_WORDS words of 32;
- the staging (`one_hot_words`): a word's four one-hot masks (A, C, G,
  T), bit j the column 32 t + j, from three warp ballots (non-gap, the
  code's two bits); rows and columns past the ends are gaps; a row's
  non-gap count is the sum of its words' non-gap popcounts;
- the bins (`pair_bins`): a pair's 4 x 4 histogram, the popcount of the
  AND of a member mask and a witness mask, added round by round;
- the counts the models read (`counts_from_bins`): P(a, b) the bins,
  P(a, 4) and P(4, b) their row and column sums, P(4, 4) the whole sum;
- the formula (`distance_from_bins`): those counts through the plain
  version's formulas (distance/msa.py::distance_from_counts), which the
  kernel follows operation by operation; the card tests hold the kernel's
  own order against them.
"""

from __future__ import annotations

import numpy as np
import torch

from dipper_tpu_torch.distance.msa import distance_from_counts
from dipper_tpu_torch.utils.device import torch_dtype

TILE_MEMBERS = 8
TILE_WITNESSES = 32
TILE_WORDS = 8
THREADS = TILE_MEMBERS * 32
WORD = 32

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def plan(n_clusters: int, n_wit: int, n_mem: int, L: int) -> dict:
    """The launch: tiles a cluster, blocks, threads and column rounds."""
    tiles_mem = -(-n_mem // TILE_MEMBERS)
    tiles_wit = -(-n_wit // TILE_WITNESSES)
    return {"tiles_mem": tiles_mem, "tiles_wit": tiles_wit,
            "blocks": n_clusters * tiles_mem * tiles_wit,
            "threads": THREADS,
            "rounds": -(-L // (TILE_WORDS * WORD))}


def _popcount(x: np.ndarray) -> np.ndarray:
    """Bits set in each uint32 of x (int64)."""
    b = np.ascontiguousarray(x, dtype=np.uint32).view(np.uint8)
    return _POP8[b].reshape(x.shape + (4,)).sum(axis=-1)


def one_hot_words(codes: np.ndarray) -> np.ndarray:
    """uint8 [R, L] codes -> uint32 [R, 4, words] masks (A, C, G, T) of
    each 32-column word, the words of whole rounds (the tail gaps)."""
    R, L = codes.shape
    words = -(-L // (TILE_WORDS * WORD)) * TILE_WORDS
    padded = np.full((R, words * WORD), 4, dtype=np.uint8)
    padded[:, :L] = codes
    v = padded.reshape(R, words, WORD).astype(np.int64)
    weights = np.uint64(1) << np.arange(WORD, dtype=np.uint64)

    def ballot(pred):
        bits = (pred != 0).astype(np.uint64) * weights
        return bits.sum(axis=-1).astype(np.uint32)

    ng, b0, b1 = ballot(v < 4), ballot(v & 1), ballot(v & 2)
    return np.stack([ng & ~b1 & ~b0, ng & ~b1 & b0, ng & b1 & ~b0,
                     ng & b1 & b0], axis=1)


def nongap_of(words: np.ndarray) -> np.ndarray:
    """[R, 4, words] masks -> each row's non-gap count (int64)."""
    ng = words[:, 0] | words[:, 1] | words[:, 2] | words[:, 3]
    return _popcount(ng).sum(axis=-1)


def pair_bins(words_m: np.ndarray, words_w: np.ndarray) -> np.ndarray:
    """[Q, 4, n] member masks, [W, 4, n] witness masks -> int64 [Q, W, 4, 4]
    bins, bins[k, w, a, b] the columns with member code a and witness code
    b, added a round of TILE_WORDS words at a time."""
    Q, W, n = words_m.shape[0], words_w.shape[0], words_m.shape[2]
    bins = np.zeros((Q, W, 4, 4), dtype=np.int64)
    for t0 in range(0, n, TILE_WORDS):
        m = words_m[:, None, :, None, t0:t0 + TILE_WORDS]
        w = words_w[None, :, None, :, t0:t0 + TILE_WORDS]
        bins += _popcount(m & w).sum(axis=-1)
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


def cluster_dist_model(codes: np.ndarray | torch.Tensor, members: int, *,
                       distance_type: int,
                       dtype_name: str) -> torch.Tensor:
    """The kernel's output for uint8 [c, W, L] codes (each cluster's last
    `members` rows its members) on the CPU: [c, Q, W]."""
    codes = np.asarray(codes.cpu() if torch.is_tensor(codes) else codes)
    c, W, L = codes.shape
    out = torch.empty((c, members, W), dtype=torch_dtype(dtype_name))
    for i in range(c):
        words = one_hot_words(codes[i])
        ng = nongap_of(words)
        bins = pair_bins(words[W - members:], words)
        out[i] = distance_from_bins(bins, ng[W - members:], ng,
                                    distance_type, dtype_name)
    return out
