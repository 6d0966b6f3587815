"""Sequence encoding, vectorized with NumPy lookup tables.

Numeric contracts (must match the reference bit-for-bit because they
feed the MinHash pipeline and the MSA pair counts):

- 2-bit codes (src/twoBitCompressor.cpp:5-41): 'A'->0 'C'->1 'G'->2
  'T'->3 'U'->3, anything else (including lowercase!) -> 0.
- 4-bit codes (src/fourBitCompressor.cpp:5-41): same for ACGTU,
  anything else -> 4 (gap/N bucket).

The reference packs into u64 words LSB-first (32 bases/word for 2-bit,
16 for 4-bit). We keep sequences as uint8 code arrays on the host and
pack into int32 words (LSB-first, 16 or 8 codes per word) only for
device transfer; device kernels unpack with shifts.
"""

from __future__ import annotations

import numpy as np

_LUT2 = np.zeros(256, dtype=np.uint8)
_LUT2[ord("C")] = 1
_LUT2[ord("G")] = 2
_LUT2[ord("T")] = 3
_LUT2[ord("U")] = 3

_LUT4 = np.full(256, 4, dtype=np.uint8)
_LUT4[ord("A")] = 0
_LUT4[ord("C")] = 1
_LUT4[ord("G")] = 2
_LUT4[ord("T")] = 3
_LUT4[ord("U")] = 3


def encode_2bit_codes(seq: bytes) -> np.ndarray:
    """bytes -> uint8 codes in {0,1,2,3} (unknown -> 0 = 'A')."""
    return _LUT2[np.frombuffer(seq, dtype=np.uint8)]


def encode_4bit_codes(seq: bytes) -> np.ndarray:
    """bytes -> uint8 codes in {0..4} (gap/N/other -> 4)."""
    return _LUT4[np.frombuffer(seq, dtype=np.uint8)]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes {0..3} -> int32 words, 16 codes per word, LSB-first."""
    return pack_2bit_matrix(codes[None])[0]


def pack_4bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes {0..4} -> int32 words, 8 codes per word, LSB-first."""
    n = len(codes)
    pad = (-n) % 8
    c = np.pad(codes, (0, pad)).astype(np.uint32).reshape(-1, 8)
    shifts = np.arange(8, dtype=np.uint32) * 4
    return (c << shifts).sum(axis=1, dtype=np.uint32).view(np.int32)


def pack_2bit_matrix(codes: np.ndarray) -> np.ndarray:
    """uint8 codes [B, L] {0..3} -> int32 words [B, ceil(L/16)],
    16 codes per word LSB-first. Strided uint8 ORs + a little-endian
    int32 view reproduce the word layout with no integer widening (the
    widening+sum formulation was ~35x slower and dominated ingest)."""
    B, L = codes.shape
    pad = (-L) % 16
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    b = (codes[:, 0::4] | (codes[:, 1::4] << 2)
         | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
    return np.ascontiguousarray(b).view(np.int32)


# Fused encode+pack: one gather over byte PAIRS (little-endian uint16
# view) into a 64K-entry table yields two 2-bit codes per lookup.
_LUT2_PAIR = (_LUT2[np.arange(65536) & 0xFF]
              | (_LUT2[np.arange(65536) >> 8] << 2)).astype(np.uint8)


def encode_pack_2bit_matrix(ascii_mat: np.ndarray) -> np.ndarray:
    """ASCII uint8 [B, L] -> int32 words [B, ceil(L/16)] in one pass
    (same output as pack_2bit_matrix(encode_2bit_codes(...)), same
    unknown->A contract). L must be even."""
    B, L = ascii_mat.shape
    pad = (-L) % 16
    if pad:
        ascii_mat = np.pad(ascii_mat, ((0, 0), (0, pad)))
    pairs = np.ascontiguousarray(ascii_mat).view(np.uint16)
    nib = _LUT2_PAIR[pairs]                       # [B, L/2] of 4-bit halves
    b = nib[:, 0::2] | (nib[:, 1::2] << 4)        # [B, L/4] packed bytes
    return np.ascontiguousarray(b).view(np.int32)


def batch_codes(seqs, encoder, pad_to: int | None = None, pad_value: int = 0):
    """Encode a list of byte sequences into a padded [N, Lmax] uint8
    matrix plus a length vector."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    L = int(lengths.max()) if pad_to is None else pad_to
    out = np.full((len(seqs), L), pad_value, dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = encoder(s)
    return out, lengths
