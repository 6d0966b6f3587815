"""MinHash (Mash) sketching on the device.

Behavioral spec (src/mash.cu:239-369), as dipper_tpu/sketch/minhash.py
computes it:
- every k-mer window j in [0, len-k] of the 2-bit-encoded sequence,
- canonical form = lexicographically smaller of the forward and
  reverse-complement character strings: with MSB-first 2-bit packing,
  lex order is numeric order, and the reverse complement in MSB-first
  form is the bitwise complement of the forward k-mer in LSB-first form,
- hash = low 64 bits of MurmurHash3_x64_128(canonical chars, k,
  seed=42); k <= 15, so only the tail path of the hash runs,
- sketch = the sketch_size smallest hashes as a MULTISET (duplicates
  kept), ascending, padded with 0xFFFF_FFFF_FFFF_FFFF (SENTINEL).

Windows at pos > len - k, which include the zero padding of a batch,
are masked by length, never by content. A sketch bank is an int64
tensor of u64 bit patterns.

CUDA tensors go to the Hopper kernel (sketch/minhash_cuda.py, csrc/
minhash_sketch.cu), which raises on failure; CPU tensors take
`sketch_batch_plain`, the plain PyTorch version. The plain version keeps
every 64-bit value as two u32 limbs in int64 tensors, multiplies through
16-bit halves so that every product is exact in int64 (it never relies
on int64 overflow wrapping), and takes the bottom-k with torch.sort on
the value with its sign bit flipped, so that signed order is unsigned
order.

`sketch_sequences` is the host-side entry point: it packs the ASCII
into int32 words (16 codes a word, LSB-first, io/encode.py), batches
rows sorted by length under a byte budget, makes one host-to-device
copy a batch and returns the rows in input order.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
_INT64_MIN = -(2**63)
# the sentinel with its sign bit flipped: the largest sortable key
_KEY_SENTINEL = 2**63 - 1

_C1 = (0x87C37B91, 0x114253D5)
_C2 = (0x4CF5AD43, 0x2745937F)
_F1 = (0xFF51AFD7, 0xED558CCD)
_F2 = (0xC4CEB9FE, 0x1A85EC53)

# 'A','C','G','T' ASCII bytes packed LSB-first: byte i is the character
# of 2-bit code i
_ASCII_PACKED = 0x54474341

# windows of one plain-version tile (bounds its [rows, tile] transients)
_PLAIN_TILE = 2048
# bytes of one plain-version row chunk's transients (about 24 live
# int64 [rows, tile] arrays)
_PLAIN_CHUNK_BYTES = 2**27

# device bytes of one batch of sketch_sequences: its packed words, the
# kernel's scratch and its output, reckoned per row from the batch's
# longest row
_BATCH_BYTES = 2**30


# --- 64-bit arithmetic on (hi, lo) u32 limbs held in int64 tensors -------

def _mul32_full(x, y: int):
    """x (values in [0, 2^32)) * the constant y -> the 64-bit product as
    (hi, lo) limbs, through 16-bit halves (every partial product and sum
    stays below 2^33)."""
    xl, xh = x & _M16, x >> 16
    yl, yh = y & _M16, y >> 16
    ll = xl * yl
    mid = xl * yh + (ll >> 16)
    mid2 = xh * yl + (mid & _M16)
    hi = xh * yh + (mid >> 16) + (mid2 >> 16)
    lo = ((mid2 & _M16) << 16) | (ll & _M16)
    return hi, lo


def _mullo32(x, y: int):
    """(x * y) mod 2^32 for x in [0, 2^32) and the constant y."""
    xl, xh = x & _M16, x >> 16
    yl, yh = y & _M16, y >> 16
    return (xl * yl + ((xl * yh + xh * yl) << 16)) & _M32


def _mul64(a, c):
    """(hi, lo) * the constant (chi, clo) mod 2^64."""
    chi, clo = c
    hi, lo = _mul32_full(a[1], clo)
    hi = (hi + _mullo32(a[1], chi) + _mullo32(a[0], clo)) & _M32
    return hi, lo


def _xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _add64(a, b):
    lo = a[1] + b[1]
    hi = (a[0] + b[0] + (lo >> 32)) & _M32
    return hi, lo & _M32


def _shr64(a, r: int):
    hi, lo = a
    if r < 32:
        return hi >> r, ((lo >> r) | (hi << (32 - r))) & _M32
    return torch.zeros_like(hi), hi >> (r - 32)


def _shl64(a, r: int):
    hi, lo = a
    if r < 32:
        return ((hi << r) | (lo >> (32 - r))) & _M32, (lo << r) & _M32
    return (lo << (r - 32)) & _M32, torch.zeros_like(lo)


def _rotl64(a, r: int):
    h1, l1 = _shl64(a, r)
    h2, l2 = _shr64(a, 64 - r)
    return h1 | h2, l1 | l2


def _fmix64(k):
    k = _xor(k, _shr64(k, 33))
    k = _mul64(k, _F1)
    k = _xor(k, _shr64(k, 33))
    k = _mul64(k, _F2)
    return _xor(k, _shr64(k, 33))


def _murmur_tail_limbs(k1, k2, klen: int):
    """MurmurHash3_x64_128's low 64 bits for keys of klen in [1, 15]
    bytes; k1, k2 are the little-endian key words as (hi, lo) limbs.
    Returns (hi, lo)."""
    if not 1 <= klen <= 15:
        raise ValueError(f"klen {klen} outside [1, 15]")
    z = torch.zeros_like(k1[1])
    h1 = (z, z + 42)
    h2 = (z, z + 42)
    if klen > 8:
        kk2 = _mul64(_rotl64(_mul64(k2, _C2), 33), _C1)
        h2 = _xor(h2, kk2)
    kk1 = _mul64(_rotl64(_mul64(k1, _C1), 31), _C2)
    h1 = _xor(h1, kk1)
    h1 = (h1[0], h1[1] ^ klen)
    h2 = (h2[0], h2[1] ^ klen)
    h1 = _add64(h1, h2)
    h2 = _add64(h2, h1)
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return _add64(h1, h2)


def _split(x: torch.Tensor):
    """int64 bit patterns -> (hi, lo) u32 limbs (an arithmetic shift and
    a mask make the logical shift)."""
    return (x >> 32) & _M32, x & _M32


def _join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) limbs -> int64 bit patterns, with no overflowing
    product: hi is read as a signed 32-bit value first."""
    return (hi - ((hi >> 31) << 32)) * 2**32 + lo


def murmur3_low64_tail(k1: torch.Tensor, k2: torch.Tensor,
                       klen: int) -> torch.Tensor:
    """k1/k2: int64 bit patterns of the little-endian u64 key words ->
    int64 bit patterns of the hash's low 64 bits (the plain version)."""
    hi, lo = _murmur_tail_limbs(_split(k1), _split(k2), klen)
    return _join(hi, lo)


# --- the plain version ---------------------------------------------------

def unpack_codes(words: torch.Tensor) -> torch.Tensor:
    """int32 [B, W] packed words (16 codes a word, LSB-first) -> uint8
    codes [B, 16 W]."""
    w = words.to(torch.int64) & _M32
    shifts = torch.arange(0, 32, 2, device=words.device)
    return ((w[:, :, None] >> shifts) & 3).to(torch.uint8).reshape(
        words.shape[0], -1)


def window_keys(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                p0: int, p1: int) -> torch.Tensor:
    """Sortable keys of windows [p0, p1) of every row: the hash with its
    sign bit flipped (signed order = unsigned order), the sentinel's
    key (2^63 - 1) where pos > len - k. codes uint8 [B, L] with
    p1 + k - 1 <= L."""
    if not 2 <= k <= 15:
        raise ValueError(f"k {k} outside [2, 15]")
    n = p1 - p0
    fwd_lex = torch.zeros((codes.shape[0], n), dtype=torch.int64,
                          device=codes.device)
    fwd_lsb = torch.zeros_like(fwd_lex)
    for i in range(k):
        c = codes[:, p0 + i:p1 + i].to(torch.int64)
        fwd_lex |= c << (2 * (k - 1 - i))
        fwd_lsb |= c << (2 * i)
    mask = (1 << (2 * k)) - 1
    canon = torch.minimum(fwd_lex, ~fwd_lsb & mask)
    words = [torch.zeros_like(canon) for _ in range(4)]  # k1lo k1hi k2lo k2hi
    for i in range(k):
        code = (canon >> (2 * (k - 1 - i))) & 3
        char = (_ASCII_PACKED >> (code << 3)) & 0xFF
        words[i // 4] |= char << (8 * (i % 4))
    hi, lo = _murmur_tail_limbs((words[1], words[0]), (words[3], words[2]),
                                k)
    key = (hi - 2**31) * 2**32 + lo
    pos = torch.arange(p0, p1, device=codes.device)
    valid = pos[None, :] <= (lengths.to(torch.int64)[:, None] - k)
    return torch.where(valid, key, _KEY_SENTINEL)


def _bottom_keys(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                 sketch_size: int, tile: int) -> torch.Tensor:
    """Ascending bottom-sketch_size window keys of every row, the
    sentinel key past the last window: a running bottom-k over tiles of
    `tile` windows."""
    B, L = codes.shape
    P = L - k + 1
    best = torch.empty((B, 0), dtype=torch.int64, device=codes.device)
    for p0 in range(0, P, tile):
        keys = window_keys(codes, lengths, k, p0, min(P, p0 + tile))
        best = torch.cat([best, keys], dim=1).sort(dim=1).values[
            :, :sketch_size]
    if best.shape[1] < sketch_size:
        pad = torch.full((B, sketch_size - best.shape[1]), _KEY_SENTINEL,
                         dtype=torch.int64, device=codes.device)
        best = torch.cat([best, pad], dim=1)
    return best


def sketch_batch_plain(words: torch.Tensor, lengths: torch.Tensor, *, k: int,
                       sketch_size: int, tile: int = _PLAIN_TILE,
                       chunk_bytes: int = _PLAIN_CHUNK_BYTES) -> torch.Tensor:
    """Plain PyTorch version of the sketch kernel: int32 [B, W] packed
    codes, int32 [B] lengths -> int64 [B, sketch_size] sketches (u64 bit
    patterns), in chunks of rows and tiles of windows that bound the
    transients to about `chunk_bytes` (any split gives the same bits)."""
    B, W = words.shape
    out = torch.empty((B, sketch_size), dtype=torch.int64,
                      device=words.device)
    step = max(1, chunk_bytes // (24 * 8 * min(tile, 16 * W)))
    for r0 in range(0, B, step):
        codes = unpack_codes(words[r0:r0 + step])
        keys = _bottom_keys(codes, lengths[r0:r0 + step], k, sketch_size,
                            tile)
        out[r0:r0 + step] = keys ^ _INT64_MIN
    return out


# --- the entry points ----------------------------------------------------

def sketch_batch_device_packed(words: torch.Tensor, lengths: torch.Tensor, *,
                               k: int, sketch_size: int) -> torch.Tensor:
    """int32 [B, W] packed codes (16 a word, LSB-first), int32 [B]
    lengths -> int64 [B, sketch_size] sketches (u64 bit patterns), each
    row ascending as u64, sentinel-padded. CUDA tensors go to the
    kernel (which raises on failure), CPU tensors to the plain version."""
    if words.device.type == "cuda":
        from dipper_tpu_torch.sketch.minhash_cuda import minhash_sketch_cuda

        return minhash_sketch_cuda(words, lengths, k=k,
                                   sketch_size=sketch_size)
    if words.device.type == "cpu":
        return sketch_batch_plain(words, lengths, k=k,
                                  sketch_size=sketch_size)
    raise ValueError(f"unsupported device {words.device}")


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes [B, L] in {0..3} -> int32 words [B, ceil(L/16)], 16
    codes a word LSB-first (io/encode.py::pack_2bit_matrix's layout),
    on the codes' device."""
    B, L = codes.shape
    pad = (-L) % 16
    c = torch.nn.functional.pad(codes.to(torch.int64), (0, pad))
    shifts = torch.arange(0, 32, 2, device=codes.device)
    w = (c.reshape(B, -1, 16) << shifts).sum(dim=2)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def sketch_batch_device(codes: torch.Tensor, lengths: torch.Tensor, *,
                        k: int, sketch_size: int) -> torch.Tensor:
    """uint8 [B, L] 2-bit codes (padded), int32 [B] lengths -> int64
    [B, sketch_size] sketches: the codes packed on their device, then
    sketch_batch_device_packed."""
    return sketch_batch_device_packed(pack_codes(codes), lengths, k=k,
                                      sketch_size=sketch_size)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _row_bytes(L: np.ndarray, k: int, sketch_size: int) -> np.ndarray:
    """Device bytes a row of length L costs in a batch (an upper bound):
    packed words, the kernel's scratch (minhash_cuda.row_scratch_bound)
    and the output."""
    from dipper_tpu_torch.sketch.minhash_cuda import row_scratch_bound

    W = (np.maximum(L, k) + 15) // 16
    return 4 * W + 8 * (row_scratch_bound(W, k, sketch_size)
                        + sketch_size) + 12


def sketch_sequences(seqs, k: int, sketch_size: int = 1000, *, device,
                     as_device: bool = False):
    """Sketch a list of byte sequences on `device`.
    Returns the [N, sketch_size] bank: a NumPy uint64 array, or with
    `as_device=True` the int64 tensor of u64 bit patterns on `device`
    (no device-to-host copy; for callers that rank-compress it there).

    Rows go in order of length (stable), in batches whose device bytes
    stay under _BATCH_BYTES; a batch's ASCII is packed on the host
    (io/encode.py::encode_pack_2bit_matrix), its words, lengths and row
    ids go to the device in one copy, and its sketches are written into
    the bank at their input rows."""
    from dipper_tpu_torch.io.encode import encode_pack_2bit_matrix

    device = torch.device(device)
    N = len(seqs)
    out = torch.empty((N, sketch_size), dtype=torch.int64, device=device)
    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=N)
    order = np.argsort(lengths, kind="stable")
    s = 0
    while s < N:
        # the batch [s, e) costs (e - s) rows at its longest row's bytes
        cost = np.arange(1, N - s + 1) * _row_bytes(lengths[order[s:]], k,
                                                    sketch_size)
        e = s + max(1, int(np.searchsorted(cost, _BATCH_BYTES, "right")))
        idx = order[s:e]
        s = e
        lens = lengths[idx]
        Lpad = _round_up(max(int(lens[-1]), k), 16)
        ascii_mat = np.zeros((len(idx), Lpad), dtype=np.uint8)
        if lens[0] == lens[-1]:
            cat = b"".join(seqs[i] for i in idx)
            ascii_mat[:, :lens[0]] = np.frombuffer(
                cat, dtype=np.uint8).reshape(len(idx), lens[0])
        else:
            for r, i in enumerate(idx):
                ascii_mat[r, :lens[r]] = np.frombuffer(seqs[i], np.uint8)
        words = encode_pack_2bit_matrix(ascii_mat)
        B, W = words.shape
        host = np.concatenate([words.reshape(-1), lens.astype(np.int32),
                               idx.astype(np.int32)])
        buf = torch.from_numpy(host).to(device)
        sk = sketch_batch_device_packed(
            buf[:B * W].view(B, W), buf[B * W:B * W + B], k=k,
            sketch_size=sketch_size)
        out.index_copy_(0, buf[B * W + B:].long(), sk)
    if as_device:
        return out
    return out.cpu().numpy().view(np.uint64)
