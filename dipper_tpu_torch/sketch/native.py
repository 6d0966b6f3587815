"""ctypes bindings for the native host sketcher (native/sketchnat.cpp).

Builds native/libsketchnat.so at first use (utils/native_lib.py). The
host route of the ingest hashes here (--save-sketches, and placement,
D&C and --add where the device route would not fit the card:
distance/mash.py::ingest_route), rank-compresses the u64 bank with
np.unique and uploads the int32 ranks once; where this library cannot be
loaded, `sketch.bank.get_sketch_bank` sketches with the device sketcher
(sketch/minhash.py) instead.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from dipper_tpu_torch.utils.native_lib import native_library

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = native_library("libsketchnat.so", "sketchnat.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.sketchnat_sketch.restype = ctypes.c_int
    lib.sketchnat_sketch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # concatenated sequence bytes
        ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
        ctypes.c_int64,                   # n
        ctypes.c_int,                     # k
        ctypes.c_int,                     # sketch_size
        ctypes.c_int,                     # nthreads
        ctypes.POINTER(ctypes.c_uint64),  # out [n, sketch_size]
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def sketch_sequences_native(seqs, k: int,
                            sketch_size: int) -> Optional[np.ndarray]:
    """Host-native sketch bank: [N, sketch_size] u64, each row the
    ascending bottom-sketch_size murmur hashes (sentinel-padded).
    Bit-identical to sketch_sequences (tests/test_native_sketch.py).
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(seqs)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    buf = np.frombuffer(b"".join(bytes(s) for s in seqs), dtype=np.uint8) \
        if n else np.zeros(0, np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, np.uint8)  # valid pointer for the empty case
    out = np.empty((n, sketch_size), dtype=np.uint64)
    nthreads = min(32, os.cpu_count() or 1)
    rc = lib.sketchnat_sketch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int(k), ctypes.c_int(sketch_size),
        ctypes.c_int(nthreads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        return None
    return out
