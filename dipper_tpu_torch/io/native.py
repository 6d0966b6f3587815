"""ctypes bindings for the native FASTA reader (native/fastio.cpp).

Builds native/libfastio.so at first use (utils/native_lib.py) if a
toolchain is available; falls back silently to the pure-Python reader
otherwise.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from dipper_tpu_torch.utils.native_lib import native_library

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = native_library("libfastio.so", "fastio.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.fastio_read_fasta.restype = ctypes.c_int
    lib.fastio_read_fasta.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastio_free.argtypes = [ctypes.c_void_p]
    try:  # symbol absent in pre-phylip builds of the library
        lib.fastio_read_phylip_lower.restype = ctypes.c_int
        lib.fastio_read_phylip_lower.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
    except AttributeError:
        pass
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_fasta_native(path: str) -> Optional[Tuple[List[str], List[bytes]]]:
    lib = _load()
    if lib is None:
        return None
    seqs_p = ctypes.POINTER(ctypes.c_uint8)()
    off_p = ctypes.POINTER(ctypes.c_int64)()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    n = ctypes.c_int64()
    rc = lib.fastio_read_fasta(
        path.encode(), ctypes.byref(seqs_p), ctypes.byref(off_p),
        ctypes.byref(names_p), ctypes.byref(names_len), ctypes.byref(n),
    )
    if rc != 0:
        return None
    nn = n.value
    offsets = np.ctypeslib.as_array(off_p, shape=(nn + 1,)).copy()
    total = int(offsets[-1])
    buf = np.ctypeslib.as_array(seqs_p, shape=(total,)).copy() if total else \
        np.zeros(0, np.uint8)
    names_raw = ctypes.string_at(names_p, names_len.value)
    names = [s.decode() for s in names_raw.split(b"\0")[:nn]]
    seqs = [buf[offsets[i]:offsets[i + 1]].tobytes() for i in range(nn)]
    lib.fastio_free(seqs_p)
    lib.fastio_free(off_p)
    lib.fastio_free(ctypes.cast(names_p, ctypes.c_void_p))
    return names, seqs


def read_phylip_lower_native(path: str) -> Optional[Tuple[List[str], np.ndarray]]:
    """Parse a lower-triangular PHYLIP matrix with the native reader.
    Returns (names, D) with D a full symmetric [N, N] float64 matrix,
    or None if the library (or a clean parse) is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "fastio_read_phylip_lower"):
        return None
    vals_p = ctypes.POINTER(ctypes.c_double)()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    n = ctypes.c_int64()
    rc = lib.fastio_read_phylip_lower(
        path.encode(), ctypes.byref(vals_p), ctypes.byref(names_p),
        ctypes.byref(names_len), ctypes.byref(n),
    )
    if rc != 0:
        return None
    nn = n.value
    tri = np.ctypeslib.as_array(vals_p, shape=(nn * (nn - 1) // 2,)).copy()
    names_raw = ctypes.string_at(names_p, names_len.value)
    names = [s.decode() for s in names_raw.split(b"\0")[:nn]]
    lib.fastio_free(vals_p)
    lib.fastio_free(ctypes.cast(names_p, ctypes.c_void_p))
    D = np.zeros((nn, nn), dtype=np.float64)
    iu = np.tril_indices(nn, k=-1)
    D[iu] = tri
    D += D.T
    return names, D
