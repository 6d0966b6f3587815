"""Sketch-bank construction with checkpoint/resume.

The reference persists nothing between runs (SURVEY §5); its D&C host
bank h_hashList is the natural checkpoint unit, realized here as an
.npz of the [N, sketch_size] u64 bank keyed by (k, sketch_size)."""

from __future__ import annotations

import sys

import numpy as np

from dipper_tpu_torch.utils.params import Param


def get_sketch_bank(seqs, params: Param, as_device: bool = False,
                    device=None):
    """Returns the [N, sketch_size] u64 sketch bank, as dipper_tpu/
    sketch/bank.py::get_sketch_bank does. With `as_device=True` and no
    checkpoint I/O asked for, the device sketcher's int64 bank (u64 bit
    patterns) on `device`, for callers that rank-compress it there.
    Otherwise a host uint64 array: loaded from `params.load_sketches`, or
    hashed by the native sketcher, or, where that cannot be built or
    loaded, by the device sketcher on `device` (one log line says so).
    `device` defaults to the card."""
    from dipper_tpu_torch.utils.device import resolve_device

    if as_device and not params.load_sketches and not params.save_sketches:
        from dipper_tpu_torch.sketch.minhash import sketch_sequences

        return sketch_sequences(seqs, params.kmer_size, params.sketch_size,
                                device=resolve_device(device or "cuda"),
                                as_device=True)
    if params.load_sketches:
        data = np.load(params.load_sketches)
        sk = data["sketches"]
        if (int(data["kmer_size"]) != params.kmer_size
                or int(data["sketch_size"]) != params.sketch_size
                or sk.shape[0] != len(seqs)):
            raise SystemExit(
                f"sketch bank mismatch: file has N={sk.shape[0]} "
                f"k={int(data['kmer_size'])} s={int(data['sketch_size'])}, "
                f"run wants N={len(seqs)} k={params.kmer_size} "
                f"s={params.sketch_size}")
        print(f"Loaded sketch bank from {params.load_sketches}",
              file=sys.stderr)
    else:
        from dipper_tpu_torch.sketch.native import sketch_sequences_native

        sk = sketch_sequences_native(seqs, params.kmer_size,
                                     params.sketch_size)
        if sk is None:
            from dipper_tpu_torch.sketch.minhash import sketch_sequences

            dev = resolve_device(device or "cuda")
            print("Native sketcher unavailable (native/libsketchnat.so "
                  f"could not be built or loaded): sketching on {dev}",
                  file=sys.stderr)
            sk = sketch_sequences(seqs, params.kmer_size,
                                  params.sketch_size, device=dev)
    if params.save_sketches:
        np.savez_compressed(
            params.save_sketches, sketches=sk,
            kmer_size=params.kmer_size, sketch_size=params.sketch_size)
        print(f"Saved sketch bank to {params.save_sketches}",
              file=sys.stderr)
    return sk
