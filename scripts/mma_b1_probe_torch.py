#!/usr/bin/env python3
"""Probes the one-bit tensor-core instruction that kernel 12
(dipper_tpu_torch/csrc/msa_cluster_dist.cu) computes its pair bins with,
`mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc` (AND then
popcount), on this card: it compiles a small source with csrc/build.py's
flags, counts each function's BMMA, IMMA, HMMA and POPC instructions
(chip_smoke.sass_functions), checks on random operands that the
fragments' register layout the kernel assumes gives numpy's product (A's
registers (row g, k-word t), (row g + 8, t), (g, 4 + t), (g + 8, 4 + t),
B's (column g, t), (g, 4 + t), C's (g, 2t), (g, 2t + 1), (g + 8, 2t),
(g + 8, 2t + 1), with g = lane / 4, t = lane % 4, a k-word 32 one-bit
elements), and times its throughput over the whole card beside the int8
`mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`'s (8 independent
accumulators a warp, CUDA events), the rate chip_smoke.planes_bound
takes for it. One JSON line, with the card's name and power limit; needs
a CUDA card:

    python3 scripts/mma_b1_probe_torch.py
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import sass_functions  # noqa: E402
from dipper_tpu_torch.csrc.build import (BUILD_DIR, NVCC_FLAGS,  # noqa: E402
                                         _nvcc)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_b1(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2])
{
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2])
{
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A: 16 rows x 8 words, B: 8 columns x 8 words (words of 32 one-bit
// elements, k along the words); C 16 x 8.
__global__ void tile_kernel(const unsigned* A, const unsigned* B, int* C)
{
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    const unsigned a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t],
                           A[g * 8 + 4 + t], A[(g + 8) * 8 + 4 + t]};
    const unsigned b[2] = {B[g * 8 + t], B[g * 8 + 4 + t]};
    int d[4] = {0, 0, 0, 0};
    mma_b1(d, a, b);
    C[g * 8 + 2 * t] = d[0];
    C[g * 8 + 2 * t + 1] = d[1];
    C[(g + 8) * 8 + 2 * t] = d[2];
    C[(g + 8) * 8 + 2 * t + 1] = d[3];
}

template <bool B1>
__global__ void rate_kernel(int* sink, int iters, unsigned seed)
{
    unsigned a[4], b[2];
    for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 7 * i + 1);
    for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 13 + i);
    int d[8][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (B1) mma_b1(d[j], a, b); else mma_s8(d[j], a, b);
        }
    }
    int s = 0;
    for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
    if (s == 0x7fffffff) sink[blockIdx.x] = s;
}

extern "C" int probe_tile(const void* A, const void* B, void* C)
{
    tile_kernel<<<1, 32>>>((const unsigned*)A, (const unsigned*)B, (int*)C);
    return (int)cudaGetLastError();
}

extern "C" int probe_rate(void* sink, int blocks, int threads, int iters,
                          int b1)
{
    if (b1)
        rate_kernel<true><<<blocks, threads>>>((int*)sink, iters, 12345u);
    else
        rate_kernel<false><<<blocks, threads>>>((int*)sink, iters, 12345u);
    return (int)cudaGetLastError();
}
"""


def reference(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """C = A B^T over the k bits of the words: popcount of the AND."""
    a = np.unpackbits(A.view(np.uint8), axis=1, bitorder="little")
    b = np.unpackbits(B.view(np.uint8), axis=1, bitorder="little")
    return a.astype(np.int64) @ b.astype(np.int64).T


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    res = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "device": torch.cuda.get_device_name(0)}
    try:
        res["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError as e:
        res["nvidia_smi"] = repr(e)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mma_probe_", dir=BUILD_DIR)
    src = os.path.join(tmp, "probe.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    lib_path = os.path.join(tmp, "libprobe.so")
    p = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib_path, src],
                       capture_output=True, text=True, timeout=900)
    res["nvcc_rc"] = p.returncode
    res["nvcc_tail"] = p.stdout[-1500:] + p.stderr[-1500:]
    if p.returncode != 0:
        print(json.dumps(res))
        return 1
    res["sass"] = {name: {k: sum(op == k for _, op, _ in ins)
                          for k in ("BMMA", "IMMA", "HMMA", "POPC")}
                   for name, ins in sass_functions(lib_path).items()}
    lib = ctypes.CDLL(lib_path)
    lib.probe_tile.argtypes = [ctypes.c_void_p] * 3
    lib.probe_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    A = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    a = torch.from_numpy(A.view(np.int32).copy()).to(dev)
    b = torch.from_numpy(B.view(np.int32).copy()).to(dev)
    c = torch.zeros((16, 8), dtype=torch.int32, device=dev)
    rc = lib.probe_tile(a.data_ptr(), b.data_ptr(), c.data_ptr())
    torch.cuda.synchronize()
    res["layout"] = {"rc": rc, "equal": bool(
        rc == 0 and np.array_equal(c.cpu().numpy(), reference(A, B)))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(sms * 64, dtype=torch.int32, device=dev)
    rates = {}
    for b1 in (1, 0):
        blocks, threads, iters = sms * 8, 128, 4096
        lib.probe_rate(sink.data_ptr(), blocks, threads, 64, b1)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = lib.probe_rate(sink.data_ptr(), blocks, threads, iters, b1)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        mmas = blocks * threads // 32 * iters * 8
        ops = mmas * 16 * 8 * (256 if b1 else 32) * 2
        best = min(times)
        rates["b1" if b1 else "s8"] = {
            "rc": rc, "ms": times, "mma_per_s": mmas / (best * 1e-3),
            "tops": ops / (best * 1e-3) / 1e12}
    res["rates"] = rates
    print(json.dumps(res))
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
