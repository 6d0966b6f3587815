#!/usr/bin/env python3
"""Where the time of the port's NJ goes, on the card.

Builds the mash matrix of a scripts/make_dataset.py set (L = 10,000,
k = 15, s = 1000) with the port, then:

  A. the whole NJ (dipper_tpu_torch.nj.neighbor_joining) on the matrix,
     host clock around a synchronized run, once per --sizes prefix;
  B. the Q pass alone (the two subtractions, the diagonal, the argmin)
     on the active block at sampled n, CUDA events over 20 runs, and its
     sum over every merge step, interpolated in n^2 between the samples:
     the device time that the Q pass costs the whole NJ;
  C. the host time of one merge step: NJ of a 1,024-taxon prefix, where
     the device work is small, divided by its steps.

Each result is one JSON line on stdout. Run from the root of a checkout:

    python3 scripts/profile_nj_torch.py                 # N = 20,000 on cuda
    python3 scripts/profile_nj_torch.py --n 600 --sizes 600,300 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def q_pass_ms(D: torch.Tensor, n: int, reps: int = 20) -> float:
    """Mean ms of one Q pass over the active n x n block of D."""
    U = D[:n, :n].sum(dim=1)
    Un = U / (n - 2)
    Q = torch.empty(n * n, dtype=D.dtype, device=D.device).view(n, n)
    big = torch.finfo(D.dtype).max

    def once():
        torch.sub(D[:n, :n], Un[:, None], out=Q)
        Q.sub_(Un[None, :])
        Q.diagonal().fill_(big)
        return torch.argmin(Q)

    once()
    if D.device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            once()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--sizes", default="20000,10000,5000",
                    help="prefix sizes of the whole-NJ runs (A)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    from dipper_tpu_torch.distance.mash import (mash_distance_matrix,
                                                pad_ranks, rank_compress_host)
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.nj import neighbor_joining
    from dipper_tpu_torch.sketch.native import sketch_sequences_native
    from dipper_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ds")
        subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                     "make_dataset.py"),
                        "-n", str(args.n), "-L", "10000", "-o", prefix,
                        "--seed", str(args.seed)],
                       check=True, stdout=subprocess.DEVNULL)
        _, seqs = read_fasta(prefix + ".fa")
    ranks = pad_ranks(rank_compress_host(
        sketch_sequences_native(seqs, 15, 1000)))
    D = mash_distance_matrix(ranks, 15, 1000, args.precision, dev)
    sync(dev)
    info = {"device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "n": args.n, "precision": args.precision}
    if dev.type == "cuda":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    print(json.dumps(info), flush=True)

    # A: whole NJ runs
    for m in map(int, args.sizes.split(",")):
        sync(dev)
        t0 = time.perf_counter()
        neighbor_joining(D[:m, :m], dtype_name=args.precision, device=dev)
        sync(dev)
        s = time.perf_counter() - t0
        print(json.dumps({"whole_nj": {"n": m, "s": s,
                                       "ms_per_step": s * 1e3 / (m - 2)}}),
              flush=True)

    # B: the Q pass at sampled n, summed over every step
    ns = [n for n in (args.n, args.n * 3 // 4, args.n // 2, args.n // 4,
                      args.n // 8, args.n // 16) if n >= 3]
    samples = {n: q_pass_ms(D, n) for n in ns}
    xs = np.array(sorted(samples)) ** 2.0
    ys = np.array([samples[n] for n in sorted(samples)])
    steps = np.arange(3, args.n + 1) ** 2.0
    total_ms = float(np.interp(steps, xs, ys).sum())
    print(json.dumps({"q_pass": {
        "ms_at_n": samples,
        "sum_over_steps_s": total_ms / 1e3,
        "bytes_per_element": 5 * D.element_size(),
        "gbytes_per_s_at_n": {n: 5 * D.element_size() * n * n / ms / 1e6
                              for n, ms in samples.items()}}}), flush=True)

    # C: host time per merge step where the device work is small
    m = min(1024, args.n)
    neighbor_joining(D[:m, :m], dtype_name=args.precision, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    neighbor_joining(D[:m, :m], dtype_name=args.precision, device=dev)
    sync(dev)
    s = time.perf_counter() - t0
    print(json.dumps({"small_nj": {"n": m, "ms_per_step":
                                   s * 1e3 / (m - 2)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
