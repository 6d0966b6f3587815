#!/usr/bin/env python3
"""Where the time of the port's NJ goes, on the card.

Builds the mash matrix of a scripts/make_dataset.py set (L = 10,000,
k = 15, s = 1000) with the port, then:

  A. the whole NJ (dipper_tpu_torch.nj.neighbor_joining; on the card the
     kernel route, csrc/nj_q_argmin.cu + csrc/nj_update.cu) on the matrix,
     host clock around a synchronized run, once per --sizes prefix;
  B. the selection alone at sampled n: kernel A (nj_q_argmin over the
     active block, on the card only) in its half read (one triangle of
     the symmetric matrix, the NJ paths' mode) and in its full read,
     beside the plain Q pass (the two subtractions, the diagonal,
     torch.argmin), CUDA events over 20 runs, and each one's sum over
     every merge step, interpolated in n^2 between the samples: the
     device time the selection costs the whole NJ;
  C. the host time of one merge step: NJ of a 1,024-taxon prefix, where
     the device work is small, divided by its steps, by the kernel route
     (on the card) and by the plain route (neighbor_joining_plain).

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


def timed_ms(fn, dev: torch.device, reps: int = 20) -> float:
    """Mean ms of fn() over `reps` runs after a warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def selection_ms(D: torch.Tensor, n: int, dtype_name: str) -> dict:
    """Kernel A (on the card) in both reads and the plain Q pass + argmin
    over the active n x n block of D, the same flat index from all."""
    from dipper_tpu_torch.nj import engine

    st = engine._State(D[:n, :n], dtype_name, D.device, None)
    Un = st.U / st.denom[n]
    qbuf = st.q_buffer()
    plain = lambda: engine._argmin_plain(st.D, Un, qbuf, st.big)  # noqa: E731
    out = {"plain_ms": timed_ms(plain, D.device)}
    if D.device.type == "cuda":
        if not engine._read_mode(st, None):
            raise SystemExit("the matrix is not symmetric bit for bit")
        for key, half in (("kernel_ms", True), ("full_read_ms", False)):
            k = engine._stepper(st, half)
            k.q_argmin(n)
            if not torch.equal(k.flat, plain()):
                raise SystemExit(f"kernel A at n = {n} != the plain version")
            out[key] = timed_ms(lambda: k.q_argmin(n), D.device)
    else:
        out["kernel_ms"] = out["full_read_ms"] = "not measured (no card)"
    return out


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

    # B: the selection at sampled n, summed over every step
    ns = [n for n in (args.n, args.n * 3 // 4, args.n // 2, args.n // 4,
                      args.n // 8, args.n // 16) if n >= 3]
    samples = {n: selection_ms(D, n, args.precision) for n in ns}
    steps = np.arange(3, args.n + 1) ** 2.0
    xs = np.array(sorted(samples)) ** 2.0
    rec = {"ms_at_n": samples}
    for key in ("plain_ms", "kernel_ms", "full_read_ms"):
        ys = [samples[n][key] for n in sorted(samples)]
        if all(isinstance(y, float) for y in ys):
            rec[f"{key[:-3]}_sum_over_steps_s"] = float(
                np.interp(steps, xs, np.array(ys)).sum()) / 1e3
    # the half read's bytes: one triangle and the diagonal
    rec["kernel_gbytes_per_s_at_n"] = {
        n: D.element_size() * n * (n + 1) / 2 / v["kernel_ms"] / 1e6
        for n, v in samples.items() if isinstance(v["kernel_ms"], float)}
    print(json.dumps({"selection": rec}), flush=True)

    # C: host time per merge step where the device work is small
    from dipper_tpu_torch.nj import neighbor_joining_plain

    m = min(1024, args.n)
    for route, fn in (("kernel", neighbor_joining),
                      ("plain", neighbor_joining_plain)):
        if route == "kernel" and dev.type != "cuda":
            continue
        fn(D[:m, :m], dtype_name=args.precision, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        fn(D[:m, :m], dtype_name=args.precision, device=dev)
        sync(dev)
        s = time.perf_counter() - t0
        print(json.dumps({"small_nj": {"route": route, "n": m,
                                       "ms_per_step": s * 1e3 / (m - 2)}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
