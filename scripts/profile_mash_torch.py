#!/usr/bin/env python3
"""The two mash kernels' own times on the card, at the main paths' shapes.

Sketches a scripts/make_dataset.py set (L = 10,000, k = 15, s = 1000),
builds this checkout's kernels and times, with CUDA events over several
back-to-back launches after a warm-up:

  - mash_inter_cuda (csrc/mash_merge_count.cu, int32 counts) and
  - mash_rows_dist_cuda (csrc/mash_rows_dist.cu, f32 distances)

at bank x queries = every taxon x 64, 4,096 x 259, every taxon x 8,192
(placement's range call) and 20,000 x 4,096 (NJ's row block). Each shape
prints one JSON line with both times, pairs per second, the walk's steps
(sum of s + inter over the pairs, from the kernel's own counts), the bound
chip_smoke.py reckons from them and the share of it reached; the last
line holds the card (nvidia-smi name and power limit) and ptxas's report.

To compare two checkouts on one card, run this script from each of them in
one job, in the order old, new, new, old, on the same FASTA:

    python3 scripts/make_dataset.py -n 30000 -L 10000 -o /tmp/d --seed 1
    python3 old/scripts/profile_mash_torch.py --fasta /tmp/d.fa --label old
    python3 scripts/profile_mash_torch.py --fasta /tmp/d.fa --label new

It imports the package of the checkout it lies in and uses only the
wrappers' signatures, so a copy of it runs in an older checkout too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# as chip_smoke.py: 4 integer operations a walk step, the int32 rate of
# 132 multiprocessors x 64 lanes x 1.98 GHz, the memory rate of the H100
OPS_PER_WALK_STEP = 4
PEAK_INT32_PER_S = 132 * 64 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12


def event_ms(fn, reps: int) -> float:
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30000, help="taxa to generate")
    ap.add_argument("--fasta", help="use this FASTA instead of generating")
    ap.add_argument("--label", default="", help="copied into every line")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_mash_torch: CUDA is not available", file=sys.stderr)
        return 1
    from dipper_tpu_torch.csrc.build import BUILD_DIR, build_all
    from dipper_tpu_torch.distance import mash as tm
    from dipper_tpu_torch.distance import mash_cuda
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    build_all(["mash_merge_count", "mash_rows_dist"])
    with tempfile.TemporaryDirectory() as tmp:
        fa = args.fasta
        if fa is None:
            prefix = os.path.join(tmp, f"n{args.n}")
            subprocess.run(
                [sys.executable, os.path.join(REPO, "scripts",
                                              "make_dataset.py"),
                 "-n", str(args.n), "-L", "10000", "-o", prefix, "--seed",
                 "1"], check=True, stdout=subprocess.DEVNULL)
            fa = prefix + ".fa"
        _, seqs = read_fasta(fa)
    k, s = 15, 1000
    sk = sketch_sequences_native(seqs, k, s)
    if sk is None:
        print("profile_mash_torch: native sketcher unavailable",
              file=sys.stderr)
        return 1
    r = torch.from_numpy(tm.pad_ranks(tm.rank_compress_host(sk))).cuda()
    n = r.shape[0]
    table = torch.from_numpy(tm._dist_table(k, s, "float32")).cuda()
    shapes = [(r, r[-64:]), (r[:4096], r[4096:4096 + 259]),
              (r, r[-min(8192, n):]), (r[:20000], r[:4096])]
    for bank, qry in shapes:
        bank, qry = bank.contiguous(), qry.contiguous()
        pairs = bank.shape[0] * qry.shape[0]
        reps = args.reps if pairs > 10**7 else 10 * args.reps
        inter = mash_cuda.mash_inter_cuda(bank, qry, sketch_size=s)
        steps = pairs * s + int(inter.sum(dtype=torch.int64))
        line = {"label": args.label, "bank": bank.shape[0],
                "queries": qry.shape[0], "s": s, "steps": steps,
                "mean_inter": float(inter.float().mean())}
        del inter
        for name, table_bytes, fn in (
                ("mash_merge_count", 0, lambda: mash_cuda.mash_inter_cuda(
                    bank, qry, sketch_size=s)),
                ("mash_rows_dist_f32", 4 * (s + 1),
                 lambda: mash_cuda.mash_rows_dist_cuda(
                     bank, qry, table, sketch_size=s))):
            ms = event_ms(fn, reps)
            nbytes = ((bank.shape[0] + qry.shape[0]) * s * 4 + pairs * 4
                      + table_bytes)
            bound = max(OPS_PER_WALK_STEP * steps / PEAK_INT32_PER_S,
                        nbytes / PEAK_BYTES_PER_S) * 1e3
            line[name] = {"ms": ms, "pairs_per_s": pairs / ms * 1e3,
                          "bound_ms": bound, "share_of_bound": bound / ms}
        print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    ptxas = {}
    for name in ("mash_merge_count", "mash_rows_dist"):
        with open(os.path.join(BUILD_DIR, f"lib{name}.log")) as f:
            ptxas[name] = [ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln]
    print(json.dumps({"label": args.label, "timing": f"CUDA events, mean of "
                      f"{args.reps} launches (x10 for the small shapes) "
                      "after a warm-up",
                      "card": smi.stdout.strip().splitlines()[0],
                      "torch_name": torch.cuda.get_device_name(0),
                      "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
