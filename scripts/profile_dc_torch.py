#!/usr/bin/env python3
"""Divide-and-conquer (-m 3) of the PyTorch port on one GPU, at the JAX
package's own operating point (N = 100,000, B = N // 20 = 5,000), with
its phase times, the bucket lines and the per-cluster count kernel's
share of its bound.

    python3 scripts/profile_dc_torch.py                 # N = 100,000
    python3 scripts/profile_dc_torch.py --n 30000 --out out/dc30k

Generates scripts/make_dataset.py's set (L = 10,000, seed 1), runs the
CLI with -m 3 on it (default flags otherwise: f32, k = 15, s = 1000) and
records every launch of csrc/mash_cluster_inter.cu (CUDA events around
the call in the run, which for the process's first call include the
library's and the kernel's loading, and its bound as chip_smoke.py's
cluster_bound reckons it); after the run each launch is timed again on
its own inputs, the card alone (a CUDA graph of 20 launches, replayed).
Prints JSON lines: the dataset, the run (phase times, clusters, buckets,
host syncs per phase-3 step, nRF vs the true tree), and the kernel's
launches (the total, the widest bucket's, the sums of both times beside
the sum of bounds). The card's name and power limit go first. Needs
CUDA.

    python3 scripts/profile_dc_torch.py --n 30000 --parent build/parent

compares this checkout with an earlier one (`git archive <commit>`
unpacked at build/parent) on one card instead: the CLI with -m 3 on the
same set in child processes, in turns parent, this, this, parent, each
checkout's kernels and host libraries built before the first turn;
a JSON line a turn (phase times, wall seconds, nRF vs the true tree).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--out", default=None,
                    help="directory for the tree and the CLI log (default: "
                         "a temporary one)")
    ap.add_argument("--parent", default=None,
                    help="an earlier checkout to time in turns with this "
                         "one (child processes, no kernel profile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_dc_torch: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dipper_tpu_torch.csrc.build import build_all
    from dipper_tpu_torch.dc import cluster
    from dipper_tpu_torch.distance import mash_cuda

    build_all()  # set-up: no nvcc inside a timed call

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        fa, true_nwk = cs.make_dataset(args.n, os.path.join(tmp, "dc"),
                                       seed=1)
        emit({"dataset": {"n": args.n, "L": 10000, "seed": 1,
                          "gen_s": time.time() - t0}})
        if args.parent:
            return turns(args.parent, fa, true_nwk, out_dir, args.n)
        calls = []
        kernel = mash_cuda.mash_cluster_inter_cuda

        def recorded(ranks, wit, mem, *, sketch_size):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            got = kernel(ranks, wit, mem, sketch_size=sketch_size)
            ev[1].record()
            calls.append((got, sketch_size, ev, (ranks, wit, mem)))
            return got

        mash_cuda.mash_cluster_inter_cuda = recorded
        cs.reset_counts()
        cluster.STEPS = cluster.BFS_LEVELS = 0
        out = os.path.join(out_dir, f"dc{args.n}.nwk")
        try:
            rc, log, wall = cs.run_cli(["-i", "r", "-I", fa, "-O", out,
                                        "-m", "3"])
        finally:
            mash_cuda.mash_cluster_inter_cuda = kernel
        counts = cs.read_counts()
        with open(os.path.join(out_dir, f"dc{args.n}.log"), "w") as f:
            f.write(log)
        if rc != 0:
            print(f"profile_dc_torch: the CLI returned {rc}", file=sys.stderr)
            return 1
        from dipper_tpu_torch.utils.treecmp import rf_distance

        rf, nrf = rf_distance(open(out).read(), open(true_nwk).read())
        torch.cuda.synchronize()
        launches = []
        for got, s, ev, (ranks, wit, mem) in calls:
            c, Q, W = got.shape
            b = cs.cluster_bound(got, s)
            kernel_ms = cs.graph_ms(
                lambda: kernel(ranks, wit, mem, sketch_size=s), 20, 3)
            launches.append({"clusters": c, "cmax": Q, "W": W,
                             "ms": ev[0].elapsed_time(ev[1]),
                             "kernel_ms": kernel_ms,
                             "bound_ms": b["bound_ms"],
                             "bound_by": b["bound_by"]})
        emit({"run": {"n": args.n, "backbone": args.n // 20,
                      **cs._dc_log(log), "total_wall_ms": wall * 1e3,
                      "phase3_steps": cluster.STEPS,
                      "phase3_bfs_levels": cluster.BFS_LEVELS,
                      "host_syncs_per_phase3_step":
                          cluster.BFS_LEVELS / max(cluster.STEPS, 1),
                      "kernel_launches": counts,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "rf": rf, "nrf_vs_true": nrf}})
        ms = sum(x["ms"] for x in launches)
        kms = sum(x["kernel_ms"] for x in launches)
        bound = sum(x["bound_ms"] for x in launches)
        widest = max(launches, key=lambda x: x["cmax"]) if launches else None
        emit({"mash_cluster_inter": {
            "launches": len(launches), "sum_ms": ms, "sum_kernel_ms": kms,
            "sum_bound_ms": bound,
            "share_of_bound": bound / kms if kms else None,
            "widest_bucket": widest, "by_launch": launches}})
    return 0


def turns(parent: str, fa: str, true_nwk: str, out_dir: str, n: int) -> int:
    """-m 3 on `fa` by the CLI of `parent` and of this checkout, each in a
    child process, in turns parent, this, this, parent."""
    import chip_smoke as cs
    from dipper_tpu_torch.utils.treecmp import rf_distance

    roots = {"parent": os.path.abspath(parent), "this": REPO}
    out_dir = os.path.abspath(out_dir)  # the children run in their roots
    prep = ("from dipper_tpu_torch.csrc.build import build_all; build_all()"
            "\nfrom dipper_tpu_torch.utils.native_lib import native_library"
            "\nfor n in ('fastio', 'sketchnat', 'newick'):"
            "\n    native_library(f'lib{n}.so', f'{n}.cpp')")
    for who, root in roots.items():
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, "-c", prep], cwd=root, env=env,
                       check=True, timeout=900)
    for i, who in enumerate(("parent", "this", "this", "parent")):
        root = roots[who]
        out = os.path.join(out_dir, f"dc{n}.{who}.{i}.nwk")
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m", "dipper_tpu_torch.cli", "-i", "r", "-I",
             fa, "-O", out, "-m", "3"], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, timeout=1800)
        wall = time.time() - t0
        with open(os.path.join(out_dir, f"dc{n}.{who}.{i}.log"), "w") as f:
            f.write(run.stderr)
        if run.returncode != 0:
            print(f"profile_dc_torch: {who}'s CLI returned "
                  f"{run.returncode}", file=sys.stderr)
            return 1
        rf, nrf = rf_distance(open(out).read(), open(true_nwk).read())
        emit({"turn": i, "checkout": who, "n": n,
              **cs._dc_log(run.stderr), "process_wall_s": wall, "rf": rf,
              "nrf_vs_true": nrf})
    return 0


if __name__ == "__main__":
    sys.exit(main())
