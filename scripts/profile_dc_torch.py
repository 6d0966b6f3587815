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
phase 3's kernel launches (csrc/dc_cluster_build.cu a batched chunk,
csrc/dc_stream_block.cu a streamed cluster's row block) beside the log's
chunks and row blocks, its steps and host syncs, nRF vs
the true tree; phase 2 split into its rows (dc/pipeline.py::_phase2_rows:
kernel 2 for mash), its scorer (kclosest.score_edges_rows: kernel 10,
csrc/dc_assign.cu) and, where the checkout has one, its pack
(kclosest.assign_records, once a phase), each the sum over the phase's
chunks of the time
between two CUDA events recorded around the call in the run and read
after the run, and of the host's time in the call, with the phase-2 log
line's chunks, launches and host syncs), and the kernel's
launches (the total, the widest bucket's, the sums of both times beside
the sum of bounds). The card's name and power limit go first. Needs
CUDA.

    python3 scripts/profile_dc_torch.py --n 30000 --parent build/parent

compares this checkout with an earlier one (`git archive <commit>`
unpacked at build/parent) on one card instead: the CLI with -m 3 on the
same set in child processes, in turns parent, this, this, parent (each
round; --rounds sets how many), each
checkout's kernels and host libraries built before the first turn;
a JSON line a turn (phase times, phase 2's rows and scorer split as
above, wall seconds, nRF vs the true tree, whether its Newick equals the
first turn's). Each child runs the CLI through PHASE2_CHILD.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Times phase 2's two calls by the names that this checkout and earlier
# ones share (dc/pipeline.py::_phase2_rows, kclosest.score_edges_rows):
# CUDA events around each call in the run, and the host's time in each
# call (perf_counter); after the run (synchronized), summary() gives each
# call's summed ms, host ms and count, restore() puts the calls back. Run
# by exec, in this process or in a child of another checkout
# (PHASE2_CHILD).
PHASE2_TIMERS = r"""
import time
import torch
from dipper_tpu_torch.dc import pipeline
from dipper_tpu_torch.placement import kclosest

events = {"rows": [], "scorer": [], "pack": []}
host = {k: 0.0 for k in events}
# the pack (kclosest.assign_records) where the checkout has one
calls = (pipeline._phase2_rows, kclosest.score_edges_rows,
         getattr(kclosest, "assign_records", None))


def timed(key, fn):
    def run(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = fn(*a, **kw)
        ev[1].record()
        host[key] += time.perf_counter() - t0
        events[key].append(ev)
        return out
    return run


def summary():
    return {**{f"phase2_{k}_ms": sum(a.elapsed_time(b) for a, b in v)
               for k, v in events.items()},
            **{f"phase2_{k}_host_ms": v * 1e3 for k, v in host.items()},
            **{f"phase2_{k}_calls": len(v) for k, v in events.items()}}


def restore():
    pipeline._phase2_rows, kclosest.score_edges_rows = calls[:2]
    if calls[2] is not None:
        kclosest.assign_records = calls[2]


pipeline._phase2_rows = timed("rows", calls[0])
kclosest.score_edges_rows = timed("scorer", calls[1])
if calls[2] is not None:
    kclosest.assign_records = timed("pack", calls[2])
"""

# Runs the CLI (arguments after the script) with PHASE2_TIMERS; prints one
# JSON line: the CLI's return code and the timers' summary
PHASE2_CHILD = PHASE2_TIMERS + r"""
import json, sys
from dipper_tpu_torch.cli import main

rc = main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"rc": rc, **summary()}))
"""


def phase2_split(log: str, child: dict) -> dict:
    """Phase 2's rows and scorer times (PHASE2_CHILD's line) and, where
    the log has it, its phase-2 line (chunks, kernel-10 launches, host
    syncs)."""
    rec = {k: v for k, v in child.items() if k.startswith("phase2_")}
    m = re.search(r"DC phase 2: chunks=(\d+) rows_per_chunk=(\d+) "
                  r"kernel_launches=(\d+) host_syncs=(\d+) route=(\w+)", log)
    if m:
        rec.update(phase2_chunks=int(m[1]), phase2_rows_per_chunk=int(m[2]),
                   phase2_kernel_launches=int(m[3]),
                   phase2_host_syncs=int(m[4]), phase2_route=m[5])
    m = re.search(r"DC phase 2: .* pack_launches=(\d+)", log)
    if m:
        rec["phase2_pack_launches"] = int(m[1])
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--out", default=None,
                    help="directory for the tree and the CLI log (default: "
                         "a temporary one)")
    ap.add_argument("--parent", default=None,
                    help="an earlier checkout to time in turns with this "
                         "one (child processes, no kernel profile)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with --parent: the four turns this many times")
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
            return turns(args.parent, fa, true_nwk, out_dir, args.n,
                         args.rounds)
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
        timers: dict = {}
        exec(PHASE2_TIMERS, timers)
        cs.reset_counts()
        cluster.STEPS = cluster.BFS_LEVELS = 0
        out = os.path.join(out_dir, f"dc{args.n}.nwk")
        try:
            rc, log, wall = cs.run_cli(["-i", "r", "-I", fa, "-O", out,
                                        "-m", "3"])
        finally:
            mash_cuda.mash_cluster_inter_cuda = kernel
            timers["restore"]()
        counts = cs.read_counts()
        with open(os.path.join(out_dir, f"dc{args.n}.log"), "w") as f:
            f.write(log)
        if rc != 0:
            print(f"profile_dc_torch: the CLI returned {rc}", file=sys.stderr)
            return 1
        from dipper_tpu_torch.utils.treecmp import rf_distance

        rf, nrf = rf_distance(open(out).read(), open(true_nwk).read())
        torch.cuda.synchronize()
        buckets = re.findall(r"DC phase 3: bucket \S+ clusters=\d+ "
                             r"path=(\w+) members=(\d+) launches=(\d+)", log)
        phase3 = {
            "batched_chunks": sum(int(c) for p, _, c in buckets
                                  if p == "batch"),
            "streamed_members": sum(int(m) for p, m, _ in buckets
                                    if p == "stream"),
            "streamed_row_blocks": sum(int(c) for p, _, c in buckets
                                       if p == "stream"),
            "dc_cluster_build_launches": counts["dc_cluster_build"],
            "dc_stream_block_launches": counts["dc_stream_block"],
            "steps": cluster.STEPS, "host_syncs": cluster.BFS_LEVELS}
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
        split = phase2_split(log, timers["summary"]())
        emit({"run": {"n": args.n, "backbone": args.n // 20,
                      **cs._dc_log(log), **split,
                      "total_wall_ms": wall * 1e3,
                      "phase3_steps": cluster.STEPS,
                      "phase3_bfs_levels": cluster.BFS_LEVELS,
                      "host_syncs_per_phase3_step":
                          cluster.BFS_LEVELS / max(cluster.STEPS, 1),
                      "kernel_launches": counts, "phase3": phase3,
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


def turns(parent: str, fa: str, true_nwk: str, out_dir: str, n: int,
          rounds: int = 1) -> int:
    """-m 3 on `fa` by the CLI of `parent` and of this checkout, each in a
    child process, in turns parent, this, this, parent, `rounds` times."""
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
    for i, who in enumerate(("parent", "this", "this", "parent") * rounds):
        root = roots[who]
        out = os.path.join(out_dir, f"dc{n}.{who}.{i}.nwk")
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-c", PHASE2_CHILD, "-i", "r", "-I", fa, "-O",
             out, "-m", "3"], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, timeout=1800)
        wall = time.time() - t0
        with open(os.path.join(out_dir, f"dc{n}.{who}.{i}.log"), "w") as f:
            f.write(run.stderr)
        if run.returncode != 0:
            print(f"profile_dc_torch: {who}'s CLI returned "
                  f"{run.returncode}", file=sys.stderr)
            return 1
        nwk = open(out).read()
        first = first if i else nwk
        rf, nrf = rf_distance(nwk, open(true_nwk).read())
        child = json.loads(run.stdout.strip().splitlines()[-1])
        emit({"turn": i, "checkout": who, "n": n,
              **cs._dc_log(run.stderr), **phase2_split(run.stderr, child),
              "process_wall_s": wall, "rf": rf,
              "nrf_vs_true": nrf, "newick_equal_to_turn_0": nwk == first})
    return 0


if __name__ == "__main__":
    sys.exit(main())
