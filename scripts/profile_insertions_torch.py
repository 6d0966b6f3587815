#!/usr/bin/env python3
"""Per-insertion time breakdown of the PyTorch port's k-closest insertion
loop (dipper_tpu_torch.placement.kclosest), on the main path's data.

Builds the tree of an N-taxon `scripts/make_dataset.py` set (L = 10,000,
the CLI's input shuffle and Mash sketches) up to 5 * WINDOW insertions
before the end, without timing. Then it measures five windows of WINDOW
insertions each, at the full cap. On the card the loop is the kernel
path (per insertion one score_edges and one insert_step launch, no host
sync); the plain path, as every insertion ran before the insertion-step
kernel (the scorer kernel with one readback, then splice and compact BFS
as tensor code), is measured beside it for comparison:
  A. the kernel loop, as the CLI runs it: wall ms per insertion;
  B. the kernel loop with each launch between CUDA events, queued behind a
     device sleep so that the card runs them back to back
     (chip_smoke.kernel_window): device ms of the scorer and of
     insert_step per insertion, and the host's ms per insertion to
     enqueue them;
  C. torch.profiler over the kernel loop: device busy ms per insertion
     (kernels and copies, from device-side events only), device ops,
     kernel launches (all, and those of the port's own kernels), syncs
     and copies per insertion. The device's busy share is C's busy ms
     over A's wall ms, since the profiler slows the host;
  D. the plain loop: wall ms per insertion;
  E. torch.profiler over the plain loop, as C.
On the CPU every window runs the plain loop (B is skipped). Each result
is one JSON line on stdout; the profiler's tables go to
OUT/profile_table.txt.

    python scripts/profile_insertions_torch.py                 # N=30,000 on cuda
    python scripts/profile_insertions_torch.py --n 600 --window 50 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dipper_tpu_torch.driver import _load_sequences  # noqa: E402
from dipper_tpu_torch.placement import insert_cuda  # noqa: E402
from dipper_tpu_torch.placement import kclosest as tk  # noqa: E402
from dipper_tpu_torch.placement.api import _mash_frontend  # noqa: E402
from dipper_tpu_torch.utils.device import resolve_device, synchronize  # noqa: E402
from dipper_tpu_torch.utils.params import Param  # noqa: E402


def profiled(run, lo: int, W: int, dev, plain_ms: float) -> tuple:
    """Window [lo, lo + W) under torch.profiler: (its JSON record, the
    profiler's key averages)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    hand = {"score_edges": (tk, "SCORE_EDGES_LAUNCHES"),
            "side_vector": (tk, "SIDE_VECTOR_LAUNCHES"),
            "insert_step": (insert_cuda, "INSERT_STEP_LAUNCHES"),
            "closest_bfs": (insert_cuda, "CLOSEST_BFS_LAUNCHES")}
    before = {k: getattr(m, v) for k, (m, v) in hand.items()}
    t, prof = run(lo, lo + W, lambda: profile(activities=acts))
    ka = prof.key_averages()
    rec = {"insertions": W, "ms_per_insertion": t / W * 1e3}
    for k, (m, v) in hand.items():
        rec[f"{k}_kernel_launches_per_insertion"] = (
            getattr(m, v) - before[k]) / W
    if dev.type == "cuda":
        # aten ops also carry their kernels' device time: count only the
        # device-side events, as the table's "Self CUDA time total" does
        on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
        busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 / W
        rec.update(
            device_busy_ms_per_insertion=busy_ms,
            device_busy_share_of_unprofiled_loop=busy_ms / plain_ms,
            device_ops_per_insertion=sum(e.count for e in on_dev) / W)
    by_name = {e.key: e.count for e in ka}
    for key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                "cudaMemcpyAsync", "aten::to", "aten::nonzero"):
        rec[f"{key}_per_insertion"] = by_name.get(key, 0) / W
    return rec, ka


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30000)
    ap.add_argument("--window", type=int, default=300,
                    help="insertions per measured window")
    ap.add_argument("--sketch-size", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1, help="dataset seed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "profile_insertions"),
                    help="directory of the profiler's tables")
    args = ap.parse_args()
    N, W = args.n, args.window
    if N - 5 * W <= 2:
        raise SystemExit("--n must exceed 5 * --window + 2")
    dev = resolve_device(args.device)
    params = Param(sketch_size=args.sketch_size)

    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "make_dataset.py"),
             "-n", str(N), "-L", "10000", "-o", os.path.join(tmp, "d"),
             "--seed", str(args.seed)],
            check=True, stdout=subprocess.DEVNULL)
        _, seqs = _load_sequences(params, os.path.join(tmp, "d.fa"))
    fa, static = _mash_frontend(seqs, params, dev)
    kw = dict(frontend="mash", frontend_static=static, dtype_name=params.dtype)
    st = tk.init_placement_state(fa, num_sequences=N, **kw)
    cap = tk._cap_for(N, N)
    st = tk._resize_state(st, 4 * cap)
    fa_cap = tk._slice_frontend(fa, "mash", cap)

    def run(lo, hi, around=contextlib.nullcontext):
        """Insertions lo..hi-1; `around()` wraps the loop but not the
        distance rows. Returns (the loop's wall seconds, around()'s
        context value)."""
        rows = tk._rows(fa_cap, "mash", static, params.dtype, lo, hi)
        synchronize(dev)
        with around() as ctx:
            t0 = time.perf_counter()
            tk._insert_range(st, lo, hi, rows, N)
            synchronize(dev)
            t = time.perf_counter() - t0
        return t, ctx

    a0 = N - 5 * W
    t, _ = run(2, a0)
    print(json.dumps({"prefix": {"insertions": a0 - 2,
                                 "ms_per_insertion": t / (a0 - 2) * 1e3}}),
          flush=True)
    kernel = tk.uses_insert_kernel(st)

    # window A: the loop as the CLI runs it
    t, _ = run(a0, a0 + W)
    loop_ms = t / W * 1e3
    print(json.dumps({"window_loop": {"path": "kernel" if kernel else "plain",
                                      "insertions": W,
                                      "ms_per_insertion": loop_ms}}),
          flush=True)
    a0 += W

    # window B: each kernel launch between CUDA events
    if kernel:
        from chip_smoke import kernel_window

        rows = tk._rows(fa_cap, "mash", static, params.dtype, a0, a0 + W)
        got = kernel_window(st, rows, a0, a0 + W, N)
        print(json.dumps({"window_events": {
            "insertions": W,
            "score_edges_device_ms": sum(got["score_ms"]) / W,
            "insert_step_device_ms": sum(got["insert_ms"]) / W,
            "insert_step_device_ms_max": max(got["insert_ms"]),
            "host_ms_per_insertion": got["host_ms_per_insertion"],
            "chunks_not_queued": got["chunks_not_queued"]}}), flush=True)
    else:
        run(a0, a0 + W)
    a0 += W

    # window C: the profiler over the loop
    rec, ka = profiled(run, a0, W, dev, loop_ms)
    print(json.dumps({"window_profiled": {
        "path": "kernel" if kernel else "plain", **rec}}), flush=True)
    tables = [("loop", ka)]
    a0 += W

    # windows D and E: the plain path (splice and BFS as tensor code)
    uses = tk.uses_insert_kernel
    tk.uses_insert_kernel = lambda st_: False
    try:
        t, _ = run(a0, a0 + W)
        plain_ms = t / W * 1e3
        print(json.dumps({"window_plain": {"insertions": W,
                                           "ms_per_insertion": plain_ms}}),
              flush=True)
        rec, ka = profiled(run, a0 + W, W, dev, plain_ms)
    finally:
        tk.uses_insert_kernel = uses
    print(json.dumps({"window_plain_profiled": rec}), flush=True)
    tables.append(("plain loop", ka))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
        for name, ka in tables:
            f.write(f"== {name}\n")
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
            if dev.type == "cuda":
                f.write("\n\n")
                f.write(ka.table(sort_by="self_device_time_total",
                                 row_limit=25))
            f.write("\n\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
