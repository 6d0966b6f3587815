#!/usr/bin/env python3
"""Per-insertion time breakdown of the PyTorch port's k-closest insertion
loop (dipper_tpu_torch.placement.kclosest), on the main path's data.

Builds the tree of an N-taxon `scripts/make_dataset.py` set (L = 10,000,
the CLI's input shuffle and Mash sketches) up to 3 * WINDOW insertions
before the end, without timing. Then it measures three windows of WINDOW
insertions each, at the full cap:
  A. the plain loop, as the CLI runs it: wall ms per insertion;
  B. scoring, splice and BFS, each bracketed by a device synchronize
     (which adds three syncs per insertion), plus the `nonzero` calls per
     insertion (one per BFS level, the last, empty level included);
  C. torch.profiler over the loop with no extra syncs: device busy ms
     per insertion (kernels and copies, from device-side events only),
     device ops, kernel launches (all, and those of the port's own
     scorer kernels), syncs and copies per insertion. The device's busy
     share is C's busy ms over A's wall ms, since the profiler slows the
     host.
Each result is one JSON line on stdout; the profiler's tables go to
OUT/profile_table.txt.

    python scripts/profile_insertions_torch.py                 # N=30,000 on cuda
    python scripts/profile_insertions_torch.py --n 600 --window 50 --device cpu
"""

from __future__ import annotations

import argparse
import collections
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
from dipper_tpu_torch.placement import kclosest as tk  # noqa: E402
from dipper_tpu_torch.placement.api import _mash_frontend  # noqa: E402
from dipper_tpu_torch.utils.device import resolve_device, synchronize  # noqa: E402
from dipper_tpu_torch.utils.params import Param  # noqa: E402


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
    if N - 3 * W <= 2:
        raise SystemExit("--n must exceed 3 * --window + 2")
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

    a0 = N - 3 * W
    t, _ = run(2, a0)
    print(json.dumps({"prefix": {"insertions": a0 - 2,
                                 "ms_per_insertion": t / (a0 - 2) * 1e3}}),
          flush=True)

    # window A: the plain loop
    t, _ = run(a0, a0 + W)
    plain_ms = t / W * 1e3
    print(json.dumps({"window_plain": {"insertions": W,
                                       "ms_per_insertion": plain_ms}}),
          flush=True)
    a0 += W

    # window B: each part bracketed by a synchronize
    part_s = collections.defaultdict(float)
    levels = 0
    originals = {f: getattr(tk, f)
                 for f in ("score_edges", "splice", "update_closest_bfs")}

    def timed(name, fn):
        def wrapped(*a, **k):
            synchronize(dev)
            t0 = time.perf_counter()
            r = fn(*a, **k)
            synchronize(dev)
            part_s[name] += time.perf_counter() - t0
            return r
        return wrapped

    nonzero = torch.Tensor.nonzero

    def counted_nonzero(self, *a, **k):
        nonlocal levels
        levels += 1
        return nonzero(self, *a, **k)

    for f, fn in originals.items():
        setattr(tk, f, timed(f, fn))
    torch.Tensor.nonzero = counted_nonzero
    try:
        t, _ = run(a0, a0 + W)
    finally:
        torch.Tensor.nonzero = nonzero
        for f, fn in originals.items():
            setattr(tk, f, fn)
    print(json.dumps({"window_synced": {
        "insertions": W, "ms_per_insertion": t / W * 1e3,
        **{f"{k}_ms_per_insertion": v / W * 1e3 for k, v in part_s.items()},
        "nonzero_per_insertion": levels / W}}), flush=True)

    # window C: the profiler, no extra syncs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    hand = {"score_edges": "SCORE_EDGES_LAUNCHES",
            "side_vector": "SIDE_VECTOR_LAUNCHES"}
    before = {k: getattr(tk, v) for k, v in hand.items()}
    t, prof = run(a0 + W, N, lambda: profile(activities=acts))
    ka = prof.key_averages()
    rec = {"insertions": W, "ms_per_insertion": t / W * 1e3}
    for k, v in hand.items():
        rec[f"{k}_kernel_launches_per_insertion"] = (
            getattr(tk, v) - before[k]) / W
    if dev.type == "cuda":
        # aten ops also carry their kernels' device time: count only the
        # device-side events, as the table's "Self CUDA time total" does
        on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
        busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 / W
        rec.update(
            device_busy_ms_per_insertion=busy_ms,
            device_busy_share_of_plain_loop=busy_ms / plain_ms,
            device_ops_per_insertion=sum(e.count for e in on_dev) / W)
    by_name = {e.key: e.count for e in ka}
    for key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                "cudaMemcpyAsync", "aten::to", "aten::nonzero"):
        rec[f"{key}_per_insertion"] = by_name.get(key, 0) / W
    print(json.dumps({"window_profiled": rec}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
        if dev.type == "cuda":
            f.write("\n\n")
            f.write(ka.table(sort_by="self_device_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
