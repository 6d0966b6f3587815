#!/usr/bin/env python3
"""Per-insertion time breakdown of the PyTorch port's exact placement
(dipper_tpu_torch.placement.exact), by its two routes, and of --add's
backbone seeding.

Exact placement: builds the tree of the first N sequences of an aligned
`scripts/make_dataset.py` set (L = 10,000, 5% gaps, -d 1 distances in
f64) up to a few windows of WINDOW insertions before the end, without
timing (the kernel route on the card, the plain version on the CPU). Then,
for each route (the plain version's tensor code, and on the card the
kernel route: csrc/exact_step.cu, one launch an insertion in replayed
CUDA graphs), windows of WINDOW insertions each:
  A. the route's loop as the builds run it: wall ms per insertion;
  C. torch.profiler over the loop with no extra syncs: the host's kernel
     and graph launches, copies and stream syncs per insertion, exact_step
     records on the card, device busy ms per insertion (device-side events
     only) and the device's busy share of window A's time;
  S. the host operations that synchronize, counted by source line
     (torch.cuda.set_sync_debug_mode("warn"));
and for the plain version
  B. the depth read, the two sweeps (`_compute_lims`), scoring and splice,
     each bracketed by a device synchronize;
and on the card
  P. the stamped parts of 16 insertions by exact_step.cu's stamped
     instance (walk, up-sweep, down-sweep, score, splice and depth shift:
     exact_cuda.stamped_parts) at the main path's launch shape and with
     every level on block 0 (W above any level), and the level widths (the
     kernel route's busy share is window C's).
Seeding (--seed-backbone B, off by default): the witness BFS of each leaf
of a B-leaf k-closest tree of the same distances, as `run_add_queries`
runs it: ms per backbone leaf over the first, middle and last tenth.
Each result is one JSON line on stdout.

    python scripts/profile_exact_torch.py                  # N=2,048 on cuda
    python scripts/profile_exact_torch.py --n 30000 --window 64
    python scripts/profile_exact_torch.py --n 300 --window 20 --device cpu
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dipper_tpu_torch.distance.msa import msa_distance_matrix  # noqa: E402
from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes  # noqa: E402
from dipper_tpu_torch.io.fasta import read_fasta  # noqa: E402
from dipper_tpu_torch.placement import exact, exact_cuda  # noqa: E402
from dipper_tpu_torch.placement import kclosest as tk  # noqa: E402
from dipper_tpu_torch.utils.device import resolve_device, synchronize  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def distances(n: int, seed: int, device) -> torch.Tensor:
    """The f64 -d 1 matrix of an aligned generated set's n sequences."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "aligned")
        subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "make_dataset.py"),
             "-n", str(n), "-L", "10000", "-o", prefix, "--seed", str(seed),
             "--aligned"], check=True, stdout=subprocess.DEVNULL)
        _, seqs = read_fasta(prefix + ".fa")
    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    return msa_distance_matrix(codes, 1, "float64", device)


def _profiled(st, D, lo: int, window: int, plain: bool, device) -> dict:
    """Window C of a route under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = D.shape[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exact.run_exact_range(st, lo, lo + window, D[lo:lo + window], n,
                              plain)
        synchronize(device)
    ka = prof.key_averages()
    count = {e.key: e.count for e in ka}
    on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
    return {"launches_per_insertion":
                (count.get("cudaLaunchKernel", 0)
                 + count.get("cudaLaunchKernelExC", 0)) / window,
            "graph_launches_per_insertion":
                count.get("cudaGraphLaunch", 0) / window,
            "memcpys_per_insertion":
                count.get("cudaMemcpyAsync", 0) / window,
            "stream_syncs_per_insertion":
                count.get("cudaStreamSynchronize", 0) / window,
            "exact_step_records_per_insertion":
                sum(e.count for e in on_dev if "exact_step_kernel" in e.key)
                / window,
            "device_busy_ms_per_insertion":
                sum(e.self_device_time_total for e in on_dev) / 1e3
                / window,
            "top_device_ops_ms_per_insertion": sorted(
                ((e.key[:60], e.self_device_time_total / 1e3 / window)
                 for e in on_dev), key=lambda kv: -kv[1])[:6]}


def _sync_sources(st, D, lo: int, window: int, plain: bool) -> dict:
    """Window S: the calls that synchronize, by source line."""
    n = D.shape[0]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            exact.run_exact_range(st, lo, lo + window, D[lo:lo + window], n,
                                  plain)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))
    return {"syncing_calls_per_insertion": {
        src: c / window for src, c in where.most_common()},
        "syncs_per_insertion": sum(where.values()) / window}


def profile_exact(D: torch.Tensor, window: int, device) -> None:
    n = D.shape[0]
    kw = dict(num_sequences=n, frontend="matrix", dtype_name="float64")
    routes = ("plain", "kernel") if device.type == "cuda" else ("plain",)
    per_route = 3 if device.type == "cuda" else 1
    start = n - window * (per_route * len(routes) + 1) - min(window, 8)
    st = exact.init_exact_state((D,), **kw)
    exact.run_exact_range(st, 2, start, D[2:start], n)
    synchronize(device)
    base = {"n": n, "window": window, "device": str(device)}
    lo = start
    for route in routes:
        plain = route == "plain"
        # A. the route's loop
        t0 = time.perf_counter()
        exact.run_exact_range(st, lo, lo + window, D[lo:lo + window], n,
                              plain)
        synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3 / window
        emit({**base, "route": route, "part": "window", "first": lo,
              "ms_per_insertion": ms,
              "greatest_depth": exact._max_depth(st)})
        lo += window
        if device.type != "cuda":
            continue
        # C. under the profiler
        rec = _profiled(st, D, lo, window, plain, device)
        rec["device_busy_share"] = rec["device_busy_ms_per_insertion"] / ms
        emit({**base, "route": route, "part": "profiled_window",
              "first": lo, **rec})
        lo += window
        # S. which host operations synchronize, by source line
        emit({**base, "route": route, "part": "sync_sources", "first": lo,
              **_sync_sources(st, D, lo, window, plain)})
        lo += window

    if device.type == "cuda":
        # P, on copies of the state (lo does not move)
        k = min(window - 1, 16)
        for shape in ({}, {"wide": 1 << 30}):
            emit({**base, "part": "stamped_parts",
                  **exact_cuda.stamped_parts(st, D[lo:lo + k + 1], lo, k,
                                             **shape)})

    # B. the plain version's parts, a synchronize after each
    parts = collections.OrderedDict(
        (k, 0.0) for k in ("depth_read", "sweeps", "score", "splice"))
    levels = 0
    t_all = time.perf_counter()
    for i in range(lo, lo + window):
        t = [time.perf_counter()]

        def mark():
            synchronize(device)
            t.append(time.perf_counter())

        maxdep = exact._max_depth(st)
        mark()
        lim = exact._compute_lims(st, D[i], n, maxdep)
        mark()
        eid, frac, add = exact._score_exact(st, lim)
        mark()
        exact._splice_exact(st, eid, frac, add, i, n, maxdep)
        mark()
        levels += 2 * maxdep
        for k, a, b in zip(parts, t, t[1:]):
            parts[k] += (b - a) * 1e3
    emit({**base, "route": "plain", "part": "synced_window", "first": lo,
          "ms_per_insertion": (time.perf_counter() - t_all) * 1e3 / window,
          "parts_ms_per_insertion": {k: v / window for k, v in parts.items()},
          "sweep_levels_per_insertion": levels / window,
          "sweep_ms_per_level": parts["sweeps"] / max(levels, 1)})
    lo += window
    exact.run_exact_range(st, lo, n, D[lo:n], n)
    synchronize(device)
    emit({**base, "part": "done", "edge_slots_used": st.idx,
          "greatest_depth": exact._max_depth(st)})


def profile_seeding(D: torch.Tensor, backbone: int, device) -> None:
    """The B witness BFS calls that seed a loaded backbone's lists."""
    B = backbone
    Db = D[:B, :B].contiguous()
    kw = dict(num_sequences=B, frontend="matrix", dtype_name="float64")
    built = tk.run_placement_full((Db,), **kw)
    st = tk.TreeState(
        e=built.e, belong=built.belong, length=built.length, rev=built.rev,
        cdis=torch.full_like(built.cdis, tk.SENT_DIS),
        cid=torch.full_like(built.cid, -1), idx=built.idx, adj=built.adj)
    synchronize(device)
    tenth = max(B // 10, 1)
    spans = {"first_tenth": (0, tenth), "middle_tenth":
             (B // 2, B // 2 + tenth), "last_tenth": (B - tenth, B)}
    ms = {}
    t_all = time.perf_counter()
    for i in range(B):
        for name, (a, b) in spans.items():
            if i == a:
                synchronize(device)
                ms[name] = -time.perf_counter()
            if i == b:
                synchronize(device)
                ms[name] += time.perf_counter()
        tk.update_closest_bfs(st, i, 2 * B)
    synchronize(device)
    ms["last_tenth"] += time.perf_counter()
    emit({"part": "seeding", "backbone": B, "device": str(device),
          "ms_per_backbone_leaf": (time.perf_counter() - t_all) * 1e3 / B,
          "ms_per_leaf_by_span": {k: v * 1e3 / tenth for k, v in ms.items()},
          "dense_bfs_fallbacks": st.nfb})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--window", type=int, default=100,
                    help="insertions per measured window")
    ap.add_argument("--seed", type=int, default=1, help="dataset seed")
    ap.add_argument("--seed-backbone", type=int, default=0, metavar="B",
                    help="also time --add's seeding of a B-leaf backbone "
                         "(B <= n)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        emit({"device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi.stdout.strip(), "torch": torch.__version__})
    D = distances(args.n, args.seed, device)
    profile_exact(D, args.window, device)
    if args.seed_backbone:
        profile_seeding(D, min(args.seed_backbone, args.n), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
