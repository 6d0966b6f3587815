#!/usr/bin/env python3
"""--add onto a multifurcating backbone on the card: seeding ms a backbone
leaf and ms a query of dipper_tpu_torch's CLI by checkout, and what the
plain (dense) route's witness BFS costs a level.

For each backbone size B of --sizes, the first B taxa of an N-taxon
scripts/make_dataset.py set (seed 1, L = 10,000, unaligned) are built
into a backbone by this checkout's CLI (-i r -m 1 on the card) and
collapsed by chip_smoke.collapse_backbone (the internal edges under the
30th percentile of internal lengths, and every internal edge of one
clade of at least 320 leaves, contracted); --add then places the next
--queries taxa on it. Each checkout of --checkout (repeatable; default
this one) runs the --add CLI in a child process with a time limit, in
turns (A B B A for two checkouts, A A for one). One JSON line each:
  - "backbone": the collapse's counts (internal edges before and after,
    the largest degree, the nodes of degree > 3);
  - "add": one run: rc, seeding ms a backbone leaf and ms a query (the
    CLI log), the route (the log's multifurcation line), graph captures,
    wall seconds, the Newick's md5;
  - "dense_route": in this process, this checkout's plain route (a state
    without an out-edge table, the dense BFS) on the first --window
    backbone leaves and, after the rest are seeded, --window queries:
    host syncs a BFS and a query (torch.cuda.set_sync_debug_mode's
    warnings), levels a BFS (insert_model's count on a host copy, over
    the same leaves: the frontiers read, the last of which joins
    nothing), CUDA kernel launches a level (torch.profiler, over leaves
    whose levels are counted alike), ms a leaf and a query. Skipped with
    --no-dense.
  - "parts" (with --parts, this checkout in this process, on the card):
    where a seeding leaf's time goes, by the stamped instances of
    csrc/insert_step.cu (clock64 and %globaltimer on thread 0, a leaf:
    the launch to its first level, the narrow levels, the wide levels'
    slot passes, degree scans and wide-pair passes, thread 0's reads past
    the shared buffers, and the rest), for the per-leaf cursor route's
    kernel (closest_bfs_wide_stamped, a launch a leaf) and for the range
    kernel (closest_bfs_range, one launch) at its plan and at the
    --plans given, over --parts-leaves leaves after the first 64 (the
    window) and from --late (the late stretch), both routes from equal
    states and to equal states; the SM clock the stamps imply; and the
    card's gap between consecutive launches of a replayed per-leaf graph
    (torch.profiler's kernel records, behind a lead-in) beside the range
    launch's own record.
The backbones, Newicks and logs go to --out.

    python3 scripts/profile_add_torch.py --out build/profile_add
    python3 scripts/profile_add_torch.py --checkout build/parent --checkout .
    python3 scripts/profile_add_torch.py --sizes 28976 --no-dense --parts \
        --checkout .
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import collapse_backbone, head_fasta  # noqa: E402
from dipper_tpu_torch.utils.device import synchronize  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cli(checkout: str, argv: list, log: str, timeout: float) -> tuple:
    """The port's CLI of `checkout` in a child process: (rc, its stderr,
    wall seconds); rc 124 when the time limit cut it."""
    t0 = time.time()
    with open(log, "w") as f:
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "dipper_tpu_torch.cli", *argv],
                cwd=checkout, stdout=subprocess.DEVNULL, stderr=f,
                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    with open(log) as f:
        return rc, f.read(), time.time() - t0


def _ms(pattern: str, text: str):
    m = re.search(pattern, text)
    return float(m.group(1)) if m else None


class _Captured(Exception):
    pass


def add_inputs(all_fa: str, back_nwk: str, device: str) -> tuple:
    """run_add_queries' inputs as this checkout's CLI makes them for
    --add (the backbone's edge arrays and the mash bank on the card),
    taken at the call, which is not made: (frontend_args, arrays, kw)."""
    from dipper_tpu_torch.cli import main
    from dipper_tpu_torch.placement import kclosest

    got = {}
    orig = kclosest.run_add_queries

    def capture(frontend_args, e0, belong0, length0, rev0, **kw):
        got.update(args=(frontend_args, (e0, belong0, length0, rev0), kw))
        raise _Captured

    kclosest.run_add_queries = capture
    try:
        main(["-i", "r", "-I", all_fa, "-O", os.devnull, "--add", "-t",
              back_nwk, "--device", device])
    except _Captured:
        pass
    finally:
        kclosest.run_add_queries = orig
    return got["args"]


def syncs_of(fn) -> int:
    """Host syncs that fn() makes (torch.cuda.set_sync_debug_mode's
    warnings)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(x.message) for x in w)


def launches_of(fn) -> int:
    """CUDA kernel launches by the host during fn() (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))


def dense_route(all_fa: str, back_nwk: str, W: int, device: str) -> dict:
    """This checkout's plain route of --add on a state without a table:
    the dense BFS from the first W leaves, the rest seeded, then W
    queries; each part's syncs and launches (on the card) and ms, and
    the levels of the BFS windows by insert_model."""
    from dipper_tpu_torch.placement import insert_model as im
    from dipper_tpu_torch.placement import kclosest as tk

    frontend_args, (e0, belong0, length0, rev0), kw = add_inputs(
        all_fa, back_nwk, device)
    N, B = kw["num_sequences"], kw["backbone_size"]
    dev = e0.device
    st = tk.add_state(e0, belong0, length0, rev0, num_sequences=N,
                      backbone_size=B, dtype_name=kw["dtype_name"],
                      use_adj=False, wide_table=False)

    def seed(lo, hi):
        for i in range(lo, hi):
            tk.update_closest_bfs(st, i, 2 * N)

    card = dev.type == "cuda"

    def timed(fn) -> float:
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        return time.perf_counter() - t0

    W = min(W, B // 3, (N - B) // 3)
    rec = {"backbone": B, "queries": N - B, "window": W}
    seed(0, 1)  # warm-up
    # the kernel's model seeds a host copy alike (bit for bit), counting
    # the levels of the two windows' leaves
    model = {f: getattr(st, f).cpu().numpy().copy() for f in im.FIELDS
             if f != "adj"}
    model.update(zip(("adj",) + im.WIDE, (
        a.cpu().numpy() for a in tk.wide_adjacency_from_edges(belong0,
                                                              2 * N))))
    levels = []
    for lo in (1, W + 1):
        stats = {}
        for i in range(lo, lo + W):
            im.bfs(model, i, i, stats=stats)
        levels.append(stats["levels"])
    rec["levels_per_bfs"] = levels[0] / W
    rec["levels_per_bfs_launch_window"] = levels[1] / W
    if card:
        bfs_syncs = syncs_of(lambda: seed(1, W + 1))
        bfs_launches = launches_of(lambda: seed(W + 1, 2 * W + 1))
        rec["host_syncs_per_bfs"] = bfs_syncs / W
        rec["launches_per_level"] = bfs_launches / levels[1]
    else:
        seed(1, 2 * W + 1)
    rec["seeding_ms_per_leaf"] = timed(
        lambda: seed(2 * W + 1, 3 * W + 1)) / W * 1e3
    rec["rest_seeded_s"] = timed(lambda: seed(3 * W + 1, B))
    rows = tk._rows(frontend_args, kw["frontend"], kw["frontend_static"],
                    kw["dtype_name"], B, B + 3 * W)

    def queries(lo, hi):
        for i in range(lo, hi):
            tk.insertion_step(st, rows[i - B], i, N)

    if card:
        rec["host_syncs_per_query"] = syncs_of(
            lambda: queries(B, B + W)) / W
        rec["launches_per_query"] = launches_of(
            lambda: queries(B + W, B + 2 * W)) / W
    else:
        queries(B, B + 2 * W)
    rec["ms_per_query"] = timed(lambda: queries(B + 2 * W,
                                                B + 3 * W)) / W * 1e3
    return rec


def _stamp_summary(w: torch.Tensor) -> dict:
    """A stretch's stamps ([leaves, STAMP_WORDS] int64, on the host) as
    µs a leaf by part, levels and reads a leaf, and the SM clock (GHz)
    they imply."""
    w = w.double()
    cyc = w[:, 2] - w[:, 0]
    ns = w[:, 9] - w[:, 8]
    ghz = float(cyc.sum() / ns.sum())
    us = lambda c: float(c.mean()) / ghz / 1e3  # noqa: E731
    parts = {"to_first_level": us(w[:, 1] - w[:, 0]),
             "narrow_levels": us(w[:, 3]), "slot_passes": us(w[:, 4]),
             "degree_scans": us(w[:, 5]), "pair_passes": us(w[:, 6])}
    parts["other"] = us(cyc) - sum(parts.values())
    return {"us_per_leaf": us(cyc), "parts_us": parts,
            "reads_past_shared_us": us(w[:, 7]),
            "reads_past_shared_per_leaf": float(w[:, 12].mean()),
            "narrow_levels_per_leaf": float(w[:, 10].mean()),
            "wide_levels_per_leaf": float(w[:, 11].mean()),
            "first_leaf_to_first_level_us": float(w[0, 1] - w[0, 0])
            / ghz / 1e3,
            "sm_clock_ghz": ghz}


def _kernel_records(fn, names) -> dict:
    """fn() under torch.profiler behind a lead-in: each named kernel's
    records (start, end in µs), in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    out = {n: [] for n in names}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                out[n].append((e.time_range.start, e.time_range.end))
    return {n: sorted(v) for n, v in out.items()}


def stamped_parts(all_fa: str, back_nwk: str, leaves: int, late: int,
                  plans: list | None) -> dict:
    """The stamped split of the seeding (see the module's "parts"), on
    states made from this checkout's --add inputs on the card; `plans`
    None: the per-leaf kernel alone (no range launch is timed)."""
    from dipper_tpu_torch.placement import insert_cuda
    from dipper_tpu_torch.placement import kclosest as tk

    frontend_args, arrays, kw = add_inputs(all_fa, back_nwk, "cuda")
    N, B = kw["num_sequences"], kw["backbone_size"]

    def state():
        return tk.add_state(*arrays, num_sequences=N, backbone_size=B,
                            dtype_name=kw["dtype_name"], use_adj=False)

    six = ("e", "belong", "length", "rev", "cdis", "cid")
    one, rng = state(), state()
    rec = {"backbone": B, "leaves": leaves, "n_off": one.wide_off.numel(),
           "n_eid": one.wide_eid.numel(),
           "plans": ([] if plans is None else
                     [insert_cuda.range_plan(rng, **p)
                      for p in [{}] + plans])}
    lo0 = tk.GRAPH_INSERTIONS
    done = 0
    for tag, lo in (("window", lo0), ("late", max(lo0 + leaves,
                                                   min(late, B - leaves)))):
        tk._seed_by_range(one, done, lo)
        tk._seed_by_range(rng, done, lo)
        snap = {f: getattr(rng, f).clone() for f in six}
        stamps = torch.zeros((leaves, insert_cuda.STAMP_WORDS),
                             dtype=torch.int64, device=one.e.device)
        insert_cuda.set_cursor(one, lo)
        for k in range(leaves):
            insert_cuda.closest_bfs_wide_stamped(one, stamps[k])
        got = {"first_leaf": lo,
               "per_leaf": _stamp_summary(stamps.cpu())}
        if not rec["plans"]:
            tk._seed_by_range(rng, lo, lo + leaves)
        for j, plan in enumerate(rec["plans"]):
            for f in six:
                getattr(rng, f).copy_(snap[f])
            rs = torch.zeros_like(stamps)
            insert_cuda.set_cursor(rng, lo)
            insert_cuda.closest_bfs_range(rng, leaves, plan, stamps=rs)
            bad = [f for f in six if not torch.equal(getattr(one, f),
                                                     getattr(rng, f))]
            if bad:
                raise SystemExit(f"parts, {tag}: the range kernel at plan "
                                 f"{plan} != the per-leaf kernel in {bad}")
            got["range" if j == 0 else f"range_plan_{j}"] = _stamp_summary(
                rs.cpu())
        rec[tag] = got
        done = lo + leaves
    # the card's gaps between a replayed graph's per-leaf launches, and
    # the range launch's record, over the next 2 x GRAPH_INSERTIONS leaves
    n = 2 * tk.GRAPH_INSERTIONS
    tk._seed_by_cursor(one, done, done + tk.GRAPH_INSERTIONS)  # capture
    tk._seed_by_range(rng, done, done + tk.GRAPH_INSERTIONS)
    done += tk.GRAPH_INSERTIONS
    k1 = _kernel_records(lambda: tk._seed_by_cursor(one, done, done + n),
                         ["closest_bfs_wide_kernel"])
    k2 = ({"closest_bfs_range_kernel": []} if plans is None else
          _kernel_records(lambda: tk._seed_by_range(rng, done, done + n),
                          ["closest_bfs_range_kernel"]))
    if plans is None:
        tk._seed_by_range(rng, done, done + n)
    runs = k1["closest_bfs_wide_kernel"]
    gaps = [b[0] - a[1] for a, b in zip(runs, runs[1:])]
    rec["profiled"] = {
        "first_leaf": done, "leaves": n, "per_leaf_records": len(runs),
        "per_leaf_kernel_us": (sum(b - a for a, b in runs) / len(runs)
                               if runs else None),
        "gap_us_mean": sum(gaps) / len(gaps) if gaps else None,
        "gap_us_min": min(gaps) if gaps else None,
        "gap_us_max": max(gaps) if gaps else None,
        "per_leaf_span_us": (runs[-1][1] - runs[0][0]) / len(runs)
        if runs else None,
        "range_records": len(k2["closest_bfs_range_kernel"]),
        "range_us_per_leaf": (sum(b - a for a, b in
                                  k2["closest_bfs_range_kernel"]) / n
                              if k2["closest_bfs_range_kernel"] else None)}
    bad = [f for f in six if not torch.equal(getattr(one, f),
                                             getattr(rng, f))]
    if bad:
        raise SystemExit(f"parts, profiled: the routes differ in {bad}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30000,
                    help="taxa of the generated set")
    ap.add_argument("--sizes", default="4096,28976",
                    help="backbone sizes, comma-separated")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--checkout", action="append", default=None,
                    help="a checkout whose CLI runs --add (repeatable; "
                         "default: this one)")
    ap.add_argument("--window", type=int, default=64,
                    help="leaves and queries of each dense-route window")
    ap.add_argument("--no-dense", action="store_true",
                    help="skip the in-process dense route")
    ap.add_argument("--parts", action="store_true",
                    help="the stamped split of the seeding (this checkout, "
                         "in this process, on the card)")
    ap.add_argument("--parts-leaves", type=int, default=256,
                    help="leaves of each stamped stretch")
    ap.add_argument("--late", type=int, default=20000,
                    help="first leaf of the late stamped stretch")
    ap.add_argument("--no-range", action="store_true",
                    help="--parts of the per-leaf kernel alone")
    ap.add_argument("--plans", default="",
                    help="more range-kernel plans for --parts, as JSON "
                         "objects of range_plan's forced parts separated "
                         "by ';' (e.g. '{\"cap\": 256, \"list_cap\": 256}')")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: a rehearsal at a small --n (no syncs, "
                         "launches or card times)")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds an --add run may take")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "profile_add"))
    args = ap.parse_args()
    # the checkouts' CLIs run in their own directories
    args.out = os.path.abspath(args.out)
    dev = args.device
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_add_torch: CUDA is not available")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    checkouts = [os.path.abspath(c) for c in (args.checkout or [REPO])]
    turns = (checkouts + checkouts[::-1] if len(checkouts) > 1
             else checkouts * 2)
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, f"n{args.n}")
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", "make_dataset.py"),
                        "-n", str(args.n), "-L", "10000", "-o", prefix,
                        "--seed", "1"],
                       check=True, stdout=subprocess.DEVNULL, timeout=600)
        for B in map(int, args.sizes.split(",")):
            run_size(args, dev, turns, prefix + ".fa", B, tmp)
    return 0


def run_size(args, dev: str, turns: list, fa: str, B: int, tmp: str) -> None:
    """One backbone size: its build, collapse, --add runs and the dense
    route (the FASTAs in `tmp`, the Newicks and logs in args.out)."""
    tag = os.path.join(args.out, f"b{B}")
    back_fa = head_fasta(fa, B, os.path.join(tmp, f"b{B}.back.fa"))
    all_fa = head_fasta(fa, B + args.queries,
                        os.path.join(tmp, f"b{B}.all.fa"))
    rc, _, wall = cli(REPO, ["-i", "r", "-I", back_fa, "-O",
                             tag + ".binary.nwk", "-m", "1", "--device",
                             dev],
                      tag + ".binary.log", args.timeout)
    if rc != 0:
        raise SystemExit(f"backbone build of {B} returned {rc}")
    with open(tag + ".binary.nwk") as f:
        nwk, counts = collapse_backbone(f.read())
    back_nwk = tag + ".back.nwk"
    with open(back_nwk, "w") as f:
        f.write(nwk + "\n")
    emit({"backbone": B, "build_s": wall, **counts})
    for k, c in enumerate(turns):
        out = f"{tag}.out.{k}.nwk"
        rc, log, wall = cli(c, ["-i", "r", "-I", all_fa, "-O", out,
                                "--add", "-t", back_nwk, "--device",
                                dev],
                            f"{tag}.add.{k}.log", args.timeout)
        route = re.search(r"Backbone has multifurcations[^\n]*", log)
        md5 = None
        if rc == 0:
            with open(out, "rb") as f:
                md5 = hashlib.md5(f.read()).hexdigest()
        seeded = _ms(r"seeded in: ([\d.]+) ms", log)
        ins = _ms(r"insertions ([\d.]+) ms", log)
        emit({"add": B, "queries": args.queries, "checkout": c,
              "turn": k, "rc": rc, "wall_s": wall,
              "seeding_ms_per_leaf": seeded / B if seeded else None,
              "ms_per_query": ins / args.queries if ins else None,
              "graph_captures": _ms(r"graph captures (\d+)", log),
              "route": route.group(0) if route else None,
              "newick_md5": md5})
    if not args.no_dense:
        emit({"dense_route": dense_route(all_fa, back_nwk, args.window,
                                         dev)})
    if args.parts:
        plans = (None if args.no_range else
                 [json.loads(p) for p in args.plans.split(";") if p.strip()])
        emit({"parts": stamped_parts(all_fa, back_nwk, args.parts_leaves,
                                     args.late, plans)})


if __name__ == "__main__":
    sys.exit(main())
