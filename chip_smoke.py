#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (dipper_tpu_torch).

Runs on one NVIDIA GPU, from the root of a checkout:

    python3 chip_smoke.py                  # all phases
    python3 chip_smoke.py --phases 1,2,3,6,7 --n 4400   # kernel checks only

Phases, each printing one line of its own (run in the order 1, 2, 3, 6,
15, 7, 25, 19, 4, 17, 5, 16, 9, 24, 10, 11, 12, 14, 13, 8, 18, 20, 21, 22,
23:
phases 13, 8 and 18 run the profiler, which slows every later launch in
the process; phases 20 to 22 run in processes of their own):
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: compile the hand-written kernels from dipper_tpu_torch/csrc/,
     one nvcc per source, all started together;
  3. merge-count kernel vs plain: mash_inter_cuda against
     merged_inter_count_ref on the card, torch.equal required, on (a) real
     S=1000 sketches (bank 4,096 x 259 queries), (b) S=128 (pow2, no
     pads), (c) adversarial duplicate- and sentinel-heavy rank rows, (d)
     the main path's bank width (every taxon) with 64 queries, (e)-(h)
     ragged shapes (neither side a multiple of the kernel's tile, one row
     a side, S = 33 and S = 1); and the main paths' largest calls (every
     taxon x 8,192 queries, 20,000 x 4,096), every 128th query row
     compared. Times are CUDA-event means after a warm-up, each beside its
     bound (see mash_bound) and the share of the bound reached;
  6. distance kernel vs plain: mash_rows_dist_cuda against
     mash_rows_vs_bank on the cases and calls of phase 3, in f32 and f64,
     torch.equal required, with times, bounds and shares;
  15. per-cluster count kernel vs plain: mash_cluster_inter_cuda against
     cluster_inter_ref, torch.equal required, on the placement set's S =
     1000 sketches: D&C's bucket shapes (the 100K run's five, 3,113 x 8
     to 39 x 128, every 16th cluster compared; 17 x 128, the 30K run's
     widest), 13 clusters of ragged sizes (the repeat pad) up to cmax 8,
     16, 32, 64, 128 and 1,023, one cluster, a witness tail that is not
     the member list; on adversarial rows at S = 100, 33 and 1; the wrapper's
     and the card's own times beside their bounds (with --parent DIR, an
     earlier checkout's kernel timed in turns on the same inputs);
  7. the scorer's kernels vs plain, equal bits required throughout:
     side_vector_cuda against _side_vector at cap 16,384 with 65,536 edges
     and at cap 30,000 with 120,000 edges, in f32 and f64; score_edges_cuda
     against _score_edges_plain (all six outputs) on made-up states (a tie
     between two valid edges, every valid score above 2.0, used slots up to
     and short of the arrays' end, NaN and +inf in the row, a state of four
     edges), f32 and f64, and on a real tree state: the port's placement
     built on the card to N = 4,096, then the rows of 256 taxa that were
     not inserted. For both entry points, side by side: the kernel's own
     time on the card (a captured CUDA graph of 200 launches, replayed),
     the wrapper's host time per call, the bound from its bytes, and the
     plain version's time;
  25. the insertion-step kernel (csrc/insert_step.cu: splice and witness
     BFS) vs plain, the seven state arrays bit for bit after every launch:
     made-up splices (ties, empty entries and NaN in the ten-way merge, f32
     and f64), whole builds from made-up matrices (random, a caterpillar,
     NaN pairs, all-NaN f64), phase 7's 4,096-taxon build, --add's seeding
     of a placement backbone and of a balanced 1,024-leaf backbone (levels
     wider than the kernel's block), D&C's streamed cluster (label, blocked
     slot, scoreable cleared from the kernel's output) against its plain
     route on the card; and one BFS level's latency (a BFS of ~2,049
     levels on a caterpillar, CUDA events);
  4. GPU port vs CPU port, placement: the CLI at N=512 (-i r -m 1) with
     --device cuda and --device cpu, the same Newick bytes required;
  17. GPU port vs CPU port, D&C: the CLI with -m 3 at N = 600 (B = 30,
     seed 4) in f64 with streamed clusters (16 members and up, rows 5 at a
     time) and several builds a bucket forced: the same Newick bytes;
  8. GPU port vs CPU port, NJ: the mash matrix of N=2,048 taxa written by
     the card (-i r -o d), and -i r -o d of its first 512 on both devices
     (device sketcher, device ranks and kernel 2 on the card, their plain
     versions on the CPU: the same PHYLIP bytes), then -i d -m 2 on both
     devices in f32 and f64, nRF = 0 required; then one NJ on the card under torch.profiler
     (launches per merge step, device busy time), and the launches,
     copies and syncs of one scorer call, kernel and plain;
  5. the placement main path: scripts/make_dataset.py's generator (seed
     1, L=10,000) and the CLI with default flags, which take k-closest
     placement at N >= 30,000; requires rc 0, a complete Newick, launches
     of the merge-count kernel, one score_edges and one insert_step launch
     per insertion, the BFS alone twice and no standalone side-vector
     launch, the tree state on the card and nRF
     vs the true tree < 0.35. Every merge-count launch of the run is then
     held against the plain version on its own inputs, every 128th query
     row of it; no sketch-kernel launch (placement sketches on the host,
     as in the JAX package), and at N = 30,000 the nRF of every earlier
     smoke (PLACEMENT_NRF_30K); every 997th insertion is held against the
     plain version as it happens (the scorer's six values, then the seven
     state arrays against a copy stepped by the plain version), and before
     the last insert range its first 300 rows (taxa not yet inserted) are
     scored by kernel and plain version on the state as it stands, where
     the scorer is also timed, three rows (one with NaN at the witnesses
     of the first used slots) are scored by slot ranges as in phase 19,
     each range launch timed, and its first 300 insertions are run by the
     kernels (each launch timed by CUDA events, queued behind a device
     sleep), by the plain version and by insert_model, to the same state,
     which is then put back (those launches are taken out of the count);
     the last range itself then runs under
     torch.cuda.set_sync_debug_mode("error") at 2 launches per insertion;
  16. the D&C main path: the CLI with -m 3 on phase 5's set (B = N // 20
     = 1,500): rc 0, a complete Newick with nRF vs the true tree under
     DC_NRF_LIMIT, launches of the per-cluster count kernel and of the
     merge-count kernel, one score_edges launch per backbone insertion (B
     - 2), one insert_step launch per backbone insertion and streamed
     member; every per-cluster count launch held against the plain version
     on its every 16th cluster, the widest batched bucket's launch timed
     whole beside its bound and its plain version; phase times, bucket
     lines, cluster sizes, host syncs per phase-3 step;
  18. launches and host syncs per phase-3 step of one batched build at 64
     and 1,024 clusters under torch.profiler (made-up inputs): the
     launches of a step must not grow with the clusters;
  9. the NJ main path: the generator at N=20,000 (seed 1) and the CLI
     with default flags, which take conventional NJ below 30,000 taxa;
     requires rc 0, a complete Newick, distance-kernel and sketch-kernel
     launches (the NJ matrix sketches on the card, as in the JAX
     package), every distance launch's every 128th row equal to the plain
     version, a symmetric matrix with a zero diagonal whose lower
     triangle is the kernel's rows and which equals, entry for entry,
     the host route's (native sketches, np.unique ranks), and nRF vs the
     true tree < 0.45 (at N = 20,000 the value of every earlier smoke,
     NJ_NRF_20K); "Sketch in" and "Rank bank in" beside the host route's;
  24. the sketch kernel (csrc/minhash_sketch.cu) against its plain
     version on the card and the native host sketcher, equal bits
     required throughout: phase 5's set (every row against the native
     bank and the plain version, the first 512 also on their own) and
     phase 9's, and adversarial rows (lengths 0, k-1, k, k+1, around the
     4,096-window tile edge, 10,000 and 2,000,000; N, lowercase and U
     bytes; a repeat-heavy row; k 4, 11, 15; s 1, 100, 1000, 1024 and the
     kernel's largest); device rank_compress equal to the first-of-run
     rule computed on the host, and kernel 2's distances through it equal
     to those through rank_compress_host; for both sets the kernel's own
     time by CUDA events (stages (a) and (b), and (a) without its sort),
     M k-mers/s, its bound from operations and bytes and the share
     reached, the host's encode/pack and the H2D copy, rank_compress
     against rank_compress_host, the native sketcher with the host's CPU
     and threads, and as a yardstick torch.sort along rows of the set's
     [rows, windows] hash matrix (whose first s columns must equal the
     kernel's rows);
  10. MSA pair counts and distances on an aligned set (the generator
     with --aligned at N=20,000, L=10,000, 5% gaps, seed 1): the card's
     counts of 4,096 queries x the bank's first 4,096 rows against an
     int64 count on the host for sampled pairs, bitwise; the six models in
     f32 and f64 against the port's CPU result, NaN and inf in the same
     places, on 256 close relatives (branch scale 0.1: rtol 2e-6 and 1e-12
     with an atol of 64 ulps of 1) and on the set's first 256 sequences,
     mostly saturated pairs next to the models' poles (rtol 1e-3 and
     1e-9); the time of one row
     block's product (torch._int_mm, no hand kernel: the reference leaves
     this product to its compiler too) beside its bound, and of its
     formulas;
  11. the -i m main path: the CLI with default flags on that alignment
     (auto mode takes NJ, -d 1); requires rc 0, a complete Newick and nRF
     vs the true tree under MSA_NJ_NRF_LIMIT;
  12. -i m -m 1 on the alignment's first 8,192 sequences: one score_edges
     and one insert_step launch per insertion, nRF vs the true tree
     restricted to them under MSA_PLACE_NRF_LIMIT;
  14. --add: a backbone built by the port from the first 4,096 sequences
     of the placement set (-i r -m 1), then --add of the next 1,024: every
     backbone split survives, score_edges launches = 1,024, insert_step
     launches = 1,024 and the BFS alone once a backbone leaf, merge-count
     launches > 0; and the same Newick from the card and the CPU at a
     backbone of 256 with 64 queries;
  13. exact placement on the card in f64, through
     build_placement_tree_from_seqs(exact=True) on the alignment's first
     512 sequences and build_placement_tree_from_matrix(exact=True) on
     their distance matrix: the same Newick as the port's CPU build, the
     tree's greatest depth, ms per insertion, and the launches, copies and
     syncs per insertion of the matrix build's last 32 insertions under
     torch.profiler.
  19. the scorer by slot ranges (a rank's share of a sharded build): the
     made-up states of phase 7, f32 and f64, split 2 and 3 ways and at
     borders on the winning slot, between two tied edges, at n_used and
     in the unused tail; every range launch equal to the plain version on
     its range and the ranges' choices, merged in the kernel's order,
     equal to the one-launch result, bit for bit; each range launch timed
     at 120,000 slots;
  20. two ranks on the one card, NJ: two processes of the CLI with
     --coordinator 127.0.0.1:P --num-processes 2 --process-id r --devices
     2 -m 2 on phase 9's set: the Newick byte-equal to phase 9's; each
     rank's backend, time to tree, ms per merge step and host syncs per
     step; every distance-kernel and sketch-kernel launch of each rank
     sampled against the plain version (each rank sketches on the card);
  21. two ranks on the one card, D&C: the same with -m 3 on phase 5's set:
     byte-equal to phase 16's tree; each rank's phase times; kernels 1, 2,
     3 and 4 sampled on each rank's launches;
  22. sharded_mash_matrix and sharded_placement_build over two ranks on the
     first 4,096 taxa of phase 5's set: equal to the single-process matrix
     and placement arrays; kernels 1, 2 and 3 sampled on the ranks'
     launches; whether gloo takes CUDA tensors;
  23. --profile on a small build (-i r -m 2 at N = 512, the CLI in a
     process of its own): a trace holding the port's mash kernel among
     its CUDA kernel events, and the same tree as without it.
Two ranks on one card share it by time-slicing two CUDA contexts; their
times are those of two processes sharing one card, not of sharding. Each
rank of phases 20 to 22 is a process of this script (--worker-cli,
--worker-sharded), checks that it imported no JAX, and is killed with its
group past RANK_TIMEOUT_S.
Phase 13's size, 512, is a quarter of what a 600 s budget for the whole
script would not hold (2,048): exact placement's sweeps are the host's
tensor code. Phases 12, 14 and 4 are back at 8,192, 4,096 + 1,024 and
512, since the insertion-step kernel took their insertion loops off the
host.
Every kernel counter is set to 0 just before a main path (phases 5, 16,
9, 11, 12, 14, and in each rank of 20, 21 and 22) and read just after it;
`launches` in the kernels' record is the count of phases 5 (placement;
insert_step's counts both its entry points), 16 (D&C: the per-cluster
count kernel) and 9 (NJ; also the sketch kernel's), `launches_by_path` has
every path's (one count a rank for the multi-rank paths), and
score_edges's `range_launches` the sharded placement's range launches.

The last two lines are the kernels' record and {"ok": true, "device":
{...}}. Any failed check raises, so the script exits non-zero and prints no
result; it also exits non-zero without CUDA. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# each kernel: its source and the TPU kernel it replaces
KERNELS = {
    "mash_merge_count": ("dipper_tpu_torch/csrc/mash_merge_count.cu",
                         "dipper_tpu/distance/mash_pallas.py:143"),
    "mash_rows_dist": ("dipper_tpu_torch/csrc/mash_rows_dist.cu",
                       "dipper_tpu/distance/mash_pallas.py:191"),
    "side_vector": ("dipper_tpu_torch/csrc/side_vector.cu",
                    "scripts/gather_micro.py:74"),
    "score_edges": ("dipper_tpu_torch/csrc/score_edges.cu",
                    "scripts/gather_micro.py:74"),
    "mash_cluster_inter": ("dipper_tpu_torch/csrc/mash_cluster_inter.cu",
                           "dipper_tpu/dc/pipeline.py:1093"),
    "minhash_sketch": ("dipper_tpu_torch/csrc/minhash_sketch.cu",
                       "dipper_tpu/sketch/minhash.py:274 (XLA program, no "
                       "Pallas)"),
    "insert_step": ("dipper_tpu_torch/csrc/insert_step.cu",
                    "dipper_tpu/placement/kclosest.py:857 (XLA program, no "
                    "Pallas)"),
}
NRF_LIMIT = 0.35
# nRF vs the true tree of the full-size sets (seed 1) in every smoke so
# far: placement at 30,000 (the JAX package's value) and NJ at 20,000;
# the device sketcher must leave both unchanged
PLACEMENT_NRF_30K = 0.2948961562822949
NJ_NRF_20K = 0.32029804470670603
# NJ 20K's "Sketch in" and "Rank bank in" (ms) on the host route (native
# sketcher, np.unique), the final smoke of the commit before the device
# sketcher
HOST_ROUTE_NJ_20K_MS = {"sketch": 1820, "rank_bank": 2893}
# a sanity bound for NJ on the generator's 20K set (no JAX figure exists)
NJ_NRF_LIMIT = 0.45
# every SIDE_SAMPLE-th insertion of the placement main path is held
# against the plain version (the scorer's six values, the seven state
# arrays after the insert step)
SIDE_SAMPLE = 997
# insertions of the placement state before its last range timed launch by
# launch and held against the plain version and insert_model
INSERT_WINDOW = 300
# a device sleep (clock cycles, ~10 ms) that QUEUE_CHUNK insertions' launches
# wait behind, so that the card runs them back to back and CUDA events
# time the kernels and not the host's gaps
QUEUE_SLEEP_CYCLES = 20_000_000
QUEUE_CHUNK = 32
# rows scored on the real states (phase 7's N = 4,096 build, phase 5's
# state before its last range)
SCORE_ROWS = (256, 300)
# sanity bounds for the aligned set (uncorrected distances saturate along
# the generator's long paths; no JAX figure exists)
MSA_NJ_NRF_LIMIT = 0.35
MSA_PLACE_NRF_LIMIT = 0.45
# a sanity bound for D&C on the placement set (N = 30,000, B = 1,500),
# set from the first card run (nRF 0.5832); no JAX figure exists at that
# size
DC_NRF_LIMIT = 0.65
# every DC_SAMPLE-th cluster of each per-cluster count launch of the D&C
# main path is held against the plain version
DC_SAMPLE = 16
ALL_PHASES = (1, 2, 3, 6, 15, 7, 25, 19, 4, 17, 5, 16, 9, 24, 10, 11, 12, 14,
              13, 8, 18, 20, 21, 22, 23)
# every SAMPLE-th query row of a large kernel call is compared with the
# plain version (which takes ~10 ms per query row at 30,000 bank rows)
SAMPLE = 128
# The card's peaks that the bounds divide by (H100 SXM data sheet): device
# memory rate, and the int32 rate outside the tensor cores: 132
# multiprocessors x 64 int32 lanes x 1.98 GHz, one operation a lane a
# clock (half the lanes of the 67 TFLOP/s float32 figure, no FMA's two).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_PER_S = 132 * 64 * 1.98e9
# dense int8 rate of the tensor cores (the MSA pair-count product)
PEAK_INT8_PER_S = 1979e12
# integer operations of one step of the mash walk: a compare, a pointer
# advance, two counter updates
OPS_PER_WALK_STEP = 4
# 32-bit integer operations of one window of the sketch kernel at k > 8,
# counted from csrc/minhash_sketch.cu (a 64-bit multiply as 3, a 64-bit
# shift, rotate, xor or add as 2): the window's codes from two words and
# its canonical form 17; the key bytes 26 (two nibble spreads, the pads,
# four byte permutes, the two words); the murmur tail 64 (two key blocks
# of two multiplies, a rotate and an xor; the length; two adds; two
# finalisers of three shift-xors and two multiplies; the last add); the
# length mask and one 64-bit compare of the bottom-k 5
SKETCH_OPS_PER_WINDOW = 17 + 26 + 64 + 5
# the sketch kernel's plain version on the card: its tiles of windows and
# row chunks (its bits do not depend on them)
PLAIN_SKETCH_TILE = 2**16
PLAIN_SKETCH_CHUNK_BYTES = 2**31


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def make_dataset(n: int, prefix: str, seed: int, aligned: bool = False,
                 blen_scale: float | None = None) -> tuple[str, str]:
    """scripts/make_dataset.py (L=10,000; unaligned with 2% indels, or
    aligned with 5% gaps; the generator's branch scale unless one is
    given) -> (.fa, .true.nwk)."""
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_dataset.py"),
         "-n", str(n), "-L", "10000", "-o", prefix, "--seed", str(seed)]
        + (["--aligned"] if aligned else [])
        + (["--blen-scale", str(blen_scale)] if blen_scale else []),
        check=True, stdout=subprocess.DEVNULL, timeout=600)
    return prefix + ".fa", prefix + ".true.nwk"


def head_fasta(fa: str, n: int, out: str) -> str:
    """The first n records of a generated FASTA (two lines a record)."""
    import itertools

    with open(fa, "rb") as f, open(out, "wb") as g:
        g.writelines(itertools.islice(f, 2 * n))
    return out


def ranks_of(seqs, k: int, s: int) -> np.ndarray:
    from dipper_tpu_torch.distance.mash import pad_ranks, rank_compress_host
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    sk = sketch_sequences_native(seqs, k, s)
    check(sk is not None, "native sketcher unavailable")
    return pad_ranks(rank_compress_host(sk))


def host_cpu() -> str:
    """The host's CPU model from /proc/cpuinfo, or its vendor, family and
    model numbers where the model name reads "unknown" (as on the card's
    virtual machines)."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            key, _, val = ln.partition(":")
            info.setdefault(key.strip(), val.strip())
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}")
    return name


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "torch_name": name, "nvidia_smi": line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "host_cpu": host_cpu(),
            "nproc": len(os.sched_getaffinity(0))}
    emit(info)
    return info


def phase_build() -> None:
    from dipper_tpu_torch.csrc.build import BUILD_DIR, BUILD_SECONDS, build_all

    t0 = time.time()
    build_all()
    ptxas = {}
    for name in KERNELS:
        with open(os.path.join(BUILD_DIR, f"lib{name}.log")) as f:
            ptxas[name] = [ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_s": dict(BUILD_SECONDS),
          "wall_s": time.time() - t0, "ptxas": ptxas})


def event_ms(fn, reps: int = 200) -> float:
    """Mean ms per call over `reps` back-to-back calls between two CUDA
    events, after a warm-up."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def graph_ms(fn, reps: int = 200, replays: int = 5) -> float:
    """Mean ms per launch on the card alone: `fn` (launches only, no host
    sync) is captured `reps` times into one CUDA graph, and the graph's
    replays are timed between two CUDA events. No Python runs between
    the launches, so this is the kernel's own duration plus the card's
    gap between two dependent kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(replays):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / (reps * replays)


def host_ms(fn, reps: int = 200) -> float:
    """Mean ms of host time per call of `fn` (launches only): what the
    wrapper costs before the card sees the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def bound_of(ops: float, nbytes: float,
             ops_per_s: float = PEAK_INT32_PER_S) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    by_ops = ops / ops_per_s * 1e3
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def mash_bound(inter: torch.Tensor, n_query: int, n_bank: int, s: int,
               item: int, table: bool) -> dict:
    """Bound of one mash kernel call of n_query x n_bank pairs from this
    run's data. A pair's walk takes s + inter steps (every step raises
    uni or inter, and it ends at uni == s), OPS_PER_WALK_STEP integer
    operations each; `inter` holds the counts of the call's pairs, all of
    them or some of its query rows (then scaled up). Bytes: the first s
    ranks of every bank and query row once, the table, the [Q, N] output
    of `item`-byte values once."""
    pairs = n_query * n_bank
    steps = pairs * s + float(inter.sum()) * (pairs / inter.numel())
    nbytes = (n_bank + n_query) * s * 4 + pairs * item
    if table:
        nbytes += (s + 1) * item
    out = bound_of(OPS_PER_WALK_STEP * steps, nbytes)
    out["steps"] = steps
    return out


def with_share(rec: dict, bound: dict) -> dict:
    rec.update(bound)
    rec["share_of_bound"] = bound["bound_ms"] / rec["ms"]
    return rec


def _adversarial(n: int, s: int, m: int, rng) -> np.ndarray:
    """Rank rows in the style of tests/test_mash.py: a small value universe
    (many duplicates and cross-duplicates), every other row
    sentinel-heavy, padded to m with the pad rank."""
    from dipper_tpu_torch.distance.mash import _PAD_KEY

    rows = np.sort(rng.integers(0, 60, (n, s)), axis=1)
    heavy = rng.random(n) < 0.5
    rows[heavy, s - s // 3:] = 59
    pad = np.full((n, m - s), (_PAD_KEY - 1) // 2)
    return np.concatenate([rows, pad], axis=1).astype(np.int32)


def check_sampled(name: str, got, bank, qry, s: int) -> tuple:
    """Holds every SAMPLE-th row of the kernel's output `got` (or `got`
    itself when it holds only those rows) against the plain version of
    the same query rows; returns (record, the plain counts)."""
    from dipper_tpu_torch.distance.mash import merged_inter_count_ref

    if got.shape[0] == qry.shape[0]:
        got = got[::SAMPLE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = merged_inter_count_ref(bank, qry[::SAMPLE].contiguous(),
                                  sketch_size=s)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), f"{name}: kernel != plain on every "
          f"{SAMPLE}th query row (max abs err {err})")
    return ({"bank": bank.shape[0], "queries": qry.shape[0], "s": s,
             "rows_checked": want.shape[0], "equal": True, "max_abs_err": err,
             "plain_ms_checked_rows": plain_ms}, want)


def kernel_cases(fa: str) -> tuple[dict, np.ndarray, float]:
    """The kernel phases' inputs from the main path's FASTA: (cases
    name -> (bank, queries, sketch_size) host rank arrays, the S=1000 rank
    bank of every taxon, its sketch seconds)."""
    from dipper_tpu_torch.io.fasta import read_fasta

    _, seqs = read_fasta(fa)
    n = len(seqs)
    rng = np.random.default_rng(0)
    t0 = time.time()
    r1000 = ranks_of(seqs, 15, 1000)
    sketch_s = time.time() - t0
    r128 = ranks_of(seqs[:2148], 15, 128)
    cases = {
        "a_s1000_bank4096_q259": (r1000[:4096], r1000[4096:4096 + 259], 1000),
        "b_s128_bank2048_q100": (r128[:2048], r128[2048:2148], 128),
        "c_adversarial_s100": (_adversarial(777, 100, 128, rng),
                               _adversarial(67, 100, 128, rng), 100),
        f"d_s1000_bank{n}_q64": (r1000, r1000[-64:], 1000),
        # ragged: neither side a multiple of the kernel's tile (at most 16
        # rows at S = 1000, 64 at S <= 128), one row a side, S = 33, S = 1
        "e_s1000_bank333_q77": (r1000[1000:1333], r1000[77:154], 1000),
        "f_s1000_bank1_q1": (r1000[:1], r1000[1:2], 1000),
        "g_adversarial_s33_bank65_q129": (_adversarial(65, 33, 64, rng),
                                          _adversarial(129, 33, 64, rng), 33),
        "h_adversarial_s1_bank67_q5": (_adversarial(67, 1, 2, rng),
                                       _adversarial(5, 1, 2, rng), 1),
    }
    return cases, r1000, sketch_s


def main_calls(r1000: torch.Tensor) -> dict:
    """The main paths' largest kernel calls, as views of the rank bank on
    the card: placement's range call (every taxon x 8,192 queries) and
    NJ's row block (20,000 x 4,096)."""
    n = r1000.shape[0]
    return {f"range_call_bank{n}_q8192": (r1000, r1000[-min(8192, n):]),
            "nj_call_bank20000_q4096": (r1000[:20000], r1000[:4096])}


def _on_card(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def _reps(pairs: int) -> int:
    """Timed launches of a mash call: fewer for the large ones."""
    return 3 if pairs > 10**7 else 20 if pairs > 10**5 else 100


def phase_kernel_vs_plain(inputs) -> dict:
    from dipper_tpu_torch.distance.mash import merged_inter_count_ref
    from dipper_tpu_torch.distance.mash_cuda import mash_inter_cuda

    cases, r1000, sketch_s = inputs
    n = r1000.shape[0]
    worst = 0
    out = {}
    for name, (bank, qry, s) in cases.items():
        bank, qry = _on_card(bank, qry)
        got = mash_inter_cuda(bank, qry, sketch_size=s)
        want = merged_inter_count_ref(bank, qry, sketch_size=s)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want), f"{name}: kernel != plain "
              f"(max abs err {err})")
        worst = max(worst, err)
        pairs = bank.shape[0] * qry.shape[0]
        ms = event_ms(lambda: mash_inter_cuda(bank, qry, sketch_size=s),
                      _reps(pairs))
        plain_ms = event_ms(
            lambda: merged_inter_count_ref(bank, qry, sketch_size=s), 3)
        out[name] = with_share(
            {"bank": bank.shape[0], "queries": qry.shape[0], "s": s,
             "M": bank.shape[1], "equal": True, "ms": ms,
             "plain_ms": plain_ms, "pairs_per_s": pairs / ms * 1e3,
             "plain_pairs_per_s": pairs / plain_ms * 1e3,
             "mean_inter": float(want.float().mean())},
            mash_bound(want, qry.shape[0], bank.shape[0], s, 4, False))
    # the main paths' largest calls; the plain version of all of one would
    # take minutes, so they are compared on every SAMPLE-th query row
    (bank_all,) = _on_card(r1000)
    calls = {}
    for name, (bank, qry) in main_calls(bank_all).items():
        bank, qry = bank.contiguous(), qry.contiguous()
        rc, want = check_sampled(
            name, mash_inter_cuda(bank, qry, sketch_size=1000), bank, qry,
            1000)
        worst = max(worst, rc["max_abs_err"])
        rc["ms"] = event_ms(
            lambda: mash_inter_cuda(bank, qry, sketch_size=1000), 3)
        rc["pairs_per_s"] = bank.shape[0] * qry.shape[0] / rc["ms"] * 1e3
        calls[name] = with_share(rc, mash_bound(
            want, qry.shape[0], bank.shape[0], 1000, 4, False))
    emit({"phase": "kernel_vs_plain", "kernel": "mash_merge_count",
          "timing": "CUDA events, mean of back-to-back launches after a "
                    "warm-up",
          "bound": {"ops_per_step": OPS_PER_WALK_STEP,
                    "int32_ops_per_s": PEAK_INT32_PER_S,
                    "bytes_per_s": PEAK_BYTES_PER_S},
          "sketch_all_s": sketch_s, "cases": out, "max_abs_err": worst,
          "main_calls": calls})
    return _mash_record(out[f"d_s1000_bank{n}_q64"], calls, worst)


def _mash_record(main_case: dict, calls: dict, worst) -> dict:
    """A mash kernel's entry in the `kernels` line: the main path's bank
    with 64 queries (the largest shape at which the plain version of the
    whole call is timed), and the main paths' own calls beside it."""
    rec = {k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "share_of_bound")}
    rec.update(max_abs_err=worst, library_ms=None,
               shape=[main_case["bank"], main_case["queries"]],
               main_calls={name: {k: c[k] for k in (
                   "ms", "bound_ms", "bound_by", "share_of_bound")}
                   for name, c in calls.items()})
    return rec


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the entries that are not NaN in both; inf
    where the NaN positions differ."""
    nan = got.isnan()
    if not torch.equal(nan, want.isnan()):
        return float("inf")
    if bool(nan.all()):
        return 0.0
    return float((got[~nan].double() - want[~nan].double()).abs().max())


def phase_rows_dist_vs_plain(inputs, k: int = 15) -> dict:
    from dipper_tpu_torch.distance.mash import (_dist_table, mash_rows_vs_bank,
                                                merged_inter_count_ref)
    from dipper_tpu_torch.distance.mash_cuda import mash_rows_dist_cuda

    cases, r1000, _ = inputs
    n = r1000.shape[0]
    worst = 0.0
    out = {}
    calls = {}
    (bank_all,) = _on_card(r1000)
    for dtype in ("float32", "float64"):
        item = np.dtype(dtype).itemsize
        for name, (bank, qry, s) in cases.items():
            bank, qry = _on_card(bank, qry)
            table = torch.from_numpy(_dist_table(k, s, dtype)).cuda()

            def kernel():
                return mash_rows_dist_cuda(bank, qry, table, sketch_size=s)

            def plain():
                return mash_rows_vs_bank(bank, qry, k=k, sketch_size=s,
                                         dtype_name=dtype)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"mash_rows_dist {dtype} {name}: kernel != plain "
                  f"(max abs err {err})")
            worst = max(worst, err)
            pairs = bank.shape[0] * qry.shape[0]
            ms, plain_ms = event_ms(kernel, _reps(pairs)), event_ms(plain, 3)
            out[f"{dtype}/{name}"] = with_share(
                {"bank": bank.shape[0], "queries": qry.shape[0], "s": s,
                 "equal": True, "ms": ms, "plain_ms": plain_ms,
                 "pairs_per_s": pairs / ms * 1e3},
                mash_bound(merged_inter_count_ref(bank, qry, sketch_size=s),
                           qry.shape[0], bank.shape[0], s, item, True))
        table = torch.from_numpy(_dist_table(k, 1000, dtype)).cuda()
        for name, (bank, qry) in main_calls(bank_all).items():
            bank, qry = bank.contiguous(), qry.contiguous()

            def kernel():
                return mash_rows_dist_cuda(bank, qry, table, sketch_size=1000)

            got = kernel()[::SAMPLE]
            inter = merged_inter_count_ref(bank, qry[::SAMPLE].contiguous(),
                                           sketch_size=1000)
            want = table[inter.long()]
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            check(torch.equal(got, want), f"mash_rows_dist {dtype} {name}: "
                  f"kernel != plain on every {SAMPLE}th query row (max abs "
                  f"err {err})")
            worst = max(worst, err)
            ms = event_ms(kernel, 3)
            calls[f"{dtype}/{name}"] = with_share(
                {"bank": bank.shape[0], "queries": qry.shape[0], "s": 1000,
                 "rows_checked": want.shape[0], "equal": True, "ms": ms,
                 "pairs_per_s": bank.shape[0] * qry.shape[0] / ms * 1e3},
                mash_bound(inter, qry.shape[0], bank.shape[0], 1000, item,
                           True))
    emit({"phase": "kernel_vs_plain", "kernel": "mash_rows_dist", "k": k,
          "timing": "CUDA events, mean of back-to-back launches after a "
                    "warm-up",
          "cases": out, "max_abs_err": worst, "main_calls": calls})
    return _mash_record(out[f"float32/d_s1000_bank{n}_q64"],
                        {nm: c for nm, c in calls.items()
                         if nm.startswith("float32/")}, worst)


def _side_inputs(cap: int, E: int, dtype: str, seed: int):
    """Witness lists as the scorer sees them: ids of placed leaves, 30% of
    slots empty (-1), every 7th edge with no witness at all."""
    from dipper_tpu_torch.placement.kclosest import K

    rng = np.random.default_rng(seed)
    cid = rng.integers(0, cap, (E, K)).astype(np.int32)
    cid[rng.random((E, K)) < 0.3] = -1
    cid[::7] = -1
    cdis = (rng.random((E, K)) * 0.5).astype(dtype)
    row = rng.random(cap).astype(dtype)
    return _on_card(cid, cdis, row)


def phase_side_vector_vs_plain() -> dict:
    from dipper_tpu_torch.placement.kclosest import _side_vector, side_vector_cuda

    out = {}
    worst = 0.0
    for cap, E in ((16384, 65536), (30000, 120000)):
        for dtype in ("float32", "float64"):
            cid, cdis, row = _side_inputs(cap, E, dtype, seed=cap)
            got = side_vector_cuda(cid, cdis, row)
            want = _side_vector(cid, cdis, row)
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            check(got.dtype == want.dtype and err == 0.0
                  and torch.equal(got, want),
                  f"side_vector {dtype} cap {cap}: kernel != plain "
                  f"(max abs err {err})")
            worst = max(worst, err)
            # bytes: the witness ids and distances and the row once, the
            # [E] output once; operations: a subtract and a max a witness,
            # at half the 67 TFLOP/s float32 figure (which counts an FMA
            # as two)
            nbytes = sum(x.numel() * x.element_size()
                         for x in (cid, cdis, row, got))

            def kernel():
                return side_vector_cuda(cid, cdis, row)

            out[f"{dtype}/cap{cap}_E{E}"] = with_share(
                {"cap": cap, "edges": E, "k": cid.shape[1], "equal": True,
                 "ms": graph_ms(kernel),
                 "wrapper_host_ms": host_ms(kernel),
                 "back_to_back_calls_ms": event_ms(kernel),
                 "plain_ms": event_ms(lambda: _side_vector(cid, cdis, row))},
                bound_of(2 * cid.numel(), nbytes, 33.5e12))
    emit({"phase": "kernel_vs_plain", "kernel": "side_vector",
          "timing": "ms: a captured CUDA graph of 200 launches, replayed 5 "
                    "times between CUDA events; wrapper_host_ms: host "
                    "clock over 200 launches; back_to_back_calls_ms and "
                    "plain_ms: CUDA events around 200 calls from Python",
          "cases": out, "max_abs_err": worst})
    main_case = out["float32/cap30000_E120000"]
    return {"max_abs_err": worst, "library_ms": None,
            **{k: main_case[k] for k in (
                "ms", "wrapper_host_ms", "back_to_back_calls_ms", "plain_ms",
                "bound_ms", "bound_by", "share_of_bound")}}


def _six_err(got, want) -> float:
    """0.0 when score_edges' six values agree bit for bit (NaN with NaN),
    else the larger absolute difference of frac and add, inf when the
    ints differ."""
    if tuple(got[:4]) != tuple(want[:4]):
        return float("inf")
    return max(_max_abs_err(g.reshape(1), w.reshape(1))
               for g, w in zip(got[4:], want[4:]))


def _kernel_six(st, row, keep: bool = True, lo: int = 0,
                hi: int | None = None) -> tuple:
    """score_edges_cuda's launch over the slots [lo, hi) and readback (not
    looked up through the module, where phase 5 records calls); `keep`
    clones frac and add out of the state's output buffer."""
    from dipper_tpu_torch.placement import kclosest

    sc = kclosest.score_edges_launch(st, row, lo=lo, hi=hi)
    ints = sc.out_i.tolist()
    return ((*ints, sc.frac.clone(), sc.add.clone()) if keep
            else (*ints, sc.frac, sc.add))


def _score_both(st, row) -> tuple:
    """(kernel's six values, plain version's) for one state and row."""
    from dipper_tpu_torch.placement import kclosest

    return _kernel_six(st, row), kclosest._score_edges_plain(st, row)


def score_bound(st, row) -> dict:
    """Bound of one score_edges launch: the six arrays over the used slots
    and the row once, the outputs once; operations: per scored edge two
    sides (a subtract and a max a witness) and the clamp sequence (23
    operations), at half the 67 TFLOP/s float32 figure."""
    item = row.element_size()
    k = st.cid.shape[1]
    nbytes = (st.idx * (k * 4 + k * item + 3 * 4 + item)
              + row.numel() * item + 4 * 4 + 2 * item)
    return bound_of(st.idx / 2 * (4 * k + 23), nbytes, 33.5e12)


def time_scorer(st, row) -> dict:
    """The scorer's times on one state and row, with the bound."""
    from dipper_tpu_torch.placement import kclosest

    def launch():
        kclosest.score_edges_launch(st, row)

    # the insertion loop looks its stream up once per insert range
    stream = torch.cuda.current_stream().cuda_stream
    return with_share(
        {"edge_slots": st.e.shape[0], "used_slots": st.idx,
         "cap": row.numel(), "ms": graph_ms(launch),
         "wrapper_host_ms": host_ms(
             lambda: kclosest.score_edges_launch(st, row, stream)),
         "call_with_readback_ms": event_ms(
             lambda: _kernel_six(st, row, keep=False)),
         "plain_ms": event_ms(
             lambda: kclosest._score_edges_plain(st, row), 50)},
        score_bound(st, row))


def built_state(tmp: str, n: int, extra: int, compare: bool = False):
    """The port's placement of the first n taxa of an (n + extra)-taxon
    generated set, on the card, at the arrays' size for the whole set;
    returns (state, the distance rows of the extra taxa). With `compare`
    every insertion is held against the plain version (compare_build)."""
    from dipper_tpu_torch.driver import _load_sequences
    from dipper_tpu_torch.placement import kclosest
    from dipper_tpu_torch.placement.api import _mash_frontend
    from dipper_tpu_torch.utils.params import Param

    total = n + extra
    fa = os.path.join(tmp, f"score{total}.fa")
    if not os.path.exists(fa):
        make_dataset(total, os.path.join(tmp, f"score{total}"), seed=4)
    params = Param()
    _, seqs = _load_sequences(params, fa)
    front, static = _mash_frontend(seqs, params, torch.device("cuda"))
    kw = dict(frontend="mash", frontend_static=static,
              dtype_name=params.dtype)
    st = kclosest.init_placement_state(front, num_sequences=total, **kw)
    rows = kclosest._rows(front, "mash", static, params.dtype, 2, total)
    if compare:
        compare_build(st, rows, 2, n, total, f"the N={n} build")
    else:
        kclosest._insert_range(st, 2, n, rows, total)
    return st, rows[n - 2:]


def phase_score_edges_vs_plain(tmp: str, n: int = 4096) -> dict:
    from dipper_tpu_torch.placement import kclosest, score_model

    cases = {}
    worst = 0.0
    for dtype in ("float32", "float64"):
        for name, d, row, expected in score_model.made_up_cases(dtype):
            st = kclosest.tree_state_from_numpy(d, "cuda")
            got, want = _score_both(st, torch.from_numpy(row).cuda())
            err = _six_err(got, want)
            worst = max(worst, err)
            check(err == 0.0, f"score_edges {dtype} {name}: kernel {got} != "
                  f"plain {want}")
            check(score_model.meets(expected, got), f"score_edges {dtype} "
                  f"{name}: {got} is not the case's {expected}")
            cases[f"{dtype}/{name}"] = {
                "edge_slots": st.e.shape[0], "used_slots": st.idx,
                "eid": got[0], "frac": float(got[4]), "add": float(got[5]),
                "equal": True}
    t0 = time.time()
    st, rows = built_state(tmp, n, SCORE_ROWS[0])
    build_s = time.time() - t0
    for j in range(rows.shape[0]):
        got, want = _score_both(st, rows[j])
        err = _six_err(got, want)
        worst = max(worst, err)
        check(err == 0.0, f"score_edges on the N={n} state, row {j}: kernel "
              f"{got} != plain {want}")
    built = {"n": n, "rows_scored": rows.shape[0], "equal": True,
             "build_s": build_s, **time_scorer(st, rows[0])}
    del st, rows
    # times at the insertion loop's sizes: random pairings through rev (as
    # far apart as a real tree's), every slot of the last insertion used
    timed = {}
    for cap, slots in ((16384, 65536), (30000, 120000)):
        for dtype in ("float32", "float64"):
            rng = np.random.default_rng(cap)
            d = score_model.made_up_state(slots // 2 - 2, slots, cap, dtype,
                                          rng)
            st = kclosest.tree_state_from_numpy(d, "cuda")
            row = torch.from_numpy(rng.random(cap).astype(dtype)).cuda()
            got, want = _score_both(st, row)
            check(_six_err(got, want) == 0.0, f"score_edges {dtype} cap "
                  f"{cap}: kernel {got} != plain {want}")
            timed[f"{dtype}/cap{cap}_E{slots}"] = time_scorer(st, row)
    emit({"phase": "kernel_vs_plain", "kernel": "score_edges",
          "timing": "ms: a captured CUDA graph of 200 launches, replayed 5 "
                    "times between CUDA events; wrapper_host_ms: host "
                    "clock over 200 launches without the readback; "
                    "call_with_readback_ms and plain_ms: CUDA events "
                    "around back-to-back calls from Python",
          "made_up_cases": cases, "built_state": built, "timed": timed,
          "max_abs_err": worst})
    main_case = timed["float32/cap30000_E120000"]
    return {"max_abs_err": worst, "library_ms": None,
            **{k: main_case[k] for k in (
                "ms", "wrapper_host_ms", "call_with_readback_ms", "plain_ms",
                "bound_ms", "bound_by", "share_of_bound")}}


# ---------------------------------------------------------------------------
# The insertion-step kernel (csrc/insert_step.cu)
# ---------------------------------------------------------------------------


def state_clone(st):
    """A TreeState with copies of the seven arrays (no kernel pointers)."""
    import dataclasses

    from dipper_tpu_torch.placement.insert_model import FIELDS

    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in FIELDS})


def state_diff(a, b) -> list:
    """What two states differ in, bit for bit (floats by their bits, so
    NaN payloads count): idx and the names of the arrays."""
    from dipper_tpu_torch.placement.insert_model import FIELDS

    out = [] if a.idx == b.idx else ["idx"]
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape:
            out.append(f)
            continue
        if x.is_floating_point():
            bits = torch.int32 if x.dtype == torch.float32 else torch.int64
            x, y = x.view(bits), y.view(bits)
        if not torch.equal(x, y):
            out.append(f)
    return out


def restore(st, snap) -> None:
    """st's arrays and idx back to a clone's, in place."""
    from dipper_tpu_torch.placement.insert_model import FIELDS

    for f in FIELDS:
        getattr(st, f).copy_(getattr(snap, f))
    st.idx = snap.idx


def plain_step(st, row, i: int, N: int):
    """Insertion i by the plain version: the scorer, splice and compact
    BFS as tensor code (the kernels' yardstick). Returns the scorer's
    six values."""
    from dipper_tpu_torch.placement import kclosest

    six = kclosest._score_edges_plain(st, row)
    eid, x, y, ye, frac, add = six
    kclosest.splice(st, eid, frac, add, i, N, (x, y, ye))
    kclosest._update_closest_bfs_compact(st, i, 2 * N)
    return six


def compare_build(st, rows, lo: int, hi: int, N: int, tag: str) -> int:
    """Insertions lo..hi-1 (rows[j]: insertion lo + j) by the kernels on
    `st` and by the plain version on a copy, the seven arrays compared
    bit for bit after each; returns the insertions compared."""
    from dipper_tpu_torch.placement import kclosest

    stream = torch.cuda.current_stream().cuda_stream
    pl = state_clone(st)
    for i in range(lo, hi):
        kclosest.kernel_insertion_step(st, rows[i - lo], i, N, stream)
        plain_step(pl, rows[i - lo], i, N)
        diff = state_diff(st, pl)
        check(not diff, f"{tag}: insert_step != plain at insertion {i}: "
              f"{diff}")
    return hi - lo


def compare_seeding(st, leaves, tag: str) -> int:
    """closest_bfs from each leaf (--add's seeding) on `st` and the plain
    compact BFS on a copy, compared after each; returns the leaves."""
    from dipper_tpu_torch.placement import insert_cuda, kclosest

    pl = state_clone(st)
    M = st.adj.shape[0]
    for leaf in leaves:
        insert_cuda.closest_bfs(st, leaf)
        kclosest._update_closest_bfs_compact(pl, leaf, M)
        diff = state_diff(st, pl)
        check(not diff, f"{tag}: closest_bfs != plain from leaf {leaf}: "
              f"{diff}")
    return len(leaves)


def backbone_state(nwk: str, n: int, dtype: str):
    """--add's state of a Newick backbone over n taxa (lists empty), on
    the card, as run_add_queries makes it; returns (state, B)."""
    from dipper_tpu_torch.io.newick import parse_newick
    from dipper_tpu_torch.placement import api, kclosest

    tree = parse_newick(nwk, n)
    e0, belong0, length0, rev0 = api.backbone_tree_to_arrays(tree, n)
    B = len(tree.leaf_names_in_idx_order())
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    st = kclosest.prepare_kernels(kclosest.TreeState(
        e=torch.from_numpy(e0).to(dev), belong=torch.from_numpy(belong0).to(dev),
        length=torch.from_numpy(length0).to(dev, dt),
        rev=torch.from_numpy(rev0).to(dev),
        cdis=torch.full((4 * n, kclosest.K), kclosest.SENT_DIS, dtype=dt,
                        device=dev),
        cid=torch.full((4 * n, kclosest.K), -1, dtype=torch.int32,
                       device=dev),
        idx=4 * B - 4,
        adj=kclosest.adjacency_from_edges(
            torch.from_numpy(belong0).to(dev), 2 * n)))
    return st, B


def kernel_window(st, rows, lo: int, hi: int, N: int) -> dict:
    """Insertions lo..hi-1 by the kernel path (one score_edges and one
    insert_step launch each), every launch between CUDA events, queued
    QUEUE_CHUNK insertions at a time behind a device sleep so that the
    card runs them back to back: the device ms of each launch, and the
    host ms per insertion of enqueueing them (the wrappers' cost)."""
    from dipper_tpu_torch.placement import insert_cuda, kclosest

    stream = torch.cuda.current_stream().cuda_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    ev[1].record()
    torch.cuda.synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    score, insert, host_s, starved = [], [], 0.0, 0
    for c0 in range(lo, hi, QUEUE_CHUNK):
        ids = range(c0, min(hi, c0 + QUEUE_CHUNK))
        evs = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
               for _ in ids]
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        t0 = time.perf_counter()
        for e, i in zip(evs, ids):
            e[0].record()
            sc = kclosest.score_edges_launch(st, rows[i - lo], stream)
            e[1].record()
            insert_cuda.insert_step(st, sc.eid, sc.frac, sc.add,
                                    middle=i + N - 1, outside=i, label=i,
                                    stream=stream)
            e[2].record()
        dt = time.perf_counter() - t0
        host_s += dt
        starved += dt * 1e3 > sleep_ms
        torch.cuda.synchronize()
        score += [e[0].elapsed_time(e[1]) for e in evs]
        insert += [e[1].elapsed_time(e[2]) for e in evs]
    return {"score_ms": score, "insert_ms": insert,
            "host_ms_per_insertion": host_s / (hi - lo) * 1e3,
            "sleep_ms": sleep_ms, "chunks_not_queued": starved}


def insert_bound(stats: dict, n_ins: int, item: int) -> dict:
    """Bound of n_ins insert_step launches from the model's counts of what
    they read and write (insert_model.bfs's `stats`), each byte once:
    per insertion the choice, the chosen edge's fields and both halves'
    lists, the two rewired slots, the four new slots and two adjacency
    rows; per frontier entry the entry and its adjacency row; per edge
    whose destination is read 4 bytes; per list read its K distances;
    per insert the ids read, both lists written, the length and the next
    frontier entry. Operations: two a list entry (a compare, a count),
    at half the 67 TFLOP/s float32 figure."""
    K = 5
    splice = ((4 + 2 * item) + (item + 12) + 2 * K * (item + 4)
              + 2 * (8 + item) + 4 * (12 + item) + 4 * K * (item + 4)
              + 2 * 12 + 8)
    nbytes = (n_ins * splice + stats["entries"] * (8 + item + 12)
              + stats["edges"] * 4 + stats["lists"] * K * item
              + stats["inserts"] * (K * 4 + K * (item + 4) + 2 * item + 8))
    return bound_of(2 * K * stats["lists"], nbytes, 33.5e12)


def time_insert_window(st, rows, lo: int, N: int,
                       window: int = INSERT_WINDOW) -> dict:
    """On the state before an insert range, left as it was found: its
    first `window` insertions by the kernels (kernel_window), again by
    the plain version on a copy (splice and compact BFS timed by CUDA
    events) and by insert_model on host copies (what they read and
    write); the three must end in the same state. Returns the kernel's
    and the plain version's mean times, the bound from the model's
    counts, and levels per insertion."""
    from dipper_tpu_torch.placement import insert_model, kclosest

    window = min(window, rows.shape[0])
    snap = state_clone(st)
    times = kernel_window(st, rows, lo, lo + window, N)
    after = state_clone(st)
    pl = state_clone(snap)
    model = {f: getattr(snap, f).cpu().numpy()
             for f in insert_model.FIELDS}
    stats, plain_ms = {}, 0.0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for i in range(lo, lo + window):
        eid, x, y, ye, frac, add = kclosest._score_edges_plain(
            pl, rows[i - lo])
        i0 = pl.idx
        torch.cuda.synchronize()
        ev[0].record()
        kclosest.splice(pl, eid, frac, add, i, N, (x, y, ye))
        kclosest._update_closest_bfs_compact(pl, i, 2 * N)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms += ev[0].elapsed_time(ev[1])
        insert_model.insert_step(model, eid, frac.cpu().numpy(),
                                 add.cpu().numpy(), i0, i + N - 1, i, i,
                                 stats=stats)
    diff = state_diff(after, pl)
    check(not diff, f"insert window at {lo}: kernels != plain in {diff}")
    mdiff = [f for f in insert_model.FIELDS
             if getattr(after, f).cpu().numpy().tobytes()
             != model[f].tobytes()]
    check(not mdiff, f"insert window at {lo}: kernels != model in {mdiff}")
    restore(st, snap)
    ms = sum(times["insert_ms"]) / window
    rec = {"lo": lo, "insertions": window, "ms": ms,
           "score_edges_ms": sum(times["score_ms"]) / window,
           "plain_ms": plain_ms / window,
           "host_ms_per_insertion": times["host_ms_per_insertion"],
           "sleep_ms": times["sleep_ms"],
           "chunks_not_queued": times["chunks_not_queued"],
           "levels_per_insertion": stats["levels"] / window,
           "per_insertion": {k: v / window for k, v in stats.items()},
           "equal_plain_and_model": True}
    bound = insert_bound(stats, window, st.length.element_size())
    bound["bound_ms"] /= window
    return with_share(rec, bound)


def phase_insert_vs_plain(tmp: str, n: int = 4096) -> dict:
    """csrc/insert_step.cu against its plain version on the card, the
    seven state arrays bit for bit after every launch; and the latency
    of one BFS level."""
    import dataclasses

    from dipper_tpu_torch.dc import cluster
    from dipper_tpu_torch.placement import insert_cuda, insert_model as im
    from dipper_tpu_torch.placement import kclosest

    dev = torch.device("cuda")
    cases = {}
    # (a) made-up splices: ties, empty entries and NaN in the ten-way merge
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        for name, (cd_x, id_x, cd_y, id_y, orig, frac) in (
                im.SPLICE_CASES.items()):
            st = kclosest.init_state(4, dt, dev)
            kclosest.build_initial_tree(
                st, torch.tensor(2 * orig, dtype=dt, device=dev), 4)
            st.cdis[0] = torch.tensor(cd_x, dtype=dt)
            st.cid[0] = torch.tensor(id_x, dtype=torch.int32)
            st.cdis[2] = torch.tensor(cd_y, dtype=dt)
            st.cid[2] = torch.tensor(id_y, dtype=torch.int32)
            pl = state_clone(st)
            f = torch.tensor([frac], dtype=dt, device=dev)
            a = torch.tensor([im.SPLICE_ADD], dtype=dt, device=dev)
            xy = insert_cuda.insert_step(
                st, torch.zeros((1,), dtype=torch.int32, device=dev), f, a,
                middle=5, outside=2, label=2).tolist()
            kclosest.splice(pl, 0, f[0], a[0], 2, 4)
            kclosest._update_closest_bfs_compact(pl, 2, 8)
            diff = state_diff(st, pl)
            check(not diff and xy == [0, 2], f"made-up splice {dtype} "
                  f"{name}: insert_step != plain in {diff} (xy {xy})")
            cases[f"splice/{dtype}/{name}"] = {"equal": True}
    # (b) whole builds from made-up matrices, every insertion compared
    for kind, m, dtype in (("random", 300, "float32"),
                           ("random", 300, "float64"),
                           ("caterpillar", 256, "float32"),
                           ("some_nan", 200, "float64"),
                           ("all_nan", 64, "float64")):
        D = torch.from_numpy(im.made_up_matrix(kind, m, seed=m)
                             .astype(dtype)).to(dev)
        st = kclosest.init_placement_state((D,), num_sequences=m,
                                           frontend="matrix",
                                           dtype_name=dtype)
        pl = kclosest.init_state(m, getattr(torch, dtype), dev)
        kclosest.build_initial_tree(pl, D[1, 0], m)
        for leaf in (0, 1):
            kclosest._update_closest_bfs_compact(pl, leaf, 2 * m)
        diff = state_diff(st, pl)
        check(not diff, f"{kind} {m} {dtype}: the two first BFSs differ in "
              f"{diff}")
        cases[f"build/{kind}{m}/{dtype}"] = {
            "insertions": compare_build(st, D[2:], 2, m, m,
                                        f"{kind} {m} {dtype}")}
    # (c) the 4,096-taxon build of phase 7's set (mash rows, f32)
    t0 = time.time()
    st, _ = built_state(tmp, n, SCORE_ROWS[0], compare=True)
    cases[f"build/mash{n}/float32"] = {"insertions": n - 2,
                                      "s": time.time() - t0}
    del st
    # (d) --add's seeding of a placement backbone of 1,024 taxa, and (e) of
    # a balanced 1,024-leaf backbone (levels wider than the block)
    D = torch.from_numpy(im.made_up_matrix("random", 1024, seed=11)).to(dev)
    e, b, length = kclosest.run_placement((D,), num_sequences=1024,
                                          frontend="matrix",
                                          dtype_name="float64")
    place_nwk = kclosest.edges_to_newick(
        e, b, length, [f"L{i}" for i in range(1024)], 1024)
    for tag, nwk, dtype in (
            ("placement1024", place_nwk, "float32"),
            ("balanced1024", im.balanced_newick(1024,
                                                np.random.default_rng(3)),
             "float64")):
        st, B = backbone_state(nwk, 1280, dtype)
        cases[f"seeding/{tag}/{dtype}"] = {
            "leaves": compare_seeding(st, range(B), f"seeding {tag}")}
    # (f) D&C's streamed cluster: label, middle, blocked slot 0, scoreable
    # cleared from the launch's (xe, ye); the plain route on the card
    for dtype in ("float32", "float64"):
        rng = np.random.default_rng(12)
        cmax, W, rb = 300, 310, 64
        Dq = torch.from_numpy(rng.uniform(0.05, 0.6, (cmax, W))
                              .astype(dtype)).to(dev)
        cd = np.sort(rng.uniform(0, 0.3, (2, 5)), axis=-1).astype(dtype)
        cid = np.arange(10, dtype=np.int32).reshape(2, 5)
        cid[1, 3:], cd[1, 3:] = -1, 2.0
        lens = rng.uniform(0.01, 0.2, 2).astype(dtype)
        lens[1] = lens[0]
        init = tuple(torch.from_numpy(x).to(dev) for x in (cd, cid, lens))
        states = {}
        make = cluster.cluster_init_state

        def keep(route):
            def init_state(*a, **kw):
                st_, sc_ = make(*a, **kw)
                states[route] = st_
                return st_, sc_
            return init_state

        uses = kclosest.uses_insert_kernel
        before = insert_cuda.INSERT_STEP_LAUNCHES
        try:
            cluster.cluster_init_state = keep("kernel")
            got = cluster.build_streamed(lambda s0: Dq[s0:s0 + rb], *init,
                                         cmax, cmax, rb)
            launches = insert_cuda.INSERT_STEP_LAUNCHES - before
            cluster.cluster_init_state = keep("plain")
            kclosest.uses_insert_kernel = lambda st_: False
            want = cluster.build_streamed(lambda s0: Dq[s0:s0 + rb], *init,
                                          cmax, cmax, rb)
        finally:
            cluster.cluster_init_state = make
            kclosest.uses_insert_kernel = uses
        diff = state_diff(states["kernel"], states["plain"])
        check(not diff and launches == cmax
              and all(torch.equal(a, b) for a, b in zip(got, want)),
              f"streamed cluster {dtype}: insert_step != plain in {diff} "
              f"({launches} launches for {cmax} members)")
        cases[f"dc_streamed/cmax{cmax}/{dtype}"] = {"members": cmax,
                                                    "launches": launches}
    # (g) one BFS level's latency: a BFS from leaf 0 of a 2,048-taxon
    # caterpillar over empty lists, about 2,049 levels of width <= 2
    D = torch.from_numpy(im.made_up_matrix("caterpillar", 2048)
                         .astype("float32")).to(dev)
    st = kclosest.run_placement_full((D,), num_sequences=2048,
                                     frontend="matrix", dtype_name="float32")
    st.cdis.fill_(kclosest.SENT_DIS)
    st.cid.fill_(-1)
    stats = {}
    im.bfs({f: getattr(st, f).cpu().numpy() for f in im.FIELDS}, 0, 0,
           stats=stats)
    snap = state_clone(st)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    runs = []
    for _ in range(6):
        restore(st, snap)
        torch.cuda.synchronize()
        ev[0].record()
        insert_cuda.closest_bfs(st, 0)
        ev[1].record()
        torch.cuda.synchronize()
        runs.append(ev[0].elapsed_time(ev[1]))
    level_ms = sorted(runs[1:])[len(runs[1:]) // 2] / stats["levels"]
    res = {"cases": cases, "level_latency_ms": level_ms,
           "caterpillar_bfs": {"levels": stats["levels"], "ms": runs}}
    emit({"phase": "kernel_vs_plain", "kernel": "insert_step",
          "comparison": "the seven state arrays bit for bit after every "
                        "launch (floats by their bits)", **res,
          "max_abs_err": 0.0})
    return res


def run_cli(argv) -> tuple[int, str, float]:
    """dipper_tpu_torch.cli.main(argv) with its stderr captured (and
    echoed); returns (rc, stderr text, wall seconds)."""
    from dipper_tpu_torch.cli import main

    class Tee(io.TextIOBase):
        def __init__(self):
            self.buf = io.StringIO()

        def write(self, s):
            sys.__stderr__.write(s)
            return self.buf.write(s)

    tee = Tee()
    t0 = time.time()
    with contextlib.redirect_stderr(tee):
        rc = main(argv)
    return rc, tee.buf.getvalue(), time.time() - t0


def phase_gpu_vs_cpu(tmp: str, n: int = 512) -> None:
    from dipper_tpu_torch.utils.treecmp import rf_distance

    fa, _ = make_dataset(n, os.path.join(tmp, f"n{n}"), seed=2)
    outs = {}
    walls = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"n{n}.{dev}.nwk")
        rc, _, walls[dev] = run_cli(["-i", "r", "-I", fa, "-O", out,
                                     "-m", "1", "--device", dev])
        check(rc == 0, f"CLI --device {dev} returned {rc}")
        outs[dev] = open(out).read()
    rf, nrf = rf_distance(outs["cuda"], outs["cpu"])
    check(rf == 0, f"GPU vs CPU port trees differ: RF {rf} (nRF {nrf})")
    check(outs["cuda"] == outs["cpu"], "GPU vs CPU port: the same tree in "
          "other bytes")
    emit({"phase": "gpu_vs_cpu", "n": n, "rf": rf, "nrf": nrf,
          "newick_identical": True, "wall_s": walls})


def _ms(pattern: str, text: str) -> float | None:
    m = re.search(pattern, text)
    return float(m.group(1)) if m else None


def reset_counts() -> None:
    """Every kernel counter to 0 (just before a main path)."""
    from dipper_tpu_torch.distance import mash_cuda
    from dipper_tpu_torch.placement import insert_cuda, kclosest
    from dipper_tpu_torch.sketch import minhash_cuda

    mash_cuda.LAUNCHES = 0
    mash_cuda.ROWS_DIST_LAUNCHES = 0
    mash_cuda.CLUSTER_LAUNCHES = 0
    kclosest.SIDE_VECTOR_LAUNCHES = 0
    kclosest.SCORE_EDGES_LAUNCHES = 0
    minhash_cuda.LAUNCHES = 0
    insert_cuda.INSERT_STEP_LAUNCHES = 0
    insert_cuda.CLOSEST_BFS_LAUNCHES = 0


def read_counts() -> dict:
    """Every kernel's launches since reset_counts: insert_step's are those
    of its two entry points, "insert_step.closest_bfs" the BFS alone's."""
    from dipper_tpu_torch.distance import mash_cuda
    from dipper_tpu_torch.placement import insert_cuda, kclosest
    from dipper_tpu_torch.sketch import minhash_cuda

    return {"mash_merge_count": mash_cuda.LAUNCHES,
            "mash_rows_dist": mash_cuda.ROWS_DIST_LAUNCHES,
            "side_vector": kclosest.SIDE_VECTOR_LAUNCHES,
            "score_edges": kclosest.SCORE_EDGES_LAUNCHES,
            "mash_cluster_inter": mash_cuda.CLUSTER_LAUNCHES,
            "minhash_sketch": minhash_cuda.LAUNCHES,
            "insert_step": (insert_cuda.INSERT_STEP_LAUNCHES
                            + insert_cuda.CLOSEST_BFS_LAUNCHES),
            "insert_step.closest_bfs": insert_cuda.CLOSEST_BFS_LAUNCHES}


def check_tree(nwk: str, n: int, true_nwk: str, limit: float) -> tuple:
    """A complete Newick over S0..S{n-1}, and its RF/nRF vs the true tree
    below `limit`."""
    from dipper_tpu_torch.utils.treecmp import rf_distance

    check(nwk.count(",") == n - 1, f"Newick has {nwk.count(',')} commas, "
          f"want {n - 1}")
    leaves = set(re.findall(r"[(,]([^(),:;]+):", nwk))
    check(leaves == {f"S{i}" for i in range(n)},
          "Newick leaf names differ from the input")
    rf, nrf = rf_distance(nwk, open(true_nwk).read())
    check(nrf < limit, f"nRF vs the true tree {nrf} >= {limit}")
    return rf, nrf


def phase_main_path(tmp: str, n: int, fa: str, true_nwk: str) -> dict:
    from dipper_tpu_torch.distance import mash_cuda
    from dipper_tpu_torch.placement import insert_cuda, kclosest

    out = os.path.join(tmp, f"n{n}.nwk")

    states = []
    chunked = kclosest.run_placement_chunked

    def keep_state(*a, **kw):
        st = chunked(*a, **kw)
        states.append(st)
        return st

    # every merge-count call of the run: its inputs (views of the resident
    # rank bank), every SAMPLE-th row of its output, and its CUDA-event time
    calls = []
    kernel = mash_cuda.mash_inter_cuda

    def recorded(bank, qry, *, sketch_size):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = kernel(bank, qry, sketch_size=sketch_size)
        ev[1].record()
        calls.append((bank, qry, sketch_size, got[::SAMPLE].clone(), ev))
        return got

    # every SIDE_SAMPLE-th insertion is held against the plain version on
    # its own inputs, as it happens: the scorer's six values, and the seven
    # state arrays after the kernel's insert step against a copy of the
    # state that the plain version stepped (which launches none of the
    # port's kernels); none in the range run under the sync check
    step = kclosest.kernel_insertion_step
    step_errs = []
    n_steps = [0]
    sampling = [True]

    def step_recorded(st, row, i, N, stream):
        if not (sampling[0] and n_steps[0] % SIDE_SAMPLE == 0):
            n_steps[0] += 1
            return step(st, row, i, N, stream)
        n_steps[0] += 1
        pl = state_clone(st)
        sc = kclosest.score_edges_launch(st, row, stream)
        got = (*sc.out_i.tolist(), sc.frac.clone(), sc.add.clone())
        insert_cuda.insert_step(st, sc.eid, sc.frac, sc.add, middle=i + N - 1,
                                outside=i, label=i, stream=stream)
        want = plain_step(pl, row, i, N)
        step_errs.append((i, _six_err(got, want), state_diff(st, pl)))

    # before the last insert range: its first rows (taxa not yet inserted)
    # through kernel and plain version on the state as it stands, and the
    # kernels' times there; these launches are taken out of the count.
    # Then the range itself runs with torch's sync check set to raise
    insert_range = kclosest._insert_range
    last_range = {}
    sync_range = {}

    def range_recorded(st, lo, hi, rows, num_sequences):
        if hi != num_sequences or last_range:
            return insert_range(st, lo, hi, rows, num_sequences)
        t_checks = time.perf_counter()
        count = (kclosest.SCORE_EDGES_LAUNCHES,
                 insert_cuda.INSERT_STEP_LAUNCHES,
                 insert_cuda.CLOSEST_BFS_LAUNCHES)
        errs = [_six_err(*_score_both(st, rows[j]))
                for j in range(min(SCORE_ROWS[1], rows.shape[0]))]
        last_range.update(lo=lo, rows_scored=len(errs),
                          max_abs_err=max(errs),
                          **time_scorer(st, rows[0]))
        # kernel 3 by slot ranges on the real state: rows of taxa
        # not yet inserted, and one with NaN at a witness of each of
        # the first 16 used slots
        nan_row = rows[1].clone()
        wit = st.cid[:16].reshape(-1)
        nan_row[wit[wit >= 0].long()] = float("nan")
        last_range["slot_ranges"] = ranges_check(
            st, [rows[0], rows[2], nan_row], time_ranges=True)
        last_range["insert_window"] = time_insert_window(
            st, rows, lo, num_sequences)
        (kclosest.SCORE_EDGES_LAUNCHES, insert_cuda.INSERT_STEP_LAUNCHES,
         insert_cuda.CLOSEST_BFS_LAUNCHES) = count
        # the CLI's log times the range with these checks inside
        last_range["checks_s"] = time.perf_counter() - t_checks
        sampling[0] = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            insert_range(st, lo, hi, rows, num_sequences)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sampling[0] = True
        launches = {
            "score_edges": kclosest.SCORE_EDGES_LAUNCHES - count[0],
            "insert_step": insert_cuda.INSERT_STEP_LAUNCHES - count[1],
            "closest_bfs": insert_cuda.CLOSEST_BFS_LAUNCHES - count[2]}
        sync_range.update(
            lo=lo, hi=hi, sync_debug_mode="error", launches=launches,
            launches_per_insertion=sum(launches.values()) / (hi - lo),
            ms_per_insertion=wall / (hi - lo) * 1e3)

    kclosest.run_placement_chunked = keep_state
    mash_cuda.mash_inter_cuda = recorded
    kclosest.kernel_insertion_step = step_recorded
    kclosest._insert_range = range_recorded
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        # default flags at the real size; below 30,000 taxa auto mode
        # would take NJ, so a smaller rehearsal asks for placement
        rc, log, wall = run_cli(["-i", "r", "-I", fa, "-O", out]
                                + (["-m", "1"] if n < 30000 else []))
    finally:
        kclosest.run_placement_chunked = chunked
        mash_cuda.mash_inter_cuda = kernel
        kclosest.kernel_insertion_step = step
        kclosest._insert_range = insert_range
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    check(rc == 0, f"main path CLI returned {rc}")
    check(counts["mash_merge_count"] > 0,
          "the placement main path launched no mash_merge_count kernel")
    check(counts["score_edges"] == n - 2,
          f"the placement main path launched score_edges "
          f"{counts['score_edges']} times for {n - 2} insertions")
    check(counts["insert_step"] == n
          and counts["insert_step.closest_bfs"] == 2,
          f"the placement main path launched insert_step "
          f"{counts['insert_step']} times ({counts['insert_step.closest_bfs']}"
          f" of them the BFS alone) for {n - 2} insertions and two seeds")
    check(counts["side_vector"] == 0,
          f"the placement main path launched the standalone side_vector "
          f"kernel {counts['side_vector']} times")
    # placement's ingest is the host sketcher's, as in the JAX package
    check(counts["minhash_sketch"] == 0,
          f"the placement main path launched the sketch kernel "
          f"{counts['minhash_sketch']} times")
    check(n_steps[0] == n - 2, f"{n_steps[0]} kernel insertions recorded")
    check(sync_range and sync_range["launches_per_insertion"] == 2,
          f"the last insert range under the sync check: {sync_range}")
    check(len(states) == 1, "the main path did not run run_placement_chunked")
    st = states[0]
    for f in ("e", "belong", "length", "rev", "cdis", "cid", "adj"):
        check(getattr(st, f).device.type == "cuda", f"tree state {f} on "
              f"{getattr(st, f).device}")
    rf, nrf = check_tree(open(out).read().strip(), n, true_nwk, NRF_LIMIT)
    check(n != 30000 or nrf == PLACEMENT_NRF_30K, f"placement nRF {nrf} != "
          f"{PLACEMENT_NRF_30K}, every earlier smoke's")
    check(len(calls) == counts["mash_merge_count"],
          f"{len(calls)} recorded kernel calls, "
          f"{counts['mash_merge_count']} launches")
    checked = []
    for j, (bank, qry, s, got, ev) in enumerate(calls):
        c, want = check_sampled(f"main-path launch {j}", got, bank, qry, s)
        c["ms"] = ev[0].elapsed_time(ev[1])
        checked.append(with_share(c, mash_bound(
            want, qry.shape[0], bank.shape[0], s, 4, False)))
    for i, err, diff in step_errs:
        check(err == 0.0 and not diff, f"main-path insertion {i}: kernels "
              f"!= plain (scorer's max abs err {err}, arrays {diff})")
    check(last_range and last_range["max_abs_err"] == 0.0
          and last_range["slot_ranges"]["max_abs_err"] == 0.0,
          f"score_edges before the last insert range: kernel != plain "
          f"({last_range})")
    emit({"phase": "main_path", "path": "placement", "n": n, "L": 10000,
          "k": 15, "s": 1000, "precision": "f32", "chunk": 8192,
          "phases_ms": {
              "input": _ms(r"Input in: (\d+) ms", log),
              "sketch": _ms(r"Sketch in: (\d+) ms", log),
              "rank_bank": _ms(r"Rank bank in: (\d+) ms", log),
              "rows": _ms(r"Placement rows: ([\d.]+) ms", log),
              "insertions": _ms(r"insertions: ([\d.]+) ms", log),
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "steady_ms_per_insertion": _ms(
              r"steady ([\d.]+) ms/insertion", log),
          "insertions_ms_without_checks": _ms(
              r"insertions: ([\d.]+) ms", log)
          - last_range["checks_s"] * 1e3,
          "kernel_launches": counts, "kernel_calls": checked,
          "insertions_checked": len(step_errs),
          "score_edges_before_last_range": last_range,
          "last_range_no_sync": sync_range,
          "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true": nrf, "nrf_limit": NRF_LIMIT})
    return {"counts": counts, "merge_count_calls": checked,
            "score_edges_last_range": last_range, "sync_range": sync_range}


def phase_nj_gpu_vs_cpu(tmp: str, n: int = 2048) -> dict:
    """The card's mash matrix as PHYLIP, then NJ from it on both devices."""
    from dipper_tpu_torch.io.phylip import read_phylip_lower_triangular
    from dipper_tpu_torch.nj import neighbor_joining
    from dipper_tpu_torch.utils.treecmp import rf_distance

    fa, _ = make_dataset(n, os.path.join(tmp, f"nj{n}"), seed=3)
    phy = os.path.join(tmp, f"nj{n}.phy")
    rc, _, _ = run_cli(["-i", "r", "-I", fa, "-O", phy, "-o", "d"])
    check(rc == 0, f"-i r -o d returned {rc}")
    # -i r -o d at 512 taxa: the device sketcher, device ranks and kernel
    # 2 on the card, their plain versions on the CPU; equal PHYLIP bytes
    head = head_fasta(fa, 512, os.path.join(tmp, "nj512.fa"))
    res, phys = {"o_d_512": {"wall_s": {}}}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"nj512.{dev}.phy")
        rc, _, wall = run_cli(["-i", "r", "-I", head, "-O", out, "-o", "d",
                               "--device", dev])
        check(rc == 0, f"-i r -o d --device {dev} returned {rc}")
        phys[dev] = open(out, "rb").read()
        res["o_d_512"]["wall_s"][dev] = wall
    check(phys["cuda"] == phys["cpu"], "-i r -o d at 512: the card's PHYLIP "
          "bytes != the CPU's")
    res["o_d_512"]["phylip_identical"] = True
    for prec in ("f32", "f64"):
        outs, nj_ms = {}, {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"nj{n}.{prec}.{dev}.nwk")
            rc, log, _ = run_cli(["-i", "d", "-I", phy, "-O", out, "-m", "2",
                                  "--precision", prec, "--device", dev])
            check(rc == 0, f"NJ -i d --device {dev} returned {rc}")
            outs[dev] = open(out).read()
            nj_ms[dev] = _ms(r"NJ in: (\d+) ms", log)
        rf, nrf = rf_distance(outs["cuda"], outs["cpu"])
        check(rf == 0, f"NJ {prec}: GPU vs CPU trees differ: RF {rf} "
              f"(nRF {nrf})")
        res[prec] = {"rf": rf, "nrf": nrf, "nj_ms": nj_ms,
                     "newick_identical": outs["cuda"] == outs["cpu"]}
    # one NJ on the card under the profiler: launches per merge step and
    # the device's busy share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, D = read_phylip_lower_triangular(phy)
    neighbor_joining(D[:256, :256], dtype_name="float32", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        neighbor_joining(D, dtype_name="float32", device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    res["profiled_f32"] = {
        "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share_of_unprofiled_cuda_run":
            busy_ms / res["f32"]["nj_ms"]["cuda"],
        "kernel_launches_per_step": launches / (n - 2),
        "device_ops_per_step": sum(e.count for e in on_dev) / (n - 2),
        "top_device_ops": sorted(
            ((e.key, e.self_device_time_total / 1e3) for e in on_dev),
            key=lambda kv: -kv[1])[:8]}
    emit({"phase": "nj_gpu_vs_cpu", "n": n, **res})
    return res


def phase_scorer_profiled(calls: int = 50) -> dict:
    """One scorer call under torch.profiler, kernel and plain version, at
    the 30K build's last shape: launches, copies and stream syncs per
    call, device time per call, and the kernel's own duration from the
    profiler's device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.placement import kclosest, score_model

    rng = np.random.default_rng(30000)
    st = kclosest.tree_state_from_numpy(
        score_model.made_up_state(59998, 120000, 30000, "float32", rng),
        "cuda")
    row = torch.from_numpy(rng.random(30000).astype("float32")).cuda()
    res = {}
    for name, fn in (("kernel", lambda: _kernel_six(st, row, keep=False)),
                     ("plain", lambda: kclosest._score_edges_plain(st, row))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        count = {e.key: e.count for e in ka}
        on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
        res[name] = {
            "launches_per_call": count.get("cudaLaunchKernel", 0) / calls,
            "memcpys_per_call": count.get("cudaMemcpyAsync", 0) / calls,
            "stream_syncs_per_call":
                count.get("cudaStreamSynchronize", 0) / calls,
            "device_ms_per_call":
                sum(e.self_device_time_total for e in on_dev) / 1e3 / calls}
        for e in on_dev:
            if "score_edges_kernel" in e.key:
                res[name]["kernel_device_ms"] = (
                    e.self_device_time_total / 1e3 / e.count)
    emit({"phase": "scorer_profiled", "edge_slots": 120000, "cap": 30000,
          "calls": calls, **res})
    return res


def phase_nj_main_path(tmp: str, n: int) -> dict:
    from dipper_tpu_torch.distance import mash, mash_cuda

    t0 = time.time()
    fa, true_nwk = make_dataset(n, os.path.join(tmp, f"n{n}"), seed=1)
    gen_s = time.time() - t0
    out = os.path.join(tmp, f"n{n}.nj.nwk")

    matrices = []
    build_matrix = mash.mash_distance_matrix

    def keep_matrix(*a, **kw):
        D = build_matrix(*a, **kw)
        matrices.append(D)
        return D

    # every distance-kernel call: its inputs, every SAMPLE-th row of its
    # output and its CUDA-event time
    calls = []
    kernel = mash_cuda.mash_rows_dist_cuda

    def recorded(bank, qry, table, *, sketch_size, out=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = kernel(bank, qry, table, sketch_size=sketch_size, out=out)
        ev[1].record()
        calls.append((bank, qry, table, sketch_size, got[::SAMPLE].clone(),
                      ev))
        return got

    mash.mash_distance_matrix = keep_matrix
    mash_cuda.mash_rows_dist_cuda = recorded
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        rc, log, wall = run_cli(["-i", "r", "-I", fa, "-O", out])
    finally:
        mash.mash_distance_matrix = build_matrix
        mash_cuda.mash_rows_dist_cuda = kernel
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    check(rc == 0, f"NJ main path CLI returned {rc}")
    check("Using conventional NJ" in log, "auto mode did not take NJ")
    check(counts["mash_rows_dist"] > 0,
          "the NJ main path launched no mash_rows_dist kernel")
    # the NJ matrix's ingest is the device sketcher's, as in the JAX package
    check(counts["minhash_sketch"] > 0,
          "the NJ main path launched no minhash_sketch kernel")
    check(len(calls) == counts["mash_rows_dist"],
          f"{len(calls)} recorded kernel calls, "
          f"{counts['mash_rows_dist']} launches")
    rf, nrf = check_tree(open(out).read().strip(), n, true_nwk, NJ_NRF_LIMIT)
    check(n != 20000 or nrf == NJ_NRF_20K, f"NJ nRF {nrf} != {NJ_NRF_20K}, "
          "every earlier smoke's")
    from dipper_tpu_torch.distance.mash import (inter_to_dist,
                                                merged_inter_count_ref)

    k, s = 15, 1000
    worst = 0.0
    checked = []
    for j, (bank, qry, table, ss, got, ev) in enumerate(calls):
        t1 = time.perf_counter()
        inter = merged_inter_count_ref(bank, qry[::SAMPLE].contiguous(),
                                       sketch_size=ss)
        want = inter_to_dist(inter, k, ss, "float32")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        err = _max_abs_err(got, want)
        check(torch.equal(got, want), f"NJ main-path launch {j}: kernel != "
              f"plain on every {SAMPLE}th row (max abs err {err})")
        worst = max(worst, err)
        checked.append(with_share(
            {"bank": bank.shape[0], "queries": qry.shape[0],
             "rows_checked": want.shape[0], "max_abs_err": err,
             "ms": ev[0].elapsed_time(ev[1]),
             "plain_ms_checked_rows": plain_ms},
            mash_bound(inter, qry.shape[0], bank.shape[0], ss, 4, True)))
    check(len(matrices) == 1, "the NJ main path built no mash matrix")
    D = matrices[0]
    check(D.shape == (n, n) and D.dtype == torch.float32
          and D.device.type == "cuda", f"matrix {tuple(D.shape)} {D.dtype} "
          f"on {D.device}")
    check(torch.equal(D, D.T), "the mash matrix is not symmetric")
    check(bool((D.diagonal() == 0).all()), "the mash matrix diagonal is not 0")
    # the lower triangle is the kernel's rows (row i = query, j < i = bank)
    q0 = 0
    for bank, qry, table, ss, got, ev in calls:
        for r in range(got.shape[0]):
            i = q0 + r * SAMPLE
            check(torch.equal(D[i, :i], got[r, :i]),
                  f"matrix row {i} differs from the kernel's row")
        q0 += qry.shape[0]
    # the device route's matrix (device sketches, device ranks) is the
    # host route's (native sketches, np.unique ranks), entry for entry
    from dipper_tpu_torch.driver import _load_sequences
    from dipper_tpu_torch.utils.params import Param

    _, seqs = _load_sequences(Param(), fa)
    D_host = mash.mash_distance_matrix(ranks_of(seqs, k, s), k, s, "float32",
                                       torch.device("cuda"))
    check(torch.equal(D, D_host), "the NJ matrix from the device sketcher "
          "!= the host route's")
    del D_host, seqs
    emit({"phase": "main_path", "path": "nj", "n": n, "L": 10000, "k": k,
          "s": s, "precision": "f32", "dataset_gen_s": gen_s,
          "phases_ms": {
              "input": _ms(r"Input in: (\d+) ms", log),
              "sketch": _ms(r"Sketch in: (\d+) ms", log),
              "rank_bank": _ms(r"Rank bank in: (\d+) ms", log),
              "distance_matrix": _ms(r"Distance matrix in: (\d+) ms", log),
              "nj": _ms(r"NJ in: (\d+) ms", log),
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "host_route_ms_before": HOST_ROUTE_NJ_20K_MS,
          "matrix_equal_host_route": True,
          "kernel_launches": counts, "kernel_calls": checked,
          "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true": nrf, "nrf_limit": NJ_NRF_LIMIT})
    return {"counts": counts, "max_abs_err": worst, "fa": fa,
            "true_nwk": true_nwk, "out": out,
            "tree_created_ms": _ms(r"Tree Created in: (\d+) ms", log)}


def restricted_rf(nwk: str, true_nwk: str) -> tuple:
    """RF and nRF of `nwk` against the true tree restricted to nwk's
    leaves (a subset of the true tree's)."""
    from dipper_tpu_torch.utils.treecmp import _splits_from_newick

    got, leaves = _splits_from_newick(nwk)
    true, all_leaves = _splits_from_newick(true_nwk)
    check(leaves <= all_leaves, "the tree has leaves the true tree lacks")
    ref = min(leaves)
    want = set()
    for s in true:
        side = s & leaves
        if ref in side:
            side = leaves - side
        if 1 < len(side) < len(leaves) - 1:
            want.add(frozenset(side))
    rf = len(got ^ want)
    return rf, rf / max(len(got) + len(want), 1)


def load_codes(fa: str, n: int | None = None) -> np.ndarray:
    """uint8 [n, L] 4-bit codes of an aligned FASTA's first n records."""
    from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes
    from dipper_tpu_torch.io.fasta import read_fasta

    _, seqs = read_fasta(fa)
    return batch_codes(seqs[:n], encode_4bit_codes, pad_value=4)[0]


def phase_msa_counts(codes: np.ndarray, close: np.ndarray, q: int = 4096,
                     block: int = 256, sampled: int = 256) -> dict:
    """`codes`: the aligned set; `close`: the codes of a small set of close
    relatives (see the models' comparison below)."""
    from dipper_tpu_torch.distance import msa

    n, L = codes.shape
    q = min(q, n)
    codes_d = torch.from_numpy(codes).cuda()
    phi = msa.one_hot_channels(codes_d[:q])
    P = msa.pair_counts(phi, phi)
    torch.cuda.synchronize()
    check(P.dtype == torch.int32 and tuple(P.shape) == (q, 5, q, 5),
          f"pair counts {P.dtype} {tuple(P.shape)}")
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, q, (sampled, 2))
    pairs[0] = (0, 0)
    pairs[1] = (q - 1, 0)
    got = P[pairs[:, 0], :, pairs[:, 1], :].cpu().numpy()
    chan = msa.build_channels(
        codes[np.unique(pairs)]).astype(np.int64)
    at = {int(v): k for k, v in enumerate(np.unique(pairs))}
    want = np.stack([chan[at[int(i)]] @ chan[at[int(j)]].T
                     for i, j in pairs])
    err = int(np.abs(got.astype(np.int64) - want).max())
    check(np.array_equal(got, want), f"MSA pair counts: card != int64 host "
          f"count on sampled pairs (max abs err {err})")
    del P, phi

    # the six models, card vs the port's CPU result, on two blocks: `close`
    # (a set of close relatives, every model well away from its poles) at
    # the stated tolerance, and the first `block` of this set, whose pairs
    # are mostly saturated (NaN, inf, and finite values next to a pole,
    # where one last place of a log's argument moves the result by
    # 1/argument times as much) at a loose one. Failures are raised after
    # the phase's line is printed.
    models, failed = {}, []
    blocks = {"close": (torch.from_numpy(close), {"float32": 2e-6,
                                                  "float64": 1e-12}, 64),
              "saturated": (torch.from_numpy(codes[:block]),
                            {"float32": 1e-3, "float64": 1e-9}, 0)}
    for name, (cb, rtols, atol_eps) in blocks.items():
        for dtype, rtol in rtols.items():
            atol = atol_eps * torch.finfo(getattr(torch, dtype)).eps
            for dt in range(1, 7):
                kw = dict(distance_type=dt, dtype_name=dtype)
                ng = msa.nongap_counts(cb, dtype)
                cpu = msa.msa_tiled_block(cb, ng, cb, ng, **kw)
                gpu = msa.msa_tiled_block(cb.cuda(), ng.cuda(), cb.cuda(),
                                          ng.cuda(), **kw).cpu()
                same_specials = (
                    torch.equal(gpu.isnan(), cpu.isnan())
                    and torch.equal(gpu.isposinf(), cpu.isposinf())
                    and torch.equal(gpu.isneginf(), cpu.isneginf()))
                ok = ~(cpu.isnan() | cpu.isinf() | gpu.isnan() | gpu.isinf())
                diff = (gpu[ok].double() - cpu[ok].double()).abs()
                rel = diff / cpu[ok].double().abs().clamp(min=1e-300)
                close_enough = torch.allclose(gpu, cpu, rtol=rtol, atol=atol,
                                              equal_nan=True)
                if not (same_specials and close_enough):
                    failed.append(
                        f"MSA model {dt} {dtype} on the {name} block: card "
                        f"vs CPU max abs err {diff.max().item()}, max rel "
                        f"err {rel.max().item()} (rtol {rtol}, atol {atol}),"
                        f" NaN and inf in the same places: {same_specials}")
                models[f"{name}/{dtype}/d{dt}"] = {
                    "max_abs_err": diff.max().item(),
                    "max_rel_err": rel.max().item(), "rtol": rtol,
                    "atol": atol, "same_nan_inf_places": same_specials,
                    "bitwise": bool(torch.equal(gpu.nan_to_num(),
                                                cpu.nan_to_num())),
                    "nan": int(cpu.isnan().sum()),
                    "inf": int(cpu.isinf().sum())}
    cb = blocks["saturated"][0]
    # JC's steps on both devices, f32: which one differs first, if any
    # (all but the log are single IEEE operations)
    steps = {}
    for dev in ("cpu", "cuda"):
        c, ng = cb.to(dev), msa.nongap_counts(cb, "float32").to(dev)
        uncor = msa.msa_tiled_block(c, ng, c, ng, distance_type=1,
                                    dtype_name="float32")
        t = uncor / torch.full((), 0.75, device=dev)
        x = 1.0 - t
        steps[dev] = [v.cpu() for v in (uncor, t, x, torch.log(x))]
    jc_steps = {name: int((a.nan_to_num() != b.nan_to_num()).sum())
                for name, a, b in zip(("uncor", "over_0.75", "one_minus",
                                       "log"), steps["cpu"], steps["cuda"])}

    # one row block of the matrix path: the product alone, then with the
    # formulas (f32, -d 1 and -d 5: the fewest and the most slices read)
    rb = min(msa._fit_rows(None, n), n)
    phi = msa.one_hot_channels(codes_d)
    torch.cuda.synchronize()
    ng = msa.nongap_counts(codes_d, "float32")
    product_ms = event_ms(lambda: msa.pair_counts(phi[:rb], phi), 5)
    block_ms = {
        f"d{dt}": event_ms(lambda: msa._block_distance(
            phi[:rb], phi, ng[:rb], ng, distance_type=dt,
            dtype_name="float32"), 5) for dt in (1, 5)}
    expand_ms = event_ms(lambda: msa.one_hot_channels(codes_d), 3)
    ops = 2.0 * 25 * rb * n * L
    nbytes = (rb + n) * 5 * L + rb * n * 25 * 4
    rec = with_share({"row_block": rb, "bank": n, "L": L, "ms": product_ms,
                      "tops": ops / product_ms / 1e9},
                     bound_of(ops, nbytes, PEAK_INT8_PER_S))
    emit({"phase": "msa_counts", "n": n, "L": L,
          "route": "torch._int_mm (int8 x int8 -> int32)",
          "counts_checked": {"queries": q, "bank": q, "sampled_pairs": sampled,
                             "equal": True, "max_abs_err": err},
          "models_card_vs_cpu": models,
          "jc_steps_entries_differing_card_vs_cpu": jc_steps,
          "row_block_product": rec,
          "row_block_with_formulas_ms": block_ms,
          "formulas_ms": {k: v - product_ms for k, v in block_ms.items()},
          "one_hot_expand_all_ms": expand_ms,
          "row_blocks_of_the_matrix": -(-n // rb)})
    check(not failed, "; ".join(failed))
    return rec


def phase_msa_nj_main_path(tmp: str, n: int, fa: str, true_nwk: str) -> dict:
    from dipper_tpu_torch.distance import msa

    out = os.path.join(tmp, f"msa{n}.nj.nwk")
    matrices = []
    build_matrix = msa.msa_distance_matrix

    def keep_matrix(*a, **kw):
        D = build_matrix(*a, **kw)
        matrices.append(D)
        return D

    msa.msa_distance_matrix = keep_matrix
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        rc, log, wall = run_cli(["-i", "m", "-I", fa, "-O", out])
    finally:
        msa.msa_distance_matrix = build_matrix
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"-i m main path CLI returned {rc}")
    check("Using conventional NJ" in log, "auto mode did not take NJ")
    check(len(matrices) == 1, "the -i m main path built no MSA matrix")
    D = matrices[0]
    check(D.shape == (n, n) and D.dtype == torch.float32
          and D.device.type == "cuda", f"matrix {tuple(D.shape)} {D.dtype} "
          f"on {D.device}")
    check(bool((D.diagonal() == 0).all()), "the MSA matrix diagonal is not 0")
    check(torch.equal(D, D.T), "the MSA matrix is not symmetric")
    check(not bool(D.isnan().any()), "the -d 1 matrix holds NaN")
    rf, nrf = check_tree(open(out).read().strip(), n, true_nwk,
                         MSA_NJ_NRF_LIMIT)
    emit({"phase": "main_path", "path": "msa_nj", "n": n, "L": 10000,
          "distance_type": 1, "precision": "f32",
          "phases_ms": {
              "input": _ms(r"Input in: (\d+) ms", log),
              "encode": _ms(r"Encoded in: (\d+) ms", log),
              "distance_matrix": _ms(r"Distance matrix in: (\d+) ms", log),
              "nj": _ms(r"NJ in: (\d+) ms", log),
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "kernel_launches": counts, "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true": nrf, "nrf_limit": MSA_NJ_NRF_LIMIT})
    return {"counts": counts}


def phase_msa_placement(tmp: str, n: int, fa: str, true_nwk: str) -> dict:
    sub = head_fasta(fa, n, os.path.join(tmp, f"msa_first{n}.fa"))
    out = os.path.join(tmp, f"msa_first{n}.nwk")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rc, log, wall = run_cli(["-i", "m", "-I", sub, "-O", out, "-m", "1"])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"-i m -m 1 CLI returned {rc}")
    check(counts["score_edges"] == n - 2,
          f"-i m -m 1 launched score_edges {counts['score_edges']} times for "
          f"{n - 2} insertions")
    check(counts["insert_step"] == n
          and counts["insert_step.closest_bfs"] == 2,
          f"-i m -m 1 launched insert_step {counts['insert_step']} times "
          f"for {n - 2} insertions and two seeds")
    nwk = open(out).read().strip()
    check(nwk.count(",") == n - 1, f"Newick has {nwk.count(',')} commas, "
          f"want {n - 1}")
    rf, nrf = restricted_rf(nwk, open(true_nwk).read())
    check(nrf < MSA_PLACE_NRF_LIMIT, f"-i m -m 1: nRF vs the true tree {nrf} "
          f">= {MSA_PLACE_NRF_LIMIT}")
    emit({"phase": "main_path", "path": "msa_placement", "n": n, "L": 10000,
          "distance_type": 1, "precision": "f32",
          "phases_ms": {
              "input": _ms(r"Input in: (\d+) ms", log),
              "rows": _ms(r"Placement rows: ([\d.]+) ms", log),
              "insertions": _ms(r"insertions: ([\d.]+) ms", log),
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "steady_ms_per_insertion": _ms(
              r"steady ([\d.]+) ms/insertion", log),
          "kernel_launches": counts, "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true_restricted": nrf,
          "nrf_limit": MSA_PLACE_NRF_LIMIT})
    return {"counts": counts}


def backbone_splits_survive(out_nwk: str, back_nwk: str) -> tuple:
    """(every split of the backbone is a split of the combined tree
    restricted to the backbone's leaves, the combined tree's leaves)."""
    from dipper_tpu_torch.utils.treecmp import _splits_from_newick

    back, back_leaves = _splits_from_newick(back_nwk)
    splits, leaves = _splits_from_newick(out_nwk)
    ref = min(back_leaves)
    restricted = set()
    for s in splits:
        side = s & back_leaves
        if ref in side:
            side = back_leaves - side
        if 1 < len(side) < len(back_leaves) - 1:
            restricted.add(frozenset(side))
    return back <= restricted, leaves


def phase_add(tmp: str, fa: str, backbone: int, queries: int,
              small: tuple = (256, 64)) -> dict:
    def add_run(b: int, q: int, dev: str, tag: str):
        back_fa = head_fasta(fa, b, os.path.join(tmp, f"{tag}.back.fa"))
        all_fa = head_fasta(fa, b + q, os.path.join(tmp, f"{tag}.all.fa"))
        back_nwk = os.path.join(tmp, f"{tag}.back.{dev}.nwk")
        out = os.path.join(tmp, f"{tag}.out.{dev}.nwk")
        rc, blog, _ = run_cli(["-i", "r", "-I", back_fa, "-O", back_nwk,
                               "-m", "1", "--device", dev])
        check(rc == 0, f"backbone build --device {dev} returned {rc}")
        reset_counts()
        rc, log, wall = run_cli(["-i", "r", "-I", all_fa, "-O", out, "--add",
                                 "-t", back_nwk, "--device", dev])
        counts = read_counts()
        check(rc == 0, f"--add --device {dev} returned {rc}")
        return open(back_nwk).read(), open(out).read(), counts, log, wall

    back, out, counts, log, wall = add_run(backbone, queries, "cuda", "add")
    check(counts["score_edges"] == queries,
          f"--add launched score_edges {counts['score_edges']} times for "
          f"{queries} queries")
    check(counts["insert_step.closest_bfs"] == backbone
          and counts["insert_step"] == backbone + queries,
          f"--add launched insert_step {counts['insert_step']} times "
          f"({counts['insert_step.closest_bfs']} the BFS alone) for "
          f"{backbone} backbone leaves and {queries} queries")
    check(counts["mash_merge_count"] > 0,
          "--add launched no mash_merge_count kernel")
    survive, leaves = backbone_splits_survive(out, back)
    check(leaves == {f"S{i}" for i in range(backbone + queries)},
          "--add: the tree's leaves are not the input's")
    check(survive, "--add: a backbone split did not survive")
    b, q = small
    outs = {dev: add_run(b, q, dev, f"add{b}")[:2] for dev in ("cuda", "cpu")}
    check(outs["cuda"] == outs["cpu"], "--add: the card's backbone or "
          f"combined Newick differs from the CPU's at {b} + {q}")
    emit({"phase": "main_path", "path": "add", "backbone": backbone,
          "queries": queries, "precision": "f32",
          "phases_ms": {
              "sketch": _ms(r"Sketch in: (\d+) ms", log),
              "seeding": _ms(r"seeded in: ([\d.]+) ms", log),
              "rows": _ms(r"queries: rows ([\d.]+) ms", log),
              "insertions": _ms(r"insertions ([\d.]+) ms", log),
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "seeding_ms_per_backbone_leaf":
              _ms(r"seeded in: ([\d.]+) ms", log) / backbone,
          "ms_per_query": _ms(r"insertions ([\d.]+) ms", log) / queries,
          "kernel_launches": counts, "backbone_splits_survive": True,
          "gpu_vs_cpu": {"backbone": b, "queries": q,
                         "newick_identical": True}})
    return {"counts": counts}


def cluster_lists(n_rows: int, c: int, cmax: int, rng) -> tuple:
    """Index lists of c clusters as D&C's phase 3 makes them: ragged sizes
    1..cmax (the first 1, the last cmax), members padded by repeating the
    last one, witnesses 10 backbone heads and then the members; int32 on
    the card, the members a view of the witness lists' tail (as
    dc/pipeline.py::_pair_distances passes them)."""
    sz = rng.integers(1, cmax + 1, c)
    sz[0], sz[-1] = 1, cmax
    mem = np.empty((c, cmax), np.int32)
    for i in range(c):
        ids = rng.choice(n_rows, min(int(sz[i]), n_rows), replace=False)
        mem[i] = ids[np.minimum(np.arange(cmax), len(ids) - 1)]
    (wit,) = _on_card(np.concatenate([rng.integers(0, n_rows, (c, 10)), mem],
                                     axis=1).astype(np.int32))
    return wit, wit[:, 10:]


def parent_cluster_kernel(parent: str):
    """Kernel 4 of an earlier checkout at `parent`, called through that
    checkout's own wrapper (its distance/mash_cuda.py::
    mash_cluster_inter_cuda, which builds its csrc/mash_cluster_inter.cu
    into its own build/ and passes its launcher's own arguments), as
    fn(ranks, wit, mem, s) -> out. The checkout's package stands in for
    this one's only while that module is imported."""
    import importlib

    pkg = "dipper_tpu_torch"

    def ours():
        return [k for k in sys.modules if k == pkg or k.startswith(pkg + ".")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    root = os.path.abspath(parent)
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module(f"{pkg}.distance.mash_cuda")
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    check(os.path.abspath(mod.__file__).startswith(root + os.sep),
          f"{pkg} of {parent} was not the one imported")

    def run(ranks, wit, mem, s):
        return mod.mash_cluster_inter_cuda(ranks, wit, mem, sketch_size=s)
    return run


def cluster_bound(got: torch.Tensor, s: int) -> dict:
    """Bound of one per-cluster count launch from this run's counts `got`
    [c, Q, W]: mash_bound's walk steps (s + inter a pair); bytes, the
    first s ranks of every member and witness row of every cluster once,
    the index lists and the [c, Q, W] counts."""
    c, Q, W = got.shape
    steps = got.numel() * s + float(got.sum())
    nbytes = c * (Q + W) * (s + 1) * 4 + got.numel() * 4
    out = bound_of(OPS_PER_WALK_STEP * steps, nbytes)
    out["steps"] = steps
    return out


def phase_cluster_vs_plain(r1000: np.ndarray, parent: str | None) -> dict:
    """Kernel 4 (mash_cluster_inter_cuda) against cluster_inter_ref on the
    card, torch.equal required: real S = 1000 sketches of the placement
    set; D&C's bucket shapes (the 100K run's five, 3,113 clusters of up
    to 8 members, 1,426 of 16, 1,401 of 32, 497 of 64, 39 of 128; 17 of
    128, the 30K run's widest), 13 clusters of
    ragged sizes up to cmax in {8, 16, 32, 64, 128, 1023}, one cluster; a
    witness tail that is not the member list (the generic contract);
    adversarial duplicate- and sentinel-heavy rows; S = 33 and S = 1.
    Every 16th cluster of the wide buckets is compared, and of clusters
    wider than 32 every (cmax // 32)-th member row (the plain version
    holds a [Q, W, 2M] transient a cluster). Times: `ms`, CUDA events
    around 20 back-to-back wrapper calls; `kernel_ms`, a captured CUDA
    graph of 20 launches (the card alone). With `parent` (a checkout of an
    earlier commit), its kernel is timed the same way on the same inputs
    in turns (parent, this, this, parent) and held bitwise to this one;
    it is handed the members as a contiguous copy (the first wrapper took
    no view), so a parent that stages the witness tail once takes its
    generic layout there."""
    from dipper_tpu_torch.distance.mash import cluster_inter_ref
    from dipper_tpu_torch.distance.mash_cuda import mash_cluster_inter_cuda

    rng = np.random.default_rng(15)
    (bank,) = _on_card(r1000)
    n = bank.shape[0]
    cases = {f"s1000_c{c}_cmax{cm}": (bank, *cluster_lists(n, c, cm, rng),
                                      1000)
             for c, cm in ((3113, 8), (1426, 16), (1401, 32), (497, 64),
                           (39, 128), (17, 128), (13, 8), (13, 16), (13, 32),
                           (13, 64), (13, 128), (13, 1023))}
    cases["one_cluster_s1000_cmax200"] = (
        bank, *cluster_lists(n, 1, 200, rng), 1000)
    wit, mem = cluster_lists(n, 400, 8, rng)
    mem = mem.clone()
    (wit[:, 10:],) = _on_card(rng.integers(0, n, (400, 8)).astype(np.int32))
    cases["generic_s1000_c400_cmax8"] = (bank, wit, mem, 1000)
    for name, rows, S, M in (("adversarial_s100", 600, 100, 128),
                             ("adversarial_s33", 300, 33, 64),
                             ("adversarial_s1", 200, 1, 2)):
        (adv,) = _on_card(_adversarial(rows, S, M, rng))
        cases[f"{name}_c13_cmax24"] = (adv, *cluster_lists(rows, 13, 24, rng),
                                       S)
    old = parent_cluster_kernel(parent) if parent else None
    out, worst, first = {}, 0, None
    for name, (r, wit, mem, S) in cases.items():
        c, cm = mem.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = mash_cluster_inter_cuda(r, wit, mem, sketch_size=S)
        torch.cuda.synchronize()
        if first is None:
            # the process's first call: the library's load and the
            # kernel's module load ride on it
            first = {"case": name,
                     "ms": (time.perf_counter() - t0) * 1e3}
        cstep = DC_SAMPLE if c >= 256 else 1
        step = max(1, cm // 32)
        t0 = time.perf_counter()
        want = cluster_inter_ref(r, wit[::cstep].contiguous(),
                                 mem[::cstep, ::step].contiguous(),
                                 sketch_size=S)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        sub = got[::cstep, ::step]
        err = int((sub.long() - want.long()).abs().max())
        check(torch.equal(sub, want), f"mash_cluster_inter {name}: kernel != "
              f"plain (max abs err {err})")
        worst = max(worst, err)

        def new():
            return mash_cluster_inter_cuda(r, wit, mem, sketch_size=S)

        ms = event_ms(new, 20)
        rec = {"clusters": c, "cmax": cm, "W": wit.shape[1], "s": S,
               "clusters_checked": want.shape[0],
               "member_rows_checked": want.shape[1], "equal": True,
               "ms": ms, "plain_ms_checked": plain_ms}
        if old is None:
            rec["kernel_ms"] = graph_ms(new, 20, 3)
        else:
            mem_c = mem.contiguous()

            def prev():
                return old(r, wit, mem_c, S)

            check(torch.equal(prev(), got), f"mash_cluster_inter {name}: "
                  "the parent's kernel disagrees")
            p1, k1, k2, p2 = (graph_ms(f, 20, 3)
                              for f in (prev, new, new, prev))
            rec.update(kernel_ms=(k1 + k2) / 2, parent_kernel_ms=(p1 + p2) / 2,
                       turns_ms=[p1, k1, k2, p2])
        bound = cluster_bound(got, S)
        rec.update(bound)
        rec["share_of_bound"] = bound["bound_ms"] / rec["kernel_ms"]
        if old is not None:
            rec["parent_share_of_bound"] = (bound["bound_ms"]
                                            / rec["parent_kernel_ms"])
        out[name] = rec
    emit({"phase": "kernel_vs_plain", "kernel": "mash_cluster_inter",
          "timing": "ms: CUDA events around 20 back-to-back calls after a "
                    "warm-up; kernel_ms: a CUDA graph of 20 launches, "
                    "replayed 3 times", "first_call": first,
          "parent": parent, "cases": out, "max_abs_err": worst})
    return {"max_abs_err": worst, "cases": out}


def _dc_log(log: str) -> dict:
    return {
        "phases_ms": {
            "input": _ms(r"Input in: (\d+) ms", log),
            "sketch": _ms(r"Sketch in: (\d+) ms", log),
            "rank_bank": _ms(r"Rank bank in: (\d+) ms", log),
            "phase1_backbone": _ms(r"DC phase 1 in: (\d+) ms", log),
            "phase2_assign": _ms(r"DC phase 2 in: (\d+) ms", log),
            "phase3_clusters": _ms(r"DC phase 3 in: (\d+) ms", log),
            "tree_created": _ms(r"Tree Created in: (\d+) ms", log)},
        "clusters": re.search(r"DC phase 3: (\d+ clusters, size .*)",
                              log).group(1),
        "buckets": re.findall(r"DC phase 3: (bucket .*)", log)}


def phase_dc_main_path(tmp: str, n: int, fa: str, true_nwk: str) -> dict:
    """-m 3 through the CLI on the placement set (B = n // 20): every
    per-cluster count launch recorded and its every DC_SAMPLE-th cluster
    held against the plain version afterwards; the widest batched
    bucket's launch timed again beside its bound and the plain version."""
    from dipper_tpu_torch.dc import cluster
    from dipper_tpu_torch.distance import mash_cuda
    from dipper_tpu_torch.distance.mash import cluster_inter_ref

    out = os.path.join(tmp, f"dc{n}.nwk")
    calls = []
    kernel = mash_cuda.mash_cluster_inter_cuda

    def recorded(ranks, wit, mem, *, sketch_size):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = kernel(ranks, wit, mem, sketch_size=sketch_size)
        ev[1].record()
        calls.append((ranks, wit, mem, sketch_size,
                      got[::DC_SAMPLE].clone(), ev))
        return got

    mash_cuda.mash_cluster_inter_cuda = recorded
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cluster.STEPS = cluster.BFS_LEVELS = 0
    try:
        rc, log, wall = run_cli(["-i", "r", "-I", fa, "-O", out, "-m", "3"])
    finally:
        mash_cuda.mash_cluster_inter_cuda = kernel
    counts = read_counts()
    steps, levels = cluster.STEPS, cluster.BFS_LEVELS
    peak = torch.cuda.max_memory_allocated()
    B = n // 20
    check(rc == 0, f"D&C CLI returned {rc}")
    check("Using divide-and-conquer mode" in log, "D&C mode not logged")
    check(counts["mash_cluster_inter"] > 0,
          "the D&C main path launched no mash_cluster_inter kernel")
    check(counts["mash_merge_count"] > 0,
          "the D&C main path launched no mash_merge_count kernel")
    check(counts["score_edges"] == B - 2,
          f"the D&C backbone launched score_edges {counts['score_edges']} "
          f"times for its {B - 2} insertions")
    # one insert_step launch a backbone insertion and a streamed member,
    # the BFS alone for the backbone's two seeds
    streamed = sum(int(m) for m in re.findall(
        r"DC phase 3: bucket \S+ clusters=\d+ path=stream members=(\d+)",
        log))
    check(counts["insert_step"] - counts["insert_step.closest_bfs"]
          == B - 2 + streamed and counts["insert_step.closest_bfs"] == 2,
          f"the D&C main path launched insert_step {counts['insert_step']} "
          f"times ({counts['insert_step.closest_bfs']} the BFS alone) for "
          f"{B - 2} backbone insertions, {streamed} streamed members and "
          "two seeds")
    check(len(calls) == counts["mash_cluster_inter"],
          f"{len(calls)} recorded calls, {counts['mash_cluster_inter']} "
          "launches")
    rf, nrf = check_tree(open(out).read().strip(), n, true_nwk, DC_NRF_LIMIT)
    checked, worst = [], 0
    for j, (ranks, wit, mem, S, got, ev) in enumerate(calls):
        want = cluster_inter_ref(ranks, wit[::DC_SAMPLE].contiguous(),
                                 mem[::DC_SAMPLE].contiguous(),
                                 sketch_size=S)
        err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want), f"D&C launch {j}: mash_cluster_inter "
              f"!= plain on every {DC_SAMPLE}th cluster (max abs err {err})")
        worst = max(worst, err)
        checked.append({"clusters": wit.shape[0], "cmax": mem.shape[1],
                        "clusters_checked": want.shape[0],
                        "ms": ev[0].elapsed_time(ev[1])})
    # the widest batched bucket's launch, timed again whole
    ranks, wit, mem, S, _, _ = max(calls, key=lambda c: c[2].shape[1])
    full = kernel(ranks, wit, mem, sketch_size=S)
    ms = event_ms(lambda: kernel(ranks, wit, mem, sketch_size=S), 20)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    plain = cluster_inter_ref(ranks, wit, mem, sketch_size=S)
    ev[1].record()
    torch.cuda.synchronize()
    check(torch.equal(full, plain), "the widest D&C launch: kernel != plain")
    largest = with_share({"clusters": wit.shape[0], "cmax": mem.shape[1],
                          "W": wit.shape[1], "s": S, "ms": ms,
                          "plain_ms": ev[0].elapsed_time(ev[1])},
                         cluster_bound(full, S))
    res = {"counts": counts, "largest_bucket": largest, "max_abs_err": worst,
           "out": out, **_dc_log(log)}
    emit({"phase": "main_path", "path": "dc", "n": n, "backbone": B,
          "L": 10000, "k": 15, "s": 1000, "precision": "f32",
          **_dc_log(log), "total_wall_ms": wall * 1e3,
          "phase3_steps": steps, "phase3_bfs_levels": levels,
          "host_syncs_per_phase3_step": levels / max(steps, 1),
          "kernel_launches": counts, "mash_cluster_inter_calls": checked,
          "largest_bucket_launch": largest, "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true": nrf, "nrf_limit": DC_NRF_LIMIT})
    return res


def phase_dc_gpu_vs_cpu(tmp: str, n: int = 600) -> None:
    """-m 3 at N = 600 (B = 30) on the card and on the CPU, f64, with
    streamed clusters (16 members and up, rows 5 at a time) and several
    builds a bucket forced: the same Newick bytes."""
    from dipper_tpu_torch.dc import pipeline as dc

    fa, _ = make_dataset(n, os.path.join(tmp, f"dc{n}"), seed=4)
    knobs = {"_STREAM_CLUSTER_MIN": 16, "_STREAM_ROW_BLOCK": 5,
             "PHASE3_BUDGET": 64}
    saved = {k: getattr(dc, k) for k in knobs}
    outs, walls, logs = {}, {}, {}
    try:
        for k, v in knobs.items():
            setattr(dc, k, v)
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"dc{n}.{dev}.nwk")
            rc, logs[dev], walls[dev] = run_cli(
                ["-i", "r", "-I", fa, "-O", out, "-m", "3", "--precision",
                 "f64", "--device", dev])
            check(rc == 0, f"D&C --device {dev} returned {rc}")
            outs[dev] = open(out).read()
    finally:
        for k, v in saved.items():
            setattr(dc, k, v)
    check("path=stream" in logs["cuda"] and "path=batch" in logs["cuda"],
          "D&C at N = 600 did not take both the streamed and batched paths")
    check(outs["cuda"] == outs["cpu"],
          f"D&C at N = {n}: the card's f64 Newick differs from the CPU's")
    emit({"phase": "dc_gpu_vs_cpu", "n": n, "backbone": n // 20,
          "knobs": knobs, "newick_identical": True, "wall_s": walls,
          "buckets": _dc_log(logs["cuda"])["buckets"]})


def phase_dc_step_profiled(cmax: int = 16) -> dict:
    """Launches and host syncs per phase-3 step of one batched build at
    64 and at 1,024 clusters (made-up distances and witness lists) under
    torch.profiler: a step's launches do not grow with the clusters."""
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.dc import cluster

    rng = np.random.default_rng(18)
    res = {}
    for C in (64, 1024):
        W = 10 + cmax
        Dq, cd, lens = _on_card(
            rng.uniform(0.05, 0.6, (C, cmax, W)).astype(np.float32),
            np.sort(rng.uniform(0, 0.3, (C, 2, 5)), axis=-1).astype(
                np.float32),
            np.repeat(rng.uniform(0.01, 0.2, (C, 1)), 2, axis=1).astype(
                np.float32))
        (cid,) = _on_card(np.tile(np.arange(10, dtype=np.int32).reshape(
            2, 5), (C, 1, 1)))
        sizes = np.full(C, cmax)

        def build():
            return cluster.build_clusters(Dq, cd, cid, lens, sizes, cmax)

        build()
        torch.cuda.synchronize()
        steps0, levels0 = cluster.STEPS, cluster.BFS_LEVELS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            build()
            torch.cuda.synchronize()
        steps = cluster.STEPS - steps0
        levels = cluster.BFS_LEVELS - levels0
        count = {e.key: e.count for e in prof.key_averages()}
        res[C] = {"steps": steps, "bfs_levels": levels,
                  "launches_per_step": count.get("cudaLaunchKernel", 0)
                  / steps,
                  "stream_syncs_per_step":
                      count.get("cudaStreamSynchronize", 0) / steps,
                  "memcpys_per_step": count.get("cudaMemcpyAsync", 0) / steps,
                  "bfs_levels_per_step": levels / steps}
    lo, hi = res[64]["launches_per_step"], res[1024]["launches_per_step"]
    check(hi < 2 * lo, f"launches per phase-3 step grew with the clusters: "
          f"{lo} at 64, {hi} at 1,024")
    emit({"phase": "dc_step_profiled", "cmax": cmax,
          "by_clusters": {str(k): v for k, v in res.items()}})
    return res


def phase_exact(tmp: str, fa: str, n: int, window: int = 32) -> dict:
    """Exact placement of the alignment's first n sequences on the card
    and on the CPU, f64, from the sequences and from their matrix."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.distance import msa
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.placement import api, exact
    from dipper_tpu_torch.utils.params import Param

    names, seqs = read_fasta(fa)
    names, seqs = names[:n], seqs[:n]
    D = msa.msa_distance_matrix(load_codes(fa, n), 1, "float64",
                                "cuda").cpu().numpy()

    states = []
    chunked = exact.run_exact_chunked

    def keep_state(*a, **kw):
        st = chunked(*a, **kw)
        states.append(st)
        return st

    # the matrix build on the card ends with `window` insertions in a range
    # of their own, which run under the profiler
    prof_box = []
    run_range = exact.run_exact_range

    def range_profiled(st, lo, hi, rows, num_sequences):
        if st.e.device.type != "cuda" or hi - lo != window or prof_box:
            return run_range(st, lo, hi, rows, num_sequences)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_range(st, lo, hi, rows, num_sequences)
            torch.cuda.synchronize()
        prof_box.append((prof, (time.perf_counter() - t0) * 1e3))

    def build(frontend: str, dev: str, chunk: int) -> tuple:
        logs = []
        p = Param(in_format="m" if frontend == "msa" else "d",
                  dtype="float64", state_chunk=chunk)
        t0 = time.time()
        if frontend == "msa":
            nwk = api.build_placement_tree_from_seqs(
                seqs, names, p, device=torch.device(dev), exact=True,
                log=logs.append)
        else:
            nwk = api.build_placement_tree_from_matrix(
                D, names, p, device=torch.device(dev), exact=True,
                log=logs.append)
        wall = time.time() - t0
        per = [float(m.group(1)) for ln in logs
               for m in [re.search(r"\(([\d.]+) ms/insertion\)", ln)] if m]
        return nwk, wall, per[0]

    exact.run_exact_chunked = keep_state
    exact.run_exact_range = range_profiled
    res, trees = {}, {}
    try:
        for frontend in ("msa", "matrix"):
            # ranges [2, n - window) and [n - window, n)
            chunk = n - 2 - window if frontend == "matrix" else n
            del states[:]
            reset_counts()
            gpu, gpu_s, gpu_ms = build(frontend, "cuda", chunk)
            check(states and states[0].e.device.type == "cuda",
                  "exact placement did not keep its state on the card")
            depth = exact._max_depth(states[0])
            cpu, cpu_s, cpu_ms = build(frontend, "cpu", chunk)
            check(gpu == cpu, f"exact placement ({frontend}, f64): the "
                  "card's Newick differs from the CPU's")
            check(gpu.count(",") == n - 1, "exact placement: incomplete tree")
            trees[frontend] = gpu
            res[frontend] = {
                "newick_identical_gpu_cpu": True, "greatest_depth": depth,
                "ms_per_insertion": {"cuda": gpu_ms, "cpu": cpu_ms},
                "wall_s": {"cuda": gpu_s, "cpu": cpu_s},
                "kernel_launches": read_counts()}
    finally:
        exact.run_exact_chunked = chunked
        exact.run_exact_range = run_range
    # the same distances row by row (the matrix's diagonal is zeroed)
    res["same_newick_from_both_frontends"] = trees["msa"] == trees["matrix"]
    check(len(prof_box) == 1, "the profiled window of exact placement did "
          "not run")
    prof, wall_ms = prof_box[0]
    ka = prof.key_averages()
    count = {e.key: e.count for e in ka}
    on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
    res["profiled_window"] = {
        "insertions": window, "first": n - window,
        "ms_per_insertion_under_profiler": wall_ms / window,
        "launches_per_insertion": count.get("cudaLaunchKernel", 0) / window,
        "memcpys_per_insertion": count.get("cudaMemcpyAsync", 0) / window,
        "stream_syncs_per_insertion":
            count.get("cudaStreamSynchronize", 0) / window,
        "device_busy_ms_per_insertion":
            sum(e.self_device_time_total for e in on_dev) / 1e3 / window,
        "top_device_ops": sorted(
            ((e.key, e.self_device_time_total / 1e3 / window) for e in on_dev),
            key=lambda kv: -kv[1])[:6]}
    emit({"phase": "exact_placement", "n": n, "precision": "f64",
          "distance_type": 1, **res})
    return res


# ---------------------------------------------------------------------------
# Kernel 3 by slot ranges, and ranks sharing the card (phases 19 to 23)
# ---------------------------------------------------------------------------

# a group of ranks still running this long after it started is killed, and
# the smoke fails
RANK_TIMEOUT_S = 600
# taxa of the sharded placement build and mash matrix (phase 22)
SHARDED_N = 4096


def range_bounds(E: int, n_used: int, extra=()) -> list:
    """Splits of [0, E) into slot ranges: 2 and 3 even ones, borders at
    the given slots (and just after them) and, where the state has an
    unused tail, a range that ends at n_used and ranges with no used
    slot."""
    sets = [{0, -(-E // 2), E}, {0, -(-E // 3), 2 * -(-E // 3), E}]
    sets += [{0, s, s + 1, E} for s in extra]
    if n_used < E:
        sets += [{0, n_used, E}, {0, max(1, n_used - 1), n_used + 1, E}]
    return [sorted(b - {E + 1}) for b in sets]


def ranges_check(st, rows, extra=(), time_ranges: bool = False) -> dict:
    """Kernel 3 by slot ranges on one state, for each row: the full launch
    against the plain version; every range launch of every split against
    the plain version on its range; the split's choices, merged in the
    kernel's order (parallel/sharded.py::merge_choices), against the full
    launch. All bit for bit. With `time_ranges`, each range launch of the
    2- and 3-way splits of the first row is timed on the card alone
    (graph_ms) beside the full launch."""
    from dipper_tpu_torch.parallel.sharded import merge_choices
    from dipper_tpu_torch.placement import kclosest

    E = st.e.shape[0]
    worst, splits = 0.0, 0
    for j, row in enumerate(rows):
        full = _kernel_six(st, row)
        worst = max(worst, _six_err(full, kclosest._score_edges_plain(st,
                                                                      row)))
        for bounds in range_bounds(E, st.idx,
                                   [full[0], max(0, full[0] - 1), *extra]):
            outs = []
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                got = _kernel_six(st, row, lo=lo, hi=hi)
                check(lo <= got[0] < hi, f"range [{lo}, {hi}) chose slot "
                      f"{got[0]}")
                worst = max(worst, _six_err(
                    got, kclosest._score_edges_plain(st, row, lo, hi)))
                outs.append(got)
            w = merge_choices(np.array([[float(o[5]), o[0]] for o in outs]))
            err = _six_err(outs[w], full)
            check(err == 0.0, f"row {j}, ranges {bounds}: merged choice "
                  f"{outs[w]} != the full launch's {full}")
            splits += 1
    check(worst == 0.0, f"score_edges by ranges: kernel != plain (max abs "
          f"err {worst})")
    res = {"rows": len(rows), "splits": splits, "edge_slots": E,
           "used_slots": st.idx, "max_abs_err": worst}
    if time_ranges:
        row = rows[0]
        res["full_ms"] = graph_ms(lambda: kclosest.score_edges_launch(st,
                                                                      row))
        res["range_ms"] = {
            f"{lo}:{hi}": graph_ms(lambda lo=lo, hi=hi:
                                   kclosest.score_edges_launch(st, row,
                                                               lo=lo, hi=hi))
            for bounds in range_bounds(E, st.idx)[:2]
            for lo, hi in zip(bounds[:-1], bounds[1:])}
    return res


def phase_score_ranges() -> dict:
    """Kernel 3 by slot ranges on the made-up states (ties split across
    ranges, NaN and inf rows, unused tails), f32 and f64, and timed at the
    insertion loop's size (120,000 slots)."""
    from dipper_tpu_torch.placement import kclosest, score_model

    worst, cases = 0.0, {}
    for dtype in ("float32", "float64"):
        for name, d, row, _ in score_model.made_up_cases(dtype):
            st = kclosest.tree_state_from_numpy(d, "cuda")
            # the tie cases: a border between the two tied edges
            extra = ([int(np.flatnonzero(d["belong"] > d["e"])[60])]
                     if name.startswith("tie") else [])
            res = ranges_check(st, [torch.from_numpy(row).cuda()], extra)
            worst = max(worst, res["max_abs_err"])
            cases[f"{dtype}/{name}"] = res["splits"]
    rng = np.random.default_rng(30000)
    d = score_model.made_up_state(59998, 120000, 30000, "float32", rng)
    st = kclosest.tree_state_from_numpy(d, "cuda")
    timed = ranges_check(
        st, [torch.from_numpy(rng.random(30000).astype("float32")).cuda()],
        time_ranges=True)
    emit({"phase": "score_edges_ranges", "splits_by_case": cases,
          "timing": "graph_ms: a captured CUDA graph of 200 launches, "
                    "replayed 5 times between CUDA events",
          "timed_f32_E120000": timed, "max_abs_err": worst})
    return {"max_abs_err": worst, "timed": timed}


class Samplers:
    """Wraps the port's kernel entry points in this process so that their
    launches during a run are held against the plain versions: every
    SAMPLE-th query row of each mash_merge_count and mash_rows_dist launch,
    every DC_SAMPLE-th cluster of each mash_cluster_inter launch (compared
    after the run, on the launch's own inputs), every SIDE_SAMPLE-th
    score_edges launch on its slot range and every SIDE_SAMPLE-th
    insert_step launch (the seven state arrays against a copy that the
    plain splice and BFS stepped; both compared as they happen). The
    plain versions launch none of the port's kernels."""

    def __init__(self):
        from dipper_tpu_torch.distance import mash_cuda
        from dipper_tpu_torch.placement import insert_cuda, kclosest

        self.mc, self.kc, self.ic = mash_cuda, kclosest, insert_cuda
        from dipper_tpu_torch.sketch import minhash_cuda

        self.sk = minhash_cuda
        self.orig = (mash_cuda.mash_inter_cuda, mash_cuda.mash_rows_dist_cuda,
                     mash_cuda.mash_cluster_inter_cuda,
                     kclosest.score_edges_launch,
                     minhash_cuda.minhash_sketch_cuda,
                     insert_cuda.insert_step)
        inter, rows_dist, cluster, score, sketch, insert = self.orig
        self.calls = {"mash_merge_count": [], "mash_rows_dist": [],
                      "mash_cluster_inter": [], "minhash_sketch": []}
        self.score = {"calls": 0, "checked": 0, "max_abs_err": 0.0}
        self.insert = {"calls": 0, "checked": 0, "max_abs_err": 0.0}

        def inter_rec(bank, qry, *, sketch_size):
            got = inter(bank, qry, sketch_size=sketch_size)
            self.calls["mash_merge_count"].append(
                (bank, qry[::SAMPLE].contiguous(), sketch_size,
                 got[::SAMPLE].clone()))
            return got

        def rows_rec(bank, qry, table, *, sketch_size, out=None):
            got = rows_dist(bank, qry, table, sketch_size=sketch_size,
                            out=out)
            self.calls["mash_rows_dist"].append(
                (bank, qry[::SAMPLE].contiguous(), table, sketch_size,
                 got[::SAMPLE].clone()))
            return got

        def cluster_rec(ranks, wit, mem, *, sketch_size):
            got = cluster(ranks, wit, mem, sketch_size=sketch_size)
            self.calls["mash_cluster_inter"].append(
                (ranks, wit[::DC_SAMPLE].contiguous(),
                 mem[::DC_SAMPLE].contiguous(), sketch_size,
                 got[::DC_SAMPLE].clone()))
            return got

        def score_rec(st, row, stream=None, lo=0, hi=None):
            sc = score(st, row, stream, lo, hi)
            if self.score["calls"] % SIDE_SAMPLE == 0:
                got = (*sc.out_i.tolist(), sc.frac.clone(), sc.add.clone())
                err = _six_err(got, kclosest._score_edges_plain(
                    st, row, lo, st.e.shape[0] if hi is None else hi))
                self.score["checked"] += 1
                self.score["max_abs_err"] = max(self.score["max_abs_err"],
                                                err)
            self.score["calls"] += 1
            return sc

        def insert_rec(st, eid, frac, add, *, middle, outside, label,
                       block_slot=-1, stream=None):
            sample = self.insert["calls"] % SIDE_SAMPLE == 0
            self.insert["calls"] += 1
            pl = state_clone(st) if sample else None
            xy = insert(st, eid, frac, add, middle=middle, outside=outside,
                        label=label, block_slot=block_slot, stream=stream)
            if sample:
                kclosest.splice(pl, int(eid.reshape(())), frac.reshape(()),
                                add.reshape(()), 0, 0, middle=middle,
                                outside=outside)
                blocked = ((pl.belong[block_slot], pl.e[block_slot])
                           if block_slot >= 0 else ())
                kclosest._update_closest_bfs_compact(
                    pl, outside, pl.adj.shape[0], label, blocked)
                self.insert["checked"] += 1
                if state_diff(st, pl):
                    self.insert["max_abs_err"] = float("inf")
            return xy

        def sketch_rec(words, lengths, *, k, sketch_size, **kw):
            got = sketch(words, lengths, k=k, sketch_size=sketch_size, **kw)
            self.calls["minhash_sketch"].append(
                (words[::SAMPLE].contiguous(), lengths[::SAMPLE].contiguous(),
                 k, sketch_size, got[::SAMPLE].clone()))
            return got

        (mash_cuda.mash_inter_cuda, mash_cuda.mash_rows_dist_cuda,
         mash_cuda.mash_cluster_inter_cuda, kclosest.score_edges_launch,
         minhash_cuda.minhash_sketch_cuda, insert_cuda.insert_step) = (
            inter_rec, rows_rec, cluster_rec, score_rec, sketch_rec,
            insert_rec)

    def finish(self) -> dict:
        """Restores the entry points and compares the recorded launches;
        returns per kernel the launches checked and the largest
        difference."""
        from dipper_tpu_torch.distance.mash import (cluster_inter_ref,
                                                    merged_inter_count_ref)
        from dipper_tpu_torch.sketch.minhash import sketch_batch_plain

        (self.mc.mash_inter_cuda, self.mc.mash_rows_dist_cuda,
         self.mc.mash_cluster_inter_cuda, self.kc.score_edges_launch,
         self.sk.minhash_sketch_cuda, self.ic.insert_step) = self.orig
        out = {}
        worst = 0.0
        for bank, qry, s, got in self.calls["mash_merge_count"]:
            want = merged_inter_count_ref(bank, qry, sketch_size=s)
            worst = max(worst, _max_abs_err(got, want))
        out["mash_merge_count"] = {
            "launches_checked": len(self.calls["mash_merge_count"]),
            "max_abs_err": worst}
        worst = 0.0
        for bank, qry, table, s, got in self.calls["mash_rows_dist"]:
            want = table[merged_inter_count_ref(bank, qry, sketch_size=s)
                         .long()]
            worst = max(worst, _max_abs_err(got, want))
        out["mash_rows_dist"] = {
            "launches_checked": len(self.calls["mash_rows_dist"]),
            "max_abs_err": worst}
        worst = 0.0
        for ranks, wit, mem, s, got in self.calls["mash_cluster_inter"]:
            want = cluster_inter_ref(ranks, wit, mem, sketch_size=s)
            worst = max(worst, _max_abs_err(got, want))
        out["mash_cluster_inter"] = {
            "launches_checked": len(self.calls["mash_cluster_inter"]),
            "max_abs_err": worst}
        worst = 0.0
        for words, lengths, k, s, got in self.calls["minhash_sketch"]:
            worst = max(worst, u64_err(got, sketch_batch_plain(
                words, lengths, k=k, sketch_size=s)))
        out["minhash_sketch"] = {
            "launches_checked": len(self.calls["minhash_sketch"]),
            "max_abs_err": worst}
        out["score_edges"] = dict(self.score)
        out["insert_step"] = dict(self.insert)
        return out


def _jax_free() -> bool:
    return not any(m == "jax" or m.startswith("jax.") or m == "dipper_tpu"
                   or m.startswith("dipper_tpu.") for m in sys.modules)


def worker_cli(result: str, argv: list) -> int:
    """One rank of a two-rank CLI run (`--worker-cli RESULT ARGS...`):
    the kernels' counts set to 0, the CLI's main on ARGS with every
    kernel sampled against its plain version, the counts read, and the
    result written to RESULT as JSON."""
    samplers = Samplers()
    reset_counts()
    rc, log, wall = run_cli(argv)
    counts = read_counts()
    samples = samplers.finish()
    with open(result, "w") as f:
        json.dump({"rc": rc, "counts": counts, "wall_s": wall, "log": log,
                   "samples": samples, "jax_free": _jax_free()}, f)
    return rc


def gloo_cuda_probe(mesh) -> dict:
    """Whether this PyTorch's gloo takes CUDA tensors in all_gather and
    broadcast (the port stages them through pinned host memory either
    way, parallel/sharded.py::Mesh.all_gather)."""
    import torch.distributed as dist

    t = torch.full((4,), float(mesh.rank), device=mesh.device)
    ops = {"all_gather": lambda: dist.all_gather(
               [torch.empty_like(t) for _ in range(mesh.size)], t,
               group=mesh.group),
           "broadcast": lambda: dist.broadcast(t.clone(), src=0,
                                               group=mesh.group)}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except (RuntimeError, ValueError) as e:
            out[name] = "refused: " + str(e).splitlines()[0][:200]
    return out


def worker_sharded(result: str, coord: str, rank: int, world: int, fa: str,
                   out_npz: str) -> int:
    """One rank of the sharded library builds (`--worker-sharded`):
    sharded_mash_matrix and sharded_placement_build of FASTA's sequences
    (k 15, s 1,000, f32) over `world` ranks, kernels sampled, counts set
    to 0 before each and read after; rank 0 writes the results to
    OUT_NPZ, every rank their digests to RESULT."""
    import hashlib

    import torch.distributed as dist

    from dipper_tpu_torch.distance.mash import pad_ranks, rank_compress_host
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.parallel.distributed import init_distributed
    from dipper_tpu_torch.parallel.sharded import (make_mesh,
                                                   sharded_mash_matrix,
                                                   sharded_placement_build)
    from dipper_tpu_torch.sketch.bank import get_sketch_bank
    from dipper_tpu_torch.utils.params import Param

    init_distributed(coord, world, rank)
    logs = []
    mesh = make_mesh(world, "cuda", log=logs.append)
    probe = gloo_cuda_probe(mesh)
    _, seqs = read_fasta(fa)
    sk = np.asarray(get_sketch_bank(seqs, Param()))
    ranks = pad_ranks(rank_compress_host(sk))
    samplers = Samplers()
    reset_counts()
    t0 = time.time()
    D = sharded_mash_matrix(ranks, 15, 1000, mesh, "float32")
    torch.cuda.synchronize()
    matrix_s = time.time() - t0
    matrix_counts = read_counts()
    reset_counts()
    t0 = time.time()
    e, b, length = sharded_placement_build(sk, 15, 1000, mesh, "float32")
    placement_s = time.time() - t0
    placement_counts = read_counts()
    samples = samplers.finish()
    D = D.cpu().numpy()
    if rank == 0:
        np.savez(out_npz, D=D, e=e, belong=b, length=length)
    with open(result, "w") as f:
        json.dump({"rank": rank, "backend": mesh.backend, "log": logs,
                   "gloo_cuda_tensors": probe, "matrix_s": matrix_s,
                   "placement_s": placement_s,
                   "matrix_counts": matrix_counts,
                   "placement_counts": placement_counts,
                   "samples": samples, "jax_free": _jax_free(),
                   "digests": {k: hashlib.md5(v.tobytes()).hexdigest()
                               for k, v in (("D", D), ("e", e),
                                            ("belong", b),
                                            ("length", length))}}, f)
    dist.destroy_process_group()
    return 0


def run_ranks(tmp: str, tag: str, args_of_rank, world: int = 2) -> list:
    """Starts `world` processes of this script, rank r with
    args_of_rank(r, coordinator, result_path), and waits for them under
    one deadline (RANK_TIMEOUT_S): a group still running then is killed
    and fails the smoke, as does any rank that exits non-zero. Returns
    each rank's JSON result."""
    from dipper_tpu_torch.parallel.distributed import free_port

    coord = f"127.0.0.1:{free_port()}"
    procs, paths = [], []
    for r in range(world):
        res = os.path.join(tmp, f"{tag}.rank{r}.json")
        logf = open(os.path.join(tmp, f"{tag}.rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             *args_of_rank(r, coord, res)],
            stdout=logf, stderr=subprocess.STDOUT, cwd=REPO))
        logf.close()
        paths.append(res)
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        check(False, f"{tag}: a rank ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"{tag}.rank{r}.log")) as f:
                sys.stderr.write(f.read()[-6000:])
        check(p.returncode == 0, f"{tag}: rank {r} exited {p.returncode}")
    out = []
    for res in paths:
        with open(res) as f:
            out.append(json.load(f))
    for r, got in enumerate(out):
        check(got["jax_free"], f"{tag}: rank {r} imported JAX or the JAX "
              "package")
    return out


def _check_samples(tag: str, r: int, samples: dict, want: tuple) -> None:
    for name in want:
        s = samples[name]
        n = s.get("launches_checked", s.get("checked"))
        check(n > 0, f"{tag}: rank {r} checked no {name} launch")
        check(s["max_abs_err"] == 0.0, f"{tag}: rank {r}: {name} != plain "
              f"on its own launches (max abs err {s['max_abs_err']})")


def _cli_ranks(tmp: str, tag: str, argv: list, out: str) -> list:
    return run_ranks(tmp, tag, lambda r, coord, res: [
        "--worker-cli", res, *argv, "-O", out, "--devices", "2",
        "--coordinator", coord, "--num-processes", "2", "--process-id",
        str(r)])


def _rank_line(got: dict) -> dict:
    """What every rank of a CLI run reports: its backend, time to tree
    and launches."""
    log = got["log"]
    m = re.search(r"Collectives over 2 ranks: (\w+)", log)
    check(m is not None and "Sharding over 2 devices" in log,
          "a rank did not shard over 2 devices")
    return {"backend": m.group(1), "wall_s": got["wall_s"],
            "tree_created_ms": _ms(r"Tree Created in: (\d+) ms", log),
            "kernel_launches": got["counts"], "samples": got["samples"]}


def phase_nj_two_ranks(tmp: str, nj: dict) -> dict:
    """Two CLI processes on the one card, -m 2 --devices 2 on phase 9's
    set: the Newick byte-equal to phase 9's single-process tree."""
    out = os.path.join(tmp, "nj.2ranks.nwk")
    ranks = _cli_ranks(tmp, "nj2", ["-i", "r", "-I", nj["fa"], "-m", "2"],
                       out)
    check(open(out).read() == open(nj["out"]).read(),
          "two-rank NJ tree != the single-process tree")
    lines = []
    for r, got in enumerate(ranks):
        for name in ("mash_rows_dist", "minhash_sketch"):
            check(got["counts"][name] > 0,
                  f"NJ rank {r} launched no {name} kernel")
        _check_samples("nj2", r, got["samples"],
                       ("mash_rows_dist", "minhash_sketch"))
        m = re.search(r"NJ sharded over 2 ranks \((\w+)\): (\d+) merge steps, "
                      r"([\d.]+) ms a step, (\d+) host syncs a step",
                      got["log"])
        check(m is not None, f"NJ rank {r} logged no sharded merge steps")
        lines.append({**_rank_line(got), "merge_steps": int(m.group(2)),
                      "ms_per_merge_step": float(m.group(3)),
                      "host_syncs_per_step": int(m.group(4)),
                      "nj_ms": _ms(r"NJ in: (\d+) ms", got["log"]),
                      "distance_matrix_ms": _ms(
                          r"Distance matrix in: (\d+) ms", got["log"])})
    emit({"phase": "two_ranks", "path": "nj", "n": nj["n"],
          "note": "two processes sharing one card (time-sliced CUDA "
                  "contexts): not a measure of sharding's speed",
          "newick_equal_single": True,
          "single_tree_created_ms": nj.get("tree_created_ms"),
          "ranks": lines})
    return {"counts": [got["counts"] for got in ranks]}


def phase_dc_two_ranks(tmp: str, n: int, fa: str, dc: dict) -> dict:
    """Two CLI processes on the one card, -m 3 --devices 2 on phase 5's
    set: the Newick byte-equal to phase 16's single-process tree."""
    out = os.path.join(tmp, "dc.2ranks.nwk")
    ranks = _cli_ranks(tmp, "dc2", ["-i", "r", "-I", fa, "-m", "3"], out)
    check(open(out).read() == open(dc["out"]).read(),
          "two-rank D&C tree != the single-process tree")
    B = n // 20
    lines = []
    for r, got in enumerate(ranks):
        c = got["counts"]
        for name in ("mash_merge_count", "mash_rows_dist",
                     "mash_cluster_inter"):
            check(c[name] > 0, f"D&C rank {r} launched no {name} kernel")
        check(c["score_edges"] == B - 2, f"D&C rank {r}: score_edges "
              f"{c['score_edges']} launches for {B - 2} backbone insertions")
        _check_samples("dc2", r, got["samples"],
                       ("mash_merge_count", "mash_rows_dist",
                        "mash_cluster_inter", "score_edges", "insert_step"))
        lines.append({**_rank_line(got), **_dc_log(got["log"])})
    emit({"phase": "two_ranks", "path": "dc", "n": n, "backbone": B,
          "note": "two processes sharing one card (time-sliced CUDA "
                  "contexts): not a measure of sharding's speed",
          "newick_equal_single": True,
          "single_phases_ms": dc.get("phases_ms"), "ranks": lines})
    return {"counts": [got["counts"] for got in ranks]}


def phase_sharded_library(tmp: str, fa: str, n: int = SHARDED_N,
                          world: int = 2) -> dict:
    """sharded_mash_matrix and sharded_placement_build over `world` ranks
    (two on the one card in the smoke), on the first n taxa of phase 5's
    set: equal to the single-process matrix and placement arrays."""
    from dipper_tpu_torch.distance.mash import (mash_distance_matrix,
                                                mash_rank_bank)
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.placement import kclosest
    from dipper_tpu_torch.utils.params import Param

    head = head_fasta(fa, n, os.path.join(tmp, f"head{n}.fa"))
    npz = os.path.join(tmp, "sharded.npz")
    ranks = run_ranks(tmp, "sharded", lambda r, coord, res: [
        "--worker-sharded", res, coord, str(r), str(world), head, npz],
        world=world)
    for r, got in enumerate(ranks):
        check(got["digests"] == ranks[0]["digests"],
              f"sharded builds: rank {r}'s results differ from rank 0's")
        check(got["matrix_counts"]["mash_rows_dist"] > 0,
              f"sharded matrix: rank {r} launched no mash_rows_dist kernel")
        for name in ("mash_merge_count", "score_edges"):
            check(got["placement_counts"][name] > 0,
                  f"sharded placement: rank {r} launched no {name} kernel")
        check(got["placement_counts"]["score_edges"] == n - 2,
              f"sharded placement: rank {r} scored "
              f"{got['placement_counts']['score_edges']} times for "
              f"{n - 2} insertions")
        _check_samples("sharded", r, got["samples"],
                       ("mash_merge_count", "mash_rows_dist", "score_edges",
                        "insert_step"))
    _, seqs = read_fasta(head)
    bank = mash_rank_bank(seqs, Param(), torch.device("cuda"))
    t0 = time.time()
    D = mash_distance_matrix(bank, 15, 1000, "float32", torch.device("cuda"))
    torch.cuda.synchronize()
    single_matrix_s = time.time() - t0
    t0 = time.time()
    e, b, length = kclosest.run_placement(
        (bank,), num_sequences=n, frontend="mash", frontend_static=(15, 1000),
        dtype_name="float32")
    e, b, length = (x.cpu().numpy() for x in (e, b, length))
    single_placement_s = time.time() - t0
    with np.load(npz) as z:
        check(np.array_equal(z["D"], D.cpu().numpy()),
              "the sharded mash matrix != the single-process matrix")
        for name, want in (("e", e), ("belong", b), ("length", length)):
            check(np.array_equal(z[name], want), f"sharded placement {name} "
                  "!= the single-process build's")
    emit({"phase": "two_ranks", "path": "sharded_library", "n": n,
          "ranks_n": world, "cards": torch.cuda.device_count(),
          "note": "ranks sharing one card (time-sliced CUDA contexts) "
                  "measure no speed of sharding",
          "matrix_equal_single": True, "placement_equal_single": True,
          "single_matrix_s": single_matrix_s,
          "single_placement_s": single_placement_s,
          "ranks": [{k: got[k] for k in (
              "backend", "gloo_cuda_tensors", "matrix_s", "placement_s",
              "matrix_counts", "placement_counts", "samples")}
              for got in ranks]})
    return {"counts": [{"matrix": got["matrix_counts"],
                        "placement": got["placement_counts"]}
                       for got in ranks],
            "backend": ranks[0]["backend"],
            "gloo_cuda_tensors": ranks[0]["gloo_cuda_tensors"]}


def phase_profile(tmp: str) -> None:
    """--profile on a small build on the card (-i r -m 2 at N = 512), in
    a process of its own as a user runs it (in this process the earlier
    phases' profiler sessions leave a new session's first kernels out of
    its trace): a trace with the NJ matrix's mash tile kernel among its
    CUDA kernel events, and the tree of the same build without it."""
    fa, _ = make_dataset(512, os.path.join(tmp, "prof512"), seed=2)
    outs = {}
    for tag, extra in (("plain", []),
                       ("profiled", ["--profile",
                                     os.path.join(tmp, "trace")])):
        out = os.path.join(tmp, f"prof512.{tag}.nwk")
        res = subprocess.run(
            [sys.executable, "-m", "dipper_tpu_torch.cli", "-i", "r", "-I",
             fa, "-O", out, "-m", "2", *extra], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"--profile phase: CLI ({tag}) returned "
              f"{res.returncode}: {res.stderr[-2000:]}")
        outs[tag] = open(out).read()
    check(outs["plain"] == outs["profiled"], "--profile changed the tree")
    trace = os.path.join(tmp, "trace", "trace.rank0.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # the mash kernels' tile kernel (csrc/mash_walk.cuh): the NJ matrix's
    # one launch
    tile = sum("tile_kernel" in e.get("name", "") for e in kernels)
    check(tile > 0, "the --profile trace has no event of the port's mash "
          "kernel")
    emit({"phase": "profile", "n": 512, "trace_bytes": os.path.getsize(trace),
          "events": len(events), "kernel_events": len(kernels),
          "mash_tile_kernel_events": tile, "tree_unchanged": True})


def pack_rows(seqs, k: int) -> tuple:
    """Host-packed int32 words and int32 lengths of `seqs` as one batch,
    padded as sketch/minhash.py::sketch_sequences pads a batch."""
    from dipper_tpu_torch.io.encode import encode_pack_2bit_matrix

    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = -(-max(int(lens.max()), k) // 16) * 16
    ascii_mat = np.zeros((len(seqs), L), dtype=np.uint8)
    for r, s in enumerate(seqs):
        ascii_mat[r, :len(s)] = np.frombuffer(s, np.uint8)
    return encode_pack_2bit_matrix(ascii_mat), lens


def plain_sketch_on_card(seqs, k: int, s: int) -> tuple:
    """The sketch kernel's plain version (sketch_batch_plain) on the card
    for `seqs` in one batch; returns (bank, host ms)."""
    from dipper_tpu_torch.sketch.minhash import sketch_batch_plain

    words, lens = _on_card(*pack_rows(seqs, k))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sketch_batch_plain(words, lens, k=k, sketch_size=s,
                             tile=PLAIN_SKETCH_TILE,
                             chunk_bytes=PLAIN_SKETCH_CHUNK_BYTES)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def u64_err(got: torch.Tensor, want) -> float:
    """0.0 where two banks of u64 bit patterns (int64 tensors or a uint64
    array) are equal, else the largest |difference| of their u64 values
    (inf where the shapes differ)."""
    g = got.cpu().numpy().view(np.uint64)
    w = (want.cpu().numpy().view(np.uint64)
         if isinstance(want, torch.Tensor) else want)
    if g.shape != w.shape:
        return float("inf")
    if np.array_equal(g, w):
        return 0.0
    return float(np.where(g > w, g - w, w - g).max())


def first_of_run_ranks_host(host_ranks: np.ndarray) -> np.ndarray:
    """The device rank rule computed on the host another way, from
    rank_compress_host's consecutive ranks: a value's rank is the count
    of bank values below it (the sorted position where its run of equal
    values starts), the sum of the counts of the smaller ranks."""
    counts = np.bincount(host_ranks.reshape(-1))
    return (np.cumsum(counts) - counts)[host_ranks].astype(np.int32)


def sketch_adversarial() -> dict:
    """The sketch kernel against its plain version on the card and the
    native sketcher on ragged and adversarial rows: lengths 0, k-1, k,
    k+1, 4,095 to 4,097 bases and windows (the tile edge), 10,000 and
    2,000,000 (489 tiles); N, lowercase and U bytes; a repeat-heavy row;
    in a ragged order; k 4, 11, 15 and s 1, 100, 1000, 1024 and the
    kernel's largest."""
    from dipper_tpu_torch.sketch import minhash, minhash_cuda
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    rng = np.random.default_rng(24)
    long_row = bytes(rng.choice(list(b"ACGTNacgtU"), 2_000_000)
                     .astype(np.uint8))
    cases = {}
    for k in (4, 11, 15):
        seqs = [bytes(rng.choice(list(b"ACGTNacgtU"), L).astype(np.uint8))
                for L in (0, k - 1, k, k + 1, 4095, 4096, 4097, 4094 + k,
                          4095 + k, 4096 + k, 10000)]
        seqs += [b"ACGT" * 2500, long_row]
        seqs = [seqs[i] for i in rng.permutation(len(seqs))]
        for s in (1, 100, 1000, 1024, minhash_cuda.MAX_SKETCH_SIZE):
            got = minhash.sketch_sequences(seqs, k, s, device="cuda",
                                           as_device=True)
            plain, plain_ms = plain_sketch_on_card(seqs, k, s)
            native = sketch_sequences_native(seqs, k, s)
            check(native is not None, "native sketcher unavailable")
            err = max(u64_err(got, plain), u64_err(got, native))
            check(err == 0.0, f"sketch kernel k={k} s={s}: != plain or "
                  f"native on the adversarial rows (max abs err {err})")
            cases[f"k{k}_s{s}"] = {"rows": len(seqs), "equal": True,
                                   "plain_ms": plain_ms}
    return cases


def time_sketch_set(tag: str, seqs, k: int = 15, s: int = 1000,
                    check_rank_rule: bool = False) -> dict:
    """The device ingest of one set, as the NJ path runs it, and its parts
    on their own: sketch_sequences (host wall, synchronized), the host's
    encode/pack, each batch's H2D copy, the kernel's own time by CUDA
    events (both stages; stage (a); stage (b) on (a)'s tile lists; (a)
    without its sort), the device rank_compress; beside them the native
    host sketcher and rank_compress_host, the plain version on the card
    and torch.sort along rows of the set's [rows, windows] hash matrix
    (the yardstick). The bank is held bitwise to the native one, to the
    plain version and to the sorted hash matrix's first s columns; the
    device ranks give kernel 2's distances bit for bit as the host ranks
    do (and, with check_rank_rule, equal the rule computed on the host)."""
    from dipper_tpu_torch.distance.mash import (mash_pairwise, pad_ranks,
                                                rank_compress,
                                                rank_compress_host)
    from dipper_tpu_torch.io import encode
    from dipper_tpu_torch.sketch import minhash, minhash_cuda
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    calls, enc_s = [], []
    kernel = minhash_cuda.minhash_sketch_cuda
    pack = encode.encode_pack_2bit_matrix

    def kernel_rec(words, lengths, **kw):
        calls.append((words, lengths))
        return kernel(words, lengths, **kw)

    def pack_rec(a):
        t0 = time.perf_counter()
        w = pack(a)
        enc_s.append(time.perf_counter() - t0)
        return w

    minhash_cuda.minhash_sketch_cuda = kernel_rec
    encode.encode_pack_2bit_matrix = pack_rec
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank = minhash.sketch_sequences(seqs, k, s, device="cuda",
                                        as_device=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        minhash_cuda.minhash_sketch_cuda = kernel
        encode.encode_pack_2bit_matrix = pack
    t0 = time.perf_counter()
    native = sketch_sequences_native(seqs, k, s)
    native_ms = (time.perf_counter() - t0) * 1e3
    check(native is not None, "native sketcher unavailable")
    worst = u64_err(bank, native)
    check(worst == 0.0, f"{tag}: sketch kernel != native sketcher (max abs "
          f"err {worst})")
    plain, plain_ms = plain_sketch_on_card(seqs, k, s)
    err = u64_err(bank, plain)
    check(err == 0.0, f"{tag}: sketch kernel != plain on the card (max abs "
          f"err {err})")
    # each batch: the kernel's stages, its H2D copy, the sort yardstick
    stage_ms = {"both": 0.0, "a": 0.0, "b": 0.0, "a_hash_only": 0.0}
    h2d_ms = sort_ms = 0.0
    nbytes = windows = 0
    for words, lengths in calls:
        B, W = words.shape
        scr = torch.empty(minhash_cuda.scratch_elems(B, W, k, s),
                          dtype=torch.int64, device="cuda")
        out = torch.empty((B, s), dtype=torch.int64, device="cuda")
        for name, st in (("both", 3), ("a", 1), ("b", 2),
                         ("a_hash_only", 5)):
            stage_ms[name] += event_ms(lambda: kernel(
                words, lengths, k=k, sketch_size=s, stages=st, scratch=scr,
                out=out), 5)
        host = np.concatenate([words.cpu().numpy().reshape(-1),
                               lengths.cpu().numpy(), lengths.cpu().numpy()])
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(host).to("cuda")
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        h2d_ms += best
        lens = lengths.long()
        windows += int((lens - k + 1).clamp(min=0).sum())
        nbytes += words.numel() * 4 + B * 4 + B * s * 8
        # the [rows, windows] hash matrix of the batch (plain hash on the
        # card), sorted along rows by one torch.sort
        P = 16 * W - k + 1
        keys = torch.empty((B, P), dtype=torch.int64, device="cuda")
        step = max(1, 2**28 // (24 * 8 * P))
        for r0 in range(0, B, step):
            keys[r0:r0 + step] = minhash.window_keys(
                minhash.unpack_codes(words[r0:r0 + step]),
                lengths[r0:r0 + step], k, 0, P)
        sort_ms += event_ms(lambda: torch.sort(keys, dim=1), 3)
        if P >= s:
            top = torch.sort(keys, dim=1).values[:, :s] ^ torch.iinfo(
                torch.int64).min
            check(torch.equal(top, kernel(words, lengths, k=k,
                                          sketch_size=s)),
                  f"{tag}: sketch kernel != the sorted hash matrix")
        del keys
    # ranks: the card's against the host's
    ranks = rank_compress(bank)
    rank_ms = event_ms(lambda: rank_compress(bank), 5)
    t0 = time.perf_counter()
    host_ranks = rank_compress_host(native)
    host_rank_ms = (time.perf_counter() - t0) * 1e3
    rule = None
    if check_rank_rule:
        rule = bool(np.array_equal(ranks.cpu().numpy(),
                                   first_of_run_ranks_host(host_ranks)))
        check(rule, f"{tag}: device ranks != the first-of-run rule on the "
              "host")
    dev_pad = pad_ranks(ranks)
    host_pad = torch.from_numpy(pad_ranks(host_ranks)).cuda()
    q = min(4096, dev_pad.shape[0])
    same = all(torch.equal(
        mash_pairwise(dev_pad, dev_pad[:q], k=k, sketch_size=s,
                      dtype_name=dt),
        mash_pairwise(host_pad, host_pad[:q], k=k, sketch_size=s,
                      dtype_name=dt)) for dt in ("float32", "float64"))
    check(same, f"{tag}: kernel-2 distances through device ranks != through "
          "host ranks")
    bound = bound_of(windows * SKETCH_OPS_PER_WINDOW, nbytes)
    select_ms = stage_ms["a"] - stage_ms["a_hash_only"]
    return {"rows": len(seqs), "k": k, "s": s, "batches": len(calls),
            "windows": windows, "equal_native": True, "equal_plain": True,
            "max_abs_err": 0.0,
            "sketch_sequences_wall_ms": wall_ms,
            "encode_pack_ms": sum(enc_s) * 1e3, "h2d_ms": h2d_ms,
            "kernel_ms": stage_ms, "ms": stage_ms["both"],
            "mkmers_per_s": windows / stage_ms["both"] / 1e3,
            **bound, "share_of_bound": bound["bound_ms"] / stage_ms["both"],
            "plain_ms": plain_ms,
            "torch_sort_rows_ms": sort_ms,
            "select_in_a_plus_b_ms": select_ms + stage_ms["b"],
            "rank_compress_ms": rank_ms, "rank_compress_host_ms": host_rank_ms,
            "rank_rule_equal_host": rule,
            "distances_equal_host_ranks": True,
            "native_ms": native_ms,
            "native_threads": min(32, os.cpu_count() or 1)}


def phase_sketch(fa30: str, fa20: str) -> dict:
    """Phase 24: the sketch kernel against its plain version and the
    native sketcher, bitwise, on the placement set (all 30K rows against
    the native bank, the first 512 against the plain version), the NJ
    set (every row against both) and adversarial rows; device rank
    compression; times."""
    from dipper_tpu_torch.driver import _load_sequences
    from dipper_tpu_torch.sketch import minhash
    from dipper_tpu_torch.utils.params import Param

    t0 = time.time()
    parts_s = {}
    _, seqs30 = _load_sequences(Param(), fa30)
    bank = minhash.sketch_sequences(seqs30[:512], 15, 1000, device="cuda",
                                    as_device=True)
    plain, _ = plain_sketch_on_card(seqs30[:512], 15, 1000)
    err = u64_err(bank, plain)
    check(err == 0.0, f"sketch kernel != plain on the placement set's first "
          f"512 rows (max abs err {err})")
    parts_s["load_and_first_512"] = time.time() - t0
    set30 = time_sketch_set("placement set", seqs30, check_rank_rule=True)
    del seqs30
    parts_s["placement_set"] = time.time() - t0 - sum(parts_s.values())
    _, seqs20 = _load_sequences(Param(), fa20)
    set20 = time_sketch_set("NJ set", seqs20)
    del seqs20
    parts_s["nj_set"] = time.time() - t0 - sum(parts_s.values())
    adv = sketch_adversarial()
    parts_s["adversarial"] = time.time() - t0 - sum(parts_s.values())
    res = {"placement_30k": set30, "nj_20k": set20}
    emit({"phase": "sketch_vs_plain", "kernel": "minhash_sketch",
          "timing": "kernel: CUDA events, mean of 5 back-to-back calls a "
                    "batch after a warm-up, summed over the batches; host "
                    "parts: host clock",
          "bound": {"int32_ops_per_window": SKETCH_OPS_PER_WINDOW,
                    "int32_ops_per_s": PEAK_INT32_PER_S,
                    "bytes_per_s": PEAK_BYTES_PER_S},
          "host_cpu": host_cpu(), **res, "adversarial": adv,
          "parts_s": parts_s, "phase_s": time.time() - t0})
    nj = set20
    return {"ms": nj["ms"], "plain_ms": nj["plain_ms"],
            "bound_ms": nj["bound_ms"], "bound_by": nj["bound_by"],
            "share_of_bound": nj["share_of_bound"],
            "library_ms": nj["torch_sort_rows_ms"], "max_abs_err": 0.0,
            "shape": [nj["rows"], 10000], "mkmers_per_s": nj["mkmers_per_s"],
            "placement_30k": {key: set30[key] for key in (
                "ms", "bound_ms", "share_of_bound", "mkmers_per_s",
                "torch_sort_rows_ms", "rank_compress_ms")}}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] in ("--worker-cli",
                                             "--worker-sharded"):
        # a rank started by run_ranks (phases 20 to 22)
        sys.path.insert(0, REPO)
        if sys.argv[1] == "--worker-cli":
            return worker_cli(sys.argv[2], sys.argv[3:])
        res, coord, rank, world, fa, npz = sys.argv[2:8]
        return worker_sharded(res, coord, int(rank), int(world), fa, npz)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30000,
                    help="taxa of the placement main path (phase 5) and of "
                         "the kernel phases' inputs")
    ap.add_argument("--nj-n", type=int, default=20000,
                    help="taxa of the NJ main path (phase 9)")
    ap.add_argument("--msa-n", type=int, default=20000,
                    help="taxa of the aligned set (phases 10 and 11); "
                         "phase 12 places its first min(8192, msa-n), phase "
                         "13 its first min(512, msa-n)")
    ap.add_argument("--phases", default=",".join(map(str, sorted(ALL_PHASES))),
                    help="comma-separated subset of phases to run")
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit (e.g. from git "
                         "archive): phase 15 builds its per-cluster count "
                         "kernel and times it beside this one's")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dipper_tpu_torch  # noqa: F401  (fails outside a checkout)

    info = phase_device()
    if 2 in phases:
        phase_build()
    records = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep}
               for name, (src, rep) in KERNELS.items()}

    def note(path: str, counts) -> None:
        """A main path's launch counts (a dict, or one dict a rank) into
        every kernel's record."""
        if isinstance(counts, list):
            counts = {name: [c[name] for c in counts] for name in counts[0]}
        for name, c in counts.items():
            if name in records:
                records[name].setdefault("launches_by_path", {})[path] = c

    with tempfile.TemporaryDirectory() as tmp:
        if phases & {3, 5, 6, 14, 15, 16, 21, 22, 24}:
            t0 = time.time()
            data = make_dataset(args.n, os.path.join(tmp, f"n{args.n}"),
                                seed=1)
            emit({"phase": "dataset", "n": args.n, "L": 10000, "seed": 1,
                  "gen_s": time.time() - t0})
        if phases & {3, 6, 15}:
            inputs = kernel_cases(data[0])
        if 3 in phases:
            records["mash_merge_count"].update(phase_kernel_vs_plain(inputs))
        if 6 in phases:
            records["mash_rows_dist"].update(phase_rows_dist_vs_plain(inputs))
        if 15 in phases:
            res = phase_cluster_vs_plain(inputs[1], args.parent)
            narrow = res["cases"]["s1000_c3113_cmax8"]
            records["mash_cluster_inter"].update(
                max_abs_err=res["max_abs_err"],
                narrow_bucket={k: narrow[k] for k in (
                    "clusters", "cmax", "W", "kernel_ms", "bound_ms",
                    "share_of_bound")})
        if phases & {3, 6, 15}:
            del inputs
        if 7 in phases:
            records["side_vector"].update(phase_side_vector_vs_plain())
            records["score_edges"].update(phase_score_edges_vs_plain(tmp))
        if 25 in phases:
            res = phase_insert_vs_plain(tmp)
            records["insert_step"].update(
                max_abs_err=0.0, library_ms=None,
                level_latency_ms=res["level_latency_ms"])
        if 19 in phases:
            se = records["score_edges"]
            res = phase_score_ranges()
            se["slot_ranges"] = res["timed"]
            se["max_abs_err"] = max(se.get("max_abs_err", 0.0),
                                    res["max_abs_err"])
        if 4 in phases:
            phase_gpu_vs_cpu(tmp)
        if 17 in phases:
            phase_dc_gpu_vs_cpu(tmp)
        if 5 in phases:
            res = phase_main_path(tmp, args.n, *data)
            note("placement", res["counts"])
            mc, sv = records["mash_merge_count"], records["side_vector"]
            se = records["score_edges"]
            mc["launches"] = res["counts"]["mash_merge_count"]
            mc["main_path_calls"] = res["merge_count_calls"]
            mc["max_abs_err"] = max(
                [mc.get("max_abs_err", 0)]
                + [c["max_abs_err"] for c in res["merge_count_calls"]])
            # the scorer's kernel carries the side vector on this path;
            # the standalone entry point is held to its plain version in
            # phase 7 only
            sv["launches"] = res["counts"]["side_vector"]
            se["launches"] = res["counts"]["score_edges"]
            se["main_path_state"] = {
                k: v for k, v in res["score_edges_last_range"].items()
                if k != "insert_window"}
            # insert_step's times: the window of the 30K state before its
            # last range; the latency chain from phase 25's level latency
            ins = records["insert_step"]
            win = res["score_edges_last_range"]["insert_window"]
            ins.update(launches=res["counts"]["insert_step"],
                       max_abs_err=ins.get("max_abs_err", 0.0),
                       library_ms=None, main_path_window=win,
                       last_range_no_sync=res["sync_range"],
                       **{k: win[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "share_of_bound")})
            if "level_latency_ms" in ins:
                chain = win["levels_per_insertion"] * ins["level_latency_ms"]
                ins.update(latency_chain_ms=chain,
                           share_of_latency_chain=chain / win["ms"])
        if 16 in phases:
            res = dc_single = phase_dc_main_path(tmp, args.n, *data)
            note("dc", res["counts"])
            ci = records["mash_cluster_inter"]
            big = res["largest_bucket"]
            ci.update(launches=res["counts"]["mash_cluster_inter"],
                      max_abs_err=max(ci.get("max_abs_err", 0),
                                      res["max_abs_err"]),
                      library_ms=None, shape=[big["clusters"], big["cmax"],
                                              big["W"]],
                      **{k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "share_of_bound")})
        if 9 in phases:
            res = nj_single = phase_nj_main_path(tmp, args.nj_n)
            note("nj", res["counts"])
            rd = records["mash_rows_dist"]
            rd["launches"] = res["counts"]["mash_rows_dist"]
            rd["max_abs_err"] = max(rd.get("max_abs_err", 0.0),
                                    res["max_abs_err"])
            records["minhash_sketch"]["launches"] = res["counts"][
                "minhash_sketch"]
        if 24 in phases:
            nj_fa = (nj_single["fa"] if 9 in phases else make_dataset(
                args.nj_n, os.path.join(tmp, f"n{args.nj_n}"), seed=1)[0])
            records["minhash_sketch"].update(phase_sketch(data[0], nj_fa))
        if phases & {10, 11, 12, 13}:
            t0 = time.time()
            msa_fa, msa_true = make_dataset(
                args.msa_n, os.path.join(tmp, f"msa{args.msa_n}"), seed=1,
                aligned=True)
            emit({"phase": "dataset", "aligned": True, "n": args.msa_n,
                  "L": 10000, "seed": 1, "gen_s": time.time() - t0})
        if 10 in phases:
            close_fa, _ = make_dataset(256, os.path.join(tmp, "close256"),
                                       seed=6, aligned=True, blen_scale=0.1)
            phase_msa_counts(load_codes(msa_fa), load_codes(close_fa))
        if 11 in phases:
            note("msa_nj", phase_msa_nj_main_path(
                tmp, args.msa_n, msa_fa, msa_true)["counts"])
        if 12 in phases:
            note("msa_placement", phase_msa_placement(
                tmp, min(8192, args.msa_n), msa_fa, msa_true)["counts"])
        if 14 in phases:
            note("add", phase_add(tmp, data[0], min(4096, args.n // 2),
                                  min(1024, args.n // 8))["counts"])
        if 13 in phases:
            phase_exact(tmp, msa_fa, min(512, args.msa_n))
        if 8 in phases:
            phase_nj_gpu_vs_cpu(tmp)
            prof = phase_scorer_profiled()
            records["score_edges"].update(
                plain_launches=prof["plain"]["launches_per_call"],
                profiler_kernel_ms=prof["kernel"].get("kernel_device_ms"))
        if 18 in phases:
            phase_dc_step_profiled()
        # the multi-rank paths: each rank sets its counts to 0 just before
        # its run and reads them just after
        if 20 in phases:
            check(9 in phases, "phase 20 compares with phase 9's tree")
            note("nj_2ranks", phase_nj_two_ranks(
                tmp, {**nj_single, "n": args.nj_n})["counts"])
        if 21 in phases:
            check(16 in phases, "phase 21 compares with phase 16's tree")
            note("dc_2ranks", phase_dc_two_ranks(tmp, args.n, data[0],
                                                 dc_single)["counts"])
        if 22 in phases:
            res = phase_sharded_library(tmp, data[0], min(SHARDED_N, args.n))
            note("sharded_matrix_2ranks",
                 [c["matrix"] for c in res["counts"]])
            note("sharded_placement_2ranks",
                 [c["placement"] for c in res["counts"]])
            # kernel 3's range launches: each rank scores its slot range
            records["score_edges"]["range_launches"] = [
                c["placement"]["score_edges"] for c in res["counts"]]
            info["multi_rank_backend"] = res["backend"]
            info["gloo_cuda_tensors"] = res["gloo_cuda_tensors"]
        if 23 in phases:
            phase_profile(tmp)
    check(not any(m == "jax" or m.startswith("jax.") or m == "dipper_tpu"
                  or m.startswith("dipper_tpu.") for m in sys.modules),
          "JAX or the JAX package was imported")
    kernels = list(records.values())
    if phases != set(ALL_PHASES):
        emit({"partial_run": sorted(phases), "kernels": kernels})
        return 0
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["torch_name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
