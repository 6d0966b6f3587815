#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (dipper_tpu_torch).

Runs on one NVIDIA GPU, from the root of a checkout:

    python3 chip_smoke.py                  # all phases
    python3 chip_smoke.py --phases 1,2,3,6,7 --n 4400   # kernel checks only

Phases, each printing one line of its own (run in the order 1, 2, 3, 6,
15, 7, 25, 19, 4, 17, 5, 16, 29, 26, 9, 24, 10, 11, 12, 28, 14, 30, 27, 13,
8, 18, 20, 21, 22, 23:
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
     made-up splices (ties, empty entries and NaN in the ten-way merge, a
     choice whose writes overlap; f32 and f64), whole builds from made-up
     matrices (random, a caterpillar, NaN pairs, all-NaN f64), phase 7's
     4,096-taxon build, each build also by the cursor route (replayed
     graphs and a remainder) and by insert_model, to the same state;
     --add's seeding of a placement backbone and of a balanced
     1,024-leaf backbone (levels of 512 nodes: the frontier spills past
     the kernel's shared buffers), insertions onto that backbone with its
     lists empty (spills, and switches between a warp's narrow levels and
     the block's wide ones, counted by insert_model), D&C's streamed
     cluster (label, blocked slot, scoreable cleared after the splice; the
     walk is insert_step.cuh's, run by kernel 8a, dc_stream_block, one
     launch a row block) against its plain route on the card; one narrow
     BFS level's
     latency (a BFS of ~2,049 levels on a caterpillar, CUDA events) and
     one dependent L2 round trip (a pointer chase through 4 MB), the unit
     of the kernel's latency floor;
  4. GPU port vs CPU port, placement: the CLI at N=512 (-i r -m 1) with
     --device cuda and --device cpu, the same Newick bytes required; and
     run_placement_chunked on a 4,096-taxon set's mash rows (computed on
     the card) in insert ranges of 1,000 on both devices: the card's
     cursor route replays graphs with remainders and captures again at
     each of two prefix caps; the same Newick bytes required;
  17. GPU port vs CPU port, D&C: the CLI with -m 3 at N = 600 (B = 30,
     seed 4) in f64 with streamed clusters (16 members and up, rows 5 at a
     time) and several builds a bucket forced: the same Newick bytes;
  8. GPU port vs CPU port, NJ: the mash matrix of N=2,048 taxa written by
     the card (-i r -o d), and -i r -o d of its first 512 on both devices
     (device sketcher, device ranks and kernel 2 on the card, their plain
     versions on the CPU: the same PHYLIP bytes), then -i d -m 2 on both
     devices in f32 and f64, nRF = 0 required; NJ of the matrix on the
     card by the kernel route (csrc/nj_q_argmin.cu, csrc/nj_update.cu)
     and by the plain route (merge_step_plain every step): equal join
     ids, f32 branch lengths byte for byte, f64 within 1e-12 relative;
     then one NJ on the card under torch.profiler (launches per merge
     step, device busy time), and its first merge steps (kernel A in the
     half read: the PHYLIP matrix is symmetric) under sync_debug_mode
     "error" and under the profiler in windows of 100 and 200 steps (per
     step, from their difference: at most 3 kernel launches,
     cudaLaunchKernel and cudaLaunchKernelExC, 2 of them NJ's, no sync,
     no copy); and the
     launches, copies and syncs of one scorer call, kernel and plain;
  5. the placement main path: scripts/make_dataset.py's generator (seed
     1, L=10,000) and the CLI with default flags, which take k-closest
     placement at N >= 30,000; requires rc 0, a complete Newick, launches
     of the merge-count kernel, one score_edges and one insert_step launch
     per insertion, the BFS alone twice and no standalone side-vector
     launch, the tree state on the card and nRF
     vs the true tree < 0.35. Every merge-count launch of the run is then
     held against the plain version on its own inputs, every 128th query
     row of it; the ingest's device route ("Rank bank route: device" in
     the log, sketch-kernel launches, each held against the plain version
     on its every 128th row), and at N = 30,000 the nRF of every earlier
     smoke (PLACEMENT_NRF_30K). The insert ranges run by the cursor
     route (replays of a captured graph of 64 insertions, the remainder
     by direct cursor launches): the graph captures of the build (the
     log's count), its replays, and the host's replays and direct
     launches an insertion; at each graph border before every 997th
     insertion the state is copied, the graph replayed, and the copy
     stepped through the same insertions by the plain version (the seven
     state arrays, and the scorer's six values of the last). Before the
     last insert range its first 300 rows (taxa not yet inserted) are
     scored by kernel and plain version on the state as it stands, where
     the scorer is also timed, three rows (one with NaN at the witnesses
     of the first used slots) are scored by slot ranges as in phase 19,
     each range launch timed, and its first 300 insertions are run by
     direct kernel launches (each timed by CUDA events, queued behind a
     device sleep), by the plain version, by insert_model and by the
     cursor route, to the same state (with --parent, an earlier
     checkout's insert_step too, timed in turns: parent, this, this,
     parent), which is then put back (those launches are taken out of
     the count); the last range itself then runs under
     torch.cuda.set_sync_debug_mode("error") at 2 launches per insertion
     and no capture. After the profiler phases, the cursor route over
     2 x 64 + 7 of that range's insertions (a copy of the state) under
     torch.profiler: 2.0 kernel launches an insertion on the card, one
     cursor write;
  16. the D&C main path: the CLI with -m 3 on phase 5's set (B = N // 20
     = 1,500): rc 0, a complete Newick with nRF vs the true tree under
     DC_NRF_LIMIT, launches of the per-cluster count kernel and of the
     merge-count kernel, one score_edges launch per backbone insertion (B
     - 2), one insert_step launch per backbone insertion; the ingest's
     device route as in phase 5 (sketch-kernel
     launches sampled against the plain version); every per-cluster count
     launch held against the plain version
     on its every 16th cluster, the widest batched bucket's launch timed
     whole beside its bound and its plain version; phase times, bucket
     lines, cluster sizes; phase 3 on its kernels: one dc_cluster_build
     launch a batched chunk, one dc_stream_block launch a streamed
     cluster's row block, no host sync in a phase-3 step, nRF DC_NRF_30K
     at N = 30,000, and
     phase 2 on kernel 10: one dc_assign_pack launch a phase and one
     dc_assign launch a chunk, the phase's launches under
     torch.cuda.set_sync_debug_mode("error") (no host sync before its one
     copy to the host), the pack's records and every launch's rows and
     slots recorded for phase 29; and the CLI run again with phases 2 and 3 by
     their plain versions on the card (score_edges_rows_plain,
     build_clusters_plain, the streamed tensor loop) to the same
     assignment and Newick bytes;
  29. kernel 10 (csrc/dc_assign.cu, D&C phase 2's assignment) and its
     pack vs score_edges_rows_plain and pack_slots_plain on the card,
     equal slots and record bytes required: the scorer's made-up states
     in f32 and f64 (ties, every valid score above 2.0, NaN and +inf in
     rows, four edges, unused tails) on 13 rows, contiguous and strided,
     under the kernel's plan and every forced instance (clusters of 1
     block and of the plan's 2; 1, 2, 4, 8 rows a block staged, 2 read
     from device memory; a ring of two stages); phase 16's pack and backbone state with every chunk of its
     real phase-2 rows (every row; the run's slots and a launch again);
     that chunk as a view of wider rows (the matrix frontend's layout); a
     synthetic state at the 1M band's width (B = 50,000, E = 200,000, 256
     rows) in f32 and f64, and in f32 a chunk as the pipeline sizes it
     there (1,342 rows, held in slices of 256), projected to 950,000
     rows. Times: each case's kernel launches queued behind a device
     sleep (median of 5) beside its bound (the rows, the state and the
     slots once at the memory rate, or 35 operations a row and valid slot
     at the float rate), two reckoned floors (the shared-memory gathers'
     bank wavefronts; the records' bytes through L2 at the rate a copy
     within L2 reaches) and the plain version's time (a reference: no
     single PyTorch call computes the function), and the sum over phase
     16's chunks; the pack's time beside its byte bound;
  26. phase 3's kernels vs plain on phase 16's own launches (recorded
     there): every dc_cluster_build launch's every 16th cluster built
     again by build_clusters_plain, all six arrays bit for bit; the first
     chunk of each bucket whole, timed on fresh states queued behind a
     device sleep beside its plain version, its byte bound and its plan's
     latency floor (shared plans: two L2 round trips, then six dependent
     shared-memory loads a step and two a BFS level, one shared-memory
     load timed by a pointer chase; the global plan: five L2 round trips a
     step, two a level); the streamed cluster built again by its kernel
     from its recorded rows (the run's arrays), then by its plain route
     member by member with dc_stream_block launched for one member on a
     copy at every 16th member (the choice, the state and the flags
     against the plain route's), the final states equal; the first 64
     members of the last row block as one launch on 16 and on 8 blocks and
     as a CUDA graph of 64 one-member launches (the same bits), beside the
     plain route and the byte bound; both routes' ms a member; with
     --parent DIR, that checkout's build_chunk on each bucket's first
     chunk and its streamed route timed in turns with this one's (parent,
     this, this, parent), to the same bits;
  18. one batched build at 64 and 1,024 clusters under torch.profiler
     (made-up inputs): by kernel 8b one dc_cluster_build launch, no BFS
     level and no stream sync a build; by its plain version the launches
     of a step must not grow with the clusters;
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
     one launch of each NJ kernel a merge step (19,998 at 20,000), every
     kernel A launch in the half read (the log says so); the
     Newick of the plain route on the card (merge_step_plain every step,
     on the run's matrix) equal byte for byte to the CLI's; kernel A at
     n = 20,000, 10,000 and 2,048 (NJ_TIMED_N) in its half and full
     reads, its flat index equal to the plain version's in both, timed
     queued behind a device sleep (queued_ms) beside the plain Q pass,
     torch.argmin of an [n, n] tensor in memory and both bounds (half-
     and full-read bytes); kernel B at 20,000 equal to the plain step bit
     for bit, timed beside it; with --parent DIR, that checkout's kernels
     A and B equal to this one's and timed in turns (parent, this, this,
     parent); 50 merge steps at each n, ms a step as the run meets them
     and queued (the card's own);
  24. the sketch kernel (csrc/minhash_sketch.cu) against its plain
     version on the card and the native host sketcher, equal bits
     required throughout: phase 5's set (every row against the native
     bank and the plain version, the first 512 also on their own) and
     phase 9's; the select path's cases (one 200 kb row split into
     segments, rows shorter than k, poly-A rows, one row; s 1, 1,000,
     1,024 and 2^20, the tile path); adversarial rows (lengths 0, k-1, k,
     k+1, around the 4,096-window tile edge, 10,000 and 2,000,000; N,
     lowercase and U bytes; a repeat-heavy row; k 4, 11, 15; s 1, 100,
     1000, 1024 and the kernel's largest); device rank_compress equal to
     the first-of-run rule computed on the host, and kernel 2's distances
     through it equal to those through rank_compress_host;
     rank_compress_dense equal to rank_compress_host; distance/mash.py::
     mash_rank_bank's device route on phase 5's set (what placement, D&C
     and --add run) equal byte for byte to the host route's padded rank
     bank, with its logged parts and peak device bytes a bank value
     beside the host route's parts; for both sets the kernel's own time
     by CUDA events (both stages; stage 1, the select kernel; stage 2, the
     merge rounds; stage 1's hashing alone), M k-mers/s, its bound from
     operations and bytes and the share reached, the host's encode/pack
     and the H2D copy, rank_compress and rank_compress_dense against
     rank_compress_host, the native sketcher with the host's CPU and
     threads, and as a yardstick torch.sort along rows of the set's
     [rows, windows] hash matrix (whose first s columns must equal the
     kernel's rows); with --parent DIR, that checkout's kernel timed in
     turns on the same batches (parent, this, this, parent);
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
     (auto mode takes NJ, -d 1); requires rc 0, a complete Newick, one
     launch of each NJ kernel a merge step, kernel A in the half read
     every step, and nRF vs the true tree under MSA_NJ_NRF_LIMIT;
  12. -i m -m 1 on the alignment's first 8,192 sequences: one score_edges
     and one insert_step launch per insertion, nRF vs the true tree
     restricted to them under MSA_PLACE_NRF_LIMIT;
  28. -i m -m 3 -d 1 in f64 on the alignment's first 4,096 sequences
     (MSA_DC_N): one dc_cluster_build launch a batched chunk (its warp and
     block plans in f64), one dc_assign launch a phase-2 chunk and one
     pack a phase, no host
     sync in phase 3, the nRF vs the true tree restricted to them; the
     same Newick bytes with phase 3's plain versions on the card; and the
     first 600 (MSA_DC_CPU_N) built on the card and on the CPU to the same
     Newick bytes;
  14. --add: a backbone built by the port from the first 4,096 sequences
     of the placement set (-i r -m 1), then --add of the next 1,024: every
     backbone split survives, score_edges launches = 1,024, insert_step
     launches = 1,024 and the BFS alone once a backbone leaf, merge-count
     launches > 0, the ingest's device route as in phase 5; and the same Newick from the card and the CPU at a
     backbone of 256 with 64 queries;
  30. multifurcating --add: a backbone built by the port from phase 5's
     set but its last 1,024 taxa (28,976 at N = 30,000; -i r -m 1),
     collapsed (collapse_backbone: the internal edges under the 30th
     percentile of internal lengths, and every internal edge of the
     smallest clade of at least COLLAPSE_CLADE leaves, contracted), then
     --add of the last 1,024: the log's wide-table route, every kept
     backbone split survives, the leaves are the input's, score_edges
     launches = 1,024, the seeding in closest_bfs_range launches = its
     chunks of RANGE_LEAVES (one at 28,976), the wide insert_step's
     launches = 1,024 (none of the BFS alone) and none of the binary
     one's; then on the run's own inputs (wide_window) the range kernel
     against the per-leaf cursor route and the dense BFS, 256 leaves
     (the window after the first 64) and 256 from ADD_WIDE_LATE, and 64
     queries by the cursor route (the seeding and the queries under
     torch.cuda.set_sync_debug_mode("error")), 64 more queries by direct
     launches against splice and dense BFS, the same arrays (and
     insert_model's), each timed by CUDA events queued behind a device
     sleep, the bounds from the model's counts and the latency floor (its
     levels a leaf times one L2 round trip); the window seeded again by
     the range kernel in f64 and at a forced capacity of 32 entries (f32
     and f64): the cursor route's arrays; and the same Newick from the
     card and the CPU on a collapsed backbone of 256 (a clade of 64) with
     64 queries. Seeding ms a backbone leaf, its launches and ms a query
     from the log;
  27. the exact main path: the CLI's exact placement (-i r -m 0, auto mode
     at N >= 30,000, default flags: f32; skipped at a smaller --n) on
     phase 5's set: rc 0, a
     complete Newick with nRF vs the true tree < 0.35, time to tree and ms
     an insertion by range, one exact_step launch an insertion
     (csrc/exact_step.cu: the level order, both sweeps, the score, the
     splice and the depth shift in one launch, replayed as CUDA graphs of
     64 driven by a device cursor), merge-count and sketch-kernel launches
     (the ingest's device route, sampled against the plain version); then
     EXACT_SAMPLE insertions of its last range re-run from a copy of the
     state by the kernel route launch by launch and by the plain version
     on the card, the choices and every array equal after each (the node
     records kept by the splices equal to records rebuilt from the plain
     state); the kernel's time there (a replayed graph of 64) beside the
     plain version's, its byte bound and its latency floor; each part of
     an insertion (walk, up-sweep, down-sweep, score, splice and depth
     shift) by exact_step.cu's stamped instance (at the main path's
     shape, and with every level on block 0), with cycles by level; the
     tree's level widths, the launch shape (C, threads, W) and one
     cluster barrier's cost; with --parent DIR, that checkout's
     exact_step timed in turns with this one's (parent, this, this,
     parent);
  13. exact placement on the card in f64, through
     build_placement_tree_from_seqs(exact=True) on the alignment's first
     512 and 2,048 sequences and build_placement_tree_from_matrix(
     exact=True) on the 2,048's distance matrix: the same Newick as the
     port's CPU build at 512 (sequences) and 2,048 (matrix), one
     exact_step launch an insertion, ms per insertion on both; the kernel
     route against the plain route on the
     card, state for state and choice for choice, in windows of 32
     insertions at the build's start, middle and end; the kernel's time at
     the end beside the plain version's and its bounds; and 2 x 64 + 7
     insertions at the end by the cursor route under
     torch.cuda.set_sync_debug_mode("error") (one exact_step launch an
     insertion, two graph replays, no host sync) and again under
     torch.profiler (launches, copies and syncs an insertion, the device
     busy time and share); the parts, widths, shapes and --parent turns
     as in phase 27, at the end of the 2,048 build.
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
     step, one launch of each NJ kernel a merge step on each rank (kernel
     A in the full read over the rank's rows, no half read); every
     distance-kernel and sketch-kernel
     launch of each rank sampled against the plain version (each rank
     sketches on the card);
  21. two ranks on the one card, D&C: the same with -m 3 on phase 5's set:
     byte-equal to phase 16's tree; each rank's phase times; kernels 1, 2,
     3 and 4 sampled on each rank's launches; one kernel-10 launch a
     phase-2 chunk of each rank's share;
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
Phases 12, 14, 4 and 13 run at 8,192, 4,096 + 1,024, 512 and 2,048,
since the insertion-step and exact-step kernels took their insertion
loops off the host.
Every kernel counter is set to 0 just before a main path (phases 5, 16,
9, 11, 12, 28, 14, 30, 27, and in each rank of 20, 21 and 22) and read just
after it; `launches` in the kernels' record is the count of phases 5
(placement; insert_step's counts both its entry points; the sketch
kernel's), 16 (D&C: the per-cluster count kernel, dc_stream_block,
dc_cluster_build, dc_assign and dc_assign_pack), 9 (NJ: the distance
kernel and NJ's
two), 30 (insert_step_wide, the wide instantiation's queries, and
closest_bfs_range_wide, the seeding's range launches)
and 27 (exact: exact_step), `launches_by_path` has
every path's (one count a rank for the multi-rank paths), and
score_edges's `range_launches` the sharded placement's range launches.

The line before those two gives each line's seconds since the line
before it (the smoke's time by phase). The last two lines are the
kernels' record and {"ok": true, "device": {...}}. Any failed check raises, so the script exits non-zero and prints no
result; it also exits non-zero without CUDA. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
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
                         "dipper_tpu/distance/mash_pallas.py:124"),
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
    "insert_step_wide": ("dipper_tpu_torch/csrc/insert_step.cu",
                         "dipper_tpu/placement/kclosest.py:143 (XLA program, "
                         "no Pallas)"),
    "closest_bfs_range_wide": ("dipper_tpu_torch/csrc/insert_step.cu",
                               "dipper_tpu/placement/kclosest.py:1236 (XLA "
                               "program, no Pallas)"),
    "nj_q_argmin": ("dipper_tpu_torch/csrc/nj_q_argmin.cu",
                    "dipper_tpu/nj/engine.py:35 (XLA program, no Pallas)"),
    "nj_update": ("dipper_tpu_torch/csrc/nj_update.cu",
                  "dipper_tpu/nj/engine.py:35 (XLA program, no Pallas)"),
    "dc_stream_block": ("dipper_tpu_torch/csrc/dc_stream_block.cu",
                        "dipper_tpu/dc/pipeline.py:180 (XLA program, no "
                        "Pallas)"),
    "dc_cluster_build": ("dipper_tpu_torch/csrc/dc_cluster_build.cu",
                         "dipper_tpu/dc/pipeline.py:180 (XLA program, no "
                         "Pallas)"),
    "exact_step": ("dipper_tpu_torch/csrc/exact_step.cu",
                   "dipper_tpu/placement/exact.py:231 (XLA program, no "
                   "Pallas)"),
    "dc_assign": ("dipper_tpu_torch/csrc/dc_assign.cu",
                  "dipper_tpu/dc/pipeline.py:57 (XLA program, no Pallas)"),
    "dc_assign_pack": ("dipper_tpu_torch/csrc/dc_assign.cu",
                       "dipper_tpu/dc/pipeline.py:57 (XLA program, no "
                       "Pallas)"),
    "msa_cluster_dist": ("dipper_tpu_torch/csrc/msa_cluster_dist.cu",
                         "dipper_tpu/dc/pipeline.py:1210 (XLA program, no "
                         "Pallas)"),
    "msa_cluster_dist_pack": ("dipper_tpu_torch/csrc/msa_cluster_dist.cu",
                              "dipper_tpu/dc/pipeline.py:1198 (XLA program, "
                              "no Pallas)"),
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
# the host's kernel launches in torch.profiler's records: <<<>>> launches,
# and cudaLaunchKernelEx's (NJ's kernels, csrc/nj_step.cuh::launch)
LAUNCH_KEYS = ("cudaLaunchKernel", "cudaLaunchKernelExC")
QUEUE_CHUNK = 32
# phase 5's state before its last range and the rows of a window of its
# insertions (two graphs' and 7 more), profiled after the profiler phases
PROFILE_WINDOW: dict = {}
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
# kernel 10's (csrc/dc_assign.cu) operations a row and valid slot: 10
# differences and 10 maxima over the two witness lists, the clamp
# sequence's 14, the compare with the running minimum
ASSIGN_OPS_PER_PAIR = 35
# its instances: (rows a block, staged, blocks a cluster), None the plan's
# own; rows read from device memory are assign_model.GLOBAL_ROWS a block
ASSIGN_INSTANCES = [(None, None, None, None), (None, None, 1, None),
                    (None, None, None, 2), (1, True, None, None),
                    (2, True, None, None), (4, True, None, None),
                    (8, True, None, None), (2, False, None, None),
                    (2, False, 1, None)]
# the synthetic state at the 1M band's width (B = 50,000, E = 4B) and its
# rows: 256, and one chunk as the pipeline sizes it (PHASE2_BYTES // (B x
# 4) rows in f32), held to the plain version in slices of 256 rows
ASSIGN_WIDE_B = 50000
ASSIGN_WIDE_ROWS = 256
# the 1M band's phase 2: the rows of N - B queries at N = 1,000,000
ASSIGN_BAND_QUERIES = 950000
# expected bank wavefronts of a warp's shared-memory load of 4, 8 or 16
# bytes a lane at random addresses (assign_bound)
SM_BANKS = 32
ALL_PHASES = (1, 2, 3, 6, 15, 7, 25, 19, 4, 17, 5, 16, 29, 26, 9, 24, 10, 11,
              12, 28, 31, 14, 30, 27, 13, 8, 18, 20, 21, 22, 23)
# -i m -m 3 (phase 28): the aligned set's first MSA_DC_N sequences on the
# card, and its first MSA_DC_CPU_N on the card and on the CPU
MSA_DC_N = 4096
MSA_DC_CPU_N = 600
# phase 13's taxa, and the insertions of each of its windows of the kernel
# route against the plain route on the card
EXACT_N = 2048
EXACT_WINDOW = 32
# insertions of the exact CLI's last range re-run from a copy of its state
# by the kernel route and by the plain version (phase 27)
EXACT_SAMPLE = 64
# insertions that exact_step.cu's stamped instance times by part (phases
# 13 and 27), and the runs: (name, launch shape); "block0" takes every
# level on block 0 (W above any level: the records without the split),
# "cluster" is the main path's shape
EXACT_PARTS = 16
EXACT_PART_RUNS = (("block0", {"wide": 1 << 30}), ("cluster", {}))
# nRF of the D&C main path's tree vs the true tree at N = 30,000 in every
# earlier smoke with D&C: phase 3's kernels must leave it unchanged
DC_NRF_30K = 0.5831583158315832
# the multifurcating --add backbone (collapse_backbone): internal edges
# below this quantile of the internal lengths contracted, and every
# internal edge of one clade of at least COLLAPSE_CLADE leaves, more than
# the frontier entries of insert_step.cu's shared buffers (kCap = 256), so
# that the clade's level spills to the scratch
COLLAPSE_QUANTILE = 0.3
COLLAPSE_CLADE = 320
# phase 30's window of the kernel route against the plain route: backbone
# leaves seeded, and queries (twice: by the cursor route, then by direct
# launches)
ADD_WIDE_LEAVES = 256
ADD_WIDE_QUERIES = 64
# the first leaf of phase 30's late stretch (the window again, where the
# lists near most leaves are full), and the capacity that the window's
# forced run gives the range kernel's frontier and wide list
ADD_WIDE_LATE = 20000
ADD_WIDE_SMALL_CAP = 32
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
# float32 rate outside the tensor cores without FMA: 132 multiprocessors
# x 128 lanes x 1.98 GHz, one operation a lane a clock (NJ's Q: two
# subtractions and a compare an element)
PEAK_F32_PER_S = 132 * 128 * 1.98e9
# float64 alike: 64 lanes a multiprocessor (half the 67 TFLOP/s FP64
# figure, which counts an FMA as two)
PEAK_F64_PER_S = 132 * 64 * 1.98e9
# NJ's kernel A is timed at these active counts (the main path's first
# step, half of it, and phase 8's size)
NJ_TIMED_N = (20000, 10000, 2048)
# integer operations of one step of the mash walk: a compare, a pointer
# advance, two counter updates
OPS_PER_WALK_STEP = 4
# The sketch kernel's bound counts the instructions of one window in the
# built kernel's SASS (sketch_window_sass): an H100 SM dispatches one warp
# instruction a clock from each of its four schedulers, 128 thread
# instructions; its int32 ALU pipe (logic, shifts, adds, compares,
# selects, byte permutes, LEA) and its FMA pipe's integer multiply-adds
# (IMAD, which the compiler also uses for moves, shifts and adds) run 64
# a clock each (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0); 132 SMs at 1.98 GHz.
SM_CLOCKS_PER_S = 132 * 1.98e9
DISPATCH_PER_SM_CLOCK = 128
INT_PIPE_PER_SM_CLOCK = 64
SASS_ALU = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA")
# windows a thread hashes in one trip of the tile loop (minhash::kItems)
SKETCH_ITEMS = 8
# the sketch kernel's plain version on the card: its tiles of windows and
# row chunks (its bits do not depend on them)
PLAIN_SKETCH_TILE = 2**16
PLAIN_SKETCH_CHUNK_BYTES = 2**31


# (what a line reports, seconds since the line before it) of every line
# emitted: the smoke's time by phase
LINE_SECONDS: list = []
_LAST_LINE = [time.time()]


def emit(obj) -> None:
    now = time.time()
    tag = str(obj.get("phase", "")) + ("/" + str(obj["path"])
                                       if "path" in obj else "")
    LINE_SECONDS.append([tag, round(now - _LAST_LINE[0], 1)])
    _LAST_LINE[0] = now
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
    # a library a source (dc_assign.cu holds kernel 10 and its pack)
    libs = sorted({os.path.splitext(os.path.basename(src))[0]
                   for src, _ in KERNELS.values()})
    for name in libs:
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


def queued_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of `reps` calls queued behind a device sleep (the
    host enqueues them all while the card sleeps, so the card runs them
    back to back) between two CUDA events, after a warm-up: the card's
    own time, also where one call is shorter than the host's launch."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
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


def sass_functions(lib: str) -> dict:
    """The SASS of a library of the port (`lib`, built under csrc/build.py's
    BUILD_DIR, or a path to a .so), by `cuobjdump -sass`: function name ->
    its instructions as (address, opcode without modifiers or predicate,
    text)."""
    from dipper_tpu_torch.csrc.build import BUILD_DIR

    path = lib if lib.endswith(".so") else os.path.join(BUILD_DIR,
                                                        f"lib{lib}.so")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, ins = {}, None
    for ln in sass.splitlines():
        if ln.strip().startswith("Function :"):
            ins = out.setdefault(ln.split(":", 1)[1].strip(), [])
        elif ins is not None:
            for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                         ln):
                text = re.sub(r"^@!?U?P[T0-9]+\s+", "", text.strip())
                ins.append((int(addr, 16), text.split()[0].split(".")[0],
                            text))
    return out


def sketch_window_sass() -> dict:
    """Instructions of one window of the sketch kernel, from the SASS of
    the built library (cuobjdump): the tile loop of select_kernel<true>,
    the hashing alone (the largest backward branch's span), is one trip
    of SKETCH_ITEMS windows a thread, and at k > 8 every instruction of it
    runs (its forward branches skip only the second key word's code, for
    k <= 8). Returns the counts a window: all, the ALU pipe's, the FMA
    pipe's IMAD, and each opcode's."""
    fns = [v for k, v in sass_functions("minhash_sketch").items()
           if "select_kernelILb1E" in k]
    check(len(fns) == 1, "no select_kernel<true> in the sketch library")
    ins = fns[0]
    loops = [(a - int(m.group(1), 16), int(m.group(1), 16), a)
             for a, op, text in ins if op == "BRA"
             for m in [re.search(r"0x([0-9a-f]+)", text)]
             if m and int(m.group(1), 16) < a]
    check(bool(loops), "no loop in select_kernel<true>")
    _, lo, hi = max(loops)
    ops = [op for a, op, _ in ins if lo <= a <= hi]
    per = {op: ops.count(op) / SKETCH_ITEMS for op in sorted(set(ops))}
    check(per.get("BREV") == 1.0, f"the tile loop is not {SKETCH_ITEMS} "
          f"windows of one __brev each: {per}")
    return {"all": len(ops) / SKETCH_ITEMS,
            "alu": sum(per.get(op, 0.0) for op in SASS_ALU),
            "imad": per.get("IMAD", 0.0), "by_opcode": per}


def sketch_bound(windows: int, nbytes: float, per_window: dict) -> dict:
    """Bound of the sketch kernel over `windows` windows: each SM's clocks
    for a window are the most of its instructions over the dispatch rate,
    its ALU instructions and its IMAD over their pipes' rates; against
    the bytes over the memory rate."""
    rates = {"dispatch": per_window["all"] / DISPATCH_PER_SM_CLOCK,
             "alu_pipe": per_window["alu"] / INT_PIPE_PER_SM_CLOCK,
             "fma_pipe": per_window["imad"] / INT_PIPE_PER_SM_CLOCK}
    limit = max(rates, key=rates.get)
    out = bound_of(0, nbytes)
    by_ops = windows * rates[limit] / SM_CLOCKS_PER_S * 1e3
    if by_ops >= out["bound_ms"]:
        out.update(bound_ms=by_ops, bound_by="operations")
    out.update(ops=windows * per_window["all"], limited_by=limit,
               sm_clocks_per_window=rates)
    return out


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


class RouteSampler:
    """While installed, holds the cursor route of insert ranges
    (kclosest._insert_range on a state that takes the kernels: replayed
    graphs) against the plain version: at each graph border before an
    insertion i with (i - 2) a multiple of SIDE_SAMPLE, the state is
    copied, the graph replayed once, and the copy stepped through the
    same insertions by the plain version (which launches none of the
    port's kernels); the seven state arrays must agree, and the scorer's
    six values of the replay's last insertion. `errs`: (last insertion,
    the scorer's max abs err, the arrays that differ) a border;
    `checks_s`: the host time of the checks, queued work first; no check
    while `sampling` is false. Replays outside a range pass unsampled."""

    def __init__(self):
        from dipper_tpu_torch.placement import insert_cuda, kclosest

        self.ic, self.kc = insert_cuda, kclosest
        self.orig = (insert_cuda.replay, kclosest._insert_range)
        self.errs, self.checks_s, self.sampling, self.cur = [], 0.0, True, {}
        insert_cuda.replay, kclosest._insert_range = (self.replay,
                                                      self.insert_range)

    def restore(self) -> None:
        self.ic.replay, self.kc._insert_range = self.orig

    def begin(self, st, lo: int, rows, N: int) -> None:
        """A range of st from insertion lo starts (rows[j]: insertion
        lo + j)."""
        self.cur.update(st=st, rows=rows, lo=lo, N=N, pos=lo, idx=st.idx)

    def insert_range(self, st, lo, hi, rows, num_sequences):
        self.begin(st, lo, rows, num_sequences)
        try:
            return self.orig[1](st, lo, hi, rows, num_sequences)
        finally:
            self.cur.clear()

    def replay(self, g, times: int) -> None:
        replay, cur = self.orig[0], self.cur
        if not (self.sampling and g.steps and cur):
            replay(g, times)
            if cur:
                cur["pos"] += g.steps * times
            return
        st, rows, lo, N = cur["st"], cur["rows"], cur["lo"], cur["N"]
        for _ in range(times):
            pos = cur["pos"]
            first = -(-(pos - 2) // SIDE_SAMPLE) * SIDE_SAMPLE + 2
            if first >= pos + g.steps:
                replay(g, 1)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pl = state_clone(st)
                # st.idx advances at the range's end; the plain copy's as it
                # goes, from the slots in use at this border
                pl.idx = cur["idx"] + 4 * (pos - lo)
                replay(g, 1)
                sc = st.scorer
                got = (*sc.out_i.tolist(), sc.frac.clone(), sc.add.clone())
                for i in range(pos, pos + g.steps):
                    want = plain_step(pl, rows[i - lo], i, N)
                diff = [f for f in state_diff(st, pl) if f != "idx"]
                if pl.idx != cur["idx"] + 4 * (pos + g.steps - lo):
                    diff.append("idx")
                self.errs.append((pos + g.steps - 1, _six_err(got, want),
                                  diff))
                self.checks_s += time.perf_counter() - t0
            cur["pos"] = pos + g.steps


def compare_build(st, rows, lo: int, hi: int, N: int, tag: str,
                  stats: dict | None = None) -> int:
    """Insertions lo..hi-1 (rows[j]: insertion lo + j) by direct kernel
    launches on `st` and by the plain version on a copy, the seven arrays
    compared bit for bit after each, and by the cursor route
    (kclosest._insert_range: replayed graphs and a remainder) on another
    copy, compared at the end. With `stats`, insert_model also steps a
    host copy (its counts go to `stats`: levels, spills, switches between
    narrow and wide levels) and must end in the same state. Returns the
    insertions compared."""
    from dipper_tpu_torch.placement import insert_model, kclosest

    stream = torch.cuda.current_stream().cuda_stream
    pl = state_clone(st)
    route = state_clone(st)
    model = ({f: getattr(st, f).cpu().numpy() for f in insert_model.FIELDS}
             if stats is not None else None)
    for i in range(lo, hi):
        kclosest.kernel_insertion_step(st, rows[i - lo], i, N, stream)
        i0 = pl.idx
        eid, _, _, _, frac, add = plain_step(pl, rows[i - lo], i, N)
        diff = state_diff(st, pl)
        check(not diff, f"{tag}: insert_step != plain at insertion {i}: "
              f"{diff}")
        if model is not None:
            insert_model.insert_step(model, eid, frac.cpu().numpy(),
                                     add.cpu().numpy(), i0, i + N - 1, i, i,
                                     stats=stats)
    kclosest._insert_range(route, lo, hi, rows, N)
    diff = state_diff(route, st)
    check(not diff, f"{tag}: the cursor route != direct launches in {diff}")
    if model is not None:
        mdiff = [f for f in insert_model.FIELDS
                 if getattr(st, f).cpu().numpy().tobytes()
                 != model[f].tobytes()]
        check(not mdiff, f"{tag}: insert_step != insert_model in {mdiff}")
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


def kernel_window(st, rows, lo: int, hi: int, N: int, step=None) -> dict:
    """Insertions lo..hi-1 by direct launches (one score_edges and one
    insert_step launch each; `step(st, sc, i, stream)` in insert_step's
    place, e.g. an earlier commit's kernel), every launch between CUDA
    events, queued QUEUE_CHUNK insertions at a time behind a device sleep
    so that the card runs them back to back: the device ms of each
    launch, and the host ms per insertion of enqueueing them (the
    wrappers' cost)."""
    from dipper_tpu_torch.placement import insert_cuda, kclosest

    if step is None:
        def step(st_, sc, i, stream):
            insert_cuda.insert_step(st_, sc.eid, sc.frac, sc.add,
                                    middle=i + N - 1, outside=i, label=i,
                                    stream=stream)
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
            step(st, sc, i, stream)
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


def parent_module(parent: str, name: str):
    """Module `name` of the port in an earlier checkout at `parent` (which
    builds its kernels from its own csrc/ into its own build/). The
    checkout's package stands in for this one's only while the module is
    imported."""
    import importlib

    pkg = "dipper_tpu_torch"

    def ours():
        return [k for k in sys.modules if k == pkg or k.startswith(pkg + ".")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    root = os.path.abspath(parent)
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module(f"{pkg}.{name}")
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    check(os.path.abspath(mod.__file__).startswith(root + os.sep),
          f"{pkg} of {parent} was not the one imported")
    return mod


def parent_insert_step(parent: str, N: int):
    """insert_step of an earlier checkout, as a kernel_window step: its
    placement/insert_cuda.py on a TreeState that shares the state's arrays
    (so that its own wrapper prepares its own library and scratch), the
    slot counter carried across."""
    import dataclasses

    mod = parent_module(parent, "placement.insert_cuda")
    alias = {}

    def step(st, sc, i, stream):
        pst = alias.get(id(st))
        if pst is None or pst[0] is not st:
            pst = alias[id(st)] = (st, dataclasses.replace(st))
        pst = pst[1]
        pst.idx = st.idx
        mod.insert_step(pst, sc.eid, sc.frac, sc.add, middle=i + N - 1,
                        outside=i, label=i, stream=stream)
        st.idx = pst.idx
    return step


def route_window(st, rows, lo: int, hi: int, N: int) -> dict:
    """Insertions lo..hi-1 by the cursor route (kclosest._insert_range: a
    cursor write, replayed graphs, the remainder by direct cursor
    launches), queued behind a device sleep and timed by CUDA events: the
    card's ms per insertion, and the host's."""
    from dipper_tpu_torch.placement import kclosest

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    t0 = time.perf_counter()
    ev[0].record()
    kclosest._replay_insertions(st, lo, hi, rows, N)
    ev[1].record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"ms": ev[0].elapsed_time(ev[1]) / (hi - lo),
            "host_ms": host / (hi - lo) * 1e3}


def time_insert_window(st, rows, lo: int, N: int,
                       window: int = INSERT_WINDOW,
                       parent: str | None = None) -> dict:
    """On the state before an insert range, left as it was found: its
    first `window` insertions by direct kernel launches (kernel_window),
    again by the plain version on a copy (splice and compact BFS timed by
    CUDA events) and by insert_model on host copies (what they read and
    write); the three must end in the same state. Then the same window by
    the cursor route (replayed graphs and a remainder), which must end
    there too, and the route's replays alone (whole graphs), timed. With
    `parent` (an earlier checkout), its insert_step is timed on the same
    window in turns (parent, this, this, parent) and must end in the same
    state. Returns the times, the bound from the model's counts, and
    levels per insertion."""
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
    # the cursor route on the same window (once to capture the state's
    # graph if no range has, once timed), and its replays alone
    for _ in range(2):
        restore(st, snap)
        route = route_window(st, rows, lo, lo + window, N)
        diff = state_diff(st, after)
        check(not diff, f"insert window at {lo}: the cursor route != direct "
              f"launches in {diff}")
    G = kclosest.GRAPH_INSERTIONS
    whole = window // G * G
    restore(st, snap)
    replays = route_window(st, rows, lo, lo + whole, N) if whole else None
    ms = sum(times["insert_ms"]) / window
    rec = {"lo": lo, "insertions": window, "ms": ms,
           "score_edges_ms": sum(times["score_ms"]) / window,
           "plain_ms": plain_ms / window,
           "host_ms_per_insertion": times["host_ms_per_insertion"],
           "sleep_ms": times["sleep_ms"],
           "chunks_not_queued": times["chunks_not_queued"],
           "cursor_route": {"graph_insertions": G, **route,
                            "equal_direct_launches": True},
           "replays_alone": {"insertions": whole, **(replays or {})},
           "levels_per_insertion": stats["levels"] / window,
           "per_insertion": {k: v / window for k, v in stats.items()},
           "equal_plain_and_model": True}
    if parent:
        old = parent_insert_step(parent, N)
        # the parent's library is built and loaded at its first launch,
        # which no turn times
        restore(st, snap)
        kernel_window(st, rows, lo, lo + 1, N, old)
        turns = []
        for who in ("parent", "this", "this", "parent"):
            restore(st, snap)
            got = kernel_window(st, rows, lo, lo + window, N,
                                old if who == "parent" else None)
            diff = state_diff(st, after)
            check(not diff, f"insert window at {lo}: the parent's kernel "
                  f"!= this one's in {diff}")
            turns.append(sum(got["insert_ms"]) / window)
        rec["parent"] = {"turns_ms": turns, "parent_ms": (turns[0]
                                                         + turns[3]) / 2,
                         "this_ms": (turns[1] + turns[2]) / 2,
                         "equal": True}
    restore(st, snap)
    bound = insert_bound(stats, window, st.length.element_size())
    bound["bound_ms"] /= window
    return with_share(rec, bound)


def l2_round_trip_ms(n: int = 1 << 20, steps: int = 100_000) -> float:
    """One dependent L2 round trip on this card: insert_step.cu's pointer
    chase (one thread, loads past L1) through a random cycle of n int32
    (4 MB: in L2, not in L1), `steps` links between CUDA events."""
    import ctypes

    from dipper_tpu_torch.csrc.build import check_launch, load
    from dipper_tpu_torch.placement import insert_cuda

    lib = load("insert_step", insert_cuda._STEP_ARGS)
    fn = lib.insert_step_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    perm = np.random.default_rng(0).permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[perm] = np.roll(perm, -1)
    (link,) = _on_card(nxt)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    check_launch(lib, "insert_step", fn(link.data_ptr(), n, out.data_ptr(),
                                        dev, stream))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    check_launch(lib, "insert_step", fn(link.data_ptr(), steps,
                                        out.data_ptr(), dev, stream))
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / steps


def phase_insert_vs_plain(tmp: str, n: int = 4096) -> dict:
    """csrc/insert_step.cu against its plain version on the card, the
    seven state arrays bit for bit after every launch; and the latency
    of one BFS level."""
    import dataclasses

    from dipper_tpu_torch.dc import cluster, cluster_cuda
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
        # a choice whose writes overlap: the plain version's later
        # statement wins
        d, eid, frac, add, middle, outside = im.overlap_state(dtype)
        st = kclosest.tree_state_from_numpy(d, dev)
        pl = state_clone(st)
        xy = insert_cuda.insert_step(
            st, torch.full((1,), eid, dtype=torch.int32, device=dev),
            torch.tensor([frac], dtype=dt, device=dev),
            torch.tensor([add], dtype=dt, device=dev), middle=middle,
            outside=outside, label=outside).tolist()
        kclosest.splice(pl, eid, torch.tensor(frac, dtype=dt, device=dev),
                        torch.tensor(add, dtype=dt, device=dev), outside, 4,
                        middle=middle, outside=outside)
        kclosest._update_closest_bfs_compact(pl, outside, 8)
        diff = state_diff(st, pl)
        check(not diff and xy == [eid, 15], f"overlapping splice {dtype}: "
              f"insert_step != plain in {diff} (xy {xy})")
        cases[f"splice/{dtype}/overlap"] = {"equal": True}
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
        stats = {}
        cases[f"build/{kind}{m}/{dtype}"] = {
            "insertions": compare_build(st, D[2:], 2, m, m,
                                        f"{kind} {m} {dtype}", stats),
            "model": stats}
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
    balanced = im.balanced_newick(1024, np.random.default_rng(3))
    for tag, nwk, dtype in (
            ("placement1024", place_nwk, "float32"),
            ("balanced1024", balanced, "float64")):
        st, B = backbone_state(nwk, 1280, dtype)
        stats = {}
        host = {f: getattr(st, f).cpu().numpy() for f in im.FIELDS}
        for leaf in range(B):
            im.closest_bfs(host, leaf, stats=stats)
        cases[f"seeding/{tag}/{dtype}"] = {
            "leaves": compare_seeding(st, range(B), f"seeding {tag}"),
            "model": stats}
    check(cases["seeding/balanced1024/float64"]["model"]["spilled"] > 0,
          "the balanced backbone's seeding spilled no frontier entry")
    # (e2) insertions onto the balanced backbone, its lists empty: levels
    # of 512 nodes (frontiers spill) after narrow ones, in insert_step
    for dtype in ("float32", "float64"):
        st, B = backbone_state(balanced, 1280, dtype)
        rows = torch.from_numpy(np.random.default_rng(25).uniform(
            0.05, 0.5, (24, 1280)).astype(dtype)).to(dev)
        stats = {}
        cases[f"insert/balanced1024/{dtype}"] = {
            "insertions": compare_build(st, rows, B, B + 24, 1280,
                                        f"balanced backbone {dtype}", stats),
            "model": stats}
        check(stats["spilled"] > 0 and stats["switches"] > 0,
              f"insertions onto the balanced backbone {dtype}: no spill or "
              f"no switch between narrow and wide levels ({stats})")
    # (f) D&C's streamed cluster: label, middle, blocked slot 0, scoreable
    # cleared from the splice's (xe, ye), by kernel 8a (insert_step.cuh's
    # splice and walk in block 0, one launch a row block); the plain route
    # on the card
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
        make = cluster.one_cluster

        def keep(route):
            def one(*a):
                st_, sc_ = make(*a)
                states[route] = st_
                return st_, sc_
            return one

        uses = kclosest.uses_insert_kernel
        before = cluster_cuda.STREAM_BLOCK_LAUNCHES
        try:
            cluster.one_cluster = keep("kernel")
            got = cluster.build_streamed(lambda s0: Dq[s0:s0 + rb], *init,
                                         cmax, cmax, rb)
            launches = cluster_cuda.STREAM_BLOCK_LAUNCHES - before
            cluster.one_cluster = keep("plain")
            kclosest.uses_insert_kernel = lambda st_: False
            want = cluster.build_streamed(lambda s0: Dq[s0:s0 + rb], *init,
                                          cmax, cmax, rb)
        finally:
            cluster.one_cluster = make
            kclosest.uses_insert_kernel = uses
        diff = state_diff(states["kernel"], states["plain"])
        check(not diff and launches == -(-cmax // rb)
              and all(torch.equal(a, b) for a, b in zip(got, want)),
              f"streamed cluster {dtype}: dc_stream_block != plain in "
              f"{diff} ({launches} launches for {cmax} members in row "
              f"blocks of {rb})")
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
           "caterpillar_bfs": {"levels": stats["levels"], "ms": runs},
           "l2_round_trip_ms": l2_round_trip_ms()}
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


def phase_gpu_vs_cpu(tmp: str, n: int = 256) -> None:
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
    caps = gpu_vs_cpu_across_caps(tmp)
    emit({"phase": "gpu_vs_cpu", "n": n, "rf": rf, "nrf": nrf,
          "newick_identical": True, "wall_s": walls, "across_caps": caps})


def gpu_vs_cpu_across_caps(tmp: str, n: int = 4096, chunk: int = 1000):
    """The placement of an n-taxon set (the card's mash rows as a matrix)
    by run_placement_chunked in insert ranges of `chunk` on the card (the
    cursor route: graphs replayed with remainders, captured again at each
    prefix cap) and on the CPU (the plain loop): the same Newick bytes."""
    from dipper_tpu_torch.driver import _load_sequences
    from dipper_tpu_torch.placement import insert_cuda, kclosest
    from dipper_tpu_torch.placement.api import _mash_frontend
    from dipper_tpu_torch.utils.params import Param

    fa, _ = make_dataset(n, os.path.join(tmp, f"caps{n}"), seed=5)
    params = Param()
    _, seqs = _load_sequences(params, fa)
    front, static = _mash_frontend(seqs, params, torch.device("cuda"))
    D = kclosest._rows(front, "mash", static, "float32", 0, n).contiguous()
    kw = dict(num_sequences=n, frontend="matrix", dtype_name="float32",
              chunk=chunk)
    ranges = [(lo, min(n, lo + chunk)) for lo in range(2, n, chunk)]
    G = kclosest.GRAPH_INSERTIONS
    c0, r0 = insert_cuda.GRAPH_CAPTURES, insert_cuda.GRAPH_REPLAYS
    t0 = time.time()
    st = kclosest.run_placement_chunked((D,), **kw)
    torch.cuda.synchronize()
    gpu_s = time.time() - t0
    captures = insert_cuda.GRAPH_CAPTURES - c0
    replays = insert_cuda.GRAPH_REPLAYS - r0
    names = [f"T{i}" for i in range(n)]
    nwk = {"cuda": kclosest.edges_to_newick(st.e, st.belong, st.length,
                                            names, n)}
    t0 = time.time()
    st = kclosest.run_placement_chunked((D.cpu(),), **kw)
    cpu_s = time.time() - t0
    nwk["cpu"] = kclosest.edges_to_newick(st.e, st.belong, st.length, names,
                                          n)
    caps = sorted({kclosest._cap_for(hi, n) for _, hi in ranges})
    check(captures == len(caps) >= 2
          and replays == sum((hi - lo) // G for lo, hi in ranges)
          and any((hi - lo) % G for lo, hi in ranges),
          f"across caps: {captures} captures and {replays} replays for "
          f"ranges {ranges} at caps {caps}")
    check(nwk["cuda"] == nwk["cpu"], f"GPU vs CPU port across caps at {n}: "
          f"the Newick bytes differ")
    return {"n": n, "chunk": chunk, "caps": caps, "graph_captures": captures,
            "graph_replays": replays,
            "remainders": [(hi - lo) % G for lo, hi in ranges],
            "newick_identical": True, "gpu_s": gpu_s, "cpu_s": cpu_s}


def _ms(pattern: str, text: str) -> float | None:
    m = re.search(pattern, text)
    return float(m.group(1)) if m else None


def reset_counts() -> None:
    """Every kernel counter to 0 (just before a main path)."""
    from dipper_tpu_torch.dc import assign_cuda, cluster_cuda
    from dipper_tpu_torch.distance import mash_cuda, msa_cuda
    from dipper_tpu_torch.nj import nj_cuda
    from dipper_tpu_torch.placement import exact_cuda, insert_cuda, kclosest
    from dipper_tpu_torch.sketch import minhash_cuda

    cluster_cuda.STREAM_BLOCK_LAUNCHES = 0
    cluster_cuda.CLUSTER_BUILD_LAUNCHES = 0
    msa_cuda.CLUSTER_DIST_LAUNCHES = 0
    msa_cuda.PACK_LAUNCHES = 0
    assign_cuda.ASSIGN_LAUNCHES = 0
    assign_cuda.PACK_LAUNCHES = 0
    mash_cuda.LAUNCHES = 0
    mash_cuda.ROWS_DIST_LAUNCHES = 0
    mash_cuda.CLUSTER_LAUNCHES = 0
    kclosest.SIDE_VECTOR_LAUNCHES = 0
    kclosest.SCORE_EDGES_LAUNCHES = 0
    minhash_cuda.LAUNCHES = 0
    insert_cuda.INSERT_STEP_LAUNCHES = 0
    insert_cuda.CLOSEST_BFS_LAUNCHES = 0
    insert_cuda.INSERT_STEP_WIDE_LAUNCHES = 0
    insert_cuda.CLOSEST_BFS_WIDE_LAUNCHES = 0
    insert_cuda.CLOSEST_BFS_RANGE_WIDE_LAUNCHES = 0
    insert_cuda.GRAPH_CAPTURES = 0
    insert_cuda.GRAPH_REPLAYS = 0
    exact_cuda.EXACT_STEP_LAUNCHES = 0
    nj_cuda.Q_ARGMIN_LAUNCHES = 0
    nj_cuda.HALF_READ_LAUNCHES = 0
    nj_cuda.UPDATE_LAUNCHES = 0


def read_counts() -> dict:
    """Every kernel's launches since reset_counts: insert_step's are those
    of its entry points (direct or replayed), "insert_step.closest_bfs"
    the BFS alone's, "insert_step_wide" those of its wide
    instantiation and "closest_bfs_range_wide" its range launches (a wide
    state's seeding); "nj_q_argmin.half_read" kernel A's launches in the
    half read; and the CUDA graphs of the cursor route captured and
    replayed."""
    from dipper_tpu_torch.dc import assign_cuda, cluster_cuda
    from dipper_tpu_torch.distance import mash_cuda, msa_cuda
    from dipper_tpu_torch.nj import nj_cuda
    from dipper_tpu_torch.placement import exact_cuda, insert_cuda, kclosest
    from dipper_tpu_torch.sketch import minhash_cuda

    return {"mash_merge_count": mash_cuda.LAUNCHES,
            "mash_rows_dist": mash_cuda.ROWS_DIST_LAUNCHES,
            "side_vector": kclosest.SIDE_VECTOR_LAUNCHES,
            "score_edges": kclosest.SCORE_EDGES_LAUNCHES,
            "mash_cluster_inter": mash_cuda.CLUSTER_LAUNCHES,
            "minhash_sketch": minhash_cuda.LAUNCHES,
            "insert_step": (insert_cuda.INSERT_STEP_LAUNCHES
                            + insert_cuda.CLOSEST_BFS_LAUNCHES),
            "insert_step.closest_bfs": insert_cuda.CLOSEST_BFS_LAUNCHES,
            "insert_step_wide": (insert_cuda.INSERT_STEP_WIDE_LAUNCHES
                                 + insert_cuda.CLOSEST_BFS_WIDE_LAUNCHES),
            "insert_step_wide.closest_bfs":
                insert_cuda.CLOSEST_BFS_WIDE_LAUNCHES,
            "closest_bfs_range_wide":
                insert_cuda.CLOSEST_BFS_RANGE_WIDE_LAUNCHES,
            "graph_captures": insert_cuda.GRAPH_CAPTURES,
            "graph_replays": insert_cuda.GRAPH_REPLAYS,
            "nj_q_argmin": nj_cuda.Q_ARGMIN_LAUNCHES,
            "nj_q_argmin.half_read": nj_cuda.HALF_READ_LAUNCHES,
            "nj_update": nj_cuda.UPDATE_LAUNCHES,
            "dc_stream_block": cluster_cuda.STREAM_BLOCK_LAUNCHES,
            "dc_cluster_build": cluster_cuda.CLUSTER_BUILD_LAUNCHES,
            "exact_step": exact_cuda.EXACT_STEP_LAUNCHES,
            "dc_assign": assign_cuda.ASSIGN_LAUNCHES,
            "dc_assign_pack": assign_cuda.PACK_LAUNCHES,
            "msa_cluster_dist": msa_cuda.CLUSTER_DIST_LAUNCHES,
            "msa_cluster_dist_pack": msa_cuda.PACK_LAUNCHES}


class SketchSampler:
    """Every sketch-kernel launch of a run recorded (every SAMPLE-th row of
    its inputs and output), to be held bitwise against the plain version
    on the card on those rows after the run (`finish`)."""

    def __init__(self):
        from dipper_tpu_torch.sketch import minhash_cuda

        self.mod, self.orig, self.calls = (
            minhash_cuda, minhash_cuda.minhash_sketch_cuda, [])

        def rec(words, lengths, *, k, sketch_size, **kw):
            got = self.orig(words, lengths, k=k, sketch_size=sketch_size,
                            **kw)
            self.calls.append((words[::SAMPLE].contiguous(),
                               lengths[::SAMPLE].contiguous(), k,
                               sketch_size, got[::SAMPLE].clone()))
            return got

        minhash_cuda.minhash_sketch_cuda = rec

    def restore(self) -> None:
        self.mod.minhash_sketch_cuda = self.orig

    def finish(self) -> dict:
        """Restores the entry point; compares the recorded launches."""
        from dipper_tpu_torch.sketch.minhash import sketch_batch_plain

        self.restore()
        worst, rows = 0.0, 0
        for words, lengths, k, s, got in self.calls:
            worst = max(worst, u64_err(got, sketch_batch_plain(
                words, lengths, k=k, sketch_size=s)))
            rows += words.shape[0]
        return {"launches_checked": len(self.calls), "rows_checked": rows,
                "max_abs_err": worst}


def check_device_ingest(tag: str, counts: dict, log: str,
                        sketches: SketchSampler) -> dict:
    """A main path from -i r took the device route of the ingest: the
    route's log line, sketch-kernel launches, each equal to the plain
    version on its sampled rows."""
    check("Rank bank route: device" in log,
          f"{tag}: the ingest did not take the device route")
    check(counts["minhash_sketch"] > 0,
          f"{tag}: the main path launched no minhash_sketch kernel")
    res = sketches.finish()
    check(res["max_abs_err"] == 0.0, f"{tag}: a sketch-kernel launch != "
          f"plain on its sampled rows (max abs err {res['max_abs_err']})")
    return res


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


def phase_main_path(tmp: str, n: int, fa: str, true_nwk: str,
                    parent: str | None = None) -> dict:
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

    # before the last insert range: its first rows (taxa not yet inserted)
    # through kernel and plain version on the state as it stands, and the
    # kernels' times there; these launches are taken out of the count.
    # Then the range itself runs with torch's sync check set to raise
    last_range = {}
    sync_range = {}

    def range_recorded(st, lo, hi, rows, num_sequences):
        if hi != num_sequences or last_range:
            return route.insert_range(st, lo, hi, rows, num_sequences)
        route.begin(st, lo, rows, num_sequences)
        route.sampling = False
        t_checks = time.perf_counter()
        count = read_counts()
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
            st, rows, lo, num_sequences, parent=parent)
        # the state and the rows of a window, for the graph route's
        # profile after the CLI's run (whose own launches stay unprofiled)
        w = 2 * kclosest.GRAPH_INSERTIONS + 7
        PROFILE_WINDOW.update(st=state_clone(st), rows=rows[:w].clone(),
                              lo=lo, N=num_sequences)
        # (a capture here is the state's, which the range would make:
        # the build's count keeps it)
        (kclosest.SCORE_EDGES_LAUNCHES, insert_cuda.INSERT_STEP_LAUNCHES,
         insert_cuda.CLOSEST_BFS_LAUNCHES, insert_cuda.GRAPH_REPLAYS) = (
            count["score_edges"],
            count["insert_step"] - count["insert_step.closest_bfs"],
            count["insert_step.closest_bfs"], count["graph_replays"])
        count = read_counts()
        # the CLI's log times the range with these checks inside
        last_range["checks_s"] = time.perf_counter() - t_checks
        route.begin(st, lo, rows, num_sequences)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            insert_range(st, lo, hi, rows, num_sequences)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        route.sampling = True
        after = read_counts()
        launches = {k: after[k] - count[k] for k in (
            "score_edges", "insert_step", "insert_step.closest_bfs",
            "graph_captures", "graph_replays")}
        sync_range.update(
            lo=lo, hi=hi, sync_debug_mode="error", launches=launches,
            launches_per_insertion=(launches["score_edges"]
                                    + launches["insert_step"]) / (hi - lo),
            graph_replays_per_insertion=launches["graph_replays"] / (hi - lo),
            direct_launches_per_insertion=2 * (
                hi - lo - launches["graph_replays"]
                * kclosest.GRAPH_INSERTIONS) / (hi - lo),
            ms_per_insertion=wall / (hi - lo) * 1e3)

    kclosest.run_placement_chunked = keep_state
    mash_cuda.mash_inter_cuda = recorded
    route = RouteSampler()
    insert_range = route.orig[1]
    kclosest._insert_range = range_recorded
    sketches = SketchSampler()
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
        route.restore()
        sketches.restore()
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
    # placement's ingest: the device route (sketch kernel, dense ranks)
    sketch_checked = check_device_ingest("placement", counts, log,
                                         sketches)
    G = kclosest.GRAPH_INSERTIONS
    replayed = G * counts["graph_replays"]
    captures = int(_ms(r"graph captures (\d+)", log) or 0)
    check(0 < replayed <= n - 2 and counts["graph_captures"] == captures
          and captures >= 1,
          f"the placement main path replayed {counts['graph_replays']} "
          f"graphs of {G} insertions for {n - 2} insertions, "
          f"{counts['graph_captures']} captures (log: {captures})")
    check(sync_range and sync_range["launches_per_insertion"] == 2
          and sync_range["launches"]["graph_captures"] == 0,
          f"the last insert range under the sync check: {sync_range}")
    # sample points before the last range, at most half of them in a
    # range's remainder (direct launches, not checked)
    before_last = (sync_range["lo"] - 2 + SIDE_SAMPLE - 1) // SIDE_SAMPLE
    check(len(route.errs) >= before_last // 2,
          f"{len(route.errs)} graph borders checked of {before_last} sample "
          f"points before the last range")
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
    for i, err, diff in route.errs:
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
          - (last_range["checks_s"] + route.checks_s) * 1e3,
          "graph_border_checks_s": route.checks_s,
          "kernel_launches": counts, "kernel_calls": checked,
          "sketch_launches_checked": sketch_checked,
          "graph_route": {
              "graph_insertions": G, "captures_per_build": captures,
              "replays": counts["graph_replays"],
              "replays_per_insertion": counts["graph_replays"] / (n - 2),
              "direct_launches_per_insertion":
                  2 * (n - 2 - replayed) / (n - 2)},
          "graph_borders_checked": [i for i, _, _ in route.errs],
          "score_edges_before_last_range": last_range,
          "last_range_no_sync": sync_range,
          "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true": nrf, "nrf_limit": NRF_LIMIT})
    return {"counts": counts, "merge_count_calls": checked,
            "sketch_checked": sketch_checked,
            "score_edges_last_range": last_range, "sync_range": sync_range,
            "graph_route": {"captures_per_build": captures,
                            "replays": counts["graph_replays"],
                            "graph_insertions": G}}


def phase_nj_gpu_vs_cpu(tmp: str, n: int = 2048) -> dict:
    """The card's mash matrix as PHYLIP, then NJ from it on both devices."""
    from dipper_tpu_torch.io.phylip import read_phylip_lower_triangular
    from dipper_tpu_torch.nj import neighbor_joining
    from dipper_tpu_torch.utils.treecmp import rf_distance

    fa, _ = make_dataset(n, os.path.join(tmp, f"nj{n}"), seed=3)
    phy = os.path.join(tmp, f"nj{n}.phy")
    rc, _, _ = run_cli(["-i", "r", "-I", fa, "-O", phy, "-o", "d"])
    check(rc == 0, f"-i r -o d returned {rc}")
    # -i r -o d at 256 taxa: the device sketcher, device ranks and kernel
    # 2 on the card, their plain versions on the CPU; equal PHYLIP bytes
    head = head_fasta(fa, 256, os.path.join(tmp, "nj256.fa"))
    res, phys = {"o_d_256": {"wall_s": {}}}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"nj256.{dev}.phy")
        rc, _, wall = run_cli(["-i", "r", "-I", head, "-O", out, "-o", "d",
                               "--device", dev])
        check(rc == 0, f"-i r -o d --device {dev} returned {rc}")
        phys[dev] = open(out, "rb").read()
        res["o_d_256"]["wall_s"][dev] = wall
    check(phys["cuda"] == phys["cpu"], "-i r -o d at 256: the card's PHYLIP "
          "bytes != the CPU's")
    res["o_d_256"]["phylip_identical"] = True
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
    _, D = read_phylip_lower_triangular(phy)
    res["kernel_vs_plain"] = nj_routes_on_card(D)
    # one NJ on the card under the profiler: launches per merge step and
    # the device's busy share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    launches = sum(e.count for e in ka if e.key in LAUNCH_KEYS)
    res["profiled_f32"] = {
        "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share_of_profiled_wall": busy_ms / wall_ms,
        "device_busy_share_of_unprofiled_cuda_run":
            busy_ms / res["f32"]["nj_ms"]["cuda"],
        "kernel_launches_per_step": launches / (n - 2),
        "device_ops_per_step": sum(e.count for e in on_dev) / (n - 2),
        "nj_kernel_records_per_step": sum(
            e.count for e in on_dev if "q_argmin_kernel" in e.key
            or "update_kernel" in e.key) / (n - 2),
        "syncs": {k: v for k, v in ((e.key, e.count) for e in ka)
                  if "Synchronize" in k},
        "top_device_ops": sorted(
            ((e.key, e.self_device_time_total / 1e3) for e in on_dev),
            key=lambda kv: -kv[1])[:8]}
    res["profiled_window"] = nj_window_profiled(D)
    emit({"phase": "nj_gpu_vs_cpu", "n": n, **res})
    return res


def _joins(children) -> list:
    return [[c for c, _ in ch] for ch in children]


def _lengths(children) -> np.ndarray:
    return np.array([bl for ch in children for _, bl in ch])


def nj_routes_on_card(D) -> dict:
    """NJ of D on the card by the kernel route (neighbor_joining) and by
    the plain route (neighbor_joining_plain, merge_step_plain every step),
    in f32 and f64: equal join ids; f32 branch lengths byte for byte, f64
    within 1e-12 relative (U[x]'s f64 sum order is each route's own)."""
    from dipper_tpu_torch.nj import (neighbor_joining,
                                     neighbor_joining_plain)

    out = {}
    for prec, dt in (("f32", "float32"), ("f64", "float64")):
        rec, trees = {}, {}
        for route, fn in (("kernel", neighbor_joining),
                          ("plain", neighbor_joining_plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trees[route] = fn(D, dtype_name=dt, device="cuda")
            rec[f"{route}_s"] = time.perf_counter() - t0
        got, want = trees["kernel"], trees["plain"]
        check(got[1] == want[1] and _joins(got[0]) == _joins(want[0]),
              f"NJ {prec} on the card: the kernel route's joins != the "
              "plain route's")
        gl, wl = _lengths(got[0]), _lengths(want[0])
        rel = float(np.max(np.abs(gl - wl) / np.maximum(np.abs(wl),
                                                        1e-300)))
        if prec == "f32":
            check(np.array_equal(gl, wl), "NJ f32 on the card: the kernel "
                  f"route's branch lengths != the plain route's (max rel "
                  f"{rel})")
        else:
            check(rel <= 1e-12, f"NJ f64 on the card: branch lengths "
                  f"{rel} relative off the plain route's")
        out[prec] = {**rec, "joins_equal": True, "max_rel_err": rel}
    return out


def nj_window_profiled(D, steps: tuple = (100, 200)) -> dict:
    """The first merge steps of an NJ of D (f32, no U recompute among
    them) by the kernel route, kernel A in the half read (the mode
    engine._read_mode picks for D): under sync_debug_mode "error", then under
    torch.profiler in windows of steps[0] and steps[1] steps (each from
    a fresh state). Per step, from the difference of the two windows (so
    that the profiler's own syncs and the window's final synchronize
    cancel): the host's kernel launches (LAUNCH_KEYS, every kernel
    of the process), NJ's launches (the wrapper's counts), syncs and
    copies; at most 3 launches, 2 of them NJ's, no sync, no copy. The
    card's kernel records are reported beside them: CUPTI drops a few
    of them in a run, so they are no count to check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.nj import engine, nj_cuda

    N = D.shape[0]
    check(not any(engine._recomputes_u(N - s, N)
                  for s in range(max(steps) + 1)),
          "the profiled NJ window holds a U recompute")

    def fresh():
        st = engine._State(D, "float32", torch.device("cuda"), None)
        k = engine._stepper(st, engine._read_mode(st, None))
        check(k.half, "the PHYLIP matrix is not symmetric bit for bit")
        engine._merge_step_kernels(k, st, 0, None)
        torch.cuda.synchronize()
        return st, k

    st, k = fresh()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s in range(1, max(steps) + 1):
            engine._merge_step_kernels(k, st, s, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    win = {}
    for w in steps:
        st, k = fresh()
        c0 = nj_cuda.Q_ARGMIN_LAUNCHES + nj_cuda.UPDATE_LAUNCHES
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for s in range(1, w + 1):
                engine._merge_step_kernels(k, st, s, None)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        nj = nj_cuda.Q_ARGMIN_LAUNCHES + nj_cuda.UPDATE_LAUNCHES - c0
        ka = prof.key_averages()
        count = {e.key: e.count for e in ka}
        on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
        win[w] = {
            "host_launches": sum(count.get(k2, 0) for k2 in LAUNCH_KEYS),
            "nj_launches": nj,
            "card_kernel_records": sum(e.count for e in on_dev),
            "card_nj_kernel_records": sum(
                e.count for e in on_dev if "q_argmin_kernel" in e.key
                or "update_kernel" in e.key),
            "syncs": {k2: v for k2, v in count.items()
                      if "Synchronize" in k2},
            "memcpys": count.get("cudaMemcpyAsync", 0),
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in on_dev) / 1e3,
            "wall_ms_under_profiler": wall_ms}
    a, b = (win[w] for w in steps)
    d = steps[1] - steps[0]
    res = {"windows": win, "n_first": N - 1,
           "host_launches_per_step":
               (b["host_launches"] - a["host_launches"]) / d,
           "nj_launches_per_step": (b["nj_launches"] - a["nj_launches"]) / d,
           "card_kernel_records_per_step":
               (b["card_kernel_records"] - a["card_kernel_records"]) / d,
           "syncs_per_step": (sum(b["syncs"].values())
                              - sum(a["syncs"].values())) / d,
           "memcpys_per_step": (b["memcpys"] - a["memcpys"]) / d,
           "device_busy_ms_per_step":
               (b["device_busy_ms"] - a["device_busy_ms"]) / d,
           "wall_ms_per_step_under_profiler":
               (b["wall_ms_under_profiler"] - a["wall_ms_under_profiler"])
               / d,
           "no_sync_under_sync_debug_error": True}
    res["device_busy_share"] = (res["device_busy_ms_per_step"]
                                / res["wall_ms_per_step_under_profiler"])
    check(res["nj_launches_per_step"] == 2.0
          and res["host_launches_per_step"] <= 3.0,
          f"NJ merge steps launched {res['host_launches_per_step']} kernels "
          f"a step ({res['nj_launches_per_step']} of them NJ's)")
    check(res["syncs_per_step"] == 0 and res["memcpys_per_step"] == 0,
          f"NJ merge steps synced {res['syncs_per_step']} and copied "
          f"{res['memcpys_per_step']} times a step ({win})")
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


# the kernel of torch.cuda._sleep, which profiler_lead_in launches
LEAD_IN_KERNEL = "spin_kernel"


def profiler_lead_in() -> None:
    """Device work at the start of a profiler session that the session's
    counts leave out, then a device sync: a session's first kernels can
    be missing from its trace, even in the process's first session
    (scripts/profiler_lead_in_check.py counts such misses), so a window
    whose kernels are counted by name starts behind this."""
    for _ in range(8):
        torch.cuda._sleep(10000)
    torch.cuda.synchronize()


def phase_graph_route_profiled() -> dict:
    """The cursor route (kclosest._insert_range) over PROFILE_WINDOW's
    insertions of the main path's state under torch.profiler, after a
    warm-up run that captures the state's graph: the card's kernel
    launches an insertion by name (2.0: score_edges and insert_step; the
    cursor write once a range), the host's graph launches and kernel
    launches, syncs and copies, the device busy time an insertion."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.placement import kclosest

    w = PROFILE_WINDOW
    st, rows, lo, N = w["st"], w["rows"], w["lo"], w["N"]
    n = rows.shape[0]
    snap = state_clone(st)
    kclosest._insert_range(st, lo, lo + n, rows, N)
    torch.cuda.synchronize()
    warm = state_clone(st)
    restore(st, snap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        kclosest._insert_range(st, lo, lo + n, rows, N)
        torch.cuda.synchronize()
    diff = state_diff(st, warm)
    check(not diff, f"the profiled window differs from its warm-up in {diff}")
    ka = prof.key_averages()
    count = {e.key: e.count for e in ka}
    on_dev = [e for e in ka if e.device_type != DeviceType.CPU
              and LEAD_IN_KERNEL not in e.key]
    by_kernel, kernel_ms = {}, {}
    for e in on_dev:
        for name in ("score_edges_kernel", "insert_step_kernel",
                     "cursor_set_kernel"):
            if name in e.key:
                by_kernel[name] = by_kernel.get(name, 0) + e.count
                kernel_ms[name] = (kernel_ms.get(name, 0.0)
                                   + e.self_device_time_total / 1e3)
    per = {k: v / n for k, v in by_kernel.items()}
    device_launches = (by_kernel.get("score_edges_kernel", 0)
                       + by_kernel.get("insert_step_kernel", 0)) / n
    check(device_launches == 2.0 and by_kernel.get("cursor_set_kernel") == 1,
          f"the cursor route launched {by_kernel} on the card for {n} "
          f"insertions")
    G = kclosest.GRAPH_INSERTIONS
    rec = {"phase": "graph_route_profiled", "lo": lo, "insertions": n,
           "graph_insertions": G,
           "device_kernel_launches_per_insertion": device_launches,
           "device_launches_by_kernel_per_insertion": per,
           # each kernel's own duration on the card (profiler), a launch
           "kernel_device_ms": {k: v / by_kernel[k]
                                for k, v in kernel_ms.items()},
           "cudaGraphLaunch": count.get("cudaGraphLaunch", 0),
           "cudaLaunchKernel_per_insertion":
               count.get("cudaLaunchKernel", 0) / n,
           "stream_syncs": count.get("cudaStreamSynchronize", 0),
           "memcpys": count.get("cudaMemcpyAsync", 0),
           "device_busy_ms_per_insertion":
               sum(e.self_device_time_total for e in on_dev) / 1e3 / n}
    emit(rec)
    return rec


def phase_nj_main_path(tmp: str, n: int, parent: str | None = None) -> dict:
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
    check_nj_launches("NJ main path", counts, n, half=True)
    check_nj_mode("NJ main path", log, "half")
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

    names, seqs = _load_sequences(Param(), fa)
    D_host = mash.mash_distance_matrix(ranks_of(seqs, k, s), k, s, "float32",
                                       torch.device("cuda"))
    check(torch.equal(D, D_host), "the NJ matrix from the device sketcher "
          "!= the host route's")
    del D_host, seqs
    # the plain route (merge_step_plain every step) on the card: the same
    # Newick bytes as the CLI's kernel route
    from dipper_tpu_torch.nj import neighbor_joining_plain, nj_tree_newick

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain_nwk = nj_tree_newick(*neighbor_joining_plain(
        D, dtype_name="float32", device="cuda"), names)
    plain_s = time.perf_counter() - t1
    check(plain_nwk == open(out).read().strip(), "NJ main path: the plain "
          "route's Newick on the card != the kernel route's")
    nj_times = nj_kernel_times(D, parent)
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
          "plain_route_nj_s": plain_s, "plain_route_newick_equal": True,
          "nj_kernel_times": nj_times,
          "kernel_launches": counts, "kernel_calls": checked,
          "max_memory_allocated": peak,
          "rf": rf, "nrf_vs_true": nrf, "nrf_limit": NJ_NRF_LIMIT})
    return {"counts": counts, "max_abs_err": worst, "fa": fa,
            "true_nwk": true_nwk, "out": out, "nj_times": nj_times,
            "tree_created_ms": _ms(r"Tree Created in: (\d+) ms", log)}


def check_nj_launches(tag: str, counts: dict, n: int, half: bool) -> None:
    """An NJ of n taxa ran every merge step through both kernels, kernel A
    in the half read (`half`) or in the full read."""
    for name in ("nj_q_argmin", "nj_update"):
        check(counts[name] == n - 2, f"{tag}: {counts[name]} {name} "
              f"launches for {n - 2} merge steps")
    got = counts["nj_q_argmin.half_read"]
    check(got == (n - 2 if half else 0), f"{tag}: {got} of kernel A's "
          f"{n - 2} launches in the half read, want "
          f"{n - 2 if half else 0}")


def check_nj_mode(tag: str, log: str, mode: str) -> None:
    """The NJ run logged kernel A's mode."""
    check(f"NJ merge steps: {mode} read" in log, f"{tag}: the log does not "
          f"say the {mode} read ran: "
          + "; ".join(ln for ln in log.splitlines() if "NJ merge" in ln))


def nj_q_bounds(n: int) -> dict:
    """Kernel A's bounds at n active nodes (f32): the half read's bytes
    (one triangle and the diagonal, n (n + 1) / 2 values, and U) and the
    full read's (n^2 values), each against two subtractions and a compare
    a candidate (n^2 candidates either way)."""
    half = bound_of(3.0 * n * n, 4.0 * n * (n + 1) / 2 + 8.0 * n + 8,
                    PEAK_F32_PER_S)
    full = bound_of(3.0 * n * n, 4.0 * n * n + 8.0 * n + 8, PEAK_F32_PER_S)
    return {**half, "bound_full_read_ms": full["bound_ms"],
            "bound_full_read_by": full["bound_by"]}


def parent_nj_stepper(parent: str, st):
    """Kernel A and B of an earlier checkout: its nj/nj_cuda.py's Stepper
    over copies of the state's arrays (D as a contiguous [N, N], which
    every earlier Stepper takes), so that its own wrapper builds and loads
    its own libraries."""
    mod = parent_module(parent, "nj.nj_cuda")
    D = torch.empty(st.D.shape, dtype=st.D.dtype, device=st.D.device)
    arrays = (D.copy_(st.D), st.U.clone(), st.real.clone(),
              st.log_ids.clone(), st.log_bl.clone())
    return mod.Stepper(*arrays), arrays


def in_turns(this, parent, reps: int) -> dict:
    """queued_ms of `this` and `parent` timed in turns: parent, this,
    this, parent."""
    turns = {"parent": 0.0, "this": 0.0}
    for who in ("parent", "this", "this", "parent"):
        turns[who] += queued_ms(this if who == "this" else parent, reps) / 2
    return turns


def nj_step_windows(D: torch.Tensor, steps: int = 50) -> dict:
    """The first `steps` merge steps of an NJ of D's [n, n] prefix (n in
    NJ_TIMED_N) by the kernel route in the half read, each window from a
    fresh state and timed by CUDA events, ms a step: as the run meets them
    ("host"), and queued behind a device sleep ("card", the card's own
    time a step)."""
    from dipper_tpu_torch.nj import engine, nj_cuda

    out = {}
    for n in sorted((m for m in NJ_TIMED_N if m <= D.shape[0]),
                    reverse=True):
        check(not any(engine._recomputes_u(n - s, n)
                      for s in range(1, steps + 1)),
              f"the step window at {n} holds a U recompute")
        out[n] = {"steps": steps}
        for queue in ("host", "card"):
            st = engine._State(D[:n, :n], "float32", D.device, None)
            k = nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl,
                                half=True)
            engine._merge_step_kernels(k, st, 0, None)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            if queue == "card":
                torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
            ev[0].record()
            for step in range(1, steps + 1):
                engine._merge_step_kernels(k, st, step, None)
            ev[1].record()
            torch.cuda.synchronize()
            out[n][f"ms_per_step_{queue}"] = ev[0].elapsed_time(ev[1]) / steps
            del st, k
        torch.cuda.empty_cache()
    return out


def nj_kernel_times(D: torch.Tensor, parent: str | None = None,
                    reps: int = 20) -> dict:
    """NJ's kernels at the main path's sizes, on a copy of its f32 matrix
    D with U its row sums: kernel A over the whole active block at each n
    of NJ_TIMED_N in the half read (the main path's mode) and in the full
    read, its flat index equal to the plain version's (the Q pass and
    torch.argmin) in both, by CUDA events beside the plain version,
    torch.argmin of an [n, n] tensor already in memory (one library read
    of the full bytes) and both bounds; with `parent` (an earlier
    checkout), that checkout's kernel A on a contiguous copy, its index
    equal, timed in turns with this one's half read (parent, this, this,
    parent). Kernel B (nj_update) at the largest n on the pair kernel A
    chose, bit for bit against _update_plain on a second copy (and the
    parent's kernel B equal on its copy), then timed (each launch
    rewrites the same rows and columns) beside _update_plain and in turns
    with the parent's. Then the step windows (nj_step_windows)."""
    from dipper_tpu_torch.nj import engine

    dev = D.device
    N = D.shape[0]
    st = engine._State(D, "float32", dev, None)
    check(engine._read_mode(st, None), "the NJ matrix is not symmetric bit "
          "for bit")
    ks = {"half": engine._stepper(st, True), "full": engine._stepper(st, False)}
    pk, parrays = parent_nj_stepper(parent, st) if parent else (None, None)
    res = {"q_argmin": {}, "update": {}}
    for n in sorted((m for m in NJ_TIMED_N if m <= N), reverse=True):
        st.U[:n] = engine._sum_last(st.D[:n, :n])
        Dv = st.D[:n, :n]
        Un = st.U[:n] / st.denom[n]
        qbuf = st.q_buffer()
        want = engine._argmin_plain(Dv, Un, qbuf, st.big)
        rec = {}
        for mode, k in ks.items():
            k.q_argmin(n)
            check(torch.equal(k.flat, want), f"kernel A ({mode} read) at n "
                  f"= {n}: flat {int(k.flat)} != the plain version's "
                  f"{int(want)}")
        for mode, k in ks.items():
            rec[f"{mode}_read_ms"] = queued_ms(lambda: k.q_argmin(n), reps)
        if pk is not None:
            parrays[1].copy_(st.U)
            pk.q_argmin(n)
            check(torch.equal(pk.flat, want), f"the parent's kernel A at n "
                  f"= {n}: flat {int(pk.flat)} != the plain version's")
            turns = in_turns(lambda: ks["half"].q_argmin(n),
                             lambda: pk.q_argmin(n), reps)
            rec.update(parent_ms=turns["parent"],
                       this_ms_in_turns=turns["this"])
        rec["plain_ms"] = queued_ms(lambda: engine._argmin_plain(
            Dv, Un, qbuf, st.big), reps)
        Dn = Dv.contiguous()
        rec["library_ms"] = queued_ms(lambda: torch.argmin(Dn), reps)
        del Dn
        rec.update(ms=rec["half_read_ms"], max_abs_err=0.0,
                   **nj_q_bounds(n))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["full_read_share_of_full_bound"] = (rec["bound_full_read_ms"]
                                                / rec["full_read_ms"])
        res["q_argmin"][n] = rec
    n = max(res["q_argmin"])
    step = N - n
    st.U[:n] = engine._sum_last(st.D[:n, :n])
    k = ks["half"]
    k.q_argmin(n)
    flat = k.flat.clone()
    twin = engine._State(st.D, "float32", dev, None)
    twin.U.copy_(st.U)
    if pk is not None:
        for dst, src in zip(parrays, (st.D, st.U, st.real, st.log_ids,
                                      st.log_bl)):
            dst.copy_(src)
    k.update(step, n, flat)
    engine._update_plain(twin, step, flat)
    torch.cuda.synchronize()
    err = max(float((st.D - twin.D).abs().max()),
              float((st.U - twin.U).abs().max()))
    for name in ("D", "U", "real"):
        check(torch.equal(getattr(st, name), getattr(twin, name)),
              f"kernel B at n = {n}: {name} != the plain step's (max abs "
              f"err {err})")
    for name in ("log_ids", "log_bl"):
        check(torch.equal(getattr(st, name)[step], getattr(twin, name)[step]),
              f"kernel B at n = {n}: the log row != the plain step's")
    rec = {}
    if pk is not None:
        pk.update(step, n, flat)
        ours = (st.D, st.U, st.real, st.log_ids[step], st.log_bl[step])
        theirs = (*parrays[:3], parrays[3][step], parrays[4][step])
        check(all(torch.equal(a, b) for a, b in zip(theirs, ours)),
              f"the parent's kernel B at n = {n} != this one's")
        turns = in_turns(lambda: k.update(step, n, flat),
                         lambda: pk.update(step, n, flat), reps)
        rec.update(parent_ms=turns["parent"], this_ms_in_turns=turns["this"])
    rec.update(
        ms=queued_ms(lambda: k.update(step, n, flat), reps),
        plain_ms=queued_ms(lambda: engine._update_plain(twin, step, flat),
                          reps),
        library_ms=None, max_abs_err=err,
        # read rows x, y and last and U; write rows and columns x and y
        # and U
        **bound_of(6.0 * n, 4.0 * (9 * n) + 8.0, PEAK_F32_PER_S))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    res["update"][n] = rec
    del st, twin, ks, k, pk, parrays
    torch.cuda.empty_cache()
    res["step_windows"] = nj_step_windows(D)
    return res


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
    check_nj_launches("-i m main path", counts, n, half=True)
    check_nj_mode("-i m main path", log, "half")
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


def phase_msa_dc(tmp: str, fa: str, true_nwk: str, n: int) -> dict:
    """-i m -m 3 -d 1 in f64 on the aligned set's first n sequences: rc 0,
    a complete Newick, one msa_cluster_dist and one dc_cluster_build
    launch a batched chunk and one dc_stream_block launch a streamed row
    block, no host sync in phase 3, nRF vs the true tree restricted to
    them; the same Newick bytes with phase 3's plain versions on the card;
    and on the first MSA_DC_CPU_N the card's Newick byte-equal to the
    CPU's."""
    from dipper_tpu_torch.dc import cluster
    from dipper_tpu_torch.distance import msa

    def cli(sub: str, out: str, device: str = "cuda") -> tuple:
        return run_cli(["-i", "m", "-I", sub, "-O", out, "-m", "3", "-d",
                        "1", "--precision", "f64", "--device", device])

    sub = head_fasta(fa, n, os.path.join(tmp, f"msa_dc{n}.fa"))
    out = os.path.join(tmp, f"msa_dc{n}.nwk")
    reset_counts()
    cluster.STEPS = cluster.BFS_LEVELS = 0
    rc, log, wall = cli(sub, out)
    counts = read_counts()
    steps, levels = cluster.STEPS, cluster.BFS_LEVELS
    check(rc == 0, f"-i m -m 3 CLI returned {rc}")
    check("Using divide-and-conquer mode" in log, "D&C mode not logged")
    lines = re.findall(r"DC phase 3: bucket \S+ clusters=\d+ path=(\w+) "
                       r"members=\d+ launches=(\d+)", log)
    chunks = sum(int(k) for p, k in lines if p == "batch")
    blocks = sum(int(k) for p, k in lines if p == "stream")
    check(chunks > 0 and counts["dc_cluster_build"] == chunks
          and counts["msa_cluster_dist"] == chunks
          and counts["dc_stream_block"] == blocks,
          f"-i m -m 3: dc_cluster_build {counts['dc_cluster_build']} and "
          f"msa_cluster_dist {counts['msa_cluster_dist']} "
          f"launches for {chunks} chunks, dc_stream_block "
          f"{counts['dc_stream_block']} for {blocks} row blocks")
    check(levels == 0 and steps > 0, f"-i m -m 3: phase 3 synced the host "
          f"{levels} times in {steps} steps")
    p2 = phase2_line(log)
    check(counts["dc_assign"] == p2["chunks"] > 0 and p2["route"] == "kernel",
          f"-i m -m 3: dc_assign {counts['dc_assign']} launches for "
          f"{p2['chunks']} phase-2 chunks")
    check_one_pack("-i m -m 3", counts, p2)
    planes = check_planes("-i m -m 3", log, counts)
    nwk = open(out).read().strip()
    check(nwk.count(",") == n - 1, f"Newick has {nwk.count(',')} commas, "
          f"want {n - 1}")
    rf, nrf = restricted_rf(nwk, open(true_nwk).read())
    plain_out = os.path.join(tmp, f"msa_dc{n}.plain.nwk")
    uses = (cluster.uses_cluster_kernel, cluster.uses_stream_kernels,
            msa.uses_cluster_dist_kernel)
    cluster.uses_cluster_kernel = lambda Dq: False
    cluster.uses_stream_kernels = lambda st: False
    msa.uses_cluster_dist_kernel = lambda codes: False
    try:
        rc_p, _, wall_p = cli(sub, plain_out)
    finally:
        (cluster.uses_cluster_kernel, cluster.uses_stream_kernels,
         msa.uses_cluster_dist_kernel) = uses
    check(rc_p == 0 and open(plain_out).read() == open(out).read(),
          "-i m -m 3: phase 3's kernels and their plain versions give other "
          "Newick bytes")
    small = head_fasta(fa, MSA_DC_CPU_N,
                       os.path.join(tmp, f"msa_dc{MSA_DC_CPU_N}.fa"))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(tmp, f"msa_dc{MSA_DC_CPU_N}.{dev}.nwk")
        rc_s, _, _ = cli(small, outs[dev], dev)
        check(rc_s == 0, f"-i m -m 3 at {MSA_DC_CPU_N} on {dev} returned "
              f"{rc_s}")
    check(open(outs["cuda"]).read() == open(outs["cpu"]).read(),
          f"-i m -m 3 at {MSA_DC_CPU_N}: the card's Newick differs from the "
          "CPU's")
    emit({"phase": "main_path", "path": "msa_dc", "n": n, "L": 10000,
          "distance_type": 1, "precision": "f64", "backbone": n // 20,
          **_dc_log(log), "total_wall_ms": wall * 1e3,
          "plain_route_wall_ms": wall_p * 1e3, "newick_identical_plain": True,
          "newick_identical_cpu_at": MSA_DC_CPU_N, "phase3_steps": steps,
          "phase3_bfs_levels": levels, "kernel_launches": counts,
          **planes, "rf": rf, "nrf_vs_true_restricted": nrf})
    return {"counts": counts}


def check_planes(tag: str, log: str, counts: dict) -> dict:
    """A -i m -m 3 run on the card packed its aligned set once (one
    msa_cluster_dist_pack launch, as its "MSA planes in" line counts) and
    gathered no codes on the host for its batched buckets' distances."""
    m = re.search(r"MSA planes in: (\d+) ms \((\d+) bytes on the card, "
                  r"(\d+) pack launches; the copies (\d+) ms\)", log)
    check(m is not None, f"{tag}: no 'MSA planes in' line in the log")
    check(counts["msa_cluster_dist_pack"] == int(m[3]) == 1,
          f"{tag}: msa_cluster_dist_pack launched "
          f"{counts['msa_cluster_dist_pack']} times (log: {m[3]}), once "
          "wanted")
    gathered = [int(g) for g in re.findall(
        r"DC phase 3: bucket \S+ clusters=\d+ path=batch .*? "
        r"gathered_bytes=(\d+)", log)]
    check(bool(gathered) and not any(gathered),
          f"{tag}: phase 3 gathered {gathered} bytes of codes on the host "
          "on the card's route")
    return {"planes_ms": int(m[1]), "planes_bytes": int(m[2]),
            "pack_launches": int(m[3]), "planes_copies_ms": int(m[4]),
            "phase3_gathered_bytes": sum(gathered)}


class ClusterDistRecorder:
    """Kernel 12's launches of a D&C run: each chunk's (members, clusters),
    and each bucket's first chunk's witness lists (wit_d, the tensor handed
    to the kernel, kept on the card; the pipeline never writes it) with the
    planes and non-gap counts they index; and the host codes the run packed
    (`codes`: the CLI's order, which its input shuffle sets)."""

    def __init__(self):
        from dipper_tpu_torch.distance import msa_cuda

        self.mod, self.fn = msa_cuda, msa_cuda.cluster_dist
        self.pack_bank = msa_cuda.pack_bank
        self.launches, self.first, self.codes = [], {}, None

        def rec_pack(codes, device, log=None):
            self.codes = codes
            return self.pack_bank(codes, device, log=log)

        def rec(planes, nongap, wit, members, **kw):
            out = self.fn(planes, nongap, wit, members, **kw)
            self.launches.append((members, wit.shape[0]))
            self.first.setdefault(members, (planes, nongap, wit))
            return out

        msa_cuda.cluster_dist = rec
        msa_cuda.pack_bank = rec_pack

    def restore(self) -> None:
        self.mod.cluster_dist = self.fn
        self.mod.pack_bank = self.pack_bank


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Two tensors equal bit for bit (a float's NaN bits included)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        bits = torch.int32 if x.dtype == torch.float32 else torch.int64
        x, y = x.view(bits), y.view(bits)
    return torch.equal(x, y)


def hard_chunk(codes: np.ndarray, seed: int = 5) -> tuple:
    """(uint8 [18, 203] bank, int64 [4, 18] witness lists) of a made-up
    bucket-8 chunk (10 head witnesses) whose first cluster's members are
    tests/test_torch_msa.py::_hard_codes' kinds of row: unrelated ones
    (the log of a negative: NaN), a pair a transversion or A<->C apart in
    every column, an all-gap row (0/0, x/0) and a duplicate; the last
    cluster ragged (its last members repeat one). `codes`: the aligned
    set, whose first 10 rows cut to 203 columns are the simulated ones."""
    rng = np.random.default_rng(seed)
    L = 203
    sim = codes[:10, :L]
    rand = rng.integers(0, 4, (6, L)).astype(np.uint8)
    rand[3] = rand[2] ^ 1
    bank = np.concatenate([sim, rand, np.full((1, L), 4, np.uint8), sim[:1]])
    n = len(bank)
    wit = rng.integers(0, n, (4, 18))
    wit[0, 10:] = np.arange(n - 8, n)
    wit[-1, 14:] = wit[-1, 13]
    return bank, wit


def cluster_dist_bound(codes: torch.Tensor, members: int, item: int) -> dict:
    """Kernel 12's first design's bound on one chunk, kept beside
    planes_bound to compare with that design's share: the 4 x 4 bins of
    every pair as int8 one-hot products (16 multiply-adds a pair and
    column) at the tensor cores' int8 rate, against each code byte read
    once and each distance written once."""
    c, W, L = codes.shape
    pairs = c * members * W
    return bound_of(2.0 * 16 * pairs * L, c * W * L + pairs * item,
                    PEAK_INT8_PER_S)


def planes_bound(planes: torch.Tensor, wit: torch.Tensor, members: int,
                 item: int) -> dict:
    """Kernel 12's bound on one chunk, from what it reads: each of the
    chunk's witness rows' planes once (4 x words x 4 bytes a row), each
    distance written once; the 16 bins of every pair as one-bit
    AND-popcount products (32 bit operations a pair and column) at the
    one-bit tensor cores' rate (8 x the int8 peak: an m16n8k256 at the
    issue rate of an m16n8k32)."""
    c, W = wit.shape
    words = planes.shape[2]
    pairs = c * members * W
    return bound_of(32.0 * pairs * words * 32,
                    c * W * words * 16 + pairs * item, 8 * PEAK_INT8_PER_S)


def pack_bound(N: int, L: int, words: int) -> dict:
    """The pack's bound: the codes read once, the planes and counts written
    once; four compares a column on the int32 lanes."""
    return bound_of(4.0 * N * L, N * L + N * words * 16 + N * 4)


def msa_cluster_sass() -> dict:
    """Kernel 12's tensor-core and popcount instructions by function in the
    built library's SASS (cuobjdump): BMMA (one-bit mma), IMMA, POPC."""
    return {name: {op: sum(o == op for _, o, _ in ins)
                   for op in ("BMMA", "IMMA", "POPC")}
            for name, ins in sass_functions("msa_cluster_dist").items()}


def bucket_times(log: str) -> dict:
    """Seconds of each phase-3 bucket of a D&C log, by cmax_b."""
    return {int(b): float(t) for b, t in re.findall(
        r"DC phase 3: bucket cmax_b=(\d+) .* in ([\d.]+)s", log)}


def phase_msa_dc_main_path(tmp: str, fa: str, true_nwk: str, n: int) -> dict:
    """-i m -m 3 on the whole aligned set, default flags (f32, -d 1, B = n
    // 20), in turns with the plain distance route (the witness lists'
    codes gathered on the host and one _block_distance call a cluster,
    msa.uses_cluster_dist_kernel patched): plain, kernel, kernel, plain.
    Every turn rc 0 and the same Newick bytes, a complete tree, nRF vs the
    true tree < DC_NRF_LIMIT; the first kernel turn, counted, packs the set
    once (one msa_cluster_dist_pack launch), launches msa_cluster_dist and
    dc_cluster_build once a batched chunk and gathers no codes on the host
    (its bucket lines' gathered_bytes 0; the plain turns' not). Then the
    pack bit for bit against its plain version on the whole set and on
    hard rows, the run's resident planes equal to them, kernel 12 bit for
    bit against its plain version on each bucket's first chunk of that run
    (its recorded witness lists) and on a made-up chunk of hard rows, all
    six models in f32 and f64; kernel 12's SASS one-bit mma (BMMA) without
    POPC; and the pack's and each first chunk's kernel time queued behind
    a device sleep, beside its bounds and the plain version's time, at the
    run's settings."""
    from dipper_tpu_torch.distance import msa, msa_cuda

    def cli(route: str, tag: str) -> dict:
        path = os.path.join(tmp, f"msa_dc{n}.{tag}.nwk")
        uses = msa.uses_cluster_dist_kernel
        if route == "plain":
            msa.uses_cluster_dist_kernel = lambda codes: False
        try:
            rc, log, wall = run_cli(["-i", "m", "-I", fa, "-O", path, "-m",
                                     "3"])
        finally:
            msa.uses_cluster_dist_kernel = uses
        check(rc == 0, f"-i m -m 3 at {n} ({route} route) returned {rc}")
        return {"route": route, "nwk": open(path).read(), "log": log,
                "wall_ms": wall * 1e3}

    turns = [cli("plain", "t0")]
    reset_counts()
    rec = ClusterDistRecorder()
    try:
        turns.append(cli("kernel", "t1"))
    finally:
        rec.restore()
    counts = read_counts()
    turns += [cli("kernel", "t2"), cli("plain", "t3")]
    log = turns[1]["log"]
    lines = re.findall(r"DC phase 3: bucket \S+ clusters=\d+ path=(\w+) "
                       r"members=\d+ launches=(\d+)", log)
    chunks = sum(int(k) for p, k in lines if p == "batch")
    blocks = sum(int(k) for p, k in lines if p == "stream")
    check(chunks > 0 and counts["msa_cluster_dist"] == chunks
          == len(rec.launches) and counts["dc_cluster_build"] == chunks
          and counts["dc_stream_block"] == blocks,
          f"-i m -m 3 at {n}: msa_cluster_dist {counts['msa_cluster_dist']} "
          f"and dc_cluster_build {counts['dc_cluster_build']} launches for "
          f"{chunks} batched chunks, dc_stream_block "
          f"{counts['dc_stream_block']} for {blocks} row blocks")
    p2 = phase2_line(log)
    check(counts["dc_assign"] == p2["chunks"] > 0 and p2["route"] == "kernel",
          f"-i m -m 3 at {n}: dc_assign {counts['dc_assign']} launches for "
          f"{p2['chunks']} phase-2 chunks")
    nwk = turns[1]["nwk"].strip()
    check(all(t["nwk"] == turns[1]["nwk"] for t in turns),
          f"-i m -m 3 at {n}: the kernel route's and the plain route's "
          "Newick bytes differ")
    check(nwk.count(",") == n - 1, f"Newick has {nwk.count(',')} commas, "
          f"want {n - 1}")
    rf, nrf = restricted_rf(nwk, open(true_nwk).read())
    check(nrf < DC_NRF_LIMIT, f"-i m -m 3 at {n}: nRF vs the true tree "
          f"{nrf} >= {DC_NRF_LIMIT}")
    planes_run = check_planes(f"-i m -m 3 at {n}", log, counts)
    check(all(re.search(r"gathered_bytes=[1-9]", t["log"])
              for t in turns if t["route"] == "plain"),
          f"-i m -m 3 at {n}: a plain turn gathered no codes on the host")

    # the pack against its plain version on the whole set (the run's
    # codes, in its order), and the run's resident planes (the recorded
    # chunks') equal to both
    codes = torch.from_numpy(rec.codes).cuda()
    N, L = codes.shape
    want_p, want_ng = msa.pack_planes_plain(codes)
    planes, nongap = torch.empty_like(want_p), torch.empty_like(want_ng)
    msa_cuda.pack(codes, planes, nongap)
    check(same_bits(planes, want_p) and same_bits(nongap, want_ng),
          f"msa_cluster_dist_pack differs from its plain version at {N} x "
          f"{L}")
    check(all(same_bits(p, want_p) and same_bits(g, want_ng)
              for p, g, _ in rec.first.values()),
          "the run's resident planes differ from the plain version's")
    del want_p, want_ng
    words = planes.shape[2]
    pack = {"rows": N, "L": L, "words": words,
            "ms": queued_ms(lambda: msa_cuda.pack(codes, planes, nongap),
                            reps=5),
            "plain_ms": event_ms(lambda: msa.pack_planes_plain(codes),
                                 reps=1),
            "planes_in_ms": planes_run["planes_ms"],
            **pack_bound(N, L, words)}
    pack["share_of_bound"] = pack["bound_ms"] / pack["ms"]

    # kernel 12 against its plain version on the run's chunks and on hard
    # rows, all models
    hb, hw = hard_chunk(load_codes(fa, 10))
    hard = torch.from_numpy(hb).cuda()
    hp, hng = msa.pack_planes_plain(hard)
    hp_k, hng_k = torch.empty_like(hp), torch.empty_like(hng)
    msa_cuda.pack(hard, hp_k, hng_k)
    check(same_bits(hp_k, hp) and same_bits(hng_k, hng),
          "msa_cluster_dist_pack differs from its plain version on the hard "
          "rows")
    cases = {**{f"bucket{q}": (p, g, w, codes, q)
                for q, (p, g, w) in rec.first.items()},
             "hard": (hp_k, hng_k, msa_cuda.witness_lists(hw, len(hb), "cuda"),
                      hard, 8)}
    compared = {}
    for name, (p, g, w, src, q) in cases.items():
        for dt in range(1, 7):
            for dtype in ("float32", "float64"):
                kw = dict(distance_type=dt, dtype_name=dtype)
                got = msa_cuda.cluster_dist(p, g, w, q, **kw)
                want = msa.cluster_dist_by_index_plain(src, w, q, **kw)
                check(same_bits(got, want), f"msa_cluster_dist differs from "
                      f"its plain version on {name}, -d {dt}, {dtype}")
                if name == "hard" and dt > 1:
                    check(bool(got.isnan().any() or got.isinf().any()),
                          f"the hard chunk gave no NaN or inf at -d {dt}, "
                          f"{dtype}")
        compared[name] = list(w.shape) + [q]
        del got, want
    sass = msa_cluster_sass()
    dist_fns = {k: v for k, v in sass.items() if "cluster_dist_kernel" in k}
    check(len(dist_fns) == 2 and all(v["BMMA"] > 0 and v["POPC"] == 0
                                     for v in dist_fns.values()),
          f"kernel 12's SASS is not one-bit mma without POPC: {sass}")
    # times at the run's settings (f32, -d 1)
    kw = dict(distance_type=1, dtype_name="float32")
    by_bucket = {}
    for q, (p, g, w) in sorted(rec.first.items()):
        c, W = w.shape
        t = {"clusters": c, "W": W,
             "ms": queued_ms(lambda: msa_cuda.cluster_dist(p, g, w, q, **kw),
                             reps=5),
             "plain_ms": event_ms(
                 lambda: msa.cluster_dist_by_index_plain(codes, w, q, **kw),
                 reps=2),
             **planes_bound(p, w, q, 4)}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        codes_b = cluster_dist_bound(torch.empty((c, W, L), device="meta"),
                                     q, 4)
        t.update(codes_bound_ms=codes_b["bound_ms"],
                 codes_bound_by=codes_b["bound_by"],
                 share_of_codes_bound=codes_b["bound_ms"] / t["ms"])
        by_bucket[q] = t
    rec.first.clear()
    del codes, planes, nongap
    res = {"phase": "main_path", "path": "msa_dc_main", "n": n, "L": 10000,
           "distance_type": 1, "precision": "f32", "backbone": n // 20,
           "turns": [{"route": t["route"], "wall_ms": t["wall_ms"],
                      "encode_ms": _ms(r"Encoded in: (\d+) ms", t["log"]),
                      **_dc_log(t["log"]),
                      "bucket_s": bucket_times(t["log"])} for t in turns],
           "chunks": [list(x) for x in rec.launches],
           "newick_identical_plain": True,
           "newick_md5": hashlib.md5(turns[1]["nwk"].encode()).hexdigest(),
           **planes_run, "pack": pack, "kernel_vs_plain": compared,
           "sass": sass, "by_bucket": by_bucket, "kernel_launches": counts,
           "rf": rf, "nrf_vs_true": nrf, "nrf_limit": DC_NRF_LIMIT}
    emit(res)
    return {"counts": counts, "by_bucket": by_bucket, "pack": pack,
            "sass": sass}


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


def collapse_backbone(nwk: str, quantile: float = COLLAPSE_QUANTILE,
                      clade: int = COLLAPSE_CLADE) -> tuple[str, dict]:
    """A multifurcating backbone made from a binary Newick, as other tools
    hand them over (short branches collapsed, or a taxonomy): every
    internal edge shorter than the `quantile` of the internal edges'
    lengths is contracted, and so is every internal edge inside the
    smallest clade of at least `clade` leaves (the first in DFS order),
    whose root then holds all its leaves. A contracted edge's node gives
    its children, with their lengths, to its parent. Returns the Newick
    (io.newick.write_newick, as the CLI writes trees) and the internal
    edges before and after, the clade's leaves and the degrees.

    Host code only, and not a feature of the package. The port's CPU
    tests (test_torch_add.py, test_torch_add_wide.py), its card tests
    (test_torch_cuda.py) and scripts/profile_add_torch.py import it from
    here, so a change to it changes the backbones they build."""
    from dipper_tpu_torch.io.newick import parse_newick, write_newick

    tree = parse_newick(nwk, nwk.count(",") + 1)
    order, stack = [], [tree.root]
    while stack:
        v = stack.pop()
        order.append(v)
        stack.extend(v.children)
    order.reverse()  # children before their parent
    leaves = {}
    for v in order:
        leaves[id(v)] = (1 if v.is_leaf()
                         else sum(leaves[id(c)] for c in v.children))
    inner = [v for v in order if not v.is_leaf() and v.parent is not None]
    cut = float(np.quantile([v.bl for v in inner], quantile))
    big = [v for v in order if not v.is_leaf() and leaves[id(v)] >= clade]
    top = min(big, key=lambda v: leaves[id(v)]) if big else None
    inside = set()
    if top is not None:
        stack = list(top.children)
        while stack:
            v = stack.pop()
            if not v.is_leaf():
                inside.add(id(v))
                stack.extend(v.children)
    for v in inner:
        if v.bl < cut or id(v) in inside:
            p = v.parent
            at = p.children.index(v)
            p.children[at:at + 1] = v.children
            for c in v.children:
                c.parent = p
    nodes, stack = [], [tree.root]
    while stack:
        v = stack.pop()
        nodes.append(v)
        stack.extend(v.children)
    deg = [len(v.children) + (v.parent is not None) for v in nodes
           if not v.is_leaf()]
    return write_newick(tree), {
        "internal_edges": len(inner),
        "internal_edges_kept": sum(not v.is_leaf() and v.parent is not None
                                   for v in nodes),
        "quantile": quantile, "length_cut": cut,
        "clade_leaves": leaves[id(top)] if top is not None else 0,
        "max_degree": max(deg),
        "nodes_above_degree_3": sum(d > 3 for d in deg)}


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
        sketches = SketchSampler() if dev == "cuda" else None
        reset_counts()
        try:
            rc, log, wall = run_cli(["-i", "r", "-I", all_fa, "-O", out,
                                     "--add", "-t", back_nwk, "--device",
                                     dev])
        finally:
            if sketches:
                sketches.restore()
        counts = read_counts()
        check(rc == 0, f"--add --device {dev} returned {rc}")
        if sketches:
            counts["sketch_checked"] = check_device_ingest(
                "--add", counts, log, sketches)
        return open(back_nwk).read(), open(out).read(), counts, log, wall

    back, out, counts, log, wall = add_run(backbone, queries, "cuda", "add")
    sketch_checked = counts.pop("sketch_checked")
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
              "rank_bank": _ms(r"Rank bank in: (\d+) ms", log),
              "seeding": _ms(r"seeded in: ([\d.]+) ms", log),
              "rows": _ms(r"queries: rows ([\d.]+) ms", log),
              "insertions": _ms(r"insertions ([\d.]+) ms", log),
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "seeding_ms_per_backbone_leaf":
              _ms(r"seeded in: ([\d.]+) ms", log) / backbone,
          "ms_per_query": _ms(r"insertions ([\d.]+) ms", log) / queries,
          "kernel_launches": counts, "backbone_splits_survive": True,
          "sketch_launches_checked": sketch_checked,
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
    fn(ranks, wit, mem, s) -> out."""
    mod = parent_module(parent, "distance.mash_cuda")

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
            "msa_planes": _ms(r"MSA planes in: (\d+) ms", log),
            "phase1_backbone": _ms(r"DC phase 1 in: (\d+) ms", log),
            "phase2_assign": _ms(r"DC phase 2 in: (\d+) ms", log),
            "phase3_clusters": _ms(r"DC phase 3 in: (\d+) ms", log),
            "tree_created": _ms(r"Tree Created in: (\d+) ms", log)},
        "clusters": re.search(r"DC phase 3: (\d+ clusters, size .*)",
                              log).group(1),
        "buckets": re.findall(r"DC phase 3: (bucket .*)", log),
        "phase3_gathered_bytes": sum(int(b) for b in re.findall(
            r"DC phase 3: bucket .* gathered_bytes=(\d+)", log))}


class Phase3Recorder:
    """Phase 3's kernel launches of a D&C run recorded for phase 26: of
    every kernel-8b launch (a batched chunk) the initial lists, lengths,
    distances and sizes of its every DC_SAMPLE-th cluster and their
    arrays after the launch, its CUDA-event time, and the first chunk of
    each bucket whole; of every streamed cluster its inputs, its row
    blocks and its output. Nothing here syncs the host."""

    def __init__(self):
        from dipper_tpu_torch.dc import cluster, cluster_cuda

        self.cluster, self.cuda = cluster, cluster_cuda
        self.build_chunk = cluster_cuda.build_chunk
        self.build_streamed = cluster.build_streamed
        self.chunks, self.whole, self.streams = [], {}, []

        def chunk(st, scoreable, Dq, sizes, cmax, stream=None):
            k = slice(None, None, DC_SAMPLE)
            init = {"cd": st.cdis[k, :2].clone(), "cid": st.cid[k, :2].clone(),
                    "lens": st.length[k, :2].clone(), "Dq": Dq[k].clone(),
                    "sizes": sizes[k].clone()}
            if cmax not in self.whole:
                self.whole[cmax] = {
                    "cd": st.cdis[:, :2].clone(), "cid": st.cid[:, :2].clone(),
                    "lens": st.length[:, :2].clone(), "Dq": Dq.clone(),
                    "sizes": sizes.clone()}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            self.build_chunk(st, scoreable, Dq, sizes, cmax, stream)
            ev[1].record()
            got = {f: getattr(st, f)[k].clone() for f in (
                "e", "belong", "length", "rev", "cdis", "cid")}
            self.chunks.append({"cmax": cmax, "clusters": st.e.shape[0],
                                "init": init, "got": got, "ev": ev})

        def streamed(block_fn, cd, cid, lens, size, cmax, row_block):
            blocks = []

            def fn(start):
                blocks.append(block_fn(start))
                return blocks[-1]

            out = self.build_streamed(fn, cd, cid, lens, size, cmax,
                                      row_block)
            self.streams.append({"cd": cd.clone(), "cid": cid.clone(),
                                 "lens": lens.clone(), "size": size,
                                 "cmax": cmax, "row_block": row_block,
                                 "blocks": blocks,
                                 "got": [x.clone() for x in out]})
            return out

        cluster_cuda.build_chunk = chunk
        cluster.build_streamed = streamed

    def restore(self) -> None:
        self.cuda.build_chunk = self.build_chunk
        self.cluster.build_streamed = self.build_streamed


ASSIGN_FIELDS = ("e", "belong", "length", "rev", "cdis", "cid")


class Phase2Recorder:
    """Phase 2 of a D&C run recorded for phase 29: the backbone state's six
    arrays (copied on the card at the first launch), the pack's records
    (copied) and every kernel-10 launch's rows (copied on the card) and
    slots; and the phase's launches (pipeline._phase2_assign, everything
    before its one copy to the host) run under
    torch.cuda.set_sync_debug_mode("error"), so that a host sync there
    raises (`synced` keeps its message). Nothing here syncs the host."""

    def __init__(self):
        from dipper_tpu_torch.dc import assign_cuda, pipeline

        self.mod, self.pipeline = assign_cuda, pipeline
        self.assign, self.phase2 = assign_cuda.assign, pipeline._phase2_assign
        self.pack = assign_cuda.pack
        self.state, self.launches, self.synced, self.windows = None, [], [], 0
        self.records = []

        def pack(st, width):
            got = self.pack(st, width)
            self.records.append(got._replace(data=got.data.clone(),
                                             meta=got.meta.clone()))
            return got

        def assign(st, rows, out=None, **kw):
            got = self.assign(st, rows, out, **kw)
            if self.state is None:
                self.state = {f: getattr(st, f).clone()
                              for f in ASSIGN_FIELDS}
            self.launches.append({"rows": rows.clone(), "got": got.clone(),
                                  "row_stride": rows.stride(0)})
            return got

        def phase2(*a, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            self.windows += 1
            try:
                return self.phase2(*a, **kw)
            except RuntimeError as e:
                self.synced.append(str(e))
                raise
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        assign_cuda.assign = assign
        assign_cuda.pack = pack
        pipeline._phase2_assign = phase2

    def restore(self) -> None:
        self.mod.assign = self.assign
        self.mod.pack = self.pack
        self.pipeline._phase2_assign = self.phase2


def phase2_line(log: str) -> dict:
    """The D&C log's phase-2 line: chunks, rows a chunk, kernel-10
    launches, host syncs, route and pack launches."""
    m = re.search(r"DC phase 2: chunks=(\d+) rows_per_chunk=(\d+) "
                  r"kernel_launches=(\d+) host_syncs=(\d+) route=(\w+) "
                  r"pack_launches=(\d+)", log)
    check(m is not None, "no phase-2 line in the D&C log")
    return {"chunks": int(m[1]), "rows_per_chunk": int(m[2]),
            "kernel_launches": int(m[3]), "host_syncs": int(m[4]),
            "route": m[5], "pack_launches": int(m[6])}


def check_one_pack(tag: str, counts: dict, p2: dict) -> None:
    """Phase 2 on the card packs its state once (one dc_assign_pack
    launch, as its log line counts)."""
    check(counts["dc_assign_pack"] == p2["pack_launches"] == 1,
          f"{tag}: dc_assign_pack launched {counts['dc_assign_pack']} times "
          f"in phase 2 (log: {p2['pack_launches']}), once wanted")


def assign_md5(log: str) -> str:
    return re.search(r"\[assign (\w+)\]", log).group(1)


def phase_dc_main_path(tmp: str, n: int, fa: str, true_nwk: str) -> dict:
    """-m 3 through the CLI on the placement set (B = n // 20): every
    per-cluster count launch recorded and its every DC_SAMPLE-th cluster
    held against the plain version afterwards; the widest batched
    bucket's launch timed again beside its bound and the plain version;
    phase 3's kernels recorded for phase 26 (Phase3Recorder), their
    launches counted against the log's chunks and streamed members; the
    run again with phase 3 by its plain versions on the card, to the same
    Newick bytes."""
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
    sketches = SketchSampler()
    phase2 = Phase2Recorder()
    phase3 = Phase3Recorder()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cluster.STEPS = cluster.BFS_LEVELS = 0
    try:
        rc, log, wall = run_cli(["-i", "r", "-I", fa, "-O", out, "-m", "3"])
    finally:
        mash_cuda.mash_cluster_inter_cuda = kernel
        sketches.restore()
        phase2.restore()
        phase3.restore()
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
    sketch_checked = check_device_ingest("D&C", counts, log, sketches)
    check(counts["score_edges"] == B - 2,
          f"the D&C backbone launched score_edges {counts['score_edges']} "
          f"times for its {B - 2} insertions")
    # one insert_step launch a backbone insertion, the BFS alone for the
    # backbone's two seeds
    streamed = sum(int(m) for m in re.findall(
        r"DC phase 3: bucket \S+ clusters=\d+ path=stream members=(\d+)",
        log))
    row_blocks = sum(int(m) for m in re.findall(
        r"DC phase 3: bucket \S+ clusters=\d+ path=stream members=\d+ "
        r"launches=(\d+)", log))
    check(counts["insert_step"] - counts["insert_step.closest_bfs"]
          == B - 2 and counts["insert_step.closest_bfs"] == 2,
          f"the D&C main path launched insert_step {counts['insert_step']} "
          f"times ({counts['insert_step.closest_bfs']} the BFS alone) for "
          f"{B - 2} backbone insertions and two seeds")
    check(len(calls) == counts["mash_cluster_inter"],
          f"{len(calls)} recorded calls, {counts['mash_cluster_inter']} "
          "launches")
    # phase 3 on its kernels: one kernel-8b launch a batched chunk (the
    # chunk's distance launch), one kernel-8a launch a streamed cluster's
    # row block, no host sync in a step
    chunks = sum(int(c) for c in re.findall(
        r"DC phase 3: bucket \S+ clusters=\d+ path=batch members=\d+ "
        r"launches=(\d+)", log))
    check(counts["dc_cluster_build"] == chunks == len(phase3.chunks),
          f"dc_cluster_build launched {counts['dc_cluster_build']} times for "
          f"{chunks} batched chunks ({len(phase3.chunks)} recorded)")
    check(counts["dc_stream_block"] == row_blocks
          and (row_blocks > 0) == (streamed > 0),
          f"dc_stream_block launched {counts['dc_stream_block']} times for "
          f"{row_blocks} row blocks ({streamed} streamed members)")
    check(levels == 0 and steps > 0, f"phase 3 synced the host {levels} "
          f"times in {steps} steps")
    # phase 2 on kernel 10: one launch a chunk, no host sync before its one
    # copy to the host
    p2 = phase2_line(log)
    check(p2["route"] == "kernel" and counts["dc_assign"] == p2["chunks"]
          == p2["kernel_launches"] == len(phase2.launches) > 0,
          f"dc_assign launched {counts['dc_assign']} times for "
          f"{p2['chunks']} phase-2 chunks ({len(phase2.launches)} recorded)")
    check_one_pack("D&C", counts, p2)
    check(len(phase2.records) == 1, f"{len(phase2.records)} packs recorded")
    check(phase2.windows == 1 and not phase2.synced
          and p2["host_syncs"] == 1, f"phase 2 synced the host: "
          f"{phase2.synced or p2}")
    rf, nrf = check_tree(open(out).read().strip(), n, true_nwk, DC_NRF_LIMIT)
    if n == 30000:
        check(nrf == DC_NRF_30K, f"D&C nRF {nrf}, every earlier smoke "
              f"{DC_NRF_30K}")
    # the same run with phases 2 and 3 by their plain versions on the card
    from dipper_tpu_torch.placement import kclosest

    plain_out = os.path.join(tmp, f"dc{n}.plain.nwk")
    uses = (cluster.uses_cluster_kernel, cluster.uses_stream_kernels,
            kclosest.uses_assign_kernel)
    cluster.uses_cluster_kernel = lambda Dq: False
    cluster.uses_stream_kernels = lambda st: False
    kclosest.uses_assign_kernel = lambda st: False
    try:
        rc_p, log_p, wall_p = run_cli(["-i", "r", "-I", fa, "-O", plain_out,
                                       "-m", "3"])
    finally:
        (cluster.uses_cluster_kernel, cluster.uses_stream_kernels,
         kclosest.uses_assign_kernel) = uses
    check(rc_p == 0, f"D&C CLI with phases 2 and 3 by their plain versions "
          f"returned {rc_p}")
    check(phase2_line(log_p)["route"] == "plain"
          and assign_md5(log_p) == assign_md5(log),
          "D&C: kernel 10 and its plain version give other assignments")
    check(open(plain_out).read() == open(out).read(),
          "D&C: phases 2 and 3 on their kernels and on their plain versions "
          "give other Newick bytes")
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
           "out": out, "phase2": phase2, "phase3": phase3, **_dc_log(log)}
    plain = _dc_log(log_p)
    emit({"phase": "main_path", "path": "dc", "n": n, "backbone": B,
          "L": 10000, "k": 15, "s": 1000, "precision": "f32",
          **_dc_log(log), "total_wall_ms": wall * 1e3,
          "phase3_steps": steps, "phase3_bfs_levels": levels,
          "host_syncs_per_phase3_step": levels / max(steps, 1),
          "phase2": {**p2, "assign_md5": assign_md5(log),
                     "sync_debug_windows": phase2.windows},
          "phase3_chunks": chunks, "phase3_streamed_members": streamed,
          "phase3_row_blocks": row_blocks,
          "phases_2_3_plain_route": {"phases_ms": plain["phases_ms"],
                                     "buckets": plain["buckets"],
                                     "phase2": phase2_line(log_p),
                                     "total_wall_ms": wall_p * 1e3,
                                     "newick_identical": True,
                                     "assign_identical": True},
          "kernel_launches": counts, "mash_cluster_inter_calls": checked,
          "sketch_launches_checked": sketch_checked,
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


def _max_load(balls: int, bins: int) -> float:
    """The expected largest bin of `balls` thrown at random into `bins`
    (exact: P(largest <= k) is balls! / bins^balls times the coefficient of
    x^balls in (sum_{i <= k} x^i / i!)^bins)."""
    expect = 0.0
    for k in range(balls):
        base = np.array([1.0 / math.factorial(i) for i in range(k + 1)])
        poly = np.array([1.0])
        for _ in range(bins):
            poly = np.convolve(poly, base)[:balls + 1]
        p_le = (poly[balls] if poly.size > balls else 0.0) * \
            math.factorial(balls) / bins ** balls
        expect += 1.0 - p_le
    return expect


def gather_wavefronts(nbytes: int) -> float:
    """Expected bank wavefronts of one warp's shared-memory load of
    `nbytes` (4, 8 or 16) a lane at random addresses: the warp's request
    goes in nbytes / 4 phases of 32 / (nbytes / 4) lanes, and a phase takes
    as many wavefronts as its fullest bank (group of nbytes / 4 banks)."""
    phases = nbytes // 4
    lanes = SM_BANKS // phases
    return phases * _max_load(lanes, lanes)


L2_RATE: list = []


def l2_rate() -> float:
    """L2's rate as this card achieves it within L2, bytes a second: an 8
    MB buffer copied into another (both resident in the 50 MB L2) 100
    times in one CUDA graph (no launch gaps), CUDA events around a replay,
    the bytes read and written counted. Measured once a run."""
    if not L2_RATE:
        src = torch.rand(2 << 20, device="cuda")
        dst = torch.empty_like(src)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dst.copy_(src)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(100):
                dst.copy_(src)
        graph.replay()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        L2_RATE.append(2 * src.numel() * 4 * 100
                       / (ev[0].elapsed_time(ev[1]) * 1e-3))
    return L2_RATE[0]


def assign_bound(st, rows, plan) -> dict:
    """Kernel 10's bound on one chunk under `plan` (assign_cuda.plan's):
    the rows, the state and the slots once at the memory rate, or
    ASSIGN_OPS_PER_PAIR operations for each row and valid slot of this
    state at the float rate of the rows' type; and two reckoned floors
    beside it, each with the work that sets it. The shared-memory gather
    floor (staged rows): the witness loads (each row group's, each valid
    record's used witness entries, ceil(R x item / 16) loads an id of
    min(R x item, 16) bytes) / 32 x gather_wavefronts at one wavefront a
    clock on each of 132 SMs at 1.98 GHz. The state's L2 floor: the
    records' bytes times the record streams of a chunk (one a cluster's
    C row groups) over l2_rate()."""
    from dipper_tpu_torch.placement.kclosest import K

    Q, W = rows.shape
    item = rows.element_size()
    E = st.e.shape[0]
    v = st.belong > st.e
    valid = int(v.sum())
    used = int((st.cid[v] != -1).sum() + (st.cid[st.rev[v].long()] != -1)
               .sum())
    nbytes = Q * W * item + E * (K * (4 + item) + 3 * 4 + item) + Q * 8
    rate = PEAK_F64_PER_S if item == 8 else PEAK_F32_PER_S
    groups = -(-Q // plan.rows)
    streams = -(-groups // plan.cluster)
    l2_bytes = valid * plan.record_bytes * streams
    out = {**bound_of(Q * valid * ASSIGN_OPS_PER_PAIR, nbytes, rate),
           "valid_slots": valid, "witness_entries": used,
           "l2_floor_ms": l2_bytes / l2_rate() * 1e3,
           "l2_floor_work": {"record_bytes": plan.record_bytes,
                             "records": valid, "streams": streams,
                             "bytes": l2_bytes, "l2_bytes_per_s": l2_rate()},
           "smem_gather_floor_ms": None, "smem_gather_floor_work": None}
    if plan.staged:
        vec = plan.rows * item
        per_id, width = -(-vec // 16), min(vec, 16)
        warp_loads = groups * used * per_id / 32
        waves = gather_wavefronts(width)
        out["smem_gather_floor_ms"] = warp_loads * waves / SM_CLOCKS_PER_S \
            * 1e3
        out["smem_gather_floor_work"] = {
            "row_groups": groups, "loads_per_id": per_id,
            "load_bytes": width, "warp_loads": warp_loads,
            "wavefronts_per_warp_load": waves}
    return out


def assign_times(st, rows, records, reps: int = 5,
                 plain: bool = True) -> dict:
    """Kernel 10 on one chunk over `records`, the card's time of each of
    `reps` launches queued behind a device sleep (median), after a launch
    that loads it; the plain version's (median of 3, a reference only: no
    single PyTorch call computes this function) unless `plain` is False;
    the bound, the two floors and the share of each."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.placement import kclosest as tk

    out = assign_cuda.assign(st, rows, records=records)
    kernel = queued_each_ms([lambda: assign_cuda.assign(st, rows, out,
                                                        records=records)
                             for _ in range(reps)])
    plain_ms = (_median(queued_each_ms(
        [lambda: tk.score_edges_rows_plain(st, rows) for _ in range(3)]))
        if plain else None)
    plan = assign_cuda.plan(rows.shape[1], rows.dtype)
    rec = {"rows": rows.shape[0], "width": rows.shape[1],
           "slots": st.e.shape[0], "row_stride": rows.stride(0),
           "precision": "f64" if rows.dtype == torch.float64 else "f32",
           "plan": plan._asdict(), "ms": _median(kernel), "ms_runs": kernel,
           "plain_ms": plain_ms, "library_ms": None}
    rec = with_share(rec, assign_bound(st, rows, plan))
    rec["share_of_l2_floor"] = rec["l2_floor_ms"] / rec["ms"]
    if rec["smem_gather_floor_ms"] is not None:
        rec["share_of_smem_gather_floor"] = (rec["smem_gather_floor_ms"]
                                             / rec["ms"])
    return rec


def pack_times(st, width: int, reps: int = 5) -> dict:
    """The pack on one state, each of `reps` launches queued behind a
    device sleep (median); its plain version's (median of 3); its bound:
    the state's arrays read once and the records written once at the
    memory rate."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.placement import kclosest as tk
    from dipper_tpu_torch.placement.kclosest import K

    got = assign_cuda.pack(st, width)
    kernel = queued_each_ms([lambda: assign_cuda.pack(st, width)
                             for _ in range(reps)])
    plain = queued_each_ms([lambda: tk.pack_slots_plain(st, width)
                            for _ in range(3)])
    E = st.e.shape[0]
    item = st.length.element_size()
    valid = int(got.meta[0])
    nbytes = (E * (K * (4 + item) + 3 * 4 + item)
              + valid * got.data.shape[1] + 8)
    rec = {"slots": E, "records": valid, "record_bytes": got.data.shape[1],
           "width": width, "ms": _median(kernel), "ms_runs": kernel,
           "plain_ms": _median(plain), "library_ms": None}
    return with_share(rec, bound_of(0, nbytes))


def _assign_state(arrays: dict):
    from dipper_tpu_torch.placement import kclosest as tk

    return tk.TreeState(**arrays, idx=0)


def _check_pack(st, width: int, tag: str, got=None):
    """The pack (`got`, or a launch now) against pack_slots_plain, byte for
    byte: the valid slots' records and meta (count, lowest invalid slot).
    Returns the records."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.placement import kclosest as tk

    got = got or assign_cuda.pack(st, width)
    rec, meta = tk.pack_slots_plain(st, width)
    check(torch.equal(got.meta, meta), f"the pack on {tag}: meta "
          f"{got.meta.tolist()} != plain {meta.tolist()}")
    check(torch.equal(got.data[:rec.shape[0]], rec),
          f"the pack on {tag}: records != plain")
    return got


def _assign_every_plan(st, rows, records, tag: str) -> int:
    """Kernel 10 under its plan and every instance of ASSIGN_INSTANCES
    that fits against the plain version on the card, bit for bit; returns
    the launches."""
    from dipper_tpu_torch.dc import assign_cuda
    from dipper_tpu_torch.dc import assign_model as am
    from dipper_tpu_torch.placement import kclosest as tk

    want = tk.score_edges_rows_plain(st, rows)
    W, item = rows.shape[1], rows.element_size()
    launches = 0
    for r, staged, cl, stages in ASSIGN_INSTANCES:
        try:
            am.kernel_plan(W, item, r, staged, cl, stages)
        except ValueError:
            continue
        got = assign_cuda.assign(st, rows, records=records, rows_per_block=r,
                                 staged=staged, cluster=cl, stages=stages)
        check(torch.equal(got, want), f"kernel 10 != plain on {tag} (rows a "
              f"block {r}, staged {staged}, cluster {cl}, stages {stages}): "
              f"{int((got != want).sum())} rows differ")
        launches += 1
    return launches


def phase_dc_assign_vs_plain(rec: Phase2Recorder) -> dict:
    """Kernel 10 (csrc/dc_assign.cu) and its pack against their plain
    versions (score_edges_rows_plain, pack_slots_plain) on the card, bit
    for bit: the scorer's made-up states in f32 and f64 (ties, every valid
    score above 2.0, NaN and +inf in rows, four edges, unused tails) on 13
    rows, contiguous and strided, under every instance; phase 16's pack
    and every chunk of its real phase-2 rows (D&C 30K's backbone state,
    every row) and its slots from the run; those rows as the matrix
    frontend hands them over (a view of wider rows); a synthetic state at
    the 1M band's width (B = 50,000, E = 200,000) with 256 rows in f32
    (one row a block) and f64 (rows read from device memory), and in f32
    one chunk as the pipeline sizes it (PHASE2_BYTES // (B x 4) = 1,342
    rows, held to the plain version in slices of 256 rows), timed and
    projected to the 1M band's 950,000 rows. Each timed (assign_times)
    beside its bound, its two floors and the plain version; the pack
    timed on D&C 30K's state and at B = 50,000."""
    from dipper_tpu_torch.dc import assign_cuda, pipeline
    from dipper_tpu_torch.placement import kclosest as tk
    from dipper_tpu_torch.placement import score_model as sm

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    out = {"made_up": {}}
    launches = packs = 0
    for dtype in ("float32", "float64"):
        for name, d, row, _ in sm.made_up_cases(dtype, seed=29):
            st = _assign_state({f: torch.from_numpy(np.array(d[f])).to(dev)
                                for f in ASSIGN_FIELDS})
            rows_h = np.stack([row] + [rng.permutation(row)
                                       for _ in range(11)]
                              + [np.full_like(row, row[0])])
            wide = torch.from_numpy(np.concatenate(
                [rows_h, rng.random((13, 5)).astype(dtype)], axis=1)).to(dev)
            rows = torch.from_numpy(rows_h).to(dev)
            records = _check_pack(st, rows.shape[1], f"{name} {dtype}")
            packs += 1
            for r, tag in ((rows, "contiguous"),
                           (wide[:, :rows_h.shape[1]], "strided")):
                launches += _assign_every_plan(st, r, records,
                                               f"{name} {dtype} {tag}")
            out["made_up"][f"{name}/{dtype}"] = {
                "slots": int(d["e"].shape[0]), "rows": 13}
    # D&C 30K's backbone, the run's records and its real rows, every chunk
    # and row
    check(rec.state is not None and rec.launches and len(rec.records) == 1,
          "phase 16 recorded no kernel-10 launch or not one pack")
    st = _assign_state(rec.state)
    W = rec.launches[0]["rows"].shape[1]
    records = _check_pack(st, W, "D&C 30K's state (the run's records)",
                          rec.records[0])
    rows_checked = 0
    for j, c in enumerate(rec.launches):
        want = tk.score_edges_rows_plain(st, c["rows"])
        check(torch.equal(c["got"], want), f"D&C phase-2 chunk {j}: the "
              f"run's slots != plain ({int((c['got'] != want).sum())} rows)")
        check(torch.equal(assign_cuda.assign(st, c["rows"], records=records),
                          want),
              f"D&C phase-2 chunk {j}: kernel 10 again != plain")
        rows_checked += c["rows"].shape[0]
        launches += 1
    big = max(rec.launches, key=lambda c: c["rows"].shape[0])["rows"]
    out["dc_chunk"] = assign_times(st, big, records)
    out["pack_dc"] = pack_times(st, W)
    # every chunk once more, queued, for the phase's kernel time
    outs = [torch.empty(c["rows"].shape[0], dtype=torch.int64, device=dev)
            for c in rec.launches]
    each = queued_each_ms([lambda c=c, o=o: assign_cuda.assign(
        st, c["rows"], o, records=records) for c, o in zip(rec.launches,
                                                           outs)])
    plan = assign_cuda.plan(W, big.dtype)
    bounds = [assign_bound(st, c["rows"], plan) for c in rec.launches]
    out["dc_phase2"] = {"chunks": len(rec.launches), "rows": rows_checked,
                        "kernel_ms_sum": sum(each), "kernel_ms": each,
                        "pack_ms": out["pack_dc"]["ms"],
                        **{f"{k}_sum": sum(b[k] for b in bounds) for k in
                           ("bound_ms", "smem_gather_floor_ms",
                            "l2_floor_ms")}}
    # the matrix frontend's rows: a view of an [N, N] matrix's rows
    Q, B = big.shape
    mat = torch.zeros((Q, 20 * B), dtype=big.dtype, device=dev)
    mat[:, :B] = big
    view = mat[:, :B]
    launches += _assign_every_plan(st, view, records, "the strided D&C chunk")
    out["matrix_strided"] = assign_times(st, view, records)
    del mat, view
    # the 1M band's width
    for dtype in ("float32", "float64"):
        d = sm.made_up_state(2 * ASSIGN_WIDE_B - 2, 4 * ASSIGN_WIDE_B,
                             ASSIGN_WIDE_B, dtype, rng, bare=False)
        st_w = _assign_state({f: torch.from_numpy(np.array(d[f])).to(dev)
                              for f in ASSIGN_FIELDS})
        records = _check_pack(st_w, ASSIGN_WIDE_B, f"B = 50,000 {dtype}")
        packs += 1
        rows_h = rng.random((ASSIGN_WIDE_ROWS, ASSIGN_WIDE_B)).astype(dtype)
        rows_h[7, ::101] = np.nan
        rows_w = torch.from_numpy(rows_h).to(dev)
        launches += _assign_every_plan(st_w, rows_w, records,
                                       f"B = 50,000 {dtype}")
        out[f"b50000_{dtype}"] = assign_times(st_w, rows_w, records)
        del rows_w
        if dtype == "float32":
            out["pack_b50000"] = pack_times(st_w, ASSIGN_WIDE_B)
            # one chunk as the pipeline sizes it at the 1M band
            q = pipeline.PHASE2_BYTES // (ASSIGN_WIDE_B * 4)
            band = torch.rand((q, ASSIGN_WIDE_B), generator=torch.Generator(
                device=dev).manual_seed(29), device=dev)
            band[11, ::103] = float("nan")
            got = assign_cuda.assign(st_w, band, records=records)
            launches += 1
            plain_ms = []
            for a in range(0, q, ASSIGN_WIDE_ROWS):
                part = band[a:a + ASSIGN_WIDE_ROWS]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                want = tk.score_edges_rows_plain(st_w, part)
                ev[1].record()
                torch.cuda.synchronize()
                plain_ms.append(ev[0].elapsed_time(ev[1]))
                check(torch.equal(got[a:a + ASSIGN_WIDE_ROWS], want),
                      f"the 1M band's chunk, rows {a}..: kernel 10 != plain "
                      f"({int((got[a:a + ASSIGN_WIDE_ROWS] != want).sum())} "
                      "rows)")
            t = assign_times(st_w, band, records, plain=False)
            t["plain_ms"] = sum(plain_ms)
            t["plain_ms_slices"] = plain_ms
            t["projected_s_1m_band"] = (t["ms"] * ASSIGN_BAND_QUERIES / q
                                        / 1e3)
            t["projected_queries"] = ASSIGN_BAND_QUERIES
            out["band_chunk_float32"] = t
            del band
        del st_w
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "kernel": "dc_assign",
          "launches_compared": launches, "packs_compared": packs + 1,
          "dc_rows_compared": rows_checked, "max_abs_err": 0, **out})
    return out


def _bits_diff(got: dict, want, fields) -> list:
    """The fields in which `got` (name -> tensor) and `want` (an object
    with those attributes) differ bit for bit."""
    return [f for f in fields if not same_bits(got[f], getattr(want, f))]


def _kept_states(cluster, name: str = "cluster_init_state"):
    """cluster.<name> (cluster_init_state, or one_cluster for a streamed
    build's state), recording each state it gives; returns (the list, a
    function that puts the original back)."""
    made, orig = [], getattr(cluster, name)

    def keep(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    setattr(cluster, name, keep)
    return made, lambda: setattr(cluster, name, orig)


def scored_reads(cid, rev, flags, n_used: int) -> tuple:
    """What a masked score over the n_used slots in use of each cluster
    (cid [C, E, K], rev [C, E], flags [C, E]) must read, summed over the
    clusters: the slots whose lists it reads (the scoreable ones and their
    reverses), the scoreable slots (whose reverse slot and length it
    reads), and the distinct witnesses those lists name (whose row entries
    it reads)."""
    valid = flags[:, :n_used]
    ci, j = valid.nonzero(as_tuple=True)
    read = valid.clone()
    read[ci, rev[ci, j].clamp(min=0).long()] = True
    rc, rj = read.nonzero(as_tuple=True)
    ids = cid[rc, rj].long()
    top = int(ids.max()) if ids.numel() else -1
    named = torch.zeros((valid.shape[0], top + 2), dtype=torch.bool,
                        device=valid.device)
    named[rc[:, None].expand_as(ids), ids + 1] = True
    return int(read.sum()), int(valid.sum()), int(named[:, 1:].sum())


def member_bytes(st, flags: torch.Tensor) -> int:
    """Kernel 8a's bytes for one member of a streamed cluster (a state of
    one tree at st.idx slots in use, its flags before the member), each
    input byte read once and each output byte written once: the flags of
    the slots in use, the reverse slot and length of the scoreable ones,
    the lists of those and of their reverses, the row entries the lists
    name; the splice's six slots (e, belong, rev, length, lists), six flags
    and two adjacency rows."""
    item, K_ = st.length.element_size(), st.cid.shape[-1]
    n_read, n_valid, named = scored_reads(st.cid[None], st.rev[None],
                                          flags[None], st.idx)
    slot = 3 * 4 + item + K_ * (4 + item)
    return (st.idx + n_valid * (4 + item) + n_read * K_ * (4 + item)
            + named * item + 6 * slot + 6 + 2 * 3 * 4)


def shared_round_trip_ms(n: int = 4096, steps: int = 1_000_000) -> float:
    """One dependent shared-memory load on this card: dc_cluster_build.cu's
    pointer chase (one thread) through a random cycle of n int32 in shared
    memory, `steps` links between CUDA events."""
    import ctypes

    from dipper_tpu_torch.csrc.build import check_launch, load
    from dipper_tpu_torch.dc import cluster_cuda

    lib = load("dc_cluster_build", cluster_cuda._BUILD_ARGS)
    fn = lib.dc_cluster_build_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    perm = np.random.default_rng(0).permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[perm] = np.roll(perm, -1)
    (link,) = _on_card(nxt)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    check_launch(lib, "dc_cluster_build", fn(link.data_ptr(), n, 1000,
                                             out.data_ptr(), dev, stream))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    check_launch(lib, "dc_cluster_build", fn(link.data_ptr(), n, steps,
                                             out.data_ptr(), dev, stream))
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / steps


def chunk_bound(cluster, w: dict, cmax: int) -> dict:
    """Kernel 8b's bound for a chunk (w: its initial lists, lengths,
    distances and sizes): each input byte read once (the sizes, slots 0
    and 1 and nodes 0 and 1 of every cluster as cluster_init_state leaves
    them, and for every member the row entries its masked score needs,
    counted at its turn along a plain build) and each output byte written
    once (the 2 + 4 size slots and 2 + 2 size nodes a cluster uses: e,
    belong, rev, length, lists, flag; adjacency)."""
    K_ = w["cid"].shape[-1]
    item = w["Dq"].element_size()
    named, orig = [0], cluster._score_masked

    def counting(st, scoreable, rows, kq, order):
        named[0] += scored_reads(st.cid, st.rev, scoreable, 2 + 4 * kq)[2]
        return orig(st, scoreable, rows, kq, order)

    cluster._score_masked = counting
    try:
        cluster.build_clusters_plain(w["Dq"], w["cd"], w["cid"], w["lens"],
                                     w["sizes"].cpu().numpy(), cmax)
    finally:
        cluster._score_masked = orig
    sizes = w["sizes"].long()
    C = int(sizes.numel())
    slot = 3 * 4 + K_ * (4 + item) + item + 1
    slots = 2 * C + int((2 + 4 * sizes).sum())
    nodes = 2 * C + int((2 + 2 * sizes).sum())
    nbytes = named[0] * item + 4 * C + slots * slot + nodes * 3 * 4
    return {**bound_of(0, nbytes), "dq_entries_named": named[0]}


def _median(xs) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


def queued_each_ms(launches) -> list:
    """The card's time of each of `launches` (callables, each one kernel
    launch on inputs of its own, made beforehand), the launches queued
    behind a device sleep so that the card runs them back to back: CUDA
    events around each, without the host's time between them."""
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
           for _ in launches]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for fn, ev in zip(launches, evs):
        ev[0].record()
        fn()
        ev[1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def _chunk_runs(cluster, build, w: dict, cmax: int, reps: int = 5) -> tuple:
    """`reps` kernel-8b launches (`build`: a build_chunk) of a recorded
    chunk, each on a fresh state, queued (queued_each_ms) after one launch
    that loads the kernel: (the times, the last state)."""
    def fresh():
        return cluster.cluster_init_state(w["cd"], w["cid"], w["lens"], cmax,
                                          with_adj=True)

    build(*fresh(), w["Dq"], w["sizes"], cmax)
    states = [fresh() for _ in range(reps)]
    times = queued_each_ms([
        lambda st=st, sc=sc: build(st, sc, w["Dq"], w["sizes"], cmax)
        for st, sc in states])
    return times, states[-1][0]


def phase_dc_kernels_vs_plain(rec: "Phase3Recorder",
                              parent: str | None = None) -> dict:
    """Phase 3's kernels on the D&C main path's own inputs (phase 16's
    recording), against their plain versions on the card, bit for bit.
    Kernel 8b: every recorded launch's every DC_SAMPLE-th cluster built
    again by build_clusters_plain (all six arrays); the first chunk of
    each bucket whole, its launch timed on fresh states queued behind a
    device sleep (queued_each_ms) beside the plain version, the byte bound
    and its plan's latency floor (shared plans: two L2 round trips to stage
    the state, then six
    dependent shared-memory loads a step and two a BFS level of the plain
    route; the global plan: five L2 round trips a step, two a level).
    Kernel 8a: the streamed cluster built again by its kernel from its
    recorded rows (the run's arrays), then by its plain route member by
    member, kernel 8a launched for one member on a copy of the state at
    every DC_SAMPLE-th member and at the last (the choice, the state and
    the flags against the plain route's); the first 64 members of the last
    row block timed as one launch (16 and 8 blocks, queued) and as a CUDA
    graph of 64 one-member launches, beside the plain route, the byte
    bound and the score's and splice's L2 trips. With `parent` (a
    checkout), its build_chunk and build_streamed timed in turns with this
    one's on the same inputs (parent, this, this, parent), to the same
    bits."""
    from dipper_tpu_torch.dc import cluster, cluster_cuda

    check(bool(rec.chunks) and bool(rec.streams),
          "phase 26 needs phase 16's batched chunks and streamed cluster")
    l2 = l2_round_trip_ms()
    shm = shared_round_trip_ms()
    six = ("e", "belong", "length", "rev", "cdis", "cid")
    par_cuda = par_cluster = None
    if parent is not None:
        par_cuda = parent_module(parent, "dc.cluster_cuda")
        par_cluster = parent_module(parent, "dc.cluster")
    # (a) kernel 8b, every DC_SAMPLE-th cluster of every launch
    sampled = 0
    for j, ch in enumerate(rec.chunks):
        i = ch["init"]
        made, put_back = _kept_states(cluster)
        try:
            cluster.build_clusters_plain(i["Dq"], i["cd"], i["cid"],
                                         i["lens"], i["sizes"].cpu().numpy(),
                                         ch["cmax"])
        finally:
            put_back()
        diff = _bits_diff(ch["got"], made[0][0], six)
        check(not diff, f"dc_cluster_build launch {j} (cmax {ch['cmax']}): "
              f"{diff} != plain on every {DC_SAMPLE}th cluster")
        sampled += i["sizes"].shape[0]
    launches = [{"cmax": ch["cmax"], "clusters": ch["clusters"],
                 "ms": ch["ev"][0].elapsed_time(ch["ev"][1])}
                for ch in rec.chunks]
    # (b) the first chunk of each bucket, whole, timed
    by_bucket = {}
    for cmax, w in sorted(rec.whole.items()):
        sizes = w["sizes"].cpu().numpy()
        C, W = w["Dq"].shape[0], w["Dq"].shape[2]
        runs, st = _chunk_runs(cluster, cluster_cuda.build_chunk, w, cmax)
        steps0, levels0 = cluster.STEPS, cluster.BFS_LEVELS
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        made, put_back = _kept_states(cluster)
        try:
            cluster.build_clusters_plain(w["Dq"], w["cd"], w["cid"],
                                         w["lens"], sizes, cmax)
        finally:
            put_back()
        ev[1].record()
        torch.cuda.synchronize()
        steps = cluster.STEPS - steps0
        levels = cluster.BFS_LEVELS - levels0
        diff = _bits_diff({f: getattr(st, f) for f in six}, made[0][0], six)
        check(not diff, f"dc_cluster_build, bucket {cmax}: {diff} != plain")
        plan = cluster_cuda.kernel_plan(cmax, w["Dq"].dtype)
        rec_b = with_share({"clusters": C, "cmax": cmax, "W": W,
                            "members": int(sizes.sum()), "steps": steps,
                            "plain_bfs_levels": levels,
                            "plan": dict(zip(("kind", "threads",
                                              "clusters_per_block",
                                              "smem_bytes"), plan)),
                            "ms": _median(runs), "runs_ms": runs,
                            "plain_ms": ev[0].elapsed_time(ev[1])},
                           chunk_bound(cluster, w, cmax))
        if plan[0] == "global":
            floor = (5 * steps + 2 * levels) * l2
        else:
            floor = 2 * l2 + (6 * steps + 2 * levels) * shm
        rec_b["latency_floor_ms"] = floor
        rec_b["share_of_latency_floor"] = floor / rec_b["ms"]
        if par_cuda is not None:
            turns = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                build = (par_cuda.build_chunk if who == "parent"
                         else cluster_cuda.build_chunk)
                times, got = _chunk_runs(cluster, build, w, cmax)
                turns[who].append(_median(times))
                diff = _bits_diff({f: getattr(got, f) for f in six}, st, six)
                check(not diff, f"bucket {cmax}: the parent's kernel 8b and "
                      f"this one's differ in {diff}")
            rec_b["in_turns"] = {k: float(np.mean(v))
                                 for k, v in turns.items()}
        by_bucket[str(cmax)] = rec_b
    # (c) the streamed cluster
    streams = []
    for s in rec.streams:
        rb, size, cmax = s["row_block"], s["size"], s["cmax"]
        blocks = s["blocks"]

        def block_fn(start):
            return blocks[start // rb]

        def route(build):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            got = build(block_fn, s["cd"], s["cid"], s["lens"], size, cmax,
                        rb)
            ev[1].record()
            torch.cuda.synchronize()
            return ev[0].elapsed_time(ev[1]), got

        made, put_back = _kept_states(cluster, "one_cluster")
        try:
            route_ms, got = route(cluster.build_streamed)
        finally:
            put_back()
        check(all(torch.equal(a, b) for a, b in zip(got, s["got"])),
              "the streamed cluster built again by its kernel differs from "
              "the run's")
        kst, kfl = made[0]
        # the plain route member by member, kernel 8a on a copy now and then
        st, flags = cluster.one_cluster(*cluster.cluster_init_state(
            s["cd"][None], s["cid"][None], s["lens"][None], cmax,
            with_adj=True))
        order = cluster._Order.of(cmax, st.e.device)
        kq_w = (size - 1) // rb * rb
        window = min(64, size - kq_w)
        checked, window_bytes = 0, 0
        t0 = time.perf_counter()
        for kq in range(size):
            row = blocks[kq // rb][kq % rb]
            if kq == kq_w:
                snap = (state_clone(st), flags.clone())
                torch.cuda.synchronize()
                tw = time.perf_counter()
            if kq_w <= kq < kq_w + window:
                window_bytes += member_bytes(st, flags)
            probe = kq % DC_SAMPLE == 0 or kq == size - 1
            if probe:
                cst, cfl = state_clone(st), flags.clone()
                j = kq % rb
                out_i, out_f = cluster_cuda.stream_block(
                    cst, cfl, blocks[kq // rb][j:j + 1], kq, cmax)
            eid, frac, add = cluster.stream_member_plain(st, flags, row, kq,
                                                         cmax, order)
            if kq == kq_w + window - 1:
                torch.cuda.synchronize()
                window_plain_ms = (time.perf_counter() - tw) * 1e3
            if probe:
                cst.idx = st.idx
                want_f = torch.stack((frac, add))
                bits = (torch.int32 if want_f.dtype == torch.float32
                        else torch.int64)
                diff = state_diff(cst, st)
                check(int(out_i[0]) == eid and not diff
                      and torch.equal(out_f.view(bits), want_f.view(bits))
                      and torch.equal(cfl, flags),
                      f"dc_stream_block != plain at streamed member {kq} "
                      f"({diff})")
                checked += 1
        torch.cuda.synchronize()
        plain_route_ms = (time.perf_counter() - t0) * 1e3
        diff = state_diff(kst, st)
        check(not diff and torch.equal(kfl, flags),
              f"the streamed cluster: kernel route != plain route in {diff}")
        # the window: one launch (16 and 8 blocks), and a graph of one-member
        # launches of the same kernel
        rows_w = torch.stack([blocks[(kq_w + j) // rb][(kq_w + j) % rb]
                              for j in range(window)])

        def fresh():
            return state_clone(snap[0]), snap[1].clone()

        def one_launch(ctas):
            copies = [fresh() for _ in range(5)]
            runs = queued_each_ms([
                lambda c=c, f=f: cluster_cuda.stream_block(
                    c, f, rows_w, kq_w, cmax, ctas=ctas) for c, f in copies])
            return _median(runs[1:]), *copies[-1]

        ms, c16, f16 = one_launch(cluster_cuda.STREAM_CTAS)
        ms8, c8, f8 = one_launch(8)
        gst, gfl = fresh()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            for j in range(window):
                cluster_cuda.stream_block(gst, gfl, rows_w[j:j + 1],
                                          kq_w + j, cmax)
        torch.cuda.current_stream().wait_stream(side)
        graph_runs = []
        for _ in range(5):
            restore(gst, snap[0])
            gfl.copy_(snap[1])
            graph_runs += queued_each_ms([graph.replay])
        for tag, (c, f) in (("8 blocks", (c8, f8)), ("the graph",
                                                        (gst, gfl))):
            diff = state_diff(c, c16)
            check(not diff and torch.equal(f, f16),
                  f"the streamed window by {tag} differs from one launch "
                  f"on {cluster_cuda.STREAM_CTAS} blocks in {diff}")
        rec_s = with_share(
            {"members": size, "cmax": cmax, "row_block": rb,
             "members_checked": checked, "window_first_member": kq_w,
             "window_members": window, "ctas": cluster_cuda.STREAM_CTAS,
             "ms": ms, "ms_8_blocks": ms8,
             "graph_of_one_member_launches_ms": _median(graph_runs),
             "plain_ms": window_plain_ms,
             "ms_per_member": ms / window,
             "route_ms": route_ms, "route_ms_per_member": route_ms / size,
             "plain_route_ms": plain_route_ms,
             "plain_route_ms_per_member": plain_route_ms / size},
            bound_of(0, window_bytes))
        rec_s["latency_floor_ms"] = window * 5 * l2
        rec_s["share_of_latency_floor"] = rec_s["latency_floor_ms"] / ms
        if par_cluster is not None:
            turns = {"parent": [], "this": []}
            route(par_cluster.build_streamed)  # loads its kernels
            for who in ("parent", "this", "this", "parent"):
                build = (par_cluster.build_streamed if who == "parent"
                         else cluster.build_streamed)
                t, out = route(build)
                turns[who].append(t)
                check(all(torch.equal(a, b) for a, b in zip(out, s["got"])),
                      f"the streamed cluster by the {who}'s route differs")
            rec_s["in_turns_route_ms_per_member"] = {
                k: float(np.mean(v)) / size for k, v in turns.items()}
        streams.append(rec_s)
    res = {"dc_cluster_build": {"by_bucket": by_bucket, "launches": launches,
                                "clusters_checked": sampled},
           "dc_stream_block": {"streamed": streams},
           "l2_round_trip_ms": l2, "shared_round_trip_ms": shm}
    emit({"phase": "kernel_vs_plain", "kernel": "dc_stream_block and "
          "dc_cluster_build", "comparison": "bit for bit on the D&C main "
          "path's inputs", **res, "max_abs_err": 0.0})
    return res


def phase_dc_step_profiled(cmax: int = 16) -> dict:
    """One batched build at 64 and at 1,024 clusters (made-up distances
    and witness lists) under torch.profiler, by kernel 8b and by its
    plain version: the kernel route is one dc_cluster_build launch and no
    host sync a build; the plain route's launches per step do not grow
    with the clusters."""
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.dc import cluster, cluster_cuda

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
        res[C] = {}
        for route, build in (("kernel", cluster.build_clusters),
                             ("plain", cluster.build_clusters_plain)):
            def run():
                return build(Dq, cd, cid, lens, sizes, cmax)

            want = run()
            torch.cuda.synchronize()
            steps0, levels0 = cluster.STEPS, cluster.BFS_LEVELS
            builds0 = cluster_cuda.CLUSTER_BUILD_LAUNCHES
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                got = run()
                torch.cuda.synchronize()
            steps = cluster.STEPS - steps0
            levels = cluster.BFS_LEVELS - levels0
            count = {e.key: e.count for e in prof.key_averages()}
            kernels = sum(c for k, c in count.items()
                          if re.search(r"cluster_(warp|block|global)_kernel",
                                       k))
            res[C][route] = {
                "steps": steps, "bfs_levels": levels,
                "dc_cluster_build_launches":
                    cluster_cuda.CLUSTER_BUILD_LAUNCHES - builds0,
                "dc_cluster_build_kernels_profiled": kernels,
                "launches": count.get("cudaLaunchKernel", 0),
                "launches_per_step": count.get("cudaLaunchKernel", 0)
                / steps,
                "stream_syncs": count.get("cudaStreamSynchronize", 0),
                "stream_syncs_per_step":
                    count.get("cudaStreamSynchronize", 0) / steps,
                "memcpys_per_step": count.get("cudaMemcpyAsync", 0) / steps,
                "bfs_levels_per_step": levels / steps}
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"phase-3 build at {C} clusters ({route}) differs between "
                  "two runs")
        k = res[C]["kernel"]
        check(k["dc_cluster_build_launches"] == 1 and k["bfs_levels"] == 0
              and k["stream_syncs"] == 0,
              f"a batched build at {C} clusters by kernel 8b: "
              f"{k['dc_cluster_build_launches']} launches, "
              f"{k['bfs_levels']} BFS levels, {k['stream_syncs']} syncs")
    lo = res[64]["plain"]["launches_per_step"]
    hi = res[1024]["plain"]["launches_per_step"]
    check(hi < 2 * lo, f"launches per phase-3 step grew with the clusters: "
          f"{lo} at 64, {hi} at 1,024")
    emit({"phase": "dc_step_profiled", "cmax": cmax,
          "by_clusters": {str(k): v for k, v in res.items()}})
    return res


def exact_clone(st):
    """A copy of an exact state on its device (its own stepper)."""
    import dataclasses

    from dipper_tpu_torch.placement import exact_cuda
    from dipper_tpu_torch.placement.exact_model import FIELDS

    return exact_cuda.prepare_stepper(dataclasses.replace(
        st, **{f: getattr(st, f).clone() for f in FIELDS}))


def exact_diff(a, b) -> list:
    """What two exact states differ in, bit for bit: idx and the names of
    the arrays (adj too)."""
    from dipper_tpu_torch.placement.exact_model import FIELDS

    out = [] if a.idx == b.idx else ["idx"]
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            bits = torch.int32 if x.dtype == torch.float32 else torch.int64
            x, y = x.view(bits), y.view(bits)
        if x.shape != y.shape or not torch.equal(x, y):
            out.append(f)
    return out


def plain_exact_step(st, row, i: int, N: int) -> int:
    """Insertion i by the plain version on the card; returns its choice."""
    from dipper_tpu_torch.placement import exact

    maxdep = exact._max_depth(st)
    lim = exact._compute_lims(st, row, N, maxdep)
    eid, frac, add = exact._score_exact(st, lim)
    exact._splice_exact(st, eid, frac, add, i, N, maxdep)
    return int(eid)


def exact_vs_plain(st, rows, lo: int, k: int, N: int) -> dict:
    """Insertions lo .. lo + k - 1 (rows[j]: lo + j) from copies of `st`:
    one by the kernel route launch by launch, one by the plain version on
    the card; the choices and every array equal after each insertion, and
    how many of the launches took the whole cluster (the launch before
    found at least CLUSTER_LEVELS levels wider than WIDE; the first launch
    of a new stepper is block 0's). `st` is left as it was."""
    from dipper_tpu_torch.placement import exact, exact_cuda

    a, b = exact_clone(st), exact_clone(st)
    on_cluster = 0
    for j in range(k):
        i = lo + j
        prev = exact_cuda.last_out(a)["wide_levels"]
        on_cluster += prev >= exact_cuda.CLUSTER_LEVELS
        exact.run_exact_range(a, i, i + 1, rows[j:j + 1], N)
        out = exact_cuda.last_out(a)
        eid = plain_exact_step(b, rows[j], i, N)
        check(out["status"] == 0, f"exact_step at insertion {i}: {out}")
        check(out["eid"] == eid, f"exact_step chose slot {out['eid']} at "
              f"insertion {i}, the plain version {eid}")
        diff = exact_diff(a, b)
        check(not diff, f"exact_step at insertion {i} differs from the "
              f"plain version in {diff}")
        check(torch.equal(a.stepper.rec, exact_cuda.node_records(b)),
              f"exact_step at insertion {i}: the node records kept by its "
              f"splices differ from the plain state's")
    return {"lo": lo, "insertions": k, "choices_equal": True,
            "states_equal": True, "records_equal": True,
            "launches_on_cluster": on_cluster}


def exact_times(st, rows, lo: int, N: int) -> dict:
    """On copies of `st`: exact_step's time an insertion (one replay of
    the state's graph of exact_cuda.GRAPH_INSERTIONS launches between CUDA
    events, the median of three), the plain version's on the card (8
    insertions), the first launch's record (the tree's greatest depth,
    positions, the depth shift's levels and nodes) and the kernel's bound
    from the bytes this insertion must move and its latency floor
    ((3 maxdep + shift levels) dependent L2 round trips)."""
    from dipper_tpu_torch.placement import exact, exact_cuda

    G = exact_cuda.GRAPH_INSERTIONS
    check(rows.shape[0] >= G, f"{rows.shape[0]} rows for a graph of {G}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = []
    for _ in range(3):
        c = exact_clone(st)
        graph = exact_cuda.range_graph(c)
        exact_cuda.set_cursor(c, lo, rows, lo)
        torch.cuda.synchronize()
        ev[0].record()
        graph.graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]) / G)
    c = exact_clone(st)
    exact.run_exact_range(c, lo, lo + 1, rows[:1], N)
    out = exact_cuda.last_out(c)
    k = 8
    c = exact_clone(st)
    torch.cuda.synchronize()
    ev[0].record()
    for j in range(k):
        exact.run_exact_range(c, lo + j, lo + j + 1, rows[j:j + 1], N,
                              plain=True)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1]) / k
    T = st.length.element_size()
    used, P = st.idx, out["positions"]
    leaves = used // 4 + 1
    # read: each used slot's length (both directions), each downward
    # slot's e and rev (an upward slot is reached through its downward
    # slot's rev), each node's adjacency row, each leaf's row entry, the
    # choice's belong and its ends' depths; written: the six slots (e,
    # rev, length), four belong, the three parents, the two new depths and
    # adjacency rows, the shifted depths and the cursor
    nbytes = (used * T + (used // 2) * 8 + P * 12 + leaves * T + 12
              + 6 * (8 + T) + 16 + 12 + 8 + 24 + 4 * out["shift_nodes"]
              + 16)
    # a subtraction and a maximum a child in the up-sweep, four operations
    # an incident edge in the down-sweep, edge_score's 13 a downward edge
    ops = (P - 1) * (2 + 8 + 13)
    peak = PEAK_F32_PER_S if T == 4 else PEAK_F32_PER_S / 2
    bound = bound_of(ops, nbytes, peak)
    trip = l2_round_trip_ms()
    floor = (3 * out["maxdep"] + out["shift_levels"]) * trip
    kms = sorted(ms)[1]
    return {"lo": lo, "ms": kms, "ms_runs": ms, "plain_ms": plain_ms,
            "launch_record": out, "slots_used": used, **bound,
            "share_of_bound": bound["bound_ms"] / kms,
            "l2_round_trip_ms": trip, "latency_floor_ms": floor,
            "share_of_latency_floor": floor / kms}


def exact_parts(st, rows, lo: int) -> dict:
    """Each run of EXACT_PART_RUNS (exact_cuda.stamped_parts) on
    EXACT_PARTS insertions of `st` from lo: where an insertion's cycles go
    at each launch shape, and the level widths of the tree (printed, with
    the launch shape and one cluster barrier's cost)."""
    from dipper_tpu_torch.placement import exact_cuda

    k = min(EXACT_PARTS, rows.shape[0] - 1)
    res = {name: exact_cuda.stamped_parts(st, rows, lo, k, **shape)
           for name, shape in EXACT_PART_RUNS}
    widths = res["cluster"]["level_widths"]
    check(res["block0"]["level_widths"] == widths, "the two launch shapes "
          "walked different level orders")
    print(f"exact level widths at lo={lo} (depth {len(widths) - 1}, "
          f"max {max(widths)}): {widths}", flush=True)
    for name, r in res.items():
        print(f"exact stamped parts, {name} (us at "
              f"{r['sm_clock_mhz']:.0f} MHz): "
              + ", ".join(f"{p} {v:.2f}" for p, v in r["us"].items())
              + f"; total {r['us_total']:.2f}", flush=True)
        print(f"  {name} by level, cycles = a + b x width: " + "; ".join(
            f"{p} a {v['fixed_cycles']:.0f} b {v['cycles_a_position']:.2f}"
            for p, v in r["by_level"].items()), flush=True)
        # each pass's us on the levels wider than W and on the others
        r["us_by_width"] = {
            p: {kind: sum(c for c, x in zip(v["cycles_by_level"], widths)
                          if (x > exact_cuda.WIDE) == (kind == "wide"))
                / r["sm_clock_mhz"] for kind in ("wide", "narrow")}
            for p, v in r["by_level"].items()}
        print(f"  {name} us on levels wider than W / the others: "
              + "; ".join(f"{p} {v['wide']:.2f} / {v['narrow']:.2f}"
                          for p, v in r["us_by_width"].items()), flush=True)
    barrier = exact_cuda.cluster_sync_us()
    print(f"exact_step launch shape: C = {exact_cuda.CLUSTER_CTAS} blocks "
          f"of {exact_cuda.THREADS} threads, W = {exact_cuda.WIDE}; one "
          f"cluster barrier (us): {barrier}", flush=True)
    return {"runs": res, "level_widths": widths,
            "levels_wider_than": {w: sum(x > w for x in widths)
                                  for w in (32, 128, 512, 2048)},
            "cluster_barrier_us": barrier,
            "shape": {"ctas": exact_cuda.CLUSTER_CTAS,
                      "threads": exact_cuda.THREADS,
                      "wide": exact_cuda.WIDE}}


def exact_graph_ms(c, rows, lo: int, mod=None) -> float:
    """One replay of the graph of GRAPH_INSERTIONS launches of a copy `c`
    of a state from insertion lo (rows[j]: lo + j) between CUDA events, in
    ms an insertion; `mod` is the exact_cuda module that launches (this
    checkout's, or an earlier one's, whose stepper `c` then carries)."""
    from dipper_tpu_torch.placement import exact_cuda

    mod = mod or exact_cuda
    graph = mod.range_graph(c)
    mod.set_cursor(c, lo, rows, lo)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    graph.graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    check(int(c.stepper.out[-1]) == 0, f"a timed graph failed: "
          f"{c.stepper.out.tolist()}")
    return ev[0].elapsed_time(ev[1]) / mod.GRAPH_INSERTIONS


def exact_in_turns(parent: str, st, rows, lo: int) -> dict:
    """The earlier checkout's exact_step (its placement/exact_cuda.py on
    copies of `st`, which build and load its own kernel) and this one's,
    one graph of GRAPH_INSERTIONS insertions each, in turns: parent, this,
    this, parent (ms an insertion, the mean of each's two turns)."""
    import dataclasses

    from dipper_tpu_torch.placement.exact_model import FIELDS

    mod = parent_module(parent, "placement.exact_cuda")
    turns = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        if who == "this":
            turns[who].append(exact_graph_ms(exact_clone(st), rows, lo))
            continue
        c = dataclasses.replace(st, **{f: getattr(st, f).clone()
                                       for f in FIELDS})
        mod.prepare_stepper(c)
        turns[who].append(exact_graph_ms(c, rows, lo, mod))
    res = {f"{k}_ms": sum(v) / len(v) for k, v in turns.items()}
    res["turns"] = turns
    print(f"exact_step in turns at lo={lo}: {res}", flush=True)
    return res


def exact_route_profiled(D, n: int) -> dict:
    """The kernel route at the end of an n-taxon build of D (f64 on the
    card): a range of 2 x GRAPH_INSERTIONS + 7 insertions (after a range
    that captured the state's graph) under sync_debug_mode "error" (no
    host sync), then the same insertions on a copy under torch.profiler:
    exact_step launches an insertion (the counter and the card's kernel
    records), the host's graph launches, kernel launches, copies and syncs,
    the device busy time an insertion."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dipper_tpu_torch.placement import exact, exact_cuda, insert_cuda

    G = exact_cuda.GRAPH_INSERTIONS
    k = 2 * G + 7
    lo = n - k
    st = exact.init_exact_state((D,), num_sequences=n, frontend="matrix",
                                dtype_name="float64")
    exact.run_exact_range(st, 2, lo, D[2:lo], n)
    snap = exact_clone(st)
    torch.cuda.synchronize()
    launches, replays = (exact_cuda.EXACT_STEP_LAUNCHES,
                         insert_cuda.GRAPH_REPLAYS)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exact.run_exact_range(st, lo, n, D[lo:n], n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per = (exact_cuda.EXACT_STEP_LAUNCHES - launches) / k
    check(per == 1.0 and insert_cuda.GRAPH_REPLAYS - replays == 2,
          f"the range launched exact_step {per} times an insertion and "
          f"replayed {insert_cuda.GRAPH_REPLAYS - replays} graphs")
    exact_cuda.range_graph(snap)   # captured before the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exact.run_exact_range(snap, lo, n, D[lo:n], n)
        torch.cuda.synchronize()
    diff = exact_diff(snap, st)
    check(not diff, f"the profiled range differs from the checked one in "
          f"{diff}")
    ka = prof.key_averages()
    count = {e.key: e.count for e in ka}
    on_dev = [e for e in ka if e.device_type != DeviceType.CPU]
    records = sum(e.count for e in on_dev if "exact_step_kernel" in e.key)
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3 / k
    return {"lo": lo, "insertions": k, "graph_insertions": G,
            "exact_step_launches_per_insertion": per,
            "host_syncs_in_range": 0,
            "ms_per_insertion_sync_checked": wall_ms / k,
            "device_exact_step_records_per_insertion": records / k,
            "cudaGraphLaunch": count.get("cudaGraphLaunch", 0),
            "cudaLaunchKernel_per_insertion":
                sum(count.get(key, 0) for key in LAUNCH_KEYS) / k,
            "memcpys_per_insertion": count.get("cudaMemcpyAsync", 0) / k,
            "stream_syncs_per_insertion":
                count.get("cudaStreamSynchronize", 0) / k,
            "device_busy_ms_per_insertion": busy,
            "device_busy_share": busy / (wall_ms / k)}


def phase_exact(tmp: str, fa: str, n: int, window: int = EXACT_WINDOW,
                small: int = 512, parent: str | None = None) -> dict:
    """Exact placement on the card, f64: the alignment's first n sequences
    through build_placement_tree_from_seqs(exact=True) and their distance
    matrix through build_placement_tree_from_matrix(exact=True), and both
    at their first `small` taxa on the card and on the CPU; the kernel route
    against the plain route on the card in windows; the kernel route's
    launches, copies and syncs an insertion; kernel and plain times."""
    from dipper_tpu_torch.distance import msa
    from dipper_tpu_torch.io.fasta import read_fasta
    from dipper_tpu_torch.placement import api, exact
    from dipper_tpu_torch.utils.params import Param

    names, seqs = read_fasta(fa)
    names, seqs = names[:n], seqs[:n]
    Dc = msa.msa_distance_matrix(load_codes(fa, n), 1, "float64", "cuda")
    D = Dc.cpu().numpy()

    def build(frontend: str, size: int, dev: str) -> tuple:
        logs = []
        p = Param(in_format="m" if frontend == "msa" else "d",
                  dtype="float64")
        t0 = time.time()
        if frontend == "msa":
            nwk = api.build_placement_tree_from_seqs(
                seqs[:size], names[:size], p, device=torch.device(dev),
                exact=True, log=logs.append)
        else:
            nwk = api.build_placement_tree_from_matrix(
                D[:size, :size], names[:size], p, device=torch.device(dev),
                exact=True, log=logs.append)
        wall = time.time() - t0
        per = [float(m.group(1)) for ln in logs
               for m in [re.search(r"\(([\d.]+) ms/insertion\)", ln)] if m]
        return nwk, wall, per[0]

    res, trees = {}, {}
    # (frontend, taxa, built on the CPU too): the CPU's plain version takes
    # 15-30 ms an insertion at 2,048, so both builds are held to the CPU at
    # `small`, and at n the card's builds to each other
    for frontend, size, on_cpu in (("msa", small, True),
                                   ("matrix", small, True),
                                   ("matrix", n, False), ("msa", n, False)):
        reset_counts()
        gpu, gpu_s, gpu_ms = build(frontend, size, "cuda")
        counts = read_counts()
        check(counts["exact_step"] == size - 2, f"exact placement "
              f"({frontend}, {size}) launched exact_step "
              f"{counts['exact_step']} times for {size - 2} insertions")
        check(gpu.count(",") == size - 1, "exact placement: incomplete tree")
        trees[frontend, size] = gpu
        rec = {"ms_per_insertion": {"cuda": gpu_ms}, "wall_s": {"cuda": gpu_s},
               "kernel_launches": {k: v for k, v in counts.items() if v}}
        if on_cpu:
            cpu, cpu_s, cpu_ms = build(frontend, size, "cpu")
            check(gpu == cpu, f"exact placement ({frontend}, {size}, f64): "
                  "the card's Newick differs from the CPU's")
            rec.update(newick_identical_gpu_cpu=True)
            rec["ms_per_insertion"]["cpu"] = cpu_ms
            rec["wall_s"]["cpu"] = cpu_s
        res[f"{frontend}_{size}"] = rec
    # the same distances row by row (the matrix's diagonal is zeroed, and
    # an insertion reads no row entry of its own)
    res["same_newick_from_both_frontends"] = (
        trees["msa", n] == trees["matrix", n])
    # the kernel route against the plain route on the card, state for
    # state, in windows at the start, the middle and the end of a build
    st = exact.init_exact_state((Dc,), num_sequences=n, frontend="matrix",
                                dtype_name="float64")
    pos, windows = 2, []
    for lo in (2, n // 2, n - window):
        exact.run_exact_range(st, pos, lo, Dc[pos:lo], n)
        windows.append(exact_vs_plain(st, Dc[lo:lo + window], lo, window,
                                      n))
        exact.run_exact_range(st, lo, lo + window, Dc[lo:lo + window], n)
        pos = lo + window
    res["kernel_vs_plain_windows"] = windows
    res["greatest_depth"] = exact._max_depth(st)
    G = 64
    lo = n - G - 8
    st = exact.init_exact_state((Dc,), num_sequences=n, frontend="matrix",
                                dtype_name="float64")
    exact.run_exact_range(st, 2, lo, Dc[2:lo], n)
    res["times_at_end"] = exact_times(st, Dc[lo:lo + G], lo, n)
    res["times_at_end"]["parts"] = exact_parts(st, Dc[lo:lo + G], lo)
    if parent:
        res["times_at_end"]["in_turns"] = exact_in_turns(
            parent, st, Dc[lo:lo + G], lo)
    res["route_profiled"] = exact_route_profiled(Dc, n)
    emit({"phase": "exact_placement", "n": n, "small": small,
          "precision": "f64", "distance_type": 1, **res})
    return res


def phase_exact_main_path(tmp: str, n: int, fa: str, true_nwk: str,
                          parent: str | None = None) -> dict:
    """The CLI's exact path (-i r -m 0, default flags: f32) on phase 5's
    set: time to tree, ms an insertion, exact_step's launches, nRF vs the
    true tree; the ingest's device route; then EXACT_SAMPLE insertions of
    its last range re-run from a copy of the state by the kernel route and
    by the plain version on the card (choices and states equal), and the
    kernel's time there beside the plain version's and its bounds."""
    from dipper_tpu_torch.placement import exact

    out = os.path.join(tmp, f"n{n}.exact.nwk")
    last = {}
    run_range = exact.run_exact_range

    def range_kept(st, lo, hi, rows, num_sequences, plain=False):
        # the last range's state and first rows, kept for the checks after
        # the run (device copies, no host sync)
        if hi == num_sequences and not last:
            last.update(lo=lo, st=exact_clone(st), N=num_sequences,
                        rows=rows[:max(EXACT_SAMPLE, 64)].clone())
        return run_range(st, lo, hi, rows, num_sequences, plain)

    sketches = SketchSampler()
    exact.run_exact_range = range_kept
    try:
        reset_counts()
        rc, log, wall = run_cli(["-i", "r", "-I", fa, "-O", out, "-m", "0"])
        counts = read_counts()
    finally:
        exact.run_exact_range = run_range
        sketches.restore()
    check(rc == 0, f"exact CLI returned {rc}")
    check("Using exact placement mode" in log, "-m 0 at N = 30,000 did not "
          "take exact placement")
    check(counts["exact_step"] == n - 2, f"exact CLI launched exact_step "
          f"{counts['exact_step']} times for {n - 2} insertions")
    check(counts["mash_merge_count"] > 0, "exact CLI launched no merge-count "
          "kernel for its rows")
    ingest = check_device_ingest("exact CLI", counts, log, sketches)
    rf, nrf = check_tree(open(out).read(), n, true_nwk, NRF_LIMIT)
    per = [float(m.group(1)) for m in re.finditer(
        r"Inserted \d+/\d+ \(([\d.]+) ms/insertion\)", log)]
    check(bool(last), "the exact CLI's last range was not seen")
    st, rows, lo, N = last["st"], last["rows"], last["lo"], last["N"]
    k = min(EXACT_SAMPLE, rows.shape[0])
    sample = exact_vs_plain(st, rows, lo, k, N)
    check(sample["launches_on_cluster"] == k - 1, f"of {k} sampled launches "
          f"at 30K, {sample['launches_on_cluster']} took the whole cluster "
          f"(every one after the first should)")
    times = exact_times(st, rows, lo, N)
    times["parts"] = exact_parts(st, rows, lo)
    if parent:
        times["in_turns"] = exact_in_turns(parent, st, rows, lo)
    rec = {"phase": "exact_main_path", "n": n, "argv": "-i r -m 0",
           "precision": "f32", "time_to_tree_s": wall,
           "ms_per_insertion_by_range": per,
           "insert_ranges": len(per), "rf": rf, "nrf": nrf,
           "counts": {k2: v for k2, v in counts.items() if v},
           "ingest_sketch_checked": ingest, "sample_vs_plain": sample,
           "times_last_range": times,
           "log_times_ms": {key: _ms(rf"{key} in: (\d+) ms", log)
                            for key in ("Input", "Sketch", "Rank bank",
                                        "Tree Created")}}
    emit(rec)
    return {**rec, "counts": counts}


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
    plain splice and BFS stepped; both compared as they happen), and the
    cursor route's replays at graph borders (RouteSampler: each border
    checked counts as a launch of both kernels checked). The plain
    versions launch none of the port's kernels."""

    def __init__(self):
        from dipper_tpu_torch.distance import mash_cuda
        from dipper_tpu_torch.placement import insert_cuda, kclosest

        self.mc, self.kc, self.ic = mash_cuda, kclosest, insert_cuda
        self.orig = (mash_cuda.mash_inter_cuda, mash_cuda.mash_rows_dist_cuda,
                     mash_cuda.mash_cluster_inter_cuda,
                     kclosest.score_edges_launch, insert_cuda.insert_step)
        inter, rows_dist, cluster, score, insert = self.orig
        self.calls = {"mash_merge_count": [], "mash_rows_dist": [],
                      "mash_cluster_inter": []}
        self.sketch = SketchSampler()
        self.score = {"calls": 0, "checked": 0, "max_abs_err": 0.0}
        self.insert = {"calls": 0, "checked": 0, "max_abs_err": 0.0}
        self.route = RouteSampler()

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
                       stream=None):
            sample = self.insert["calls"] % SIDE_SAMPLE == 0
            self.insert["calls"] += 1
            pl = state_clone(st) if sample else None
            xy = insert(st, eid, frac, add, middle=middle, outside=outside,
                        label=label, stream=stream)
            if sample:
                kclosest.splice(pl, int(eid.reshape(())), frac.reshape(()),
                                add.reshape(()), 0, 0, middle=middle,
                                outside=outside)
                kclosest._update_closest_bfs_compact(
                    pl, outside, pl.adj.shape[0], label)
                self.insert["checked"] += 1
                if state_diff(st, pl):
                    self.insert["max_abs_err"] = float("inf")
            return xy

        (mash_cuda.mash_inter_cuda, mash_cuda.mash_rows_dist_cuda,
         mash_cuda.mash_cluster_inter_cuda, kclosest.score_edges_launch,
         insert_cuda.insert_step) = (inter_rec, rows_rec, cluster_rec,
                                     score_rec, insert_rec)

    def finish(self) -> dict:
        """Restores the entry points and compares the recorded launches;
        returns per kernel the launches checked and the largest
        difference."""
        from dipper_tpu_torch.distance.mash import (cluster_inter_ref,
                                                    merged_inter_count_ref)

        (self.mc.mash_inter_cuda, self.mc.mash_rows_dist_cuda,
         self.mc.mash_cluster_inter_cuda, self.kc.score_edges_launch,
         self.ic.insert_step) = self.orig
        self.route.restore()
        for _, err, diff in self.route.errs:
            self.score["checked"] += 1
            self.score["max_abs_err"] = max(self.score["max_abs_err"], err)
            self.insert["checked"] += 1
            if diff:
                self.insert["max_abs_err"] = float("inf")
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
        out["minhash_sketch"] = self.sketch.finish()
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
        check_nj_launches(f"NJ rank {r}", got["counts"], nj["n"], half=False)
        check_nj_mode(f"NJ rank {r}", got["log"], "full")
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
        p2 = phase2_line(got["log"])
        check(c["dc_assign"] == p2["chunks"] > 0 and p2["route"] == "kernel",
              f"D&C rank {r}: dc_assign {c['dc_assign']} launches for its "
              f"{p2['chunks']} phase-2 chunks")
        check_one_pack(f"D&C rank {r}", c, p2)
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


def sketch_select_cases(parent_kernel=None) -> dict:
    """The kernel's select-path cases, one batch each at k = 15, against
    the plain version on the card and the native sketcher: one 200 kb row
    (B = 1, split into segments), rows shorter than k beside normal ones,
    poly-A rows (every window one hash) and a 4-periodic row, one 10 kb
    row, one 2 Mbp row; s 1, 1,000, 1,024 and 2^20 (the tile path). Each
    with the plan's path and lists a row, and its CUDA-event time; with
    `parent_kernel` (an earlier checkout's minhash_cuda), that kernel's
    result held to this one's and both timed in turns: parent, this,
    this, parent, 5 calls each, with scratch and output made before."""
    from dipper_tpu_torch.sketch import minhash_cuda
    from dipper_tpu_torch.sketch.native import sketch_sequences_native

    rng = np.random.default_rng(124)

    def acgt(L):
        return bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))

    sets = {"row_200kb": [acgt(200_000)],
            "short_rows": [b"", acgt(7), acgt(14), acgt(15), acgt(10_000)],
            "poly_a": [b"A" * 10_000, b"A" * 4111, b"ACGT" * 2500],
            "b1": [acgt(10_000)], "row_2mb": [acgt(2_000_000)]}
    cases = {}
    for name, seqs in sets.items():
        words, lens = _on_card(*pack_rows(seqs, 15))
        for s in (1, 1000, 1024, 1 << 20):
            got = minhash_cuda.minhash_sketch_cuda(words, lens, k=15,
                                                   sketch_size=s)
            plain, plain_ms = plain_sketch_on_card(seqs, 15, s)
            native = sketch_sequences_native(seqs, 15, s)
            check(native is not None, "native sketcher unavailable")
            err = max(u64_err(got, plain), u64_err(got, native))
            check(err == 0.0, f"sketch kernel {name} s={s}: != plain or "
                  f"native (max abs err {err})")
            select, lists, _, rounds = minhash_cuda.plan(
                words.shape[0], words.shape[1], 15, s)
            cases[f"{name}_s{s}"] = rec = {
                "rows": len(seqs), "path": "select" if select else "tiles",
                "lists_a_row": lists, "merge_rounds": len(rounds),
                "equal": True, "plain_ms": plain_ms,
                "ms": event_ms(lambda: minhash_cuda.minhash_sketch_cuda(
                    words, lens, k=15, sketch_size=s), 5)}
            if parent_kernel is not None:
                B, W = words.shape
                runs = {}
                for who, mod in (("this", minhash_cuda),
                                 ("parent", parent_kernel)):
                    scr = torch.empty(mod.scratch_elems(B, W, 15, s),
                                      dtype=torch.int64, device="cuda")
                    out = torch.empty((B, s), dtype=torch.int64,
                                      device="cuda")
                    runs[who] = (lambda fn=mod.minhash_sketch_cuda,
                                 scratch=scr, o=out: fn(
                                     words, lens, k=15, sketch_size=s,
                                     scratch=scratch, out=o))
                check(torch.equal(runs["parent"](), got),
                      f"{name} s={s}: the parent's sketch kernel != this "
                      "one")
                turns = {"parent": 0.0, "this": 0.0}
                for who in ("parent", "this", "this", "parent"):
                    turns[who] += event_ms(runs[who], 5) / 2
                rec["parent_ms"] = turns["parent"]
                rec["this_ms_in_turns"] = turns["this"]
                del runs
    return cases


def time_sketch_set(tag: str, seqs, sass: dict, k: int = 15,
                    s: int = 1000, check_rank_rule: bool = False,
                    parent_kernel=None) -> dict:
    """The device ingest of one set and its parts on their own:
    sketch_sequences (host wall, synchronized), the host's encode/pack,
    each batch's H2D copy, the kernel's own time by CUDA events (both
    stages; stage 1, the select kernel; stage 2, the merge rounds, none
    at these shapes; stage 1's hashing alone), rank_compress and
    rank_compress_dense; beside them the native host sketcher and
    rank_compress_host (the host route), the plain version on the card
    and torch.sort along rows of the set's [rows, windows] hash matrix
    (the yardstick). With `parent_kernel` (an earlier checkout's
    minhash_sketch_cuda), that kernel timed in turns with this one on
    each batch: parent, this, this, parent. The bank is held bitwise to
    the native one, to the plain version and to the sorted hash matrix's
    first s columns; the dense ranks to rank_compress_host's; the
    first-of-run ranks give kernel 2's distances bit for bit as the host
    ranks do (and, with check_rank_rule, equal the rule computed on the
    host)."""
    from dipper_tpu_torch.distance.mash import (mash_pairwise, pad_ranks,
                                                rank_compress,
                                                rank_compress_dense,
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
    del plain
    # each batch: the kernel's stages (and the parent's, in turns), its
    # H2D copy, the sort yardstick
    stage_ms = {"both": 0.0, "a": 0.0, "b": 0.0, "a_hash_only": 0.0}
    parent_ms = {"both": 0.0, "a": 0.0, "b": 0.0, "a_hash_only": 0.0}
    turns_ms = {"parent": 0.0, "this": 0.0}
    h2d_ms = sort_ms = 0.0
    nbytes = windows = 0
    for words, lengths in calls:
        B, W = words.shape
        scr = torch.empty(minhash_cuda.scratch_elems(B, W, k, s),
                          dtype=torch.int64, device="cuda")
        out = torch.empty((B, s), dtype=torch.int64, device="cuda")

        def run(st, fn=kernel, scratch=scr):
            return lambda: fn(words, lengths, k=k, sketch_size=s, stages=st,
                              scratch=scratch, out=out)

        for name, st in (("both", 3), ("a", 1), ("b", 2),
                         ("a_hash_only", 5)):
            stage_ms[name] += event_ms(run(st), 5)
        if parent_kernel is not None:
            pscr = torch.empty(parent_kernel.scratch_elems(B, W, k, s),
                               dtype=torch.int64, device="cuda")
            pfn = parent_kernel.minhash_sketch_cuda
            check(torch.equal(run(3, pfn, pscr)(),
                              kernel(words, lengths, k=k, sketch_size=s)),
                  f"{tag}: the parent's sketch kernel != this one")
            for who in ("parent", "this", "this", "parent"):
                turns_ms[who] += event_ms(
                    run(3, pfn, pscr) if who == "parent" else run(3), 5) / 2
            for name, st in (("both", 3), ("a", 1), ("b", 2),
                             ("a_hash_only", 5)):
                parent_ms[name] += event_ms(run(st, pfn, pscr), 5)
            del pscr
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
    # ranks: first-of-run (NJ) and dense (placement, D&C, --add) on the
    # card against the host's
    ranks = rank_compress(bank)
    rank_ms = event_ms(lambda: rank_compress(bank), 5)
    dense_ms = event_ms(lambda: rank_compress_dense(bank), 5)
    t0 = time.perf_counter()
    host_ranks = rank_compress_host(native)
    host_rank_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(rank_compress_dense(bank).cpu().numpy(),
                         host_ranks),
          f"{tag}: rank_compress_dense != rank_compress_host")
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
    del dev_pad, host_pad, ranks, bank
    bound = sketch_bound(windows, nbytes, sass)
    rec = {"rows": len(seqs), "k": k, "s": s, "batches": len(calls),
           "windows": windows, "equal_native": True, "equal_plain": True,
           "max_abs_err": 0.0,
           "sketch_sequences_wall_ms": wall_ms,
           "encode_pack_ms": sum(enc_s) * 1e3, "h2d_ms": h2d_ms,
           "kernel_ms": stage_ms, "ms": stage_ms["both"],
           "select_ms": stage_ms["a"] - stage_ms["a_hash_only"],
           "select_share_of_ms": (stage_ms["a"] - stage_ms["a_hash_only"])
           / stage_ms["both"],
           "mkmers_per_s": windows / stage_ms["both"] / 1e3,
           **bound, "share_of_bound": bound["bound_ms"] / stage_ms["both"],
           "hash_only_share_of_bound": bound["bound_ms"]
           / stage_ms["a_hash_only"],
           "plain_ms": plain_ms,
           "torch_sort_rows_ms": sort_ms,
           "rank_compress_ms": rank_ms, "rank_compress_dense_ms": dense_ms,
           "rank_compress_host_ms": host_rank_ms,
           "rank_rule_equal_host": rule, "dense_ranks_equal_host": True,
           "distances_equal_host_ranks": True,
           "native_ms": native_ms,
           "native_threads": min(32, os.cpu_count() or 1)}
    if parent_kernel is not None:
        rec["parent"] = {"kernel_ms": parent_ms, "turns_ms": turns_ms,
                         "timing": "each batch: parent, this, this, parent "
                                   "(5 calls each), the two turns averaged "
                                   "and summed over batches"}
    return rec, host_ranks


def device_route_vs_host(seqs, host_ranks: np.ndarray, native_ms: float,
                         host_rank_ms: float) -> dict:
    """distance/mash.py::mash_rank_bank, as placement, D&C and --add call
    it, on the card: its device route's padded rank bank against the
    host route's (native sketcher, np.unique: the same set's ranks from
    time_sketch_set), byte for byte; the device route's logged parts and
    peak device memory a bank value beside the host route's parts."""
    from dipper_tpu_torch.distance import mash
    from dipper_tpu_torch.utils.params import Param

    lines = []
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = mash.mash_rank_bank(seqs, Param(), dev, log=lines.append)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    log = "\n".join(lines)
    check("Rank bank route: device" in log, "mash_rank_bank did not take "
          f"the device route: {lines}")
    t0 = time.perf_counter()
    want = torch.from_numpy(mash.pad_ranks(host_ranks)).to(dev)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    same = bool(torch.equal(got, want))
    check(same, "the device route's padded rank bank != the host route's")
    N, S = host_ranks.shape
    return {"route_line": lines[0], "bank_bytes_equal_host_route": same,
            "device_route_ms": {
                "sketch": _ms(r"Sketch in: (\d+) ms", log),
                "rank_bank": _ms(r"Rank bank in: (\d+) ms", log),
                "wall": wall_ms},
            "host_route_ms": {"native_sketch": native_ms,
                              "rank_compress_host": host_rank_ms,
                              "upload": upload_ms,
                              "sum": native_ms + host_rank_ms + upload_ms},
            "peak_bytes_per_value": peak / (N * S),
            "route_estimate_bytes_per_value": mash._DEVICE_ROUTE_BYTES}


def phase_sketch(fa30: str, fa20: str, parent: str | None = None) -> dict:
    """Phase 24: the sketch kernel against its plain version and the
    native sketcher, bitwise, on the placement set (all 30K rows against
    the native bank, the first 512 against the plain version), the NJ
    set (every row against both), the select path's cases and adversarial
    rows; device rank compression (first-of-run and dense); the device
    route's padded rank bank against the host route's; times, with an
    earlier checkout's kernel in turns where `parent` is given."""
    from dipper_tpu_torch.driver import _load_sequences
    from dipper_tpu_torch.sketch import minhash
    from dipper_tpu_torch.utils.params import Param

    t0 = time.time()
    parts_s = {}
    pk = parent_module(parent, "sketch.minhash_cuda") if parent else None
    _, seqs30 = _load_sequences(Param(), fa30)
    bank = minhash.sketch_sequences(seqs30[:512], 15, 1000, device="cuda",
                                    as_device=True)
    plain, _ = plain_sketch_on_card(seqs30[:512], 15, 1000)
    err = u64_err(bank, plain)
    check(err == 0.0, f"sketch kernel != plain on the placement set's first "
          f"512 rows (max abs err {err})")
    del bank, plain
    parts_s["load_and_first_512"] = time.time() - t0
    sass = sketch_window_sass()
    set30, host_ranks = time_sketch_set("placement set", seqs30, sass,
                                        check_rank_rule=True,
                                        parent_kernel=pk)
    route = device_route_vs_host(seqs30, host_ranks, set30["native_ms"],
                                 set30["rank_compress_host_ms"])
    del seqs30, host_ranks
    parts_s["placement_set"] = time.time() - t0 - sum(parts_s.values())
    _, seqs20 = _load_sequences(Param(), fa20)
    set20, _ = time_sketch_set("NJ set", seqs20, sass, parent_kernel=pk)
    del seqs20
    parts_s["nj_set"] = time.time() - t0 - sum(parts_s.values())
    select = sketch_select_cases(pk)
    parts_s["select_cases"] = time.time() - t0 - sum(parts_s.values())
    adv = sketch_adversarial()
    parts_s["adversarial"] = time.time() - t0 - sum(parts_s.values())
    res = {"placement_30k": set30, "nj_20k": set20}
    emit({"phase": "sketch_vs_plain", "kernel": "minhash_sketch",
          "timing": "kernel: CUDA events, mean of 5 back-to-back calls a "
                    "batch after a warm-up, summed over the batches; host "
                    "parts: host clock",
          "stages": "a: stage 1 (hash + select), a_hash_only: its hashing "
                    "alone, b: the merge rounds (none where a row is one "
                    "list), both: one call",
          "bound": {"sass_instructions_per_window": sass,
                    "sm_clocks_per_s": SM_CLOCKS_PER_S,
                    "dispatch_per_sm_clock": DISPATCH_PER_SM_CLOCK,
                    "int_pipe_per_sm_clock": INT_PIPE_PER_SM_CLOCK,
                    "bytes_per_s": PEAK_BYTES_PER_S},
          "host_cpu": host_cpu(), **res, "device_route_30k": route,
          "select_cases": select, "adversarial": adv,
          "parts_s": parts_s, "phase_s": time.time() - t0})
    main = set30
    rec = {"ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "share_of_bound": main["share_of_bound"],
           "hash_only_share_of_bound": main["hash_only_share_of_bound"],
           "select_share_of_ms": main["select_share_of_ms"],
           "library_ms": main["torch_sort_rows_ms"], "max_abs_err": 0.0,
           "shape": [main["rows"], 10000],
           "mkmers_per_s": main["mkmers_per_s"],
           "kernel_ms": main["kernel_ms"],
           "nj_20k": {key: set20[key] for key in (
               "ms", "bound_ms", "share_of_bound", "hash_only_share_of_bound",
               "select_share_of_ms", "mkmers_per_s", "kernel_ms",
               "torch_sort_rows_ms", "rank_compress_ms")},
           "device_route_30k": {key: route[key] for key in (
               "device_route_ms", "host_route_ms",
               "bank_bytes_equal_host_route")}}
    if pk is not None:
        rec["parent_ms"] = set30["parent"]["turns_ms"]["parent"]
        rec["this_ms_in_turns"] = set30["parent"]["turns_ms"]["this"]
        rec["nj_20k"]["parent_ms"] = set20["parent"]["turns_ms"]["parent"]
    return rec


def no_sync(fn) -> None:
    """fn() under torch.cuda.set_sync_debug_mode("error"): a host sync
    raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def wide_window(inputs: tuple, leaves: int = ADD_WIDE_LEAVES,
                queries: int = ADD_WIDE_QUERIES) -> dict:
    """closest_bfs_range (the seeding's kernel) against the per-leaf
    cursor route (closest_bfs_cursor's graphs, the parent's route, kept as
    the yardstick) and the plain version (the dense BFS), on --add's state
    of a multifurcating backbone built from the CLI's own inputs to
    run_add_queries (`inputs`): three f32 states (the range route, the
    cursor route, no table). Each seeds GRAPH_INSERTIONS leaves (the
    cursor graph's capture), then `leaves` more (the window), each route
    timed by CUDA events queued behind a device sleep (the two kernel
    routes under sync debug "error"), to the same arrays, and to
    insert_model.bfs_range's on a host copy (its counts give the bound);
    the range route then seeds to ADD_WIDE_LATE, the cursor route takes
    its arrays, and both seed `leaves` more (the late stretch, timed
    alike, the same arrays); the range route seeds the rest (timed). The
    window is seeded again by the range kernel in f64 and, at a forced
    capacity of ADD_WIDE_SMALL_CAP entries (the frontier and the wide
    list spill), in f32 and f64: the same arrays as the cursor route
    (and the dense BFS in f64). Then `queries` queries on the range
    route's state and on a copy without a table after a warm-up range
    (the insert graph's capture): the kernel route under sync debug
    "error", to the same arrays; then `queries` more by direct launches
    (kernel_window: each insert_step launch between events) and by the
    plain version (the scorer, then splice and dense BFS between events),
    insert_model's insert_step on a host copy counting what they read."""
    import dataclasses

    from dipper_tpu_torch.placement import insert_cuda, insert_model
    from dipper_tpu_torch.placement import kclosest as tk

    frontend_args, arrays, kw = inputs
    N, B = kw["num_sequences"], kw["backbone_size"]
    common = dict(num_sequences=N, backbone_size=B, use_adj=False)

    def states(dtype):
        got = (tk.add_state(*arrays, dtype_name=dtype, **common),
               tk.add_state(*arrays, dtype_name=dtype, **common),
               tk.add_state(*arrays, dtype_name=dtype, wide_table=False,
                            **common))
        check(got[0].wide_off is not None and got[2].adj is None,
              "--add wide window: the states are not the wide and the "
              "plain ones")
        return got

    st, cu, pl = states(kw["dtype_name"])
    six = ("e", "belong", "length", "rev", "cdis", "cid")

    def diff(a, b):
        return [f for f in state_diff(a, dataclasses.replace(b, adj=a.adj))
                if f in six + ("idx",)]

    def host(a):
        return {f: getattr(a, f).cpu().numpy().copy()
                for f in insert_model.FIELDS + insert_model.WIDE}

    def seed_dense(state, lo_, hi_):
        for i in range(lo_, hi_):
            tk.update_closest_bfs(state, i, 2 * N)

    G = tk.GRAPH_INSERTIONS
    lo, hi = G, G + leaves
    tk._seed_by_range(st, 0, lo)
    tk._seed_by_cursor(cu, 0, lo)
    seed_dense(pl, 0, lo)
    plan = insert_cuda.range_plan(st)
    model = host(st)
    range_ms, cursor_ms, plain_ms = (queued_each_ms([fn])[0] for fn in (
        lambda: no_sync(lambda: tk._seed_by_range(st, lo, hi)),
        lambda: no_sync(lambda: tk._seed_by_cursor(cu, lo, hi)),
        lambda: seed_dense(pl, lo, hi)))
    stats, levels = {}, []
    insert_model.bfs_range(model, lo, leaves, plan, stats=stats,
                           levels=levels)
    for tag, other in (("the per-leaf cursor route", cu),
                       ("the dense BFS", pl)):
        d = diff(st, other)
        check(not d, f"--add wide window: closest_bfs_range != {tag} in {d}")
    mdiff = [f for f in six if getattr(st, f).cpu().numpy().tobytes()
             != model[f].tobytes()]
    check(not mdiff, f"--add wide window: closest_bfs_range != insert_model "
          f"in {mdiff}")
    snap = {f: getattr(st, f).clone() for f in six}
    # the range kernel in f64 and at a forced small capacity, on the window
    wants = {kw["dtype_name"]: snap}
    for dtype, small in (("float32", True), ("float64", False),
                         ("float64", True)):
        if dtype not in wants:
            a, c, p = states(dtype)
            tk._seed_by_range(a, 0, hi)
            tk._seed_by_cursor(c, 0, hi)
            seed_dense(p, 0, hi)
            for tag, other in (("the per-leaf cursor route", c),
                               ("the dense BFS", p)):
                d = diff(a, other)
                check(not d, f"--add wide window, {dtype}: closest_bfs_range"
                      f" != {tag} in {d}")
            wants[dtype] = {f: getattr(c, f) for f in six}
        want = wants[dtype]
        if small:
            a = tk.add_state(*arrays, dtype_name=dtype, **common)
            ps = insert_cuda.range_plan(a, cap=ADD_WIDE_SMALL_CAP,
                                        list_cap=ADD_WIDE_SMALL_CAP)
            tk._seed_by_range(a, 0, hi, ps)
            d = [f for f in six if not same_bits(getattr(a, f), want[f])]
            check(not d, f"--add wide window, {dtype}: closest_bfs_range at "
                  f"a capacity of {ADD_WIDE_SMALL_CAP} != the cursor route "
                  f"in {d}")
    # the late stretch
    late = max(hi, min(ADD_WIDE_LATE, B - leaves))
    rest_ms = queued_each_ms([lambda: tk._seed_by_range(st, hi, late)])[0]
    for f in six:
        getattr(cu, f).copy_(getattr(st, f))
    model = host(st)
    late_range_ms, late_cursor_ms = (queued_each_ms([fn])[0] for fn in (
        lambda: no_sync(lambda: tk._seed_by_range(st, late, late + leaves)),
        lambda: no_sync(lambda: tk._seed_by_cursor(cu, late, late + leaves))))
    lstats = {}
    insert_model.bfs_range(model, late, leaves, plan, stats=lstats)
    d = diff(st, cu) + [f for f in six if getattr(st, f).cpu().numpy()
                        .tobytes() != model[f].tobytes()]
    check(not d, f"--add wide window, late stretch: closest_bfs_range != "
          f"the cursor route or insert_model in {d}")
    rest_ms += queued_each_ms([lambda: tk._seed_by_range(
        st, late + leaves, B)])[0]
    del cu
    pl = tk.prepare_kernels(dataclasses.replace(
        st, **{f: getattr(st, f).clone() for f in six}, adj=None,
        wide_off=None, wide_eid=None))
    rows = tk._rows(frontend_args, kw["frontend"], kw["frontend_static"],
                    kw["dtype_name"], B, B + G + 2 * queries)
    tk._insert_range(st, B, B + G, rows, N)
    tk._insert_range(pl, B, B + G, rows, N)
    q0 = B + G
    route_ms = queued_each_ms([lambda: no_sync(lambda: tk._insert_range(
        st, q0, q0 + queries, rows[G:], N))])[0]
    plain_q_ms = queued_each_ms([lambda: tk._insert_range(
        pl, q0, q0 + queries, rows[G:], N)])[0]
    d = diff(st, pl)
    check(not d, f"--add wide window: queries by the kernel route != the "
          f"plain route in {d}")
    q1 = q0 + queries
    model = host(st)
    win = kernel_window(st, rows[q1 - B:], q1, q1 + queries, N)
    qstats, splice_bfs_ms = {}, []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for i in range(q1, q1 + queries):
        eid, x, y, ye, frac, add = tk.score_edges(pl, rows[i - B])
        i0 = pl.idx
        ev[0].record()
        tk.splice(pl, eid, frac, add, i, N, (x, y, ye))
        tk._update_closest_bfs_dense(pl, i, 2 * N)
        ev[1].record()
        torch.cuda.synchronize()
        splice_bfs_ms.append(ev[0].elapsed_time(ev[1]))
        insert_model.insert_step(model, int(eid), frac.cpu().numpy(),
                                 add.cpu().numpy(), i0, i + N - 1, i, i,
                                 stats=qstats)
    d = diff(st, pl) + [f for f in six if getattr(st, f).cpu().numpy()
                        .tobytes() != model[f].tobytes()]
    check(not d, f"--add wide window: direct insert_step launches != the "
          f"plain version or insert_model in {d}")
    item = st.length.element_size()
    # the range launch's bytes: the leaves' reads and writes, and the
    # table staged once
    bound = insert_bound(stats, 0, item)
    staged = 4 * (plan["n_off"] + plan["n_eid"])
    bound_r = bound_of(bound["ops"], bound["bytes"] + staged, 33.5e12)
    lbound = insert_bound(lstats, 0, item)
    qbound = insert_bound(qstats, queries, item)
    rec = {"leaves": leaves, "queries": queries, "plan": plan,
           "ms": range_ms / leaves, "plain_ms": plain_ms / leaves,
           "bound_ms": bound_r["bound_ms"] / leaves,
           "bound_by": bound_r["bound_by"],
           "per_leaf_cursor_ms": cursor_ms / leaves,
           "late_first_leaf": late, "late_ms": late_range_ms / leaves,
           "late_per_leaf_cursor_ms": late_cursor_ms / leaves,
           "late_bound_ms": lbound["bound_ms"] / leaves,
           "rest_seeding_ms_per_leaf": rest_ms / (B - hi - leaves),
           "query_route_ms": route_ms / queries,
           "query_plain_ms": plain_q_ms / queries,
           "insert_step_ms_per_query": sum(win["insert_ms"]) / queries,
           "score_edges_ms_per_query": sum(win["score_ms"]) / queries,
           "splice_dense_bfs_ms_per_query": sum(splice_bfs_ms) / queries,
           "query_bound_ms": qbound["bound_ms"] / queries,
           "query_bound_by": qbound["bound_by"],
           "query_levels": qstats["levels"] / queries,
           "levels_per_leaf": stats["levels"] / leaves,
           "late_levels_per_leaf": lstats["levels"] / leaves,
           "widest_level": max(levels),
           "model_counts_per_leaf": {k: v / leaves for k, v in stats.items()},
           "late_model_counts_per_leaf": {k: v / leaves
                                          for k, v in lstats.items()},
           "equal_cursor_dense_and_model": True,
           "equal_f64_and_small_capacity": True,
           "no_host_sync_in_ranges": True}
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def phase_add_wide(tmp: str, fa: str, backbone: int, queries: int,
                   small: tuple = (256, 64)) -> dict:
    """--add onto a multifurcating backbone: the port's -i r -m 1 tree of
    the set's first `backbone` taxa, collapsed (collapse_backbone), then
    --add of the next `queries` on the card, counted; the wide window on
    the run's own inputs; the card and the CPU on a collapsed backbone of
    small[0] with small[1] queries."""
    from dipper_tpu_torch.placement import kclosest

    def backbone_of(b: int, tag: str, clade: int) -> tuple:
        back_fa = head_fasta(fa, b, os.path.join(tmp, f"{tag}.back.fa"))
        binary = os.path.join(tmp, f"{tag}.binary.nwk")
        rc, _, _ = run_cli(["-i", "r", "-I", back_fa, "-O", binary, "-m",
                            "1", "--device", "cuda"])
        check(rc == 0, f"{tag}: the backbone build returned {rc}")
        with open(binary) as f:
            nwk, counts = collapse_backbone(f.read(), clade=clade)
        path = os.path.join(tmp, f"{tag}.back.nwk")
        with open(path, "w") as f:
            f.write(nwk + "\n")
        return path, counts

    def add_run(b: int, q: int, back: str, dev: str, tag: str):
        all_fa = head_fasta(fa, b + q, os.path.join(tmp, f"{tag}.all.fa"))
        out = os.path.join(tmp, f"{tag}.out.{dev}.nwk")
        rc, log, wall = run_cli(["-i", "r", "-I", all_fa, "-O", out, "--add",
                                 "-t", back, "--device", dev])
        check(rc == 0, f"{tag}: --add --device {dev} returned {rc}")
        return open(out).read(), log, wall

    back, collapsed = backbone_of(backbone, "addw", COLLAPSE_CLADE)
    check(collapsed["max_degree"] >= COLLAPSE_CLADE,
          f"the collapsed backbone's largest degree is "
          f"{collapsed['max_degree']}")
    inputs = {}
    orig = kclosest.run_add_queries

    def recorded(frontend_args, e0, belong0, length0, rev0, **kw):
        inputs["args"] = (frontend_args, (e0, belong0, length0, rev0), kw)
        return orig(frontend_args, e0, belong0, length0, rev0, **kw)

    kclosest.run_add_queries = recorded
    reset_counts()
    try:
        out, log, wall = add_run(backbone, queries, back, "cuda", "addw")
    finally:
        kclosest.run_add_queries = orig
    counts = read_counts()
    check("insert_step.cu's wide table" in log,
          "--add did not take the wide table on the card")
    check(counts["score_edges"] == queries,
          f"--add launched score_edges {counts['score_edges']} times for "
          f"{queries} queries")
    chunks = -(-backbone // kclosest.RANGE_LEAVES)
    check(counts["closest_bfs_range_wide"] == chunks
          and counts["insert_step_wide.closest_bfs"] == 0
          and counts["insert_step_wide"] == queries
          and counts["insert_step"] == 0,
          f"--add launched closest_bfs_range {counts['closest_bfs_range_wide']}"
          f" times ({chunks} chunks), the wide insert_step "
          f"{counts['insert_step_wide']} times "
          f"({counts['insert_step_wide.closest_bfs']} the BFS alone) and the "
          f"binary one {counts['insert_step']} times for {backbone} backbone "
          f"leaves and {queries} queries")
    check(f"seeding range launches {chunks}" in log,
          "--add's log does not report its seeding range launches")
    survive, leaves = backbone_splits_survive(out, open(back).read())
    check(leaves == {f"S{i}" for i in range(backbone + queries)},
          "--add: the tree's leaves are not the input's")
    check(survive, "--add: a backbone split did not survive")
    window = wide_window(inputs.pop("args"))
    b, q = small
    back_s, _ = backbone_of(b, f"addw{b}", 64)
    outs = {dev: add_run(b, q, back_s, dev, f"addw{b}")[0]
            for dev in ("cuda", "cpu")}
    check(outs["cuda"] == outs["cpu"], "--add: the card's Newick on a "
          f"collapsed backbone differs from the CPU's at {b} + {q}")
    seeded = _ms(r"seeded in: ([\d.]+) ms", log)
    inserted = _ms(r"insertions ([\d.]+) ms", log)
    emit({"phase": "main_path", "path": "add_multifurcating",
          "backbone": backbone, "queries": queries, "precision": "f32",
          "collapsed": collapsed,
          "phases_ms": {
              "sketch": _ms(r"Sketch in: (\d+) ms", log),
              "seeding": seeded,
              "rows": _ms(r"queries: rows ([\d.]+) ms", log),
              "insertions": inserted,
              "tree_created": _ms(r"Tree Created in: (\d+) ms", log),
              "total_wall": wall * 1e3},
          "seeding_ms_per_backbone_leaf": seeded / backbone,
          "seeding_launches": counts["closest_bfs_range_wide"],
          "seeding_chunk_leaves": kclosest.RANGE_LEAVES,
          "ms_per_query": inserted / queries,
          "kernel_launches": counts, "backbone_splits_survive": True,
          "window": window,
          "gpu_vs_cpu": {"backbone": b, "queries": q,
                         "newick_identical": True}})
    return {"counts": counts, "window": window}


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
                         "13 its first min(2048, msa-n)")
    ap.add_argument("--phases", default=",".join(map(str, sorted(ALL_PHASES))),
                    help="comma-separated subset of phases to run")
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit (e.g. from git "
                         "archive): phase 15 builds its per-cluster count "
                         "kernel, phase 5 its insert_step, phase 9 its NJ "
                         "kernels A and B, phase 24 its sketch kernel, "
                         "phases 13 and 27 its exact_step and phase 26 its "
                         "phase-3 kernels, and each is timed beside this "
                         "one's")
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
        if phases & {3, 5, 6, 14, 15, 16, 21, 22, 24, 27, 30}:
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
                level_latency_ms=res["level_latency_ms"],
                l2_round_trip_ms=res["l2_round_trip_ms"])
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
            res = phase_main_path(tmp, args.n, *data, parent=args.parent)
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
            # the ingest's kernel: placement is its main path
            records["minhash_sketch"].update(
                launches=res["counts"]["minhash_sketch"],
                main_path_launches_checked=res["sketch_checked"])
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
                       graph_route=res["graph_route"],
                       **{k: win[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "share_of_bound")})
            if "parent" in win:
                ins["parent_ms"] = win["parent"]["parent_ms"]
            if "level_latency_ms" in ins:
                # the latency floor beside the byte bound: the levels, each
                # one dependent L2 round trip (the chase), and the levels
                # at the measured narrow level
                chain = win["levels_per_insertion"] * ins["level_latency_ms"]
                ins.update(latency_floor_ms=win["levels_per_insertion"]
                           * ins["l2_round_trip_ms"],
                           latency_chain_ms=chain,
                           share_of_latency_chain=chain / win["ms"])
            # the first profiler session of the process: after another
            # one, the profiler missed a few of the replayed graphs' kernels
            # (and even here it once missed the window's first kernel,
            # hence profiler_lead_in)
            ins["graph_route_profiled"] = phase_graph_route_profiled()
            PROFILE_WINDOW.clear()
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
            for name in ("dc_stream_block", "dc_cluster_build",
                         "dc_assign", "dc_assign_pack"):
                records[name].update(launches=res["counts"][name],
                                     library_ms=None)
        if 29 in phases:
            check(16 in phases, "phase 29 checks phase 16's recorded "
                  "phase 2")
            res = phase_dc_assign_vs_plain(dc_single.pop("phase2"))
            big = res["dc_chunk"]
            records["dc_assign"].update(
                max_abs_err=0.0, library_ms=None, dc_phase2=res["dc_phase2"],
                matrix_strided=res["matrix_strided"],
                b50000={k: res[f"b50000_{k}"] for k in ("float32",
                                                         "float64")},
                band_chunk_float32=res["band_chunk_float32"],
                **{k: big[k] for k in ("rows", "width", "plan", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "share_of_bound",
                                       "smem_gather_floor_ms",
                                       "share_of_smem_gather_floor",
                                       "l2_floor_ms", "share_of_l2_floor")})
            pk = res["pack_dc"]
            records["dc_assign_pack"].update(
                max_abs_err=0.0, library_ms=None, b50000=res["pack_b50000"],
                **{k: pk[k] for k in ("slots", "records", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "share_of_bound")})
        if 26 in phases:
            check(16 in phases, "phase 26 checks phase 16's recorded "
                  "launches")
            res = phase_dc_kernels_vs_plain(dc_single.pop("phase3"),
                                            args.parent)
            sm = res["dc_stream_block"]["streamed"][0]
            records["dc_stream_block"].update(
                max_abs_err=0.0, library_ms=None, streamed=sm,
                **{k: sm[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "share_of_bound",
                                      "latency_floor_ms")})
            cb = res["dc_cluster_build"]
            narrow = cb["by_bucket"][min(cb["by_bucket"], key=int)]
            records["dc_cluster_build"].update(
                max_abs_err=0.0, library_ms=None, by_bucket=cb["by_bucket"],
                clusters_checked=cb["clusters_checked"],
                main_path_launches=cb["launches"],
                **{k: narrow[k] for k in ("clusters", "cmax", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "share_of_bound",
                                          "latency_floor_ms")})
        if 9 in phases:
            res = nj_single = phase_nj_main_path(tmp, args.nj_n, args.parent)
            note("nj", res["counts"])
            rd = records["mash_rows_dist"]
            rd["launches"] = res["counts"]["mash_rows_dist"]
            rd["max_abs_err"] = max(rd.get("max_abs_err", 0.0),
                                    res["max_abs_err"])
            records["minhash_sketch"].setdefault(
                "launches", res["counts"]["minhash_sketch"])
            # NJ's kernels: their launches on this path, their times at
            # its sizes (kernel A at NJ_TIMED_N, the largest in the keys)
            for name, key in (("nj_q_argmin", "q_argmin"),
                              ("nj_update", "update")):
                times = res["nj_times"][key]
                top = times[max(times)]
                records[name].update(
                    launches=res["counts"][name], n=max(times),
                    times_by_n=times,
                    **{f: top[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "max_abs_err", "share_of_bound",
                                           "parent_ms") if f in top})
            records["nj_q_argmin"].update(
                half_read_launches=res["counts"]["nj_q_argmin.half_read"],
                bound_full_read_ms=res["nj_times"]["q_argmin"][
                    records["nj_q_argmin"]["n"]]["bound_full_read_ms"])
            records["nj_update"]["step_windows"] = \
                res["nj_times"]["step_windows"]
        if 24 in phases:
            nj_fa = (nj_single["fa"] if 9 in phases else make_dataset(
                args.nj_n, os.path.join(tmp, f"n{args.nj_n}"), seed=1)[0])
            records["minhash_sketch"].update(phase_sketch(data[0], nj_fa,
                                                          args.parent))
        if phases & {10, 11, 12, 13, 28, 31}:
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
        if 28 in phases:
            note("msa_dc", phase_msa_dc(tmp, msa_fa, msa_true,
                                        min(MSA_DC_N, args.msa_n))["counts"])
        if 31 in phases:
            res = phase_msa_dc_main_path(tmp, msa_fa, msa_true, args.msa_n)
            note("msa_dc_main", res["counts"])
            b8 = res["by_bucket"][min(res["by_bucket"])]
            records["msa_cluster_dist"].update(
                launches=res["counts"]["msa_cluster_dist"], max_abs_err=0.0,
                library_ms=None, by_bucket=res["by_bucket"],
                sass=res["sass"],
                **{k: b8[k] for k in ("clusters", "W", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "share_of_bound", "codes_bound_ms",
                                      "share_of_codes_bound")})
            records["msa_cluster_dist_pack"].update(
                launches=res["counts"]["msa_cluster_dist_pack"],
                max_abs_err=0.0, library_ms=None,
                **{k: res["pack"][k] for k in (
                    "rows", "L", "ms", "plain_ms", "bound_ms", "bound_by",
                    "share_of_bound", "planes_in_ms")})
        if 14 in phases:
            note("add", phase_add(tmp, data[0], min(4096, args.n // 2),
                                  min(1024, args.n // 8))["counts"])
        if 30 in phases:
            q = min(1024, args.n // 8)
            res = phase_add_wide(tmp, data[0], args.n - q, q)
            note("add_multifurcating", res["counts"])
            win = res["window"]
            # one dependent L2 round trip (phase 25's, or measured here)
            trip = (records["insert_step"].get("l2_round_trip_ms")
                    or l2_round_trip_ms())
            records["closest_bfs_range_wide"].update(
                launches=res["counts"]["closest_bfs_range_wide"],
                max_abs_err=0.0, library_ms=None, per="backbone leaf",
                window=win, l2_round_trip_ms=trip,
                latency_floor_ms=win["levels_per_leaf"] * trip,
                late_latency_floor_ms=win["late_levels_per_leaf"] * trip,
                **{k: win[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "share_of_bound")})
            # the wide instantiation's launches on the main path are the
            # queries' insert_step (the seeding is the range kernel's)
            records["insert_step_wide"].update(
                launches=res["counts"]["insert_step_wide"], max_abs_err=0.0,
                library_ms=None, per="query", l2_round_trip_ms=trip,
                ms=win["insert_step_ms_per_query"],
                plain_ms=win["splice_dense_bfs_ms_per_query"],
                bound_ms=win["query_bound_ms"],
                bound_by=win["query_bound_by"],
                share_of_bound=(win["query_bound_ms"]
                                / win["insert_step_ms_per_query"]),
                latency_floor_ms=win["query_levels"] * trip,
                per_leaf_cursor_seeding_ms=win["per_leaf_cursor_ms"])
        if 27 in phases and args.n < 30000:
            # -m 0 is auto mode, which takes exact placement only from
            # 30,000 taxa (below, NJ)
            emit({"phase": "exact_main_path", "n": args.n,
                  "skipped": "-m 0 takes exact placement at N >= 30,000"})
        elif 27 in phases:
            res = phase_exact_main_path(tmp, args.n, *data, args.parent)
            note("exact", res["counts"])
            t = res["times_last_range"]
            records["exact_step"].update(
                launches=res["counts"]["exact_step"], max_abs_err=0.0,
                library_ms=None, n=args.n, slots_used=t["slots_used"],
                launch_record=t["launch_record"], parts=t["parts"],
                launches_on_cluster=res["sample_vs_plain"][
                    "launches_on_cluster"],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "share_of_bound",
                                     "latency_floor_ms",
                                     "share_of_latency_floor")})
            if "in_turns" in t:
                records["exact_step"]["parent_ms"] = t["in_turns"]["parent_ms"]
        if 13 in phases:
            n13 = min(EXACT_N, args.msa_n)
            res = phase_exact(tmp, msa_fa, n13, small=min(512, args.msa_n),
                              parent=args.parent)
            ex = records["exact_step"]
            t = res["times_at_end"]
            ex["at_phase13"] = {k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                "latency_floor_ms", "launch_record", "parts", "in_turns")
                if k in t}
            ex["route_profiled"] = res["route_profiled"]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
                ex.setdefault(key, t[key])
            ex.setdefault("max_abs_err", 0.0)
            ex.setdefault("library_ms", None)
            ex.setdefault("launches", res[f"matrix_{n13}"]
                          ["kernel_launches"]["exact_step"])
        if 8 in phases:
            win = phase_nj_gpu_vs_cpu(tmp)["profiled_window"]
            for name in ("nj_q_argmin", "nj_update"):
                records[name]["merge_steps_profiled"] = win
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
    emit({"phase": "seconds_by_line", "lines": LINE_SECONDS})
    if phases != set(ALL_PHASES):
        emit({"partial_run": sorted(phases), "kernels": kernels})
        return 0
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["torch_name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
