"""dipper-tpu-torch command line interface.

The flag surface of dipper_tpu.cli (itself the reference CLI's,
src/tree_generation.cu:33-99) plus --device:

  -i/--input-format {d,r,m}   PHYLIP matrix | raw FASTA | aligned FASTA
  -I/--input-file PATH
  -O/--output-file PATH
  -o/--output-format {t,d}
  -m/--algorithm {0,1,2,3}    auto | placement | NJ | divide-and-conquer
  -p/--placement-mode {0,1}   parsed; the -m value decides (reference quirk)
  -k/--kmer-size INT          (2..15, default 15)
  -s/--sketch-size INT        (default 1000)
  -d/--distance-type {1..6}
  -a/--add  -t/--input-tree PATH
  --device {cuda,cpu}         where tensors live (default cuda; asking for
                              cuda without a GPU raises; on cuda the mash
                              kernels take sketch sizes up to 19,367 for
                              placement, 14,523 (f32) or 11,619 (f64) for
                              NJ and -o d, the sketch kernel of NJ and -o
                              d up to 1,048,576)
  --devices N                 split NJ's Q scan and D&C's phases 2 and 3
                              over N ranks (one process and one card each)
  --coordinator HOST:PORT --num-processes P --process-id I
                              join a multi-process run (every process runs
                              the same command with its own id)
  --profile DIR               a torch.profiler trace of the build, one
                              file per rank

Ported, from -i r, -i m and -i d: conventional NJ (-m 2, or auto mode
below 30,000 taxa), k-closest placement (-m 1, or auto mode from 30,000
to 1,000,000 taxa), exact placement (the -m value 0: auto mode, so only
at N >= 30,000), divide-and-conquer (-m 3, or auto mode at N >=
1,000,000; from -i r and -i m only, a matrix is refused as by the
reference), the distance matrix as PHYLIP (-i r or -i m with -o d) and
--add (from -i r and -i m), with --precision, --seed,
--save/--load-sketches, and for placement and D&C's backbone
--save/--load-state, --state-chunk and --no-prefix-caps.

Ranks: with --coordinator every process joins one torch.distributed group
(parallel/distributed.py); NJ and D&C split their work over
min(--devices, processes) of them and rank 0 writes the output. On one
host without a coordinator, --devices N starts min(N, cards) local ranks
itself (spawned processes, one card each); --device cpu --devices N has
one device and builds unsharded, as the JAX package on one CPU device
does. Placement, --add and -o d run whole on every rank, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dipper-tpu-torch",
        description="Distance-based phylogenetic tree builder on PyTorch "
                    "and CUDA",
    )
    p.add_argument("-i", "--input-format", required=True, choices=["d", "r", "m"])
    p.add_argument("-I", "--input-file", required=True)
    p.add_argument("-O", "--output-file", required=True)
    p.add_argument("-o", "--output-format", default="t", choices=["t", "d"],
                   help="t = Newick tree; d = PHYLIP distance matrix")
    p.add_argument("-m", "--algorithm", default=None, choices=["0", "1", "2", "3"])
    p.add_argument("-p", "--placement-mode", default=None, choices=["0", "1"])
    p.add_argument("-k", "--kmer-size", type=int, default=15)
    p.add_argument("-s", "--sketch-size", type=int, default=1000)
    p.add_argument("-d", "--distance-type", type=int, default=1, choices=range(1, 7))
    p.add_argument("-a", "--add", action="store_true")
    p.add_argument("-t", "--input-tree", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the build (default cuda; no silent "
                        "fallback to the CPU). cuda takes --sketch-size up "
                        "to 19367 for placement, 14523 (f32) or 11619 (f64) "
                        "for NJ and -o d (the kernels' shared memory); the "
                        "sketch kernel takes up to 1048576")
    p.add_argument("--precision", default="f32", choices=["f32", "f64"])
    p.add_argument("--seed", type=int, default=42,
                   help="input shuffle seed; -1 = keep input order")
    p.add_argument("--save-sketches", default=None, metavar="NPZ",
                   help="write the MinHash sketch bank to an .npz and "
                        "continue")
    p.add_argument("--load-sketches", default=None, metavar="NPZ",
                   help="resume from a saved sketch bank instead of "
                        "re-sketching (-i r only)")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="checkpoint the placement tree state every "
                        "--state-chunk insertions")
    p.add_argument("--load-state", default=None, metavar="NPZ",
                   help="resume a placement build from a tree-state "
                        "checkpoint (either package's)")
    p.add_argument("--state-chunk", type=int, default=8192,
                   help="insertions per range (checkpoint granularity)")
    p.add_argument("--no-prefix-caps", action="store_true",
                   help="run every range on the full-width arrays instead "
                        "of pow2 prefix caps (same tree, more work)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the build to DIR "
                        "(CPU and CUDA activities; one file per rank)")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="split NJ's Q scan and D&C's phases 2 and 3 over "
                        "N ranks, one card each (1 = single device, the "
                        "default)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process run: the address of rank 0's "
                        "rendezvous (or set DIPPER_COORDINATOR); every "
                        "process runs the same command with its own "
                        "--process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def _rank_main(rank: int, argv: list, world: int, coordinator: str) -> None:
    """One local rank of `--devices N` (a spawned process)."""
    rc = main(argv + ["--coordinator", coordinator, "--num-processes",
                      str(world), "--process-id", str(rank)])
    if rc:
        raise SystemExit(rc)


def _spawn_local(argv: list, n: int) -> int:
    """Runs the command as n local ranks, one card each; a rank that
    fails fails the run, and ranks still running TIMEOUT after the first
    one finished are killed."""
    import torch.multiprocessing as mp

    from dipper_tpu_torch.csrc.build import build_all
    from dipper_tpu_torch.parallel.distributed import TIMEOUT, free_port

    # built once here, so that the ranks load one set of libraries
    build_all()
    print(f"Starting {n} local ranks", file=sys.stderr)
    ctx = mp.start_processes(
        _rank_main, args=(argv, n, f"127.0.0.1:{free_port()}"), nprocs=n,
        join=False, start_method="spawn")
    deadline = None
    try:
        while not ctx.join(timeout=5):
            alive = sum(p.is_alive() for p in ctx.processes)
            if alive < n and deadline is None:
                deadline = time.time() + TIMEOUT.total_seconds()
            if deadline is not None and time.time() > deadline:
                print("ERROR: a rank did not finish", file=sys.stderr)
                return 1
    except mp.ProcessRaisedException as e:
        print(f"ERROR: a rank failed:\n{e}", file=sys.stderr)
        return 1
    except mp.ProcessExitedException as e:
        print(f"ERROR: a rank exited with {e.exit_code}", file=sys.stderr)
        return 1
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.add and not args.input_tree:
        print("ERROR: --input-tree/-t is required with --add", file=sys.stderr)
        return 1
    for path in filter(None, [args.input_file, args.input_tree]):
        if not os.path.exists(path):
            print(f"ERROR: cannot open file: {path}", file=sys.stderr)
            return 1

    from dipper_tpu_torch.parallel.distributed import (init_distributed,
                                                       rank_device)
    from dipper_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    try:
        proc_id, proc_count = init_distributed(
            args.coordinator, args.num_processes, args.process_id)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    import torch.distributed as dist

    if dist.is_initialized():
        print(f"Joined distributed runtime: process {proc_id}/{proc_count}",
              file=sys.stderr)
        device = rank_device(device)
    elif args.devices > 1 and device.type == "cuda":
        import torch

        n = min(args.devices, torch.cuda.device_count())
        if n > 1:
            return _spawn_local(argv, n)
    try:
        return _build(args, device, proc_id)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _build(args, device, rank: int) -> int:
    """The build of one process (the whole run, or one rank's part)."""
    from dipper_tpu_torch.driver import run_pipeline
    from dipper_tpu_torch.io.errors import InputFormatError
    from dipper_tpu_torch.utils.params import Param

    algo = args.algorithm or "0"
    # reference quirk: placemode is read from the algorithm flag
    placemode = args.algorithm if args.algorithm is not None else "1"
    params = Param(
        kmer_size=args.kmer_size,
        sketch_size=args.sketch_size,
        distance_type=args.distance_type,
        in_format=args.input_format,
        out_format=args.output_format,
        dtype="float64" if args.precision == "f64" else "float32",
        shuffle_seed=None if args.seed == -1 else args.seed,
        save_sketches=args.save_sketches,
        load_sketches=args.load_sketches,
        save_state=args.save_state,
        load_state=args.load_state,
        state_chunk=args.state_chunk,
        prefix_caps=not args.no_prefix_caps,
        devices=args.devices,
    )

    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            # callbacks run last first: the trace is written after the
            # profiler stops
            stack.callback(_export_trace, prof, args.profile, rank)
            stack.enter_context(prof)
        try:
            run_pipeline(params, algo, placemode, args, device)
        except InputFormatError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
    print(f"Tree Created in: {int((time.time() - t0) * 1000)} ms", file=sys.stderr)
    return 0


def _export_trace(prof, out_dir: str, rank: int) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace.rank{rank}.json")
    prof.export_chrome_trace(path)
    print(f"Profile trace: {path}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
