#!/usr/bin/env python3
"""Times how D&C's aligned set reaches the card as kernel 12's bit planes
(dipper_tpu_torch/distance/msa_cuda.py::pack_bank), split into its parts,
each route in a fresh process as a CLI run meets it (the CUDA context and
the pack's library loaded first, as earlier phases leave them).

    python3 scripts/planes_upload_torch.py [--n 20000] [--L 10000]

Routes, in turns pinned, pageable, pageable, pinned, then pack_bank once:
- pinned: one pinned host buffer of the rows (`torch.empty(...,
  pin_memory=True)`), the codes copied into it (`np.copyto`), one
  asynchronous copy to the card, one pack launch;
- pageable: `torch.from_numpy(codes).to(device)` straight from the
  numpy array, one pack launch;
- pack_bank: the module's route as it stands (its "MSA planes in" line).
Each part is timed on the host clock (perf_counter) with the card
synchronized after it; each route runs twice in its process (the second
time with the process's allocators warm). The codes are uniform over the
five codes 0-4 (a fifth gaps), made in bulk before any timing. Prints a
JSON line with the card's name and power limit, then one a turn. Needs
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _timed(parts: dict, name: str, fn):
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts[name] = (time.perf_counter() - t) * 1e3
    return out


def worker(route: str, n: int, L: int) -> dict:
    import torch

    from dipper_tpu_torch.distance import msa, msa_cuda

    codes = np.random.default_rng(1).integers(0, 5, (n, L), dtype=np.uint8)
    dev = torch.device("cuda")
    # what a CLI run has done before its pack: the context up, the
    # library built and loaded
    torch.zeros(1, device=dev)
    msa_cuda._lib()
    torch.cuda.synchronize()
    words = msa.plane_words(L)
    reps = []
    for _ in range(2):
        parts, logs = {}, []
        t0 = time.perf_counter()
        if route == "pack_bank":
            msa_cuda.pack_bank(codes, dev, log=logs.append)
        else:
            planes = _timed(parts, "device_alloc", lambda: (
                torch.empty((n, 4, words), dtype=torch.int32, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev)))
            if route == "pinned":
                pinned = _timed(parts, "pinned_alloc", lambda: torch.empty(
                    (n, L), dtype=torch.uint8, pin_memory=True))
                _timed(parts, "host_copy",
                       lambda: np.copyto(pinned.numpy(), codes))
                staged = _timed(parts, "h2d", lambda: pinned.to(
                    dev, non_blocking=True))
            else:
                staged = _timed(parts, "h2d",
                                lambda: torch.from_numpy(codes).to(dev))
            _timed(parts, "pack", lambda: msa_cuda.pack(staged, *planes))
            del staged, planes
        reps.append({"total_ms": (time.perf_counter() - t0) * 1e3,
                     "parts_ms": parts, "log": logs})
    return {"route": route, "n": n, "L": L, "bytes": n * L, "reps": reps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--L", type=int, default=10000)
    ap.add_argument("--worker", choices=["pinned", "pageable", "pack_bank"])
    args = ap.parse_args()
    if args.worker:
        emit(worker(args.worker, args.n, args.L))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    for turn, route in enumerate(("pinned", "pageable", "pageable", "pinned",
                                  "pack_bank")):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", route, "--n", str(args.n), "--L",
                            str(args.L)], capture_output=True, text=True,
                           timeout=600)
        if p.returncode != 0:
            print(p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        emit({"turn": turn, **json.loads(p.stdout.strip().splitlines()[-1])})
    return 0


if __name__ == "__main__":
    sys.exit(main())
