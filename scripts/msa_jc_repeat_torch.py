#!/usr/bin/env python3
"""Repeats the card test of the MSA distances against the CPU
(tests/test_torch_cuda.py::test_msa_distances_cuda_close_to_cpu, the six
models in f32 and f64) in processes of their own, and shows JC's f32
steps on the test's input on both devices.

Each run is `python -m pytest --noconftest tests/test_torch_cuda.py -q
-k test_msa_distances_cuda_close_to_cpu`; one JSON line a run (exit
code, failed test ids), then a summary. Then, for JC in f32 (-d 2) on
the test's alignment, the pair furthest from the CPU's value in units of
the test's tolerance, with its intermediate values on both devices as
hex floats: the counts, uncor, uncor / 0.75, 1 - uncor / 0.75, the log
and the distance, and the first of them that differs. Run on the card
from the root of a checkout:

    python3 scripts/msa_jc_repeat_torch.py --runs 30
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

TEST = "test_msa_distances_cuda_close_to_cpu"


def jc_steps(codes, dev: torch.device) -> dict:
    """JC's f32 intermediates over the whole alignment on `dev`, in
    distance/msa.py::_block_distance's operations."""
    from dipper_tpu_torch.distance import msa

    codes_d = torch.as_tensor(codes).to(dev)
    nongap = msa.nongap_counts(codes_d, "float32")
    phi = msa.one_hot_channels(codes_d)
    P4 = msa.pair_counts(phi, phi)
    P = lambda a, b: P4[:, a, :, b].to(torch.float32)  # noqa: E731
    tot = P(4, 4)
    match = P(0, 0) + P(1, 1) + P(2, 2) + P(3, 3)
    useful = nongap[:, None] + nongap[None, :] - tot
    uncor = 1.0 - match / useful
    ratio = uncor / torch.full((), 0.75, dtype=torch.float32, device=dev)
    arg = 1.0 - ratio
    lg = torch.log(arg)
    dist = -0.75 * lg
    return {k: v.cpu() for k, v in (
        ("match", match), ("useful", useful), ("uncor", uncor),
        ("uncor / 0.75", ratio), ("1 - uncor / 0.75", arg), ("log", lg),
        ("distance", dist))}


def diagnose() -> dict:
    from datagen import simulate_alignment
    import numpy as np
    from dipper_tpu_torch.io.encode import batch_codes, encode_4bit_codes

    # the test's input (tests/test_torch_cuda.py::_aligned_codes(150, 500,
    # 6, blen_scale=0.3))
    _, seqs = simulate_alignment(150, 500, np.random.default_rng(6),
                                 gap_frac=0.05, blen_scale=0.3)
    codes = batch_codes(seqs, encode_4bit_codes, pad_value=4)[0]
    cpu = jc_steps(codes, torch.device("cpu"))
    gpu = jc_steps(codes, torch.device("cuda"))
    want, got = cpu["distance"], gpu["distance"]
    tol = 2e-6 * want.abs() + 64 * torch.finfo(torch.float32).eps
    excess = ((got - want).abs() / tol).nan_to_num(0.0)
    i, j = divmod(int(torch.argmax(excess)), want.shape[1])
    pair = {}
    first = None
    for k in cpu:
        a, b = float(cpu[k][i, j]), float(gpu[k][i, j])
        pair[k] = {"cpu": a.hex(), "cuda": b.hex()}
        if first is None and a != b and not (a != a and b != b):
            first = k
    return {"pair": [i, j], "err_over_tolerance": float(excess[i, j]),
            "steps": pair, "first_step_that_differs": first,
            "steps_differing_anywhere": {
                k: int((cpu[k] != gpu[k]).sum() - (cpu[k].isnan()
                                                   & gpu[k].isnan()).sum())
                for k in cpu}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("msa_jc_repeat_torch: CUDA is not available", file=sys.stderr)
        return 1
    failed = {}
    for r in range(args.runs):
        res = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest",
             "tests/test_torch_cuda.py", "-q", "-p", "no:cacheprovider",
             "-k", TEST], cwd=REPO, capture_output=True, text=True)
        ids = re.findall(r"FAILED (\S+)", res.stdout)
        for t in ids:
            failed[t] = failed.get(t, 0) + 1
        print(json.dumps({"run": r, "rc": res.returncode, "failed": ids,
                          "passed": int((re.findall(r"(\d+) passed",
                                                    res.stdout) or [0])[-1])}),
              flush=True)
    print(json.dumps({"runs": args.runs, "failures_by_test": failed,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(json.dumps({"jc_f32": diagnose()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
