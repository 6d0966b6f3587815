"""Runs tests/torch_parallel_worker.py as a gloo group of CPU processes
(a FileStore under the test's temporary directory, so that xdist workers
never share a port) and returns each rank's results. The group has a
wall-clock limit; past it every rank is killed and the test fails."""

import os
import subprocess
import sys
import time

import numpy as np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
GROUP_TIMEOUT_S = 120


def run_group(world: int, inputs: dict, tmp_dir, timeout=GROUP_TIMEOUT_S):
    """inputs: case -> {key: array}, each with a "kind". Returns a list of
    `world` dicts (one a rank) case -> {key: array}."""
    tmp_dir = str(tmp_dir)
    flat = {f"{case}.{k}": np.asarray(v)
            for case, d in inputs.items() for k, v in d.items()}
    inp = os.path.join(tmp_dir, "in.npz")
    np.savez(inp, **flat)
    store = os.path.join(tmp_dir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store,
         ",".join(inputs), inp, tmp_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a group of {world} ranks ran past "
                             f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    results = []
    for r in range(world):
        with np.load(os.path.join(tmp_dir, f"rank{r}.npz")) as z:
            got = {}
            for key in z.files:
                case, k = key.split(".", 1)
                got.setdefault(case, {})[k] = z[key]
            results.append(got)
    return results
