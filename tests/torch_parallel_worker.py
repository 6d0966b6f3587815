"""One rank of a gloo group of CPU processes, for tests/test_torch_parallel.py
and tests/test_torch_tools.py: joins the group through a FileStore, builds
the requested cases with the port's sharded entry points, checks that no
JAX module was imported, and writes its results.

Usage: torch_parallel_worker.py RANK WORLD STORE_FILE CASES IN.npz OUT_DIR

CASES is a comma-separated list of keys of IN.npz's "case_*" entries; each
case's inputs are the entries "<case>.*". Results go to
OUT_DIR/rank<RANK>.npz as "<case>.*" arrays.
"""

import os
import sys

rank, world, store, cases, inp, outdir = (int(sys.argv[1]),
                                          int(sys.argv[2]), *sys.argv[3:7])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from dipper_tpu_torch.dc import pipeline as tpl  # noqa: E402
from dipper_tpu_torch.nj import neighbor_joining  # noqa: E402
from dipper_tpu_torch.parallel import (make_mesh, sharded_mash_matrix,  # noqa: E402
                                       sharded_placement_build)
from dipper_tpu_torch.parallel.distributed import (init_distributed,  # noqa: E402
                                                   to_host)
from dipper_tpu_torch.utils.params import Param  # noqa: E402

init_distributed(f"file://{store}", world, rank)
mesh = make_mesh(device="cpu", log=lambda m: None)
data = np.load(inp)
out = {}
for case in cases.split(","):
    kind = str(data[f"{case}.kind"])
    get = lambda key: data[f"{case}.{key}"]  # noqa: E731
    if kind == "matrix":
        D = sharded_mash_matrix(get("ranks"), int(get("k")), int(get("ss")),
                                mesh, dtype="float64")
        out[f"{case}.D"] = D.numpy()
    elif kind == "placement":
        e, b, l = sharded_placement_build(get("sketches"), int(get("k")),
                                          int(get("ss")), mesh,
                                          dtype=str(get("dtype")))
        out.update({f"{case}.e": e, f"{case}.belong": b,
                    f"{case}.length": l})
    elif kind == "nj":
        N = get("D").shape[0]
        ch, root = neighbor_joining(get("D"), dtype_name=str(get("dtype")),
                                    device="cpu", mesh=mesh)
        joins = ch[N:2 * N - 1]
        out[f"{case}.ids"] = np.array([[c for c, _ in v] for v in joins])
        out[f"{case}.bl"] = np.array([[b for _, b in v] for v in joins])
        out[f"{case}.root"] = np.array(root)
    elif kind == "dc":
        for knob in ("PHASE2_CHUNK", "PHASE3_BUDGET", "_STREAM_CLUSTER_MIN",
                     "_STREAM_ROW_BLOCK"):
            if f"{case}.{knob}" in data:
                setattr(tpl, knob, int(get(knob)))
        b = int(get("b"))
        params = Param(in_format="d", dtype="float64", backbone_size=b,
                       batch_size=b)
        n = get("D").shape[0]
        logs = []
        nwk = tpl.build_dc_tree_from_matrix(
            get("D"), [f"L{i}" for i in range(n)], params,
            device=torch.device("cpu"), log=logs.append, mesh=mesh)
        out[f"{case}.newick"] = np.array(nwk)
        out[f"{case}.log"] = np.array("\n".join(logs))
    elif kind == "to_host":
        got = to_host((torch.full((3,), float(rank)), torch.arange(rank + 1)),
                      src=world - 1)
        out[f"{case}.a"], out[f"{case}.b"] = got
    else:
        raise SystemExit(f"unknown case kind {kind!r}")

assert not any(m == "jax" or m.startswith(("jax.", "dipper_tpu."))
               or m == "dipper_tpu" for m in sys.modules), \
    "a rank imported JAX or the JAX package"
np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()
# leave without the interpreter's teardown, in which a c10d thread still
# joinable at times aborted a rank that had finished its work
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
