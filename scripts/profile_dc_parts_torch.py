#!/usr/bin/env python3
"""Where kernel 8b's time goes (csrc/dc_cluster_build.cu), on one GPU.

    python3 scripts/profile_dc_parts_torch.py

Two measurements on made-up chunks (dc/cluster_model.py::made_up_chunk,
"random", the D&C 30K run's bucket shapes: 1,052 clusters of bucket 8, 415
of 32, 17 of 128):

1. The launch's time by cluster size: every cluster of the chunk given the
   same size s (0, 1, 2, 4, cmax / 2, cmax), each launch on a fresh state,
   five queued behind a device sleep (chip_smoke.py::queued_each_ms), the
   median: s = 0 is the launch with its staging in and out; the slope is
   a member's cost.
2. A member by part, in clock cycles of the card: a copy of
   dc_cluster_build.cu with clock64() stamps for warp 0 of block 0 of the
   warp plan (the score, the minimum, the splice, the flags and the walk)
   is written to dipper_tpu_torch/build/, built there with nvcc and run
   once per chunk after a warm-up; the stamps of each member are read
   back.

Prints JSON lines; the card's name, power limit and SM clock first. Needs
CUDA and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (anchor in dc_cluster_build.cu, the stamped text put in its place)
STAMPS = [
    ('#include "insert_step.cuh"\n',
     '#include "insert_step.cuh"\n'
     "__device__ long long g_stamps[64][8];\n"
     "#define STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0 "
     "&& kq < 64) g_stamps[kq][k] = clock64(); } while (0)\n"),
    ("        if (next)\n            row_load(dq + (long long)(kq + 1) * "
     "ch.dq_k,\n                     row_entries(ch, kq + 1), lane, kWarp, "
     "ahead);\n",
     "        STAMP(0);\n        if (next)\n            row_load(dq + "
     "(long long)(kq + 1) * ch.dq_k,\n                     row_entries(ch, "
     "kq + 1), lane, kWarp, ahead);\n"),
    ("        best = warp_min_all(best);\n",
     "        STAMP(1);\n        best = warp_min_all(best);\n"),
    ("        member_tail(sl, lane, best, n_used, kq, ch.cmax);\n",
     "        STAMP(2);\n        member_tail(sl, lane, best, n_used, kq, "
     "ch.cmax);\n        STAMP(4);\n"),
    ("                                 &first, &bl);\n",
     "                                 &first, &bl);\n    STAMP(3);\n"),
]
PARTS = {"score": (0, 1), "minimum": (1, 2), "splice": (2, 3),
         "flags_and_walk": (3, 4)}
CASES = ((8, 1052), (32, 415), (128, 17))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def stamped_library() -> ctypes.CDLL:
    """The stamped copy of dc_cluster_build.cu, built and loaded."""
    from dipper_tpu_torch.csrc.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS
    from dipper_tpu_torch.csrc.build import _nvcc

    with open(os.path.join(CSRC_DIR, "dc_cluster_build.cu")) as f:
        src = f.read()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"dc_cluster_build.cu lacks {old!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int dc_cluster_build_stamps(long long* host)\n{\n'
            "    return (int)cudaMemcpyFromSymbol(host, g_stamps, "
            "sizeof(g_stamps));\n}\n")
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, "dc_cluster_build_stamped.cu")
    lib = os.path.join(BUILD_DIR, "libdc_cluster_build_stamped.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", lib, cu],
                   check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_dc_parts_torch: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dipper_tpu_torch.dc import cluster, cluster_cuda
    from dipper_tpu_torch.dc import cluster_model as cm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = stamped_library()
    fn = lib.dc_cluster_build
    fn.restype = ctypes.c_int
    fn.argtypes = cluster_cuda._BUILD_ARGS
    for cmax, C in CASES:
        Dq, cd, cid, lens, _ = cm.made_up_chunk("random", C, cmax,
                                                "float32", seed=cmax)
        Dq, cd, cid, lens = (torch.from_numpy(x).to(dev)
                             for x in (Dq, cd, cid, lens))

        def fresh():
            return cluster.cluster_init_state(cd, cid, lens, cmax,
                                              with_adj=True)

        by_size = {}
        for size in sorted({0, 1, 2, 4, cmax // 2, cmax}):
            sizes = cluster_cuda.upload_sizes(np.full(C, size), dev)
            cluster_cuda.build_chunk(*fresh(), Dq, sizes, cmax)
            states = [fresh() for _ in range(5)]
            times = cs.queued_each_ms([
                lambda st=st, sc=sc: cluster_cuda.build_chunk(
                    st, sc, Dq, sizes, cmax) for st, sc in states])
            by_size[size] = float(np.median(times))
        rec = {"cmax": cmax, "clusters": C, "precision": "f32",
               "plan": cluster_cuda.kernel_plan(cmax, Dq.dtype)[0],
               "ms_by_size": by_size}
        if rec["plan"] == "warp":
            sizes = cluster_cuda.upload_sizes(np.full(C, cmax), dev)
            M = 2 + 2 * cmax
            for _ in range(2):  # a warm-up, then the stamped run
                st, sc = fresh()
                spill = [torch.empty((C, 2, M), dtype=t, device=dev)
                         for t in (torch.int32, torch.int32, Dq.dtype)]
                rc = fn(st.e.data_ptr(), st.belong.data_ptr(),
                        st.length.data_ptr(), st.rev.data_ptr(),
                        st.cdis.data_ptr(), st.cid.data_ptr(),
                        st.adj.data_ptr(), *(t.data_ptr() for t in spill),
                        sc.data_ptr(), Dq.data_ptr(), Dq.stride(0),
                        Dq.stride(1), Dq.shape[2], sizes.data_ptr(), C, cmax,
                        0, dev.index, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"the stamped kernel returned {rc}")
            host = (ctypes.c_longlong * (64 * 8))()
            if lib.dc_cluster_build_stamps(host) != 0:
                raise RuntimeError("reading the stamps failed")
            a = np.array(host, dtype=np.int64).reshape(64, 8)[:cmax]
            rec["cycles_a_member"] = {
                k: float((a[:, j] - a[:, i]).mean())
                for k, (i, j) in PARTS.items()}
            rec["cycles_a_member"]["whole"] = float((a[:, 4] - a[:, 0])
                                                    .mean())
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
