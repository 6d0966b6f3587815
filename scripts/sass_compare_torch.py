#!/usr/bin/env python3
"""Compares the SASS of the port's kernels between this checkout and an
earlier one: each source of --sources is compiled in both by nvcc with
csrc/build.py's flags, `cuobjdump -sass` lists each library's functions,
and every function found in both is compared line for line, with the
anonymous namespace's per-file name (_GLOBAL__N__<hash>) normalized. One
JSON line a source: the functions equal, those that differ (and how many
of their lines), and those only in one of the two.

    python3 scripts/sass_compare_torch.py --parent build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dipper_tpu_torch.csrc.build import NVCC_FLAGS, _nvcc  # noqa: E402

ANON = re.compile(r"_GLOBAL__N__[0-9a-f_]+")


def functions(lib: str) -> dict:
    """cuobjdump -sass of `lib`: function name -> its SASS lines."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], check=True,
                         capture_output=True, text=True, timeout=600).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        ln = ANON.sub("_GLOBAL__N_", ln.strip())
        if ln.startswith("Function :"):
            name = ln.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None and ln:
            funcs[name].append(ln)
    return funcs


def build(root: str, source: str, out: str) -> str:
    lib = os.path.join(out, os.path.basename(source) + ".so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib,
                    os.path.join(root, "dipper_tpu_torch", "csrc", source)],
                   check=True, capture_output=True, timeout=900)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the earlier checkout (git archive)")
    ap.add_argument("--sources", default="insert_step.cu,dc_stream_block.cu,"
                    "dc_cluster_build.cu")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        for src in args.sources.split(","):
            libs = []
            for tag, root in (("parent", args.parent), ("this", REPO)):
                os.makedirs(os.path.join(tmp, tag), exist_ok=True)
                libs.append(functions(build(root, src,
                                            os.path.join(tmp, tag))))
            old, new = libs
            both = sorted(set(old) & set(new))
            differ = {f: sum(a != b for a, b in zip(old[f], new[f]))
                      + abs(len(old[f]) - len(new[f]))
                      for f in both if old[f] != new[f]}
            print(json.dumps({
                "source": src, "functions_equal": len(both) - len(differ),
                "lines_compared": sum(len(old[f]) for f in both),
                "differ": differ,
                "only_parent": sorted(set(old) - set(new)),
                "only_this": sorted(set(new) - set(old))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
