"""Builds and loads the port's CUDA kernels with nvcc at first use.

Each kernel is one `.cu` file with a plain C entry point named like the
file, `int <name>(..., void* stream)` returning a CUDA error code, and
`const char* <name>_error_string(int)`. It is compiled into
`dipper_tpu_torch/build/lib<name>.so` and loaded with ctypes (no PyTorch
headers, so a build takes seconds). A library is rebuilt when its source
or any header of this directory is newer than it, as the host libraries
under native/ are. nvcc's output, including ptxas's register and spill
report, is kept beside the library as `lib<name>.log`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "build")

# every kernel of the port: library name -> source in this directory
KERNELS = {
    "mash_merge_count": "mash_merge_count.cu",
    "mash_rows_dist": "mash_rows_dist.cu",
    "side_vector": "side_vector.cu",
    "score_edges": "score_edges.cu",
    "mash_cluster_inter": "mash_cluster_inter.cu",
    "minhash_sketch": "minhash_sketch.cu",
    "insert_step": "insert_step.cu",
    "nj_q_argmin": "nj_q_argmin.cu",
    "nj_update": "nj_update.cu",
    "score_masked": "score_masked.cu",
    "dc_cluster_build": "dc_cluster_build.cu",
    "exact_step": "exact_step.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# seconds spent in nvcc by this process, per library (0 when up to date)
BUILD_SECONDS: dict[str, float] = {}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
            "CUDA toolkit is needed to build the port's kernels")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _up_to_date(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return False
    deps = [os.path.join(CSRC_DIR, KERNELS[name])]
    deps += glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib) >= max(map(os.path.getmtime, deps))


def build_all(names=None) -> dict[str, str]:
    """Compiles the named kernels (default: all) that are not up to date,
    one nvcc process per source, all started together; returns each
    library's path. Raises with nvcc's output when a compile fails."""
    names = list(KERNELS if names is None else names)
    running = []
    for name in names:
        if _up_to_date(name):
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, KERNELS[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, cmd, tmp, proc, time.time()))
    failed = []
    for name, cmd, tmp, proc, t0 in running:
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.time() - t0
        with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            failed.append(f"nvcc failed to build {KERNELS[name]} (exit "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            # atomic: concurrent builders never load a torn file
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name: str, argtypes) -> ctypes.CDLL:
    """The kernel library `name`, built if needed, with its entry point
    `name` (int return, `argtypes`) and `name_error_string` declared."""
    if name not in _loaded:
        lib = ctypes.CDLL(build_all([name])[name])
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _loaded[name] = lib
    return _loaded[name]


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raises when a launcher returned a CUDA error code other than 0."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
