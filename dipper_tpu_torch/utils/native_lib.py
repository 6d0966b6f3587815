"""Builds the host libraries under native/ with `make` at first use.

Several processes may reach a library's first use at once (pytest's
workers, a pipeline that starts many jobs on a fresh checkout). Each
takes an exclusive `fcntl` lock on `native/.build.lock` around the
staleness check and the build, and `make` writes the library into a
temporary directory from which it is renamed onto its target, so no
process ever loads a half-written file. native/Makefile is used as it is
(through VPATH), not edited.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import shutil
import subprocess
import tempfile

NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))


@contextlib.contextmanager
def _locked(native_dir: str):
    with open(os.path.join(native_dir, ".build.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _stale(lib: str, src: str) -> bool:
    return (not os.path.exists(lib)
            or (os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(lib)))


def native_library(name: str, source: str,
                   native_dir: str = NATIVE_DIR) -> str | None:
    """Path of `native_dir/name` (e.g. "libsketchnat.so"), built from
    `source` with the directory's Makefile if it is missing or older than
    the source. Returns None when it cannot be built and does not exist."""
    lib = os.path.join(native_dir, name)
    src = os.path.join(native_dir, source)
    try:
        with _locked(native_dir):
            if not _stale(lib, src):
                return lib
            tmp = tempfile.mkdtemp(prefix=".build-", dir=native_dir)
            try:
                subprocess.run(
                    ["make", "-C", tmp, "-f",
                     os.path.join(native_dir, "Makefile"),
                     f"VPATH={native_dir}", name],
                    check=True, capture_output=True, timeout=300)
                os.replace(os.path.join(tmp, name), lib)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    except (OSError, subprocess.SubprocessError):
        pass  # no toolchain, or the build failed: use what exists
    return lib if os.path.exists(lib) else None
