"""Build the hand-written CUDA kernels in ``csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Libraries go to
``build/kernels/`` at the repo root, named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused; the
compiler's report is kept beside each library.  The build runs at first
use, never at import.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels in "
                       f"{CSRC} need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is, once built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the source and shared headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc`` each,
    all started together. Returns ``{name: {"seconds", "log"}}`` where log
    is the compiler's report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, path, time.perf_counter())
    report = {}
    for name, (proc, tmp, path, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
        path.with_suffix(".log").write_text(log)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def build_log(name: str) -> str:
    """The compiler's report of the built library for ``csrc/<name>.cu``
    (registers, shared memory, spills), or "" if it is not built.
    ``compare_checkouts`` runs its source in other checkouts, beside their
    ``library_path``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
