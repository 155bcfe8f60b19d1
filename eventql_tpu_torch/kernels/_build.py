"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes``. The libraries go to ``kernels/build/`` (not under
version control), named by a hash of their source, so an unchanged
source is compiled once per checkout. All sources are compiled in
parallel, one ``nvcc`` process each. A missing compiler or a failed
compile raises: nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from eventql_tpu_torch.utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# libraries loaded into this process (each load may compile first), by
# source name, since import: past the first query, a load is a kernel
# built again
BUILDS: Dict[str, int] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        os.path.join(os.environ.get("CUDA_PATH", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and"
        " /usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def sources() -> List[str]:
    return sorted(
        f[: -len(".cu")] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(verbose: bool = False) -> float:
    """Compile every source that has no up-to-date library; returns the
    seconds spent compiling."""
    with _LOCK:
        todo = [n for n in sources() if not os.path.exists(_lib_path(n))]
        if not todo:
            return 0.0
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name in todo:
            out = _lib_path(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
            procs.append(
                (
                    name,
                    out,
                    tmp,
                    subprocess.Popen(
                        cmd,
                        stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT,
                        text=True,
                    ),
                )
            )
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                if os.path.exists(tmp):
                    os.remove(tmp)
                continue
            if verbose and log:
                print(log, flush=True)
            os.replace(tmp, out)
        if errors:
            raise KernelBuildError("\n".join(errors))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with trace.span("build") as sp:
        sp.set("library", name)
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(path)
                BUILDS[name] = BUILDS.get(name, 0) + 1
    return lib
