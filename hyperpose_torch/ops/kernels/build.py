"""Build and load the port's CUDA kernels.

Each source `hyperpose_torch/csrc/<name>.cu` exposes a plain C interface and
is compiled by `nvcc` for Hopper (sm_90a) into its own shared library, which
is loaded with ctypes; sources may include the shared headers `csrc/*.cuh`.
Libraries go to `build/hyperpose_torch/` beside the package (the repo's
`.gitignore` lists `build/`); the file name carries a hash of the source,
every header and the flags, so an edited source or header is rebuilt and
never confused with a stale library. The first call builds: nothing happens
when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "hyperpose_torch"
KERNELS = ("line_gather", "peak_topk", "conv1_pool", "stem_gemm", "grow", "int8_gemm",
           "int8_dwconv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}  # nvcc's -Xptxas -v report, per built kernel


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> list[str]:
    """Compile every named kernel whose library is missing, one nvcc process
    per source, all started together. Returns the names it compiled; raises
    with nvcc's output if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
