"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` on first use into a shared
library with a plain C interface, and loaded with ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes). Libraries go into ``_build/``
next to this file, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is rebuilt and
an unchanged one is loaded as it is. Only sources in this package are
compiled. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

#: kernel name -> source file under csrc/
SOURCES = {
    "segment_sum": "segment_sum.cu",
    "segment_minmax": "segment_minmax.cu",
    "segment_multistat": "segment_multistat.cu",
    "segment_cumsum": "segment_cumsum.cu",
    "segment_radixbin": "segment_radixbin.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns, per kernel built,
    ``{"seconds": wall time, "log": compiler output}``."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    report: dict[str, dict] = {}
    failures = []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {SOURCES[n]} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        report[n] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.flox_error_string.argtypes = [ctypes.c_int]
        lib.flox_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.flox_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
