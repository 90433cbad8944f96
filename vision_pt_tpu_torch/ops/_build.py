"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``csrc/build/lib<name>-<hash>.so`` (the hash is of the
source, so an edited source rebuilds), then loaded with ``ctypes``. The build
happens at first use; :func:`build` compiles several sources at once, one
``nvcc`` process each. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) and seconds of each build
build_logs: dict[str, tuple[str, float]] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[Path, Path]:
    """The source and its library; the hash covers the source and every
    shared header in ``csrc``, so an edit to either rebuilds."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every source in ``names`` that has no library yet, all nvcc
    processes started together; raise if any of them fails."""
    with _lock:
        todo = [(n, *_target(n)) for n in names]
        todo = [(n, src, so) for n, src, so in todo if not so.exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for name, src, so in todo:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, so, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = (log, time.perf_counter() - t0)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _libs[name] = lib
    return lib
