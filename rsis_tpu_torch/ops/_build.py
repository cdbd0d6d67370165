"""Build and load the port's CUDA kernels (``rsis_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``. Nothing happens at import: a
kernel is built on its first CUDA use, or by ``build()`` (which starts one
``nvcc`` for each source, all at once). Libraries go into
``build/rsis_tpu_torch/`` at the repository root, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused. Only sources in the repository are compiled.
"""

from __future__ import annotations

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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rsis_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> Dict[str, Path]:
    """Kernel name -> source file, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _library_path(name: str, src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, dict]:
    """Compile the named kernels (all when None) concurrently.

    Returns name -> {"path", "seconds", "log"}; "log" holds nvcc's
    ``-Xptxas=-v`` report (registers, shared memory, spills) of a fresh
    build and is empty for a library that was already built. Raises
    RuntimeError with nvcc's output if a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = []
    t0 = time.perf_counter()
    for name in names:
        path = _library_path(name, srcs[name])
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": time.perf_counter() - t0,
                     "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of one kernel, building it first if needed."""
    return ctypes.CDLL(str(build([name])[name]["path"]))
