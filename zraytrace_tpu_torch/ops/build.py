"""Build the package's CUDA sources into a shared library, at first use.

``nvcc`` compiles ``csrc/<name>.cu`` (plus every ``csrc/*.cuh``) for
Hopper (``sm_90a``) into a library with a plain C interface, loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.
Libraries land in ``build/zraytrace_tpu_torch/`` at the checkout root,
named by a hash of the sources and flags, so each version builds once.

``-fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch version computes them, so the kernel can be held to it
tightly. Allowing contraction is a later performance lever.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zraytrace_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)


def find_nvcc() -> str:
    """The CUDA compiler: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


@functools.cache
def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless the same sources were built
    already. Returns ``{"path", "seconds", "cached", "log"}``; ``log`` is
    nvcc's output (with ``-Xptxas -v``'s resource report)."""
    sources = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return dict(path=out, seconds=0.0, cached=True, log=log)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return dict(path=out, seconds=seconds, cached=False, log=log)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name)["path"]))
