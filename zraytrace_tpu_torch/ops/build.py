"""Build the package's native sources into shared libraries, at first use.

``nvcc`` compiles ``csrc/<name>.cu`` (plus every ``csrc/*.cuh``) for
Hopper (``sm_90a``) into a library with a plain C interface, loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.
``g++`` compiles the host-side preprocessing (``native/*.cpp``: the OBJ
parser and the BVH builder) the same way. Libraries land in
``build/zraytrace_tpu_torch/`` at the checkout root, named by a hash of
the sources and flags, so each version builds once.

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
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
HOST_SRC = PACKAGE / "native"
BUILD_DIR = PACKAGE.parent / "build" / "zraytrace_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


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


def _compile(stem: str, compiler: str, flags, sources, inputs) -> dict:
    """Run ``compiler flags -o <lib> inputs`` unless a library built from
    the same ``sources`` and ``flags`` exists. Returns ``{"path",
    "seconds", "cached", "log"}``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return dict(path=out, seconds=0.0, cached=True, log=log)
    # one name per thread: two checkouts may hold the same sources and build at once
    tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, inputs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return dict(path=out, seconds=seconds, cached=False, log=log)


@functools.cache
def build(name: str, csrc: Path = CSRC) -> dict:
    """Compile ``<csrc>/<name>.cu`` with nvcc unless the same sources were
    built already; ``log`` holds ``-Xptxas -v``'s resource report. ``csrc``
    names another checkout's sources, for a measurement beside this one."""
    main = csrc / f"{name}.cu"
    return _compile(name, find_nvcc(), NVCC_FLAGS, [main] + sorted(csrc.glob("*.cuh")), [main])


@functools.cache
def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Build (if needed) and load ``<csrc>/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name, csrc)["path"]))


@functools.cache
def build_host() -> dict:
    """Compile ``native/*.cpp`` with g++ into one host library."""
    sources = sorted(HOST_SRC.glob("*.cpp"))
    return _compile("host", shutil.which("g++") or "g++", GXX_FLAGS, sources, sources)


@functools.cache
def load_host() -> ctypes.CDLL:
    return ctypes.CDLL(str(build_host()["path"]))
