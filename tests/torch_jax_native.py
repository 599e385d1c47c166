"""The JAX package's native library, loaded in this process, for the port's
tests that compare against the JAX package's BVH:

    from torch_jax_native import jax_native  # an autouse fixture

(pytest puts this directory on ``sys.path``.) Imported into a test
module, the module-scoped autouse fixture ``jax_native`` calls
``ensure_jax_native`` before the module's tests.

The JAX package compiles ``native/*.cpp`` with g++ straight into a cache
path shared by every process. A process that loads the library while
another's g++ is still writing it fails the load, and then builds BVHs
with its numpy fallback for the rest of its life: on scenes 0, 2 and 3
that fallback gives another ``prim_order`` than the C++ construction,
which the port's BVH copies. ``ensure_jax_native`` puts the C++ code
back in place of a failed load, or raises.
"""

import ctypes
import subprocess
import tempfile
from pathlib import Path

import pytest

from zraytrace_tpu.native import api, build


def ensure_jax_native():
    """Make sure the JAX package's BVH build runs its C++ code in this
    process. If the package's own load failed, compile the library again
    in a temporary directory of this process, load it and install it in
    the package. Raise, saying why, if that fails too or if native code is
    switched off (``ZRAYTRACE_NO_NATIVE=1``); never fall back quietly."""
    if build.load_library() is None:
        srcs = [str(build._src_dir() / name) for name in build._SOURCES]
        with tempfile.TemporaryDirectory(prefix="zrt_native_") as tmp:
            so = Path(tmp) / "libzrt.so"
            run = subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                                  *srcs], capture_output=True, text=True, timeout=120)
            if run.returncode:
                raise RuntimeError(f"the JAX package's native library did not build: "
                                   f"{run.stderr}")
            lib = ctypes.CDLL(str(so))  # stays mapped once the file is gone
        build._LIB = lib
        api._sig_done = False  # bind the signatures on this library
    if api._lib() is None:
        raise RuntimeError("the JAX package's native code is off (ZRAYTRACE_NO_NATIVE=1), so "
                           "its BVH comes from the numpy fallback")


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """``ensure_jax_native`` once for each test module that imports this."""
    ensure_jax_native()
