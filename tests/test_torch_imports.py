"""The port imports neither JAX nor the JAX package: every module of
``zraytrace_tpu_torch`` imported in a fresh interpreter leaves both out
of ``sys.modules``."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CODE = """
import importlib, pkgutil, sys
import zraytrace_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(zraytrace_tpu_torch.__path__,
                                                      "zraytrace_tpu_torch.")
               if not m.name.endswith("__main__"))  # runs the CLI
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "zraytrace_tpu"))
print(len(names), "modules;", "jax-side modules:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _CODE], capture_output=True, text=True,
                       timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split()[0])
    # the modules this rule matters most for are among them
    assert n >= 40, r.stdout
    for name in ("checkpoint", "dryrun", "parallel.mesh", "parallel.multihost",
                 "parallel.primshard"):
        assert (ROOT / "zraytrace_tpu_torch" / (name.replace(".", "/") + ".py")).exists()
