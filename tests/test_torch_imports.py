"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` loads neither JAX nor anything of the JAX package."""
import os
import pkgutil
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["chip_smoke", "repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
print(len(names))
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import repro_torch
    expected = 2 + len(list(pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")))
    assert int(proc.stdout.split()[-1]) == expected
