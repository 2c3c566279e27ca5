"""The port stands alone: importing every ``repro_torch`` module,
``chip_smoke`` and the torch examples (``examples/torch_*.py``) loads
neither JAX nor anything of the JAX package."""
import glob
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = """
import glob, importlib, importlib.util, pkgutil, sys
import repro_torch
names = ["chip_smoke", "repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for path in sorted(glob.glob("examples/torch_*.py")):
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
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
    expected += len(EXAMPLES)
    assert int(proc.stdout.split()[-1]) == expected


EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))


def test_probe_imports_every_torch_example():
    """The five torch examples are among the files the probe loads."""
    assert [os.path.basename(p) for p in EXAMPLES] == [
        "torch_pipegcn_spmd.py", "torch_quickstart.py",
        "torch_serve_decode.py", "torch_stale_halo_transformer.py",
        "torch_train_reddit_sim.py"]


@pytest.mark.parametrize("name", ["repro_torch.core.elastic",
                                  "repro_torch.launch.mesh",
                                  "repro_torch.core.module",
                                  "repro_torch.kernels.ops",
                                  "repro_torch.launch.check_schedule",
                                  "repro_torch.models.halo",
                                  "repro_torch.optim.optimizers",
                                  "repro_torch.analysis.cost",
                                  "repro_torch.models.model",
                                  "repro_torch.models.moe",
                                  "repro_torch.models.mla",
                                  "repro_torch.models.ssd",
                                  "repro_torch.models.rglru",
                                  "repro_torch.models.shardctx",
                                  "repro_torch.launch.serve"])
def test_probe_walks_the_elastic_modules(name):
    """The elastic runtime's modules, those of the GCN-side API and the LM
    serve path's are among those the probe imports."""
    import repro_torch
    assert name in {m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")}
