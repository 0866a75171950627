"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX
package ``raintpu``: whole top-level module names, since the port's
name, raintpu_torch, begins with raintpu."""

import subprocess
import sys
import types

from rainbench import run, spec

PROBE = """
import sys, time
from rainbench import harness, run
from rainbench.tests.conftest import tiny
for name in ("kitti-10mm-envmap", "nuscenes-100mm", "kitti-online-25mm"):
    harness.run(tiny(name), 77, 0.2, False, "cpu", time.perf_counter())
print(",".join(run.forbidden_modules()) or "none")
print("raintpu_torch" in sys.modules)
"""


def test_set_up_and_run_import_no_jax():
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split() == ["none", "True"]


def test_names_are_compared_whole(monkeypatch):
    for name in ("raintpu_torch", "raintpu_torch.render", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raintpu.render",
                        types.ModuleType("raintpu.render"))
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib", "raintpu"]
