"""The port stands alone: every module of repro_torch imports in a fresh
interpreter in which ``jax`` and ``repro`` cannot be imported at all."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
# the walk reaches the study service and its runtime helpers
missing = {"repro_torch.runtime.fault_tolerance", *(f"repro_torch.serve.{m}" for m in (
    "chaos", "clock", "coalesce", "policy", "queueing", "request", "retry", "server",
    "warm"))} - set(names)
assert not missing, missing
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    # the package, its subpackages and modules: at least the ones of this slice
    assert int(out.stdout.strip()) >= 60


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    import ast

    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the script exits non-zero and prints no result
    line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(SRC.parent / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


_REF_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import dataclasses, torch
from repro_torch.sim import _traceref
from repro_torch.sim.trace import make_trace
for app, g in (("mtmix", "arxiv"), ("htap_stream", None)):
    kw = dict(num_kernels=2, device="cpu")
    a, b = make_trace(app, g, backend="ref", **kw), make_trace(app, g, **kw)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
            and sys.modules[m] is not None]
print("ok")
"""


def test_trace_reference_runs_without_jax_or_repro():
    """The port's numpy trace reference (``sim/_traceref.py``) has its own
    Threefry: with ``jax`` and ``repro`` blocked, ``backend="ref"`` still
    regenerates the tensor path's traces."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _REF_PROBE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
