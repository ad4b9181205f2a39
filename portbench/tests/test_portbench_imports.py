"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
program), and nothing of the program in the reference."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PRELUDE = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
torch.set_num_threads(1)
"""

RUN = PRELUDE + """
import portbench.run
from portbench.tests import _tiny
for w in ("dense.prefill", "moe.prefill", "dense.train"):
    _tiny.run(w, seconds=0.05, trace=True)
from portbench import calibrate, harness
for m in json.load(open(harness.ROOT / "BENCHMARK.json"))["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = PRELUDE + """
from portbench import weights as W
from portbench.reference import model as RM, train as RT
from portbench.tests._tiny import TINY
for name in ("tiny-dense", "tiny-moe"):
    cfg = json.load(open(TINY / "configs" / f"{name}.json"))
    params = W.make_weights(cfg, 1, "cpu")
    ids = W.token_pool(1, "t", 1, 1, 33, cfg["vocab_size"], "cpu")[0]
    RM.Reference(cfg, params).last_logits(ids)
    RT.train_steps(cfg, {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                         "clip_norm": 1.0, "warmup_steps": 0, "total_steps": 10},
                   params, [(ids[:, :-1], ids[:, 1:])])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = loaded(RUN)
    assert "repro_torch" in names and "portbench" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix() for p in PB.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = _imports(PB / path)
    assert not tops & FORBIDDEN
    if path.startswith("reference/"):
        assert "repro_torch" not in tops


def test_the_entry_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                          "phi3-mini.prefill_4x4k", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
