"""The tiny cells the CPU tests run the harness on (``tiny/``): the same
harness, program and reference as a benchmark run, at sizes a test holds,
on the CPU, past the look for a card."""

import json
import time
from pathlib import Path

import torch

from portbench import harness as H

TINY = Path(__file__).parent / "tiny"
BENCH = json.loads((TINY / "bench.json").read_text())
CPU = torch.device("cpu")


def cell(workload: str) -> H.Cell:
    return H.Cell(workload, BENCH, TINY)


def run(workload: str, seed: int = 1, seconds: float = 0.3, trace: bool = False,
        step_factory=None) -> dict:
    torch.set_num_threads(2)
    return H.run_cell(workload, seed, seconds, trace, CPU, time.perf_counter(), bench=BENCH,
                      data=TINY, step_factory=step_factory)
