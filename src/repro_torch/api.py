"""The public experiment API of the port, one import away:

    from repro_torch.api import Study, grid, workload

    rows = Study(workloads=["pagerank-arxiv", "htap128"]).run() \\
        .pivot("workload", "mechanism", "speedup")

The same names as :mod:`repro.api`.  Everything runs on the CUDA card
unless ``device="cpu"`` is passed; ``Study.run(devices=d)`` shards the
lane axis over ``d`` cards (:mod:`repro_torch.sim.mesh`).
"""

from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.core.mechanisms import SimResult
from repro_torch.core.signatures import SignatureSpec
from repro_torch.sim.costmodel import HWParams
from repro_torch.sim.engine import (
    MECHANISMS,
    run_all,
    run_batch,
    run_sweep,
    run_workload,
    summarize,
    sweep_cache_sizes,
)
from repro_torch.sim.prep import TraceTensors, prepare
from repro_torch.sim.study import (
    Dispatch,
    HWGrid,
    ResultSet,
    Study,
    StudyPlan,
    StudyPoint,
    Workload,
    grid,
    workload,
)
from repro_torch.sim.trace import all_workloads, make_trace

__all__ = [
    "Study", "StudyPlan", "StudyPoint", "ResultSet",
    "Workload", "workload", "HWGrid", "grid", "Dispatch",
    "HWParams", "LazyPIMConfig", "SignatureSpec",
    "SimResult", "TraceTensors", "MECHANISMS",
    "run_all", "run_batch", "run_sweep", "run_workload", "summarize",
    "sweep_cache_sizes", "prepare", "make_trace", "all_workloads",
]
