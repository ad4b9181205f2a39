"""Run one cell of the port's benchmark on the card this process is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``.  The last line
of standard output is the result object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and a ``breakdown``; ``checks`` last); the last lines of standard
error are the numbers compared, each beside its limit.  Exits non-zero
with no result where the card or the cell's chips are missing, or where
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths_and_caches() -> None:
    """Import from the checkout (not this script's folder), and keep every
    build and kernel cache at a fixed place inside it."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    base = ROOT / "build" / "portbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths_and_caches()
    import torch

    from portbench import harness as H

    cell = H.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    result = H.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), dev, T_START,
                        device_kind=torch.cuda.get_device_name(0))
    bad = H.loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    H.emit(result, args.workload, args.seed, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
