"""Serving examples on the PyTorch port: continuous token batching and the
resilient resident study service.  The counterpart of
``examples/serve_batched.py``.

    PYTHONPATH=src python examples/torch_serve_batched.py               # on the card
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu  # plain PyTorch

Part 1 drives the continuous-batching token loop.  Part 2 stands up a
:class:`repro_torch.serve.StudyServer` with 25% injected chaos faults and
shows every fault class resolving explicitly — reject, retry-success,
degrade to the bit-exact sequential engine, or crash-then-warm-restart —
with zero wrong results.  ``--storm`` sets the number of study requests
(default 12).
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ChaosConfig,
    ChaosMonkey,
    ServeConfig,
    StudyServer,
    make_storm,
    restart_server,
)

SMALL = dict(num_kernels=3, windows_per_kernel=2)
SPECS = [
    {"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4,
                    **SMALL}],
     "mechanisms": ["cpu", "cg", "lazypim"], "threads": 16},
    {"workloads": [{"app": "htap128", "scale": 0.004, **SMALL}],
     "mechanisms": ["cpu", "cg", "lazypim"], "threads": 16},
]


def token_demo(device) -> list:
    args = argparse.Namespace(arch="qwen3-4b", smoke=True, requests=6,
                              batch=3, max_new=8, max_len=48, seed=0, device=device)
    served = serve(args)
    for r in served:
        print(f"req {r.rid}: prompt {len(r.prompt)} toks -> "
              f"{len(r.out) - len(r.prompt)} new toks")
    if len(served) != args.requests:
        raise RuntimeError(f"{len(served)} of {args.requests} requests served")
    return served


def study_service_demo(device, n_requests: int) -> tuple[dict, ChaosMonkey]:
    monkey = ChaosMonkey(ChaosConfig(seed=2, fault_rate=0.25, hang_s=5.0))
    final = {}
    with tempfile.TemporaryDirectory(prefix="repro-serve-demo-") as cache_dir:
        cfg = ServeConfig(default_deadline_s=120.0, heartbeat_timeout_s=2.0,
                          backoff_base_s=0.01, max_lanes=64,
                          cache_dir=cache_dir, device=device)
        server = StudyServer(cfg, chaos=monkey)
        monkey.clock = server.clock

        for spec in make_storm(monkey, n_requests, SPECS):
            out = server.submit(spec)
            if not isinstance(out, int):
                final[out.rid] = out
        for r in server.drain():
            final[r.rid] = r
        while server.crashed:
            print("worker crashed — restarting from the warm manifest")
            server, replayed = restart_server(cfg, chaos=monkey)
            for r in [*replayed, *server.drain()]:
                final[r.rid] = r

    for rid in sorted(final):
        r = final[rid]
        mark = " (recovered after crash)" if r.restarted else ""
        print(f"study req {rid}: {r.status} engine={r.engine} "
              f"attempts={r.attempts}{mark}")
    if any(r.status == "crashed" for r in final.values()):
        raise RuntimeError("a request was left crashed")
    print(f"chaos injected: {monkey.injected or 'nothing'}")
    return final, monkey


def main(argv=None) -> dict:
    """Both demos; returns what they print: the served token requests, the
    study service's final response by rid and the faults injected."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    ap.add_argument("--storm", type=int, default=12)
    args = ap.parse_args(argv)
    print("== continuous token batching ==")
    served = token_demo(args.device)
    print("\n== resident study service under chaos ==")
    final, monkey = study_service_demo(args.device, args.storm)
    return {"served": served, "responses": final, "injected": list(monkey.injected)}


if __name__ == "__main__":
    main()
