"""Quickstart on the PyTorch port: the paper in 60 seconds.

One declarative ``Study`` runs the LazyPIM coherence simulator on a graph
workload + an HTAP workload (every mechanism, one batched dispatch per
mechanism and geometry bucket) and prints the speedup/traffic/energy
table, then exercises the Bloom-signature kernels the protocol is built on.
The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain PyTorch

``--scale``, ``--num-kernels`` and ``--windows-per-kernel`` shrink both
workloads (the defaults are each workload's own).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.api import Study, workload  # noqa: E402
from repro_torch.core.signatures import SignatureSpec, empty_signature  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.bloom import bloom_insert, bloom_intersect  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--num-kernels", type=int, default=None)
    ap.add_argument("--windows-per-kernel", type=int, default=None)
    return ap.parse_args(argv)


def workloads(args) -> list:
    """The two workloads, at the size the flags give (each one's own
    defaults when none is given)."""
    kw = {k: v for k, v in (("scale", args.scale), ("num_kernels", args.num_kernels),
                            ("windows_per_kernel", args.windows_per_kernel))
          if v is not None}
    if not kw:
        return ["pagerank-arxiv", "htap128"]
    return [workload("pagerank", "arxiv", **kw), workload("htap128", **kw)]


def main(argv=None) -> dict:
    """Run the study and the signature demo; returns what it prints: the
    ``ResultSet``, its CPU-normalized summaries and the two conflict
    verdicts."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    results = Study(workloads=workloads(args), device=dev).run()
    normalized = results.normalized()
    for point, summary in zip(results.points, normalized):
        print(f"\n== {point.workload} (normalized to CPU-only) ==")
        print(f"{'mechanism':10s} {'speedup':>8s} {'traffic':>8s} {'energy':>8s}")
        for m in ("fg", "cg", "nc", "lazypim", "ideal"):
            d = summary[m]
            print(f"{m:10s} {d['speedup']:8.2f} {d['traffic']:8.2f} {d['energy']:8.2f}")
        lz = summary["lazypim"]
        print(f"LazyPIM conflict rate: {lz['conflict_rate']:.1%} "
              f"(exact {lz['conflict_rate_exact']:.1%})")

    # the coherence signatures themselves
    spec = SignatureSpec()

    def signature(ids):
        return bloom_insert(spec, empty_signature(spec, dev),
                            torch.as_tensor(ids, dtype=torch.int64, device=dev))

    pim_reads = signature(range(100, 200))
    cpu_writes = signature([150])
    clean = signature([5000])
    overlap = bool(bloom_intersect(spec, pim_reads[None], cpu_writes[None])[0])
    disjoint = bool(bloom_intersect(spec, pim_reads[None], clean[None])[0])
    print(f"\nsignature conflict (overlapping sets): {overlap}")
    print(f"signature conflict (disjoint sets):     {disjoint}")
    return {"results": results, "normalized": normalized,
            "conflict_overlapping": overlap, "conflict_disjoint": disjoint}


if __name__ == "__main__":
    main()
