"""Study-planner tour on the PyTorch port: a hardware grid × lazy-knob
ablation in one spec.  The counterpart of ``examples/study_grid.py``.

Sweeps the off-chip link bandwidth (the paper's scarce resource) against a
PIM-DBI on/off ablation on one graph workload, printing the planner's
dispatch-shape budget *before* running, then the pivoted result table.
The whole 3x2 cross-product runs one batched dispatch per (mechanism,
bucket).

    PYTHONPATH=src python examples/torch_study_grid.py               # on the card
    PYTHONPATH=src python examples/torch_study_grid.py --device cpu  # plain PyTorch

``--scale``, ``--num-kernels`` and ``--windows-per-kernel`` shrink the
workload (the defaults are its own).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import LazyPIMConfig, Study, grid, workload  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--num-kernels", type=int, default=None)
    ap.add_argument("--windows-per-kernel", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Plan, run and tabulate the study; returns the study and what it
    prints: the plan, the ``ResultSet``, the pivoted speedups keyed by (hw index, lazy
    index) and the DBI writebacks at 16 GB/s with DBI on and off."""
    args = parse_args(argv)
    kw = {k: v for k, v in (("scale", args.scale), ("num_kernels", args.num_kernels),
                            ("windows_per_kernel", args.windows_per_kernel))
          if v is not None}
    study = Study(
        workloads=[workload("pagerank", "arxiv", **kw) if kw else "pagerank-arxiv"],
        hw=grid(offchip_bw_gbs=[16.0, 32.0, 64.0]),
        mechanisms=("cpu", "cg", "lazypim"),
        lazy=[LazyPIMConfig(use_dbi=True), LazyPIMConfig(use_dbi=False)],
        device=args.device,
    )
    plan = study.plan()
    print(plan.describe())

    results = study.run()
    table = results.pivot(("hw_index", "lazy_index"), "mechanism", "speedup")
    bws = [h.offchip_bw_gbs for h in study.hw_points()]
    print(f"\n{'bw_gbs':>7s} {'dbi':>5s} {'cg':>7s} {'lazypim':>8s}")
    for (h, li), row in sorted(table.items()):
        dbi = study.lazy_points()[li].use_dbi
        print(f"{bws[h]:7.0f} {str(bool(dbi)):>5s} {row['cg']:7.2f} "
              f"{row['lazypim']:8.2f}")
    lz = [p for p in results.points if p.hw_index == 0]
    d_on, d_off = (p.results["lazypim"].dbi_writebacks for p in lz)
    print(f"\nDBI writebacks at 16 GB/s: {d_on:.0f} (on) vs {d_off:.0f} (off)")
    return {"study": study, "plan": plan, "results": results, "table": table,
            "dbi_writebacks": (d_on, d_off)}


if __name__ == "__main__":
    main()
