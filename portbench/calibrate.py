"""The readings a cell's limits are set from, in one process: for each seed,
the numbers that the program's outputs give against the plain reference,
and on some seeds the numbers that the control and the faults give.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3]

Prefill: the program's last-position logits of the first ``checked_requests``
requests of a seed, at the cell's sizes, through ``make_prefill_step``; the
control is the reference computed with fp8 products.  Training: the
program's checked steps as the benchmark's set-up runs them; the control
is the reference trained with fp8 products; the faults are the program on
half of each row's tokens (the mean over the rest) and the program with
one layer's query projection left unmoved.  A state left unchanged reads 1
on ``update_gap`` and needs no run.  One JSON line a seed and side.

The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def prefill_seed(H, W, cell, seed, dev, control: bool) -> dict:
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    cfg, tr = cell.cfg, cell.traffic
    k = tr["checked_requests"]
    params = W.make_weights(cfg, seed, dev)
    pool = W.token_pool(seed, "requests", k, tr["batch"], tr["seq_len"], cfg["vocab_size"], dev)
    step = make_prefill_step(Model(H.model_config(cfg)))
    with torch.inference_mode():
        answers = [(ids, step(params, {"tokens": ids})) for ids in pool]
    H.sync(dev)
    del step
    H.free(dev)
    out = {"program": H.row_errors(cfg, params, answers)}
    if control:
        ctrl = H.RM.Reference(cfg, params, "fp8")
        with torch.no_grad():
            answers = [(ids, ctrl.last_logits(ids)) for ids in pool]
        out["control"] = H.row_errors(cfg, params, answers)
    return {side: {**H.prefill_numbers(rows), "rows": rows} for side, rows in out.items()}


def half_rows(make_train_step):
    """The program's step on the first half of each row's tokens."""
    def factory(model, ocfg):
        step = make_train_step(model, ocfg)

        def half(params, state, batch):
            n = batch["tokens"].shape[1] // 2
            return step(params, state, {k: v[:, :n] for k, v in batch.items()})
        return half
    return factory


def one_leaf_unmoved(make_train_step):
    """The program's step with layer 0's query projection kept as it was."""
    def factory(model, ocfg):
        step = make_train_step(model, ocfg)

        def stuck(params, state, batch):
            wq = params["stack"]["period"][0]["mixer"]["wq"]
            keep = wq[0].clone()
            m = step(params, state, batch)
            wq[0].copy_(keep)
            return m
        return stuck
    return factory


def train_seed(H, W, cell, seed, dev, control: bool) -> dict:
    from repro_torch.launch.steps import make_train_step

    def program(factory=None):
        params, state, step, pool, prog = H.train_program(cell, seed, dev, factory)
        rows = H.checked_rows(cell, pool)
        del params, state, step, pool
        H.free(dev)
        return prog, rows

    prog, rows = program()
    sides = {"program": prog}
    if control:
        sides["fault_half_rows"] = program(half_rows(make_train_step))[0]
        sides["fault_leaf_unmoved"] = program(one_leaf_unmoved(make_train_step))[0]
    ref = H.train_reference(cell, seed, rows, dev)
    H.free(dev)
    if control:
        sides["control"] = H.train_reference(cell, seed, rows, dev, "fp8")
        H.free(dev)
    return {side: H.compare_train(r, ref) for side, r in sides.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from portbench import harness as H
    from portbench import weights as W

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = H.Cell(args.workload)
    fn = {"prefill": prefill_seed, "train": train_seed}[cell.traffic["kind"]]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        out = fn(H, W, cell, seed, dev, seed in control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "s": round(time.perf_counter() - t, 1), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
