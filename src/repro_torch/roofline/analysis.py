"""Three-term roofline analysis from the dry run, PyTorch port of
:mod:`repro.roofline.analysis`.

Terms (per card, NVIDIA H100 SXM):

    compute    = FLOPs_dev / peak_FLOPs             (989 TFLOP/s bf16 dense)
    memory     = bytes_dev / HBM_bw                 (3.35 TB/s)
    collective = collective_bytes_dev / link_bw     (450 GB/s NVLink, each way)

Sources: the dry run (:func:`repro_torch.launch.dryrun.lower_cell`) counts
each cell's per-device FLOPs and bytes on the local shards of its DTensor
program, B7 by its own formula, and its collectives' result bytes
(:func:`collective_bytes`: all-gather / all-reduce / reduce-scatter /
all-to-all).  An H100 host joins 8 cards by NVLink; a 16-wide ``model``
axis spans two such domains, whose links between them are slower, so the
collective term is a lower bound on the production meshes.

The reference extrapolates over depth because XLA's cost analysis counts a
scanned layer body once; the port's counts are exact at any depth, and the
same **layer-marginal extrapolation** is kept so a cell costs two shallow
traces instead of a full-depth one: trace unrolled variants with 1 and 2
layer-periods, then

    total = A + (n_periods_equiv - 1) * (B - A)

which is exact for depth-linear programs (transformer stacks are).  The
embed/logits/optimizer components live in A and the per-period marginal in
(B - A); encoder-decoder scales encoder and decoder together.

MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), with N_active for MoE;
the ratio MODEL_FLOPS / counted FLOPs flags remat/redundancy waste.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM constants (per card)
PEAK_FLOPS = 989e12      # bf16 dense
HBM_BW = 3.35e12         # B/s
LINK_BW = 450e9          # B/s NVLink, each way
CHIPS_SINGLE_POD = 256

# ``_c10d_functional`` collectives -> the reference's HLO kinds
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # DTensor's Shard(i) -> Shard(j)
    "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")


def _result_bytes(out) -> int:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(t.numel() * t.element_size() for t in outs if isinstance(t, torch.Tensor))


class CollectiveBytes(TorchDispatchMode):
    """While active, sums the result bytes of every ``_c10d_functional``
    collective (and DTensor's all-to-all) run on plain (local) tensors into
    ``by_kind``.  Ops on
    DTensors are handed back to DTensor (``NotImplemented``), whose local
    ops, redistributions included, then come through here: the counts are
    one rank's."""

    def __init__(self):
        super().__init__()
        self.by_kind: dict[str, float] = {}

    def _is_dtensor_op(self, types) -> bool:
        from torch.distributed.tensor import DTensor

        return any(issubclass(t, DTensor) for t in types)

    def _count_collective(self, func, out) -> None:
        kind = COLLECTIVE_KINDS.get(func._opname)
        if kind is None or func.namespace not in _COLLECTIVE_NAMESPACES:
            return    # not a collective (``wait_tensor``, ``_wrap_tensor_autograd``, ...)
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + float(_result_bytes(out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._count_collective(func, out)
        return out


def _with_total(by_kind: dict[str, float]) -> dict[str, float]:
    out = {k: v for k, v in by_kind.items() if k != "total"}
    out["total"] = sum(out.values())
    return out


@contextlib.contextmanager
def collective_bytes():
    """``with collective_bytes() as coll:`` — on exit ``coll`` holds the
    result bytes of every collective run inside, by kind, and their
    ``"total"`` (the counterpart of ``collective_bytes_from_hlo``)."""
    mode = CollectiveBytes()
    out: dict[str, float] = {}
    try:
        with mode:
            yield out
    finally:
        out.update(_with_total(mode.by_kind))


def _period_len(cfg) -> int:
    return len(cfg.block_pattern) if cfg.block_pattern else 1


def _shallow_cfg(cfg, periods: int, cfg_patch: dict | None = None):
    per = _period_len(cfg)
    kw = dict(num_layers=per * periods, scan_layers=False)
    if cfg.encoder_layers > 0:
        kw["encoder_layers"] = periods
    if cfg_patch:
        kw.update(cfg_patch)
    return dataclasses.replace(cfg, **kw)


def shallow_costs(arch: str, shape_name: str, periods: int,
                  multi_pod: bool = False, cfg_patch: dict | None = None,
                  rules_override: dict | None = None) -> dict:
    """Trace an unrolled ``periods``-deep variant; return per-device
    flops/bytes/collective-bytes.  ``cfg_patch``/``rules_override`` apply
    hill-climb candidates."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell

    cfg2 = _shallow_cfg(get_config(arch), periods, cfg_patch)
    res, _ = lower_cell(arch, shape_name, multi_pod=multi_pod, cfg_override=cfg2,
                        rules_override=rules_override)
    coll = res["collectives"]
    return {"flops": res["flops"], "bytes": res["bytes_accessed"],
            "coll": coll["total"], "coll_by_kind": coll}


def n_periods_equiv(cfg) -> float:
    return cfg.num_layers / _period_len(cfg)


def active_param_count(cfg) -> int:
    """Parameter count with only top-k routed experts active (MoE)."""
    from repro_torch.models.model import Model
    n = Model(cfg).param_count()
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert
        inactive = (cfg.moe.num_routed_padded - cfg.moe.top_k)
        n -= cfg.num_layers * inactive * per_expert
    return int(n)


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell (6ND train / 2ND inference)."""
    n_act = active_param_count(cfg)
    if shape.mode == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_act * tokens
    if shape.mode == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_act * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * n_act * tokens


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 chips: int = CHIPS_SINGLE_POD, cfg_patch: dict | None = None,
                 rules_override: dict | None = None) -> dict:
    """Full three-term roofline for one cell via marginal extrapolation."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    a = shallow_costs(arch, shape_name, 1, multi_pod, cfg_patch, rules_override)
    b = shallow_costs(arch, shape_name, 2, multi_pod, cfg_patch, rules_override)
    k = n_periods_equiv(cfg)

    def extrap(key):
        return a[key] + (k - 1.0) * max(b[key] - a[key], 0.0)

    flops_dev = extrap("flops")
    bytes_dev = extrap("bytes")
    coll_dev = extrap("coll")

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * chips
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "flops_dev": flops_dev, "bytes_dev": bytes_dev, "coll_dev": coll_dev,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / max(hlo_global, 1.0),
        # roofline fraction: how much of the bound step is useful compute
        "roofline_fraction": (mf / chips / PEAK_FLOPS) / max(bound, 1e-30),
        "coll_by_kind_A": a["coll_by_kind"],
    }


# ---------------------------------------------------------------------------
# Trace arithmetic intensity (simulator-side roofline input)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def trace_intensity(trace) -> dict:
    """Bytes/line-touch profile of a ``WindowTrace`` (read-only numpy).

    Counts the recorded access slots (64 B per line touch; each CPU slot
    stands for ``cpu_reuse`` dynamic accesses) and reports the same
    intensity terms the cell roofline uses, so a *captured* workload
    (:mod:`repro_torch.capture`) prints next to the synthetic families and
    next to the model cells it was recorded from.
    """
    pim_reads, pim_writes = _np(trace.pim_reads), _np(trace.pim_writes)
    cpu_reads, cpu_writes = _np(trace.cpu_reads), _np(trace.cpu_writes)
    pim_touch = int((pim_reads >= 0).sum() + (pim_writes >= 0).sum())
    cpu_slots = int((cpu_reads >= 0).sum() + (cpu_writes >= 0).sum())
    cpu_touch = cpu_slots * float(trace.cpu_reuse)
    pim_bytes = 64.0 * pim_touch
    cpu_bytes = 64.0 * cpu_touch
    ids = np.concatenate([a.reshape(-1) for a in
                          (pim_reads, pim_writes, cpu_reads, cpu_writes)])
    lines_touched = int(np.unique(ids[ids >= 0]).size)
    pim_instr = float(_np(trace.pim_instr).astype(np.float64).sum())
    cpu_instr = float(_np(trace.cpu_instr).astype(np.float64).sum())
    total = pim_bytes + cpu_bytes
    return {
        "name": trace.name,
        "num_lines": int(trace.num_lines),
        "lines_touched": lines_touched,
        "pim_bytes": pim_bytes,
        "cpu_bytes": cpu_bytes,
        "bytes_per_line_touch": total / max(lines_touched, 1),
        "pim_instr_per_byte": pim_instr / max(pim_bytes, 1.0),
        "cpu_instr_per_byte": cpu_instr / max(cpu_bytes, 1.0),
        "pim_share": pim_bytes / max(total, 1.0),
    }


def intensity_table(workloads=None, captured: bool = False,
                    **trace_kw) -> list[dict]:
    """``trace_intensity`` rows for a set of (app, graph) pairs (default:
    the paper set; ``captured=True`` appends the live-model captures);
    ``trace_kw`` goes to ``make_trace`` (``device="cpu"`` off the card)."""
    from repro_torch.sim.trace import all_workloads, make_trace

    if workloads is None:
        workloads = all_workloads(captured=captured)
    return [trace_intensity(make_trace(app, g, **trace_kw))
            for app, g in workloads]


def main(argv=None):
    import argparse

    from repro_torch.configs import ARCHS, get_config, shapes_for

    ap = argparse.ArgumentParser(description="Three-term roofline of dry-run cells "
                                             "on H100 constants.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/roofline.json")
    args = ap.parse_args(argv)

    cells = ([(args.arch.replace("-", "_").replace(".", "_"), args.shape)]
             if not args.all else
             [(a, s) for a in ARCHS for s in shapes_for(get_config(a))])
    rows = []
    chips = 512 if args.multi_pod else CHIPS_SINGLE_POD
    for arch, shape in cells:
        try:
            r = analyze_cell(arch, shape, multi_pod=args.multi_pod, chips=chips)
            rows.append(r)
            print(f"{arch:24s} {shape:12s} comp={r['t_compute_s']*1e3:8.2f}ms "
                  f"mem={r['t_memory_s']*1e3:8.2f}ms coll={r['t_collective_s']*1e3:8.2f}ms "
                  f"dom={r['dominant']:10s} useful={r['useful_ratio']:.2f} "
                  f"roofline={r['roofline_fraction']:.2%}")
        except Exception as e:  # noqa: BLE001 — report and continue
            print(f"FAIL {arch} {shape}: {e}")
            import traceback
            traceback.print_exc()
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
