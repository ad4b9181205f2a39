"""One run of one cell: set-up, the measured window, the trace, the check
against the plain reference, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; it names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), and its limits are ``limits/<workload>.json``.
Every metric is read by ``metrics/<metric>.py``'s ``read(ctx)``, which
returns a number or None (nothing to read).  So a later cell or metric is
files added, not code changed.

The program under test is ``repro_torch``: ``Model`` and the steps of
``launch.steps``, fed the benchmark's own weights and token ids.  Nothing
here imports JAX or the JAX package.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from portbench import weights as W
from portbench.reference import model as RM
from portbench.reference import train as RT
from portbench.trace import WINDOW_RANGE, Trace

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and the metrics it reports."""

    def __init__(self, workload: str, bench: dict | None = None, data: Path = HERE):
        bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entries[workload]
        self.name = workload
        self.chips = self.entry["chips"]
        self.cfg = load_json(data / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(data / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(data / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in e2e)]


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models import common as C

    run = cfg["run"]
    if cfg["rms_norm_eps"] != 1e-6:
        raise ValueError("the program's RMSNorm eps is 1e-6")
    kw = dict(name=cfg["name"], num_layers=cfg["num_hidden_layers"],
              d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
              num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
              head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
              vocab_size=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
              tie_embeddings=bool(cfg.get("tie_word_embeddings", True)),
              param_dtype=getattr(torch, run["param_dtype"]),
              opt_dtype=getattr(torch, run["opt_dtype"]),
              remat=bool(run["remat"]), remat_policy=run["remat_policy"])
    if "num_experts" in cfg:
        if not cfg.get("norm_topk_prob", False):
            raise ValueError("the program renormalises the top-k weights")
        moe = C.MoEConfig(num_experts=cfg["num_experts"],
                          num_shared=(cfg["shared_expert_intermediate_size"]
                                      // cfg["moe_intermediate_size"]),
                          top_k=cfg["num_experts_per_tok"],
                          d_expert=cfg["moe_intermediate_size"],
                          capacity_factor=float(run["capacity_factor"]),
                          padded_experts=run.get("padded_experts"))
        kw.update(family="moe", block_kind="moe", d_ff=cfg["moe_intermediate_size"], moe=moe,
                  moe_dispatch=run["moe_dispatch"], moe_combine_f32=run["moe_combine_f32"])
    else:
        kw.update(family="dense", d_ff=cfg["intermediate_size"])
    return C.ModelConfig(**kw)


def check_layout(model, cfg: dict) -> None:
    """The benchmark's tree has the program's leaves, shapes and dtypes."""
    want = {p: (tuple(t.shape), t.dtype) for p, t in W.leaf_paths(model.abstract())}
    have = {p: (s[0], s[1]) for p, s in W.leaf_specs(cfg).items()}
    if want != have:
        raise ValueError(f"parameter layout differs from the program's: "
                         f"{sorted(set(want.items()) ^ set(have.items()))[:4]}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class ClockLog:
    """``nvidia-smi`` samples of the SM clock, power draw, power limit and
    temperature every ``ms`` while open (nothing where ``ms`` is 0 or there
    is no ``nvidia-smi``)."""

    QUERY = "timestamp,clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self, ms: int):
        self.ms, self.proc, self.lines = ms, None, []

    def __enter__(self):
        if self.ms > 0:
            try:
                self.proc = subprocess.Popen(
                    ["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                     f"-lms={self.ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    text=True)
            except OSError:
                self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                out, _ = self.proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, _ = self.proc.communicate()
            self.lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        return False

    def summary(self) -> dict:
        cols = {"sm_mhz": 1, "power_w": 2, "limit_w": 3, "temp_c": 4}
        out = {"samples": len(self.lines)}
        rows = [ln.split(", ") for ln in self.lines]
        for key, i in cols.items():
            vals = []
            for r in rows:
                try:
                    vals.append(float(r[i]))
                except (IndexError, ValueError):
                    pass
            if vals:
                out[key] = [min(vals), statistics.median(vals), max(vals)]
        return out


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


def run_window(call, n_max: int, seconds: float, dev, trace: bool):
    """``call(i)`` for i = 0, 1, ... back to back, each waited for, while
    the window is open: it closes ``seconds`` after the first call starts,
    and a call started before that runs to its end.  Returns ([(start,
    end)] of each completed call, their results, the profiler or None)."""
    items, results = [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with torch.profiler.record_function(WINDOW_RANGE):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            while i < n_max and (i == 0 or time.perf_counter() < deadline):
                s = time.perf_counter()
                results.append(call(i))
                sync(dev)
                items.append((s, time.perf_counter()))
                i += 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return items, results, prof


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
                 step_factory=None):
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    cfg, tr = cell.cfg, cell.traffic
    b, s, v = tr["batch"], tr["seq_len"], cfg["vocab_size"]
    model = Model(model_config(cfg))
    check_layout(model, cfg)
    params = W.make_weights(cfg, seed, dev)
    pool = W.token_pool(seed, "requests", tr["max_requests"], b, s, v, dev)
    warm = W.token_pool(seed, "warmup", tr["warmup_requests"], b, s, v, dev)
    step = (step_factory or make_prefill_step)(model)
    with torch.inference_mode():
        for ids in warm:
            step(params, {"tokens": ids})
        sync(dev)
        setup_s = time.perf_counter() - t_start
        with ClockLog(tr.get("clock_log_ms", 0)) as clocks:
            items, outs, prof = run_window(lambda i: step(params, {"tokens": pool[i]}),
                                           len(pool), seconds, dev, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del step, model
    free(dev)
    done = len(items)
    failed = sum(not bool(torch.isfinite(o.float()).all()) for o in outs)
    rng = random.Random(W.sub_seed(seed, "sample"))
    picked = sorted(rng.sample(range(done), min(tr["checked_requests"], done)))
    kept = [(pool[i], outs[i]) for i in picked]
    del outs
    free(dev)
    checks = prefill_numbers(row_errors(cfg, params, kept))
    return dict(kind="prefill", setup_s=setup_s, items=items, tokens_per_item=b * s,
                attempted=done, failed=failed, peak=peak, prof=prof, checks=checks,
                clocks=clocks, batch=b, seq=s)


def row_errors(cfg: dict, params: dict, answers: list, precision: str = "float32") -> list:
    """Each answer row's relative error against the reference's last-position
    logits (the norm of the difference over the reference's), over every
    row of ``answers`` ((ids, logits) pairs); inf where it is not finite."""
    RM.use_exact_float32()
    ref = RM.Reference(cfg, params, precision)
    out = []
    for ids, got in answers:
        want = ref.last_logits(ids)
        err = torch.linalg.vector_norm(got.float() - want, dim=-1) / \
            torch.linalg.vector_norm(want, dim=-1)
        out += [x if math.isfinite(x) else float("inf") for x in err.tolist()]
    return out


def prefill_numbers(rows: list) -> dict:
    """The numbers a prefill cell may compare: the worst row's error, and
    the median row's."""
    return {"logits_rel_err": max(rows), "logits_rel_err_median": statistics.median(rows)}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def opt_config(opt: dict):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                             weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
                             warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
                             moment_dtype=torch.float32)


def train_batches(pool: torch.Tensor, i: int) -> dict:
    rows = pool[i]
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def train_program(cell: Cell, seed: int, dev, step_factory=None):
    """The program's training object, driven through its checked steps:
    (params, optimizer state, step, row pool, readings).  The readings are
    each checked step's loss and pre-clip gradient norm, each unit's first
    gradient as the optimizer took it (its first moment over 1 - b1) and
    each unit's change after the checked steps."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg, tr = cell.cfg, cell.traffic
    model = Model(model_config(cfg))
    check_layout(model, cfg)
    ocfg = opt_config(tr["optimizer"])
    params = W.make_weights(cfg, seed, dev)
    state = adamw.init(params, ocfg)
    step = (step_factory or make_train_step)(model, ocfg)
    pool = W.token_pool(seed, "rows", tr["checked_steps"] + tr["max_steps"], tr["batch"],
                        tr["seq_len"] + 1, cfg["vocab_size"], dev)
    prog: dict = {"losses": [], "grad_norms": []}
    for i in range(tr["checked_steps"]):
        m = step(params, state, train_batches(pool, i))
        prog["losses"].append(float(m["loss"]))
        prog["grad_norms"].append(float(m["grad_norm"]))
        if i == 0:
            prog["units"] = {n: x / (1.0 - ocfg.b1)
                             for n, x in RT.norms(RT.units(state["mu"])).items()}
    prog["change"] = RT.change_norms(cfg, seed, params, dev)
    return params, state, step, pool, prog


def checked_rows(cell: Cell, pool: torch.Tensor) -> list:
    """Copies of the checked steps' (tokens, labels)."""
    return [(b["tokens"].clone(), b["labels"].clone())
            for b in (train_batches(pool, i) for i in range(cell.traffic["checked_steps"]))]


def train_reference(cell: Cell, seed: int, rows: list, dev, precision: str = "float32") -> dict:
    """The reference's readings over the checked steps from the seed's
    weights (drawn again)."""
    RM.use_exact_float32()
    params = W.make_weights(cell.cfg, seed, dev)
    ref = RT.train_steps(cell.cfg, cell.traffic["optimizer"], params, rows, precision)
    ref["change"] = RT.change_norms(cell.cfg, seed, params, dev)
    return ref


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
               step_factory=None):
    tr = cell.traffic
    n_check = tr["checked_steps"]
    params, state, step, pool, prog = train_program(cell, seed, dev, step_factory)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    with ClockLog(tr.get("clock_log_ms", 0)) as clocks:
        items, outs, prof = run_window(
            lambda i: step(params, state, train_batches(pool, n_check + i))["loss"],
            tr["max_steps"], seconds, dev, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = sum(not math.isfinite(float(x)) for x in outs)
    rows = checked_rows(cell, pool)
    del params, state, step, outs, pool
    free(dev)
    checks = compare_train(prog, train_reference(cell, seed, rows, dev))
    return dict(kind="train", setup_s=setup_s, items=items,
                tokens_per_item=tr["batch"] * tr["seq_len"], attempted=len(items),
                failed=failed, peak=peak, prof=prof, checks=checks, clocks=clocks,
                batch=tr["batch"], seq=tr["seq_len"])


def _rel(a: float, b: float) -> float:
    g = abs(a - b) / abs(b)
    return g if math.isfinite(g) else float("inf")


def unit_gaps(prog: dict, ref: dict, floor: dict) -> dict:
    """{unit: gap between the two sides' norms of it, over the larger of the
    reference's norm of that unit and the median unit's}, for the units
    whose first gradient in the reference (``floor``) is at least a
    thousandth of the median unit's: a unit whose gradient is nought to
    rounding moves under Adam by round-off alone."""
    g_med = statistics.median(floor.values())
    med = statistics.median(ref.values())
    return {n: _rel(prog[n], r) * abs(r) / max(abs(r), med) for n, r in ref.items()
            if floor[n] >= 1e-3 * g_med}


def compare_train(prog: dict, ref: dict) -> dict:
    """The numbers a training cell may compare (its limits file says which):
    the largest gap of a checked step's loss; the first step's pre-clip
    gradient norm; the worst unit's first gradient; the worst unit's change
    after the checked steps."""
    return {"loss_gap": max(_rel(a, b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_norm_gap": _rel(prog["grad_norms"][0], ref["grad_norms"][0]),
            "grad_gap": max(unit_gaps(prog["units"], ref["units"], ref["units"]).values()),
            "update_gap": max(unit_gaps(prog["change"], ref["change"], ref["units"]).values())}


# ---------------------------------------------------------------------------
# Metrics and the result
# ---------------------------------------------------------------------------


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def context(cell: Cell, run: dict, device_kind: str) -> types.SimpleNamespace:
    prof = run.pop("prof")
    return types.SimpleNamespace(cell=cell.name, cfg=cell.cfg, traffic=cell.traffic,
                                 device_kind=device_kind,
                                 trace=Trace.from_profiler(prof) if prof is not None else None,
                                 **run)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, dev, t_start: float,
             bench: dict | None = None, device_kind: str | None = None, data: Path = HERE,
             **kw) -> dict:
    """One run; returns the result object (without printing it).  ``kw``
    goes to the cell's kind (``step_factory``: make the step under test
    from the model, in place of the program's)."""
    cell = Cell(workload, bench, data)
    torch.manual_seed(W.sub_seed(seed, "torch"))
    fn = {"prefill": prefill_cell, "train": train_cell}[cell.traffic["kind"]]
    run = fn(cell, seed, seconds, trace, dev, t_start, **kw)
    ctx = context(cell, run, device_kind or "")
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        val = reader(m["name"])(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    checks = {n: {"value": x, "limit": cell.limits[n]} for n, x in ctx.checks.items()
              if n in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and ctx.failed == 0
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": device_kind or "", "count": 1, "memory_peak_bytes": int(ctx.peak)}
    out = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_device_ops(10),
                            "idle_gaps": ctx.trace.idle_gaps(10)}
    out["checks"] = checks
    out["_log"] = {"item_s": [e - s for s, e in ctx.items], "clocks": ctx.clocks.summary(),
                   "clock_lines": ctx.clocks.lines}
    return out


def loaded_forbidden() -> list:
    """Modules loaded in this process whose top-level name is one of
    :data:`FORBIDDEN` (compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log_dir() -> Path:
    return ROOT / "chiprun_out" / "portbench"


def emit(result: dict, workload: str, seed: int, trace: bool) -> None:
    """The log lines, the checks as the last lines on standard error, and
    the result as the last line on standard output."""
    log = result.pop("_log")
    lines = [f"item_s {json.dumps(log['item_s'])}",
             f"clocks {json.dumps(log['clocks'])}"]
    try:
        log_dir().mkdir(parents=True, exist_ok=True)
        path = log_dir() / f"{workload}.{seed}.trace{int(trace)}.log"
        path.write_text("\n".join(lines + log["clock_lines"]) + "\n")
    except OSError:
        pass
    for ln in lines:
        print(ln, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
