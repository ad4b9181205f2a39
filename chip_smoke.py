#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port of the LazyPIM simulator on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. environment — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device is a failure;
2. build — compile ``src/repro_torch/csrc/bloom.cu`` with ``nvcc`` (sm_90a);
3. one phase per kernel — each kernel against its plain PyTorch version on
   the card on the main path's data (the HTAP bucket: 3 lanes of 262,144
   lines, 72 windows of 256 PIM slots; every window checked); integer
   results, so the tolerance is exact equality; device time of the kernel
   and of the plain version (``torch.profiler``), their time per call
   (CUDA events), and the kernel's bound (bytes over 3.35 TB/s vs integer
   operations over 67 Top/s, whichever is larger);
4. main path — ``Study(all_workloads())`` with all six mechanisms on
   ``engine="batch"`` and on ``engine="sequential"``, launch counts reset
   just before and read just after each run; the engines must agree on
   every field and ``pagerank-arxiv`` / ``htap128`` must match the goldens
   in ``tests/golden/`` (event counts exact, ratios 1e-6, raw 1e-4);
5. profile — one more batch run under ``torch.profiler``: device time by
   kernel and the device's idle share of the unprofiled batch wall time;
6. the ``kernels`` JSON line, then the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "golden"
GOLDEN_WORKLOADS = ("pagerank-arxiv", "htap128")
RATIO_KEYS = ("speedup", "traffic", "energy")
EVENT_KEYS = ("commits", "conflicts_sig", "conflicts_exact", "rollbacks",
              "flush_lines", "dbi_writebacks")
RATIO_RTOL, RAW_RTOL = 1e-6, 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores used as the integer-ALU ceiling.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
TPU_KERNEL = {
    "h3_hash": "src/repro/kernels/bloom/bloom.py:62",
    "bloom_insert": "src/repro/kernels/bloom/bloom.py:135",
    "bloom_query": "src/repro/kernels/bloom/bloom.py:205",
    "bloom_intersect": "src/repro/kernels/bloom/bloom.py:316",
}
SOURCE = "src/repro_torch/csrc/bloom.cu"

# Main-path shapes: the HTAP geometry bucket (3 lanes of 262,144 lines,
# 72 windows of 256 PIM slots), the paper's 2048-bit / 4-segment signature.
HTAP_BUCKET = ("htap128", "htap192", "htap256")
LINES = 262_144
LANES = 3
WINDOWS = 72
SLOTS = 256


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def environment():
    import torch

    phase("environment")
    check(torch.cuda.is_available(), "no CUDA device visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)


def build():
    phase("build")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.bloom import bloom as K

    t0 = time.perf_counter()
    lib = K.build_library()
    K._lib()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return K


def event_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` between CUDA events over ``iters``
    back-to-back calls, after a warm-up: the device time plus any gap the
    host leaves between launches."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int) -> float | None:
    """Mean device time per call of ``fn``: the sum of every CUDA kernel,
    memset and copy it ran, from ``torch.profiler``; None when the profiler
    records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / iters / 1e3 if total_us > 0 else None


def time_pair(fn, iters: int) -> tuple[float, float, str]:
    """(device ms, per-call ms, timing source) for one callable."""
    call = event_ms(fn, iters)
    dev = device_ms(fn, iters)
    return (dev, call, "profiler") if dev is not None else (call, call, "events")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phases(K) -> dict[str, dict]:
    """Each kernel against its plain version on the main path's data: the
    HTAP geometry bucket (htap128/192/256 padded to 262,144 lines, 72
    windows of 256 PIM slots).  Exactness is checked on every window of
    every lane; times are taken at the per-window call shape (3 lanes)."""
    import torch

    from repro_torch.core.signatures import default_spec, tables_tensor
    from repro_torch.sim.engine import stack_traces
    from repro_torch.sim.prep import pad_trace, popcount_words, prepare, scatter_set
    from repro_torch.sim.trace import make_trace

    dev = torch.device("cuda", 0)
    spec = default_spec()
    tabs = tables_tensor(spec, dev)
    S, M, NW = spec.num_byte_slices, spec.num_segments, spec.num_words
    st = stack_traces([pad_trace(prepare(make_trace(app, device=dev), device=dev),
                                 num_lines=LINES) for app in HTAP_BUCKET])
    L, W = st.pim_reads.shape[:2]
    check((L, W, st.pim_reads.shape[2], st.num_lines) == (LANES, WINDOWS, SLOTS, LINES),
          f"HTAP bucket shape {tuple(st.pim_reads.shape)} x {st.num_lines} lines")
    # Per-lane line bitmaps as the window loop sees them: everything the
    # processor dirties over the run, and everything it caches.
    zeros = torch.zeros((L, st.num_line_words), dtype=torch.int32, device=dev)
    pre = st.pre_writes_words[:, 0]
    for k in range(1, st.num_kernels):
        pre = pre | st.pre_writes_words[:, k]
    dirty = scatter_set(pre, st.cpu_writes.reshape(L, -1),
                        st.cpu_w_valid.reshape(L, -1), LINES)
    present = scatter_set(dirty, st.cpu_reads.reshape(L, -1),
                          st.cpu_r_valid.reshape(L, -1), LINES)
    check(bool((present != zeros).any()), "empty line bitmaps")
    n_dirty, n_present = int(popcount_words(dirty).sum()), int(popcount_words(present).sum())
    out = {}

    def exact(name, got, want):
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}: kernel {got.dtype}{tuple(got.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = int(diff.max()) if diff.numel() else 0
        check(err == 0, f"{name}: kernel disagrees with plain version "
                        f"(max |diff| {err}, {int((diff != 0).sum())} elements)")
        return err

    def record(name, err, fn, plain, nbytes, ops):
        ms, call_ms, src = time_pair(fn, 200)
        plain_ms, plain_call_ms, _ = time_pair(plain, 10)
        b, by = bound_ms(nbytes, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=None,
                         timing=src, call_ms=call_ms, plain_call_ms=plain_call_ms)
        print(f"{name}: exact; device time ({src}) kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms; per call kernel {call_ms:.5f} ms, plain "
              f"{plain_call_ms:.5f} ms; bound {b:.6f} ms ({by})", flush=True)

    phase("kernel h3_hash")
    lines = torch.arange(LINES, dtype=torch.int32, device=dev)
    err = exact("h3_hash", K.h3_hash(lines, tabs), K.h3_hash_plain(lines, tabs))
    full = torch.randint(-2**31, 2**31 - 1, (LINES,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(0))
    exact("h3_hash (32-bit addresses)", K.h3_hash(full, tabs),
          K.h3_hash_plain(full, tabs))
    record("h3_hash", err, lambda: K.h3_hash(lines, tabs),
           lambda: K.h3_hash_plain(lines, tabs),
           nbytes=LINES * 4 + LINES * M * 4 + tabs.numel() * 4,
           ops=LINES * M * (2 * S - 1))

    phase("kernel bloom_insert")
    all_ids = st.pim_reads.reshape(L * W, SLOTS)  # every window of every lane
    all_valid = st.pim_r_valid.reshape(L * W, SLOTS)
    sigs = K.bloom_insert(tabs, NW, ids=all_ids, valid=all_valid)
    err = exact("bloom_insert", sigs,
                K.bloom_insert_plain(tabs, NW, ids=all_ids, valid=all_valid))
    bank = K.bloom_insert(tabs, NW, bitmap=dirty, num_lines=LINES, num_regs=16)
    exact("bloom_insert (bank mode)", bank, K.bloom_insert_plain(
        tabs, NW, bitmap=dirty, num_lines=LINES, num_regs=16))
    ids, valid = st.pim_reads[:, 0].contiguous(), st.pim_r_valid[:, 0].contiguous()
    n_valid = int(valid.sum())
    record("bloom_insert", err, lambda: K.bloom_insert(tabs, NW, ids=ids, valid=valid),
           lambda: K.bloom_insert_plain(tabs, NW, ids=ids, valid=valid),
           nbytes=ids.numel() * 5 + L * NW * 4 + tabs.numel() * 4,
           ops=n_valid * M * (2 * S + 2))
    bank_ms, bank_call_ms, src = time_pair(
        lambda: K.bloom_insert(tabs, NW, bitmap=dirty, num_lines=LINES,
                               num_regs=16), 200)
    print(f"bloom_insert bank mode ({n_dirty} dirty lines in {L} lanes): exact; "
          f"device time ({src}) {bank_ms:.5f} ms incl. its zero fill, per call "
          f"{bank_call_ms:.5f} ms", flush=True)

    phase("kernel bloom_query")
    sigs = sigs[:, 0].contiguous()                          # (L * W, NW)
    words_all = present.repeat_interleave(W, dim=0)         # lane-major, as sigs
    err = exact("bloom_query", K.bloom_query(sigs, words_all, tabs, LINES),
                K.bloom_query_plain(sigs, words_all, tabs, LINES))
    read_sig = sigs.reshape(L, W, NW)[:, 0].contiguous()
    record("bloom_query", err, lambda: K.bloom_query(read_sig, present, tabs, LINES),
           lambda: K.bloom_query_plain(read_sig, present, tabs, LINES),
           nbytes=2 * present.numel() * 4 + read_sig.numel() * 4 + tabs.numel() * 4,
           ops=present.numel() * 2 + n_present * M * (2 * S + 2))

    phase("kernel bloom_intersect")
    bank_all = bank.repeat_interleave(W, dim=0).reshape(L * W * 16, NW)
    err = exact("bloom_intersect", K.bloom_intersect(bank_all, sigs, M),
                K.bloom_intersect_plain(bank_all, sigs, M))
    flat_bank = bank.reshape(L * 16, NW)
    record("bloom_intersect", err, lambda: K.bloom_intersect(flat_bank, read_sig, M),
           lambda: K.bloom_intersect_plain(flat_bank, read_sig, M),
           nbytes=flat_bank.numel() * 4 + read_sig.numel() * 4 + L * 16,
           ops=flat_bank.numel() * 2)
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def check_golden(rs, golden: dict, label: str) -> float:
    """Hold a ResultSet's golden workloads to the golden JSON; returns the
    worst relative gap seen."""
    from repro_torch.api import summarize

    worst = 0.0
    got = {p.workload: (p.results, summarize(p.results, p.hw)) for p in rs}
    for name in GOLDEN_WORKLOADS:
        results, summary = got[name]
        check(set(summary) == set(golden[name]),
              f"{label}/{name}: mechanisms {sorted(summary)}")
        for mech, vals in golden[name].items():
            for key, want in vals.items():
                have = summary[mech][key]
                gap = _rel(have, want)
                worst = max(worst, gap)
                tol = RATIO_RTOL if key in RATIO_KEYS else RAW_RTOL
                check(gap < tol, f"{label}/{name}/{mech}/{key}: {have!r} vs "
                                 f"golden {want!r} (rel {gap:.3g} > {tol})")
            for key in EVENT_KEYS:
                if key in vals:
                    check(summary[mech][key] == vals[key],
                          f"{label}/{name}/{mech}/{key} not exact")
    return worst


def main_path(K) -> dict[str, dict[str, int]]:
    import torch

    from repro_torch.api import MECHANISMS, Study, all_workloads

    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    golden_batch = json.loads((GOLDEN_DIR / "fig7_batched_golden.json").read_text())
    runs, counts, walls = {}, {}, {}
    for engine in ("batch", "sequential"):
        phase(f"main path, engine={engine}")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rs = Study(all_workloads()).run(engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[engine] = K.launch_counts()
        runs[engine], walls[engine] = rs, wall
        print(f"{engine}: {len(rs)} workloads x {len(MECHANISMS)} mechanisms "
              f"in {wall:.2f} s wall; launches {counts[engine]}", flush=True)
        for name, n in counts[engine].items():
            check(n > 0, f"{engine}: kernel {name} was never launched")
        check(len(rs) == 12, f"{engine}: {len(rs)} points, want 12")
        for p in rs:
            for m, r in p.results.items():
                for k, v in dataclasses.asdict(r).items():
                    if isinstance(v, float):
                        check(math.isfinite(v) and v >= 0.0,
                              f"{engine}/{p.workload}/{m}/{k} = {v}")
        worst = check_golden(rs, golden if engine == "sequential" else golden_batch,
                             engine)
        print(f"{engine}: goldens {GOLDEN_WORKLOADS} hold (worst rel gap "
              f"{worst:.3g})", flush=True)
    phase("batch == sequential")
    for a, b in zip(runs["batch"].points, runs["sequential"].points):
        check(a.workload == b.workload, "point order differs between engines")
        for m in a.results:
            da, db = dataclasses.asdict(a.results[m]), dataclasses.asdict(b.results[m])
            diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
            check(not diff, f"{a.workload}/{m}: batch != sequential {diff}")
    print("batch and sequential agree on every field of 12 x 6 results",
          flush=True)
    return counts, walls


def main_path_profile(batch_wall_s: float) -> dict:
    """Device time of one profiled batch run, by kernel, against the wall
    time of the unprofiled batch run: the device's busy and idle shares."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Study, all_workloads

    phase("main path profile, engine=batch")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        Study(all_workloads()).run(engine="batch")
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = (e.self_device_time_total / 1e6, e.count)
    busy_s = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    summary = dict(device_busy_s=busy_s, batch_wall_s=batch_wall_s,
                   idle_share=1.0 - busy_s / batch_wall_s,
                   launches=sum(c for _, c in by_name.values()),
                   top=[dict(kernel=k[:80], s=t, count=c) for k, (t, c) in top])
    for k, (t, c) in top:
        print(f"  {t:9.4f} s {c:7d}x  {k[:100]}")
    print(f"device busy {busy_s:.3f} s of {batch_wall_s:.3f} s batch wall "
          f"(idle share {summary['idle_share']:.3f})", flush=True)
    return summary


def main() -> int:
    try:
        environment()
        K = build()
        import torch

        stats = kernel_phases(K)
        counts, walls = main_path(K)
        profile = main_path_profile(walls["batch"])
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=TPU_KERNEL[name],
                    launches=counts["batch"][name] + counts["sequential"][name],
                    **stats[name]) for name in TPU_KERNEL]
    print(json.dumps({"profile": profile, "main_path_wall_s": walls}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
