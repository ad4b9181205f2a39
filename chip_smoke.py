#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port of the LazyPIM simulator on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. environment — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device is a failure;
2. build — compile every ``src/repro_torch/csrc/*.cu`` (``bloom.cu``,
   ``bloom_onehot.cu``, ``lazy_merge.cu``, ``flash_attention.cu``,
   ``flash_attention_sm90.cu``) with ``nvcc`` for sm_90a, one process each,
   started together, into the gitignored ``build/``; print what
   ``cudaFuncGetAttributes`` reads from the loaded ``bloom_query``,
   ``bloom_query_onehot``, ``bloom_insert`` (id and bitmap forms),
   ``bloom_insert_onehot``, ``h3_hash`` and
   ``bloom_detect_conflicts`` (transposed and direct routes) kernels (the
   paper's geometry fixed, and any; local memory must be 0), from the general flash
   attention kernel's bands (three a dtype) and from the sm90 one at each
   head dim (registers and local memory, i.e. spills and stack, a thread;
   static and dynamic shared memory a block); then the card's launch
   floor: a one-element elementwise op timed as the kernels are;
3. one phase per Bloom kernel of the Fig. 7 path (``h3_hash``,
   ``bloom_insert``, ``bloom_query``, ``bloom_intersect``) — each against
   its plain PyTorch version on the card on that path's data (the HTAP
   bucket: 3 lanes of 262,144 lines, 72 windows of 256 PIM slots; every
   window checked); integer results, so the tolerance is exact equality;
   time per call of the kernel and of the plain version from CUDA events
   over back-to-back calls on input copies rotated through 100 MB (twice
   the L2), and the kernel's bound (bytes over 3.35 TB/s vs operations
   over 67 Top/s, whichever is larger); a time under its bound fails.
   ``h3_hash`` is held on the bucket's lines, on 262,144 random 32-bit
   addresses and on LazySync's first 4 x 4,096 touched ids at qwen3-4b
   width, and timed at 262,144 lines and at those 16,384 ids, with the
   launch floor and, on a text line, the previous design's reading.
   ``bloom_query`` is held on every window with one bitmap and with two
   (``present`` and ``dirty``), and timed both ways; its bound counts the
   bitmaps read and written and the signature against the parity hash's
   operations for the set lines (the old bound printed beside it).
   ``bloom_insert`` is held on every window's read list alone and paired
   with its write list, and in bank mode on ``dirty`` alone and paired with
   a window's ``conc``; it is timed at the window's shapes as the id list,
   the id pair, the bank and the bank pair (no fill in either); each
   timing prints its bound (the parity hash's operations against the
   bytes), the launch floor and, on its text line only, the previous
   design's reading kept in ``PERF.md``.  ``bloom_intersect`` is held per
   row and, in its pair-and-any form (what the window launches), on every
   window's ``dirty`` and ``conc`` banks against its read image, both
   against the plain version and against two per-row calls and their
   ``.any``; the pair is timed at the window's shape (3 lanes x 16
   registers x 64 words, two banks) beside the per-row form and the two
   per-row calls it replaced;
4. Fig. 7 path — ``Study(all_workloads())`` with all six mechanisms on
   ``engine="batch"`` and ``engine="sequential"``, launch counts set to 0
   just before and read just after each run; ``bloom_query`` must launch
   exactly twice a window of each LazyPIM dispatch (``QUERIES_PER_WINDOW``;
   the windows of each geometry bucket in the batch engine, of each point
   in the sequential one), ``bloom_insert`` exactly twice a window
   (``INSERTS_PER_WINDOW``: the two images, the two banks) and
   ``bloom_intersect`` exactly once (``INTERSECTS_PER_WINDOW``: both
   conflict checks); the engines must agree on every field and
   ``pagerank-arxiv`` / ``htap128`` must match the goldens in
   ``tests/golden/`` (event counts exact, ratios 1e-6, raw 1e-4);
5. Fig. 7 profile — one more batch run under ``torch.profiler``: device time
   by kernel and the device's idle share of the unprofiled batch wall time;
5a. extended Fig. 7 fleet — ``Study(all_workloads(extended=True))``, the
   reference Fig. 7 driver's 22 workloads (the paper's 12, ``bfs`` and
   ``sssp`` on every graph input, ``htap_stream``, ``mtmix`` on every graph
   input) at the reference's defaults, on both engines, counted as in
   phase 4 (two ``bloom_query``, two ``bloom_insert`` and one
   ``bloom_intersect`` launch a LazyPIM window); batch == sequential on
   every field of 22 x 6 results; the goldens held; the 12 paper workloads
   equal phase 4's sequential results on every field; the 10 new ones equal
   one ``device="cpu"`` sequential run of the port on every field; both
   walls and the CPU run's printed;
5b. signature caps — the M = 64 ``Study`` (htap128 and pagerank-arxiv at
   ``SignatureSpec(4096, 64)`` and ``(2048, 64)``, full size) on both
   engines against its CPU run, every field exact, counted a window; every
   parity-form kernel at ``SignatureSpec(4096, 128)`` (640 column masks,
   two launches a call) and B4 / B1 at its 128 segments; the bitmap
   kernels (B2 in both forms, B3, B8a, B8b) at 70,000 lanes, one launch
   each; every result equal to its plain version;
5c. study service — the resident study service (``repro_torch.serve``) on
   the card: the Fig. 7 fleet as one JSON request (3 buckets: served by the
   batch engine, uncoalesced), every field equal to phase 4's results; a
   burst of 16 paper-scale requests (one of the 12 workloads each, all six
   mechanisms, ``offchip_bw_gbs`` 32 and 64: 2 lanes) served coalesced with
   the adaptive policy and then one at a time, every answer equal to its
   spec's direct ``Study.run()`` on every field (dispatch widths, audited
   lanes, p50 / p99 latency and studies/s of both legs printed); the
   reference's chaos storm (``make_storm``, seed 0, rate 0.3, every fault
   class, 170 requests on the reference chaos tests' two small specs, a
   virtual clock) served one at a time (a crash through
   ``restart_server``) and coalesced, every rid resolved as ROADMAP's
   contract table says, none lost, every served answer equal to the
   fault-free run; ``python -m repro_torch.launch.serve --study ...
   --cache-dir ...`` twice in fresh processes, the second warmed from the
   first one's manifest and then building and binding nothing.  Every
   LazyPIM window any leg walked (counted by wrapping the engine's window
   loop) asks two ``bloom_query``, two ``bloom_insert`` and one
   ``bloom_intersect`` launch;
6. seed path — the seed reference engine ``run_all_bool`` over the same 12
   workloads at full scale (default ``SignatureSpec`` and ``HWParams``),
   one trace at a time, counted and tapped: every ``bloom_insert_onehot``
   / ``bloom_query_onehot`` call held to its plain version (exact; an
   insert call answers both of a window's images), ``bloom_insert_onehot``
   launched exactly once a LazyPIM window, every
   field of the 12 x 6 results equal to the packed sequential engine's of
   phase 4, the goldens held; the full-commit and no-DBI LazyPIM ablations
   on ``pagerank-arxiv`` and ``htap128`` against the packed engine; those
   two workloads once more under ``torch.profiler`` for the idle share
   (against their wall time in the counted run);
7. the two B8 kernels timed as in phase 3 at the seed path's shapes, on
   inputs it gave them, the insert alone and as the window's pair (bound:
   bytes, or the parity hash's operations this data needs at 67 Top/s —
   every column for the insert, the columns up to each address's first
   clear bit for the query, with the query's xor-fold bound printed beside
   it; the insert also prints the launch floor and, on its text line
   only, the previous design's reading);
8. signatures — ``benchmarks/bench_signatures.py`` on the card: B1
   against the xor-fold hash at batch 4,096, B8 against B2 / B3 at batch
   1,024 (both inserts now hash with the parity form and share one kernel,
   so that pair compares B8a's incoming-signature OR with B2's plain
   image), B5 against the two-pass PyTorch path (G = 4); every pair
   bit-exact; one ``{"signatures": ...}`` line, no file written;
9. capture path — ``Study(["capture/lazy_embed"])`` (the live LazySync
   protocol recorded at its default scale: vocab 24,000, 48,000 lines in
   the 65,536-line bucket, 24 kernels x 3 steps) with all six mechanisms on
   both engines, held against the port's own ``device="cpu"`` run of the
   same study (event counts exact, ratios 1e-6, raw 1e-4); all six kernels
   must launch, ``bloom_query`` and ``bloom_insert`` twice a LazyPIM window,
   ``bloom_intersect`` once; every ``bloom_detect_conflicts`` and
   ``lazy_merge`` call the
   protocol made is held against its plain version on its own inputs;
10. LazySync at qwen3-4b width — ``LazyEmbed(get_config("qwen3_4b"),
   LazySyncConfig())`` (G = 4, vocab 151,936, d_model 2,560, bf16, 2,048-bit
   signatures, budget 1,024, commit every 16 steps): 24 ``sync_step``s with
   4,096 zipf-drawn touched ids per group and a sparse gradient on those
   rows, both from numpy seeds; each step's ``bloom_detect_conflicts`` and
   ``lazy_merge`` calls held against their plain versions (exact), every
   replica equal to ``base`` after the commit; step wall times, conflict
   rows, pinned rows, bytes against the dense all-reduce, peak memory;
   then 8 more steps twice from one snapshot, unprofiled and under
   ``torch.profiler``, for the device's idle share of a step;
11. LazySync kernel phases — first, at qwen3-4b width, B5 on a draw of
   1,024 ids a group, whose hit counts must vary (the path's own draw
   saturates the signatures), and B6 on the path's reconcile rows with
   about half of them valid; then ``bloom_detect_conflicts`` at the
   capture's shape (G = 4, N = 192) and at qwen3-4b width (N = 16,384);
   ``lazy_merge`` at the reconcile shape (4, 1,024, 2,560) and the commit
   shape (4, 151,936, 2,560) in bf16, on inputs the two paths gave them:
   times and bounds as in phase 3 (merge: exact expected, 1e-6 relative
   allowed); B5 on its transposed route, with the launch floor and, on a
   text line, the previous design's reading;
12. capture/kv_serve — ``Study(["capture/kv_serve"])`` (the paged-KV decode
   loop at its default scale: 500 pages, batch 24, 24 kernels x 3 steps)
   with all six mechanisms on both engines, each held to one
   ``device="cpu"`` run of the port (the engines agree bit for bit) at the
   same tolerances; B1–B4 must launch, ``bloom_query`` and ``bloom_insert``
   twice a LazyPIM window, ``bloom_intersect`` once;
13. qwen3-4b prefill — ``get_config("qwen3_4b")`` at full width and depth
   (36 layers, ~4.02 B parameters, ~8.0 GB in bf16) initialised on the card
   from a seeded generator; ``make_prefill_step`` on 4 prompts of 4,096
   seeded tokens, three times: counted and tapped (exactly 36
   ``flash_attention`` launches, all on the sm90 route — bf16, D = 128 —
   and none on the general one; every call held to the plain version at
   the row-scaled tolerance of ``fa_excess``), unprofiled (wall time, peak
   memory), under ``torch.profiler`` (the device's idle share);
14. kernel flash_attention — B7 at the prefill path's shape, q (4, 4,096,
   32, 128) and k / v (4, 4,096, 8, 128) causal, on layer 0's inputs: the
   sm90 route in bf16 (``flash_attention_sm90.cu``, what the path takes),
   the general route (``flash_attention.cu``) in float32 (the same inputs
   cast: what phase 16 runs) and in bf16 (forced): each against its plain
   version (``fa_excess``), timed as in phase 3 with its bound in
   operations (bf16 at the tensor-core rate, 989 TFLOP/s; float32 at the
   FFMA rate, 67 TFLOP/s), and one ``scaled_dot_product_attention`` call on
   the same inputs as the library yardstick (float32 with TF32 off; the port
   never calls it);
15. qwen3-4b serve — ``launch.serve.serve`` at full width with the
   reference serve loop's defaults (8 requests, batch 4, max-new 16, max-len
   64) on the same weights: all 8 served, tokens per second; 8 decode
   steps at batch 4 timed and then profiled (kernels a step, device busy
   time, idle share); then one teacher-forced 64-token prompt through
   decode against the full forward (top-1 agreement and max |logit
   difference|, recorded, not gated);
16. qwen3-4b prefill, float32 — the bf16 weights cast to float32 (~16 GB;
   the bf16 ones dropped), ``make_prefill_step`` on 1 prompt of 4,096
   seeded tokens with TF32 off: counted and tapped (exactly 36 B7 launches,
   all on the general route, each held to its plain version at
   ``FA_TOL``'s float32 pair), logits finite; then unprofiled (wall time,
   tokens/s, peak memory) and profiled (idle share, top kernels, B7's share
   of device time): the general route at full width;
17. smoke prefill, float32 — the qwen3-4b smoke config (2 layers, D = 16)
   in float32 through ``make_prefill_step`` on 2 x 150 tokens, counted
   (one general-route B7 launch a layer, none on the sm90 route), tapped
   (every call held to the plain version at ``FA_TOL``'s float32 pair,
   rtol 1e-5 and row_tol 1e-3) and held to the CPU run's logits (1e-4):
   the general route's own path;
18. the ``kernels`` JSON line (ten kernels, launches by path including the
   extended fleet's, the M = 64 Study's and the study service's legs: B7 once a route, as
   ``flash_attention_general`` — its forced bf16 timing, the float32 one as
   ``float32`` — and ``flash_attention_sm90``; the seven redesigned Bloom
   kernels also carry the launch floor, ``h3_hash`` (timed at 262,144
   lines) its timing at LazySync's ids as ``lazysync_ids``, ``bloom_detect_conflicts`` (timed
   at qwen3-4b width) the capture's shape under ``other_shapes``, the queries their old bound,
   ``bloom_query`` its two-bitmap timing as ``pair``, ``bloom_insert`` its
   pair, bank and bank pair timings, ``bloom_insert_onehot`` its pair and
   ``bloom_intersect`` (timed per row) its pair-and-any timing as ``pair``;
   every number in the line but the bounds measured in this run), then the
   result line.

float32 matmuls run in full float32 (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set False) wherever float32
results are compared.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "golden"
GOLDEN_WORKLOADS = ("pagerank-arxiv", "htap128")
RATIO_KEYS = ("speedup", "traffic", "energy")
EVENT_KEYS = ("commits", "conflicts_sig", "conflicts_exact", "rollbacks",
              "flush_lines", "dbi_writebacks")
RATIO_RTOL, RAW_RTOL = 1e-6, 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, the float32
# rate outside the tensor cores used as the integer-ALU ceiling, and the
# dense bf16 tensor-core rate (the attention products' ceiling).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
ROTATE_BYTES = 2 * 50 * 2**20  # twice the H100's L2
SPIN_CYCLES_PER_S = 2.0e9      # above the H100's top SM clock, 1.98 GHz
TPU_KERNEL = {
    "h3_hash": "src/repro/kernels/bloom/bloom.py:62",
    "bloom_insert": "src/repro/kernels/bloom/bloom.py:135",
    "bloom_query": "src/repro/kernels/bloom/bloom.py:205",
    "bloom_intersect": "src/repro/kernels/bloom/bloom.py:316",
    "bloom_detect_conflicts": "src/repro/kernels/bloom/bloom.py:266",
    "lazy_merge": "src/repro/kernels/lazy_merge/lazy_merge.py:30",
    "flash_attention_general": "src/repro/kernels/flash_attention/flash_attention.py:82",
    "bloom_insert_onehot": "src/repro/kernels/bloom/bloom.py:367",
    "bloom_query_onehot": "src/repro/kernels/bloom/bloom.py:420",
    "flash_attention_sm90": "src/repro/kernels/flash_attention/flash_attention.py:82",
}
SOURCE = {name: "src/repro_torch/csrc/bloom.cu" for name in TPU_KERNEL}
SOURCE["lazy_merge"] = "src/repro_torch/csrc/lazy_merge.cu"
SOURCE["flash_attention_general"] = "src/repro_torch/csrc/flash_attention.cu"
SOURCE["flash_attention_sm90"] = "src/repro_torch/csrc/flash_attention_sm90.cu"
# B7's two routes under their kernel names in the counts and the kernels line
# (the package's one ``flash_attention`` count is their sum)
FA_ROUTE_KERNEL = {"general": "flash_attention_general", "sm90": "flash_attention_sm90"}
SEED_KERNELS = ("bloom_insert_onehot", "bloom_query_onehot")
for _name in SEED_KERNELS:
    SOURCE[_name] = "src/repro_torch/csrc/bloom_onehot.cu"
SEED_ABLATION_WORKLOADS = ("pagerank-arxiv", "htap128")
# The seed path makes ~860,000 kernel launches; the profiler's bookkeeping
# of them all would take minutes, so the idle share is read on these two.
SEED_PROFILE_WORKLOADS = SEED_ABLATION_WORKLOADS
XORFOLD_OPS = 3  # a shift-and bit test, a select and an XOR per round
PARITY_OPS = 3   # an AND, a POPC and a bit insert per column mask
# The LazyPIM window asks each signature image once for two bitmaps: two
# bloom_query launches a window of each LazyPIM dispatch; it builds its two
# images from one bloom_insert launch and its two CPUWriteSet banks from
# another; the seed window builds its two images from one B8a launch.
QUERIES_PER_WINDOW = 2
INSERTS_PER_WINDOW = 2
# ...and answers both conflict checks (its two banks against the read
# image, any register) from one bloom_intersect launch.
INTERSECTS_PER_WINDOW = 1
# The previous designs' per-call readings at the shapes timed here (PERF.md
# §6): the insert's id list (3 x 256), the bank of one bitmap with the zero
# fill it needed, B8a at (1, 256); the staged-table B1 at 262,144 lines and
# B5 at G = 4 with N = 16,384 and 192.  Printed beside this run's timings
# for comparison, never reported as this run's.
PREVIOUS_MS = {"bloom_insert": 0.00574, "bloom_insert bank": 0.00911,
               "bloom_insert_onehot": 0.00642, "h3_hash": 0.01413,
               "bloom_detect_conflicts": 0.00670,
               "bloom_detect_conflicts capture": 0.00637}
PREVIOUS_CARD = "PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W"
SIG_HASH_BATCH, SIG_KERNEL_BATCH, SIG_LINES = 4096, 1024, 65_536
SIG_GROUPS, SIG_IDS_PER_GROUP = 4, 256
FIG7_KERNELS = ("h3_hash", "bloom_insert", "bloom_query", "bloom_intersect")
CAPTURE_KERNELS = FIG7_KERNELS + ("bloom_detect_conflicts", "lazy_merge")
MERGE_RTOL = 1e-6
CAPTURE_APP = "capture/lazy_embed"
KV_APP = "capture/kv_serve"
# Flash attention against its plain version, element by element:
# |kernel - plain| <= rtol |plain| + row_tol rms(plain row), the RMS taken
# over each output row's head dim; (rtol, row_tol) by dtype.  In bf16, rtol
# covers the two outputs' bf16 roundings landing one ulp apart and row_tol
# the kernel's one rounding site the plain version lacks (P rounded to bf16
# for the PV product: ~2^-9 of a row's scale per element); a row missing
# one KV tile of 64 keys in 4,096 moves by ~0.13 of its RMS, ~8x this
# tolerance.  In float32 both sides compute in float32 (the on-card tests'
# pair).
FA_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -6), "float32": (1e-5, 1e-3)}
PREFILL_BATCH, PREFILL_LEN = 4, 4096   # the train_4k sequence length
SMOKE_PREFILL_LEN = 150
SERVE_ARGS = dict(arch="qwen3-4b", smoke=False, requests=8, batch=4, max_new=16,
                  max_len=64, seed=0, study=None)  # the reference serve loop's defaults
TEACHER_LEN = 64
LAZY_STEPS = 24          # qwen3-4b-width sync_steps (commit fires at 16)
LAZY_PROFILE_STEPS = 8   # steps timed twice for the idle share
LAZY_TOUCHED = 4096      # touched ids per group per step
LAZY_ZIPF = 3.0

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


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (t+{time.perf_counter() - _START:.1f} s)", flush=True)


def environment() -> str:
    import torch

    phase("environment")
    check(torch.cuda.is_available(), "no CUDA device visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return card


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last reset, B7's split by route:
    ``flash_attention_general`` and ``flash_attention_sm90`` in place of the
    package's ``flash_attention`` (their sum)."""
    from repro_torch import kernels as KS

    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    counts = KS.launch_counts()
    del counts["flash_attention"]
    for route, n in FA.route_counts().items():
        counts[FA_ROUTE_KERNEL[route]] = n
    return counts


def build():
    import torch

    phase("build")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.bloom import bloom as K
    from repro_torch.kernels.bloom import onehot as K8

    LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    t0 = time.perf_counter()
    libs = _build.build_all()
    K._lib()
    K8._lib()
    LM._lib()
    FA._lib()
    FA._lib_sm90()
    print(f"built {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc per source, in "
          f"parallel)", flush=True)
    attributes = [("bloom_query", K.query_attributes()),
                  ("bloom_query_onehot", K8.query_attributes()),
                  ("bloom_insert_onehot", K8.insert_attributes())]
    attributes += [(f"bloom_insert {form} form", builds)
                   for form, builds in K.insert_attributes().items()]
    attributes += [("h3_hash", K.hash_attributes()),
                   ("bloom_detect_conflicts", K.detect_attributes())]
    for name, builds in attributes:
        for build_of, a in builds.items():
            print(f"{name} ({build_of} geometry): {a['registers']} registers and "
                  f"{a['local_bytes']} bytes of local memory a thread, "
                  f"{a['static_smem_bytes']} bytes of static shared memory a block",
                  flush=True)
            check(a["local_bytes"] == 0,
                  f"{name} ({build_of}): {a['local_bytes']} bytes of local memory "
                  f"(no build may spill or index a local array)")
    for dtype in (torch.bfloat16, torch.float32):
        for d in FA.general_bands(dtype):
            a = FA.general_attributes(dtype, d)
            print(f"flash_attention_general {str(dtype).removeprefix('torch.')} band to "
                  f"D = {d}: {a['registers']} "
                  f"registers and {a['local_bytes']} bytes of local memory (spills, stack) "
                  f"a thread; {a['static_smem_bytes']} static + {a['dynamic_smem_bytes']} "
                  f"dynamic bytes of shared memory a block at that D; {a['threads']} threads, "
                  f"{a['block_q']} query rows and {a['block_k']} keys a tile", flush=True)
    for d in sorted(FA.SM90_HEAD_DIMS):
        a = FA.sm90_attributes(d)
        print(f"flash_attention_sm90 D = {d}: {a['registers']} registers and "
              f"{a['local_bytes']} bytes of local memory (spills, stack) a thread; "
              f"{a['static_smem_bytes']} static + {a['dynamic_smem_bytes']} dynamic bytes "
              f"of shared memory a block", flush=True)
    return K


def rotations(args: tuple, iters: int) -> list[tuple]:
    """``args`` and copies of its tensors: enough sets (at most ``iters``)
    that one pass through them reads ``ROTATE_BYTES``, so a timed loop that
    cycles through them reads its inputs from HBM and not from the 50 MB
    L2, as a caller with fresh data does."""
    import torch

    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(1, min(iters, math.ceil(ROTATE_BYTES / max(nbytes, 1))))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def event_ms(fn, sets: list[tuple], iters: int) -> float:
    """Mean time per call of ``fn(*sets[i % len(sets)])`` between CUDA
    events over ``iters`` back-to-back calls, after a warm-up.  A spin
    kernel holds the stream while the host enqueues the calls, so the
    events time the device running them back to back, not the host's
    launch rate (a call that synchronizes inside still shows its gap)."""
    import torch

    for args in sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * enqueue_s, 2.0) * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms() -> float:
    """The card's launch floor: a one-element PyTorch elementwise op timed
    as the kernels are (CUDA events over back-to-back calls, a spin kernel
    ahead).  No launch takes less, so a kernel whose bound is far below it
    is read against this floor."""
    import torch

    x = torch.zeros(1, device="cuda")
    ms = event_ms(lambda t: t.add_(1), [(x,)], 200)
    print(f"launch floor: {ms:.5f} ms a call (one-element add_, CUDA events over "
          f"200 back-to-back calls)", flush=True)
    return ms


def lazypim_windows(study, rs, engine: str) -> int:
    """The windows the LazyPIM dispatches of a run walk: one dispatch a
    geometry bucket (its padded windows) in the batch engine, one a point
    in the sequential one."""
    check("lazypim" in study.mechanisms, "no LazyPIM dispatch")
    if engine == "batch":
        return sum(b["num_windows"] for b in study.plan().buckets)
    per_trace = {tt.name: tt.num_windows for tt in study.traces()}
    return sum(per_trace[p.workload] for p in rs)


def _check_per_window(kernel: str, per_window: int, label: str, study, rs, engine: str,
                      counts: dict) -> int:
    windows = lazypim_windows(study, rs, engine)
    want = per_window * windows
    check(counts[kernel] == want,
          f"{label}: {counts[kernel]} {kernel} launches, want {want} ({per_window} a "
          f"window over {windows} LazyPIM windows)")
    return want


def check_query_launches(label: str, study, rs, engine: str, counts: dict) -> int:
    """``bloom_query`` must launch exactly ``QUERIES_PER_WINDOW`` times a
    window of each LazyPIM dispatch.  Returns the expected count."""
    return _check_per_window("bloom_query", QUERIES_PER_WINDOW, label, study, rs, engine,
                             counts)


def check_insert_launches(label: str, study, rs, engine: str, counts: dict) -> int:
    """``bloom_insert`` must launch exactly ``INSERTS_PER_WINDOW`` times a
    window of each LazyPIM dispatch: the read and write images from one
    launch, the ``cpuws`` and ``conc`` banks from another.  Returns the
    expected count."""
    return _check_per_window("bloom_insert", INSERTS_PER_WINDOW, label, study, rs, engine,
                             counts)


def check_intersect_launches(label: str, study, rs, engine: str, counts: dict) -> int:
    """``bloom_intersect`` must launch exactly ``INTERSECTS_PER_WINDOW`` times
    a window of each LazyPIM dispatch: both conflict checks from one
    pair-and-any launch.  Returns the expected count."""
    return _check_per_window("bloom_intersect", INTERSECTS_PER_WINDOW, label, study, rs,
                             engine, counts)


def measure(label: str, err: float, fn, plain, args: tuple, nbytes: float,
            ops: float, iters: int = 200, plain_iters: int = 10,
            ops_per_s: float = PEAK_OPS_PER_S, library=None,
            library_args: tuple | None = None) -> dict:
    """Time ``fn(*args)`` and its plain version on the same inputs, rotated
    out of L2 (:func:`rotations`), with CUDA events; the kernel's bound
    from the bytes and operations the call needs (operations at
    ``ops_per_s``).  ``library`` (one PyTorch call computing the same
    function, on ``library_args``) is timed the same way as a yardstick.  A
    time under the bound is a fault of the timing and fails the phase."""
    sets = rotations(args, iters)
    ms = event_ms(fn, sets, iters)
    plain_ms = event_ms(plain, sets, plain_iters)
    library_ms = (None if library is None
                  else event_ms(library, rotations(library_args, iters), iters))
    b, by = bound_ms(nbytes, ops, ops_per_s)
    lib = "" if library_ms is None else f", library {library_ms:.5f} ms"
    print(f"{label}: max |err| {err}; per call (CUDA events, {len(sets)} input "
          f"sets) kernel {ms:.5f} ms, plain {plain_ms:.5f} ms{lib}; bound "
          f"{b:.6f} ms ({by}, {b / ms:.3f} of it reached)", flush=True)
    check(ms >= b, f"{label}: {ms:.6f} ms is under the bound {b:.6f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=library_ms, timing="events",
                input_sets=len(sets))


def kernel_phases(K, floor_ms: float) -> dict[str, dict]:
    """Each kernel against its plain version on the main path's data: the
    HTAP geometry bucket (htap128/192/256 padded to 262,144 lines, 72
    windows of 256 PIM slots).  Exactness is checked on every window of
    every lane; times are taken at the per-window call shape (3 lanes)."""
    import torch

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.lazy_sync import LazySyncConfig
    from repro_torch.core.signatures import default_spec, packed_tables, unpack_words
    from repro_torch.sim.engine import stack_traces
    from repro_torch.sim.prep import pad_trace, popcount_words, prepare, scatter_set
    from repro_torch.sim.trace import make_trace

    dev = torch.device("cuda", 0)
    spec = default_spec()
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

    def record(name, err, fn, plain, args, nbytes, ops):
        out[name] = measure(name, err, fn, plain, args, nbytes, ops)

    phase("kernel h3_hash")
    lines = torch.arange(LINES, dtype=torch.int32, device=dev)
    err = exact("h3_hash", K.h3_hash(spec, lines), K.h3_hash_plain(spec, lines))
    full = torch.randint(-2**31, 2**31 - 1, (LINES,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(0))
    exact("h3_hash (32-bit addresses)", K.h3_hash(spec, full), K.h3_hash_plain(spec, full))
    # LazySync's shape: the first step's 4 x 4,096 touched ids at qwen3-4b width
    touched = torch.from_numpy(_lazy_touched(
        np.random.default_rng([1, 0]), get_config("qwen3_4b").vocab,
        LazySyncConfig().num_groups, LAZY_TOUCHED).reshape(-1)).to(dev)
    err_ids = exact("h3_hash (LazySync ids)", K.h3_hash(spec, touched),
                    K.h3_hash_plain(spec, touched))
    ptab_bytes = packed_tables(spec).nbytes

    def hash_bound(n):
        """Each address read once, its M positions written once, the packed
        table read once; per address S gathers, S - 1 XORs and a shift, mask
        and OR a segment."""
        return dict(nbytes=n * 4 + n * M * 4 + ptab_bytes, ops=n * (2 * S - 1 + 3 * M))

    def hash_timed(label, n_err, args):
        st_ = measure(label, n_err, lambda a: K.h3_hash(spec, a),
                      lambda a: K.h3_hash_plain(spec, a), args, **hash_bound(args[0].numel()))
        print(f"{label}: launch floor {floor_ms:.5f} ms ({st_['ms'] / floor_ms:.2f}x it)",
              flush=True)
        return st_

    prev = PREVIOUS_MS["h3_hash"]
    print(f"h3_hash: previous design's reading {prev:.5f} ms at {LINES} lines "
          f"({PREVIOUS_CARD})", flush=True)
    out["h3_hash"] = dict(hash_timed(f"h3_hash ({LINES} lines)", err, (lines,)),
                          lazysync_ids=hash_timed(f"h3_hash ({touched.numel()} LazySync ids)",
                                                  err_ids, (touched,)))

    phase("kernel bloom_insert")
    log_seg = spec.seg_bits.bit_length() - 1
    hash_ops = M * log_seg * PARITY_OPS  # the parity form's operations a line
    all_ids = st.pim_reads.reshape(L * W, SLOTS)  # every window of every lane
    all_valid = st.pim_r_valid.reshape(L * W, SLOTS)
    all_wids = st.pim_writes.reshape(L * W, SLOTS)
    all_wvalid = st.pim_w_valid.reshape(L * W, SLOTS)
    sigs = K.bloom_insert(spec, ids=all_ids, valid=all_valid)
    err = exact("bloom_insert", sigs, K.bloom_insert_plain(spec, ids=all_ids, valid=all_valid))
    got = K.bloom_insert(spec, ids=all_ids, valid=all_valid, ids_b=all_wids,
                         valid_b=all_wvalid)
    want = K.bloom_insert_plain(spec, ids=all_ids, valid=all_valid, ids_b=all_wids,
                                valid_b=all_wvalid)
    err_pair = max(exact("bloom_insert (id pair, reads)", got[0], want[0]),
                   exact("bloom_insert (id pair, writes)", got[1], want[1]))
    # a window's conc bitmap: the lines the processor writes in window 0
    conc = scatter_set(zeros, st.cpu_writes[:, 0], st.cpu_w_valid[:, 0], LINES)
    n_conc = int(popcount_words(conc).sum())
    bank = K.bloom_insert(spec, bitmap=dirty, num_lines=LINES, num_regs=16)
    err_bank = exact("bloom_insert (bank mode)", bank, K.bloom_insert_plain(
        spec, bitmap=dirty, num_lines=LINES, num_regs=16))
    got = K.bloom_insert(spec, bitmap=dirty, bitmap_b=conc, num_lines=LINES, num_regs=16)
    want = K.bloom_insert_plain(spec, bitmap=dirty, bitmap_b=conc, num_lines=LINES,
                                num_regs=16)
    err_bank_pair = max(exact("bloom_insert (bank pair, dirty)", got[0], want[0]),
                        exact("bloom_insert (bank pair, conc)", got[1], want[1]))
    bank_conc = got[1]  # the window's conc bank, for bloom_intersect's pair form
    ids, valid = st.pim_reads[:, 0].contiguous(), st.pim_r_valid[:, 0].contiguous()
    wids, wvalid = st.pim_writes[:, 0].contiguous(), st.pim_w_valid[:, 0].contiguous()
    n_valid, n_wvalid = int(valid.sum()), int(wvalid.sum())
    img_bytes, bank_bytes = L * NW * 4, L * 16 * NW * 4
    old_tab_bytes = S * 256 * M * 4  # the uint32 tables the old designs staged

    def timed(label, err, fn, plain, args, nbytes, ops, previous=None):
        st_ = measure(label, err, fn, plain, args, nbytes, ops)
        prev = "" if previous is None else (f"; {previous} ({PREVIOUS_CARD})")
        print(f"{label}: launch floor {floor_ms:.5f} ms ({st_['ms'] / floor_ms:.2f}x "
              f"it){prev}", flush=True)
        return st_

    prev = PREVIOUS_MS["bloom_insert"]
    single = timed(f"bloom_insert ({L} x {SLOTS} ids, {n_valid} valid)", err,
                   lambda i, v: K.bloom_insert(spec, ids=i, valid=v),
                   lambda i, v: K.bloom_insert_plain(spec, ids=i, valid=v), (ids, valid),
                   nbytes=ids.numel() * 5 + img_bytes, ops=n_valid * hash_ops,
                   previous=f"previous design's reading {prev:.5f} ms")
    old_bound, old_by = bound_ms(ids.numel() * 5 + img_bytes + old_tab_bytes,
                                 n_valid * M * (2 * S + 2))
    print(f"bloom_insert: old bound {old_bound:.7f} ms ({old_by}; the staged tables "
          f"counted)", flush=True)
    pair = timed(f"bloom_insert id pair ({L} x {SLOTS} ids twice, {n_valid} and "
                 f"{n_wvalid} valid)", err_pair,
                 lambda i, v, j, w: K.bloom_insert(spec, ids=i, valid=v, ids_b=j, valid_b=w),
                 lambda i, v, j, w: K.bloom_insert_plain(spec, ids=i, valid=v, ids_b=j,
                                                         valid_b=w),
                 (ids, valid, wids, wvalid), nbytes=2 * ids.numel() * 5 + 2 * img_bytes,
                 ops=(n_valid + n_wvalid) * hash_ops,
                 previous=f"previous design's reading for one list {prev:.5f} ms")
    prev = PREVIOUS_MS["bloom_insert bank"]
    bank_one = timed(f"bloom_insert bank ({L} x {LINES} lines, {n_dirty} set, 16 "
                     f"registers, no fill)", err_bank,
                     lambda d: K.bloom_insert(spec, bitmap=d, num_lines=LINES, num_regs=16),
                     lambda d: K.bloom_insert_plain(spec, bitmap=d, num_lines=LINES,
                                                    num_regs=16),
                     (dirty,), nbytes=dirty.numel() * 4 + bank_bytes,
                     ops=n_dirty * hash_ops,
                     previous=f"previous design's reading {prev:.5f} ms with its fill")
    bank_pair = timed(f"bloom_insert bank pair ({L} x {LINES} lines twice, {n_dirty} and "
                      f"{n_conc} set, no fill)", err_bank_pair,
                      lambda d, c: K.bloom_insert(spec, bitmap=d, bitmap_b=c,
                                                  num_lines=LINES, num_regs=16),
                      lambda d, c: K.bloom_insert_plain(spec, bitmap=d, bitmap_b=c,
                                                        num_lines=LINES, num_regs=16),
                      (dirty, conc), nbytes=2 * dirty.numel() * 4 + 2 * bank_bytes,
                      ops=(n_dirty + n_conc) * hash_ops,
                      previous=f"previous design's reading {prev:.5f} ms for one bank "
                               f"with its fill, two such calls a window")
    out["bloom_insert"] = dict(single, old_bound_ms=old_bound, pair=pair, bank=bank_one,
                               bank_pair=bank_pair,
                               shape=dict(L=L, slots=SLOTS, valid=n_valid,
                                          write_valid=n_wvalid, num_lines=LINES,
                                          dirty_lines=n_dirty, conc_lines=n_conc))

    phase("kernel bloom_query")
    sigs = sigs[:, 0].contiguous()                          # (L * W, NW)
    words_all = present.repeat_interleave(W, dim=0)         # lane-major, as sigs
    dirty_all = dirty.repeat_interleave(W, dim=0)
    err = exact("bloom_query", K.bloom_query(spec, sigs, words_all, LINES),
                K.bloom_query_plain(spec, sigs, words_all, LINES))
    got = K.bloom_query(spec, sigs, words_all, LINES, words_b=dirty_all)
    want = K.bloom_query_plain(spec, sigs, words_all, LINES, words_b=dirty_all)
    exact("bloom_query (pair, first bitmap)", got[0], want[0])
    exact("bloom_query (pair, second bitmap)", got[1], want[1])
    read_sig = sigs.reshape(L, W, NW)[:, 0].contiguous()

    def query_ops(words):
        """Parity operations the lines set in ``words`` need: every column
        of each segment hashed, up to the first clear bit."""
        lane, line = torch.nonzero(unpack_words(words, LINES), as_tuple=True)
        pos = K.h3_hash(spec, line.to(torch.int32)).to(torch.int64)
        looked = ((read_sig[lane[:, None], pos >> 5] >> (pos & 31)) & 1)
        hashed = int((looked.cumprod(-1).sum(-1) + 1).clamp(max=M).sum())
        return hashed * log_seg * PARITY_OPS, hashed

    sig_bytes = read_sig.numel() * 4
    ops, hashed = query_ops(present)
    old_bound, old_by = bound_ms(2 * present.numel() * 4 + sig_bytes + old_tab_bytes,
                                 present.numel() * 2 + n_present * M * (2 * S + 2))
    st = measure(f"bloom_query ({L} x {LINES} lines, {n_present} set, {hashed} "
                 f"segments hashed)", err,
                 lambda sg, w: K.bloom_query(spec, sg, w, LINES),
                 lambda sg, w: K.bloom_query_plain(spec, sg, w, LINES), (read_sig, present),
                 nbytes=2 * present.numel() * 4 + sig_bytes, ops=ops)
    print(f"bloom_query: old bound {old_bound:.7f} ms ({old_by}; tables staged and "
          f"every word's bytes counted as work)", flush=True)
    ops_pair, hashed_pair = query_ops(present | dirty)
    pair = measure(f"bloom_query pair ({L} x {LINES} lines, {n_present} and {n_dirty} "
                   f"set, {hashed_pair} segments hashed)", err,
                   lambda sg, w, d: K.bloom_query(spec, sg, w, LINES, words_b=d),
                   lambda sg, w, d: K.bloom_query_plain(spec, sg, w, LINES, words_b=d),
                   (read_sig, present, dirty),
                   nbytes=4 * present.numel() * 4 + sig_bytes, ops=ops_pair)
    out["bloom_query"] = dict(st, old_bound_ms=old_bound, segments_hashed=hashed,
                              pair=dict(pair, segments_hashed=hashed_pair),
                              shape=dict(L=L, num_lines=LINES, set_lines=n_present,
                                         pair_set_lines=n_dirty))

    phase("kernel bloom_intersect")
    bank_all = bank.repeat_interleave(W, dim=0).reshape(L * W * 16, NW)
    conc_all = bank_conc.repeat_interleave(W, dim=0).reshape(L * W * 16, NW)
    err_row = exact("bloom_intersect", K.bloom_intersect(bank_all, sigs, M),
                    K.bloom_intersect_plain(bank_all, sigs, M))
    # the pair-and-any form on every window of every lane: against its plain
    # version and against two per-row calls and their .any over registers
    got = K.bloom_intersect(bank_all, sigs, M, a_b=conc_all)
    err = exact("bloom_intersect (pair)", got,
                K.bloom_intersect_plain(bank_all, sigs, M, a_b=conc_all))
    two = torch.stack([K.bloom_intersect(x, sigs, M).reshape(L * W, 16).any(1)
                       for x in (bank_all, conc_all)])
    exact("bloom_intersect (pair vs two per-row calls)", got, two)
    n_hits = [int(x.sum()) for x in got]
    flat_bank, flat_conc = bank.reshape(L * 16, NW), bank_conc.reshape(L * 16, NW)
    bank_bytes = flat_bank.numel() * 4
    pair = measure(f"bloom_intersect pair ({L} lanes x 16 registers x {NW} words, two "
                   f"banks, any register)", err,
                   lambda a, c, b: K.bloom_intersect(a, b, M, a_b=c),
                   lambda a, c, b: K.bloom_intersect_plain(a, b, M, a_b=c),
                   (flat_bank, flat_conc, read_sig),
                   nbytes=2 * bank_bytes + read_sig.numel() * 4 + 2 * L,
                   ops=2 * flat_bank.numel() * 2)
    per_row = measure(f"bloom_intersect per row ({L * 16} rows x {NW} words)", err_row,
                      lambda a, b: K.bloom_intersect(a, b, M),
                      lambda a, b: K.bloom_intersect_plain(a, b, M), (flat_bank, read_sig),
                      nbytes=bank_bytes + read_sig.numel() * 4 + L * 16,
                      ops=flat_bank.numel() * 2)
    two_ms = event_ms(lambda a, c, b: (K.bloom_intersect(a, b, M).reshape(L, 16).any(1),
                                       K.bloom_intersect(c, b, M).reshape(L, 16).any(1)),
                      rotations((flat_bank, flat_conc, read_sig), 200), 200)
    print(f"bloom_intersect: a window's two checks as two per-row calls and their .any "
          f"(the previous path) {two_ms:.5f} ms against the pair's {pair['ms']:.5f} ms; "
          f"launch floor {floor_ms:.5f} ms ({pair['ms'] / floor_ms:.2f}x it); "
          f"{n_hits} lane-windows hit in the two banks", flush=True)
    out["bloom_intersect"] = dict(per_row, pair=pair, two_per_row_calls_ms=two_ms,
                                  shape=dict(L=L, registers=16, words=NW, hits=n_hits))
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

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study, all_workloads

    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    golden_batch = json.loads((GOLDEN_DIR / "fig7_batched_golden.json").read_text())
    runs, counts, walls = {}, {}, {}
    for engine in ("batch", "sequential"):
        phase(f"Fig. 7 path, engine={engine}")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study(all_workloads())
        t0 = time.perf_counter()
        rs = study.run(engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[engine] = launch_counts()
        runs[engine], walls[engine] = rs, wall
        print(f"{engine}: {len(rs)} workloads x {len(MECHANISMS)} mechanisms "
              f"in {wall:.2f} s wall; launches {counts[engine]}", flush=True)
        for name in FIG7_KERNELS:
            check(counts[engine][name] > 0,
                  f"{engine}: kernel {name} was never launched")
        check_query_launches(f"Fig. 7/{engine}", study, rs, engine, counts[engine])
        check_insert_launches(f"Fig. 7/{engine}", study, rs, engine, counts[engine])
        check_intersect_launches(f"Fig. 7/{engine}", study, rs, engine, counts[engine])
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
    return counts, walls, runs["sequential"]


def exact_points(got, want, label: str) -> None:
    """Hold StudyPoints to others of the same workloads on every SimResult
    field, exactly."""
    check([p.workload for p in got] == [p.workload for p in want],
          f"{label}: workloads {[p.workload for p in got]} vs {[p.workload for p in want]}")
    for a, b in zip(got, want):
        check(set(a.results) == set(b.results), f"{label}/{a.workload}: mechanisms differ")
        for m in a.results:
            da, db = dataclasses.asdict(a.results[m]), dataclasses.asdict(b.results[m])
            diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
            check(not diff, f"{label}/{a.workload}/{m}: {diff}")


def extended_fleet_path(paper_sequential, card: str) -> tuple[dict, dict]:
    """``Study(all_workloads(extended=True))`` -- the reference's Fig. 7
    driver's 22 workloads -- on both engines: the Bloom launches a LazyPIM
    window, batch == sequential on every field, the goldens and the Fig. 7
    phase's 12 paper results held, and the 10 new workloads against one CPU
    run of the port, every field exact."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study, all_workloads

    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    golden_batch = json.loads((GOLDEN_DIR / "fig7_batched_golden.json").read_text())
    fleet, paper = all_workloads(extended=True), all_workloads()
    check(fleet[:len(paper)] == paper and len(fleet) == 22, f"extended fleet {fleet}")
    runs, counts, walls = {}, {}, {}
    for engine in ("batch", "sequential"):
        phase(f"extended Fig. 7 fleet, engine={engine}")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study(fleet)
        t0 = time.perf_counter()
        rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine], runs[engine] = launch_counts(), rs
        print(f"{engine}: {len(rs)} workloads x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall on {card}; launches {counts[engine]}", flush=True)
        for name in FIG7_KERNELS:
            check(counts[engine][name] > 0, f"extended/{engine}: {name} never launched")
        label = f"extended Fig. 7/{engine}"
        check_query_launches(label, study, rs, engine, counts[engine])
        check_insert_launches(label, study, rs, engine, counts[engine])
        check_intersect_launches(label, study, rs, engine, counts[engine])
        check(len(rs) == 22, f"{engine}: {len(rs)} points, want 22")
        for p in rs:
            for m, r in p.results.items():
                for k, v in dataclasses.asdict(r).items():
                    if isinstance(v, float):
                        check(math.isfinite(v) and v >= 0.0,
                              f"extended/{engine}/{p.workload}/{m}/{k} = {v}")
        worst = check_golden(rs, golden if engine == "sequential" else golden_batch,
                             f"extended/{engine}")
        print(f"{engine}: goldens {GOLDEN_WORKLOADS} hold (worst rel gap {worst:.3g})",
              flush=True)
    phase("extended fleet: batch == sequential, paper 12 == Fig. 7 phase, new 10 == CPU")
    exact_points(runs["batch"].points, runs["sequential"].points, "extended batch vs sequential")
    exact_points(runs["sequential"].points[:12], paper_sequential.points,
                 "extended fleet's paper 12 vs the Fig. 7 phase")
    t0 = time.perf_counter()
    cpu = Study(fleet[12:], device="cpu").run(engine="sequential")
    cpu_wall = time.perf_counter() - t0
    exact_points(runs["sequential"].points[12:], cpu.points, "extended new 10 vs CPU")
    print(f"batch == sequential on every field of 22 x 6 results; the paper 12 equal "
          f"the Fig. 7 phase's; the new 10 ({', '.join(p.workload for p in cpu)}) equal "
          f"the CPU run ({cpu_wall:.2f} s) on every field", flush=True)
    walls["cpu_new10_sequential"] = cpu_wall
    return counts, walls


# The study service (repro_torch.serve): a burst of paper-scale requests,
# each one of the 12 workloads at default scale with every mechanism on two
# hw points (2 lanes in one bucket); a chaos storm on the reference chaos
# tests' two small specs (tests/test_serve_chaos.py:32-39).  Seed 0 at
# fault rate 0.3 over every fault class draws each class and variant by
# rid 169 (the first NaN poison_result), so the storm has 170 requests;
# its coalesced leg caps a group at 8 lanes, so a poison bisects in 3 steps.
SERVE_BURST = 16
SERVE_BURST_HW = {"offchip_bw_gbs": [32.0, 64.0]}
STORM_SEED, STORM_RATE, STORM_REQUESTS, STORM_BATCH_LANES = 0, 0.3, 170, 8
_STORM_SMALL = dict(num_kernels=3, windows_per_kernel=2)
STORM_BASE_SPECS = [
    {"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4, **_STORM_SMALL}],
     "mechanisms": ["cpu", "lazypim"], "threads": 16},
    {"workloads": [{"app": "htap128", "scale": 0.004, **_STORM_SMALL}],
     "mechanisms": ["cpu", "lazypim"], "threads": 16},
]
SERVE_TIMEOUT_S = 300  # each fresh-process serve of the warm-restart check


class WindowTap:
    """Counts the LazyPIM windows every dispatch walks — the engine's
    ``_lazypim_acc`` wrapped while the tap is open — so the Bloom launches
    of any path (coalesced, bisected, audited, degraded) can be held to
    their counts a window."""

    def __init__(self):
        self.engine = importlib.import_module("repro_torch.sim.engine")
        self.inner, self.windows = self.engine._lazypim_acc, 0

    def __enter__(self):
        def counted(stt, shw, scfg):
            self.windows += stt.num_windows
            return self.inner(stt, shw, scfg)
        self.engine._lazypim_acc = counted
        return self

    def __exit__(self, *exc):
        self.engine._lazypim_acc = self.inner


def check_window_launches(label: str, counts: dict, windows: int) -> None:
    """Two ``bloom_query``, two ``bloom_insert`` and one ``bloom_intersect``
    launches a LazyPIM window walked."""
    check(windows > 0, f"{label}: no LazyPIM window walked")
    for name, per in (("bloom_query", QUERIES_PER_WINDOW),
                      ("bloom_insert", INSERTS_PER_WINDOW),
                      ("bloom_intersect", INTERSECTS_PER_WINDOW)):
        check(counts[name] == per * windows,
              f"{label}: {counts[name]} {name} launches, want {per} a window over "
              f"{windows} LazyPIM windows")


def _serve_leg(label: str, server, specs: list) -> tuple[list, dict, int, float]:
    """Submit every spec, drain, and return (responses in rid order, launch
    counts, LazyPIM windows walked, wall seconds); counts set to 0 just
    before."""
    import torch

    from repro_torch import kernels as KS

    torch.cuda.synchronize()
    KS.reset_launch_counts()
    with WindowTap() as tap:
        t0 = time.perf_counter()
        for spec in specs:
            out = server.submit(spec)
            check(isinstance(out, int), f"{label}: refused at admission: {out}")
        resps = server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check_window_launches(label, counts, tap.windows)
    return sorted(resps, key=lambda r: r.rid), counts, tap.windows, wall


def _storm_expected(monkey, rid: int, coalesce: bool) -> tuple[str, ...]:
    """The statuses ROADMAP's contract table allows request ``rid`` of the
    storm: admission classes reject on both legs; the one-at-a-time leg
    resolves the runtime classes (transient -> ok after a retry, persistent
    -> ok_degraded, hang -> timeout, crash -> ok after a restart); the
    coalesced leg the poison classes (poison_lane and NaN -> quarantined,
    finite -> served by the audit's degrade).  A class the leg's dispatch
    boundary does not inject is served like a fault-free request."""
    kind = monkey.fault_for(rid)
    if kind == "malformed_spec":
        return ("rejected_malformed",)
    if kind == "oversized":
        return ("rejected_oversized",)
    if not coalesce and kind == "engine_exception":
        return ("ok",) if monkey.is_transient(rid) else ("ok_degraded",)
    if not coalesce and kind == "hang":
        return ("timeout",)
    if coalesce and (kind == "poison_lane"
                     or (kind == "poison_result" and monkey.variant(rid, 2) == 0)):
        return ("quarantined",)
    return ("ok",) if not coalesce else ("ok", "ok_degraded")


def storm_phase(card: str) -> tuple[dict, dict]:
    """The reference's ``make_storm`` (seed 0, rate 0.3, every fault class)
    on the card, on a virtual clock, served twice: one request at a time
    (the runtime classes fire; a crash goes through ``restart_server``)
    and coalesced (the poison classes fire).  Every rid resolves as the
    contract table says, none is lost, and every served answer equals the
    fault-free run."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.serve import (ALL_FAULT_CLASSES, ChaosConfig, ChaosMonkey,
                                   ServeConfig, StudyServer, VirtualClock, build_study,
                                   make_storm, restart_server)

    phase(f"study service: chaos storm ({STORM_REQUESTS} requests, seed {STORM_SEED}, "
          f"rate {STORM_RATE}, every fault class)")
    want = [build_study(s).run("sequential").to_rows() for s in STORM_BASE_SPECS]
    chaos_cfg = ChaosConfig(seed=STORM_SEED, fault_rate=STORM_RATE,
                            classes=ALL_FAULT_CLASSES, hang_s=60.0)
    # the oracle: the restart exempts the rids it replays from the serving
    # monkey's draws, never from this one's
    oracle = ChaosMonkey(chaos_cfg)
    storm = make_storm(oracle, STORM_REQUESTS, STORM_BASE_SPECS)
    out, walls = {}, {}
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    with WindowTap() as tap, tempfile.TemporaryDirectory() as tmp:
        for coalesce in (False, True):
            leg = "coalesced" if coalesce else "one at a time"
            clock = VirtualClock()
            monkey = ChaosMonkey(chaos_cfg, clock=clock)
            cfg = ServeConfig(default_deadline_s=1e9, heartbeat_timeout_s=20.0,
                              backoff_base_s=0.01, max_queue=STORM_REQUESTS, max_lanes=64,
                              coalesce=coalesce, max_batch_lanes=STORM_BATCH_LANES,
                              cache_dir=str(pathlib.Path(tmp) / leg.replace(" ", "_")))
            server, final, restarts = StudyServer(cfg, clock=clock, chaos=monkey), {}, 0
            t0 = time.perf_counter()

            def collect(resps):
                for r in resps:
                    final[r.rid] = r

            # one at a time: submit, drain; coalesced: the whole storm queued
            for batch in ([[s] for s in storm] if not coalesce else [storm]):
                for spec in batch:
                    r = server.submit(spec)
                    if not isinstance(r, int):
                        collect([r])
                collect(server.drain())
                while server.crashed:
                    restarts += 1
                    check(restarts <= STORM_REQUESTS, f"storm/{leg}: restarts do not converge")
                    server, replayed = restart_server(cfg, clock=clock, chaos=monkey)
                    check(all(r.restarted for r in replayed), f"storm/{leg}: replay unmarked")
                    collect(replayed)
                    collect(server.drain())
            torch.cuda.synchronize()
            walls[leg] = time.perf_counter() - t0
            check(sorted(final) == list(range(STORM_REQUESTS)),
                  f"storm/{leg}: rids lost: {sorted(set(range(STORM_REQUESTS)) - set(final))}")
            by_class: dict[str, dict[str, int]] = {}
            for rid, r in final.items():
                kind = oracle.fault_for(rid)
                if kind == "engine_exception":
                    kind += ":transient" if oracle.is_transient(rid) else ":persistent"
                if kind == "poison_result":
                    kind += ":nan" if oracle.variant(rid, 2) == 0 else ":finite"
                allowed = _storm_expected(oracle, rid, coalesce)
                check(r.status in allowed,
                      f"storm/{leg}: rid {rid} ({kind}) {r.status}, want {allowed}: {r.error}")
                if kind == "crash" and not coalesce:
                    check(r.restarted, f"storm/{leg}: crashed rid {rid} not restarted")
                if r.status in ("ok", "ok_degraded"):
                    check(r.results.to_rows() == want[rid % len(want)],
                          f"storm/{leg}: rid {rid} ({kind}) differs from the fault-free run")
                cls = by_class.setdefault(kind or "none", {})
                cls[r.status] = cls.get(r.status, 0) + 1
            out[leg] = {"by_class": by_class, "restarts": restarts,
                        "quarantined": len(server.quarantine),
                        "virtual_s": clock.now(), "wall_s": walls[leg]}
            print(f"storm, {leg}: {STORM_REQUESTS} rids resolved in {walls[leg]:.2f} s wall "
                  f"({clock.now():.1f} virtual s) on {card}; {restarts} restarts; "
                  f"by fault class: {json.dumps(by_class, sort_keys=True)}", flush=True)
    counts = launch_counts()
    check_window_launches("storm", counts, tap.windows)
    for kind in ("malformed_spec", "oversized", "engine_exception:transient",
                 "engine_exception:persistent", "hang", "crash", "poison_lane",
                 "poison_result:nan", "poison_result:finite"):
        check(kind in out["coalesced"]["by_class"], f"storm: fault class {kind} never drawn")
    return out, counts


def warm_restart_phase(specs: list, card: str) -> dict:
    """``python -m repro_torch.launch.serve --study ... --cache-dir ...``
    twice, each a fresh process: the second warms from the first one's
    manifest and must then answer the repeat study with no nvcc build and
    no new library bind."""
    phase("study service: warm restart in a fresh process (twice)")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = pathlib.Path(tmp) / "specs.json"
        spec_path.write_text(json.dumps(specs))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        for i in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve", "--study", str(spec_path),
                 "--cache-dir", str(pathlib.Path(tmp) / "cache"), "--coalesce"],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=SERVE_TIMEOUT_S)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"serve --study run {i + 1}: rc {proc.returncode}\n"
                  f"{proc.stderr[-2000:]}")
            summary = json.loads(proc.stdout.strip().splitlines()[-1])["serve_study"]
            check(summary["statuses"] == {"ok": len(specs)},
                  f"serve --study run {i + 1}: {summary['statuses']}")
            bb = summary["builds_binds"]
            after = {k: bb["at_end"][k] - bb["after_warm"][k] for k in ("builds", "binds")}
            print(f"serve --study run {i + 1} (fresh process, {wall:.2f} s wall): "
                  f"{summary['warmed_entries']} manifest entries replayed in "
                  f"{summary['warm_wall_s']:.3f} s; first request {summary['first_latency_s']:.3f} "
                  f"s; builds / binds at start {bb['at_start']}, after the warm replay "
                  f"{bb['after_warm']}, new after it {after}; on {card}", flush=True)
            runs.append({**summary, "process_wall_s": wall, "new_after_warm": after})
    check(runs[0]["warmed_entries"] == 0, "the first process found a manifest")
    check(runs[1]["warmed_entries"] > 0, "the second process warmed nothing")
    check(runs[1]["new_after_warm"] == {"builds": 0, "binds": 0},
          f"the warmed process built or bound after its warm replay: "
          f"{runs[1]['new_after_warm']}")
    return {"first": runs[0], "second": runs[1]}


def study_service_path(paper_points, card: str) -> tuple[dict, dict]:
    """The resident study service on the card (``repro_torch.serve``,
    ``device=None``): the Fig. 7 fleet as one request, held to the main
    path's direct run; a burst of 16 paper-scale requests served coalesced
    (adaptive) and one at a time, every answer held to its spec's direct
    ``Study.run()``; the chaos storm; the warm restart in fresh processes.
    Every LazyPIM window walked asks two ``bloom_query``, two
    ``bloom_insert`` and one ``bloom_intersect``.  Returns (summary, launch
    counts by leg)."""
    from repro_torch.api import MECHANISMS, all_workloads
    from repro_torch.serve import ServeConfig, StudyServer, build_study

    counts, summary = {}, {}
    phase("study service: the Fig. 7 fleet as one request")
    fig7 = {"workloads": [list(w) for w in all_workloads()], "mechanisms": list(MECHANISMS)}
    server = StudyServer(ServeConfig(coalesce=True))
    (resp,), counts["serve_fig7"], windows, wall = _serve_leg("served Fig. 7", server, [fig7])
    check(resp.status == "ok" and resp.engine == "batch",
          f"served Fig. 7: {resp.status} on {resp.engine} ({resp.error})")
    exact_points(resp.results.points, paper_points, "served Fig. 7 vs the main path")
    print(f"Fig. 7 request: ok on the batch engine (3 buckets: not coalescible) in "
          f"{wall:.2f} s wall on {card}; {windows} LazyPIM windows; every field of 12 x 6 "
          f"results equals the main path's; launches {counts['serve_fig7']}", flush=True)
    summary["fig7_wall_s"] = wall

    phase(f"study service: a burst of {SERVE_BURST} paper-scale requests")
    paper = all_workloads()
    burst = [{"workloads": [list(paper[i % len(paper)])], "mechanisms": list(MECHANISMS),
              "threads": 16, "hw_grid": SERVE_BURST_HW} for i in range(SERVE_BURST)]
    legs = {}
    for name, cfg in (("coalesced", ServeConfig(coalesce=True, adaptive=True)),
                      ("one_at_a_time", ServeConfig())):
        server = StudyServer(cfg)
        resps, counts[f"serve_burst_{name}"], windows, wall = _serve_leg(
            f"burst/{name}", server, burst)
        check([r.status for r in resps] == ["ok"] * SERVE_BURST,
              f"burst/{name}: {[(r.rid, r.status, r.error) for r in resps]}")
        lat = server.telemetry.latency_percentiles()["ok"]
        legs[name] = dict(resps=resps, wall_s=wall, studies_per_s=SERVE_BURST / wall,
                          p50_s=lat["p50_s"], p99_s=lat["p99_s"], windows=windows,
                          engines=sorted({r.engine for r in resps}),
                          dispatch_widths=list(server.telemetry.dispatch_widths),
                          coalesced_dispatches=server.stats["coalesced_dispatches"],
                          audit_lanes=server.stats["audit_lanes"],
                          launches={k: counts[f"serve_burst_{name}"][k] for k in FIG7_KERNELS})
    check(legs["coalesced"]["engines"] == ["coalesced"], f"burst: {legs['coalesced']['engines']}")
    check(legs["one_at_a_time"]["engines"] == ["batch"], f"burst: {legs['one_at_a_time']['engines']}")
    t0 = time.perf_counter()
    direct = {}
    for i, spec in enumerate(burst[:len(paper)]):
        direct[i] = build_study(spec).run()
    direct_wall = time.perf_counter() - t0
    for name, leg in legs.items():
        for r in leg.pop("resps"):
            exact_points(r.results.points, direct[r.rid % len(paper)].points,
                         f"burst/{name}/rid {r.rid} vs its spec's direct run")
        print(f"burst, {name}: {SERVE_BURST} studies in {leg['wall_s']:.2f} s wall "
              f"({leg['studies_per_s']:.3f} studies/s), latency p50 {leg['p50_s']:.3f} s, "
              f"p99 {leg['p99_s']:.3f} s; {leg['coalesced_dispatches']} coalesced dispatches "
              f"of widths {leg['dispatch_widths']}, {leg['audit_lanes']} audited lanes; "
              f"{leg['windows']} LazyPIM windows; Bloom launches {leg['launches']}; on {card}",
              flush=True)
    print(f"every answer of both legs equals its spec's direct Study.run() on every field "
          f"({len(direct)} direct runs, {direct_wall:.2f} s on {card})", flush=True)
    summary["burst"] = legs
    summary["burst_direct_wall_s"] = direct_wall
    summary["storm"], counts["serve_storm"] = storm_phase(card)
    summary["warm_restart"] = warm_restart_phase(burst[:2], card)
    return summary, counts


C3_SPEC_BITS = (4096, 2048)  # the M = 64 Study's specs
C3_LANES = 70_000            # past gridDim.y's 65,535


def signature_caps_phase(K, K8) -> dict:
    """§C3b on the card: the M = 64 Study of tests/test_torch_signature_caps.py
    on both engines against its CPU run (exact, counted a LazyPIM window);
    every parity-form kernel at a spec of 640 column masks (two passes) and
    every bitmap kernel at 70,000 lanes of a small bitmap, one launch, each
    against its plain version, exact."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import SignatureSpec, Study, workload
    from repro_torch.core.signatures import default_spec, pack_words, unpack_words

    counts = {}
    for sig_bits in C3_SPEC_BITS:
        spec = SignatureSpec(sig_bits=sig_bits, num_segments=64)
        phase(f"signature caps: Study at {spec}")
        wl = [workload("htap128"), workload("pagerank", "arxiv")]
        t0 = time.perf_counter()
        cpu = Study(wl, spec=spec, device="cpu").run(engine="sequential")
        cpu_wall = time.perf_counter() - t0
        for engine in ("batch", "sequential"):
            torch.cuda.synchronize()
            KS.reset_launch_counts()
            study = Study(wl, spec=spec)
            t0 = time.perf_counter()
            rs = study.run(engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = launch_counts()
            label = f"M=64 {sig_bits}/{engine}"
            for name in FIG7_KERNELS:
                check(c[name] > 0, f"{label}: {name} never launched")
            check_query_launches(label, study, rs, engine, c)
            check_insert_launches(label, study, rs, engine, c)
            check_intersect_launches(label, study, rs, engine, c)
            exact_points(rs.points, cpu.points, f"{label} vs CPU")
            counts[f"{sig_bits}_{engine}"] = c
            print(f"{label}: 2 workloads x 6 mechanisms in {wall:.2f} s (CPU {cpu_wall:.2f} "
                  f"s), equal to the CPU run on every field; launches {c}", flush=True)

    phase("signature caps: a spec of 640 column masks (two passes)")
    g = torch.Generator(device="cuda").manual_seed(21)
    spec = SignatureSpec(sig_bits=4096, num_segments=128)
    passes = len(K._passes(spec)[0])
    check(passes == 2, f"{spec}: {passes} passes, want 2")

    def words(shape, density):
        return pack_words(torch.rand((*shape[:-1], shape[-1] * 32), generator=g,
                                     device="cuda") < density)

    def held(name, got, want, launched, want_launches):
        got, want = (got if isinstance(got, tuple) else (got,)), \
            (want if isinstance(want, tuple) else (want,))
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{name}: kernel != plain")
        check(launched == want_launches, f"{name}: {launched} launches, want {want_launches}")
        print(f"{name}: equal to the plain version, {launched} launch(es)", flush=True)

    ids = torch.randint(-2**31, 2**31 - 1, (3, 256), generator=g, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand((3, 256), generator=g, device="cuda") < 0.8
    bitmap = words((3, 205), 0.01)
    sig = words((3, spec.num_words), 1 - 0.5 / spec.num_segments)
    bits = unpack_words(sig, spec.sig_bits).contiguous()

    def run(name, fn, plain, kernel, mod=K):
        mod.reset_launch_counts()
        got = fn()
        launched = mod.launch_counts()[kernel]
        held(name, got, plain(), launched, passes)

    run("bloom_insert ids pair", lambda: K.bloom_insert(spec, ids=ids, valid=valid, ids_b=ids,
                                                        valid_b=valid),
        lambda: K.bloom_insert_plain(spec, ids=ids, valid=valid, ids_b=ids, valid_b=valid),
        "bloom_insert")
    run("bloom_insert bank pair", lambda: K.bloom_insert(spec, bitmap=bitmap, bitmap_b=bitmap,
                                                         num_lines=6550, num_regs=16),
        lambda: K.bloom_insert_plain(spec, bitmap=bitmap, bitmap_b=bitmap, num_lines=6550,
                                     num_regs=16), "bloom_insert")
    run("bloom_query pair", lambda: K.bloom_query(spec, sig, bitmap, 6550, words_b=bitmap),
        lambda: K.bloom_query_plain(spec, sig, bitmap, 6550, bitmap), "bloom_query")
    run("bloom_insert_onehot pair", lambda: K8.bloom_insert_onehot(spec, sig, ids, valid,
                                                                   addrs_b=ids),
        lambda: K8.bloom_insert_onehot_plain(spec, sig, ids, valid, addrs_b=ids),
        "bloom_insert_onehot", K8)
    run("bloom_query_onehot", lambda: K8.bloom_query_onehot(spec, bits, ids),
        lambda: K8.bloom_query_onehot_plain(spec, bits, ids), "bloom_query_onehot", K8)
    # registers that meet all 128 segments of their lane's image about half
    # the time, so the runs of 32 segments past the first decide
    a = words((48, spec.num_words), 0.15)
    for name, fn, plain in (
            ("bloom_intersect rows (128 segments)", lambda: K.bloom_intersect(a, sig, 128),
             lambda: K.bloom_intersect_plain(a, sig, 128)),
            ("bloom_intersect pair (128 segments)",
             lambda: K.bloom_intersect(a, sig, 128, a_b=a.flip(0)),
             lambda: K.bloom_intersect_plain(a, sig, 128, a.flip(0))),
            ("h3_hash (128 segments)", lambda: K.h3_hash(spec, ids[0]),
             lambda: K.h3_hash_plain(spec, ids[0]))):
        K.reset_launch_counts()
        got = fn()
        held(name, got, plain(), sum(K.launch_counts().values()), 1)
    rows = K.bloom_intersect_plain(a, sig, 128)
    check(0 < int(rows.sum()) < rows.numel(), f"intersect rows all {bool(rows[0])}")

    phase(f"signature caps: {C3_LANES:,} lanes, one launch a kernel")
    spec, lanes = default_spec(), C3_LANES
    ids = torch.randint(-2**31, 2**31 - 1, (lanes, 8), generator=g, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand((lanes, 8), generator=g, device="cuda") < 0.7
    bitmap = words((lanes, 2), 0.3)
    sig = words((lanes, spec.num_words), 0.8)
    bits = unpack_words(sig, spec.sig_bits).contiguous()
    passes = 1
    run("bloom_insert ids, 70,000 lanes", lambda: K.bloom_insert(spec, ids=ids, valid=valid),
        lambda: K.bloom_insert_plain(spec, ids=ids, valid=valid), "bloom_insert")
    run("bloom_insert bank pair (4 registers), 70,000 lanes",
        lambda: K.bloom_insert(spec, bitmap=bitmap, bitmap_b=bitmap.flip(0), num_lines=60,
                               num_regs=4),
        lambda: K.bloom_insert_plain(spec, bitmap=bitmap, bitmap_b=bitmap.flip(0),
                                     num_lines=60, num_regs=4), "bloom_insert")
    run("bloom_query pair, 70,000 lanes",
        lambda: K.bloom_query(spec, sig, bitmap, 60, words_b=bitmap.flip(0)),
        lambda: K.bloom_query_plain(spec, sig, bitmap, 60, bitmap.flip(0)), "bloom_query")
    run("bloom_insert_onehot, 70,000 lanes",
        lambda: K8.bloom_insert_onehot(spec, None, ids, valid),
        lambda: K8.bloom_insert_onehot_plain(spec, None, ids, valid),
        "bloom_insert_onehot", K8)
    run("bloom_query_onehot, 70,000 lanes", lambda: K8.bloom_query_onehot(spec, bits, ids),
        lambda: K8.bloom_query_onehot_plain(spec, bits, ids), "bloom_query_onehot", K8)
    K.reset_launch_counts()
    K8.reset_launch_counts()
    return counts


def device_busy_s(fn, top: int | None = 8) -> tuple[float, int, list]:
    """Device time of all kernels ``fn()`` runs (``torch.profiler``), their
    number, and the ``top`` by name (all of them for None), largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = sorted(((e.self_device_time_total / 1e6, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    return sum(t for t, _, _ in by_name), sum(c for _, c, _ in by_name), by_name[:top]


def main_path_profile(batch_wall_s: float) -> dict:
    """Device time of one profiled batch run, by kernel, against the wall
    time of the unprofiled batch run: the device's busy and idle shares."""
    from repro_torch.api import Study, all_workloads

    phase("Fig. 7 path profile, engine=batch")
    busy_s, launches, top = device_busy_s(
        lambda: Study(all_workloads()).run(engine="batch"))
    summary = dict(device_busy_s=busy_s, batch_wall_s=batch_wall_s,
                   idle_share=1.0 - busy_s / batch_wall_s, launches=launches,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    for t, c, k in top:
        print(f"  {t:9.4f} s {c:7d}x  {k[:100]}")
    print(f"device busy {busy_s:.3f} s of {batch_wall_s:.3f} s batch wall "
          f"(idle share {summary['idle_share']:.3f})", flush=True)
    return summary


class OnehotTap:
    """While active, records every ``bloom_insert_onehot`` and
    ``bloom_query_onehot`` call the seed primitives make — inputs and
    result — by wrapping the two names :mod:`repro_torch.sim.prep` calls;
    the wrapped calls launch exactly what they would have.  :meth:`check`
    then holds each result against the kernel's plain version on the same
    inputs (those calls launch nothing, so nothing is counted)."""

    def __init__(self):
        self.inserts, self.queries = [], []

    def __enter__(self):
        import repro_torch.sim.prep as P

        self._mod = P
        self._orig = (P.bloom_insert_onehot, P.bloom_query_onehot)
        insert, query = self._orig

        def tapped_insert(spec, sig, addrs, mask=None, **pair):
            out = insert(spec, sig, addrs, mask, **pair)
            self.inserts.append((spec, sig, addrs, mask, pair, out))
            return out

        def tapped_query(spec, bits, addrs):
            out = query(spec, bits, addrs)
            self.queries.append((spec, bits, addrs, out))
            return out

        P.bloom_insert_onehot, P.bloom_query_onehot = tapped_insert, tapped_query
        return self

    def __exit__(self, *exc):
        self._mod.bloom_insert_onehot, self._mod.bloom_query_onehot = self._orig
        return False

    def check(self, label: str) -> int:
        """Hold every recorded call to its plain version (exact); returns
        the largest |diff| seen (0)."""
        import torch

        from repro_torch.kernels.bloom import onehot as K8

        err = 0
        for spec, sig, addrs, mask, pair, out in self.inserts:
            want = K8.bloom_insert_onehot_plain(spec, sig, addrs, mask, **pair)
            for got, ref in zip(out, want) if pair else ((out, want),):
                err = max(err, int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()))
        for spec, bits, addrs, out in self.queries:
            want = K8.bloom_query_onehot_plain(spec, bits, addrs)
            err = max(err, int((out != want).sum()))
        check(err == 0, f"{label}: a seed one-hot kernel call disagrees with its "
                        f"plain version (max |diff| {err})")
        return err


def seed_path(sequential) -> tuple[dict, dict, OnehotTap]:
    """The seed reference engine (``run_all_bool``) over the Fig. 7 fleet on
    the card, one trace at a time, tapped: every B8 call is held to its
    plain version, every SimResult field to the packed sequential engine's
    (exact), the goldens at their tolerances; then the full-commit and
    no-DBI ablations on two workloads against the packed engine, and a
    profiled run for the idle share.  Returns (launch counts, summary, the
    tap)."""
    import types

    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import HWParams, LazyPIMConfig, all_workloads, run_all
    from repro_torch.core._boolref import run_all_bool, simulate_lazypim_bool
    from repro_torch.sim.prep import prepare
    from repro_torch.sim.trace import make_trace

    phase("seed path (run_all_bool), Fig. 7 fleet")
    dev = torch.device("cuda", 0)
    golden = json.loads((GOLDEN_DIR / "fig7_golden.json").read_text())
    t0 = time.perf_counter()
    traces = [prepare(make_trace(a, g, device=dev), device=dev)
              for a, g in all_workloads()]
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    packed = {p.workload: p for p in sequential}
    check(sorted(packed) == sorted(tt.name for tt in traces),
          f"seed fleet {[tt.name for tt in traces]} vs {sorted(packed)}")
    tap = OnehotTap()
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    walls = {}
    with tap:
        results = []
        for tt in traces:
            t1 = time.perf_counter()
            results.append(run_all_bool(tt))
            torch.cuda.synchronize()
            walls[tt.name] = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        ablations = {(tt.name, label): simulate_lazypim_bool(tt, HWParams(), cfg)
                     for tt in traces if tt.name in SEED_ABLATION_WORKLOADS
                     for label, cfg in (("full_commit", LazyPIMConfig(partial_commits=False)),
                                        ("no_dbi", LazyPIMConfig(use_dbi=False)))}
        torch.cuda.synchronize()
        ablation_wall = time.perf_counter() - t1
    counts = launch_counts()
    print(f"seed: {len(results)} workloads x 6 mechanisms in {wall:.2f} s wall "
          f"(traces staged beforehand in {prep_s:.2f} s), {len(ablations)} "
          f"ablation runs in {ablation_wall:.2f} s; launches {counts}", flush=True)
    for name in SEED_KERNELS:
        check(counts[name] > 0, f"seed: kernel {name} was never launched")
    # one LazyPIM run a trace in run_all_bool, two an ablation workload
    windows = sum(tt.num_windows * (1 + 2 * (tt.name in SEED_ABLATION_WORKLOADS))
                  for tt in traces)
    check(counts["bloom_insert_onehot"] == windows,
          f"seed: {counts['bloom_insert_onehot']} bloom_insert_onehot launches, want "
          f"{windows} (one a LazyPIM window)")
    n_fields = 0
    for tt, res in zip(traces, results):
        want = packed[tt.name].results
        check(set(res) == set(want), f"seed/{tt.name}: mechanisms {sorted(res)}")
        for m, r in res.items():
            da, db = dataclasses.asdict(r), dataclasses.asdict(want[m])
            diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
            check(not diff, f"seed/{tt.name}/{m}: seed != packed {diff}")
            n_fields += len(da)
    for (name, label), r in ablations.items():
        tt = next(t for t in traces if t.name == name)
        cfg = (LazyPIMConfig(partial_commits=False) if label == "full_commit"
               else LazyPIMConfig(use_dbi=False))
        want = run_all(tt, HWParams(), ("lazypim",), cfg)["lazypim"]
        check(dataclasses.asdict(r) == dataclasses.asdict(want),
              f"seed/{name}/lazypim {label}: seed != packed")
    worst = check_golden([types.SimpleNamespace(workload=tt.name, results=res,
                                                hw=packed[tt.name].hw)
                          for tt, res in zip(traces, results)], golden, "seed")
    err = tap.check("seed")
    print(f"seed: equals the packed sequential engine on all {n_fields} fields of "
          f"{len(results)} x 6 results and on the {len(ablations)} ablation runs "
          f"({', '.join(SEED_ABLATION_WORKLOADS)}: partial_commits=False, "
          f"use_dbi=False); goldens {GOLDEN_WORKLOADS} hold (worst rel gap "
          f"{worst:.3g}); bloom_insert_onehot launched once a LazyPIM window "
          f"({windows} windows); {len(tap.inserts)} bloom_insert_onehot and "
          f"{len(tap.queries)} bloom_query_onehot calls equal their plain "
          f"versions", flush=True)

    phase(f"seed path profile ({', '.join(SEED_PROFILE_WORKLOADS)})")
    profiled = [tt for tt in traces if tt.name in SEED_PROFILE_WORKLOADS]
    profiled_wall = sum(walls[tt.name] for tt in profiled)
    busy_s, launches, top = device_busy_s(lambda: [run_all_bool(tt) for tt in profiled])
    for t, c, k in top:
        print(f"  {t:9.4f} s {c:7d}x  {k[:100]}")
    idle = 1.0 - busy_s / profiled_wall
    print(f"device busy {busy_s:.3f} s of their {profiled_wall:.3f} s seed wall (idle "
          f"share {idle:.3f}); {launches} kernels", flush=True)
    summary = dict(wall_s=wall, wall_s_by_workload=walls, prepare_s=prep_s,
                   ablation_wall_s=ablation_wall,
                   ablations=[f"{n}/{lab}" for n, lab in ablations],
                   profiled=list(SEED_PROFILE_WORKLOADS), profiled_wall_s=profiled_wall,
                   device_busy_s=busy_s, idle_share=idle, kernels=launches,
                   golden_worst_rel_gap=worst, tapped_inserts=len(tap.inserts),
                   tapped_queries=len(tap.queries), max_abs_err=err,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    return counts, summary, tap


def onehot_kernel_phases(tap: OnehotTap, floor_ms: float) -> dict[str, dict]:
    """B8 timed at the seed path's shapes, on inputs it gave the kernels:
    the insert call with the most valid slots in its first list (alone, and
    as the window's pair of lists) and the query over the most lines.
    Bound: bytes over 3.35 TB/s or the parity hash's operations over 67
    Top/s, the larger: ``log2 seg_bits`` columns of ``PARITY_OPS`` for
    every segment of a valid address for the insert, for each segment up
    to an address's first clear bit (where the kernel stops) for the query,
    with the query's xor-fold bound of earlier runs printed beside it."""
    import torch

    from repro_torch.core.signatures import hash_positions_xorfold
    from repro_torch.kernels.bloom import onehot as K8

    out = {}
    phase("kernel bloom_insert_onehot")
    spec, _, addrs, mask, pair, _ = max(tap.inserts, key=lambda r: int(r[3].sum()))
    addrs_b, mask_b = pair["addrs_b"], pair["mask_b"]

    def max_err(got, want):
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    err = max_err(K8.bloom_insert_onehot(spec, None, addrs, mask),
                  K8.bloom_insert_onehot_plain(spec, None, addrs, mask))
    check(err == 0, "bloom_insert_onehot: kernel disagrees with plain version")
    got = K8.bloom_insert_onehot(spec, None, addrs, mask, addrs_b=addrs_b, mask_b=mask_b)
    want = K8.bloom_insert_onehot_plain(spec, None, addrs, mask, addrs_b=addrs_b,
                                        mask_b=mask_b)
    err_pair = max(max_err(g, w) for g, w in zip(got, want))
    check(err_pair == 0, "bloom_insert_onehot pair: kernel disagrees with plain version")
    lanes, n = addrs.shape
    n_valid, n_valid_b = int(mask.sum()), int(mask_b.sum())
    m, nw = spec.num_segments, spec.num_words
    hash_ops = m * (spec.seg_bits.bit_length() - 1) * PARITY_OPS
    previous = PREVIOUS_MS["bloom_insert_onehot"]
    st = measure(f"bloom_insert_onehot (L={lanes}, N={n}, {n_valid} valid, "
                 f"{spec.sig_bits} bits, M={m})", err,
                 lambda a, k: K8.bloom_insert_onehot(spec, None, a, k),
                 lambda a, k: K8.bloom_insert_onehot_plain(spec, None, a, k),
                 (addrs, mask), nbytes=lanes * n * 5 + lanes * nw * 4,
                 ops=n_valid * hash_ops)
    pair_st = measure(f"bloom_insert_onehot pair (L={lanes}, N={n} twice, {n_valid} and "
                      f"{n_valid_b} valid)", err_pair,
                      lambda a, k, b, j: K8.bloom_insert_onehot(spec, None, a, k, addrs_b=b,
                                                                mask_b=j),
                      lambda a, k, b, j: K8.bloom_insert_onehot_plain(
                          spec, None, a, k, addrs_b=b, mask_b=j),
                      (addrs, mask, addrs_b, mask_b),
                      nbytes=lanes * (n + addrs_b.shape[1]) * 5 + 2 * lanes * nw * 4,
                      ops=(n_valid + n_valid_b) * hash_ops)
    print(f"bloom_insert_onehot: launch floor {floor_ms:.5f} ms ({st['ms'] / floor_ms:.2f}x "
          f"it, the pair {pair_st['ms'] / floor_ms:.2f}x); previous design's reading "
          f"{previous:.5f} ms a single call ({PREVIOUS_CARD})", flush=True)
    out["bloom_insert_onehot"] = dict(st, pair=pair_st,
                                      shape=dict(L=lanes, N=n, valid=n_valid,
                                                 pair_valid=n_valid_b,
                                                 sig_bits=spec.sig_bits, M=m))

    phase("kernel bloom_query_onehot")
    spec, bits, addrs, _ = max(tap.queries, key=lambda r: r[2].shape[1])
    got = K8.bloom_query_onehot(spec, bits, addrs)
    want = K8.bloom_query_onehot_plain(spec, bits, addrs)
    err = int((got != want).sum())
    check(err == 0, "bloom_query_onehot: kernel disagrees with plain version")
    lanes, n = addrs.shape
    m, ab = spec.num_segments, spec.addr_bits
    pos = hash_positions_xorfold(spec, addrs.reshape(-1)).to(torch.int64)
    looked = bits.gather(1, pos.reshape(lanes, -1)).reshape(lanes, n, m)
    hashed = int((looked.to(torch.int64).cumprod(-1).sum(-1) + 1).clamp(max=m).sum())
    log_seg = spec.seg_bits.bit_length() - 1
    old_bound, old_by = bound_ms(n * 4 + lanes * spec.sig_bits + n + m * ab * 4,
                                 hashed * ab * XORFOLD_OPS)
    st = measure(f"bloom_query_onehot (L={lanes}, N={n}, {spec.sig_bits} bits, M={m}, "
                 f"{int(want.sum())} members, {hashed} segments hashed)", err,
                 lambda b, a: K8.bloom_query_onehot(spec, b, a),
                 lambda b, a: K8.bloom_query_onehot_plain(spec, b, a), (bits, addrs),
                 nbytes=lanes * n * 5 + lanes * spec.sig_bits,
                 ops=hashed * log_seg * PARITY_OPS)
    print(f"bloom_query_onehot: old bound {old_bound:.7f} ms ({old_by}, the "
          f"xor-fold's rounds)", flush=True)
    out["bloom_query_onehot"] = dict(st, old_bound_ms=old_bound,
                                     shape=dict(L=lanes, N=n, sig_bits=spec.sig_bits,
                                                M=m, segments_hashed=hashed))
    return out


def signatures_phase(K, card: str) -> dict:
    """``benchmarks/bench_signatures.py`` on the card: the byte-sliced hash
    (B1) against the seed xor-fold at batch 4,096; the seed one-hot insert
    and query (B8) against the word-level kernels (B2, B3) at batch 1,024;
    the fused conflict detector (B5) against the two-pass PyTorch path
    (hash, unpack, gather, sum) at G = 4, 256 ids a group, 1,024 probes.
    Every pair must agree bit for bit.  Prints one ``{"signatures": ...}``
    line and writes no file."""
    import numpy as np
    import torch

    from repro_torch.core import signatures as S
    from repro_torch.kernels.bloom import onehot as K8

    phase("signatures (bench_signatures on the card)")
    dev = torch.device("cuda", 0)
    spec = S.default_spec()
    nw, iters = spec.num_words, 200

    def ms(fn, *args, n=iters):
        return event_ms(fn, rotations(args, n), n)

    def pair(label, a_name, a_ms, b_name, b_ms, **extra):
        row = {a_name: a_ms, b_name: b_ms, "speedup": a_ms / b_ms, "exact": True, **extra}
        print(f"{label}: {a_name} {a_ms:.5f} ms, {b_name} {b_ms:.5f} ms "
              f"({row['speedup']:.2f}x), bit-exact", flush=True)
        return row

    def u32(rng, n, high=2**32):
        return torch.from_numpy(rng.integers(0, high, size=(n,), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    out = {"card": card, "spec": dict(sig_bits=spec.sig_bits, num_segments=spec.num_segments,
                                      addr_bits=spec.addr_bits)}
    addrs = u32(np.random.default_rng(0), SIG_HASH_BATCH)
    got = K.h3_hash(spec, addrs)
    check(torch.equal(got, S.hash_positions_xorfold(spec, addrs)),
          "signatures: byte-sliced H3 != xor-fold")
    out["hash_positions"] = pair(
        f"hash_positions (batch {SIG_HASH_BATCH})", "xorfold_ms",
        ms(lambda a: S.hash_positions_xorfold(spec, a), addrs, n=20),
        "bytesliced_ms", ms(lambda a: K.h3_hash(spec, a), addrs), batch=SIG_HASH_BATCH)

    # Line ids, so the word-level query (B3, over a line bitmap) can take
    # the same probes: half of them inserted, half fresh.
    rng = np.random.default_rng(1)
    ids = u32(rng, SIG_KERNEL_BATCH, SIG_LINES)[None]
    valid = torch.ones_like(ids, dtype=torch.bool)
    sig0 = torch.zeros((1, nw), dtype=torch.int32, device=dev)
    onehot_sig = K8.bloom_insert_onehot(spec, sig0, ids, valid)
    word_sig = K.bloom_insert(spec, ids=ids, valid=valid)[:, 0]
    check(torch.equal(onehot_sig, word_sig) and torch.equal(
        onehot_sig, K8.bloom_insert_onehot_plain(spec, sig0, ids, valid)),
        "signatures: one-hot insert != word-level insert / plain")
    out["insert"] = pair(
        f"insert (batch {SIG_KERNEL_BATCH})", "onehot_ms",
        ms(lambda s, a, v: K8.bloom_insert_onehot(spec, s, a, v), sig0, ids, valid),
        "word_ms", ms(lambda a, v: K.bloom_insert(spec, ids=a, valid=v), ids, valid),
        batch=SIG_KERNEL_BATCH, ids_below=SIG_LINES)

    probes = torch.cat([ids[0, :SIG_KERNEL_BATCH // 2],
                        u32(rng, SIG_KERNEL_BATCH // 2, SIG_LINES)])[None]
    bits = S.unpack_words(onehot_sig, spec.sig_bits)
    member = K8.bloom_query_onehot(spec, bits, probes)
    line_bm = torch.zeros((1, SIG_LINES), dtype=torch.bool, device=dev)
    line_bm[0, probes[0].to(torch.int64)] = True
    words = S.pack_words(line_bm)
    word_member = S.unpack_words(K.bloom_query(spec, word_sig, words, SIG_LINES),
                                 SIG_LINES)[0, probes[0].to(torch.int64)]
    check(torch.equal(member[0], word_member) and torch.equal(
        member, K8.bloom_query_onehot_plain(spec, bits, probes)),
        "signatures: one-hot query != word-level query / plain")
    n_member = int(member.sum())
    check(0 < n_member < SIG_KERNEL_BATCH, f"signatures: {n_member} members")
    out["query"] = pair(
        f"query (batch {SIG_KERNEL_BATCH}, {n_member} members)", "onehot_ms",
        ms(lambda b, a: K8.bloom_query_onehot(spec, b, a), bits, probes),
        "word_ms", ms(lambda s, w: K.bloom_query(spec, s, w, SIG_LINES), word_sig, words),
        batch=SIG_KERNEL_BATCH, members=n_member, word_bitmap_lines=SIG_LINES)

    rng = np.random.default_rng(2)
    group_ids = [u32(rng, SIG_IDS_PER_GROUP, 50_000) for _ in range(SIG_GROUPS)]
    sigs = torch.stack([S.insert(spec, S.empty_signature(spec, dev), a)
                        for a in group_ids]).contiguous()
    probes = u32(rng, SIG_KERNEL_BATCH, 50_000)

    def two_pass(sg, a):
        pos = S.hash_positions(spec, a).to(torch.int64)
        return S.unpack_bits(spec, sg)[:, pos].all(-1).sum(0, dtype=torch.int32)

    fused = K.bloom_detect_conflicts(spec, sigs, probes)
    check(torch.equal(fused, two_pass(sigs, probes)),
          "signatures: fused conflict detector != two-pass path")
    out["conflict"] = pair(
        f"conflict (G={SIG_GROUPS}, {SIG_IDS_PER_GROUP} ids a group, "
        f"{SIG_KERNEL_BATCH} probes)", "two_pass_ms", ms(two_pass, sigs, probes),
        "fused_ms", ms(lambda sg, a: K.bloom_detect_conflicts(spec, sg, a), sigs, probes),
        batch=SIG_KERNEL_BATCH, num_groups=SIG_GROUPS,
        hit_counts=torch.bincount(fused.to(torch.int64),
                                  minlength=SIG_GROUPS + 1).tolist())
    print(json.dumps({"signatures": out}), flush=True)
    return out


class KernelTap:
    """While active, records every ``bloom_detect_conflicts`` and
    ``lazy_merge`` call the LazySync module makes — inputs and result —
    by wrapping the two names it calls; the wrapped calls launch exactly
    what they would have, and the tap itself launches nothing.
    :meth:`check` then holds each recorded result against the kernel's
    plain version on the same inputs (those launches are not counted)."""

    def __init__(self):
        self.b5, self.b6 = [], []

    def __enter__(self):
        import repro_torch.core.lazy_sync as LS

        self._mod = LS
        self._orig = (LS.bloom_detect_conflicts, LS.lazy_merge)
        detect, merge = self._orig

        def tapped_detect(spec, sigs, addrs):
            out = detect(spec, sigs, addrs)
            self.b5.append((spec, sigs, addrs, out))
            return out

        def tapped_merge(rows, base, valid):
            out = merge(rows, base, valid)
            self.b6.append((rows, base, valid, out))
            return out

        LS.bloom_detect_conflicts, LS.lazy_merge = tapped_detect, tapped_merge
        return self

    def __exit__(self, *exc):
        self._mod.bloom_detect_conflicts, self._mod.lazy_merge = self._orig
        return False

    def clear(self) -> None:
        self.b5.clear()
        self.b6.clear()

    def check(self, label: str) -> tuple[int, float]:
        """(max |diff| of the B5 counts, max relative diff of the B6 merges)
        over every recorded call; fails past exact / ``MERGE_RTOL``."""
        import torch

        from repro_torch.core.signatures import to_addr_i32
        from repro_torch.kernels.bloom import bloom as K

        LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
        err5, err6 = 0, 0.0
        for spec, sigs, addrs, out in self.b5:
            want = K.bloom_detect_conflicts_plain(spec, sigs.contiguous(), to_addr_i32(addrs))
            err5 = max(err5, int((out.to(torch.int64) - want).abs().max())
                       if out.numel() else 0)
        for rows, base, valid, out in self.b6:
            want = LM.lazy_merge_plain(rows, base, valid)
            err6 = max(err6, merge_rel_err(out, want))
        check(err5 == 0, f"{label}: bloom_detect_conflicts disagrees with its "
                         f"plain version (max |diff| {err5})")
        check(err6 <= MERGE_RTOL, f"{label}: lazy_merge disagrees with its plain "
                                  f"version (max rel diff {err6:.3g})")
        return err5, err6


def merge_rel_err(got, want) -> float:
    if not got.numel():
        return 0.0
    diff = (got - want).abs()
    return float((diff / want.abs().clamp_min(1e-30)).max())


def compare_results(a, b, label: str) -> float:
    """Hold one ResultSet's SimResults to another's: event counts exact,
    raw accumulators 1e-4 relative, the summary ratios 1e-6; returns the
    worst relative gap seen."""
    from repro_torch.api import summarize

    worst = 0.0
    check([p.workload for p in a] == [p.workload for p in b],
          f"{label}: workloads differ")
    for pa, pb in zip(a.points, b.points):
        check(set(pa.results) == set(pb.results), f"{label}: mechanisms differ")
        for m in pa.results:
            da, db = dataclasses.asdict(pa.results[m]), dataclasses.asdict(pb.results[m])
            for k, want in db.items():
                have = da[k]
                if isinstance(want, str):
                    check(have == want, f"{label}/{m}/{k}: {have!r} vs {want!r}")
                elif k in EVENT_KEYS:
                    check(have == want, f"{label}/{m}/{k}: {have} vs {want} (exact)")
                else:
                    gap = _rel(have, want)
                    worst = max(worst, gap)
                    check(gap < RAW_RTOL, f"{label}/{m}/{k}: {have!r} vs {want!r}")
        sa, sb = summarize(pa.results, pa.hw), summarize(pb.results, pb.hw)
        for m in sb:
            for k in RATIO_KEYS:
                gap = _rel(sa[m][k], sb[m][k])
                worst = max(worst, gap)
                check(gap < RATIO_RTOL, f"{label}/{m}/{k}: {sa[m][k]!r} vs {sb[m][k]!r}")
    return worst


def capture_path() -> tuple[dict, dict, KernelTap]:
    """``Study(["capture/lazy_embed"])`` on both engines against the port's
    CPU run of the same study; every B5/B6 call held against its plain
    version.  Returns (launch counts, wall s, the tap of the batch run)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study

    counts, walls, taps = {}, {}, {}
    for engine in ("batch", "sequential"):
        phase(f"capture path, engine={engine}")
        tap = KernelTap()
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        study = Study([CAPTURE_APP])
        with tap:
            rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine] = launch_counts()
        print(f"{engine}: {CAPTURE_APP} x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall; launches {counts[engine]}", flush=True)
        for name in CAPTURE_KERNELS:
            check(counts[engine][name] > 0,
                  f"capture/{engine}: kernel {name} was never launched")
        check_query_launches(f"capture/{engine}", study, rs, engine, counts[engine])
        check_insert_launches(f"capture/{engine}", study, rs, engine, counts[engine])
        check_intersect_launches(f"capture/{engine}", study, rs, engine, counts[engine])
        t0 = time.perf_counter()
        cpu = Study([CAPTURE_APP], device="cpu").run(engine=engine)
        cpu_wall = time.perf_counter() - t0
        worst = compare_results(rs, cpu, f"capture/{engine}")
        err5, err6 = tap.check(f"capture/{engine}")
        print(f"{engine}: equals the port's CPU run ({cpu_wall:.2f} s) on every "
              f"field (worst rel gap {worst:.3g}); {len(tap.b5)} "
              f"bloom_detect_conflicts calls exact, {len(tap.b6)} lazy_merge "
              f"calls within {err6:.3g} of their plain versions", flush=True)
        taps[engine] = tap
    return counts, walls, taps["batch"]


def _lazy_touched(rng, vocab: int, groups: int, per_group: int):
    """(G, per_group) int32 touched ids drawn as ``capture_lazy_embed``
    draws them: zipf ranks with a small per-group shift through a fixed
    hot-set permutation."""
    import numpy as np

    base_rng = np.random.default_rng(0)
    order = base_rng.permutation(vocab)
    shifts = base_rng.integers(0, vocab // 64, size=groups)
    u = rng.random((groups, per_group))
    ranks = np.minimum((vocab * u ** LAZY_ZIPF).astype(np.int64), vocab - 1)
    return order[np.minimum(ranks + shifts[:, None], vocab - 1)].astype(np.int32)


def _lazy_batch(step: int, vocab: int, d: int, groups: int, dev):
    """One step's inputs at full width, from numpy seeds: (G, T) touched
    ids (:func:`_lazy_touched`) and a dense (G, V, d) float32 gradient that
    is nonzero on exactly those rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng([1, step])
    touched = _lazy_touched(rng, vocab, groups, LAZY_TOUCHED)
    grads = torch.zeros((groups, vocab, d), dtype=torch.float32, device=dev)
    for g in range(groups):
        rows = np.unique(touched[g])
        vals = rng.standard_normal((rows.size, d), dtype=np.float32) * np.float32(0.01)
        grads[g, torch.from_numpy(rows).to(dev)] = torch.from_numpy(vals).to(dev)
    return torch.from_numpy(touched).to(dev), grads


def lazysync_path() -> dict:
    """24 ``sync_step``s of LazySync at qwen3-4b width on the card, each
    step's kernel calls held against their plain versions; then the idle
    share from 8 more steps run twice from one snapshot."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig, init_state

    phase("LazySync at qwen3-4b width")
    dev = torch.device("cuda", 0)
    mcfg, cfg = get_config("qwen3_4b"), LazySyncConfig()
    emb = LazyEmbed(mcfg, cfg)
    vocab, d, groups = mcfg.vocab, mcfg.d_model, cfg.num_groups
    print(f"{mcfg.name}: vocab {vocab}, d_model {d}, {groups} groups, "
          f"{cfg.sig_bits}-bit signatures / {cfg.num_segments} segments, budget "
          f"{cfg.max_reconcile_rows}, commit every {cfg.commit_interval}, "
          f"{mcfg.param_dtype}; {LAZY_TOUCHED} touched ids per group", flush=True)
    params = emb.init(torch.Generator(device=dev).manual_seed(0))
    state = init_state(cfg, vocab, dev)
    counts = {name: 0 for name in TPU_KERNEL}
    steps, keep = [], {}
    tap = KernelTap()
    for step in range(LAZY_STEPS):
        touched, grads = _lazy_batch(step, vocab, d, groups, dev)
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        t0 = time.perf_counter()
        with tap:
            params, state, m = emb.sync_step(params, state, touched, grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, n in launch_counts().items():
            counts[name] += n
        del grads
        err5, err6 = tap.check(f"qwen3 step {step + 1}")
        if "detect" not in keep:
            keep["detect"] = tap.b5[0]
            keep["reconcile"] = tap.b6[0]
        row = dict(step=step + 1, wall_s=wall,
                   lazy_conflict_rows=int(m["lazy_conflict_rows"]),
                   lazy_pinned=int(m["lazy_pinned"]),
                   lazy_commit=bool(m["lazy_commit"]),
                   lazy_bytes=int(m["lazy_bytes"]), dense_bytes=int(m["dense_bytes"]),
                   b5_err=err5, b6_rel_err=err6)
        if row["lazy_commit"]:
            keep["commit"] = tap.b6[-1]
            table, base = params["table"], params["base"]
            for g in range(groups):
                check(torch.equal(table[g], base),
                      f"qwen3 step {step + 1}: replica {g} != base after the commit")
            row["replicas_equal_base"] = True
        tap.clear()
        steps.append(row)
        print(f"step {row['step']:2d}: {wall * 1e3:9.3f} ms; conflict rows "
              f"{row['lazy_conflict_rows']}, pinned {row['lazy_pinned']}, commit "
              f"{row['lazy_commit']}, lazy {row['lazy_bytes']} B vs dense "
              f"{row['dense_bytes']} B; B5 exact, B6 rel err {err6:.3g}", flush=True)
    check(sum(r["lazy_commit"] for r in steps) >= 1, "qwen3: no commit fired")
    check("commit" in keep, "qwen3: the commit's merge was not seen")
    for name in ("h3_hash", "bloom_detect_conflicts", "lazy_merge"):
        check(counts[name] > 0, f"qwen3: kernel {name} was never launched")

    # idle share: the same 8 steps from one snapshot, unprofiled then
    # profiled, on one step's inputs reused (bounded memory)
    snap_p = {k: v.clone() for k, v in params.items()}
    snap_s = {k: v.clone() for k, v in state.items()}
    del params, state
    window_inputs = _lazy_batch(LAZY_STEPS, vocab, d, groups, dev)

    def run_window():
        p, st = snap_p, snap_s
        for _ in range(LAZY_PROFILE_STEPS):
            p, st, _ = emb.sync_step(p, st, *window_inputs)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_window()
    window_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy, _, by_name = device_busy_s(run_window)
    for t, c, k in by_name:
        print(f"  {t:9.4f} s {c:5d}x  {k[:100]}")
    idle = 1.0 - busy / window_wall
    walls = [r["wall_s"] for r in steps]
    plain_walls = [r["wall_s"] for r in steps if not r["lazy_commit"]]
    summary = dict(steps=steps, launches=counts,
                   step_wall_s_median=sorted(plain_walls)[len(plain_walls) // 2],
                   commit_step_wall_s=[r["wall_s"] for r in steps if r["lazy_commit"]],
                   total_wall_s=sum(walls), idle_window_steps=LAZY_PROFILE_STEPS,
                   idle_window_wall_s=window_wall, idle_window_busy_s=busy,
                   idle_share=idle, peak_mem_window_bytes=peak,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in by_name])
    print(f"24 steps: {sum(walls):.3f} s; median non-commit step "
          f"{summary['step_wall_s_median'] * 1e3:.3f} ms; commit step(s) "
          f"{[round(w * 1e3, 3) for w in summary['commit_step_wall_s']]} ms; "
          f"launches {counts}", flush=True)
    print(f"idle share: device busy {busy:.4f} s of {window_wall:.4f} s over "
          f"{LAZY_PROFILE_STEPS} steps (idle share {idle:.3f}); peak memory "
          f"allocated over those steps {peak / 2**30:.2f} GiB (a 3.9 GB "
          f"snapshot of the params included)", flush=True)
    summary["keep"] = keep
    return summary


def unsaturated_checks(keep: dict) -> dict:
    """B5 and B6 against their plain versions at qwen3-4b width where their
    outputs vary.  At the path's load the 2,048-bit signatures saturate and
    every touched id tests as a member of all G groups, and every budget
    row is valid; so B5 also runs on a draw of a quarter the size (1,024
    ids a group) at vocab 151,936, whose hit counts must take at least
    three values, and B6 on the path's reconcile rows with about half the
    valid flags cleared."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.lazy_sync import LazyEmbed, LazySyncConfig
    from repro_torch.core.signatures import pack_words, to_addr_i32
    from repro_torch.kernels.bloom import bloom as K

    LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
    dev = torch.device("cuda", 0)
    mcfg, cfg = get_config("qwen3_4b"), LazySyncConfig()
    emb = LazyEmbed(mcfg, cfg)
    touched = torch.from_numpy(_lazy_touched(np.random.default_rng(2), mcfg.vocab,
                                             cfg.num_groups, 1024)).to(dev)
    sigs = pack_words(emb.signatures(touched)).contiguous()
    ids = to_addr_i32(touched.reshape(-1))
    got = K.bloom_detect_conflicts(emb.spec, sigs, ids)
    want = K.bloom_detect_conflicts_plain(emb.spec, sigs, ids)
    err5 = int((got.to(torch.int64) - want).abs().max())
    check(err5 == 0, f"B5 off saturation: kernel disagrees with plain version "
                     f"(max |diff| {err5})")
    hist = torch.bincount(want.to(torch.int64), minlength=cfg.num_groups + 1).tolist()
    check(sum(1 for c in hist if c) >= 3,
          f"B5 off saturation: hit counts {hist} do not vary")
    print(f"bloom_detect_conflicts (G={cfg.num_groups}, N={ids.numel()}, vocab "
          f"{mcfg.vocab}): exact; ids by hit-group count 0..{cfg.num_groups}: "
          f"{hist}", flush=True)

    rows, base, _, _ = keep["reconcile"]
    r = rows.shape[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    valid = torch.rand((r,), generator=gen, device=dev) < 0.5
    n_valid = int(valid.sum())
    check(0 < n_valid < r, f"B6 mixed flags: {n_valid} of {r} valid")
    got = LM.lazy_merge(rows, base, valid)
    want = LM.lazy_merge_plain(rows, base, valid)
    err6 = merge_rel_err(got, want)
    check(err6 <= MERGE_RTOL, f"B6 mixed flags: kernel disagrees with plain "
                              f"version (rel {err6:.3g})")
    check(torch.equal(got[~valid], base[~valid].to(torch.float32)),
          "B6 mixed flags: an invalid row is not its base row")
    print(f"lazy_merge {tuple(rows.shape)} {rows.dtype}, {n_valid} of {r} rows "
          f"valid: max rel diff {err6:.3g}, invalid rows equal base", flush=True)
    return dict(b5=dict(G=cfg.num_groups, N=ids.numel(), vocab=mcfg.vocab,
                        hit_count_histogram=hist, max_abs_err=err5),
                b6=dict(shape=list(rows.shape), dtype=str(rows.dtype),
                        valid=n_valid, max_rel_err=err6))


def lazysync_kernel_phases(capture_tap: KernelTap, keep: dict,
                           floor_ms: float) -> dict[str, dict]:
    """B5 and B6 against their plain versions, timed, on inputs the two
    paths gave them: B5 at the capture's shape and at qwen3-4b width, B6
    at the qwen3 reconcile and commit shapes (and the capture's, printed)."""
    import torch

    from repro_torch.core.signatures import packed_tables, to_addr_i32
    from repro_torch.kernels.bloom import bloom as K

    LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
    out = {}

    def b5(label, rec, previous):
        spec, sigs, addrs, _ = rec
        sigs = sigs.contiguous()
        ids = to_addr_i32(addrs)
        got = K.bloom_detect_conflicts(spec, sigs, ids)
        want = K.bloom_detect_conflicts_plain(spec, sigs, ids)
        err = int((got.to(torch.int64) - want).abs().max())
        check(err == 0, f"{label}: kernel disagrees with plain version")
        check(K.detect_route(spec) == "transposed", f"{label}: not the transposed route")
        g, nw = sigs.shape
        n = ids.numel()
        m, s = spec.num_segments, spec.num_byte_slices
        # each address in and its count out, the signatures and the packed
        # table read once; the hash, one mask lookup a segment and a
        # popcount an address, and the G x sig_bits mask bits built once
        st = measure(f"{label} (G={g}, N={n})", err,
                     lambda sg, a: K.bloom_detect_conflicts(spec, sg, a),
                     lambda sg, a: K.bloom_detect_conflicts_plain(spec, sg, a), (sigs, ids),
                     nbytes=n * 4 + n * 4 + g * nw * 4 + packed_tables(spec).nbytes,
                     ops=n * (2 * s - 1 + 4 * m + 1) + 3 * g * spec.sig_bits)
        print(f"{label}: launch floor {floor_ms:.5f} ms ({st['ms'] / floor_ms:.2f}x it); "
              f"previous design's reading {previous:.5f} ms ({PREVIOUS_CARD})", flush=True)
        return dict(st, shape=dict(G=g, N=n), launch_floor_ms=floor_ms)

    def b6(label, rec, iters=200):
        rows, base, valid, _ = rec
        got = LM.lazy_merge(rows, base, valid)
        want = LM.lazy_merge_plain(rows, base, valid)
        err = merge_rel_err(got, want)
        check(err <= MERGE_RTOL, f"{label}: kernel disagrees with plain version "
                                 f"(rel {err:.3g})")
        abs_err = float((got - want).abs().max()) if got.numel() else 0.0
        g, r, dd = rows.shape
        n_valid = int(valid.sum())
        es = rows.element_size()
        st = measure(f"{label} (G={g}, R={r}, D={dd}, {rows.dtype}, {n_valid} valid)",
                     abs_err, LM.lazy_merge, LM.lazy_merge_plain, (rows, base, valid),
                     nbytes=g * n_valid * dd * es + r * dd * es + r + r * dd * 4,
                     ops=(2 * g + 1) * n_valid * dd, iters=iters)
        return dict(st, shape=dict(G=g, R=r, D=dd, dtype=str(rows.dtype),
                                   valid=n_valid), max_rel_err=err)

    phase("LazySync kernels off saturation, qwen3-4b width")
    off = unsaturated_checks(keep)
    phase("kernel bloom_detect_conflicts")
    cap = b5("bloom_detect_conflicts, capture", capture_tap.b5[0],
             PREVIOUS_MS["bloom_detect_conflicts capture"])
    full = b5("bloom_detect_conflicts, qwen3-4b width", keep["detect"],
              PREVIOUS_MS["bloom_detect_conflicts"])
    out["bloom_detect_conflicts"] = dict(full, other_shapes=[cap],
                                         unsaturated_check=off["b5"])
    phase("kernel lazy_merge")
    cap_rec = b6("lazy_merge, capture reconcile", capture_tap.b6[0])
    commits = [r for r in capture_tap.b6 if r[2].all()]
    cap_commit = b6("lazy_merge, capture commit", commits[0]) if commits else None
    rec = b6("lazy_merge, qwen3-4b reconcile", keep["reconcile"])
    com = b6("lazy_merge, qwen3-4b commit", keep["commit"], iters=50)
    out["lazy_merge"] = dict(rec, other_shapes=[com, cap_rec]
                             + ([cap_commit] if cap_commit else []),
                             mixed_valid_check=off["b6"])
    return out


def kv_serve_path() -> tuple[dict, dict]:
    """``Study(["capture/kv_serve"])`` on both engines, each held to one run
    of the port on the CPU (the engines agree bit for bit, so one CPU run
    is the reference of both); B1–B4 must launch.  Returns (launch counts,
    wall s)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.api import MECHANISMS, Study

    t0 = time.perf_counter()
    cpu = Study([KV_APP], device="cpu").run(engine="sequential")
    cpu_wall = time.perf_counter() - t0
    counts, walls = {}, {}
    for engine in ("batch", "sequential"):
        phase(f"capture/kv_serve, engine={engine}")
        torch.cuda.synchronize()
        KS.reset_launch_counts()
        study = Study([KV_APP])
        t0 = time.perf_counter()
        rs = study.run(engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        counts[engine] = launch_counts()
        for name in FIG7_KERNELS:
            check(counts[engine][name] > 0,
                  f"kv_serve/{engine}: kernel {name} was never launched")
        check_query_launches(f"kv_serve/{engine}", study, rs, engine, counts[engine])
        check_insert_launches(f"kv_serve/{engine}", study, rs, engine, counts[engine])
        check_intersect_launches(f"kv_serve/{engine}", study, rs, engine, counts[engine])
        worst = compare_results(rs, cpu, f"kv_serve/{engine}")
        print(f"{engine}: {KV_APP} x {len(MECHANISMS)} mechanisms in "
              f"{walls[engine]:.2f} s wall; launches {counts[engine]}; equals the "
              f"port's CPU run ({cpu_wall:.2f} s) on every field (worst rel gap "
              f"{worst:.3g})", flush=True)
    return counts, walls


def fa_excess(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (rtol |want| + row_tol
    rms(want row))), the pair ``FA_TOL`` gives ``want``'s dtype: the second
    is <= 1 when the kernel is within tolerance.  An exact match counts 0
    (a fully masked row is 0 in both)."""
    import torch

    rtol, row_tol = FA_TOL[str(want.dtype).removeprefix("torch.")]
    got, want = got.to(torch.float32), want.to(torch.float32)
    diff = (got - want).abs()
    allowed = rtol * want.abs() + row_tol * want.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = torch.where(diff == 0, 0.0, diff / allowed)
    return float(diff.max()), float(ratio.max())


class FlashTap:
    """While active, records every ``ops.mha`` call the model zoo makes —
    inputs and result — by wrapping the name :mod:`repro_torch.models.
    attention` calls; the wrapped call launches exactly what it would have.
    :meth:`check` then holds each result against the kernel's plain version
    on the same inputs (no launch of the kernel, so nothing counted)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self._ops, self._orig = ops, ops.mha

        def tapped(q, k, v, *, causal=True, window=0):
            out = self._orig(q, k, v, causal=causal, window=window)
            self.calls.append((q, k, v, causal, window, out))
            return out

        ops.mha = tapped
        return self

    def __exit__(self, *exc):
        self._ops.mha = self._orig
        return False

    def check(self, label: str) -> tuple[float, float]:
        """Hold every tapped call to its plain version; returns the largest
        |diff| and the largest ``fa_excess`` over the calls."""
        FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
        err = excess = 0.0
        for i, (q, k, v, causal, window, out) in enumerate(self.calls):
            want = FA.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                            causal=causal, window=window)
            e, x = fa_excess(out, want)
            err, excess = max(err, e), max(excess, x)
            check(x <= 1.0, f"{label}: flash_attention call {i} disagrees with its "
                            f"plain version (max |diff| {e:.4g}, {x:.3g} of the "
                            f"tolerance)")
        return err, excess


def prefill_path() -> tuple[dict, dict, dict, tuple]:
    """qwen3-4b at full width and depth on the card: three prefill steps of
    4 x 4,096 tokens (counted and tapped; unprofiled; profiled).  Returns
    (summary, launch counts of the counted run, params, layer 0's B7
    inputs)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    phase("qwen3-4b prefill")
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3_4b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads / {cfg.num_kv_heads} kv heads x {cfg.head_dim}, vocab {cfg.vocab}; "
          f"{n_params} parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated) initialised in {time.perf_counter() - t0:.2f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()

    tap = FlashTap()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    tapped_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_sm90"] == cfg.num_layers
          and counts["flash_attention_general"] == 0,
          f"prefill: {counts['flash_attention_sm90']} flash_attention launches on the sm90 "
          f"route and {counts['flash_attention_general']} on the general one, want exactly "
          f"{cfg.num_layers} (one per layer), all sm90 (bf16, D = {cfg.head_dim})")
    check(len(tap.calls) == cfg.num_layers, f"prefill: {len(tap.calls)} ops.mha calls")
    check(tuple(last.shape) == (PREFILL_BATCH, cfg.vocab) and
          bool(last.to(torch.float32).isfinite().all()),
          f"prefill: last-position logits {tuple(last.shape)} not finite")
    err, excess = tap.check("prefill")
    q, k, v, _, _, _ = tap.calls[0]
    layer0 = (q, k, v)
    print(f"prefill (counted): {tapped_wall:.3f} s wall; launches {counts}; all "
          f"{len(tap.calls)} flash_attention calls (sm90 route) within tolerance of their plain "
          f"versions (max |diff| {err:.4g}, at most {excess:.3g} of the tolerance)",
          flush=True)
    del tap, last
    gc.collect()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = step(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy, _, top = device_busy_s(lambda: step(params, batch))
    for t, c, name in top:
        print(f"  {t:9.4f} s {c:5d}x  {name[:100]}")
    tokens_per_s = PREFILL_BATCH * PREFILL_LEN / wall
    print(f"prefill: {wall:.4f} s wall ({tokens_per_s:.0f} tokens/s); device busy "
          f"{busy:.4f} s (idle share {1.0 - busy / wall:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 2 / 2**30:.2f} GiB of weights "
          f"included)", flush=True)
    summary = dict(batch=PREFILL_BATCH, seq=PREFILL_LEN, layers=cfg.num_layers,
                   params=n_params, wall_s=wall, counted_wall_s=tapped_wall,
                   tokens_per_s=tokens_per_s, device_busy_s=busy,
                   idle_share=1.0 - busy / wall, peak_mem_bytes=peak,
                   flash_calls=cfg.num_layers, flash_max_abs_err=err,
                   flash_max_tolerance_share=excess,
                   top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top])
    return summary, counts, params, layer0


def flash_kernel_phase(layer0: tuple) -> dict[str, dict]:
    """B7 at the prefill path's shape on layer 0's inputs: the sm90 kernel
    the bf16 path takes, and the general kernel in float32 (the dtype of
    the float32 prefill, which runs it at full width) and in bfloat16
    (forced): each against its plain version, timed, with its bound in
    operations (bf16 at the tensor-core rate, float32 at the FFMA rate:
    no TF32) and one ``scaled_dot_product_attention`` call on the same
    inputs as yardstick (float32 with TF32 off).  Returns the stats by
    kernel name; the general kernel's record is its forced bf16 timing, as
    before the float32 path existed, with the float32 one as ``float32``."""
    import torch
    import torch.nn.functional as F

    FA = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    phase("kernel flash_attention (sm90 bf16; general float32 and bf16)")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 attention")
    bf = tuple(t.contiguous() for t in layer0)
    b, s, hq, d = bf[0].shape
    hkv = bf[1].shape[2]
    check(FA._route_for(bf[0].dtype, d) == "sm90", f"layer 0's B7 call ({bf[0].dtype}, "
                                                   f"D = {d}) does not take the sm90 route")
    useful = 4 * d * (s * (s + 1) // 2) * b * hq  # QK^T and PV over the causal triangle
    runs = {}
    for label, route, dtype, iters, peak in (
            ("sm90", "sm90", torch.bfloat16, 200, PEAK_BF16_FLOP_PER_S),
            ("general", "general", torch.float32, 20, PEAK_OPS_PER_S),
            ("general bf16", "general", torch.bfloat16, 50, PEAK_BF16_FLOP_PER_S)):
        q, k, v = bf if dtype == torch.bfloat16 else tuple(t.to(dtype) for t in bf)
        name = FA_ROUTE_KERNEL[route]
        tname = str(dtype).removeprefix("torch.")
        want = FA.flash_attention_plain(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).to(torch.float32)
                         - want.to(torch.float32)).abs().max())
        del lib
        got = FA._flash_attention(q, k, v, causal=True, route=route)
        err, excess = fa_excess(got, want)
        del got, want
        check(excess <= 1.0, f"{name} {tname}: kernel disagrees with plain version (max "
                             f"|diff| {err:.4g}, {excess:.3g} of the tolerance)")
        print(f"{name} ({route} route) q {tuple(q.shape)} k/v {tuple(k.shape)} {tname} "
              f"causal: max |kernel - plain| {err:.4g} ({excess:.3g} of the tolerance); "
              f"SDPA against plain {lib_err:.4g}", flush=True)
        st = measure(f"{name} (B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, {tname}, causal)",
                     err, lambda *a, r=route: FA._flash_attention(*a, causal=True, route=r),
                     lambda *a: FA.flash_attention_plain(*a, causal=True), (q, k, v),
                     nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(), ops=useful,
                     iters=iters, plain_iters=3, ops_per_s=peak,
                     library=lambda *a: F.scaled_dot_product_attention(
                         *a, is_causal=True, enable_gqa=True),
                     library_args=(qt, kt, vt))
        runs[label] = dict(st, shape=dict(B=b, S=s, Hq=hq, Hkv=hkv, D=d, dtype=tname,
                                          causal=True), b7_route=route, useful_flop=useful,
                           tolerance_share=excess,
                           library_call="torch.nn.functional.scaled_dot_product_attention"
                                        "(is_causal=True, enable_gqa=True)",
                           library_max_abs_diff_vs_plain=lib_err)
        del q, k, v, qt, kt, vt
        gc.collect()
        torch.cuda.empty_cache()
    sm90, general, general_bf16 = runs["sm90"], runs["general"], runs["general bf16"]
    sm90["kernel_attributes"] = FA.sm90_attributes(d)
    general["kernel_attributes"] = FA.general_attributes(torch.float32, d)
    general_bf16["kernel_attributes"] = FA.general_attributes(torch.bfloat16, d)
    print(f"flash_attention bf16: sm90 route {sm90['ms']:.5f} ms, general route "
          f"{general_bf16['ms']:.5f} ms ({general_bf16['ms'] / sm90['ms']:.2f}x), SDPA "
          f"{sm90['library_ms']:.5f} ms, bound {sm90['bound_ms']:.5f} ms; float32: general "
          f"route {general['ms']:.5f} ms, SDPA {general['library_ms']:.5f} ms, bound "
          f"{general['bound_ms']:.5f} ms (FFMA, {general['bound_ms'] / general['ms']:.3f} "
          f"of it reached)", flush=True)
    return {"flash_attention_sm90": sm90,
            "flash_attention_general": dict(general_bf16, float32=general)}


def prefill_f32_path(params: dict) -> tuple[dict, dict]:
    """qwen3-4b at full width and depth in float32 on the card: ``params``
    (the float32 cast of the bf16 phases' weights, ~16 GB) through
    ``make_prefill_step`` on 1 x 4,096 seeded tokens, with TF32 off;
    counted and tapped (exactly 36 B7 launches, all on the general route,
    each held to its plain version at ``FA_TOL``'s float32 pair),
    unprofiled (wall time, peak memory) and profiled (idle share, top
    kernels, B7's share of device time).  Returns (summary, launch counts
    of the counted run)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import Model

    phase("qwen3-4b prefill, float32 (general B7 route, full width)")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the float32 prefill")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3_4b"), param_dtype=torch.float32)
    model = Model(cfg)
    check(all(t.dtype == torch.float32 for t in tree_leaves(params)),
          "prefill f32: weights not float32")
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    step(params, {"tokens": tokens[:, :256]})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()

    tap = FlashTap()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    with tap:
        last = step(params, batch)
    torch.cuda.synchronize()
    tapped_wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_general"] == cfg.num_layers
          and counts["flash_attention_sm90"] == 0,
          f"prefill f32: {counts['flash_attention_general']} general and "
          f"{counts['flash_attention_sm90']} sm90 B7 launches, want exactly "
          f"{cfg.num_layers} general (one per layer)")
    check(len(tap.calls) == cfg.num_layers, f"prefill f32: {len(tap.calls)} ops.mha calls")
    check(tuple(last.shape) == (1, cfg.vocab) and last.dtype == torch.float32
          and bool(last.isfinite().all()),
          f"prefill f32: last-position logits {last.dtype}{tuple(last.shape)} not finite")
    err, excess = tap.check("prefill f32")
    print(f"prefill f32 (counted): {tapped_wall:.3f} s wall; launches {counts}; all "
          f"{len(tap.calls)} flash_attention calls (general route) within tolerance of "
          f"their plain versions (max |diff| {err:.4g}, at most {excess:.3g} of the "
          f"tolerance)", flush=True)
    del tap, last
    gc.collect()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy, n_kernels, by_name = device_busy_s(lambda: step(params, batch), top=None)
    for t, c, name in by_name[:8]:
        print(f"  {t:9.4f} s {c:5d}x  {name[:100]}")
    b7_s = sum(t for t, _, name in by_name if "flash_attention" in name)
    tokens_per_s = PREFILL_LEN / wall
    n_params = model.param_count()
    print(f"prefill f32: {wall:.4f} s wall ({tokens_per_s:.0f} tokens/s); device busy "
          f"{busy:.4f} s in {n_kernels} kernels (idle share {1.0 - busy / wall:.3f}), B7 "
          f"{b7_s:.4f} s of it ({b7_s / busy:.3f}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB (the {n_params * 4 / 2**30:.2f} GiB of weights "
          f"included)", flush=True)
    return dict(batch=1, seq=PREFILL_LEN, layers=cfg.num_layers, dtype="float32",
                wall_s=wall, counted_wall_s=tapped_wall, tokens_per_s=tokens_per_s,
                device_busy_s=busy, idle_share=1.0 - busy / wall, kernels=n_kernels,
                flash_device_s=b7_s, flash_share=b7_s / busy, peak_mem_bytes=peak,
                flash_calls=cfg.num_layers, flash_max_abs_err=err,
                flash_max_tolerance_share=excess,
                top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in by_name[:8]]), counts


def smoke_prefill_path() -> dict[str, int]:
    """The general B7 route on a path of its own: the qwen3-4b smoke config
    (2 layers, D = 16) in float32 through ``make_prefill_step`` on the card,
    counted (one general launch a layer, none on the sm90 route) and tapped
    (each call held to the plain version at ``FA_TOL``'s float32 pair), its
    last-position logits held to the CPU run's."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model

    phase("qwen3-4b smoke prefill, float32 (general B7 route)")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), param_dtype=torch.float32)
    model = Model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, SMOKE_PREFILL_LEN),
                         generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(model)
    tap = FlashTap()
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    with tap:
        got = step(gpu, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["flash_attention_general"] == cfg.num_layers
          and counts["flash_attention_sm90"] == 0,
          f"smoke prefill: {counts['flash_attention_general']} general and "
          f"{counts['flash_attention_sm90']} sm90 B7 launches, want {cfg.num_layers} general")
    check(len(tap.calls) == cfg.num_layers, f"smoke prefill: {len(tap.calls)} ops.mha calls")
    err, excess = tap.check("smoke prefill")
    want = step(cpu, {"tokens": toks})
    diff = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)),
          f"smoke prefill: card logits differ from the CPU run's by {diff:.3g}")
    print(f"smoke prefill (float32, {cfg.num_layers} layers, D = {cfg.head_dim}, 2 x "
          f"{SMOKE_PREFILL_LEN} tokens): launches {counts}; all {len(tap.calls)} "
          f"flash_attention calls (general route) within tolerance of their plain versions "
          f"(max |diff| {err:.4g}, at most {excess:.3g} of the tolerance); last-position "
          f"logits equal the CPU run's within 1e-4 (max |diff| {diff:.3g})", flush=True)
    return counts


def serve_path(params: dict) -> tuple[dict, dict]:
    """The port's serve loop at full width with the reference loop's
    defaults on ``params``; then one teacher-forced 64-token prompt through
    decode against the full forward.  Returns (summary, launch counts of
    the serve run)."""
    import torch

    from repro_torch import kernels as KS
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import Model

    phase("qwen3-4b serve")
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3_4b")
    model = Model(cfg)
    args = argparse.Namespace(device=str(dev), **SERVE_ARGS)
    torch.cuda.synchronize()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    served = serve(args, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(len(served) == SERVE_ARGS["requests"],
          f"serve: {len(served)} of {SERVE_ARGS['requests']} requests served")
    check(sorted(r.rid for r in served) == list(range(SERVE_ARGS["requests"])),
          "serve: request ids")
    for r in served:
        check(r.done and len(r.out) > len(r.prompt)
              and all(0 <= t < cfg.vocab_size for t in r.out),
              f"serve: request {r.rid} out of range or unfinished")
    total = sum(len(r.out) for r in served)
    new = sum(len(r.out) - len(r.prompt) for r in served)
    print(f"serve: {len(served)} requests, {total} tokens ({new} generated) in "
          f"{wall:.3f} s wall: {total / wall:.1f} tokens/s ({new / wall:.1f} "
          f"generated/s); launches {counts}", flush=True)

    # the decode step's idle share: 8 steps at the serve loop's batch, timed
    # unprofiled and then under the profiler from the same cache
    tok = torch.zeros((SERVE_ARGS["batch"], 1), dtype=torch.int64, device=dev)
    cache0 = model.init_cache(SERVE_ARGS["batch"], SERVE_ARGS["max_len"], dev)

    def decode_window():
        c = cache0
        for _ in range(8):
            _, c = model.decode(params, tok, c)
        torch.cuda.synchronize()

    decode_window()
    t0 = time.perf_counter()
    decode_window()
    step_wall = (time.perf_counter() - t0) / 8
    busy, n_kernels, top = device_busy_s(decode_window)
    for t, c, name in top:
        print(f"  {t:9.4f} s {c:5d}x  {name[:100]}")
    decode_idle = 1.0 - busy / 8 / step_wall
    print(f"decode step (batch {SERVE_ARGS['batch']}, {cfg.num_layers} layers): "
          f"{step_wall * 1e3:.3f} ms wall, {busy / 8 * 1e3:.3f} ms device busy in "
          f"{n_kernels / 8:.0f} kernels (idle share {decode_idle:.3f})", flush=True)

    phase("qwen3-4b decode against prefill (teacher-forced)")
    prompt = torch.randint(0, cfg.vocab_size, (1, TEACHER_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    full, _ = model.apply(params, prompt)
    last = make_prefill_step(model)(params, {"tokens": prompt})
    cache = model.init_cache(1, TEACHER_LEN, dev)
    steps = []
    for i in range(TEACHER_LEN):
        logits, cache = model.decode(params, prompt[:, i:i + 1], cache)
        steps.append(logits[:, 0])
    dec = torch.stack(steps, dim=1).to(torch.float32)
    full = full.to(torch.float32)
    check(bool(dec.isfinite().all()) and bool(full.isfinite().all()),
          "teacher-forced decode: non-finite logits")
    agree = float((dec.argmax(-1) == full.argmax(-1)).to(torch.float32).mean())
    max_d = float((dec - full).abs().max())
    last_d = float((dec[:, -1] - last.to(torch.float32)).abs().max())
    last_agree = bool(dec[0, -1].argmax() == last[0].argmax())
    print(f"teacher-forced {TEACHER_LEN}-token prompt, bf16, {cfg.num_layers} layers: "
          f"decode vs full forward top-1 agreement {agree:.4f} over {TEACHER_LEN} positions, max "
          f"|diff| {max_d:.4g}; last position vs the prefill step: top-1 equal "
          f"{last_agree}, max |diff| {last_d:.4g} (recorded, not gated)", flush=True)
    summary = dict(requests=len(served), tokens=total, generated=new, wall_s=wall,
                   tokens_per_s=total / wall, generated_per_s=new / wall,
                   decode_step_wall_s=step_wall, decode_step_busy_s=busy / 8,
                   decode_idle_share=decode_idle, decode_step_kernels=n_kernels / 8,
                   decode_top=[dict(kernel=k[:80], s=t, count=c) for t, c, k in top],
                   teacher_forced=dict(len=TEACHER_LEN, top1_agreement=agree,
                                       max_abs_diff=max_d, last_top1_equal=last_agree,
                                       last_max_abs_diff=last_d))
    return summary, counts


def main() -> int:
    try:
        card = environment()
        K = build()
        import torch

        from repro_torch.models.common import tree_map

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
        floor_ms = launch_floor_ms()
        stats = kernel_phases(K, floor_ms)
        counts, walls, sequential = main_path(K)
        profile = main_path_profile(walls["batch"])
        fig7x_counts, fig7x_walls = extended_fleet_path(sequential, card)
        service_summary, service_counts = study_service_path(sequential.points, card)
        caps_counts = signature_caps_phase(K, importlib.import_module(
            "repro_torch.kernels.bloom.onehot"))
        seed_counts, seed, seed_tap = seed_path(sequential)
        stats.update(onehot_kernel_phases(seed_tap, floor_ms))
        del seed_tap, sequential
        signatures = signatures_phase(K, card)
        cap_counts, cap_walls, cap_tap = capture_path()
        lazy = lazysync_path()
        keep = lazy.pop("keep")
        stats.update(lazysync_kernel_phases(cap_tap, keep, floor_ms))
        del keep, cap_tap
        gc.collect()
        torch.cuda.empty_cache()
        kv_counts, kv_walls = kv_serve_path()
        prefill, prefill_counts, params, layer0 = prefill_path()
        stats.update(flash_kernel_phase(layer0))
        del layer0
        gc.collect()
        torch.cuda.empty_cache()
        serving, serve_counts = serve_path(params)
        # the bf16 weights are dropped once cast: the float32 phase holds ~16 GB
        params = tree_map(lambda t: t.to(torch.float32), params)
        gc.collect()
        torch.cuda.empty_cache()
        prefill32, prefill32_counts = prefill_f32_path(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        smoke_counts = smoke_prefill_path()
        for name in ("h3_hash", "bloom_query", "bloom_query_onehot", "bloom_insert",
                     "bloom_insert_onehot", "bloom_intersect"):
            stats[name]["launch_floor_ms"] = floor_ms
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    by_path = {"fig7_batch": counts["batch"], "fig7_sequential": counts["sequential"],
               "fig7x_batch": fig7x_counts["batch"],
               "fig7x_sequential": fig7x_counts["sequential"],
               **service_counts,
               **{f"m64_study_{k}": c for k, c in caps_counts.items()},
               "seed_fig7": seed_counts,
               "capture_batch": cap_counts["batch"],
               "capture_sequential": cap_counts["sequential"],
               "qwen3_lazysync": lazy["launches"],
               "kv_serve_batch": kv_counts["batch"],
               "kv_serve_sequential": kv_counts["sequential"],
               "qwen3_prefill": prefill_counts, "qwen3_serve": serve_counts,
               "qwen3_prefill_f32": prefill32_counts,
               "smoke_prefill_f32": smoke_counts}
    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=TPU_KERNEL[name],
                    launches=sum(c[name] for c in by_path.values()),
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    **stats[name]) for name in TPU_KERNEL]
    print(json.dumps({"profile": profile, "fig7_wall_s": walls,
                      "fig7x_wall_s": fig7x_walls, "study_service": service_summary,
                      "seed_fig7": seed,
                      "signatures": signatures,
                      "capture_wall_s": cap_walls, "lazysync": lazy,
                      "kv_serve_wall_s": kv_walls, "qwen3_prefill": prefill,
                      "qwen3_serve": serving, "qwen3_prefill_f32": prefill32}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
