"""Counter-based trace synthesis on the chosen device (PyTorch port of
:mod:`repro.sim.synth`).

Every random value is a pure function of a (stream key, counter) pair
hashed through Threefry-2x32, so a whole trace is one tensor program that
runs on the device, as the reference's runs under ``jit``.  The keys come
from the same audited CRC-32 / Weyl rule (:func:`derive_key`) and the
counters index the same draws, so the port regenerates the reference's
traces bit for bit.

**Unsigned arithmetic.**  torch has no usable ``uint32`` on the CPU, so
the Threefry rounds and ``counter_mod`` run in ``int64`` with
``& 0xFFFFFFFF`` after every add and left shift — the exact uint32 result
— and id arithmetic runs in ``int64`` before the final ``int32`` cast.

Every synthesized family is here: the paper's (Ligra graph apps, HTAP
IMDB) and the extended ones (BFS/SSSP frontier kernels, streaming-ingest
HTAP, the two-tenant mix).  The sequential numpy reference of the same
families is :mod:`repro_torch.sim._traceref`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim import graphs as G

MAX_SIG_ADDRS = 250
AR = 256  # PIM read slots per window
AW = 256  # PIM write slots per window
BR = 64   # CPU->PIM-region read slots per window
BW = 64   # CPU->PIM-region write slots per window

VPL = 64 // G.VERTEX_VALUE_BYTES  # vertices per line
EPL = 64 // G.EDGE_BYTES          # edges per line

U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Counter-based PRNG core (Threefry-2x32)
# ---------------------------------------------------------------------------

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def threefry2x32(k0: int, k1: int, c0: torch.Tensor,
                 c1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds.  ``k0``/``k1`` are uint32 key values (Python
    ints), ``c0``/``c1`` int64 counter tensors holding uint32 values; returns
    the two output words as int64 tensors in [0, 2**32)."""
    k0, k1 = int(k0) & U32, int(k1) & U32
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = (c0 + k0) & U32
    x1 = (c1 + k1) & U32
    for d in range(5):
        for r in _ROT_A if d % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & U32
            x1 = ((x1 << r) & U32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & U32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & U32
    return x0, x1


def counter_bits(key, ctr: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (as int64) for each counter under stream ``key``."""
    ctr = ctr.to(torch.int64) & U32
    x0, _ = threefry2x32(key[0], key[1], ctr, torch.zeros_like(ctr))
    return x0


def counter_u01(key, ctr: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1): top 24 bits scaled (exact in float32)."""
    return (counter_bits(key, ctr) >> 8).to(torch.float32) * (2.0 ** -24)


def counter_mod(key, ctr: torch.Tensor, bound) -> torch.Tensor:
    """int64 uniform in [0, bound) via modulo (``bound`` a scalar or a
    per-counter tensor)."""
    if not isinstance(bound, torch.Tensor):
        bound = int(bound) & U32
    return counter_bits(key, ctr) % bound


def derive_key(app: str, graph_name: str | None, seed: int,
               stream: str) -> tuple[int, int]:
    """The reference's seed-mixing rule: key0 is the CRC-32 of the
    workload/stream label, key1 a Weyl-mixed seed."""
    label = f"{app}/{graph_name or ''}/{stream}"
    k0 = zlib.crc32(label.encode()) & U32
    k1 = (seed * 2654435761 + 0x9E3779B9) & U32
    return k0, k1


def derive_keys(app: str, graph_name: str | None, seed: int,
                streams: tuple[str, ...]) -> np.ndarray:
    """(S, 2) uint32 key table, one row per named stream (fixed order)."""
    return np.asarray([derive_key(app, graph_name, seed, s) for s in streams],
                      dtype=np.uint32).reshape(len(streams), 2)


def _f32(x: float) -> float:
    """The float32 rounding of ``x`` (as the reference's ``np.float32``)."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Line layout + instruction-count formulas
# ---------------------------------------------------------------------------


def vline(base: int, v):
    """Vertex-array cache line (8 values per 64 B line)."""
    return base + v // VPL


def fline(base: int, v):
    """Frontier bitmap cache line (1 B per flag)."""
    return base + v // 64


def eline(base: int, e):
    """CSR edge-array cache line (8 edges per line)."""
    return base + e // EPL


def tline(plan, table, tup, fld):
    """Tuple-field cache line of a (table, tuple, field) triple."""
    return (table * plan.tuples + tup) * plan.tuple_lines + fld


def gtline(plan, gidx, fld):
    """Tuple-field cache line of a global tuple index in the append ring
    (streaming family: the tables are contiguous, so the ring is linear)."""
    return gidx * plan.tuple_lines + fld


def instr_counts(plan, n_pim_acc: torch.Tensor, n_cpu_acc: torch.Tensor):
    """(pim_instr, cpu_instr, cpu_priv) float32, the reference's expression
    and rounding order."""
    pim = n_pim_acc.to(torch.float32) * _f32(plan.pim_ipw)
    cpu = (n_cpu_acc.to(torch.float32) * _f32(plan.cpu_reuse)
           * _f32(plan.cpu_ipw) + _f32(plan.threads * plan.cpu_serial_instr))
    priv = torch.full(n_pim_acc.shape, _f32(plan.threads * plan.priv_apw),
                      dtype=torch.float32, device=n_pim_acc.device)
    return pim, cpu, priv


# ---------------------------------------------------------------------------
# Plans: static geometry computed host-side
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """Seed graph family (Ligra edgeMap: pagerank / radii / components)."""

    app: str
    graph_name: str
    threads: int
    num_kernels: int
    wpk: int
    n: int
    E: int
    p_next_base: int
    frontier_base: int
    edge_base: int
    total_lines: int
    hi: tuple[int, ...]
    epw: int
    raw_int: int
    raw_frac: float
    raw_max: int
    hot_bias: float
    writes_src: bool
    pool_n: int = 600
    reads_n: int = 44
    bk_n: int = 4
    cpu_reuse: float = 6.0
    pim_ipw: float = 3.0
    cpu_ipw: float = 6.0
    cpu_serial_instr: float = 420.0
    priv_apw: float = 160.0
    cpu_priv_miss_rate: float = 0.002

    STREAMS = ("e0", "bk", "pool", "rawn", "rawhot", "rawhotv", "rawuni",
               "safe", "crs")

    @property
    def num_windows(self) -> int:
        return self.num_kernels * self.wpk


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """BFS/SSSP frontier family: bursty frontier-sized windows."""

    app: str
    graph_name: str
    threads: int
    num_kernels: int
    wpk: int
    n: int
    E: int
    p_next_base: int
    frontier_base: int
    edge_base: int
    total_lines: int
    epw: tuple[int, ...]       # per-kernel (level) edges a window: bursty
    epw_max: int
    relax_rate: float          # fraction of edges producing a dist write
    qraw_rate: float           # host-side relaxation (RAW) writes a window
    pool_n: int = 600
    reads_n: int = 36
    bk_n: int = 6
    cpu_reuse: float = 6.0
    pim_ipw: float = 2.5
    cpu_ipw: float = 6.0
    cpu_serial_instr: float = 380.0
    priv_apw: float = 150.0
    cpu_priv_miss_rate: float = 0.002

    STREAMS = ("f0", "relax", "qsafe", "qraw", "qrawv", "pool", "crs", "bk")

    @property
    def num_windows(self) -> int:
        return self.num_kernels * self.wpk


@dataclasses.dataclass(frozen=True)
class HtapPlan:
    """Seed HTAP family (analytics on PIM, transactions on CPU)."""

    app: str
    threads: int
    num_kernels: int
    wpk: int
    tables: int
    tuples: int
    tuple_lines: int
    hash_base: int
    hash_lines: int
    total_lines: int
    n_scan: int
    n_probe: int
    n_wr: int
    intensity: float
    txn_writes: int = 2
    txn_hot: int = 1
    txn_reads: int = 26
    burst_n: int = 8
    burst_hot: int = 3
    pool_n: int = 500
    cpu_reuse: float = 6.0
    cpu_ipw: float = 12.0
    cpu_serial_instr: float = 500.0
    priv_apw: float = 220.0
    cpu_priv_miss_rate: float = 0.0015

    STREAMS = ("tbl", "cur", "btab", "btup", "bfld", "probe", "wrh",
               "twtab", "twtup", "twfld", "ptab", "ptup", "pfld", "txr")

    @property
    def pim_ipw(self) -> float:
        return 2.5 + 1.5 * self.intensity

    @property
    def num_windows(self) -> int:
        return self.num_kernels * self.wpk


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Streaming-ingest HTAP: appends at a moving tail, analytics scanning
    the recently ingested region (hot-tail RAW and dirty-line pressure)."""

    app: str
    threads: int
    num_kernels: int
    wpk: int
    tables: int
    tuples: int
    tuple_lines: int
    hash_base: int
    hash_lines: int
    total_lines: int
    total_tuples: int          # ring size (tables * tuples)
    apw: int = 6               # appended tuples a window (the hot tail)
    lag: int = 96              # analytics scan the tuples appended lag ago
    n_scan: int = 40
    n_probe: int = 10
    n_wr: int = 24
    idx_writes: int = 2        # txn index-maintenance writes (hash area)
    txn_reads: int = 24
    recent: int = 512          # hot read window behind the tail
    burst_n: int = 8
    cpu_reuse: float = 8.0
    pim_ipw: float = 4.0
    cpu_ipw: float = 12.0
    cpu_serial_instr: float = 500.0
    priv_apw: float = 220.0
    cpu_priv_miss_rate: float = 0.0015

    STREAMS = ("probe", "wrh", "idxw", "txr", "burst")

    @property
    def num_windows(self) -> int:
        return self.num_kernels * self.wpk


@dataclasses.dataclass(frozen=True)
class MTPlan:
    """Multi-tenant mix: two tenants' kernels alternate over one shared PIM
    region (shared CSR edges, private vertex arrays); both tenants' threads
    write every window, so the CPUWriteSet carries cross-kernel pressure."""

    app: str
    graph_name: str
    threads: int
    num_kernels: int
    wpk: int
    n: int
    E: int
    a_pc: int                  # tenant A (pagerank-like) bases
    a_pn: int
    a_fr: int
    b_pc: int                  # tenant B (label-propagation-like) bases
    b_pn: int
    b_fr: int
    edge_base: int
    total_lines: int
    hi_a: tuple[int, ...]      # per-A-kernel e0 bounds
    hi_b: tuple[int, ...]
    epw: int = 60
    a_raw_frac: float = 0.5    # A: 0/1 uniform RAW writes a window
    b_raw_int: int = 0         # B: 0/1 hot RAW writes a window
    b_raw_frac: float = 0.7
    b_hot_bias: float = 0.5
    pool_n: int = 600
    reads_n: int = 40          # 20 a tenant
    bk_n: int = 4
    cpu_reuse: float = 6.0
    pim_ipw: float = 3.0
    cpu_ipw: float = 6.0
    cpu_serial_instr: float = 460.0
    priv_apw: float = 200.0
    cpu_priv_miss_rate: float = 0.002

    STREAMS = ("e0A", "e0B", "bkA", "bkB", "poolA", "poolB", "rawnA",
               "rawuniA", "safeA", "rawnB", "rawhotB", "rawhotvB", "rawuniB",
               "safeB", "crsA", "crsB")

    @property
    def num_windows(self) -> int:
        return self.num_kernels * self.wpk


# (raw_write_rate per window, hot_bias) of the seed graph family.
APP_CPU_WRITES = {
    "pagerank": (0.35, 0.0),
    "radii": (0.6, 0.35),
    "components": (1.5, 0.85),
}


# (peak edges/window, level-peak position, level width, relax, qraw)
FRONTIER_PARAMS = {
    "bfs": (110, 0.30, 0.20, 0.45, 0.25),
    "sssp": (90, 0.38, 0.33, 0.70, 0.90),
}


def build_graph_plan(app, graph_name, threads=16, num_kernels=24, wpk=3,
                     seed=0, scale=1.0, cpu_reuse=6.0):
    g = G.make_graph(graph_name, seed=seed, scale=scale)
    lay = G.layout_for_graph(g)
    raw_w, hot_bias = APP_CPU_WRITES[app]
    frontier_frac = {"pagerank": 1.0, "radii": 0.45, "components": 0.6}[app]
    hi = tuple(
        max(1, g.num_edges - max(64, int(g.num_edges * frontier_frac ** (k % 6))))
        for k in range(num_kernels))
    raw_int = int(raw_w)
    raw_frac = raw_w - raw_int
    plan = GraphPlan(
        app=app, graph_name=graph_name, threads=threads,
        num_kernels=num_kernels, wpk=wpk, n=g.num_nodes, E=g.num_edges,
        p_next_base=lay.p_next_base, frontier_base=lay.frontier_base,
        edge_base=lay.edge_base, total_lines=lay.total_lines,
        hi=hi, epw=60, raw_int=raw_int, raw_frac=raw_frac,
        raw_max=raw_int + (1 if raw_frac > 0 else 0), hot_bias=hot_bias,
        writes_src=(app == "pagerank"), cpu_reuse=cpu_reuse)
    return plan, g.edges


def build_frontier_plan(app, graph_name, threads=16, num_kernels=24, wpk=3,
                        seed=0, scale=1.0, cpu_reuse=6.0):
    g = G.make_graph(graph_name, seed=seed, scale=scale)
    lay = G.layout_for_graph(g)
    peak_epw, peak_pos, width, relax, qraw = FRONTIER_PARAMS[app]
    # BFS-level bell: tiny frontiers at the root and the fringe, a burst of
    # frontier-sized windows around the peak level
    epw = tuple(
        max(6, int(peak_epw * math.exp(
            -0.5 * ((k - peak_pos * num_kernels) / (width * num_kernels)) ** 2)))
        for k in range(num_kernels))
    plan = FrontierPlan(
        app=app, graph_name=graph_name, threads=threads,
        num_kernels=num_kernels, wpk=wpk, n=g.num_nodes, E=g.num_edges,
        p_next_base=lay.p_next_base, frontier_base=lay.frontier_base,
        edge_base=lay.edge_base, total_lines=lay.total_lines,
        epw=epw, epw_max=max(epw), relax_rate=relax, qraw_rate=qraw,
        cpu_reuse=cpu_reuse)
    return plan, g.edges


def build_htap_plan(app, threads=16, num_kernels=24, wpk=3, seed=0,
                    scale=0.01, cpu_reuse=6.0):
    n_queries = int(app.replace("htap", ""))
    lay = G.make_imdb_layout(scale=scale)
    tuples = int(G.IMDB_SHAPE["tuples_per_table"] * scale)
    if lay.table_lines != tuples * lay.tuple_lines:
        raise ValueError(f"scale={scale}: tables are not packed back-to-back")
    intensity = n_queries / 128.0
    return HtapPlan(
        app=app, threads=threads, num_kernels=num_kernels, wpk=wpk,
        tables=lay.tables, tuples=tuples, tuple_lines=lay.tuple_lines,
        hash_base=lay.hash_base, hash_lines=lay.hash_area_lines,
        total_lines=lay.total_lines, n_scan=35, n_probe=12,
        n_wr=max(8, int(40 * intensity)), intensity=intensity,
        cpu_reuse=cpu_reuse)


def build_stream_plan(app="htap_stream", threads=16, num_kernels=24, wpk=3,
                      seed=0, scale=0.01, cpu_reuse=8.0):
    lay = G.make_imdb_layout(scale=scale)
    tuples = int(G.IMDB_SHAPE["tuples_per_table"] * scale)
    if lay.table_lines != tuples * lay.tuple_lines:
        raise ValueError(f"scale={scale}: tables are not packed back-to-back")
    return StreamPlan(
        app=app, threads=threads, num_kernels=num_kernels, wpk=wpk,
        tables=lay.tables, tuples=tuples, tuple_lines=lay.tuple_lines,
        hash_base=lay.hash_base, hash_lines=lay.hash_area_lines,
        total_lines=lay.total_lines, total_tuples=lay.tables * tuples,
        cpu_reuse=cpu_reuse)


def build_mt_plan(app, graph_name, threads=16, num_kernels=24, wpk=3,
                  seed=0, scale=1.0, cpu_reuse=6.0):
    if num_kernels < 2:
        raise ValueError(f"mtmix interleaves two tenants: num_kernels must "
                         f"be >= 2, got {num_kernels}")
    g = G.make_graph(graph_name, seed=seed, scale=scale)
    lay = G.mt_layout_for_graph(g)
    ka = (num_kernels + 1) // 2   # tenant A runs the even kernels
    kb = num_kernels // 2
    hi_a = tuple(1 for _ in range(ka))  # pagerank-like: a full sweep
    hi_b = tuple(
        max(1, g.num_edges - max(64, int(g.num_edges * 0.6 ** (k % 6))))
        for k in range(kb))
    plan = MTPlan(
        app=app, graph_name=graph_name, threads=threads,
        num_kernels=num_kernels, wpk=wpk, n=g.num_nodes, E=g.num_edges,
        a_pc=lay.a_pc, a_pn=lay.a_pn, a_fr=lay.a_fr,
        b_pc=lay.b_pc, b_pn=lay.b_pn, b_fr=lay.b_fr,
        edge_base=lay.edge_base, total_lines=lay.total_lines,
        hi_a=hi_a, hi_b=hi_b, cpu_reuse=cpu_reuse)
    return plan, g.edges


# ---------------------------------------------------------------------------
# Vectorized generators
# ---------------------------------------------------------------------------


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


def _ctr2(rows: int, cols: int, dev) -> torch.Tensor:
    """(rows, cols) counters ``row * cols + col``."""
    return _arange(rows, dev)[:, None] * cols + _arange(cols, dev)


def _kernel_structure(plan, dev):
    K, wpk = plan.num_kernels, plan.wpk
    kid = torch.repeat_interleave(_arange(K, dev), wpk)
    j = _arange(K * wpk, dev) % wpk
    return kid, j, j == 0, j == wpk - 1


def _pad_cols(arr: torch.Tensor, width: int) -> torch.Tensor:
    """Pad (W, S) id columns with the -1 sentinel out to (W, width)."""
    pad = torch.full((arr.shape[0], width - arr.shape[1]), -1,
                     dtype=torch.int32, device=arr.device)
    return torch.cat([arr.to(torch.int32), pad], 1)


def _acc_counts(*arrs: torch.Tensor) -> torch.Tensor:
    return sum((a >= 0).sum(1) for a in arrs)


def _pre_writes(plan, lines: torch.Tensor) -> torch.Tensor:
    """(K, total_lines) bool with ``lines[k]`` set in row k."""
    K = plan.num_kernels
    pre = torch.zeros((K, plan.total_lines), dtype=torch.bool,
                      device=lines.device)
    pre[_arange(K, lines.device)[:, None], lines] = True
    return pre


def _finish_arrays(plan, reads, writes, cwr, crd, kid, start, end, pre):
    """Pad the slot columns to the fixed window geometry, derive the
    instruction counts, and assemble the WindowTrace field dict."""
    pim_reads = _pad_cols(reads, AR)
    pim_writes = _pad_cols(writes, AW)
    cpu_writes = _pad_cols(cwr, BW)
    cpu_reads = _pad_cols(crd, BR)
    pim_i, cpu_i, priv = instr_counts(
        plan, _acc_counts(pim_reads, pim_writes),
        _acc_counts(cpu_reads, cpu_writes))
    return dict(pim_reads=pim_reads, pim_writes=pim_writes,
                cpu_reads=cpu_reads, cpu_writes=cpu_writes,
                kernel_id=kid.to(torch.int32), kernel_start=start,
                kernel_end=end, pre_writes=pre, pim_instr=pim_i,
                cpu_instr=cpu_i, cpu_priv_accesses=priv)


def _graph_arrays(plan: GraphPlan, keys, edges: torch.Tensor) -> dict:
    """All WindowTrace tensors for the seed graph family."""
    dev = edges.device
    key = dict(zip(GraphPlan.STREAMS, keys))
    W, K, epw = plan.num_windows, plan.num_kernels, plan.epw
    kid, j, start, end = _kernel_structure(plan, dev)

    e0 = counter_mod(key["e0"], _arange(K, dev),
                     torch.tensor(plan.hi, dtype=torch.int64, device=dev))
    bk = counter_mod(key["bk"], _arange(K * plan.bk_n, dev),
                     plan.n).reshape(K, plan.bk_n)
    pre = _pre_writes(plan, torch.cat(
        [fline(plan.frontier_base, bk), vline(0, bk)], 1))

    lo = e0[kid] + j * epw
    eidx = (lo[:, None] + _arange(epw, dev)) % plan.E
    src = edges[eidx, 0]
    dst = edges[eidx, 1]
    reads = torch.zeros((W, 2 * epw), dtype=torch.int64, device=dev)
    reads[:, 0::2] = eline(plan.edge_base, eidx)
    reads[:, 1::2] = vline(0, dst)
    writes = vline(plan.p_next_base, src if plan.writes_src else dst)

    R = plan.raw_max
    rctr = _ctr2(W, R, dev)
    coin = counter_u01(key["rawn"], _arange(W, dev)) < _f32(plan.raw_frac)
    slot = _arange(R, dev)
    rvalid = (slot < plan.raw_int) | ((slot == plan.raw_int) & coin[:, None])
    hot = counter_u01(key["rawhot"], rctr) < _f32(plan.hot_bias)
    v_hot = edges[counter_mod(key["rawhotv"], rctr, plan.E), 1]
    v_uni = counter_mod(key["rawuni"], rctr, plan.n)
    raw_lines = torch.where(rvalid, vline(0, torch.where(hot, v_hot, v_uni)), -1)
    safe_v = counter_mod(key["safe"], _arange(W, dev), plan.n)
    cwr = torch.cat([raw_lines, vline(plan.p_next_base, safe_v)[:, None]], 1)

    pool = counter_mod(key["pool"], _arange(plan.pool_n, dev), plan.n)
    cv = pool[counter_mod(key["crs"], _ctr2(W, plan.reads_n, dev), plan.pool_n)]
    half = plan.reads_n // 2
    crd = torch.cat([vline(plan.p_next_base, cv[:, :half]),
                     fline(plan.frontier_base, cv[:, half:])], 1)

    return _finish_arrays(plan, reads, writes, cwr, crd, kid, start, end, pre)


def _frontier_arrays(plan: FrontierPlan, keys, edges: torch.Tensor) -> dict:
    """BFS/SSSP frontier kernels: bursty, frontier-sized windows."""
    dev = edges.device
    key = dict(zip(FrontierPlan.STREAMS, keys))
    W, K, S = plan.num_windows, plan.num_kernels, plan.epw_max
    kid, j, start, end = _kernel_structure(plan, dev)

    f0 = counter_mod(key["f0"], _arange(K, dev), plan.E)
    bk = counter_mod(key["bk"], _arange(K * plan.bk_n, dev),
                     plan.n).reshape(K, plan.bk_n)
    pre = _pre_writes(plan, torch.cat(
        [fline(plan.frontier_base, bk), vline(0, bk)], 1))

    # the level-sized frontier sweep: slots past this level's frontier
    # stay empty (-1 in place)
    epw_w = torch.tensor(plan.epw, dtype=torch.int64, device=dev)[kid]
    slot = _arange(S, dev)
    alive = slot[None, :] < epw_w[:, None]
    lo = f0[kid] + j * epw_w
    eidx = (lo[:, None] + slot[None, :]) % plan.E
    dst = edges[eidx, 1]
    reads = torch.zeros((W, 2 * S), dtype=torch.int64, device=dev)
    reads[:, 0::2] = torch.where(alive, eline(plan.edge_base, eidx), -1)
    reads[:, 1::2] = torch.where(alive, vline(0, dst), -1)
    relaxed = counter_u01(key["relax"], _ctr2(W, S, dev)) < _f32(plan.relax_rate)
    writes = torch.where(alive & relaxed, vline(plan.p_next_base, dst), -1)

    # host threads: frontier-queue writes (safe) and occasional dist
    # relaxation assists (RAW-capable)
    qv = counter_mod(key["qsafe"], _ctr2(W, 2, dev), plan.n)
    wctr = _arange(W, dev)
    qcoin = counter_u01(key["qraw"], wctr) < _f32(plan.qraw_rate)
    qrv = counter_mod(key["qrawv"], wctr, plan.n)
    raw_line = torch.where(qcoin, vline(0, qrv), -1)
    cwr = torch.cat([fline(plan.frontier_base, qv), raw_line[:, None]], 1)

    pool = counter_mod(key["pool"], _arange(plan.pool_n, dev), plan.n)
    cv = pool[counter_mod(key["crs"], _ctr2(W, plan.reads_n, dev), plan.pool_n)]
    half = plan.reads_n // 2
    crd = torch.cat([vline(0, cv[:, :half]),
                     fline(plan.frontier_base, cv[:, half:])], 1)

    return _finish_arrays(plan, reads, writes, cwr, crd, kid, start, end, pre)


def _htap_arrays(plan: HtapPlan, keys, dev) -> dict:
    """Seed HTAP family (select scans + hash-join probes vs transactions)."""
    key = dict(zip(HtapPlan.STREAMS, keys))
    W, K, TL = plan.num_windows, plan.num_kernels, plan.tuple_lines
    kid, j, start, end = _kernel_structure(plan, dev)

    table = counter_mod(key["tbl"], _arange(K, dev), plan.tables)
    cur0 = counter_mod(key["cur"], _arange(K, dev), max(1, plan.tuples - 1))

    bctr = _ctr2(K, plan.burst_n, dev)
    btab = counter_mod(key["btab"], bctr, plan.tables)
    btab = torch.where(_arange(plan.burst_n, dev)[None, :] < plan.burst_hot,
                       table[:, None], btab)
    btup = counter_mod(key["btup"], bctr, plan.tuples)
    bfld = counter_mod(key["bfld"], bctr, TL)
    pre = _pre_writes(plan, tline(plan, btab, btup, bfld))

    s = _arange(plan.n_scan, dev)
    tup = (cur0[kid][:, None] + (j * (plan.n_scan // TL))[:, None]
           + s[None, :] // TL) % plan.tuples
    scan = tline(plan, table[kid][:, None], tup, s[None, :] % TL)
    probe = plan.hash_base + counter_mod(
        key["probe"], _ctr2(W, plan.n_probe, dev), plan.hash_lines)
    reads = torch.cat([scan, probe], 1)
    writes = plan.hash_base + counter_mod(
        key["wrh"], _ctr2(W, plan.n_wr, dev), plan.hash_lines)

    tctr = _ctr2(W, plan.txn_writes, dev)
    ttab = counter_mod(key["twtab"], tctr, plan.tables)
    ttab = torch.where(_arange(plan.txn_writes, dev)[None, :] < plan.txn_hot,
                       table[kid][:, None], ttab)
    ttup = counter_mod(key["twtup"], tctr, plan.tuples)
    tfld = counter_mod(key["twfld"], tctr, TL)
    cwr = tline(plan, ttab, ttup, tfld)

    ictr = _arange(plan.pool_n, dev)
    pool = tline(plan, counter_mod(key["ptab"], ictr, plan.tables),
                 counter_mod(key["ptup"], ictr, plan.tuples),
                 counter_mod(key["pfld"], ictr, TL))
    crd = pool[counter_mod(key["txr"], _ctr2(W, plan.txn_reads, dev),
                           plan.pool_n)]

    return _finish_arrays(plan, reads, writes, cwr, crd, kid, start, end, pre)


def _stream_arrays(plan: StreamPlan, keys, dev) -> dict:
    """Streaming-ingest HTAP: appends at a moving tail, analytics over the
    region ingested ``lag`` tuples ago, reuse-heavy hot-tail txn reads."""
    key = dict(zip(StreamPlan.STREAMS, keys))
    W, K, TL, TOT = plan.num_windows, plan.num_kernels, plan.tuple_lines, \
        plan.total_tuples
    kid, _, start, end = _kernel_structure(plan, dev)
    tail = (_arange(W, dev) * plan.apw) % TOT

    # analytics: scan the tuples ingested lag ago, and hash probes
    s = _arange(plan.n_scan, dev)
    g_scan = (tail[:, None] + TOT - plan.lag - s[None, :]) % TOT
    scan = gtline(plan, g_scan, s[None, :] % TL)
    probe = plan.hash_base + counter_mod(
        key["probe"], _ctr2(W, plan.n_probe, dev), plan.hash_lines)
    reads = torch.cat([scan, probe], 1)
    writes = plan.hash_base + counter_mod(
        key["wrh"], _ctr2(W, plan.n_wr, dev), plan.hash_lines)

    # transactions: append at the tail, index maintenance in the hash area
    g_app = (tail[:, None] + _arange(plan.apw, dev)[None, :]) % TOT
    appends = gtline(plan, g_app, 0)
    idxw = plan.hash_base + counter_mod(
        key["idxw"], _ctr2(W, plan.idx_writes, dev), plan.hash_lines)
    cwr = torch.cat([appends, idxw], 1)

    # txn reads of the recently ingested window behind the tail
    r = counter_mod(key["txr"], _ctr2(W, plan.txn_reads, dev), plan.recent)
    crd = gtline(plan, (tail[:, None] + TOT - 1 - r) % TOT, r % TL)

    # inter-kernel commit burst just behind the tail
    tail_k = (_arange(K, dev) * plan.wpk * plan.apw) % TOT
    b = counter_mod(key["burst"], _ctr2(K, plan.burst_n, dev), 64)
    pre = _pre_writes(plan, gtline(plan, (tail_k[:, None] + TOT - 1 - b) % TOT, 0))

    return _finish_arrays(plan, reads, writes, cwr, crd, kid, start, end, pre)


def _mt_arrays(plan: MTPlan, keys, edges: torch.Tensor) -> dict:
    """Multi-tenant mix: the tenants alternate kernels; both tenants'
    processor threads write every window."""
    dev = edges.device
    key = dict(zip(MTPlan.STREAMS, keys))
    W, K, epw = plan.num_windows, plan.num_kernels, plan.epw
    kid, j, start, end = _kernel_structure(plan, dev)
    tenant_b = (kid % 2) == 1
    kl = kid // 2                                  # tenant-local kernel

    ka, kb = len(plan.hi_a), len(plan.hi_b)
    e0a = counter_mod(key["e0A"], _arange(ka, dev),
                      torch.tensor(plan.hi_a, dtype=torch.int64, device=dev))
    e0b = counter_mod(key["e0B"], _arange(kb, dev),
                      torch.tensor(plan.hi_b, dtype=torch.int64, device=dev))
    e0 = torch.where(tenant_b, e0b[kl.clamp(0, kb - 1)], e0a[kl.clamp(0, ka - 1)])

    # the active tenant's edgeMap over the shared CSR edges, private vertex
    # arrays; A writes p_next[src] (pagerank-like), B p_next[dst]
    pc = torch.where(tenant_b, plan.b_pc, plan.a_pc)[:, None]
    pn = torch.where(tenant_b, plan.b_pn, plan.a_pn)[:, None]
    eidx = ((e0 + j * epw)[:, None] + _arange(epw, dev)) % plan.E
    src = edges[eidx, 0]
    dst = edges[eidx, 1]
    reads = torch.zeros((W, 2 * epw), dtype=torch.int64, device=dev)
    reads[:, 0::2] = eline(plan.edge_base, eidx)
    reads[:, 1::2] = pc + dst // VPL
    writes = pn + torch.where(tenant_b[:, None], dst, src) // VPL

    # per-kernel bookkeeping in the active tenant's frontier and p_next
    bka = counter_mod(key["bkA"], _arange(ka * plan.bk_n, dev),
                      plan.n).reshape(ka, plan.bk_n)
    bkb = counter_mod(key["bkB"], _arange(kb * plan.bk_n, dev),
                      plan.n).reshape(kb, plan.bk_n)
    ks = _arange(K, dev)
    bsel = (ks % 2) == 1
    bk = torch.where(bsel[:, None], bkb[(ks // 2).clamp(0, kb - 1)],
                     bka[(ks // 2).clamp(0, ka - 1)])
    frb = torch.where(bsel, plan.b_fr, plan.a_fr)[:, None]
    pnb = torch.where(bsel, plan.b_pn, plan.a_pn)[:, None]
    pre = _pre_writes(plan, torch.cat([frb + bk // 64, pnb + bk // VPL], 1))

    # both tenants' threads every window: A's uniform RAW write, B's hot
    # RAW write, and one safe p_next write each
    wctr = _arange(W, dev)
    a_coin = counter_u01(key["rawnA"], wctr) < _f32(plan.a_raw_frac)
    a_v = counter_mod(key["rawuniA"], wctr, plan.n)
    a_raw = torch.where(a_coin, plan.a_pc + a_v // VPL, -1)
    a_safe = plan.a_pn + counter_mod(key["safeA"], wctr, plan.n) // VPL
    Rb = plan.b_raw_int + 1
    bctr = _ctr2(W, Rb, dev)
    b_coin = counter_u01(key["rawnB"], wctr) < _f32(plan.b_raw_frac)
    slot = _arange(Rb, dev)
    b_valid = (slot < plan.b_raw_int) | ((slot == plan.b_raw_int) & b_coin[:, None])
    b_hot = counter_u01(key["rawhotB"], bctr) < _f32(plan.b_hot_bias)
    b_vh = edges[counter_mod(key["rawhotvB"], bctr, plan.E), 1]
    b_vu = counter_mod(key["rawuniB"], bctr, plan.n)
    b_raw = torch.where(b_valid, plan.b_pc + torch.where(b_hot, b_vh, b_vu) // VPL, -1)
    b_safe = plan.b_pn + counter_mod(key["safeB"], wctr, plan.n) // VPL
    cwr = torch.cat([a_raw[:, None], a_safe[:, None], b_raw, b_safe[:, None]], 1)

    # cached reads from both tenants' hot pools
    poolA = counter_mod(key["poolA"], _arange(plan.pool_n, dev), plan.n)
    poolB = counter_mod(key["poolB"], _arange(plan.pool_n, dev), plan.n)
    per = plan.reads_n // 2
    cctr = _ctr2(W, per, dev)
    av = poolA[counter_mod(key["crsA"], cctr, plan.pool_n)]
    bv = poolB[counter_mod(key["crsB"], cctr, plan.pool_n)]
    q = per // 2
    crd = torch.cat([plan.a_pn + av[:, :q] // VPL, plan.a_fr + av[:, q:] // 64,
                     plan.b_pn + bv[:, :q] // VPL, plan.b_fr + bv[:, q:] // 64], 1)

    return _finish_arrays(plan, reads, writes, cwr, crd, kid, start, end, pre)


_EDGE_FNS = {GraphPlan: _graph_arrays, FrontierPlan: _frontier_arrays,
             MTPlan: _mt_arrays}
_TABLE_FNS = {HtapPlan: _htap_arrays, StreamPlan: _stream_arrays}


def generator(plan, seed: int = 0, edges: np.ndarray | None = None,
              device=None) -> tuple:
    """``(fn, args)``: ``fn(*args)`` gives all WindowTrace tensors of
    ``plan`` at ``seed`` on ``device`` (``None``: the CUDA card) — the unit
    the trace-synthesis benchmark times.  The Threefry keys, and the edge
    tensor for the edge families, are the arguments, so another seed
    reuses ``fn``."""
    dev = resolve_device(device)
    keys = [tuple(int(v) for v in row) for row in derive_keys(
        plan.app, getattr(plan, "graph_name", None), seed, type(plan).STREAMS)]
    if type(plan) in _EDGE_FNS:
        e = torch.from_numpy(np.asarray(edges, dtype=np.int64)).to(dev)
        return functools.partial(_EDGE_FNS[type(plan)], plan), (keys, e)
    if type(plan) in _TABLE_FNS:
        return functools.partial(_TABLE_FNS[type(plan)], plan, dev=dev), (keys,)
    raise TypeError(f"no generator for {type(plan).__name__}")


def synthesize(plan, seed: int = 0, edges: np.ndarray | None = None,
               device=None) -> dict:
    """Run :func:`generator`: all WindowTrace tensors of ``plan`` at
    ``seed``, generated on ``device``."""
    fn, args = generator(plan, seed, edges, device)
    return fn(*args)
