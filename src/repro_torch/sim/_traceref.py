"""Sequential numpy reference for trace synthesis (the port's copy of
:mod:`repro.sim._traceref`, behind ``make_trace(..., backend="ref")``).

Host-side numpy, one Python loop iteration a kernel or window: the
readable specification of every synthesized family.  Its randomness comes
from the same counter-based streams as the tensor generators of
:mod:`repro_torch.sim.synth` (the keys of :func:`~repro_torch.sim.synth.
derive_keys`, Threefry-2x32), but the draws, the line layout and the
instruction counts are computed here again in numpy uint32 / int32, so the
tensor path is checked against arithmetic it does not share; the two
regenerate every workload bit for bit (``tests/test_torch_synth_extended.py``).
The plans are :mod:`repro_torch.sim.synth`'s (plain Python, host-side).
"""

from __future__ import annotations

import numpy as np

from repro_torch.sim import synth as S
from repro_torch.sim.synth import AR, AW, BR, BW, VPL, EPL, derive_keys

# ---------------------------------------------------------------------------
# Counter-based draws in numpy uint32 (Threefry-2x32, 20 rounds)
# ---------------------------------------------------------------------------


def threefry2x32(k0, k1, c0: np.ndarray, c1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 over uint32 counter arrays; wraps mod 2^32 as uint32
    arithmetic does."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, np.uint32(0x1BD11BDA) ^ k0 ^ k1)
    with np.errstate(over="ignore"):
        x0 = np.asarray(c0, np.uint32) + k0
        x1 = np.asarray(c1, np.uint32) + k1
        for d in range(5):
            for r in S._ROT_A if d % 2 == 0 else S._ROT_B:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x1 ^ x0
            x0 = x0 + ks[(d + 1) % 3]
            x1 = x1 + ks[(d + 2) % 3] + np.uint32(d + 1)
    return x0, x1


def counter_bits(key, ctr) -> np.ndarray:
    ctr = np.asarray(ctr, np.uint32)
    x0, _ = threefry2x32(key[0], key[1], ctr, np.zeros_like(ctr))
    return x0


def counter_u01(key, ctr) -> np.ndarray:
    """float32 uniform in [0, 1): the top 24 bits scaled (exact)."""
    return (counter_bits(key, ctr) >> np.uint32(8)).astype(np.float32) \
        * np.float32(2.0 ** -24)


def counter_mod(key, ctr, bound) -> np.ndarray:
    """int32 uniform in [0, bound) by modulo."""
    return (counter_bits(key, ctr) % np.asarray(bound, np.uint32)).astype(np.int32)


# ---------------------------------------------------------------------------
# Line layout and instruction counts
# ---------------------------------------------------------------------------


def vline(base: int, v):
    return np.int32(base) + v // VPL


def fline(base: int, v):
    return np.int32(base) + v // 64


def eline(base: int, e):
    return np.int32(base) + e // EPL


def tline(plan, table, tup, fld):
    return ((table * plan.tuples + tup) * plan.tuple_lines + fld).astype(np.int32)


def gtline(plan, gidx, fld):
    return (gidx * plan.tuple_lines + fld).astype(np.int32)


def instr_counts(plan, n_pim_acc: np.ndarray, n_cpu_acc: np.ndarray):
    """(pim_instr, cpu_instr, cpu_priv) float32, in the reference's rounding
    order."""
    pim = n_pim_acc.astype(np.float32) * np.float32(plan.pim_ipw)
    cpu = (n_cpu_acc.astype(np.float32) * np.float32(plan.cpu_reuse)
           * np.float32(plan.cpu_ipw) + np.float32(plan.threads * plan.cpu_serial_instr))
    priv = np.full(n_pim_acc.shape, np.float32(plan.threads * plan.priv_apw), np.float32)
    return pim, cpu, priv


def _pad(ids: np.ndarray, width: int) -> np.ndarray:
    out = np.full((width,), -1, dtype=np.int32)
    n = min(len(ids), width)
    out[:n] = ids[:n]
    return out


def _u32(*vals) -> np.ndarray:
    return np.asarray(vals, np.uint32)


def _arange32(n: int, base: int = 0) -> np.ndarray:
    return (np.arange(n, dtype=np.uint32) + np.uint32(base)).astype(np.uint32)


def _alloc(plan):
    W = plan.num_windows
    return (np.full((W, AR), -1, np.int32), np.full((W, AW), -1, np.int32),
            np.full((W, BR), -1, np.int32), np.full((W, BW), -1, np.int32),
            np.zeros((plan.num_kernels, plan.total_lines), bool))


def _finish(plan, pim_reads, pim_writes, cpu_reads, cpu_writes, pre):
    """Kernel structure and instruction counts -> the field dict."""
    K, wpk = plan.num_kernels, plan.wpk
    n_pim = ((pim_reads >= 0).sum(1) + (pim_writes >= 0).sum(1)).astype(np.int32)
    n_cpu = ((cpu_reads >= 0).sum(1) + (cpu_writes >= 0).sum(1)).astype(np.int32)
    pim_i, cpu_i, priv = instr_counts(plan, n_pim, n_cpu)
    kernel_id = np.repeat(np.arange(K, dtype=np.int32), wpk)
    start = np.zeros((K * wpk,), bool)
    start[::wpk] = True
    end = np.zeros((K * wpk,), bool)
    end[wpk - 1::wpk] = True
    return dict(pim_reads=pim_reads, pim_writes=pim_writes,
                cpu_reads=cpu_reads, cpu_writes=cpu_writes,
                kernel_id=kernel_id, kernel_start=start, kernel_end=end,
                pre_writes=pre, pim_instr=pim_i, cpu_instr=cpu_i,
                cpu_priv_accesses=priv)


# ---------------------------------------------------------------------------
# Seed graph family (Ligra edgeMap)
# ---------------------------------------------------------------------------


def graph_arrays_ref(plan: S.GraphPlan, keys, edges) -> dict:
    key = dict(zip(S.GraphPlan.STREAMS, np.asarray(keys)))
    epw, R = plan.epw, plan.raw_max
    pim_reads, pim_writes, cpu_reads, cpu_writes, pre = _alloc(plan)

    hi = np.asarray(plan.hi, np.uint32)
    pool = counter_mod(key["pool"], _arange32(plan.pool_n), plan.n)

    w = 0
    for k in range(plan.num_kernels):
        e0 = int(counter_mod(key["e0"], _u32(k), hi[k:k + 1])[0])
        bk = counter_mod(key["bk"], _arange32(plan.bk_n, k * plan.bk_n), plan.n)
        pre[k, np.concatenate([fline(plan.frontier_base, bk), vline(0, bk)])] = True

        for j in range(plan.wpk):
            # edgeMap: sequential edge-array lines, scattered p_curr gathers
            eidx = (np.arange(epw, dtype=np.int32) + np.int32(e0 + j * epw)) % plan.E
            src, dst = edges[eidx, 0], edges[eidx, 1]
            reads = np.empty((2 * epw,), np.int32)
            reads[0::2] = eline(plan.edge_base, eidx)
            reads[1::2] = vline(0, dst)
            pim_reads[w] = _pad(reads, AR)
            pim_writes[w] = _pad(
                vline(plan.p_next_base, src if plan.writes_src else dst), AW)

            # concurrent RAW-capable p_curr writes and one safe p_next write
            rctr = _arange32(R, w * R)
            coin = counter_u01(key["rawn"], _u32(w))[0] < np.float32(plan.raw_frac)
            rvalid = (np.arange(R) < plan.raw_int) | \
                ((np.arange(R) == plan.raw_int) & coin)
            hot = counter_u01(key["rawhot"], rctr) < np.float32(plan.hot_bias)
            v_hot = edges[counter_mod(key["rawhotv"], rctr, plan.E), 1]
            v_uni = counter_mod(key["rawuni"], rctr, plan.n)
            raw_lines = np.where(rvalid, vline(0, np.where(hot, v_hot, v_uni)), -1)
            safe_v = counter_mod(key["safe"], _u32(w), plan.n)
            cpu_writes[w] = _pad(
                np.concatenate([raw_lines, vline(plan.p_next_base, safe_v)]), BW)

            # cached bookkeeping reads from the stable hot-vertex pool
            cctr = _arange32(plan.reads_n, w * plan.reads_n)
            cv = pool[counter_mod(key["crs"], cctr, plan.pool_n)]
            half = plan.reads_n // 2
            cpu_reads[w] = _pad(
                np.concatenate([vline(plan.p_next_base, cv[:half]),
                                fline(plan.frontier_base, cv[half:])]), BR)
            w += 1

    return _finish(plan, pim_reads, pim_writes, cpu_reads, cpu_writes, pre)


# ---------------------------------------------------------------------------
# BFS/SSSP frontier family
# ---------------------------------------------------------------------------


def frontier_arrays_ref(plan: S.FrontierPlan, keys, edges) -> dict:
    key = dict(zip(S.FrontierPlan.STREAMS, np.asarray(keys)))
    Smax = plan.epw_max
    pim_reads, pim_writes, cpu_reads, cpu_writes, pre = _alloc(plan)
    pool = counter_mod(key["pool"], _arange32(plan.pool_n), plan.n)

    w = 0
    for k in range(plan.num_kernels):
        f0 = int(counter_mod(key["f0"], _u32(k), plan.E)[0])
        bk = counter_mod(key["bk"], _arange32(plan.bk_n, k * plan.bk_n), plan.n)
        pre[k, np.concatenate([fline(plan.frontier_base, bk), vline(0, bk)])] = True
        epw = plan.epw[k]

        for j in range(plan.wpk):
            # level-sized frontier sweep: slots past the frontier stay -1
            slot = np.arange(Smax, dtype=np.int32)
            alive = slot < epw
            eidx = (slot + np.int32(f0 + j * epw)) % plan.E
            dst = edges[eidx, 1]
            reads = np.empty((2 * Smax,), np.int32)
            reads[0::2] = np.where(alive, eline(plan.edge_base, eidx), -1)
            reads[1::2] = np.where(alive, vline(0, dst), -1)
            pim_reads[w] = _pad(reads, AR)
            relaxed = counter_u01(key["relax"], _arange32(Smax, w * Smax)) \
                < np.float32(plan.relax_rate)
            pim_writes[w] = _pad(
                np.where(alive & relaxed, vline(plan.p_next_base, dst), -1), AW)

            # frontier-queue writes (safe), occasional dist relaxation (RAW)
            qv = counter_mod(key["qsafe"], _arange32(2, w * 2), plan.n)
            qcoin = counter_u01(key["qraw"], _u32(w))[0] < np.float32(plan.qraw_rate)
            qrv = counter_mod(key["qrawv"], _u32(w), plan.n)
            raw_line = np.where(qcoin, vline(0, qrv), -1)
            cpu_writes[w] = _pad(
                np.concatenate([fline(plan.frontier_base, qv), raw_line]), BW)

            cctr = _arange32(plan.reads_n, w * plan.reads_n)
            cv = pool[counter_mod(key["crs"], cctr, plan.pool_n)]
            half = plan.reads_n // 2
            cpu_reads[w] = _pad(
                np.concatenate([vline(0, cv[:half]),
                                fline(plan.frontier_base, cv[half:])]), BR)
            w += 1

    return _finish(plan, pim_reads, pim_writes, cpu_reads, cpu_writes, pre)


# ---------------------------------------------------------------------------
# Seed HTAP family
# ---------------------------------------------------------------------------


def htap_arrays_ref(plan: S.HtapPlan, keys) -> dict:
    key = dict(zip(S.HtapPlan.STREAMS, np.asarray(keys)))
    TL = plan.tuple_lines
    pim_reads, pim_writes, cpu_reads, cpu_writes, pre = _alloc(plan)

    ictr = _arange32(plan.pool_n)
    pool = tline(plan, counter_mod(key["ptab"], ictr, plan.tables),
                 counter_mod(key["ptup"], ictr, plan.tuples),
                 counter_mod(key["pfld"], ictr, TL))

    w = 0
    for k in range(plan.num_kernels):
        table = int(counter_mod(key["tbl"], _u32(k), plan.tables)[0])
        cur0 = int(counter_mod(key["cur"], _u32(k), max(1, plan.tuples - 1))[0])
        # txn-commit burst, biased toward the (hot) scanned table
        bctr = _arange32(plan.burst_n, k * plan.burst_n)
        btab = counter_mod(key["btab"], bctr, plan.tables)
        btab = np.where(np.arange(plan.burst_n) < plan.burst_hot, table, btab)
        btup = counter_mod(key["btup"], bctr, plan.tuples)
        bfld = counter_mod(key["bfld"], bctr, TL)
        pre[k, tline(plan, btab, btup, bfld)] = True

        for j in range(plan.wpk):
            # select scan (sequential tuple lines) and random hash-join probes
            s = np.arange(plan.n_scan, dtype=np.int32)
            tup = (cur0 + j * (plan.n_scan // TL) + s // TL) % plan.tuples
            scan = tline(plan, np.full_like(s, table), tup, s % TL)
            pctr = _arange32(plan.n_probe, w * plan.n_probe)
            probe = plan.hash_base + counter_mod(key["probe"], pctr, plan.hash_lines)
            pim_reads[w] = _pad(np.concatenate([scan, probe]), AR)
            wctr = _arange32(plan.n_wr, w * plan.n_wr)
            pim_writes[w] = _pad(
                plan.hash_base + counter_mod(key["wrh"], wctr, plan.hash_lines), AW)

            # transactions: hot-table-biased tuple writes and cached reads
            tctr = _arange32(plan.txn_writes, w * plan.txn_writes)
            ttab = counter_mod(key["twtab"], tctr, plan.tables)
            ttab = np.where(np.arange(plan.txn_writes) < plan.txn_hot, table, ttab)
            ttup = counter_mod(key["twtup"], tctr, plan.tuples)
            tfld = counter_mod(key["twfld"], tctr, TL)
            cpu_writes[w] = _pad(tline(plan, ttab, ttup, tfld), BW)
            rctr = _arange32(plan.txn_reads, w * plan.txn_reads)
            cpu_reads[w] = _pad(pool[counter_mod(key["txr"], rctr, plan.pool_n)], BR)
            w += 1

    return _finish(plan, pim_reads, pim_writes, cpu_reads, cpu_writes, pre)


# ---------------------------------------------------------------------------
# Streaming-ingest HTAP family
# ---------------------------------------------------------------------------


def stream_arrays_ref(plan: S.StreamPlan, keys) -> dict:
    key = dict(zip(S.StreamPlan.STREAMS, np.asarray(keys)))
    TL, TOT = plan.tuple_lines, plan.total_tuples
    pim_reads, pim_writes, cpu_reads, cpu_writes, pre = _alloc(plan)

    for k in range(plan.num_kernels):
        # commit burst just behind the tail at kernel start
        tail_k = (k * plan.wpk * plan.apw) % TOT
        b = counter_mod(key["burst"], _arange32(plan.burst_n, k * plan.burst_n), 64)
        g_b = (tail_k + TOT - 1 - b) % TOT
        pre[k, gtline(plan, g_b, np.zeros_like(g_b))] = True

    for w in range(plan.num_windows):
        tail = (w * plan.apw) % TOT
        # analytics: scan the tuples ingested lag ago, and hash probes
        s = np.arange(plan.n_scan, dtype=np.int32)
        scan = gtline(plan, (tail + TOT - plan.lag - s) % TOT, s % TL)
        pctr = _arange32(plan.n_probe, w * plan.n_probe)
        probe = plan.hash_base + counter_mod(key["probe"], pctr, plan.hash_lines)
        pim_reads[w] = _pad(np.concatenate([scan, probe]), AR)
        wctr = _arange32(plan.n_wr, w * plan.n_wr)
        pim_writes[w] = _pad(
            plan.hash_base + counter_mod(key["wrh"], wctr, plan.hash_lines), AW)

        # txns: append at the tail, index maintenance in the hash area
        a = np.arange(plan.apw, dtype=np.int32)
        appends = gtline(plan, (tail + a) % TOT, np.zeros_like(a))
        ictr = _arange32(plan.idx_writes, w * plan.idx_writes)
        idxw = plan.hash_base + counter_mod(key["idxw"], ictr, plan.hash_lines)
        cpu_writes[w] = _pad(np.concatenate([appends, idxw]), BW)

        # reuse-heavy hot reads of the recently ingested region
        rctr = _arange32(plan.txn_reads, w * plan.txn_reads)
        r = counter_mod(key["txr"], rctr, plan.recent)
        cpu_reads[w] = _pad(gtline(plan, (tail + TOT - 1 - r) % TOT, r % TL), BR)

    return _finish(plan, pim_reads, pim_writes, cpu_reads, cpu_writes, pre)


# ---------------------------------------------------------------------------
# Multi-tenant mix
# ---------------------------------------------------------------------------


def mt_arrays_ref(plan: S.MTPlan, keys, edges) -> dict:
    key = dict(zip(S.MTPlan.STREAMS, np.asarray(keys)))
    epw = plan.epw
    pim_reads, pim_writes, cpu_reads, cpu_writes, pre = _alloc(plan)
    poolA = counter_mod(key["poolA"], _arange32(plan.pool_n), plan.n)
    poolB = counter_mod(key["poolB"], _arange32(plan.pool_n), plan.n)
    hi_a = np.asarray(plan.hi_a, np.uint32)
    hi_b = np.asarray(plan.hi_b, np.uint32)
    Rb = plan.b_raw_int + 1

    w = 0
    for k in range(plan.num_kernels):
        tb, kl = (k % 2) == 1, k // 2
        if tb:
            e0 = int(counter_mod(key["e0B"], _u32(kl), hi_b[kl:kl + 1])[0])
            bk = counter_mod(key["bkB"], _arange32(plan.bk_n, kl * plan.bk_n), plan.n)
            pc, pn, fr = plan.b_pc, plan.b_pn, plan.b_fr
        else:  # tenant A
            e0 = int(counter_mod(key["e0A"], _u32(kl), hi_a[kl:kl + 1])[0])
            bk = counter_mod(key["bkA"], _arange32(plan.bk_n, kl * plan.bk_n), plan.n)
            pc, pn, fr = plan.a_pc, plan.a_pn, plan.a_fr
        # bookkeeping: frontier and p_next (the next iteration's output merge)
        pre[k, np.concatenate([np.int32(fr) + bk // 64, np.int32(pn) + bk // VPL])] = True

        for j in range(plan.wpk):
            # the active tenant's edgeMap over the shared CSR edge array
            eidx = (np.arange(epw, dtype=np.int32) + np.int32(e0 + j * epw)) % plan.E
            src, dst = edges[eidx, 0], edges[eidx, 1]
            reads = np.empty((2 * epw,), np.int32)
            reads[0::2] = eline(plan.edge_base, eidx)
            reads[1::2] = np.int32(pc) + dst // VPL
            pim_reads[w] = _pad(reads, AR)
            pim_writes[w] = _pad(np.int32(pn) + (dst if tb else src) // VPL, AW)

            # both tenants' threads write every window
            a_coin = counter_u01(key["rawnA"], _u32(w))[0] < np.float32(plan.a_raw_frac)
            a_v = counter_mod(key["rawuniA"], _u32(w), plan.n)
            a_raw = np.where(a_coin, plan.a_pc + a_v // VPL, -1)
            a_safe = plan.a_pn + counter_mod(key["safeA"], _u32(w), plan.n) // VPL
            bctr = _arange32(Rb, w * Rb)
            b_coin = counter_u01(key["rawnB"], _u32(w))[0] < np.float32(plan.b_raw_frac)
            b_valid = (np.arange(Rb) < plan.b_raw_int) | \
                ((np.arange(Rb) == plan.b_raw_int) & b_coin)
            b_hot = counter_u01(key["rawhotB"], bctr) < np.float32(plan.b_hot_bias)
            b_vh = edges[counter_mod(key["rawhotvB"], bctr, plan.E), 1]
            b_vu = counter_mod(key["rawuniB"], bctr, plan.n)
            b_raw = np.where(b_valid, plan.b_pc + np.where(b_hot, b_vh, b_vu) // VPL, -1)
            b_safe = plan.b_pn + counter_mod(key["safeB"], _u32(w), plan.n) // VPL
            cpu_writes[w] = _pad(np.concatenate(
                [a_raw, a_safe, b_raw, b_safe]).astype(np.int32), BW)

            # cached reads from both tenants' hot pools
            per = plan.reads_n // 2
            cctr = _arange32(per, w * per)
            av = poolA[counter_mod(key["crsA"], cctr, plan.pool_n)]
            bv = poolB[counter_mod(key["crsB"], cctr, plan.pool_n)]
            q = per // 2
            cpu_reads[w] = _pad(np.concatenate([
                plan.a_pn + av[:q] // VPL, plan.a_fr + av[q:] // 64,
                plan.b_pn + bv[:q] // VPL, plan.b_fr + bv[q:] // 64,
            ]).astype(np.int32), BR)
            w += 1

    return _finish(plan, pim_reads, pim_writes, cpu_reads, cpu_writes, pre)


ARRAY_FNS_REF = {
    S.GraphPlan: graph_arrays_ref,
    S.FrontierPlan: frontier_arrays_ref,
    S.HtapPlan: htap_arrays_ref,
    S.StreamPlan: stream_arrays_ref,
    S.MTPlan: mt_arrays_ref,
}


def synthesize_ref(plan, seed: int = 0, edges: np.ndarray | None = None) -> dict:
    """The full trace-array dict (numpy) from the sequential loops."""
    keys = derive_keys(plan.app, getattr(plan, "graph_name", None), seed,
                       type(plan).STREAMS)
    fn = ARRAY_FNS_REF[type(plan)]
    if type(plan) in (S.HtapPlan, S.StreamPlan):
        return fn(plan, keys)
    return fn(plan, keys, np.asarray(edges))
