"""Boolean seed reference simulators (PyTorch port of
:mod:`repro.core._boolref`): the pre-packing implementations of all six
mechanisms, on the ``*_bool`` primitives of :mod:`repro_torch.sim.prep` —
``(num_lines,)`` bool bitmaps and ``(sig_bits,)`` bool Bloom images in the
window carry, the CPUWriteSet bank materialized per window.

On the card the Bloom images and membership masks run the seed one-hot
kernels (``bloom_insert_onehot`` / ``bloom_query_onehot``,
:mod:`repro_torch.kernels.bloom.onehot`); the bitmaps and the bank are
plain PyTorch.  The packed engine (:mod:`repro_torch.sim.engine`) must
equal this one on every ``SimResult`` field, exactly, as
``tests/test_packed_engine.py`` requires of the reference.

One trace at a time, as the reference: :func:`run_all_bool` runs the
trace as the one-lane case of the packed engine's records (the same
``stack_traces`` / ``stack_hw`` / ``stack_lazy`` tensors, so every float
expression sees the packed engine's operands) and the shared per-window
terms of :mod:`repro_torch.core.mechanisms`.  The reference's
``lax.scan`` is a Python loop over the windows, with no window masking (a
trace from ``prepare`` has no padded windows).  The device is the trace's.
"""

from __future__ import annotations

import torch

from repro_torch.core.coherence import LazyPIMConfig
from repro_torch.core.mechanisms import (
    SimResult,
    _bw_bound_ns,
    _cpu_acc_count,
    _cpu_compute_ns,
    _cpu_dyn_count,
    _f0,
    _lanes,
    _pim_acc_count,
    _pim_compute_ns,
    _pim_dram_bytes,
    _pim_mem_ns,
    _priv_fill_bytes,
    _priv_mem_ns,
    _sel,
    finalize_result,
)
from repro_torch.sim.costmodel import CTRL_BYTES, LINE_BYTES, HWParams
from repro_torch.sim.engine import (
    MECHANISMS,
    stack_hw,
    stack_lazy,
    stack_traces,
)
from repro_torch.sim.prep import (
    CPUWS_REGS,
    XXH_PRIME2,
    XXH_PRIME5,
    TraceTensors,
    bank_bits_from_bitmap_bool,
    conflict_any_bool,
    cpu_cache_step_bool,
    gather_hits_bool,
    line_window_u01,
    members_bool,
    neutral_trace,
    scatter_set_bool,
    sig_bits_pair_from_ids_bool,
)

__all__ = [
    "simulate_cpu_only_bool",
    "simulate_ideal_bool",
    "simulate_fg_bool",
    "simulate_cg_bool",
    "simulate_nc_bool",
    "simulate_lazypim_bool",
    "run_all_bool",
    "ACC_FNS_BOOL",
]


def _zeros(tt: TraceTensors) -> torch.Tensor:
    """Empty bool line bitmaps (L, num_lines)."""
    return torch.zeros((_lanes(tt), tt.num_lines), dtype=torch.bool,
                       device=tt.device)


def _loop(tt: TraceTensors, step, init):
    """The reference's ``lax.scan`` over every window."""
    carry = init
    for w in range(tt.num_windows):
        carry = step(carry, w)
    return carry


def _start_kernel_bool(tt: TraceTensors, w: int, present, dirty):
    """The inter-kernel processor phase dirties lines before a launch."""
    start = tt.kernel_start[:, w]
    k = tt.kernel_id[:, w].to(torch.int64)
    pre = tt.pre_writes[torch.arange(_lanes(tt), device=tt.device), k]
    return _sel(start, present | pre, present), _sel(start, dirty | pre, dirty)


# ---------------------------------------------------------------------------
# CPU-only, Ideal-PIM, FG, CG, NC
# ---------------------------------------------------------------------------


def _cpu_only_acc_bool(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2 = carry
        present, dirty = _start_kernel_bool(tt, w, present, dirty)
        out = cpu_cache_step_bool(tt, hw, present, dirty, w,
                                  cap_lines=hw.cpu_only_cache_cap)
        kern_compute = tt.pim_instr[:, w] / (hw.cpu_cores * hw.cpu_ipc * hw.freq_ghz)
        kern_mem = (tt.pim_uniq[:, w] * (hw.offchip_mem_ns / hw.cpu_kernel_mlp)
                    / hw.cpu_cores)
        kern_fill = (tt.pim_uniq[:, w] + tt.pim_uniq_w[:, w]) * LINE_BYTES

        off_w = out.fill_bytes + kern_fill + _priv_fill_bytes(tt, w)
        lat = (_cpu_compute_ns(tt, hw, w) + kern_compute + kern_mem
               + out.mem_ns + _priv_mem_ns(tt, hw, w))
        t_w = torch.maximum(lat, _bw_bound_ns(hw, off_w))

        l1_w = _cpu_dyn_count(tt, w) + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = out.misses + out.hits + tt.pim_uniq[:, w]
        return (out.present, out.dirty, t + t_w, off + off_w, dram + off_w,
                l1 + l1_w, l2 + l2_w)

    init = (_zeros(tt), _zeros(tt)) + (_f0(tt),) * 5
    _, _, t, off, dram, l1, l2 = _loop(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


def _ideal_acc_bool(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2 = carry
        present, dirty = _start_kernel_bool(tt, w, present, dirty)
        out = cpu_cache_step_bool(tt, hw, present, dirty, w)
        pim_w = scatter_set_bool(_zeros(tt), tt.pim_writes[:, w],
                                 tt.pim_w_valid[:, w])
        present = out.present & ~pim_w
        dirty = out.dirty & ~pim_w

        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = out.fill_bytes + _priv_fill_bytes(tt, w)
        t_w = torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
        dram_w = off_w + _pim_dram_bytes(tt, w)

        l1_w = _cpu_dyn_count(tt, w) + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = out.misses + out.hits
        return (present, dirty, t + t_w, off + off_w, dram + dram_w,
                l1 + l1_w, l2 + l2_w)

    init = (_zeros(tt), _zeros(tt)) + (_f0(tt),) * 5
    _, _, t, off, dram, l1, l2 = _loop(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


def _fg_acc_bool(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2 = carry
        present, dirty = _start_kernel_bool(tt, w, present, dirty)
        out = cpu_cache_step_bool(tt, hw, present, dirty, w)
        present, dirty = out.present, out.dirty

        rt_ns = hw.fg_msg_exposed_ns
        msg_bytes = tt.pim_uniq[:, w] * 8.0 * CTRL_BYTES

        pr, prv = tt.pim_reads[:, w], tt.pim_r_valid[:, w]
        pw, pwv = tt.pim_writes[:, w], tt.pim_w_valid[:, w]
        pr_dirty = gather_hits_bool(dirty, pr, prv)
        pw_dirty = gather_hits_bool(dirty, pw, pwv)
        xfer_lines = (pr_dirty.sum(1) + pw_dirty.sum(1)).to(torch.float32)
        dirty = dirty & ~scatter_set_bool(_zeros(tt), pr, prv & pr_dirty)
        dirty = dirty & ~scatter_set_bool(_zeros(tt), pw, pwv & pw_dirty)
        present = present & ~scatter_set_bool(_zeros(tt), pw, pwv)

        pim_ns = (_pim_compute_ns(tt, hw, w)
                  + _pim_mem_ns(tt, hw, w, extra_per_miss=rt_ns)
                  + xfer_lines * LINE_BYTES / hw.offchip_bw_gbs)
        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = (out.fill_bytes + _priv_fill_bytes(tt, w) + msg_bytes
                 + xfer_lines * LINE_BYTES)
        t_w = torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
        dram_w = out.fill_bytes + _priv_fill_bytes(tt, w) + _pim_dram_bytes(tt, w)

        l1_w = _cpu_dyn_count(tt, w) + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = out.misses + out.hits + tt.pim_uniq[:, w]
        return (present, dirty, t + t_w, off + off_w, dram + dram_w,
                l1 + l1_w, l2 + l2_w)

    init = (_zeros(tt), _zeros(tt)) + (_f0(tt),) * 5
    _, _, t, off, dram, l1, l2 = _loop(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


def _cg_acc_bool(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2, flushed, blocked = carry
        present, dirty = _start_kernel_bool(tt, w, present, dirty)
        start = tt.kernel_start[:, w]

        n_flush = torch.where(start, dirty.sum(1), 0).to(torch.float32)
        flush_bytes = n_flush * LINE_BYTES
        flush_ns = (flush_bytes / hw.offchip_bw_gbs
                    + torch.where(start, hw.offchip_msg_ns, 0.0))
        dirty = _sel(start, torch.zeros_like(dirty), dirty)
        present = _sel(start, torch.zeros_like(present), present)

        n_acc = _cpu_acc_count(tt, w)
        n_dyn = n_acc * tt.cpu_reuse
        replay_ns = (n_acc * hw.offchip_mem_ns / hw.cpu_mlp
                     + n_acc * (tt.cpu_reuse - 1.0) * hw.l2_hit_ns) / hw.cpu_cores
        deferred_fill = n_acc * LINE_BYTES

        present = scatter_set_bool(present, tt.cpu_reads[:, w], tt.cpu_r_valid[:, w])
        present = scatter_set_bool(present, tt.cpu_writes[:, w], tt.cpu_w_valid[:, w])
        dirty = scatter_set_bool(dirty, tt.cpu_writes[:, w], tt.cpu_w_valid[:, w])

        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        serial_ns = replay_ns + 0.75 * _cpu_compute_ns(tt, hw, w)
        overlap_ns = 0.25 * _cpu_compute_ns(tt, hw, w) + _priv_mem_ns(tt, hw, w)
        off_w = flush_bytes + deferred_fill + _priv_fill_bytes(tt, w)
        t_w = (torch.maximum(torch.maximum(pim_ns, overlap_ns) + serial_ns,
                             _bw_bound_ns(hw, off_w))
               + flush_ns)
        dram_w = off_w + _pim_dram_bytes(tt, w)

        l1_w = n_dyn + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = n_dyn + n_flush
        return (present, dirty, t + t_w, off + off_w, dram + dram_w,
                l1 + l1_w, l2 + l2_w, flushed + n_flush, blocked + n_dyn)

    init = (_zeros(tt), _zeros(tt)) + (_f0(tt),) * 7
    _, _, t, off, dram, l1, l2, flushed, blocked = _loop(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2,
                flush_lines=flushed, blocked_accesses=blocked)


def _nc_acc_bool(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        t, off, dram, l1, l2 = carry
        out = cpu_cache_step_bool(tt, hw, _zeros(tt), _zeros(tt), w,
                                  cacheable=False)
        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = out.fill_bytes + _priv_fill_bytes(tt, w)
        t_w = torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
        dram_w = (out.fill_bytes * hw.nc_dram_energy_factor
                  + _priv_fill_bytes(tt, w) + _pim_dram_bytes(tt, w))
        l1_w = _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = torch.zeros_like(l1_w)
        return (t + t_w, off + off_w, dram + dram_w, l1 + l1_w, l2 + l2_w)

    t, off, dram, l1, l2 = _loop(tt, step, (_f0(tt),) * 5)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


# ---------------------------------------------------------------------------
# LazyPIM (seed boolean protocol state)
# ---------------------------------------------------------------------------


def _lazypim_acc_bool(tt: TraceTensors, hw: HWParams, cfg: LazyPIMConfig):
    if cfg.cpuws_regs != CPUWS_REGS:
        raise NotImplementedError(
            f"cpuws_regs={cfg.cpuws_regs} != trace register assignment "
            f"({CPUWS_REGS})")
    n = tt.num_lines
    sig_bytes_per_commit = 2.0 * tt.sig_bits / 8.0  # PIMReadSet + PIMWriteSet
    dbi_interval_ns = cfg.dbi_interval_cycles / hw.freq_ghz

    def conflict(bitmap, read_bits):
        return conflict_any_bool(
            tt, read_bits, bank_bits_from_bitmap_bool(tt, bitmap, cfg.cpuws_regs))

    def step(carry, w):
        (present, dirty, cpuws, conc, read_bm, read_bits, write_bits,
         replay_ns, dbi_t, acc) = carry
        start = tt.kernel_start[:, w]
        present, dirty = _start_kernel_bool(tt, w, present, dirty)
        dirty_before = dirty

        out = cpu_cache_step_bool(tt, hw, present, dirty, w)
        present, dirty = out.present, out.dirty

        cw_bm = scatter_set_bool(_zeros(tt), tt.cpu_writes[:, w],
                                 tt.cpu_w_valid[:, w])
        if cfg.partial_commits:
            cpuws = dirty_before | cw_bm
            conc = cw_bm
        else:
            cpuws = _sel(start, dirty_before, cpuws) | cw_bm
            conc = _sel(start, cw_bm, conc | cw_bm)

        r_bits_w, w_bits_w = sig_bits_pair_from_ids_bool(
            tt, tt.pim_reads[:, w], tt.pim_r_valid[:, w], tt.pim_writes[:, w],
            tt.pim_w_valid[:, w])
        r_bm_w = scatter_set_bool(_zeros(tt), tt.pim_reads[:, w], tt.pim_r_valid[:, w])
        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        replay_cheap = _pim_compute_ns(tt, hw, w) + (
            tt.pim_uniq_w[:, w] * hw.pim_mem_ns / hw.pim_cores)
        if cfg.partial_commits:
            read_bits, write_bits, read_bm = r_bits_w, w_bits_w, r_bm_w
            replay_ns = replay_cheap
            commit = torch.ones_like(start)
        else:
            read_bits = _sel(start, r_bits_w, read_bits | r_bits_w)
            write_bits = _sel(start, w_bits_w, write_bits | w_bits_w)
            read_bm = _sel(start, r_bm_w, read_bm | r_bm_w)
            replay_ns = torch.where(start, replay_cheap, replay_ns + replay_cheap)
            commit = tt.kernel_end[:, w]

        c1 = conflict(cpuws, read_bits) & commit
        exact = (cpuws & read_bm).any(1) & commit
        c2 = conflict(conc, read_bits)
        rollbacks = torch.where(c1, 1.0 + torch.where(c2, 1.0, 0.0), 0.0)

        flush_mask = members_bool(tt, dirty, read_bits) & c1[:, None]
        n_flush1 = flush_mask.sum(1).to(torch.float32)
        n_flush_conc = members_bool(tt, conc, read_bits).sum(1).to(torch.float32)
        n_flush = n_flush1 + torch.clamp(rollbacks - 1.0, min=0.0) * n_flush_conc
        dirty = dirty & ~flush_mask

        flush_bytes = n_flush * LINE_BYTES
        refetch_ns = n_flush * hw.pim_mem_ns / hw.pim_cores
        rollback_ns = rollbacks * (replay_ns + refetch_ns
                                   + 2.0 * hw.offchip_msg_ns
                                   + sig_bytes_per_commit / hw.offchip_bw_gbs)
        rollback_ns = rollback_ns + flush_bytes / hw.offchip_bw_gbs

        merge_mask = members_bool(tt, dirty, write_bits) & commit[:, None]
        n_merge = merge_mask.sum(1).to(torch.float32)
        inv_mask = members_bool(tt, present, write_bits) & commit[:, None]
        present = present & ~inv_mask
        dirty = dirty & ~merge_mask

        attempts = torch.where(commit, 1.0 + rollbacks, 0.0)
        commit_bytes = (attempts * (sig_bytes_per_commit + 2.0 * CTRL_BYTES)
                        + n_merge * LINE_BYTES)
        commit_ns = torch.where(
            commit,
            cfg.commit_exposure * (2.0 * hw.offchip_msg_ns
                                   + sig_bytes_per_commit / hw.offchip_bw_gbs),
            0.0)

        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = (out.fill_bytes + _priv_fill_bytes(tt, w) + commit_bytes
                 + flush_bytes)
        t_w = (torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
               + commit_ns + rollback_ns)
        dram_w = (out.fill_bytes + _priv_fill_bytes(tt, w) + _pim_dram_bytes(tt, w)
                  + flush_bytes + n_merge * LINE_BYTES)

        dbi_t = dbi_t + t_w
        fire = cfg.use_dbi & (dbi_t > dbi_interval_ns)
        n_dirty = dirty.sum(1).to(torch.float32)
        frac = (cfg.dbi_lines_per_fire / torch.clamp(n_dirty, min=1.0)).clamp(0.0, 1.0)
        u = line_window_u01(n, w, XXH_PRIME2, XXH_PRIME5, tt.device)
        drain = dirty & (u[None, :] < frac[:, None]) & fire[:, None]
        n_dbi = drain.sum(1).to(torch.float32)
        dirty = dirty & ~drain
        dbi_t = torch.where(fire, 0.0, dbi_t)
        off_w = off_w + n_dbi * LINE_BYTES
        dram_w = dram_w + n_dbi * LINE_BYTES

        l1_w = _cpu_dyn_count(tt, w) + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = out.misses + out.hits + n_flush + n_dbi
        acc = dict(
            time_ns=acc["time_ns"] + t_w,
            offchip_bytes=acc["offchip_bytes"] + off_w,
            dram_bytes=acc["dram_bytes"] + dram_w,
            l1_accesses=acc["l1_accesses"] + l1_w,
            l2_accesses=acc["l2_accesses"] + l2_w,
            commits=acc["commits"] + torch.where(commit, 1.0, 0.0),
            conflicts_sig=acc["conflicts_sig"] + torch.where(c1, 1.0, 0.0),
            conflicts_exact=acc["conflicts_exact"] + torch.where(exact, 1.0, 0.0),
            rollbacks=acc["rollbacks"] + rollbacks,
            flush_lines=acc["flush_lines"] + n_flush,
            dbi_writebacks=acc["dbi_writebacks"] + n_dbi,
            sig_bytes=acc["sig_bytes"] + attempts * sig_bytes_per_commit,
        )
        read_bits = _sel(commit, torch.zeros_like(read_bits), read_bits)
        write_bits = _sel(commit, torch.zeros_like(write_bits), write_bits)
        read_bm = _sel(commit, torch.zeros_like(read_bm), read_bm)
        conc = _sel(commit, torch.zeros_like(conc), conc)
        cpuws = _sel(commit, torch.zeros_like(cpuws), cpuws)
        replay_ns = torch.where(commit, 0.0, replay_ns)
        return (present, dirty, cpuws, conc, read_bm, read_bits, write_bits,
                replay_ns, dbi_t, acc)

    acc0 = {k: _f0(tt) for k in (
        "time_ns", "offchip_bytes", "dram_bytes", "l1_accesses", "l2_accesses",
        "commits", "conflicts_sig", "conflicts_exact", "rollbacks",
        "flush_lines", "dbi_writebacks", "sig_bytes")}
    no_bits = torch.zeros((_lanes(tt), tt.sig_bits), dtype=torch.bool,
                          device=tt.device)
    init = ((_zeros(tt),) * 5 + (no_bits, no_bits, _f0(tt), _f0(tt), acc0))
    return _loop(tt, step, init)[-1]


# ---------------------------------------------------------------------------
# Entry points: one trace, the one-lane case of the packed engine's records
# ---------------------------------------------------------------------------


ACC_FNS_BOOL = {
    "cpu": _cpu_only_acc_bool,
    "ideal": _ideal_acc_bool,
    "fg": _fg_acc_bool,
    "cg": _cg_acc_bool,
    "nc": _nc_acc_bool,
}


def _simulate(tt: TraceTensors, hw: HWParams, mechanism: str,
              cfg: LazyPIMConfig | None = None) -> SimResult:
    dev = tt.device
    stt = stack_traces([neutral_trace(tt)])
    shw = stack_hw([hw], dev)
    if mechanism == "lazypim":
        acc = _lazypim_acc_bool(stt, shw, stack_lazy([cfg or LazyPIMConfig()], dev))
    else:
        acc = ACC_FNS_BOOL[mechanism](stt, shw)
    return finalize_result(tt.name, mechanism, {k: v[0] for k, v in acc.items()})


def simulate_cpu_only_bool(tt: TraceTensors, hw: HWParams) -> SimResult:
    return _simulate(tt, hw, "cpu")


def simulate_ideal_bool(tt: TraceTensors, hw: HWParams) -> SimResult:
    return _simulate(tt, hw, "ideal")


def simulate_fg_bool(tt: TraceTensors, hw: HWParams) -> SimResult:
    return _simulate(tt, hw, "fg")


def simulate_cg_bool(tt: TraceTensors, hw: HWParams) -> SimResult:
    return _simulate(tt, hw, "cg")


def simulate_nc_bool(tt: TraceTensors, hw: HWParams) -> SimResult:
    return _simulate(tt, hw, "nc")


def simulate_lazypim_bool(tt: TraceTensors, hw: HWParams,
                          cfg: LazyPIMConfig | None = None) -> SimResult:
    return _simulate(tt, hw, "lazypim", cfg)


def run_all_bool(tt: TraceTensors, hw: HWParams | None = None,
                 mechanisms: tuple[str, ...] = MECHANISMS,
                 lazy_cfg: LazyPIMConfig | None = None) -> dict[str, SimResult]:
    """Every mechanism on one prepared trace through the seed engine, on
    the trace's device (``prepare(..., device="cpu")`` for the CPU)."""
    hw = hw or HWParams()
    return {m: _simulate(tt, hw, m, lazy_cfg) for m in mechanisms}
