"""LazyPIM: speculative coherence with compressed signatures (paper §4–§5),
PyTorch port of :mod:`repro.core.coherence`.

Per partial-kernel window the PIM kernel runs speculatively and records
its reads/writes in the ``PIMReadSet``/``PIMWriteSet`` Bloom signatures;
the processor records dirty PIM-region lines at kernel start plus its
concurrent writes in the ``CPUWriteSet`` bank (16 x 2 Kbit).  At commit the
signatures are intersected: a conflict flushes the matching dirty lines
(with real false positives) and rolls the kernel back; a clean commit
merges WAW lines and invalidates stale processor copies.  PIM-DBI (§5.6)
drains dirty lines every ``dbi_interval_cycles``.

**Kernels on the card.**  Every Bloom-signature operation of the step runs
on a hand-written CUDA kernel (:mod:`repro_torch.kernels.bloom.bloom`):

* the read/write images: one ``bloom_insert`` launch over the window's two
  id lists;
* the two conflict checks: the CPUWriteSet banks of the ``cpuws`` and
  ``conc`` bitmaps (one ``bloom_insert`` launch in bank mode for both)
  each intersected with the read image (``bloom_intersect``), any
  register — the unfused form of the reference's ``conflict_from_hits``,
  bit-exact with it;
* the flush / merge / invalidate membership masks: ``bloom_query``, two
  launches a window — ``(dirty, conc)`` against the read image before the
  flush, ``(dirty, present)`` against the write image after it — as the
  reference gathers each image once (``line_sig_hits``).

``partial_commits=False`` models the full-kernel-commit ablation of
Fig. 12 (one conflict check at kernel end, saturated filters).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.mechanisms import (
    SimResult,
    _bw_bound_ns,
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
    _scan,
    _sel,
    _start_kernel,
    _zwords,
)
from repro_torch.sim.costmodel import CTRL_BYTES, LINE_BYTES, HWParams
from repro_torch.sim.prep import (
    ALL_ONES,
    CPUWS_REGS,
    XXH_PRIME2,
    XXH_PRIME5,
    TraceTensors,
    bank_pair_from_bitmaps,
    conflict_any_pair,
    cpu_cache_step,
    line_window_u01,
    members_pair,
    pack_bitmap,
    popcount_words,
    scatter_set,
    sig_bits_pair_from_ids,
)

__all__ = ["LazyPIMConfig", "SimResult", "simulate_lazypim"]


@dataclasses.dataclass(frozen=True)
class LazyPIMConfig:
    """Protocol parameters (defaults = the paper's implementation, §5).

    ``partial_commits`` selects the dataflow (Fig. 12 ablation) and
    ``cpuws_regs``/``max_rollbacks`` are structural (static flags); the
    numeric knobs become per-lane tensors in the engines
    (``engine.stack_lazy``)."""

    partial_commits: bool = True
    use_dbi: bool = True
    # §7 uses 800 K cycles on full-length kernels; the traces subsample
    # kernels ~100x, so the interval compresses proportionally.
    dbi_interval_cycles: float = 1_600.0
    max_rollbacks: int = 3                  # §5.5: lock lines after 3
    cpuws_regs: int = 16                    # §5.7
    dbi_lines_per_fire: int = 128
    # Fraction of the commit round exposed on the critical path.
    commit_exposure: float = 0.15


def _lazypim_acc(tt: TraceTensors, hw: HWParams, cfg: LazyPIMConfig):
    """LazyPIM window loop over a stacked trace; ``hw``/``cfg`` carry (L,)
    tensors for their numeric fields and Python values for the static
    flags."""
    if cfg.cpuws_regs != CPUWS_REGS:
        # The bank groups lines by the static line % CPUWS_REGS assignment
        # baked into the trace's line_reg table.
        raise NotImplementedError(
            f"cpuws_regs={cfg.cpuws_regs} != trace register assignment "
            f"({CPUWS_REGS})")
    n = tt.num_lines
    sig_bytes_per_commit = 2.0 * tt.sig_bits / 8.0  # PIMReadSet + PIMWriteSet
    dbi_interval_ns = cfg.dbi_interval_cycles / hw.freq_ghz
    zero_f = _f0(tt)

    def step(carry, w):
        (present, dirty, cpuws, conc, read_bm, read_bits, write_bits,
         replay_ns, dbi_t, acc) = carry
        start = tt.kernel_start[:, w]
        present, dirty = _start_kernel(tt, w, present, dirty)
        dirty_before = dirty

        # --- concurrent CPU execution (fully cached under LazyPIM) ---------
        out = cpu_cache_step(tt, hw, present, dirty, w)
        present, dirty = out.present, out.dirty

        # --- signature recording -------------------------------------------
        cw_bm = scatter_set(_zwords(tt), tt.cpu_writes[:, w],
                            tt.cpu_w_valid[:, w], n)
        if cfg.partial_commits:
            cpuws = dirty_before | cw_bm
            conc = cw_bm
        else:
            cpuws = _sel(start, dirty_before, cpuws) | cw_bm
            conc = _sel(start, cw_bm, conc | cw_bm)

        r_bits_w, w_bits_w = sig_bits_pair_from_ids(
            tt, tt.pim_reads[:, w], tt.pim_r_valid[:, w], tt.pim_writes[:, w],
            tt.pim_w_valid[:, w])
        r_bm_w = scatter_set(_zwords(tt), tt.pim_reads[:, w],
                             tt.pim_r_valid[:, w], n)
        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        # Rollback replays run against a warm PIM L1: only the speculative
        # lines are refetched (§5.5).
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

        # --- commit / conflict detection ------------------------------------
        # Both conflict checks' CPUWriteSet banks from one launch, and both
        # checks from another.  Fresh concurrent writes (conc) can conflict
        # again during the replay; after max_rollbacks the conflicting lines
        # are locked (§5.5).
        bank_cpuws, bank_conc = bank_pair_from_bitmaps(tt, cpuws, conc, cfg.cpuws_regs)
        c1, c2 = conflict_any_pair(tt, read_bits, bank_cpuws, bank_conc)
        c1 = c1 & commit
        exact = ((cpuws & read_bm) != 0).any(1) & commit
        rollbacks = torch.where(c1, 1.0 + torch.where(c2, 1.0, 0.0), 0.0)

        c1_mask = torch.where(c1, ALL_ONES, 0).to(torch.int32)[:, None]
        dirty_read, conc_read = members_pair(tt, dirty, conc, read_bits)
        flush_mask = dirty_read & c1_mask
        n_flush1 = popcount_words(flush_mask).to(torch.float32)
        n_flush_conc = popcount_words(conc_read).to(torch.float32)
        n_flush = n_flush1 + torch.clamp(rollbacks - 1.0, min=0.0) * n_flush_conc
        dirty = dirty & ~flush_mask

        flush_bytes = n_flush * LINE_BYTES
        refetch_ns = n_flush * hw.pim_mem_ns / hw.pim_cores
        rollback_ns = rollbacks * (replay_ns + refetch_ns
                                   + 2.0 * hw.offchip_msg_ns
                                   + sig_bytes_per_commit / hw.offchip_bw_gbs)
        rollback_ns = rollback_ns + flush_bytes / hw.offchip_bw_gbs

        # Successful commit: WAW merge + clean-line invalidation + drain.
        commit_mask = torch.where(commit, ALL_ONES, 0).to(torch.int32)[:, None]
        dirty_written, present_written = members_pair(tt, dirty, present, write_bits)
        merge_mask = dirty_written & commit_mask
        n_merge = popcount_words(merge_mask).to(torch.float32)
        inv_mask = present_written & commit_mask
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

        # --- window timing ---------------------------------------------------
        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = (out.fill_bytes + _priv_fill_bytes(tt, w) + commit_bytes
                 + flush_bytes)
        t_w = (torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
               + commit_ns + rollback_ns)
        dram_w = (out.fill_bytes + _priv_fill_bytes(tt, w) + _pim_dram_bytes(tt, w)
                  + flush_bytes + n_merge * LINE_BYTES)

        # --- PIM-DBI (§5.6): opportunistic dirty writeback -------------------
        dbi_t = dbi_t + t_w
        fire = cfg.use_dbi & (dbi_t > dbi_interval_ns)
        n_dirty = popcount_words(dirty).to(torch.float32)
        frac = (cfg.dbi_lines_per_fire / torch.clamp(n_dirty, min=1.0)).clamp(0.0, 1.0)
        u = line_window_u01(n, w, XXH_PRIME2, XXH_PRIME5, tt.device)
        fire_mask = torch.where(fire, ALL_ONES, 0).to(torch.int32)[:, None]
        drain = dirty & pack_bitmap(u[None, :] < frac[:, None]) & fire_mask
        n_dbi = popcount_words(drain).to(torch.float32)
        dirty = dirty & ~drain
        dbi_t = torch.where(fire, 0.0, dbi_t)
        off_w = off_w + n_dbi * LINE_BYTES
        dram_w = dram_w + n_dbi * LINE_BYTES

        # --- accumulate -------------------------------------------------------
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
        # Reset the per-commit state after a successful commit.
        read_bits = _sel(commit, torch.zeros_like(read_bits), read_bits)
        write_bits = _sel(commit, torch.zeros_like(write_bits), write_bits)
        read_bm = _sel(commit, torch.zeros_like(read_bm), read_bm)
        conc = _sel(commit, torch.zeros_like(conc), conc)
        cpuws = _sel(commit, torch.zeros_like(cpuws), cpuws)
        replay_ns = torch.where(commit, 0.0, replay_ns)
        return (present, dirty, cpuws, conc, read_bm, read_bits, write_bits,
                replay_ns, dbi_t, acc)

    acc0 = {k: zero_f for k in (
        "time_ns", "offchip_bytes", "dram_bytes", "l1_accesses", "l2_accesses",
        "commits", "conflicts_sig", "conflicts_exact", "rollbacks",
        "flush_lines", "dbi_writebacks", "sig_bytes")}
    sig_zero = torch.zeros((_lanes(tt), tt.sig_words), dtype=torch.int32,
                           device=tt.device)
    init = (_zwords(tt), _zwords(tt), _zwords(tt), _zwords(tt), _zwords(tt),
            sig_zero, sig_zero, zero_f, zero_f, acc0)
    return _scan(tt, step, init)[-1]


def simulate_lazypim(tt: TraceTensors, hw: HWParams, cfg: LazyPIMConfig | None = None,
                     device=None) -> SimResult:
    """One trace through the LazyPIM window loop (``engine.run_mechanism``,
    the reference's entry point); ``device=None`` means the CUDA card."""
    from repro_torch.sim.engine import run_mechanism  # the engine imports this module

    return run_mechanism(tt, hw, "lazypim", cfg, device=device)
