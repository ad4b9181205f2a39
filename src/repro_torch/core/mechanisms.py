"""Baseline PIM coherence mechanisms (paper §3.2, §7), PyTorch port of
:mod:`repro.core.mechanisms`.

* ``cpu``   — the whole application runs on the processor.
* ``ideal`` — PIM execution with zero coherence penalty (upper bound).
* ``fg``    — fine-grained MESI: every PIM L1 miss queries the processor
  directory over the off-chip link; dirty lines ping-pong.
* ``cg``    — coarse-grained locks: every kernel launch flushes all dirty
  PIM-region lines and blocks processor accesses for the kernel.
* ``nc``    — PIM data non-cacheable in the processor.

Each ``*_acc`` function runs one mechanism's window loop over a *stacked*
trace (every tensor field carries a leading lane axis, see
``repro_torch.sim.engine.stack_traces``) with stacked ``HWParams`` leaves
of shape (L,), and returns the float32 accumulators per lane.  The
reference's ``lax.scan`` is a Python loop over windows, its ``vmap`` the
lane axis; the arithmetic, its order and its float32 rounding are the
reference's.  LazyPIM itself lives in :mod:`repro_torch.core.coherence`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sim.costmodel import CTRL_BYTES, LINE_BYTES, HWParams
from repro_torch.sim.prep import (
    TraceTensors,
    cpu_cache_step,
    gather_hits,
    popcount_words,
    scatter_set,
)

__all__ = [
    "SimResult",
    "ResultIntegrityError",
    "finalize_result",
    "simulate_cpu_only",
    "simulate_ideal",
    "simulate_fg",
    "simulate_cg",
    "simulate_nc",
    "ACC_FNS",
]


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Aggregated metrics for one (trace, mechanism) simulation."""

    name: str
    mechanism: str
    time_ns: float
    offchip_bytes: float
    dram_bytes: float
    l1_accesses: float
    l2_accesses: float
    commits: float = 0.0
    conflicts_sig: float = 0.0
    conflicts_exact: float = 0.0
    rollbacks: float = 0.0
    flush_lines: float = 0.0
    blocked_accesses: float = 0.0
    dbi_writebacks: float = 0.0
    sig_bytes: float = 0.0

    def energy_pj(self, hw: HWParams) -> dict[str, float]:
        cache = (self.l1_accesses * hw.l1_pj_per_access
                 + self.l2_accesses * hw.l2_pj_per_access
                 + self.dbi_writebacks * hw.dbi_pj_per_access)
        dram = self.dram_bytes * 8.0 * hw.dram_pj_per_bit
        off = self.offchip_bytes * 8.0 * (hw.serdes_pj_per_bit
                                          + hw.link_pj_per_bit)
        return {"cache": cache, "dram": dram, "offchip": off,
                "total": cache + dram + off}

    @property
    def conflict_rate(self) -> float:
        return self.conflicts_sig / max(self.commits, 1.0)

    @property
    def conflict_rate_exact(self) -> float:
        return self.conflicts_exact / max(self.commits, 1.0)


class ResultIntegrityError(ValueError):
    """A finalized accumulator is NaN/Inf or negative.  Every accumulator
    is a sum of non-negative float32 terms, so this means the execution
    was corrupted, not that the simulation produced an odd number."""


def finalize_result(name: str, mechanism: str, acc: dict) -> SimResult:
    """THE accumulator -> ``SimResult`` constructor of every engine, with
    the NaN/Inf/negative integrity sentinel."""
    vals = {k: float(v) for k, v in acc.items()}
    for k, v in vals.items():
        if not math.isfinite(v) or v < 0.0:
            raise ResultIntegrityError(
                f"integrity sentinel: {name or '<unnamed>'}/{mechanism} "
                f"{k}={v!r} (NaN/Inf/negative — corrupted execution, not a "
                f"valid simulation result)")
    return SimResult(name=name, mechanism=mechanism, **vals)


# ---------------------------------------------------------------------------
# Lane helpers
# ---------------------------------------------------------------------------


def _lanes(tt: TraceTensors) -> int:
    return tt.window_valid.shape[0]


def _zwords(tt: TraceTensors) -> torch.Tensor:
    """Empty packed line bitmaps (L, num_line_words)."""
    return torch.zeros((_lanes(tt), tt.num_line_words), dtype=torch.int32,
                       device=tt.device)


def _f0(tt: TraceTensors) -> torch.Tensor:
    """A zero float32 accumulator per lane."""
    return torch.zeros((_lanes(tt),), dtype=torch.float32, device=tt.device)


def _sel(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select: ``cond`` (L,) broadcast over the trailing axes."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _mask_step(tt: TraceTensors, w: int, old_carry, new_carry):
    """Padding-aware window step: on a window appended by ``pad_trace``
    (``window_valid`` False) the whole carry, accumulators included, passes
    through unchanged."""
    v = tt.window_valid[:, w]
    if isinstance(new_carry, dict):
        return {k: _mask_step(tt, w, old_carry[k], new_carry[k])
                for k in new_carry}
    if isinstance(new_carry, (tuple, list)):
        return type(new_carry)(_mask_step(tt, w, o, n)
                               for o, n in zip(old_carry, new_carry))
    return _sel(v, new_carry, old_carry)


def _pre_words(tt: TraceTensors, w: int) -> torch.Tensor:
    """Each lane's pre-write bitmap of the kernel running in window ``w``."""
    k = tt.kernel_id[:, w].to(torch.int64)
    lanes = torch.arange(_lanes(tt), device=tt.device)
    return tt.pre_writes_words[lanes, k]


def _start_kernel(tt: TraceTensors, w: int, present, dirty):
    """The inter-kernel processor phase dirties lines before a launch."""
    start = tt.kernel_start[:, w]
    pre = _pre_words(tt, w)
    return _sel(start, present | pre, present), _sel(start, dirty | pre, dirty)


# ---------------------------------------------------------------------------
# Shared per-window terms
# ---------------------------------------------------------------------------


def _pim_compute_ns(tt, hw, w):
    return tt.pim_instr[:, w] / (hw.pim_cores * hw.pim_ipc * hw.freq_ghz)


def _pim_mem_ns(tt, hw, w, extra_per_miss=None):
    per = hw.pim_mem_ns if extra_per_miss is None else hw.pim_mem_ns + extra_per_miss
    return tt.pim_uniq[:, w] * per / hw.pim_cores


def _cpu_compute_ns(tt, hw, w):
    return tt.cpu_instr[:, w] / (hw.cpu_cores * hw.cpu_ipc * hw.freq_ghz)


def _priv_mem_ns(tt, hw, w):
    mr = tt.cpu_priv_miss_rate
    per = mr * hw.offchip_mem_ns + (1.0 - mr) * hw.l1_hit_ns
    return tt.cpu_priv[:, w] * per / hw.cpu_cores


def _priv_fill_bytes(tt, w):
    return tt.cpu_priv[:, w] * tt.cpu_priv_miss_rate * LINE_BYTES


def _pim_dram_bytes(tt, w):
    """Internal (TSV) DRAM traffic of the PIM kernel itself."""
    return (tt.pim_uniq[:, w] + tt.pim_uniq_w[:, w]) * LINE_BYTES


def _cpu_acc_count(tt, w):
    return (tt.cpu_r_valid[:, w].sum(1)
            + tt.cpu_w_valid[:, w].sum(1)).to(torch.float32)


def _cpu_dyn_count(tt, w):
    return _cpu_acc_count(tt, w) * tt.cpu_reuse


def _pim_acc_count(tt, w):
    return (tt.pim_r_valid[:, w].sum(1)
            + tt.pim_w_valid[:, w].sum(1)).to(torch.float32)


def _bw_bound_ns(hw, offchip_bytes):
    return offchip_bytes / hw.offchip_bw_gbs


def _scan(tt: TraceTensors, step, init):
    """The reference's ``lax.scan`` over windows, padding-aware."""
    carry = init
    for w in range(tt.num_windows):
        carry = _mask_step(tt, w, carry, step(carry, w))
    return carry


# ---------------------------------------------------------------------------
# CPU-only
# ---------------------------------------------------------------------------


def _cpu_only_acc(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2 = carry
        present, dirty = _start_kernel(tt, w, present, dirty)
        out = cpu_cache_step(tt, hw, present, dirty, w,
                             cap_lines=hw.cpu_only_cache_cap)
        # Kernel phase on the processor: issue-limited at CPU width, its
        # memory-bound accesses stream off-chip.
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

    init = (_zwords(tt), _zwords(tt), _f0(tt), _f0(tt), _f0(tt), _f0(tt),
            _f0(tt))
    _, _, t, off, dram, l1, l2 = _scan(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


# ---------------------------------------------------------------------------
# Ideal-PIM
# ---------------------------------------------------------------------------


def _ideal_acc(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2 = carry
        present, dirty = _start_kernel(tt, w, present, dirty)
        out = cpu_cache_step(tt, hw, present, dirty, w)
        # PIM writes refresh CPU copies for free (ideal): invalidation
        # without any message cost.
        pim_w = scatter_set(_zwords(tt), tt.pim_writes[:, w],
                            tt.pim_w_valid[:, w], tt.num_lines)
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

    init = (_zwords(tt), _zwords(tt), _f0(tt), _f0(tt), _f0(tt), _f0(tt),
            _f0(tt))
    _, _, t, off, dram, l1, l2 = _scan(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


# ---------------------------------------------------------------------------
# Fine-grained MESI (FG)
# ---------------------------------------------------------------------------


def _fg_acc(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2 = carry
        present, dirty = _start_kernel(tt, w, present, dirty)
        out = cpu_cache_step(tt, hw, present, dirty, w)
        present, dirty = out.present, out.dirty

        # Every PIM miss consults the processor directory off-chip.
        rt_ns = hw.fg_msg_exposed_ns
        msg_bytes = tt.pim_uniq[:, w] * 8.0 * CTRL_BYTES

        # PIM reads/writes of CPU-dirty lines transfer the line off-chip
        # and move ownership to PIM.
        pr, prv = tt.pim_reads[:, w], tt.pim_r_valid[:, w]
        pw, pwv = tt.pim_writes[:, w], tt.pim_w_valid[:, w]
        pr_dirty = gather_hits(dirty, pr, prv)
        pw_dirty = gather_hits(dirty, pw, pwv)
        xfer_lines = (pr_dirty.sum(1) + pw_dirty.sum(1)).to(torch.float32)
        dirty = dirty & ~scatter_set(_zwords(tt), pr, prv & pr_dirty, tt.num_lines)
        dirty = dirty & ~scatter_set(_zwords(tt), pw, pwv & pw_dirty, tt.num_lines)
        # PIM exclusive writes invalidate CPU copies.
        pim_w = scatter_set(_zwords(tt), pw, pwv, tt.num_lines)
        present = present & ~pim_w

        pim_ns = (_pim_compute_ns(tt, hw, w)
                  + _pim_mem_ns(tt, hw, w, extra_per_miss=rt_ns)
                  + xfer_lines * LINE_BYTES / hw.offchip_bw_gbs)
        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = (out.fill_bytes + _priv_fill_bytes(tt, w) + msg_bytes
                 + xfer_lines * LINE_BYTES)
        t_w = torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
        dram_w = out.fill_bytes + _priv_fill_bytes(tt, w) + _pim_dram_bytes(tt, w)

        l1_w = _cpu_dyn_count(tt, w) + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = out.misses + out.hits + tt.pim_uniq[:, w]  # directory lookups
        return (present, dirty, t + t_w, off + off_w, dram + dram_w,
                l1 + l1_w, l2 + l2_w)

    init = (_zwords(tt), _zwords(tt), _f0(tt), _f0(tt), _f0(tt), _f0(tt),
            _f0(tt))
    _, _, t, off, dram, l1, l2 = _scan(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


# ---------------------------------------------------------------------------
# Coarse-grained locks (CG)
# ---------------------------------------------------------------------------


def _cg_acc(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        present, dirty, t, off, dram, l1, l2, flushed, blocked = carry
        present, dirty = _start_kernel(tt, w, present, dirty)
        start = tt.kernel_start[:, w]

        # Kernel launch: flush EVERY dirty line in the region, invalidate all.
        n_flush = torch.where(start, popcount_words(dirty), 0).to(torch.float32)
        flush_bytes = n_flush * LINE_BYTES
        flush_ns = (flush_bytes / hw.offchip_bw_gbs
                    + torch.where(start, hw.offchip_msg_ns, 0.0))
        dirty = _sel(start, torch.zeros_like(dirty), dirty)
        present = _sel(start, torch.zeros_like(present), present)

        # Region locked: thread work serializes behind the kernel and the
        # blocked accesses replay as misses (§3.2).
        n_acc = _cpu_acc_count(tt, w)
        n_dyn = n_acc * tt.cpu_reuse
        replay_ns = (n_acc * hw.offchip_mem_ns / hw.cpu_mlp
                     + n_acc * (tt.cpu_reuse - 1.0) * hw.l2_hit_ns) / hw.cpu_cores
        deferred_fill = n_acc * LINE_BYTES

        # The replayed accesses repopulate the cache and re-dirty lines the
        # next launch flushes again (the CG flush/refetch ping-pong).
        present = scatter_set(present, tt.cpu_reads[:, w], tt.cpu_r_valid[:, w],
                              tt.num_lines)
        present = scatter_set(present, tt.cpu_writes[:, w], tt.cpu_w_valid[:, w],
                              tt.num_lines)
        dirty = scatter_set(dirty, tt.cpu_writes[:, w], tt.cpu_w_valid[:, w],
                            tt.num_lines)

        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        serial_ns = replay_ns + 0.75 * _cpu_compute_ns(tt, hw, w)
        overlap_ns = 0.25 * _cpu_compute_ns(tt, hw, w) + _priv_mem_ns(tt, hw, w)
        off_w = flush_bytes + deferred_fill + _priv_fill_bytes(tt, w)
        t_w = (torch.maximum(torch.maximum(pim_ns, overlap_ns) + serial_ns,
                             _bw_bound_ns(hw, off_w))
               + flush_ns)
        dram_w = off_w + _pim_dram_bytes(tt, w)

        l1_w = n_dyn + _pim_acc_count(tt, w) + tt.cpu_priv[:, w]
        l2_w = n_dyn + n_flush  # flush scans + replayed misses
        return (present, dirty, t + t_w, off + off_w, dram + dram_w,
                l1 + l1_w, l2 + l2_w, flushed + n_flush, blocked + n_dyn)

    init = (_zwords(tt), _zwords(tt), _f0(tt), _f0(tt), _f0(tt), _f0(tt),
            _f0(tt), _f0(tt), _f0(tt))
    _, _, t, off, dram, l1, l2, flushed, blocked = _scan(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2,
                flush_lines=flushed, blocked_accesses=blocked)


# ---------------------------------------------------------------------------
# Non-cacheable PIM data (NC)
# ---------------------------------------------------------------------------


def _nc_acc(tt: TraceTensors, hw: HWParams):
    def step(carry, w):
        t, off, dram, l1, l2 = carry
        out = cpu_cache_step(tt, hw, _zwords(tt), _zwords(tt), w,
                             cacheable=False)
        pim_ns = _pim_compute_ns(tt, hw, w) + _pim_mem_ns(tt, hw, w)
        cpu_ns = _cpu_compute_ns(tt, hw, w) + out.mem_ns + _priv_mem_ns(tt, hw, w)
        off_w = out.fill_bytes + _priv_fill_bytes(tt, w)
        t_w = torch.maximum(torch.maximum(pim_ns, cpu_ns), _bw_bound_ns(hw, off_w))
        # Every NC access re-activates a DRAM row: activation energy factor.
        dram_w = (out.fill_bytes * hw.nc_dram_energy_factor
                  + _priv_fill_bytes(tt, w) + _pim_dram_bytes(tt, w))
        l1_w = _pim_acc_count(tt, w) + tt.cpu_priv[:, w]  # CPU bypasses L1
        l2_w = torch.zeros_like(l1_w)
        return (t + t_w, off + off_w, dram + dram_w, l1 + l1_w, l2 + l2_w)

    init = (_f0(tt), _f0(tt), _f0(tt), _f0(tt), _f0(tt))
    t, off, dram, l1, l2 = _scan(tt, step, init)
    return dict(time_ns=t, offchip_bytes=off, dram_bytes=dram,
                l1_accesses=l1, l2_accesses=l2)


def _simulate(tt: TraceTensors, hw: HWParams, mechanism: str, device) -> SimResult:
    # the engine imports this module: import it at call time
    from repro_torch.sim.engine import run_mechanism

    return run_mechanism(tt, hw, mechanism, device=device)


def simulate_cpu_only(tt: TraceTensors, hw: HWParams, device=None) -> SimResult:
    """The reference's per-mechanism entry points, each one trace through one
    window loop (``engine.run_mechanism``); ``device=None`` means the CUDA
    card, and the trace must live on ``device``."""
    return _simulate(tt, hw, "cpu", device)


def simulate_ideal(tt: TraceTensors, hw: HWParams, device=None) -> SimResult:
    return _simulate(tt, hw, "ideal", device)


def simulate_fg(tt: TraceTensors, hw: HWParams, device=None) -> SimResult:
    return _simulate(tt, hw, "fg", device)


def simulate_cg(tt: TraceTensors, hw: HWParams, device=None) -> SimResult:
    return _simulate(tt, hw, "cg", device)


def simulate_nc(tt: TraceTensors, hw: HWParams, device=None) -> SimResult:
    return _simulate(tt, hw, "nc", device)


# Window-loop accumulators keyed by mechanism name (LazyPIM's lives in
# ``repro_torch.core.coherence``).
ACC_FNS = {
    "cpu": _cpu_only_acc,
    "ideal": _ideal_acc,
    "fg": _fg_acc,
    "cg": _cg_acc,
    "nc": _nc_acc,
}
