"""Timing / traffic / energy cost model of the PIM coherence simulator
(PyTorch port of :mod:`repro.sim.costmodel`; the constants mirror Table 1
and §6.3 of the paper and are identical to the reference's).

``HWParams`` is a plain frozen dataclass of Python numbers.  The engines
turn it into tensors once per dispatch (``engine.stack_hw``) at the
declared leaf dtypes of :func:`hw_leaf_dtypes` — int32 counts and
capacities, float32 everything else — which is what the reference's jit
tracing computes in, so expressions such as ``pim_mem_ns / pim_cores`` round
in float32 exactly as there.
"""

from __future__ import annotations

import dataclasses

import torch

LINE_BYTES = 64
CTRL_BYTES = 8  # coherence request/ack packet payload

# Fields that stack as int32; every other field stacks as float32.
_HW_INT_FIELDS = frozenset({
    "cpu_cores", "pim_cores", "cpu_cache_lines", "pim_cache_lines",
    "thread_cache_cap", "cpu_only_cache_cap", "nc_bytes",
})


def hw_leaf_dtypes() -> dict[str, torch.dtype]:
    """Declared tensor dtype of every HWParams field."""
    return {f.name: torch.int32 if f.name in _HW_INT_FIELDS else torch.float32
            for f in dataclasses.fields(HWParams)}


@dataclasses.dataclass(frozen=True)
class HWParams:
    """Hardware constants.  Defaults model the paper's Table 1 system."""

    # --- compute ---
    cpu_cores: int = 16
    pim_cores: int = 16
    freq_ghz: float = 2.0
    cpu_ipc: float = 4.0
    pim_ipc: float = 0.8
    cpu_mlp: float = 4.0
    cpu_kernel_mlp: float = 1.8

    # --- memory timing (ns) ---
    l1_hit_ns: float = 0.5
    l2_hit_ns: float = 5.0
    offchip_mem_ns: float = 110.0
    pim_mem_ns: float = 48.0
    offchip_msg_ns: float = 25.0
    fg_msg_exposed_ns: float = 20.0

    # --- bandwidth (GB/s) ---
    offchip_bw_gbs: float = 32.0
    internal_bw_gbs: float = 160.0

    # --- energy (pJ) ---
    serdes_pj_per_bit: float = 3.0
    dram_pj_per_bit: float = 4.0
    link_pj_per_bit: float = 3.5
    l1_pj_per_access: float = 25.0
    l2_pj_per_access: float = 120.0
    dbi_pj_per_access: float = 10.0

    # --- cache geometry (in 64 B lines) ---
    cpu_cache_lines: int = 32768
    pim_cache_lines: int = 1024
    thread_cache_cap: int = 16384
    cpu_only_cache_cap: int = 4096
    nc_bytes: int = 32
    nc_dram_energy_factor: float = 3.0

    def cycles_to_ns(self, cycles: float) -> float:
        return cycles / self.freq_ghz

    def compute_ns(self, instrs, cores, ipc):
        """Issue-limited execution time of ``instrs`` split across ``cores``."""
        return instrs / (cores * ipc * self.freq_ghz)

    def offchip_transfer_ns(self, num_bytes):
        """Bandwidth-limited off-chip transfer time (bytes / (GB/s) == ns)."""
        return num_bytes / self.offchip_bw_gbs

    def internal_transfer_ns(self, num_bytes):
        return num_bytes / self.internal_bw_gbs


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    cache_pj: float
    dram_pj: float
    offchip_pj: float

    @property
    def total_pj(self) -> float:
        return self.cache_pj + self.dram_pj + self.offchip_pj


def offchip_energy_pj(hw: HWParams, num_bytes):
    return num_bytes * 8.0 * hw.serdes_pj_per_bit


def dram_energy_pj(hw: HWParams, num_bytes):
    return num_bytes * 8.0 * hw.dram_pj_per_bit


def cache_energy_pj(hw: HWParams, l1_accesses, l2_accesses):
    return l1_accesses * hw.l1_pj_per_access + l2_accesses * hw.l2_pj_per_access
