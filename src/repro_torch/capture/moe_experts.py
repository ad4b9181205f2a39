"""MoE expert-table capture — the multi-tenant analogue on live routing,
PyTorch port of :mod:`repro.capture.moe_experts`.

Records expert-parameter traffic from the *real* router: token embeddings
flow through :func:`repro_torch.models.moe._routing` (the same top-k +
normalization the MoE block runs) and :func:`repro_torch.models.moe.
cumsum_rank` (the rank helper of the block's cumsum dispatch) with the
Switch/GShard capacity drop, on the chosen device, and the resulting
(expert, rank) assignments drive the line streams — no model math is
changed, the integer id tensors the block already computes for its
gathers/scatters are the capture.

Two tenants alternate kernels over one shared expert table (the mtmix
analogue): the active tenant's PIM kernel gathers its routed experts'
weight lines and scatters kept tokens into the capacity buffer, while the
*inactive* tenant's processor threads prefetch the experts its own last
kernel routed to and update its stats — cross-tenant CPU traffic aliasing
into the active kernel's PIMReadSet.  Routing distributions *shift*: each
tenant's router bias drifts per kernel (counter-PRNG driven), so the hot
expert set moves — the inter-kernel host phase writes the previous
kernel's hottest experts (optimizer update), which is the next kernel's
pre-write set.

The router and embedding parameters are the reference's own draws
(``jax.random.normal`` from the model seed), regenerated bit for bit in
numpy by :mod:`repro_torch.sim._jaxrandom`; the stream draws are the
counter-PRNG's (:mod:`.streams`).  The trace depends on the parameters
only through the integer routing (``top_e``, ``rank``); at the seeds and
scales ``tests/test_torch_moe_capture.py`` checks, the gates of adjacent
picks differ by hundreds of float32 ulps, far more than the rounding of the
router product on either device, and the trace equals the reference's
field by field.

Line layout: ``experts`` (E × lines/expert weight blocks), ``buffer``
(E × capacity scatter slots), ``router`` (router weights), ``emb``
(1 line per embedding row), ``stats`` (per-tenant counters).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.capture.layout import LineLayout
from repro_torch.capture.recorder import WindowRecorder
from repro_torch.capture.streams import Stream, perm
from repro_torch.device import resolve_device
from repro_torch.models.moe import _routing, cumsum_rank
from repro_torch.sim import _jaxrandom
from repro_torch.sim.trace import WindowTrace

_APP = "capture/moe_experts"


@dataclasses.dataclass(frozen=True)
class MoEExpertsConfig:
    tokens_per_step: int = 64
    d_model: int = 64
    num_experts: int = 32
    top_k: int = 2
    capacity_factor: float = 1.25
    vocab: int = 512
    expert_lines: int = 768      # weight lines tracked per expert
    gather_lines: int = 8        # recorded sample of each active gather
    router_lines: int = 128
    stats_lines: int = 64        # per tenant
    drift_scale: float = 2.0     # per-kernel router-bias drift magnitude
    zipf_skew: float = 3.0       # token-id popularity skew per tenant
    pim_instr_per_keep: float = 48.0
    cpu_instr_per_token: float = 32.0

    @classmethod
    def scaled(cls, scale: float) -> "MoEExpertsConfig":
        el = max(4, int(round(768 * scale)))
        return cls(tokens_per_step=max(8, int(round(64 * scale))),
                   d_model=max(8, int(round(64 * scale))),
                   num_experts=max(4, int(round(32 * scale))),
                   vocab=max(32, int(round(512 * scale))),
                   expert_lines=el,
                   gather_lines=min(8, el),
                   router_lines=max(4, int(round(128 * scale))),
                   stats_lines=max(4, int(round(64 * scale))))

    @property
    def cap(self) -> int:
        """The block's capacity formula (moe_block, Switch/GShard)."""
        return max(8, int(self.capacity_factor * self.tokens_per_step
                          * self.top_k / self.num_experts))

    def layout(self) -> LineLayout:
        return LineLayout.build([
            ("experts", self.num_experts * self.expert_lines),
            ("buffer", self.num_experts * self.cap),
            ("router", self.router_lines),
            ("emb", self.vocab),
            ("stats", 2 * self.stats_lines),
        ])


def _route(emb_rows: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
           k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Routing + cumsum-dispatch rank math — the very ops ``moe_block``
    runs (real ``_routing``, the same rank helper) on the tensors' device:
    (T, d) rows -> (top_e, rank), each (T, K)."""
    e = router.shape[1]
    logits = emb_rows.to(torch.float32) @ router + bias
    _, _, top_e = _routing(logits, e, k, e)
    return top_e, cumsum_rank(top_e, e)


@functools.lru_cache(maxsize=8)
def _params(d: int, e: int, v: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic router/embedding parameters from the model seed: the
    reference's ``jax.random`` draws, bit for bit (read-only arrays)."""
    kr, ke = _jaxrandom.split(_jaxrandom.key(seed))
    # Unit-variance logits (router ~ 1/sqrt(d)): the token embedding and
    # the drift bias contribute comparably, so routing is token-dependent
    # but the hot expert set still shifts per kernel.
    router = _jaxrandom.normal(kr, (d, e)) * np.float32(d ** -0.5)
    emb = _jaxrandom.normal(ke, (v, d))
    router.flags.writeable = emb.flags.writeable = False
    return router, emb


def capture_moe_experts(threads: int = 16, seed: int = 0,
                        num_kernels: int = 24, windows_per_kernel: int = 3,
                        scale: float = 1.0, cpu_reuse: float = 6.0,
                        cfg: MoEExpertsConfig | None = None,
                        device=None) -> WindowTrace:
    """Run two tenants' routed traffic, routing on ``device`` (``None`` =
    the CUDA card), and record it as a ``WindowTrace`` there."""
    dev = resolve_device(device)
    cfg = MoEExpertsConfig.scaled(scale) if cfg is None else cfg
    layout = cfg.layout()
    ex, buf = layout.region("experts"), layout.region("buffer")
    rtr, emb_r = layout.region("router"), layout.region("emb")
    stats = layout.region("stats")
    router_np, emb_np = _params(cfg.d_model, cfg.num_experts, cfg.vocab, seed)
    router = torch.from_numpy(router_np.copy()).to(dev)
    emb = torch.from_numpy(emb_np.copy()).to(dev)

    tok = [Stream(_APP, seed, f"tokens{t}") for t in range(2)]
    drift = [Stream(_APP, seed, f"drift{t}") for t in range(2)]
    misc = Stream(_APP, seed, "misc")
    perms = [perm(_APP, seed, f"perm{t}", cfg.vocab) for t in range(2)]

    stride = max(1, cfg.expert_lines // cfg.gather_lines)

    def weight_sample(e_id: int, rot: int) -> np.ndarray:
        """A gather sample of expert ``e_id``'s weight lines, rotated per
        step so repeated gathers walk the whole block."""
        offs = (rot * 17 + np.arange(cfg.gather_lines) * stride) \
            % cfg.expert_lines
        return ex.line(e_id * cfg.expert_lines + offs)

    # Per-tenant carry: the experts the tenant's *last* kernel used most
    # (drives the inactive tenant's prefetches + the host optimizer's
    # pre-writes).
    hot: list[np.ndarray] = [np.zeros(0, dtype=np.int64) for _ in range(2)]

    def host_pre(kernel: int) -> list[int]:
        """Optimizer update between kernels: re-write a sample of last
        kernel's hottest experts' weight lines (kernel 0: router init)."""
        tenant = kernel % 2
        pre: list[int] = []
        if kernel == 0:
            pre += list(rtr.line(np.arange(cfg.router_lines)))
        for e_id in hot[tenant][:4]:
            pre += list(weight_sample(int(e_id), kernel))
            pre += list(weight_sample(int(e_id), kernel + 1))
        if not pre:  # first visit of this tenant: warm its stats page
            pre += list(stats.line(tenant * cfg.stats_lines
                                   + np.arange(cfg.stats_lines)))
        return pre

    rec = WindowRecorder(_APP, layout.num_lines, threads, cpu_reuse)
    for k in range(num_kernels):
        tenant, other = k % 2, (k + 1) % 2
        rec.begin_kernel(host_pre(k))
        # Shifting routing distribution: this kernel's router bias drift.
        bias = cfg.drift_scale * (np.asarray(
            drift[tenant].u01(cfg.num_experts), dtype=np.float32) - 0.5)
        bias_t = torch.from_numpy(bias).to(dev)
        counts = np.zeros(cfg.num_experts, dtype=np.int64)
        for s in range(windows_per_kernel):
            ids = perms[tenant][tok[tenant].zipf(
                cfg.vocab, cfg.zipf_skew, cfg.tokens_per_step)]
            top_e, rank = _route(emb[torch.from_numpy(ids).to(dev)], router,
                                 bias_t, cfg.top_k)
            top_e, rank = top_e.cpu().numpy(), rank.cpu().numpy()
            keep = rank < cfg.cap
            counts += np.bincount(top_e[keep].reshape(-1),
                                  minlength=cfg.num_experts)
            # PIM: gather active experts' weights, scatter kept tokens
            # into their capacity-buffer slots.
            pim_r: list[int] = []
            for e_id in np.unique(top_e[keep]):
                pim_r += list(weight_sample(int(e_id), k * 31 + s))
            slot = (top_e * cfg.cap + rank)[keep].reshape(-1)
            pim_w = list(buf.line(slot))
            # CPU: router + token-embedding reads for the active tenant,
            # the inactive tenant prefetching ITS hot experts, stats.
            cpu_r = list(rtr.line((s * 7 + np.arange(
                min(16, cfg.router_lines))) % cfg.router_lines))
            cpu_r += list(emb_r.line(np.unique(ids)))
            for e_id in hot[other][:2]:
                cpu_r += list(weight_sample(int(e_id), s))
            cpu_w = list(stats.line(
                other * cfg.stats_lines
                + misc.mod(cfg.stats_lines, 4) % cfg.stats_lines))
            rec.step(pim_reads=pim_r, pim_writes=pim_w, cpu_reads=cpu_r,
                     cpu_writes=cpu_w,
                     pim_instr=int(keep.sum()) * cfg.pim_instr_per_keep,
                     cpu_instr=cfg.tokens_per_step * cfg.cpu_instr_per_token,
                     cpu_priv=cfg.tokens_per_step * 8.0)
        hot[tenant] = np.argsort(-counts, kind="stable")[:4]
    return rec.finish(dev)
