"""LazyEmbed capture — embedding update/read races from the live protocol,
PyTorch port of :mod:`repro.capture.lazy_embed`.

Records :meth:`repro_torch.core.lazy_sync.LazyEmbed.sync_step`'s actual
per-step touched-row streams: each step the training groups' touched ids
(zipfian over the vocab, partially overlapping hot sets across groups)
drive the real protocol on the chosen device — speculative apply, H3 /
Bloom signature exchange, §5.5 pin-streak forcing, budgeted exact
reconcile, periodic commit — and the capture is the integer id tensors
the protocol computes:

* **PIM reads + writes**: the touched rows' cache lines;
* **CPU writes**: the rows ``detect_conflicts`` selected for exact
  reconciliation (``rows[valid]``, recomputed from the same pre-step
  inputs ``sync_step`` uses), trailing their producing step by one window
  (the host applies a step's merges while the PIM side runs the next);
* **CPU reads**: an inference reader stream over the same zipfian hot set;
* **kernel boundaries at commit intervals** (``commit_interval =
  windows_per_kernel``): the inter-kernel pre-write set is every row the
  commit rewrote (everything touched during the previous kernel).

The gradients are zero, so the trace does not depend on the random init
(the port's ``torch.Generator`` draw differs from ``jax.random``'s) and
equals the reference's trace bit for bit.  Line layout: 2 lines per
embedding row (d_model = 32 x 4 B = 128 B).
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
from repro_torch.sim.trace import WindowTrace

_APP = "capture/lazy_embed"
LINES_PER_ROW = 2
D_MODEL = 32


@dataclasses.dataclass(frozen=True)
class LazyEmbedConfig:
    vocab: int = 24000
    num_groups: int = 4
    touched_per_group: int = 48
    reader_rows: int = 48            # inference-side reads per step
    zipf_skew: float = 3.0
    max_reconcile_rows: int = 256
    pin_streak: int = 3
    sig_bits: int = 2048
    num_segments: int = 4
    pim_instr_per_row: float = 8.0
    cpu_instr_per_row: float = 6.0

    @classmethod
    def scaled(cls, scale: float) -> "LazyEmbedConfig":
        vocab = max(64, int(round(24000 * scale)))
        return cls(vocab=vocab,
                   touched_per_group=max(4, int(round(48 * scale))),
                   reader_rows=max(4, int(round(48 * scale))),
                   max_reconcile_rows=min(256, vocab))

    def layout(self) -> LineLayout:
        return LineLayout.build([("rows", self.vocab * LINES_PER_ROW)])


def row_lines(layout: LineLayout, rows: np.ndarray) -> np.ndarray:
    """Embedding row ids -> their cache lines (2 per row, interleaved so
    both halves of a row sit adjacent)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    return layout.region("rows").line(
        (rows[:, None] * LINES_PER_ROW
         + np.arange(LINES_PER_ROW)[None, :]).reshape(-1))


@functools.lru_cache(maxsize=8)
def _protocol(vocab: int, g: int, t: int, commit_interval: int,
              max_rows: int, pin: int, sig_bits: int, segs: int, seed: int,
              device: torch.device):
    """(initial params/state, step fn) for one protocol geometry on one
    device.  The step fn runs the real ``sync_step`` and recomputes the
    reconcile row set from the same pre-step inputs (the conflict path is
    pure), so the recorder sees exactly the rows the protocol merged.
    Cached per geometry and device; nothing here is written in place, so
    the cached initial params and state can be shared."""
    from repro_torch.core import lazy_sync
    from repro_torch.models import common as C

    mcfg = C.ModelConfig(name="capture-embed", family="dense", num_layers=1,
                         d_model=D_MODEL, num_heads=1, num_kv_heads=1,
                         head_dim=D_MODEL, d_ff=2 * D_MODEL,
                         vocab_size=vocab, param_dtype=torch.float32)
    scfg = lazy_sync.LazySyncConfig(num_groups=g, sig_bits=sig_bits,
                                    num_segments=segs,
                                    commit_interval=commit_interval,
                                    max_reconcile_rows=max_rows,
                                    pin_streak=pin)
    emb = lazy_sync.LazyEmbed(mcfg, scfg)
    params = emb.init(torch.Generator(device=device).manual_seed(seed))
    state = lazy_sync.init_state(scfg, vocab, device)
    grads = torch.zeros((g, vocab, D_MODEL), dtype=torch.float32, device=device)

    def step(params, state, touched):
        sigs = emb.signatures(touched)
        pinned = state["streak"][touched.reshape(-1).to(torch.int64)] >= pin
        rows, valid = emb.detect_conflicts(touched, sigs, force=pinned)
        params, state, metrics = emb.sync_step(params, state, touched, grads)
        return params, state, rows, valid, metrics["lazy_conflict_rows"]

    return params, state, step


def capture_lazy_embed(threads: int = 16, seed: int = 0,
                       num_kernels: int = 24, windows_per_kernel: int = 3,
                       scale: float = 1.0, cpu_reuse: float = 6.0,
                       cfg: LazyEmbedConfig | None = None,
                       device=None) -> WindowTrace:
    """Run the live protocol on ``device`` (``None`` = the CUDA card) and
    record it as a ``WindowTrace`` there."""
    dev = resolve_device(device)
    cfg = LazyEmbedConfig.scaled(scale) if cfg is None else cfg
    layout = cfg.layout()
    commit_interval = max(1, windows_per_kernel)
    params, state, step_fn = _protocol(
        cfg.vocab, cfg.num_groups, cfg.touched_per_group, commit_interval,
        cfg.max_reconcile_rows, cfg.pin_streak, cfg.sig_bits,
        cfg.num_segments, seed, dev)

    order = perm(_APP, seed, "hotset", cfg.vocab)
    touch = Stream(_APP, seed, "touch")
    group_shift = Stream(_APP, seed, "group_shift")
    reader = Stream(_APP, seed, "reader")
    init_rows = Stream(_APP, seed, "init")

    # Each group's zipf ranks shift by a small per-group offset, so hot
    # sets overlap partially — real cross-group conflicts, not total ones.
    shifts = [group_shift.mod(max(1, cfg.vocab // 64))
              for _ in range(cfg.num_groups)]

    rec = WindowRecorder(_APP, layout.num_lines, threads, cpu_reuse)
    pre = row_lines(layout, init_rows.mod(cfg.vocab, min(64, cfg.vocab)))
    touched_this_kernel: list[np.ndarray] = []
    pending_merge = np.zeros(0, dtype=np.int64)
    for _ in range(num_kernels):
        rec.begin_kernel(pre)
        touched_this_kernel.clear()
        for _ in range(windows_per_kernel):
            touched = np.stack([
                order[np.minimum(
                    touch.zipf(cfg.vocab, cfg.zipf_skew,
                               cfg.touched_per_group) + shifts[gi],
                    cfg.vocab - 1)]
                for gi in range(cfg.num_groups)]).astype(np.int32)
            params, state, rows, valid, _ = step_fn(
                params, state, torch.from_numpy(touched).to(dev))
            rows = rows.cpu().numpy()[valid.cpu().numpy()]
            touched_this_kernel.append(touched.reshape(-1))
            read_rows = order[reader.zipf(cfg.vocab, cfg.zipf_skew,
                                          cfg.reader_rows)]
            n_touch = touched.size
            rec.step(
                pim_reads=row_lines(layout, touched),
                pim_writes=row_lines(layout, touched),
                cpu_reads=row_lines(layout, read_rows),
                cpu_writes=pending_merge,
                pim_instr=n_touch * cfg.pim_instr_per_row,
                cpu_instr=(cfg.reader_rows + len(rows))
                * cfg.cpu_instr_per_row,
                cpu_priv=cfg.reader_rows * 4.0)
            pending_merge = row_lines(layout, rows)
        # The commit fires on the kernel's last step: the full sync
        # rewrites every row touched this interval — the next kernel's
        # pre-write set.
        pre = row_lines(layout,
                        np.unique(np.concatenate(touched_this_kernel)))
    return rec.finish(dev)
