"""KV-cache serving capture — the streaming-HTAP analogue on live traffic,
PyTorch port of :mod:`repro.capture.kv_serve` (host bookkeeping in numpy).

Records a paged-KV decode loop at the slot arithmetic the serving stack
uses (page = position // page_tokens, slot = position % page_tokens): a
request mix is admitted into a fixed page pool; every decode step appends
one token per live request to the hot tail of its page list (PIM writes:
the 8 cache lines of the new K/V entry), while the processor side runs
attention reads over the resident pages (recency-skewed), shared-prefix
reads, and — on page allocation — the scheduler's page-table writes, which
race the PIM kernel's per-step page-table reads (the RAW pattern).  Kernels
are groups of ``windows_per_kernel`` decode steps; the inter-kernel host
phase retires finished requests and admits new ones, whose prefill lands as
the next kernel's pre-write set.

Line layout (:class:`repro_torch.capture.layout.LineLayout`):

* ``pages``:  ``num_pages × 128`` lines — 16 tokens/page × 8 lines/token
  (2 KV heads × 64 head-dim × K&V × 2 B / 64 B line);
* ``page_table``: 1 line per 8 page-table entries.

The per-step line computation (:func:`token_lines`, :func:`pt_line`,
:func:`decode_lines`) is pure page/slot arithmetic, and every random
decision is a draw of the counter-PRNG :class:`~repro_torch.capture.streams.Stream`
(the reference's bits), so the trace equals the reference's field by
field; only the finished ``WindowTrace`` lands on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.capture.layout import LineLayout
from repro_torch.capture.recorder import WindowRecorder
from repro_torch.capture.streams import Stream
from repro_torch.device import resolve_device
from repro_torch.sim.trace import WindowTrace

PAGE_TOKENS = 16        # tokens per KV page
LINES_PER_TOKEN = 8     # 2 KV heads x 64 head-dim x (K+V) x 2 B / 64 B
LINES_PER_PAGE = PAGE_TOKENS * LINES_PER_TOKEN
PT_ENTRIES_PER_LINE = 8


@dataclasses.dataclass(frozen=True)
class KVServeConfig:
    num_pages: int = 500
    shared_pages: int = 4        # system-prompt prefix, read by everyone
    batch: int = 24              # live request slots
    max_prompt_pages: int = 4
    max_decode_tokens: int = 48
    attn_reads_per_req: int = 4  # recorded CPU attention reads per step
    recency_skew: float = 2.0    # attention re-reads the recent pages harder
    pim_instr_per_token: float = 96.0
    cpu_instr_per_read: float = 24.0
    cpu_priv_per_req: float = 50.0
    # Pin the request mix for the hand-computed differential test: when
    # set, admission skips its random draws entirely.
    fixed_prompt_tokens: int | None = None
    fixed_decode_tokens: int | None = None

    @classmethod
    def scaled(cls, scale: float) -> "KVServeConfig":
        num_pages = max(8, int(round(500 * scale)))
        shared = max(1, min(int(round(4 * scale)), num_pages // 4))
        batch = max(2, min(int(round(24 * scale)), num_pages - shared))
        return cls(num_pages=num_pages, shared_pages=shared, batch=batch,
                   max_prompt_pages=min(4, (num_pages - shared) // batch),
                   max_decode_tokens=max(4, int(round(48 * scale))))

    @property
    def pages_per_req(self) -> int:
        """Per-request page cap; guarantees a full batch always fits."""
        return (self.num_pages - self.shared_pages) // self.batch

    def layout(self) -> LineLayout:
        return LineLayout.build([
            ("pages", self.num_pages * LINES_PER_PAGE),
            ("page_table", -(-self.num_pages // PT_ENTRIES_PER_LINE)),
        ])


# -- pure line-mapping helpers (the hand-checkable arithmetic) -------------


def token_lines(layout: LineLayout, page: int, slot: int) -> np.ndarray:
    """The 8 cache lines of one token's K/V entry."""
    base = page * LINES_PER_PAGE + slot * LINES_PER_TOKEN
    return layout.region("pages").line(base + np.arange(LINES_PER_TOKEN))


def pt_line(layout: LineLayout, page: int) -> int:
    """The page-table cache line holding ``page``'s entry."""
    return int(layout.region("page_table").line(page // PT_ENTRIES_PER_LINE))


def decode_lines(layout: LineLayout, pages: list[int], pos: int):
    """(pim_writes, pim_reads) for appending token ``pos`` of a request.

    Writes: the new token's 8 lines.  Reads: the tail page's page-table
    entry + the previous token's 8 lines (the decode step attends from
    the new query against the freshly-written tail — the hot-tail reuse).
    Page-table *writes* belong to the host: allocation is scheduler work,
    recorded as a CPU write in the step that allocates.
    """
    page = pages[pos // PAGE_TOKENS]
    writes = list(token_lines(layout, page, pos % PAGE_TOKENS))
    prev = pos - 1
    reads = [pt_line(layout, page)]
    reads += list(token_lines(layout, pages[prev // PAGE_TOKENS],
                              prev % PAGE_TOKENS))
    return writes, reads


class _Request:
    __slots__ = ("pages", "pos", "target")

    def __init__(self, pages: list[int], pos: int, target: int):
        self.pages, self.pos, self.target = pages, pos, target

    @property
    def done(self) -> bool:
        return self.pos >= self.target


def capture_kv_serve(threads: int = 16, seed: int = 0, num_kernels: int = 24,
                     windows_per_kernel: int = 3, scale: float = 1.0,
                     cpu_reuse: float = 8.0,
                     cfg: KVServeConfig | None = None,
                     device=None) -> WindowTrace:
    """Run the decode loop and record it as a ``WindowTrace`` on ``device``
    (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    cfg = KVServeConfig.scaled(scale) if cfg is None else cfg
    if cfg.pages_per_req < 1:
        raise ValueError(f"page pool too small: {cfg.num_pages} pages for "
                         f"batch {cfg.batch} + {cfg.shared_pages} shared")
    layout = cfg.layout()
    app = "capture/kv_serve"
    adm = Stream(app, seed, "admit")
    attn = Stream(app, seed, "attn")
    off = Stream(app, seed, "attn_off")

    free = list(range(cfg.shared_pages, cfg.num_pages))
    requests: list[_Request] = []

    def admit() -> list[int]:
        """Admit one request; returns its prefill pre-write lines."""
        if cfg.fixed_prompt_tokens is not None:
            prompt = cfg.fixed_prompt_tokens
        else:
            n_pages = 1 + adm.mod(max(1, min(cfg.max_prompt_pages,
                                             cfg.pages_per_req)))
            prompt = (n_pages - 1) * PAGE_TOKENS + 1 + adm.mod(PAGE_TOKENS)
        prompt = max(1, min(prompt, cfg.pages_per_req * PAGE_TOKENS))
        decode = (cfg.fixed_decode_tokens if cfg.fixed_decode_tokens
                  is not None else 1 + adm.mod(cfg.max_decode_tokens))
        target = min(prompt + decode, cfg.pages_per_req * PAGE_TOKENS)
        n_pages = -(-prompt // PAGE_TOKENS)
        pages = [free.pop(0) for _ in range(n_pages)]
        requests.append(_Request(pages, prompt, target))
        pre: list[int] = []
        for t in range(prompt):
            pre += list(token_lines(layout, pages[t // PAGE_TOKENS],
                                    t % PAGE_TOKENS))
        pre += [pt_line(layout, p) for p in pages]
        return pre

    def host_phase(initial: bool) -> list[int]:
        """Inter-kernel processor phase: retire, admit, sync scheduler
        state.  Returns the next kernel's pre-write line set."""
        pre: list[int] = []
        if initial:
            shared = layout.region("pages")
            pre += list(shared.line(
                np.arange(cfg.shared_pages * LINES_PER_PAGE)))
            pre += [pt_line(layout, p) for p in range(cfg.shared_pages)]
        for r in [r for r in requests if r.done]:
            requests.remove(r)
            free.extend(r.pages)
            free.sort()
        while len(requests) < cfg.batch:
            pre += admit()
        # Scheduler checkpoint: the host re-writes every live request's
        # tail page-table entry between kernels (also guarantees the
        # pre-write phase is never empty).
        pre += [pt_line(layout, r.pages[-1]) for r in requests]
        return pre

    rec = WindowRecorder(app, layout.num_lines, threads, cpu_reuse)
    pre = host_phase(initial=True)
    for _ in range(num_kernels):
        rec.begin_kernel(pre)
        for _ in range(windows_per_kernel):
            pim_w: list[int] = []
            pim_r: list[int] = []
            cpu_r: list[int] = []
            cpu_w: list[int] = []
            tokens = 0
            for req in requests:
                if not req.done:
                    if (req.pos % PAGE_TOKENS == 0
                            and req.pos // PAGE_TOKENS >= len(req.pages)):
                        if free and len(req.pages) < cfg.pages_per_req:
                            new_page = free.pop(0)
                            req.pages.append(new_page)
                            # Allocation is scheduler work: the host
                            # writes the new page-table entry, racing the
                            # kernel's page-table reads (the real RAW).
                            cpu_w.append(pt_line(layout, new_page))
                        else:
                            req.target = req.pos  # pool pressure: finish now
                    if not req.done:
                        w, r = decode_lines(layout, req.pages, req.pos)
                        pim_w += w
                        pim_r += r
                        req.pos += 1
                        tokens += 1
                # Processor side reads run for every live slot (the
                # scheduler serves finished requests until retirement).
                sp = adm.mod(cfg.shared_pages) if cfg.shared_pages > 1 else 0
                cpu_r.append(int(layout.region("pages").line(
                    sp * LINES_PER_PAGE + off.mod(LINES_PER_PAGE))))
                for _ in range(cfg.attn_reads_per_req):
                    back = int(attn.u01() ** cfg.recency_skew
                               * len(req.pages))
                    page = req.pages[len(req.pages) - 1 - back]
                    if page == req.pages[-1]:
                        bound = max(LINES_PER_TOKEN,
                                    (((req.pos - 1) % PAGE_TOKENS) + 1)
                                    * LINES_PER_TOKEN)
                    else:
                        bound = LINES_PER_PAGE
                    cpu_r.append(int(layout.region("pages").line(
                        page * LINES_PER_PAGE + off.mod(bound))))
            rec.step(pim_reads=pim_r, pim_writes=pim_w, cpu_reads=cpu_r,
                     cpu_writes=cpu_w,
                     pim_instr=tokens * cfg.pim_instr_per_token,
                     cpu_instr=len(cpu_r) * cfg.cpu_instr_per_read,
                     cpu_priv=len(requests) * cfg.cpu_priv_per_req)
        pre = host_phase(initial=False)
    return rec.finish(dev)
