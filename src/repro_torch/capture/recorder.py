"""WindowRecorder — the windower layer shared by the capture adapters,
PyTorch port of :mod:`repro.capture.recorder` (host bookkeeping in numpy).

An adapter drives the recorder with raw per-step line streams (already
mapped to absolute line ids by its :class:`~repro_torch.capture.layout.LineLayout`);
the recorder splits each step into fixed-shape windows so that no PIM
stream carries more than ``MAX_SIG_ADDRS`` (the paper's §5.4 signature
insert cap) entries per window, stride-subsamples the CPU streams to
their slot widths, pads with the ``-1`` sentinel, marks kernel
boundaries, checks the trace invariants at emit time, and hands the
arrays to :func:`repro_torch.sim.trace.trace_from_numpy` on the caller's
device.  The splitting rule, with ``C = min(slot_width, MAX_SIG_ADDRS)``:

    n_sub = max(1, ceil(len(pim_reads) / C), ceil(len(pim_writes) / C))

and every stream is ``np.array_split`` into ``n_sub`` contiguous chunks.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sim.prep import bucket_bound
from repro_torch.sim.synth import AR, AW, BR, BW, MAX_SIG_ADDRS
from repro_torch.sim.trace import WindowTrace, trace_from_numpy


def _as_lines(x) -> np.ndarray:
    a = np.asarray([] if x is None else x, dtype=np.int64).reshape(-1)
    return a


def subsample_even(ids: np.ndarray, width: int) -> np.ndarray:
    """Even-stride subsample of a line stream down to ``width`` entries.

    Keeps the first entry and spreads the rest evenly, so both the head
    and the tail of the stream survive; identity when it already fits.
    """
    n = len(ids)
    if n <= width:
        return ids
    idx = np.floor(np.arange(width) * (n / width)).astype(np.int64)
    return ids[idx]


def split_step(pim_reads, pim_writes, cpu_reads, cpu_writes,
               insert_cap: int = MAX_SIG_ADDRS):
    """Split one step's raw streams into >= 1 window-sized sub-streams.

    Returns a list of ``(pr, pw, cr, cw)`` tuples.  Pure function of its
    inputs — this is the piece the hand-computed differential test pins.
    """
    pr, pw = _as_lines(pim_reads), _as_lines(pim_writes)
    cr, cw = _as_lines(cpu_reads), _as_lines(cpu_writes)
    cap_r = min(AR, insert_cap)
    cap_w = min(AW, insert_cap)
    n_sub = max(1,
                -(-len(pr) // cap_r),
                -(-len(pw) // cap_w))
    prs = np.array_split(pr, n_sub)
    pws = np.array_split(pw, n_sub)
    crs = np.array_split(cr, n_sub)
    cws = np.array_split(cw, n_sub)
    return [(prs[i], pws[i],
             subsample_even(crs[i], BR), subsample_even(cws[i], BW))
            for i in range(n_sub)]


class WindowRecorder:
    """Accumulates per-step capture events into a valid ``WindowTrace``."""

    def __init__(self, name: str, num_lines: int, threads: int,
                 cpu_reuse: float, cpu_priv_miss_rate: float = 0.05,
                 insert_cap: int = MAX_SIG_ADDRS):
        if num_lines != bucket_bound(num_lines):
            raise AssertionError(
                f"capture layout must declare a pow4-bucketed num_lines "
                f"(prep.bucket_bound): got {num_lines}, "
                f"expected {bucket_bound(num_lines)}")
        self.name = name
        self.num_lines = int(num_lines)
        self.threads = int(threads)
        self.cpu_reuse = float(cpu_reuse)
        self.cpu_priv_miss_rate = float(cpu_priv_miss_rate)
        self.insert_cap = int(insert_cap)
        self._windows: list[tuple] = []   # (pr, pw, cr, cw, pi, ci, cp)
        self._pre_rows: list[np.ndarray] = []
        self._kernel_starts: list[int] = []  # window index of each kernel
        self._open = False

    # -- kernel / step API ------------------------------------------------

    def begin_kernel(self, pre_write_lines) -> None:
        """Open a kernel phase; ``pre_write_lines`` is the host-side write
        set that lands before the kernel launches (never empty — an empty
        pre-write phase is rejected by the property suite)."""
        pre = np.unique(_as_lines(pre_write_lines))
        if pre.size == 0:
            raise AssertionError(
                f"{self.name}: kernel {len(self._pre_rows)} has an empty "
                f"pre-write phase")
        self._check_ids(pre, "pre_writes")
        if self._open:
            self._close_kernel()
        row = np.zeros(self.num_lines, dtype=bool)
        row[pre] = True
        self._pre_rows.append(row)
        self._kernel_starts.append(len(self._windows))
        self._open = True

    def step(self, pim_reads=None, pim_writes=None, cpu_reads=None,
             cpu_writes=None, pim_instr: float = 0.0,
             cpu_instr: float = 0.0, cpu_priv: float = 0.0) -> None:
        """Record one live step (e.g. one decode step / one sync_step)."""
        if not self._open:
            raise AssertionError(f"{self.name}: step() before begin_kernel()")
        subs = split_step(pim_reads, pim_writes, cpu_reads, cpu_writes,
                          insert_cap=self.insert_cap)
        n = len(subs)
        for pr, pw, cr, cw in subs:
            for ids, what in ((pr, "pim_reads"), (pw, "pim_writes"),
                              (cr, "cpu_reads"), (cw, "cpu_writes")):
                self._check_ids(ids, what)
            self._windows.append((pr, pw, cr, cw,
                                  pim_instr / n, cpu_instr / n, cpu_priv / n))

    # -- emission ---------------------------------------------------------

    def finish(self, device=None) -> WindowTrace:
        """Emit the recorded windows as a :class:`WindowTrace` on ``device``
        (``None`` = the CUDA card)."""
        if self._open:
            self._close_kernel()
        num_k = len(self._pre_rows)
        num_w = len(self._windows)
        if num_k == 0 or num_w == 0:
            raise AssertionError(f"{self.name}: nothing recorded")

        def pack(col: int, width: int) -> np.ndarray:
            out = np.full((num_w, width), -1, dtype=np.int32)
            for w, win in enumerate(self._windows):
                ids = win[col]
                if len(ids) > width:
                    raise AssertionError(
                        f"{self.name}: window {w} overflows slot width "
                        f"{width} with {len(ids)} entries")
                out[w, :len(ids)] = ids
            return out

        pim_reads = pack(0, AR)
        pim_writes = pack(1, AW)
        for arr, what in ((pim_reads, "pim_reads"), (pim_writes, "pim_writes")):
            for w in range(num_w):
                row = arr[w]
                uniq = np.unique(row[row >= 0]).size
                if uniq > self.insert_cap:
                    raise AssertionError(
                        f"{self.name}: window {w} {what} has {uniq} unique "
                        f"lines > insert cap {self.insert_cap}")

        kernel_id = np.zeros(num_w, dtype=np.int32)
        kernel_start = np.zeros(num_w, dtype=bool)
        kernel_end = np.zeros(num_w, dtype=bool)
        bounds = self._kernel_starts + [num_w]
        for k in range(num_k):
            lo, hi = bounds[k], bounds[k + 1]
            kernel_id[lo:hi] = k
            kernel_start[lo] = True
            kernel_end[hi - 1] = True

        instr = np.asarray([(w[4], w[5], w[6]) for w in self._windows],
                           dtype=np.float64)
        return trace_from_numpy(dict(
            name=self.name,
            threads=self.threads,
            num_lines=self.num_lines,
            pim_reads=pim_reads,
            pim_writes=pim_writes,
            cpu_reads=pack(2, BR),
            cpu_writes=pack(3, BW),
            kernel_id=kernel_id,
            kernel_start=kernel_start,
            kernel_end=kernel_end,
            pre_writes=np.stack(self._pre_rows),
            pim_instr=instr[:, 0].astype(np.float32),
            cpu_instr=instr[:, 1].astype(np.float32),
            cpu_priv_accesses=instr[:, 2].astype(np.float32),
            cpu_priv_miss_rate=self.cpu_priv_miss_rate,
            cpu_reuse=self.cpu_reuse,
        ), device)

    # -- internals --------------------------------------------------------

    def _close_kernel(self) -> None:
        if len(self._windows) == self._kernel_starts[-1]:
            raise AssertionError(
                f"{self.name}: kernel {len(self._pre_rows) - 1} recorded "
                f"zero windows")
        self._open = False

    def _check_ids(self, ids: np.ndarray, what: str) -> None:
        if ids.size and (int(ids.min()) < 0
                         or int(ids.max()) >= self.num_lines):
            raise AssertionError(
                f"{self.name}: {what} line id out of [0, {self.num_lines}) "
                f"(min {int(ids.min())}, max {int(ids.max())})")
