"""A stand-in for the build and the bound library of ``csrc/bloom.cu``, so
that CPU tests can drive the port's kernel path through its real build and
bind code (``repro_torch.kernels._build``): a compiler that exits 0 at once
(``true``), a loader that hands back :class:`BloomStandIn`, and launchers
that run each kernel's arithmetic in numpy on the host memory its pointers
name (CPU tensors taken as CUDA ones).  The stand-in records which entry
points ran since it was loaded, as a card loads a kernel's module on its
first launch, and each launch with the device that was current for it
(``_build.on_device``, the device the launcher names).

Helper module, not a test file.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import types

import numpy as np

from repro_torch.kernels import _build
from repro_torch.kernels.bloom import bloom as K


def _view(ptr: int, dtype, shape) -> np.ndarray:
    """A writable numpy view of ``shape`` elements at host address ``ptr``."""
    count = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * count).from_address(ptr), dtype=dtype).reshape(
        shape)


def _parity_positions(cols: np.ndarray, m0: int, log_seg: int, a: np.ndarray) -> np.ndarray:
    """(N, M) positions of addresses ``a`` under one pass's column masks:
    ((m0 + m) << log_seg) | h, bit k of h the parity of a & cols[m, k]."""
    x = a.astype(np.uint64)[:, None, None] & cols.astype(np.uint64)[None]
    for shift in (16, 8, 4, 2, 1):
        x ^= x >> np.uint64(shift)
    h = ((x & np.uint64(1)) << np.arange(log_seg, dtype=np.uint64)).sum(-1)
    m = np.arange(m0, m0 + cols.shape[0], dtype=np.uint64)
    return (m << np.uint64(log_seg)) | h


def _lines(words: np.ndarray, num_lines: int) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:num_lines]
    return np.nonzero(bits)[0].astype(np.uint32)


class _Entry:
    """One launcher: callable, and takes the ``argtypes`` / ``restype`` that
    ``_build.bind`` declares on it."""

    def __init__(self, lib, name, fn):
        self.lib, self.name, self.fn = lib, name, fn

    def __call__(self, *args):
        self.lib.loaded.add(self.name)
        self.lib.launched.append((self.name, self.lib.current))
        return self.fn(*args)


def _unexpected(name):
    def fail(*args):
        raise AssertionError(f"the stand-in does not run {name}")
    return fail


class BloomStandIn:
    """Every entry point the library declares (``K._SIGNATURES``): the
    launchers a LazyPIM window and ``prepare`` reach run, any other fails."""

    ENTRIES = ("h3_hash_launch", "bloom_insert_ids_launch", "bloom_insert_bitmap_launch",
               "bloom_query_launch", "bloom_intersect_pair_launch")

    def __init__(self):
        self.loaded: set[str] = set()
        self.launched: list[tuple[str, object]] = []  # (entry, current device)
        self.current = None  # the device _build.on_device made current
        for name in K._SIGNATURES:
            fn = getattr(self, "_" + name) if name in self.ENTRIES else _unexpected(name)
            setattr(self, name, _Entry(self, name, fn))

    @contextlib.contextmanager
    def on_device(self, device):
        """``_build.on_device`` on the host: ``device`` is current inside."""
        before, self.current = self.current, device
        try:
            yield
        finally:
            self.current = before

    @staticmethod
    def _h3_hash_launch(addrs, ptab, out, n, s, m, log_seg, stream):
        per = 64 // log_seg
        a = _view(addrs, np.uint32, (n,)).astype(np.uint64)
        tab = _view(ptab, np.uint64, (s, 256, -(-m // per)))
        h = tab[0][a & np.uint64(0xFF)]
        for k in range(1, s):
            h = h ^ tab[k][(a >> np.uint64(8 * k)) & np.uint64(0xFF)]
        seg = np.arange(m)
        field = (h[:, seg // per] >> (seg % per * log_seg).astype(np.uint64)) & np.uint64(
            (1 << log_seg) - 1)
        _view(out, np.uint32, (n, m))[:] = (seg.astype(np.uint64) << np.uint64(log_seg)) | field
        return 0

    @staticmethod
    def _store(out, items, cols, m0, log_seg, or_out):
        """out (R, NW) of one (list, lane) from its items (uint32)."""
        regs, nw = out.shape
        bank = np.zeros((regs, nw * 32), bool)
        pos = _parity_positions(cols, m0, log_seg, items).astype(np.int64)
        bank[(items % regs).astype(np.int64)[:, None], pos] = True
        words = np.packbits(bank, axis=1, bitorder="little").view(np.uint32)
        out[:] = words | (out if or_out else 0)

    def _bloom_insert_ids_launch(self, ids_a, valid_a, ids_b, valid_b, columns, out, k,
                                 lanes, a_a, a_b, m, log_seg, m0, or_out, regs, nw, stream):
        cols = _view(columns, np.uint32, (m, log_seg))
        o = _view(out, np.uint32, (k, lanes, regs, nw))
        for lst, (ids, valid, width) in enumerate(((ids_a, valid_a, a_a),
                                                   (ids_b, valid_b, a_b))[:k]):
            a = _view(ids, np.uint32, (lanes, width))
            v = _view(valid, np.uint8, (lanes, width)).astype(bool)
            for lane in range(lanes):
                self._store(o[lst, lane], a[lane][v[lane]], cols, m0, log_seg, or_out)
        return 0

    def _bloom_insert_bitmap_launch(self, words_a, words_b, columns, out, k, lanes, nwl,
                                    num_lines, m, log_seg, m0, or_out, regs, nw, stream):
        cols = _view(columns, np.uint32, (m, log_seg))
        o = _view(out, np.uint32, (k, lanes, regs, nw))
        for lst, ptr in enumerate((words_a, words_b)[:k]):
            w = _view(ptr, np.uint32, (lanes, nwl))
            for lane in range(lanes):
                self._store(o[lst, lane], _lines(w[lane], num_lines), cols, m0, log_seg,
                            or_out)
        return 0

    @staticmethod
    def _bloom_query_launch(sig, words_a, words_b, columns, out_a, out_b, lanes, nwl,
                            num_lines, m, log_seg, m0, nw, stream):
        cols = _view(columns, np.uint32, (m, log_seg))
        sigs = _view(sig, np.uint32, (lanes, nw))
        srcs = [_view(p, np.uint32, (lanes, nwl)) for p in (words_a, words_b) if p]
        outs = [_view(p, np.uint32, (lanes, nwl)) for p in (out_a, out_b) if p]
        for lane in range(lanes):
            lines = _lines(np.bitwise_or.reduce([w[lane] for w in srcs]), num_lines)
            pos = _parity_positions(cols, m0, log_seg, lines)
            member = ((sigs[lane][pos >> np.uint64(5)] >> (pos & np.uint64(31)).astype(
                np.uint32)) & 1).astype(bool).all(-1)
            hit = np.zeros(nwl * 32, bool)
            hit[lines[member]] = True
            packed = np.packbits(hit, bitorder="little").view(np.uint32)
            for src, dst in zip(srcs, outs):
                dst[lane] = src[lane] & packed
        return 0

    @staticmethod
    def _bloom_intersect_pair_launch(a, a_b, b, out, lanes, regs, nw, wps, m, stream):
        img = _view(b, np.uint32, (lanes, 1, m, wps))
        o = _view(out, np.uint8, (2, lanes))
        for k, ptr in enumerate((a, a_b)):
            bank = _view(ptr, np.uint32, (lanes, regs, m, wps))
            o[k] = ((bank & img) != 0).any(-1).all(-1).any(-1)
        return 0


def install(monkeypatch, build_dir) -> BloomStandIn:
    """Route ``repro_torch.kernels.bloom`` onto its kernel path for CPU
    tensors: ``nvcc`` is ``true`` (so ``_build.build_all`` writes an empty
    library into ``build_dir`` and counts a build), the loader returns the
    stand-in (``_build.bind`` counts a bind), and a library bound earlier is
    dropped.  The caller drops the stand-in's binding when the test ends
    (``K._lib.cache_clear()``).  Returns the stand-in."""
    lib = BloomStandIn()
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "nvcc", lambda: shutil.which("true"))
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: lib, c_int=ctypes.c_int))
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "on_device", lib.on_device)
    K._lib.cache_clear()
    return lib


def process_death(lib: BloomStandIn) -> None:
    """What a process's death takes with it: the bound library and the
    loaded kernel modules.  The build directory and the cache directory
    stay on disk."""
    K._lib.cache_clear()
    lib.loaded.clear()
