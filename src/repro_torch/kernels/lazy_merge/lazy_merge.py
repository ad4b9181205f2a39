"""Hand-written CUDA LazySync row merge and its plain PyTorch version.

``lazy_merge`` ports ``lazy_merge_pallas``
(``src/repro/kernels/lazy_merge/lazy_merge.py:30``); the source is
``repro_torch/csrc/lazy_merge.cu``, with the note on what bounds it and
what its design does about that.  The wrapper checks device, dtype, shape
and contiguity and allocates the output; on CPU tensors it runs the plain
version beside it, on CUDA tensors it launches the kernel (raising if the
launch reports an error) and adds one to ``lazy_merge.launches`` — there
is no fallback.  The library is built on first use
(:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["lazy_merge", "lazy_merge_plain", "reset_launch_counts",
           "launch_counts"]

SOURCE = _build.CSRC / "lazy_merge.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lazy_merge_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind(SOURCE, _SIGNATURES)


def _stream(t: torch.Tensor) -> int:
    return _build.stream(t)


def _on_cpu(*ts: torch.Tensor) -> bool:
    return _build.on_cpu("lazy_merge", *ts)


def lazy_merge_plain(rows: torch.Tensor, base: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lazy_merge`: the same float32 sums in the
    same order (``acc = sum_g (rows_g - base)`` from group 0 up, then
    ``base + acc``), so the kernel equals it bit for bit."""
    b = base.to(torch.float32)
    acc = torch.zeros_like(b)
    for g in range(rows.shape[0]):
        acc = acc + (rows[g].to(torch.float32) - b)
    return torch.where(valid[:, None], b + acc, b)


def lazy_merge(rows: torch.Tensor, base: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """``rows`` (G, R, D) and ``base`` (R, D), both float32 or both
    bfloat16, ``valid`` (R,) bool -> (R, D) float32:
    ``base + sum_g (rows_g - base)`` where ``valid``, ``base`` elsewhere."""
    for name, t in (("rows", rows), ("base", base), ("valid", valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
    if rows.dtype not in _DTYPES or base.dtype != rows.dtype:
        raise TypeError(f"rows {rows.dtype} / base {base.dtype}: want both "
                        f"float32 or both bfloat16")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid: dtype {valid.dtype}, want torch.bool")
    if rows.dim() != 3 or base.shape != rows.shape[1:] or valid.shape != rows.shape[1:2]:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, base "
                         f"{tuple(base.shape)}, valid {tuple(valid.shape)}: want "
                         f"(G, R, D), (R, D), (R,)")
    g, r, d = rows.shape
    if g < 1 or max(r, d, r * d) >= 2**31:
        raise ValueError(f"rows {tuple(rows.shape)}: want G >= 1 and R * D < 2**31")
    if _on_cpu(rows, base, valid):
        return lazy_merge_plain(rows, base, valid)
    out = torch.empty((r, d), dtype=torch.float32, device=rows.device)
    if r and d:
        _build.launch(_lib(), "lazy_merge_launch", rows.data_ptr(),
                      base.data_ptr(), valid.data_ptr(), out.data_ptr(), g, r,
                      d, _DTYPES[rows.dtype], _stream(rows), device=rows.device)
        lazy_merge.launches += 1
    return out


lazy_merge.launches = 0


def reset_launch_counts() -> None:
    lazy_merge.launches = 0


def launch_counts() -> dict[str, int]:
    return {"lazy_merge": lazy_merge.launches}
