"""Hand-written CUDA flash attention and its plain PyTorch version.

``flash_attention`` ports ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/flash_attention.py:82``); the source
is ``repro_torch/csrc/flash_attention.cu``, with the note on what bounds it
and what its design does about that.  The wrapper checks device, dtype,
shape, contiguity and alignment and allocates the output; on CPU tensors
it runs the plain version beside it, on CUDA tensors it launches the
kernel (raising if the launch reports an error) and adds one to
``flash_attention.launches`` — there is no fallback.  The library is built
on first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain", "reset_launch_counts",
           "launch_counts", "NEG_INF", "BLOCK_K"]

SOURCE = _build.CSRC / "flash_attention.cu"
NEG_INF = float(torch.finfo(torch.float32).min)
BLOCK_K = 128  # the plain version's KV chunk: the TPU kernel's block_k
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _F, _I, _I, _I, _P]}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind(SOURCE, _SIGNATURES)


def _stream(t: torch.Tensor) -> int:
    return _build.stream(t)


def _on_cpu(*ts: torch.Tensor) -> bool:
    return _build.on_cpu("flash_attention", *ts)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the TPU kernel's math,
    float32 throughout (the probabilities too, unlike ``mha_chunked``,
    which rounds them to ``v.dtype`` before the PV product), over KV chunks
    of ``BLOCK_K`` keys with the same online softmax; keys at or past Sk
    are masked.  GQA by grouping the query heads of each kv head, without
    repeating K and V."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    dev = q.device
    # (B, Hkv, G, Sq, D) queries against (B, Hkv, Sk, D) keys and values
    qf = q.to(torch.float32).reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q`` (B, Sq, Hq, D), ``k`` and ``v`` (B, Sk, Hkv, D), all float32 or
    all bfloat16 and contiguous -> (B, Sq, Hq, D) in q's dtype: GQA
    attention, causal (top-left aligned) with an optional trailing
    ``window``, in float32 with an online softmax.  On the card the head
    dim must be a multiple of 16 whose tiles fit a block's shared memory
    (up to 320 in bfloat16, 208 in float32); the launcher refuses any
    other, and a grid it cannot launch, and the wrapper raises."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want 4 dims")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype} / k {k.dtype} / v {v.dtype}: want all "
                        f"float32 or all bfloat16")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Sq, Hq, D) and two "
                         f"(B, Sk, Hkv, D)")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    if window < 0:
        raise ValueError(f"window {window}: want >= 0")
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned")
    out = torch.empty_like(q)
    if b and sq and hq:
        _build.launch(_lib(), "flash_attention_launch", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv, d,
                      ctypes.c_float(d ** -0.5), int(bool(causal)), int(window),
                      _DTYPES[q.dtype], _stream(q))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0


def launch_counts() -> dict[str, int]:
    return {"flash_attention": flash_attention.launches}
