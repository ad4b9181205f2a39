"""Hand-written CUDA flash attention and its plain PyTorch version.

``flash_attention`` ports ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/flash_attention.py:82``) along two
routes, chosen before any launch from the dtype and the head dim:

- ``"sm90"``: bfloat16 with D in :data:`SM90_HEAD_DIMS` (64, 96, 128, 192,
  256) goes to ``repro_torch/csrc/flash_attention_sm90.cu`` (register
  accumulators, a TMA-fed K/V ring, ``wgmma``);
- ``"general"``: float32, and bfloat16 with every other head dim, goes to
  ``repro_torch/csrc/flash_attention.cu`` (bfloat16 on ``mma.sync`` with S,
  P and O in registers; float32 as register-tiled exact FFMA; both with a
  ``cp.async`` K/V ring).

Each source carries the note on what bounds it and what its design does
about that.  The wrapper checks device, dtype, shape, contiguity and
alignment and allocates the output; on CPU tensors it runs the plain
version beside it, on CUDA tensors it launches the route's kernel (raising
if the launch reports an error; no route falls back to the other) and adds
one to ``flash_attention.launches`` and to its route's count
(:func:`route_counts`).  The libraries are built on first use
(:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain", "reset_launch_counts",
           "launch_counts", "route_counts", "sm90_attributes", "general_attributes",
           "general_bands", "NEG_INF", "BLOCK_K", "SM90_HEAD_DIMS"]

SOURCE = _build.CSRC / "flash_attention.cu"
SOURCE_SM90 = _build.CSRC / "flash_attention_sm90.cu"
# bfloat16 only: the head dims of the model zoo's published configs
SM90_HEAD_DIMS = frozenset({64, 96, 128, 192, 256})
NEG_INF = float(torch.finfo(torch.float32).min)
BLOCK_K = 128  # the plain version's KV chunk: the TPU kernel's block_k
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]
_ENTRY = {"general": "flash_attention_launch", "sm90": "flash_attention_sm90_launch"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind(SOURCE, {_ENTRY["general"]: _ARGS,
                                "flash_attention_general_attributes": [_I, _I, _P],
                                "flash_attention_general_bands": [_I, _I, _P]})


@functools.lru_cache(maxsize=None)
def _lib_sm90() -> ctypes.CDLL:
    return _build.bind(SOURCE_SM90, {_ENTRY["sm90"]: _ARGS,
                                     "flash_attention_sm90_attributes": [_I, _P]})


def sm90_attributes(d: int) -> dict[str, int]:
    """What the loaded sm90 kernel at head dim ``d`` (one of
    :data:`SM90_HEAD_DIMS`) takes, as ``cudaFuncGetAttributes`` reads it:
    registers a thread, local memory a thread (spills and stack), static
    and dynamic shared memory a block.  Builds the library; needs a card."""
    vals = (ctypes.c_int * 4)()
    _build.launch(_lib_sm90(), "flash_attention_sm90_attributes", d,
                  ctypes.addressof(vals), device=None)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), vals))


def general_bands(dtype: torch.dtype) -> tuple[int, ...]:
    """The largest head dim of each band of the general kernel that takes
    ``dtype`` (float32 or bfloat16), smallest first, as the library's band
    table has them; the last is the dtype's limit.  Builds the library;
    needs a card."""
    vals = (ctypes.c_int * 16)()
    _build.launch(_lib(), "flash_attention_general_bands", _DTYPES[dtype], len(vals),
                  ctypes.addressof(vals), device=None)
    return tuple(vals[1:1 + vals[0]])


def general_attributes(dtype: torch.dtype, d: int) -> dict[str, int]:
    """What the loaded general kernel that takes ``dtype`` (float32 or
    bfloat16) at head dim ``d`` is: its band's registers a thread, local
    memory a thread (spills and stack) and static shared memory a block as
    ``cudaFuncGetAttributes`` reads them, the dynamic shared memory a
    launch at ``d`` asks for, and the band's keys a KV tile, threads and
    query rows a block.  Head dims come in bands of one kernel instance
    each (``csrc/flash_attention.cu``).  Builds the library; needs a card;
    raises for a head dim the route refuses."""
    vals = (ctypes.c_int * 7)()
    _build.launch(_lib(), "flash_attention_general_attributes", _DTYPES[dtype], d,
                  ctypes.addressof(vals), device=None)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "block_k", "threads", "block_q"), vals))


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


def _route_for(dtype: torch.dtype, d: int) -> str:
    """The route a call of this dtype and head dim takes on the card."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "general"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q`` (B, Sq, Hq, D), ``k`` and ``v`` (B, Sk, Hkv, D), all float32 or
    all bfloat16 and contiguous -> (B, Sq, Hq, D) in q's dtype: GQA
    attention, causal (top-left aligned) with an optional trailing
    ``window``, in float32 with an online softmax.  On the card the dtype
    and head dim choose the route.  On the general route the head dim must
    be a multiple of 16 whose tiles fit a block's shared memory (up to 320
    in bfloat16, 208 in float32); each launcher refuses what it cannot
    take, and a grid it cannot launch, and the wrapper raises.  The general
    route computes float32 exactly (no TF32); in bfloat16 both routes feed
    P to the PV product as two bfloat16 parts, hi = bf16(P) and lo =
    bf16(P - hi), so P keeps float32's accuracy there."""
    return _flash_attention(q, k, v, causal=causal, window=window)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     route: str | None = None) -> torch.Tensor:
    """:func:`flash_attention` with its checks, on ``route`` where one is
    named: measurements and card tests hold the general kernel to the sm90
    one's shapes this way; the sm90 route takes only what it covers."""
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
    chosen = _route_for(q.dtype, d)
    if route is not None:
        if route not in _ENTRY:
            raise ValueError(f"route {route!r}: want one of {tuple(_ENTRY)}")
        if route == "sm90" and chosen != "sm90":
            raise ValueError(f"the sm90 route takes bfloat16 with D in "
                             f"{sorted(SM90_HEAD_DIMS)}, got {q.dtype}, D = {d}")
        chosen = route
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned")
    out = torch.empty_like(q)
    if b and sq and hq:
        lib = _lib() if chosen == "general" else _lib_sm90()
        _build.launch(lib, _ENTRY[chosen], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv, d,
                      ctypes.c_float(d ** -0.5), int(bool(causal)), int(window),
                      _DTYPES[q.dtype], _stream(q), device=q.device)
        flash_attention.launches += 1
        flash_attention.route_launches[chosen] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(_ENTRY, 0)


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(_ENTRY, 0)


def launch_counts() -> dict[str, int]:
    return {"flash_attention": flash_attention.launches}


def route_counts() -> dict[str, int]:
    """Launches by route since the last reset; they add up to
    ``launch_counts()["flash_attention"]``."""
    return dict(flash_attention.route_launches)
