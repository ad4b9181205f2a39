"""Shared model substrate, PyTorch port of :mod:`repro.models.common`:
spec-driven parameters, the architecture records, norms, RoPE,
activations, masks and the cross entropy.

* **Spec-driven parameters.** Every architecture declares its parameters
  once as a tree (nested dicts and lists) of :class:`ParamSpec`;
  :func:`init_params` materializes it from a ``torch.Generator`` on the
  generator's device.  The numbers differ from the reference's
  ``jax.random`` draw: :func:`tensor_from_numpy` (and
  ``repro_torch.models.model.params_from_jax``) carry the reference's
  arrays across bit for bit where a test needs the same weights.
* **bf16 by default** (``param_dtype``) with float32 norm and RoPE math,
  cast back to the input's dtype, as the reference computes them.
* The reference's logical-axis sharding machinery (``constrain``,
  ``sharding_ctx``, ``param_shardings``, ``abstract_params``) carries mesh
  shardings that the one-card port has no use for and is not ported
  (ROADMAP §C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axes + dtype + init scale."""

    shape: tuple[int, ...]
    axes: tuple[Any, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | small_normal
    scale: float | None = None  # overrides fan-in scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes "
                             f"{self.axes} differ in length")


def is_spec_leaf(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, is_leaf: Callable | None = None):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples
    (``is_leaf`` may stop the descent early), keeping its structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    """The leaves of a tree of dicts, lists and tuples, in insertion order."""
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (an iterable) in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# Largest leaf drawn in one piece (2^30 elements, 4 GiB of float32 scratch);
# qwen2-moe-a2.7b's stacked experts (24 x 64 x 2,048 x 1,408, 4.4e9
# elements) are drawn in slices.
_DRAW_CHUNK = 2**30


def _materialize(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "small_normal":
        std = spec.scale if spec.scale is not None else 0.02
    else:  # fan-in normal
        fan_in = spec.shape[0] if len(spec.shape) == 1 else math.prod(spec.shape[:-1])
        std = spec.scale if spec.scale is not None else (1.0 / max(1.0, fan_in)) ** 0.5
    if math.prod(spec.shape) <= _DRAW_CHUNK:
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=dev)
        return x.mul_(std).to(spec.dtype)
    # a leaf past _DRAW_CHUNK elements is drawn a slice of its leading axis
    # at a time, so the float32 scratch stays one slice
    out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    rows = max(1, _DRAW_CHUNK // math.prod(spec.shape[1:]))
    for i in range(0, spec.shape[0], rows):
        x = torch.randn((min(rows, spec.shape[0] - i),) + spec.shape[1:],
                        generator=generator, dtype=torch.float32, device=dev)
        out[i:i + x.shape[0]] = x.mul_(std)
    return out


def init_params(spec_tree, generator: torch.Generator):
    """Materialize a ParamSpec tree into tensors on ``generator.device``,
    leaf by leaf in tree order from the one generator (the reference splits
    one key per leaf: the numbers differ, the distributions do not)."""
    return tree_map(lambda s: _materialize(s, generator), spec_tree, is_spec_leaf)


def param_count(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(spec_tree, is_spec_leaf)))


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One array of a reference tree (numpy, e.g. ``np.asarray`` of a jax
    array) as a contiguous tensor on ``device``: bfloat16 (``ml_dtypes``)
    crosses as its 16-bit patterns viewed as ``torch.bfloat16``, float32 as
    is, bit for bit either way."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16)).view(np.int16))
        t = t.view(torch.bfloat16)
    elif a.dtype == np.float32:
        t = torch.from_numpy(np.array(a))
    else:
        raise TypeError(f"dtype {a.dtype}: want float32 or bfloat16")
    return t.to(device).contiguous()


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_shared: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    padded_experts: int | None = None  # pad for divisibility (router masked)

    @property
    def num_routed_padded(self) -> int:
        return self.padded_experts or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # defaults to ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int
    d_conv: int = 4
    c_exponent: float = 8.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture. Block kinds: 'attn', 'swa' (sliding-window
    attention), 'moe', 'mamba', 'rglru'.  The fields and defaults are the
    reference's; see :class:`repro.models.common.ModelConfig` for what each
    knob does in the model zoo."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_kind: str = "attn"
    block_pattern: tuple[str, ...] | None = None
    window_size: int = 0
    rope_theta: float = 10000.0
    qk_norm: bool = False
    mlp_act: str = "swiglu"          # swiglu | relu2 | gelu
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    recurrent: RecurrentConfig | None = None
    encoder_layers: int = 0
    frontend: str | None = None      # None | 'vision' | 'audio'
    vision_tokens: int = 256
    audio_downsample: int = 4
    vocab_padded: int | None = None  # padded for TP divisibility
    tie_embeddings: bool = True
    param_dtype: torch.dtype = torch.bfloat16
    opt_dtype: torch.dtype = torch.float32
    remat: bool = True
    moe_dispatch: str = "sort"
    moe_combine_f32: bool = True
    decode_direct_attn: bool = False
    loss_chunk: int = 0
    remat_policy: str = "nothing"
    scan_layers: bool = True
    subquadratic: bool = False

    @property
    def vocab(self) -> int:
        return self.vocab_padded or self.vocab_size

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern is not None:
            pat = self.block_pattern
            reps = -(-self.num_layers // len(pat))
            return (pat * reps)[: self.num_layers]
        return (self.block_kind,) * self.num_layers

    @property
    def homogeneous(self) -> bool:
        return len(set(self.pattern)) == 1

    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)


# ---------------------------------------------------------------------------
# Primitive layers (pure functions over tensors)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def activation(name: str, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    if name == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs a gate")
        return F.silu(gate) * x
    if name == "relu2":
        r = F.relu(x)
        return r * r
    if name == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    raise ValueError(name)


def linear_scan_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The diagonal linear recurrence h_t = a_t * h_{t-1} + b_t (h_{-1} = 0)
    along dim 1 of ``a`` and ``b`` (same shape), at log depth: the
    odd/even recursion of ``jax.lax.associative_scan`` (combine adjacent
    pairs, scan the half-length sequence, fill in the even positions),
    which the reference runs with the combine ``(a2 a1, a2 b1 + b2)``.
    Each level is a few elementwise ops on strided views, O(S) work in all.
    For inference ``b`` is overwritten with the states and returned (``a``
    is read only), so a full-width prefill keeps no second copy; where
    autograd records (grad mode on and an input requiring a gradient) the
    same recursion runs out of place (:func:`_linear_scan`), bit for bit
    the same states."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _linear_scan(a, b)
    s = a.shape[1]
    if s < 2:
        return b
    a_odd = a[:, 1::2]
    b_red = a_odd * b[:, 0:s - 1:2]
    b_red += b[:, 1::2]
    odd = linear_scan_(a_odd * a[:, 0:s - 1:2], b_red)
    b[:, 2::2] += a[:, 2::2] * odd[:, :(s - 1) // 2]
    b[:, 1::2] = odd
    return b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`linear_scan_` out of place: the same operations in the same
    order, each result a new tensor, so autograd can differentiate it."""
    s = a.shape[1]
    if s < 2:
        return b
    a_odd = a[:, 1::2]
    odd = _linear_scan(a_odd * a[:, 0:s - 1:2], a_odd * b[:, 0:s - 1:2] + b[:, 1::2])
    out = b.clone()
    out[:, 2::2] = b[:, 2::2] + a[:, 2::2] * odd[:, :(s - 1) // 2]
    out[:, 1::2] = odd
    return out


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(q, k) bool mask: causal, optionally limited to a trailing window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """Mean next-token xent; padded vocab rows masked out. logits (..., V)."""
    logits = logits.to(torch.float32)
    if vocab_real < logits.shape[-1]:
        neg = torch.finfo(torch.float32).min
        pad_mask = torch.arange(logits.shape[-1], device=logits.device) >= vocab_real
        logits = torch.where(pad_mask, neg, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].to(torch.int64), dim=-1)[..., 0]
    return torch.mean(logz - gold)
