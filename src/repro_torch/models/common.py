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
* **Sharding by constraint.** Parameters and activations name *logical
  axes*; a rule set maps them to mesh axes (the reference's MaxText
  pattern; the launch mesh's rules are in ``repro_torch.launch.mesh``).
  :func:`param_shardings` resolves each parameter to DTensor placements,
  one per mesh dim, and :func:`abstract_params` gives meta tensors for the
  dry run (no allocation).  Inside a :func:`sharding_ctx`, :func:`constrain`
  redistributes a DTensor activation to its logical axes' placements (the
  reference's ``with_sharding_constraint``); outside one it returns its
  input at the cost of one attribute read, so the card paths run the same
  code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Logical-axis machinery
# ---------------------------------------------------------------------------

# Default logical-axis -> mesh-axis rules (single-pod).  The launcher swaps in
# multi-pod rules (see repro_torch.launch.mesh.LOGICAL_RULES_*).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("data",),
    "embed": ("data",),      # FSDP: shard the d_model dim of weights over data
    "embed_table": ("data",),  # the token-embedding's d dim (separable knob)
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "seq": None,             # activations: sequence dim (SP shards this)
    "seq_sp": ("model",),    # sequence-parallel boundary activations
    "kv_seq": ("model",),    # decode KV cache: sequence dim
    "rnn": ("model",),       # recurrent/SSM channel dim
    "state": None,           # SSM state dim (16) — too small to shard
    "layers": None,
    "conv": None,
    None: None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim sizes and names with no devices and no process group
    (``jax.sharding.AbstractMesh``'s counterpart): enough to resolve
    placements and shard shapes.  Its attributes are the ones the port
    reads from a ``DeviceMesh``."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class _ShardCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, Any] = dict(DEFAULT_RULES)
        self.regions: dict[str, int] = {}


_CTX = _ShardCtx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict[str, Any] | None = None):
    """Activate a mesh + logical-rule set for constrain()/logical_to_spec()."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.regions)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    _CTX.regions = {}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.regions = prev


def active_mesh():
    """The mesh of the innermost :func:`sharding_ctx`, or None."""
    return _CTX.mesh


def _resolve_axes(logical_axes: tuple[Any, ...], rules, mesh,
                  shape: tuple[int, ...] | None = None) -> tuple:
    """Logical axes -> a partition spec: one entry a tensor dim, None or
    the tuple of mesh axes it shards over (``jax.sharding.PartitionSpec``'s
    entries).  A mesh axis is only assigned to a dim when the dim size is
    divisible by the (cumulative) axis size, and each mesh axis is used
    once — e.g. a GQA model with 8 KV heads on a 16-way model axis simply
    replicates its KV projections instead of failing to shard."""
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    out = []
    for i, ax in enumerate(logical_axes):
        mesh_ax = rules.get(ax, None)
        if mesh_ax is None:
            out.append(None)
            continue
        if isinstance(mesh_ax, str):
            mesh_ax = (mesh_ax,)
        picked: list[str] = []
        size = 1
        for m in mesh_ax:
            if m not in sizes or m in used:
                continue
            nxt = size * sizes[m]
            if shape is not None and shape[i] % nxt != 0:
                continue
            picked.append(m)
            size = nxt
        used.update(picked)
        out.append(tuple(picked) if picked else None)
    return tuple(out)


def spec_placements(spec: tuple, mesh) -> tuple:
    """A partition spec as DTensor placements, one per mesh dim: ``Shard(i)``
    where tensor dim ``i`` lists the mesh axis, ``Replicate()`` elsewhere.
    A dim sharded over several mesh axes splits in mesh-dim order, as the
    reference's ``("pod", "data")`` does."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {m: i for i, axes in enumerate(spec) if axes for m in axes}
    return tuple(Shard(owner[m]) if m in owner else Replicate()
                 for m in mesh.mesh_dim_names)


def shard_shape(shape: tuple[int, ...], mesh, placements) -> tuple[int, ...]:
    """The shape of the first shard of a ``shape`` tensor under
    ``placements`` on ``mesh`` (``NamedSharding.shard_shape``): each
    ``Shard(i)`` divides dim i by its mesh dim's size, rounding up as
    ``torch.chunk`` does."""
    out = list(shape)
    for size, p in zip(tuple(mesh.shape), placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // size)
    return tuple(out)


def logical_to_spec(logical_axes: tuple[Any, ...],
                    shape: tuple[int, ...] | None = None) -> tuple:
    """The placements of ``logical_axes`` under the active
    :func:`sharding_ctx`, one per mesh dim; ``()`` outside one."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return ()
    return spec_placements(_resolve_axes(tuple(logical_axes), rules, mesh, shape), mesh)


def local_region(name: str, fn: Callable, *args, whole: tuple[int, ...] = (),
                 replicate: bool = False):
    """``fn(*args)``, for a function written for plain tensors (an op with
    no DTensor rule, or in-place writes into slices).  Under a
    :func:`sharding_ctx` with DTensor arguments it runs on each rank's
    local shards (``local_map``'s pattern).  The first DTensor argument's
    placements, partial sums reduced and made whole along the tensor dims
    ``whole`` (``fn`` must act on every index of the other sharded dims on
    its own, as a scan over dim 1 does), are given to every DTensor
    argument of its rank and to every tensor output of its rank; other
    arguments keep their placements, partial sums reduced (a weight whose
    channels shard as the activation's do); other outputs are replicated.
    ``replicate`` replicates everything.  ``name`` is counted in the context's :func:`regions`, so
    a dry run lists where it left DTensor."""
    mesh = _CTX.mesh
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    _CTX.regions[name] = _CTX.regions.get(name, 0) + 1
    replicated = (Replicate(),) * mesh.ndim

    def made_whole(placements):
        if replicate:
            return replicated
        return tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim in whole) else p
                     for p in placements)

    def reduced(placements):
        return replicated if replicate else tuple(
            Replicate() if p.is_partial() else p for p in placements)

    ndim, placements = dts[0].ndim, made_whole(dts[0].placements)

    def to_local(a):
        if not isinstance(a, DTensor):
            return a
        want = placements if a.ndim == ndim else reduced(a.placements)
        return a.redistribute(mesh, want).to_local()

    def from_local(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, placements if t.ndim == ndim else replicated,
                                  run_check=False)

    return tree_map(from_local, fn(*(to_local(a) for a in args)))


def gather_fsdp(tree):
    """Under a :func:`sharding_ctx`: every DTensor parameter of ``tree``
    made whole along the mesh axes its ``embed`` / ``embed_table`` dims
    shard over (FSDP: a layer's weights are gathered while it computes, and
    the backward of the gather reduce-scatters their gradients), so the
    products shard over the batch and not over d_model.  Outside one,
    ``tree`` itself."""
    mesh = _CTX.mesh
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate

    axes: set[str] = set()
    for name in ("embed", "embed_table"):
        v = _CTX.rules.get(name)
        axes |= {v} if isinstance(v, str) else set(v or ())

    def one(t):
        if not isinstance(t, DTensor):
            return t
        want = tuple(Replicate() if n in axes and p.is_shard() else p
                     for n, p in zip(mesh.mesh_dim_names, t.placements))
        return t if want == tuple(t.placements) else t.redistribute(mesh, want)

    return tree_map(one, tree)


def regions() -> dict[str, int]:
    """Calls of each :func:`local_region` inside the active
    :func:`sharding_ctx` so far."""
    return dict(_CTX.regions)


# ---------------------------------------------------------------------------
# Spans and counters (recorded only while a torch.profiler profile records)
# ---------------------------------------------------------------------------

_PROFILER = torch.autograd.profiler  # its _is_profiler_enabled: a profile is recording
_NO_SPAN = contextlib.nullcontext()
_COUNTS: dict[str, Any] = {}


def span(name: str, args: Any = None):
    """A ``torch.profiler.record_function`` range ``name`` (``args``, made a
    string, its argument) while a profile is recording, so that it lies in
    the kineto trace on the device operations' clock; otherwise a shared
    no-op context, at the cost of one flag check."""
    if not _PROFILER._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name, None if args is None else str(args))


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a profile is recording;
    nothing otherwise.  A host int adds on the host; a tensor's sum adds
    into a 0-dim int64 tensor on its device, without waiting for it."""
    if not _PROFILER._is_profiler_enabled:
        return
    if not isinstance(value, torch.Tensor):
        _COUNTS[name] = _COUNTS.get(name, 0) + int(value)
        return
    acc = _COUNTS.get(name)
    if acc is None:
        # a plain tensor, so that it takes adds inside and outside inference mode
        with torch.inference_mode(False):
            acc = _COUNTS[name] = torch.zeros((), dtype=torch.int64, device=value.device)
    acc.add_(value.detach().sum())


def counters() -> dict[str, int]:
    """``{counter: total}`` since the last :func:`reset_counters`; the
    device counters are read with one synchronization."""
    on_dev = [n for n, v in _COUNTS.items() if isinstance(v, torch.Tensor)]
    out = {n: v for n, v in _COUNTS.items() if n not in on_dev}
    if on_dev:
        out.update(zip(on_dev, torch.stack([_COUNTS[n] for n in on_dev]).tolist()))
    return out


def reset_counters() -> None:
    _COUNTS.clear()


def constrain(x: torch.Tensor, *logical_axes: Any) -> torch.Tensor:
    """Redistribute ``x`` to its logical axes' placements under the active
    :func:`sharding_ctx` (``with_sharding_constraint``; a plain tensor
    counts as replicated, as DTensor's implicit replication takes it);
    without one, ``x`` itself."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    placements = logical_to_spec(logical_axes, tuple(x.shape))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


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


def abstract_params(spec_tree):
    """Meta tensors of each ParamSpec's shape and dtype, for the dry run
    (never allocates)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    spec_tree, is_spec_leaf)


def param_shardings(spec_tree, mesh, rules: dict[str, Any] | None = None):
    """The DTensor placements of every ParamSpec, resolved from its logical
    axes (one placement a mesh dim)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return tree_map(lambda s: spec_placements(_resolve_axes(s.axes, rules, mesh, s.shape), mesh),
                    spec_tree, is_spec_leaf)


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
        m = m & (k_pos[None, :] > (q_pos[:, None] - window))
    return m


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """Mean next-token xent; padded vocab rows masked out. logits (..., V)."""
    logits = logits.to(torch.float32)
    if vocab_real < logits.shape[-1]:
        neg = torch.finfo(torch.float32).min
        pad_mask = torch.arange(logits.shape[-1], device=logits.device) >= vocab_real
        logits = torch.where(pad_mask, neg, logits)
    if _CTX.mesh is not None:
        return torch.mean(constrain(_sharded_xent_terms(logits, labels), "batch", "seq"))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].to(torch.int64), dim=-1)[..., 0]
    return torch.mean(logz - gold)


def _sharded_xent_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logz - gold for float32 logits whose vocab dim may be sharded (under
    a :func:`sharding_ctx`), in ops that reduce a sharded dim by partial
    results: the max, then the sum of exponentials, each reduced over the
    ranks (``logsumexp`` would gather the logits); the gold logit as the
    sum of the row masked to its label (the gather's gradient would
    scatter into a replicated zeros of the global logits' shape).  The
    same values as the dense form: one nonzero term a row."""
    def whole(t):  # a row's (B, S, 1) statistic, on every rank of the vocab's axis
        return constrain(t, "batch", "seq", None)

    m = whole(logits.amax(dim=-1, keepdim=True))
    m = torch.where(torch.isinf(m), 0.0, m)
    logz = torch.log(whole(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True))) + m
    # the ids as (B, 1, V), sharded on batch and vocab: the comparison
    # follows the operand with the most shards, so the (B, S, V) mask and
    # its gradient's ``where`` keep the vocab sharded (ids of shape (V,)
    # tie with the labels, and some torch versions then follow the labels
    # and build the mask at the whole vocab)
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    vocab_ids = constrain(vocab_ids.expand(labels.shape[0], 1, -1), "batch", None, "vocab")
    hit = vocab_ids == labels[..., None]
    gold = whole(torch.where(hit, logits, 0.0).sum(dim=-1, keepdim=True))
    return (logz - gold)[..., 0]
