"""Model configuration records, PyTorch port of the config part of
:mod:`repro.models.common`.

Only what :mod:`repro_torch.core.lazy_sync` and the registry in
:mod:`repro_torch.configs` need is here: :class:`ParamSpec` and the
architecture records with every field and property of the reference,
with torch dtypes (``param_dtype`` defaults to ``torch.bfloat16``).  The
logical-axis sharding machinery, the layers and the init helpers come with
the model-zoo slice of the port (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


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
