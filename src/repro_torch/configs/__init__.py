"""Architecture registry, PyTorch port of :mod:`repro.configs`:
``get_config(name)`` / ``get_smoke_config(name)``.

Every architecture of the reference in :data:`ARCHS`, each with its
``config()`` and ``smoke()`` copied field for field: the dense
``qwen3_4b`` (served, trained and driven by LazySync at full width),
``phi3_mini_3_8b``, ``deepseek_67b`` and ``nemotron_4_340b``; the MoE pair
``qwen2_moe_a2_7b`` and ``moonshot_v1_16b_a3b``; the SSM
``falcon_mamba_7b`` and the hybrid ``recurrentgemma_2b``; the
encoder-decoder ``seamless_m4t_large_v2`` and the VLM ``internvl2_26b``.
The four input shapes of the dry run are defined here (``SHAPES``); per
arch, ``long_500k`` runs only on sub-quadratic backbones, and every arch
has a decoder, so the decode shape applies everywhere (``shapes_for``,
``all_cells``).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCHS = (
    "recurrentgemma_2b",
    "phi3_mini_3_8b",
    "deepseek_67b",
    "nemotron_4_340b",
    "qwen3_4b",
    "seamless_m4t_large_v2",
    "qwen2_moe_a2_7b",
    "moonshot_v1_16b_a3b",
    "internvl2_26b",
    "falcon_mamba_7b",
)

# Canonical ids (hyphenated, as in the assignment) -> module names.
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    key = name.replace("-", "_").replace(".", "_")
    key = ALIASES.get(name, key)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def shapes_for(cfg: ModelConfig) -> list[str]:
    """Applicable shape cells for an arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")  # needs sub-quadratic attention
    return out


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) dry-run cell."""
    return [(a, s) for a in ARCHS for s in shapes_for(get_config(a))]
