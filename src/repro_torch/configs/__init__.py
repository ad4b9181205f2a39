"""Architecture registry, PyTorch port of :mod:`repro.configs`:
``get_config(name)`` / ``get_smoke_config(name)``.

Every architecture of the reference is named in :data:`ARCHS`; the
decoder-only ones are ported (:data:`PORTED`: ``qwen3_4b``, which the
serving and LazySync paths drive at full width, ``phi3_mini_3_8b``,
``deepseek_67b``, ``nemotron_4_340b``, the MoE pair ``qwen2_moe_a2_7b``,
served at full width too, and ``moonshot_v1_16b_a3b``, the SSM
``falcon_mamba_7b`` and the hybrid ``recurrentgemma_2b``, both served at
full width), with ``config()`` and ``smoke()`` copied field for field.
The encoder-decoder and VLM ones raise a ``ValueError`` naming the slice
of the port that brings them (ROADMAP A11).
"""

from __future__ import annotations

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

PORTED = ("qwen3_4b", "phi3_mini_3_8b", "deepseek_67b", "nemotron_4_340b",
          "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b", "falcon_mamba_7b",
          "recurrentgemma_2b")

_LATER = {
    "seamless_m4t_large_v2": "the enc-dec / VLM slice",
    "internvl2_26b": "the enc-dec / VLM slice",
}


def _module(name: str):
    key = name.replace("-", "_").replace(".", "_")
    key = ALIASES.get(name, key)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALIASES)}")
    if key not in PORTED:
        raise ValueError(f"arch {name!r} is not ported yet: it comes with "
                         f"{_LATER[key]} of the port's model zoo (ROADMAP A11); "
                         f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
