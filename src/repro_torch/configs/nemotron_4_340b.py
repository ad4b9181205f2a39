"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP.
96L d_model=18432 96H (kv=8) d_ff=73728 vocab=256000 [arXiv:2402.16819]"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
        head_dim=192, d_ff=73728, vocab_size=256_000,
        mlp_act="relu2", tie_embeddings=False,
        opt_dtype=torch.bfloat16,  # >100B: bf16 AdamW moments
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512,
        mlp_act="relu2", tie_embeddings=False, remat=False,
    )
