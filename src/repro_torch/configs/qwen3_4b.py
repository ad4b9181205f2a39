"""qwen3-4b [dense]: qk_norm + GQA.
36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936 [hf:Qwen/Qwen3-8B]"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=9728, vocab_size=151_936, qk_norm=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, qk_norm=True, remat=False,
    )
