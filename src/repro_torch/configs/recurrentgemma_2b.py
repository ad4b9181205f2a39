"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 pattern.
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427; hf]"""

from repro_torch.models.common import ModelConfig, RecurrentConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        block_pattern=("rglru", "rglru", "swa"), window_size=2048,
        recurrent=RecurrentConfig(lru_width=2560),
        subquadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        block_pattern=("rglru", "rglru", "swa"), window_size=32,
        recurrent=RecurrentConfig(lru_width=64),
        subquadratic=True, remat=False,
    )
