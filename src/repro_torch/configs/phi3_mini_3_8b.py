"""phi3-mini-3.8b [dense]: RoPE SwiGLU, full MHA (kv=heads).
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064 [arXiv:2404.14219]"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32_064,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, remat=False,
    )
