"""deepseek-67b [dense]: llama-arch GQA.
95L d_model=8192 64H (kv=8) d_ff=22016 vocab=102400 [arXiv:2401.02954; hf]"""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=102_400,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, remat=False,
    )
