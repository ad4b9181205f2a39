"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4 experts.
24L d_model=2048 16H (kv=16) d_ff=1408/expert vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B]  60 experts padded to 64 for 16-way EP."""

from repro_torch.models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=151_936, block_kind="moe",
        moe=MoEConfig(num_experts=60, num_shared=4, top_k=4, d_expert=1408,
                      padded_experts=64),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=512, block_kind="moe",
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_expert=32),
        remat=False,
    )
