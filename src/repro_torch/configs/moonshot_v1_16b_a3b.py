"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 routed top-6 + 2 shared.
48L d_model=2048 16H (kv=16) d_ff=1408/expert vocab=163840
[hf:moonshotai/Moonlight-16B-A3B]"""

from repro_torch.models.common import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163_840, block_kind="moe",
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_expert=1408),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=512, block_kind="moe",
        moe=MoEConfig(num_experts=8, num_shared=1, top_k=2, d_expert=32),
        remat=False,
    )
