"""falcon-mamba-7b [ssm]: mamba1, attention-free.
64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16 [arXiv:2410.05355]"""

from repro_torch.models.common import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
        head_dim=1, d_ff=0, vocab_size=65_024, block_kind="mamba",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        subquadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
        head_dim=1, d_ff=0, vocab_size=512, block_kind="mamba",
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
        subquadratic=True, remat=False,
    )
