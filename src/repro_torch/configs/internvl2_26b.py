"""internvl2-26b [vlm]: InternViT frontend (STUB) + InternLM2 backbone.
48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821; hf]

vocab padded 92553 -> 92560 for 16-way TP (pad logits masked to -inf);
the vision frontend supplies 256 patch embeddings via ``input_specs()``."""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92_553, vocab_padded=92_560,
        frontend="vision", vision_tokens=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=509, vocab_padded=512,
        frontend="vision", vision_tokens=8, remat=False,
    )
