"""seamless-m4t-large-v2 [audio]: encoder-decoder, multimodal backbone.
24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]

The speech frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, S/4, d) to the 24-layer bidirectional encoder; the 24-layer
decoder cross-attends.  vocab padded 256206 -> 256208 for 16-way TP."""

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=8192, vocab_size=256_206, vocab_padded=256_208,
        encoder_layers=24, frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=510, vocab_padded=512,
        encoder_layers=2, frontend="audio", remat=False,
    )
