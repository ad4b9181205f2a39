from repro_torch.kernels.flash_attention.ops import mha

__all__ = ["mha"]
