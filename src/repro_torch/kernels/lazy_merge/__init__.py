from repro_torch.kernels.lazy_merge.ops import lazy_merge

__all__ = ["lazy_merge"]
