from repro_torch.kernels.bloom.ops import (
    bloom_detect_conflicts,
    bloom_insert,
    bloom_intersect,
    bloom_query,
)

__all__ = ["bloom_insert", "bloom_query", "bloom_detect_conflicts",
           "bloom_intersect"]
