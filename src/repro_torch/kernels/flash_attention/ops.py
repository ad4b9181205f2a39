"""Public flash attention (the counterpart of
``repro.kernels.flash_attention.ops``): the CUDA kernel of
:mod:`.flash_attention` on CUDA tensors, its plain PyTorch version on CPU
tensors.  The tensors' device selects; there is no ``use_pallas`` switch.

:func:`mha` calls B7 as the operator ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``), so the dry run can count it as B7 where no
kernel can run:

- its fake implementation returns the output's shape alone (fake and meta
  tensors: the dry run's memory sees B7's output and nothing else);
- its FLOP formula (:func:`flop_count`) counts the products on the keys
  each query sees, under the causal mask and the window;
- its DTensor sharding rule (:func:`sharding_strategies`, registered by
  :func:`register_sharding_rule`) splits the batch, or the heads where
  both the query and the kv heads divide.

On real tensors the operator's body is the wrapper, one launch a call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import flash_attention as _k

__all__ = ["mha", "flop_count", "keys_seen", "sharding_strategies", "register_sharding_rule"]


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int) -> torch.Tensor:
    return _k.flash_attention(q, k, v, causal=causal, window=window)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


def keys_seen(sq: int, sk: int, causal: bool, window: int) -> int:
    """Query-key pairs B7 computes for one (batch, head): every key for a
    non-causal call; under its top-left causal mask query i sees keys
    max(0, i - w + 1)..min(i, Sk - 1), w the window (0: no window)."""
    if not causal:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else 0
    return int(np.clip(np.minimum(i, sk - 1) - lo + 1, 0, None).sum())


def flop_count(q_shape, k_shape, v_shape, causal: bool, window: int, *args,
               out_shape=None, **kwargs) -> int:
    """B7's FLOPs: 4 * B * Hq * D for every query-key pair it computes (a
    multiply-add each in QK^T and in PV)."""
    b, sq, hq, d = q_shape
    return 4 * b * hq * d * keys_seen(sq, k_shape[1], causal, window)


def sharding_strategies(q, k, v, causal, window):
    """B7's DTensor placements, each a (output, inputs) pair for one mesh
    dim: everything replicated; the batch split; or the heads split, where
    the query and the kv heads both divide every mesh dim (GQA pairs query
    head i with kv head i // (Hq / Hkv), which only an even split keeps)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [([Replicate()], [Replicate(), Replicate(), Replicate(), None, None]),
           ([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None])]
    hq, hkv = q.tensor_meta.shape[2], k.tensor_meta.shape[2]
    if all(hq % n == 0 and hkv % n == 0 for n in q.mesh.shape):
        out.append(([Shard(2)], [Shard(2), Shard(2), Shard(2), None, None]))
    return out


register_flop_formula(torch.ops.repro_torch.flash_attention)(flop_count)


@functools.cache
def register_sharding_rule() -> None:
    """Register :func:`sharding_strategies` with DTensor (once; importing
    ``torch.distributed.tensor`` costs about a second, so the card paths,
    which never shard, do not pay it)."""
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.flash_attention.default)(sharding_strategies)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    return torch.ops.repro_torch.flash_attention(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), bool(causal), int(window))
