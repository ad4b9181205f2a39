"""The frozen count of useful work, and the table of peaks.

Every count here follows from a configuration file's published keys and a
cell's shapes alone, whatever implements the work, so that a later kernel
cannot read as a gain it did not make:

- the weight products of each block are counted at 2 FLOP a multiply-add,
  for every token: the attention projections, the dense MLP, or the MoE
  router over the real experts, the top-k routed experts and the shared
  experts (capacity padding and padded experts are not counted);
- causal attention is 4 * D FLOP for every (query, key) pair of a head
  that the causal mask keeps, at the published head size D (96 stays 96,
  whatever the kernel pads it to);
- the LM head is counted at the last position of each row in prefill,
  and at every position in training;
- training is 3 times the forward's weight products (the backward is
  twice the forward) and 3.5 times attention's (the backward at 2.5 times
  the forward, as FlashAttention counts it); recomputation is not counted.

Norms, softmax and other elementwise work are not counted.
"""

from __future__ import annotations

# Published dense peaks (NVIDIA H100 SXM data sheet), keyed by the name that
# torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_per_s": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> dict | None:
    """The peaks of a device by name, or None for a device not in the table."""
    return PEAKS.get(device_kind)


def dims(cfg: dict) -> dict:
    """The sizes the count needs, from a configuration file's keys."""
    d = cfg["hidden_size"]
    hq = cfg["num_attention_heads"]
    out = {
        "layers": cfg["num_hidden_layers"], "d": d, "hq": hq,
        "hkv": cfg.get("num_key_value_heads", hq),
        "head_dim": cfg.get("head_dim") or d // hq,
        "d_ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
        "experts": cfg.get("num_experts", 0),
    }
    if out["experts"]:
        out.update(top_k=cfg["num_experts_per_tok"], d_expert=cfg["moe_intermediate_size"],
                   d_shared=cfg.get("shared_expert_intermediate_size", 0))
    return out


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask keeps in one (row, head)."""
    return seq * (seq + 1) // 2


def block_flops_per_token(cfg: dict) -> float:
    """Weight products of all blocks for one token (no attention core, no
    head)."""
    m = dims(cfg)
    d, dh = m["d"], m["head_dim"]
    proj = 2 * d * dh * (2 * m["hq"] + 2 * m["hkv"])          # q, k, v, o
    if m["experts"]:
        ffn = (2 * d * m["experts"]                             # router, real experts
               + 6 * d * m["d_expert"] * m["top_k"]             # routed SwiGLU
               + 6 * d * m["d_shared"])                         # shared SwiGLU
    else:
        ffn = 6 * d * m["d_ff"]                                 # SwiGLU
    return float(m["layers"] * (proj + ffn))


def head_flops(cfg: dict) -> float:
    """The LM head at one position."""
    m = dims(cfg)
    return 2.0 * m["d"] * m["vocab"]


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """Causal attention's forward over all layers for ``batch`` rows of
    ``seq`` tokens: 4 * D a kept pair a head."""
    m = dims(cfg)
    return 4.0 * m["head_dim"] * causal_pairs(seq) * batch * m["hq"] * m["layers"]


def attention_bytes(cfg: dict, batch: int, seq: int) -> float:
    """Attention's forward bytes over all layers in bf16: q, k, v read once
    and the output written once."""
    m = dims(cfg)
    return 2.0 * batch * seq * m["head_dim"] * (2 * m["hq"] + 2 * m["hkv"]) * m["layers"]


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """One prefill of ``batch`` rows of ``seq`` tokens, the head at each
    row's last position."""
    return (batch * seq * block_flops_per_token(cfg) + attention_flops(cfg, batch, seq)
            + batch * head_flops(cfg))


def train_attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """Attention's forward and backward in one training step."""
    return 3.5 * attention_flops(cfg, batch, seq)


def train_attention_bytes(cfg: dict, batch: int, seq: int) -> float:
    """Attention's bytes in one training step: the forward's, and in the
    backward q, k, v, the output and its gradient read and dq, dk, dv
    written."""
    m = dims(cfg)
    fwd = attention_bytes(cfg, batch, seq)
    bwd = 2.0 * batch * seq * m["head_dim"] * (4 * m["hq"] + 4 * m["hkv"]) * m["layers"]
    return fwd + bwd


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """One training step on ``batch`` rows of ``seq`` tokens, the head at
    every position."""
    tokens = batch * seq
    return (3.0 * tokens * (block_flops_per_token(cfg) + head_flops(cfg))
            + train_attention_flops(cfg, batch, seq))


def roofline_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / peak["bf16_flop_per_s"], nbytes / peak["hbm_bytes_per_s"])
