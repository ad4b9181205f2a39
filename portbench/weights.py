"""The benchmark's weights and token ids, made from ``--seed`` on the device.

The parameter tree has the layout the program's model takes (``embed``,
``lm_head``, ``stack`` -> ``period`` -> block groups stacked on a leading
layer axis, ``tail``, ``final_norm``); its shapes and dtypes follow from a
configuration file.  Each leaf is drawn by a generator of its own, seeded
from the run's seed and the leaf's path, straight in the dtype it is served
in, one call a slice of at most 2^30 elements.  So any leaf can be drawn
again alone, the same to the bit.

Scales: a product's weight is normal with std 1/sqrt(fan-in), so every
activation keeps unit scale through the depth; the embedding 0.02 (the model
scales it by sqrt(d)); the RMSNorm gains are float32 normal with std 0.1
around the model's 1 + w.

Routers are set as a trained router is: after drawing,
:func:`balance_routers` passes one calibration request of the seed through
the plain reference layer by layer and makes each expert's logit zero-mean
over its tokens (the tokens' mean hidden state projected out of its
column) with a spread of 3, so a token's gates are confident (the top
expert carries about two thirds of the top four's weight) and a tie
between its fourth and fifth expert is rare.
"""

from __future__ import annotations

import hashlib
import math

import torch

_SLICE = 2**30
_NORM_STD = 0.1
_EMBED_STD = 0.02
_CALIBRATION_TOKENS = 4096
_ROUTER_SPREAD = 3.0


def sub_seed(seed: int, *what) -> int:
    """A seed for one use of the run's seed (below 2^63)."""
    h = hashlib.sha256(repr((int(seed),) + what).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def layout(cfg: dict) -> dict:
    """The parameter tree as (shape, dtype, fan-in dims) leaves: the
    products' weights in the run's parameter dtype, norms and the router in
    float32."""
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    hkv = cfg.get("num_key_value_heads", hq)
    dh = cfg.get("head_dim") or d // hq
    n, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    bf, f32 = getattr(torch, cfg["run"]["param_dtype"]), torch.float32
    mixer = {"wq": ((n, d, hq, dh), bf, (1,)), "wk": ((n, d, hkv, dh), bf, (1,)),
             "wv": ((n, d, hkv, dh), bf, (1,)), "wo": ((n, hq, dh, d), bf, (1, 2)),
             "norm": ((n, d), f32, None)}
    if "num_experts" in cfg:
        e = int(cfg["run"].get("padded_experts") or cfg["num_experts"])
        de, ds = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
        block = {"mixer": mixer, "moe": {
            "norm": ((n, d), f32, None), "router": ((n, d, e), f32, "router"),
            "we_in": ((n, e, d, de), bf, (2,)), "we_gate": ((n, e, d, de), bf, (2,)),
            "we_out": ((n, e, de, d), bf, (2,)),
            "ws_in": ((n, d, ds), bf, (1,)), "ws_gate": ((n, d, ds), bf, (1,)),
            "ws_out": ((n, ds, d), bf, (1,))}}
    else:
        f = cfg["intermediate_size"]
        block = {"mixer": mixer, "mlp": {
            "norm": ((n, d), f32, None), "w_in": ((n, d, f), bf, (1,)),
            "w_out": ((n, f, d), bf, (1,)), "w_gate": ((n, d, f), bf, (1,))}}
    tree = {"embed": ((v, d), bf, "embed"),
            "stack": {"period": [block], "tail": [], "final_norm": ((d,), f32, None)}}
    if not cfg.get("tie_word_embeddings", True):
        tree["lm_head"] = ((d, v), bf, (0,))
    return tree


def _is_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[1], torch.dtype)


def leaf_paths(tree, prefix: tuple = ()):
    """(path, leaf) of every leaf, in tree order."""
    if _is_leaf(tree) or isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (k,))
    else:
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))


def _set(tree, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def draw_leaf(cfg: dict, seed: int, path: tuple, spec, device) -> torch.Tensor:
    """One leaf of the tree, drawn from its own generator."""
    shape, dtype, fan = spec
    if fan is None:
        std = _NORM_STD
    elif fan == "embed":
        std = _EMBED_STD
    elif fan == "router":
        std = 1.0 / math.sqrt(shape[-2])
    else:
        std = 1.0 / math.sqrt(math.prod(shape[i] for i in fan))
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", *path))
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, _SLICE // max(1, math.prod(shape[1:])))
    for lo in range(0, shape[0], rows):
        out[lo:lo + rows].normal_(0.0, std, generator=g)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The whole tree for ``seed`` on ``device``, routers balanced."""
    tree = layout(cfg)
    for path, spec in list(leaf_paths(tree)):
        _set(tree, path, draw_leaf(cfg, seed, path, spec, device))
    if "num_experts" in cfg:
        ids = token_pool(seed, "router-calibration", 1, 1, _CALIBRATION_TOKENS,
                         cfg["vocab_size"], device)[0]
        balance_routers(cfg, tree, ids)
    return tree


@torch.no_grad()
def balance_routers(cfg: dict, params: dict, ids: torch.Tensor) -> None:
    """Rewrite each layer's router in place so that, over the tokens of
    ``ids`` as they reach that layer (float32, earlier routers already
    set), every expert's logit has mean 0 (the tokens' mean hidden state is
    projected out of its column) and standard deviation
    :data:`_ROUTER_SPREAD`."""
    from portbench.reference.model import Reference, rms_norm

    ref = Reference(cfg, params)
    routers = params["stack"]["period"][0]["moe"]["router"]
    x = ref.embed(ids)
    for i in range(ref.layers):
        w = ref.layer_weights(i)
        x = x + ref.attention(w["mixer"], x)
        h = rms_norm(x, w["moe"]["norm"], ref.eps).reshape(-1, ref.d)
        r = routers[i]
        u = h.mean(0)
        r.sub_(torch.outer(u, u @ r) / (u @ u))
        r.mul_(_ROUTER_SPREAD / (h @ r).std(0).clamp_min(1e-6))
        w["moe"]["router"] = r
        x = x + ref.moe_ffn(w["moe"], x)


def leaf_specs(cfg: dict) -> dict:
    """{path: spec} of every leaf."""
    return dict(leaf_paths(layout(cfg)))


def token_pool(seed: int, what: str, count: int, batch: int, seq: int, vocab: int,
               device) -> torch.Tensor:
    """``count`` requests of (batch, seq) token ids, int64, drawn in one call
    from one generator: request i is the same for a seed whatever else
    the run does."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "tokens", what))
    return torch.randint(0, vocab, (count, batch, seq), generator=g, device=device)
