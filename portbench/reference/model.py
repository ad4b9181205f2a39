"""The plain reference: the decoder that a configuration file describes, in
plain PyTorch, computed in float32 one layer at a time.

It reads the benchmark's weights by their names in the parameter tree that
the benchmark hands to the program (``embed``, ``lm_head``, ``stack`` ->
``final_norm``, ``period`` -> ``mixer`` / ``mlp`` / ``moe``, each stacked on
a leading layer axis), and works out everything else itself: positions,
RoPE, the causal mask, routing, capacity and every intermediate.  It
imports nothing of the program.

The equations are those of the configuration file's ``run`` group (the
port's model family):

- x = embed[ids] * bf16(sqrt(d)); each block is pre-norm with a residual;
  RMSNorm is ``x * rsqrt(mean(x^2) + eps) * (1 + w)``;
- attention: q, k, v projections, rotate-half RoPE on q and k, causal
  softmax(q k^T / sqrt(D)) v, the output projection;
- dense MLP: ``(silu(x W_gate) * x W_in) W_out``;
- MoE: float32 router over the padded experts (the padding masked),
  softmax, top-k in descending order, weights renormalised; an expert keeps
  the first ``capacity`` tokens routed to it in token order, the rest of its
  pairs drop; each token sums its kept experts' SwiGLU outputs by weight,
  plus the shared SwiGLU;
- the head is ``final_norm(x) @ lm_head``.

``precision="fp8"`` is the control: the same computation with both operands
of every product (the weights, the activations, q, k, the probabilities and
v) rounded to float8 e4m3 under one scale a tensor.  In training its
rounding passes the gradient straight through.
"""

from __future__ import annotations

import math

import torch

NEG = float("-inf")
_FP8_MAX = 448.0


def use_exact_float32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3 under one scale for the tensor;
    the rounding passes the gradient straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = _FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


class Arith:
    """The products of one precision: ``"float32"`` or ``"fp8"``."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.fp8 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)


def _f32(t: torch.Tensor, grad: bool = False) -> torch.Tensor:
    out = t.detach().to(torch.float32)
    return out.requires_grad_() if grad else out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): rotate-half RoPE at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, ar: Arith, block_bytes: int = 2**31) -> torch.Tensor:
    """q (B, S, Hq, D), k / v (B, S, Hkv, D) -> (B, S, Hq, D), causal, in
    blocks of queries so that one block's scores stay under
    ``block_bytes``."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    q, k, v = (ar.r(t).permute(0, 2, 1, 3) for t in (q, k, v))   # (B, H, S, D)
    qb = max(1, min(s, block_bytes // (4 * hq * s)))
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, qb):
        hi = min(s, lo + qb)
        sc = (q[:, :, lo:hi] @ k[:, :, :hi].transpose(-1, -2)) * d ** -0.5
        mask = pos[None, :hi] <= pos[lo:hi, None]
        p = torch.softmax(torch.where(mask, sc, NEG), dim=-1)
        outs.append(ar.r(p) @ v[:, :, :hi])
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


class Reference:
    """The configuration's decoder over the benchmark's parameter tree."""

    def __init__(self, cfg: dict, params: dict, precision: str = "float32"):
        self.cfg = cfg
        self.params = params
        self.ar = Arith(precision)
        self.eps = float(cfg["rms_norm_eps"])
        self.d = cfg["hidden_size"]
        self.hq = cfg["num_attention_heads"]
        self.hkv = cfg.get("num_key_value_heads", self.hq)
        self.dh = cfg.get("head_dim") or self.d // self.hq
        self.theta = float(cfg["rope_theta"])
        self.layers = cfg["num_hidden_layers"]
        # sqrt(d) rounded to the parameter dtype, as the model scales it
        self.embed_scale = float(torch.tensor(math.sqrt(self.d), dtype=torch.bfloat16))
        self.moe = "num_experts" in cfg
        if len(params["stack"]["period"]) != 1 or params["stack"]["tail"]:
            raise ValueError("the reference takes a stack of one block kind")
        self.block = params["stack"]["period"][0]

    # ---- one layer --------------------------------------------------------

    def layer_weights(self, i: int, grad: bool = False) -> dict:
        """Layer ``i``'s weights as float32 tensors (leaves when ``grad``)."""
        return {group: {name: _f32(t[i], grad) for name, t in leaves.items()}
                for group, leaves in self.block.items()}

    def attention(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        ar = self.ar
        h = rms_norm(x, w["norm"], self.eps).reshape(b * s, d)
        q = ar.mm(h, w["wq"].reshape(d, -1)).reshape(b, s, self.hq, self.dh)
        k = ar.mm(h, w["wk"].reshape(d, -1)).reshape(b, s, self.hkv, self.dh)
        v = ar.mm(h, w["wv"].reshape(d, -1)).reshape(b, s, self.hkv, self.dh)
        o = causal_attention(rope(q, self.theta), rope(k, self.theta), v, ar)
        return ar.mm(o.reshape(b * s, -1), w["wo"].reshape(-1, d)).reshape(b, s, d)

    def swiglu(self, h, w_in, w_gate, w_out) -> torch.Tensor:
        ar = self.ar
        return ar.mm(torch.nn.functional.silu(ar.mm(h, w_gate)) * ar.mm(h, w_in), w_out)

    def mlp(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = rms_norm(x, w["norm"], self.eps).reshape(b * s, d)
        return self.swiglu(h, w["w_in"], w["w_gate"], w["w_out"]).reshape(b, s, d)

    def route(self, w: dict, h: torch.Tensor):
        """(T, d) normed tokens -> (weights (T, K), experts (T, K), kept (T, K))."""
        cfg, run = self.cfg, self.cfg["run"]
        e_pad = int(run.get("padded_experts") or cfg["num_experts"])
        k = cfg["num_experts_per_tok"]
        logits = h @ w["router"]                       # float32 router, no rounding
        pad = torch.arange(e_pad, device=h.device) >= cfg["num_experts"]
        logits = torch.where(pad, NEG, logits)
        gates = torch.softmax(logits, dim=-1)
        top_w, top_e = torch.topk(gates, k, dim=-1, sorted=True)
        if cfg.get("norm_topk_prob", False):
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        t = h.shape[0]
        cap = max(8, int(float(run["capacity_factor"]) * t * k / e_pad))
        onehot = torch.nn.functional.one_hot(top_e, e_pad).sum(1)          # (T, E)
        rank = torch.gather(torch.cumsum(onehot, 0) - onehot, 1, top_e)    # earlier tokens
        return top_w, top_e, rank < cap

    def moe_ffn(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = rms_norm(x, w["norm"], self.eps).reshape(b * s, d)
        top_w, top_e, kept = self.route(w, h)
        out = self.swiglu(h, w["ws_in"], w["ws_gate"], w["ws_out"])
        for e in range(self.cfg["num_experts"]):
            tok, slot = torch.nonzero((top_e == e) & kept, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.swiglu(h[tok], w["we_in"][e], w["we_gate"][e], w["we_out"][e])
            out = out.index_add(0, tok, y * top_w[tok, slot][:, None])
        return out.reshape(b, s, d)

    def block_fwd(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(w["mixer"], x)
        if self.moe:
            return x + self.moe_ffn(w["moe"], x)
        return x + self.mlp(w["mlp"], x)

    # ---- the model --------------------------------------------------------

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][ids.long()].to(torch.float32) * self.embed_scale

    def head(self, x: torch.Tensor, final_norm, lm_head) -> torch.Tensor:
        return self.ar.mm(rms_norm(x, final_norm, self.eps), lm_head)

    @torch.no_grad()
    def last_logits(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, S) -> the last position's logits (B, V), float32."""
        x = self.embed(ids)
        for i in range(self.layers):
            x = self.block_fwd(self.layer_weights(i), x)
        p = self.params
        return self.head(x[:, -1], _f32(p["stack"]["final_norm"]), _f32(p["lm_head"]))

    def loss_and_grads(self, ids: torch.Tensor, labels: torch.Tensor):
        """The mean next-token cross entropy over every position and its
        gradient: (loss, {"embed", "lm_head", "final_norm": tensor,
        "layers": [per-layer {group: {name: grad}}]}), float32.  The forward
        keeps each layer's input; the backward recomputes one layer at a
        time."""
        p = self.params
        with torch.no_grad():
            xs = [self.embed(ids)]
            for i in range(self.layers - 1):
                xs.append(self.block_fwd(self.layer_weights(i), xs[-1]))
        w_last = self.layer_weights(self.layers - 1, grad=True)
        x_in = xs[-1].requires_grad_()
        x_out = self.block_fwd(w_last, x_in)
        fn, head = _f32(p["stack"]["final_norm"], True), _f32(p["lm_head"], True)
        logits = self.head(x_out.reshape(-1, self.d), fn, head)
        loss = torch.nn.functional.cross_entropy(logits, labels.reshape(-1).long())
        leaves = [fn, head, x_in] + _leaves(w_last)
        g_fn, g_head, g_x, *g_w = torch.autograd.grad(loss, leaves)
        del logits
        layer_grads = [None] * self.layers
        layer_grads[-1] = _unflatten(w_last, g_w)
        for i in range(self.layers - 2, -1, -1):
            w = self.layer_weights(i, grad=True)
            x_in = xs[i].requires_grad_()
            x_out = self.block_fwd(w, x_in)
            g_x, *g_w = torch.autograd.grad(x_out, [x_in] + _leaves(w), g_x)
            layer_grads[i] = _unflatten(w, g_w)
            xs.pop()
        g_embed = torch.zeros(p["embed"].shape, dtype=torch.float32, device=g_x.device)
        g_embed.index_add_(0, ids.reshape(-1).long(),
                           g_x.reshape(-1, self.d) * self.embed_scale)
        return loss.detach(), {"embed": g_embed, "lm_head": g_head, "final_norm": g_fn,
                               "layers": layer_grads}


def _leaves(w: dict) -> list:
    return [t for group in w.values() for t in group.values()]


def _unflatten(w: dict, flat: list) -> dict:
    it = iter(flat)
    return {group: {name: next(it) for name in leaves} for group, leaves in w.items()}
