"""Public model facade, PyTorch port of :mod:`repro.models.model`: one
entry point per execution mode, for every family of the zoo (dense, MoE,
SSM, hybrid, encoder-decoder, VLM).

    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits, aux = model.apply(params, tokens)  # full-sequence forward
    loss = model.loss(params, batch)           # next-token xent + MoE aux
    cache = model.init_cache(batch, max_len, device)
    logits, cache = model.decode(params, token, cache)

Parameters are a plain dict of tensors with the reference's nesting and
names (``{"embed", "stack": {"period": [...], "tail": [...],
"final_norm"}, ["lm_head"], ["encoder": {"blocks", "final_norm"}, "cross":
{"period", "tail"}]}``; an MoE block's ``"moe"`` subtree keeps its float32
router and norm beside the parameter-dtype experts, a Mamba block its
float32 ``dt_bias``, ``a_log`` and ``d_skip``, an RG-LRU block its float32
``lam``); :func:`params_from_jax` carries a reference parameter tree
across bit for bit, each leaf in its own dtype.  ``apply`` returns the
logits and the MoE aux losses (``load_balance``, ``router_z``) averaged
over the MoE layers; an encoder-decoder config takes the encoder's
``frames``, a VLM its ``prefix_embeds``.  ``loss`` is the reference's: the
dense cross entropy, or ``chunked_xent`` where ``cfg.loss_chunk`` is set,
plus the weighted MoE aux losses; autograd differentiates it.  The decode
cache is the reference's heterogeneous one: ``kv`` for attention layers,
``ssm`` {conv, ssm} for Mamba layers, ``rec`` {conv, h} for RG-LRU layers.
The dry-run helpers give meta tensors where the reference gives
``ShapeDtypeStruct``s (``abstract``, ``input_specs``) and DTensor
placements where it gives ``NamedSharding``s (``shardings``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common as C
from repro_torch.models import frontends as F
from repro_torch.models import transformer as T

MOE_AUX_WEIGHT = 0.01
ROUTER_Z_WEIGHT = 0.001


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: C.ModelConfig

    # ---- parameters -------------------------------------------------------

    def param_specs(self) -> dict:
        return T.lm_param_specs(self.cfg)

    def init(self, generator: torch.Generator) -> dict:
        """Seeded init on ``generator.device`` (the reference's
        distributions; not its ``jax.random`` numbers)."""
        return C.init_params(self.param_specs(), generator)

    def abstract(self) -> dict:
        """Meta tensors of every parameter (the dry run's; no allocation)."""
        return C.abstract_params(self.param_specs())

    def shardings(self, mesh, rules=None):
        """Every parameter's DTensor placements on ``mesh``."""
        return C.param_shardings(self.param_specs(), mesh, rules)

    def param_count(self) -> int:
        return C.param_count(self.param_specs())

    # ---- forward ----------------------------------------------------------

    def apply(self, params, tokens, prefix_embeds=None, frames=None):
        cfg = self.cfg
        if cfg.encoder_layers > 0:
            if frames is None:
                raise ValueError(f"{cfg.name}: the encoder-decoder needs encoder frames")
            return T.encdec_forward(params, tokens, frames, cfg)
        return T.forward(params, tokens, cfg, prefix_embeds=prefix_embeds)

    def loss(self, params, batch: dict) -> torch.Tensor:
        """batch: {tokens, labels, [frames|prefix_embeds]} -> scalar loss."""
        cfg = self.cfg
        if cfg.loss_chunk > 0 and cfg.encoder_layers == 0:
            hidden, aux = T.forward_hidden(params, batch["tokens"], cfg,
                                           prefix_embeds=batch.get("prefix_embeds"))
            loss = T.chunked_xent(params, hidden, batch["labels"], cfg)
        else:
            logits, aux = self.apply(params, batch["tokens"],
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     frames=batch.get("frames"))
            loss = C.cross_entropy(logits, batch["labels"], cfg.vocab_size)
        if aux:
            loss = (loss + MOE_AUX_WEIGHT * aux.get("load_balance", 0.0)
                    + ROUTER_Z_WEIGHT * aux.get("router_z", 0.0))
        return loss

    # ---- serving ----------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        return T.init_cache(self.cfg, batch, max_len, device)

    def decode(self, params, token, cache):
        return T.decode_step(params, token, cache, self.cfg)

    def prefill(self, params, tokens):
        """Prefill forward (logits only, as the reference's)."""
        return self.apply(params, tokens)

    # ---- dry-run inputs ----------------------------------------------------

    def input_specs(self, shape_name: str, seq_len: int, global_batch: int,
                    mode: str) -> dict:
        """Meta-tensor stand-ins for every model input (no allocation).

        mode: 'train' -> {tokens, labels, ...}; 'prefill' -> {tokens, ...};
        'decode' -> {token, cache}, the cache's ``len`` a host int32 scalar
        as :func:`~repro_torch.models.transformer.init_cache` makes it."""
        cfg = self.cfg
        if mode in ("train", "prefill"):
            def ids():
                return torch.empty((global_batch, seq_len), dtype=torch.int32, device="meta")
            specs = {"tokens": ids()}
            if mode == "train":
                specs["labels"] = ids()
            if cfg.encoder_layers > 0:
                specs["frames"] = F.frontend_spec(cfg, global_batch, seq_len)
            elif cfg.frontend is not None:
                specs["prefix_embeds"] = F.frontend_spec(cfg, global_batch, seq_len)
            return specs
        if mode == "decode":
            return {"token": torch.empty((global_batch, 1), dtype=torch.int32, device="meta"),
                    "cache": T.init_cache(cfg, global_batch, seq_len, device="meta")}
        raise ValueError(mode)


def params_from_jax(tree, device) -> dict:
    """Carry a reference parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) to tensors on ``device`` with the
    same nesting and names; bfloat16 crosses bit for bit through its 16-bit
    patterns (:func:`repro_torch.models.common.tensor_from_numpy`)."""
    return C.tree_map(lambda a: C.tensor_from_numpy(a, device), tree)
