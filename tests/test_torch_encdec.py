"""The port's encoder-decoder and VLM families (seamless-m4t-large-v2,
internvl2-26b) held against repro on the CPU, with the reference's weights
carried across by ``params_from_jax``: the configs and parameter specs
(the ``encoder`` and ``cross`` trees), ``frontend_tokens`` and
``synth_embeddings`` (bit for bit), ``encoder_kv`` and ``cross_attn_block``,
``encode``, ``encdec_forward`` / ``Model.apply`` with frames, the VLM
forward with prefix embeddings, the prefill step, decode on an enc-dec
config (the decoder stack alone, as the reference's), and
``tests/test_arch_smoke.py``'s forward-and-loss case over all ten
architectures on the port (the loss against the reference's is in
``tests/test_torch_train.py``).

Tolerances (``rtol`` = ``atol``): 1e-4 with ``param_dtype=float32``; 0.05
in bfloat16, the tolerance of ``tests/test_arch_smoke.py:98-100``.  The
port's full-sequence attention (B7's plain version on the CPU, float32
probabilities) and the reference's ``mha_chunked`` (probabilities rounded
to the parameter dtype) agree to rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models import attention as RA
from repro.models import frontends as RF
from repro.models import transformer as RT
from repro.models.model import Model as RModel
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import frontends as F
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, params_from_jax
from repro_torch.sim import _jaxrandom

FAMILIES = ("seamless_m4t_large_v2", "internvl2_26b")
TOL = {"f32": 1e-4, "bf16": 0.05}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dt):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dt], atol=TOL[dt])


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dt: str):
    """(reference model, its params from jax.random.key(0), port model,
    the same params as tensors)."""
    r_cfg = dataclasses.replace(r_get_smoke_config(arch), param_dtype=DT[dt][0])
    t_cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=DT[dt][1])
    r_model = RModel(r_cfg)
    r_params = r_model.init(jax.random.key(0))
    return r_model, r_params, Model(t_cfg), params_from_jax(
        jax.tree.map(np.asarray, r_params), "cpu")


def _frontend(cfg, seed: int = 3):
    """The reference's synthetic frontend embeddings and the port's (equal
    bits), for the smoke batch."""
    r = RF.synth_embeddings(cfg, B, jax.random.key(seed), S)
    return r, F.synth_embeddings(cfg, B, _jaxrandom.key(seed), S, device="cpu")


def _tokens(cfg, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _both(a: np.ndarray, dt: str):
    j = jnp.asarray(a).astype(DT[dt][0])
    return j, C.tensor_from_numpy(np.asarray(j), "cpu")


# ---------------------------------------------------------------------------
# Configs, specs, frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_and_specs_match_reference(arch):
    for t_cfg, r_cfg in ((get_config(arch), r_get_config(arch)),
                         (get_smoke_config(arch), r_get_smoke_config(arch))):
        for f in dataclasses.fields(r_cfg):
            if f.name not in ("param_dtype", "opt_dtype"):
                assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
        t_specs = C.tree_leaves(Model(t_cfg).param_specs(), C.is_spec_leaf)
        r_specs = jax.tree.leaves(RModel(r_cfg).param_specs(),
                                  is_leaf=lambda s: hasattr(s, "axes"))
        assert len(t_specs) == len(r_specs)
        assert Model(t_cfg).param_count() == RModel(r_cfg).param_count()
    specs = Model(get_smoke_config(arch)).param_specs()
    assert ("encoder" in specs and "cross" in specs) == (arch == "seamless_m4t_large_v2")
    n = Model(get_config(arch)).param_count()
    assert n == {"seamless_m4t_large_v2": 1_772_431_360, "internvl2_26b": 19_292_657_664}[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_carry_every_tree(arch):
    r_model, r_params, _, t_params = _pair(arch, "bf16")
    r_leaves = jax.tree.leaves_with_path(r_params)
    t_flat = {jax.tree_util.keystr(p): v for p, v in jax.tree.leaves_with_path(
        jax.tree.map(lambda t: t, t_params, is_leaf=lambda x: isinstance(x, torch.Tensor)))}
    assert len(t_flat) == len(r_leaves)
    for path, leaf in r_leaves:
        got = t_flat[jax.tree_util.keystr(path)]
        assert tuple(got.shape) == leaf.shape
        assert np.array_equal(got.to(torch.float32).numpy(), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("arch", FAMILIES)
def test_frontends_match_reference_bit_for_bit(arch, seed):
    cfg = get_smoke_config(arch)
    r_cfg = r_get_smoke_config(arch)
    for seq in (None, 16, 64):
        assert F.frontend_tokens(cfg, seq) == RF.frontend_tokens(r_cfg, seq)
        want = RF.synth_embeddings(r_cfg, 3, jax.random.key(seed), seq)
        got = F.synth_embeddings(cfg, 3, _jaxrandom.key(seed), seq, device="cpu")
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16))
    dense = get_smoke_config("qwen3_4b")
    assert F.synth_embeddings(dense, 2, _jaxrandom.key(0), device="cpu") is None
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            F.synth_embeddings(cfg, 1, _jaxrandom.key(0))


# ---------------------------------------------------------------------------
# Cross attention, encoder, enc-dec forward, VLM forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_and_encoder_match_reference(dt):
    r_model, r_params, t_model, t_params = _pair("seamless_m4t_large_v2", dt)
    cfg, t_cfg = r_model.cfg, t_model.cfg
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32), dt)
    je, te = _both(rng.standard_normal((B, 5, cfg.d_model), dtype=np.float32), dt)
    rp = jax.tree.map(lambda a: a[0], r_params["cross"]["period"])
    tp = C.tree_map(lambda a: a[0], t_params["cross"]["period"])
    r_kv, t_kv = RA.encoder_kv(rp, je, cfg), A.encoder_kv(tp, te, t_cfg)
    for a, b in zip(t_kv, r_kv):
        _close(a, b, dt)
    # Sq 16 queries on Sk 5 encoder keys, non-causal
    _close(A.cross_attn_block(tp, tx, t_kv, t_cfg), RA.cross_attn_block(rp, jx, r_kv, cfg), dt)
    r_frames, t_frames = _frontend(cfg)
    _close(T.encode(t_params, t_frames, t_cfg), RT.encode(r_params, r_frames, cfg), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_and_prefill_match_reference(arch, dt):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    cfg = r_model.cfg
    toks = _tokens(cfg)
    r_emb, t_emb = _frontend(cfg)
    key = "frames" if cfg.encoder_layers else "prefix_embeds"
    want, _ = r_model.apply(r_params, jnp.asarray(toks), **{key: r_emb})
    got, aux = t_model.apply(t_params, torch.from_numpy(toks), **{key: t_emb})
    assert tuple(got.shape) == (B, S, cfg.vocab) and got.dtype == DT[dt][1]
    assert (aux == {}) == (arch == "seamless_m4t_large_v2")
    _close(got, want, dt)
    # the reference's prefill step is its apply's last position
    t_last = make_prefill_step(t_model)(t_params, {"tokens": torch.from_numpy(toks), key: t_emb})
    assert torch.equal(t_last, got[:, -1, :])
    if arch == "seamless_m4t_large_v2":
        assert torch.equal(T.encdec_forward(t_params, torch.from_numpy(toks), t_emb,
                                            t_model.cfg)[0], got)
        with pytest.raises(ValueError, match="frames"):
            t_model.apply(t_params, torch.from_numpy(toks))


def test_encdec_decode_runs_the_decoder_stack_alone():
    """Decode on the enc-dec config does what the reference's does: the
    decoder stack with no cross-attention (ROADMAP §C)."""
    r_model, r_params, t_model, t_params = _pair("seamless_m4t_large_v2", "f32")
    toks = _tokens(r_model.cfg)
    r_cache, t_cache = r_model.init_cache(B, 8), t_model.init_cache(B, 8, "cpu")
    for i in range(3):
        want, r_cache = r_model.decode(r_params, jnp.asarray(toks[:, i:i + 1]), r_cache)
        got, t_cache = t_model.decode(t_params, torch.from_numpy(toks[:, i:i + 1]), t_cache)
        _close(got, want, "f32")
    _close(t_cache["kv"]["k"], r_cache["kv"]["k"], "f32")
    assert int(t_cache["len"]) == 3


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py's forward-and-loss case, every architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_forward_and_loss(arch):
    """The reference's case on the port: the smoke config from the port's
    seeded init, random tokens and labels, the frontend's embeddings."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    if cfg.encoder_layers > 0 or cfg.frontend is not None:
        key = "frames" if cfg.encoder_layers > 0 else "prefix_embeds"
        batch[key] = F.synth_embeddings(cfg, B, _jaxrandom.key(2), S, device="cpu")
    logits, aux = model.apply(params, batch["tokens"],
                              prefix_embeds=batch.get("prefix_embeds"),
                              frames=batch.get("frames"))
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    assert not bool(torch.isnan(logits.to(torch.float32)).any())
    loss = model.loss(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
