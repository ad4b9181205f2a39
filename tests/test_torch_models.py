"""The port's dense model zoo (repro_torch.models, configs, launch.steps)
held against repro on the CPU, with the reference's weights carried across
by ``params_from_jax``: the primitive layers, ``attn_block`` and
``mlp_block``, ``Model.apply`` logits, six teacher-forced ``Model.decode``
steps (logits and cache), and ``make_prefill_step``, for qwen3-4b's smoke
config and each other registered dense arch (phi3-mini, deepseek-67b,
nemotron-4-340b), in float32 and in bfloat16.  Plus a sliding-window
variant with its ring-buffer cache, the mirror of
``tests/test_arch_smoke.py::test_decode_matches_forward_dense``, the
enc-dec configs, ``Model.loss`` and ``chunked_xent`` against the
reference, and the ``ValueError`` naming a block kind the zoo lacks.

The port's full-sequence attention is the flash kernel's plain version
(float32 probabilities) where the reference's is ``mha_chunked``
(probabilities rounded to the parameter dtype), so the two agree to
rounding, not bit for bit.  Tolerances (``rtol`` = ``atol``): 1e-4 with
``param_dtype=float32``; 0.05 in bfloat16, the tolerance of
``tests/test_arch_smoke.py:98-100``, since bfloat16 rounds at different
sites in the two frameworks.
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
from repro.launch.steps import make_prefill_step as r_make_prefill_step
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import transformer as RT
from repro.models.model import Model as RModel
from repro_torch.configs import ARCHS as T_ARCHS, get_config, get_smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, params_from_jax

ARCHS = ("qwen3_4b", "phi3_mini_3_8b", "deepseek_67b", "nemotron_4_340b")
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


def _configs(arch: str, dt: str, **kw):
    r_cfg = dataclasses.replace(r_get_smoke_config(arch), param_dtype=DT[dt][0], **kw)
    t_cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=DT[dt][1], **kw)
    return r_cfg, t_cfg


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dt: str, **kw):
    """(reference model, its params from jax.random.key(0), port model,
    the same params as tensors)."""
    r_cfg, t_cfg = _configs(arch, dt, **kw)
    r_model = RModel(r_cfg)
    r_params = r_model.init(jax.random.key(0))
    t_params = params_from_jax(jax.tree.map(np.asarray, r_params), "cpu")
    return r_model, r_params, Model(t_cfg), t_params


def _tokens(cfg, shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _both(a: np.ndarray, dt: str):
    """One numpy array as (jax array, torch tensor) with equal bits."""
    j = jnp.asarray(a).astype(DT[dt][0])
    return j, C.tensor_from_numpy(np.asarray(j), "cpu")


def _by_path(tree, path=()) -> dict:
    """``{path: leaf}`` of a tree of dicts and lists, keys sorted (the
    reference's spec leaves are ParamSpec dataclasses, the port's too)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, path + (i,)))
        return out
    return {path: tree}


# ---------------------------------------------------------------------------
# Configs, specs, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_reference(arch):
    assert arch in T_ARCHS
    for t_cfg, r_cfg in ((get_config(arch), r_get_config(arch)),
                         (get_smoke_config(arch), r_get_smoke_config(arch))):
        for f in dataclasses.fields(r_cfg):
            if f.name not in ("param_dtype", "opt_dtype"):
                assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
        assert str(t_cfg.param_dtype).split(".")[-1] == np.dtype(r_cfg.param_dtype).name
        assert str(t_cfg.opt_dtype).split(".")[-1] == np.dtype(r_cfg.opt_dtype).name
        t_specs, r_specs = _by_path(Model(t_cfg).param_specs()), \
            _by_path(RModel(r_cfg).param_specs())
        assert list(t_specs) == list(r_specs)
        for path, r in r_specs.items():
            t = t_specs[path]
            assert (t.shape, t.axes, t.init, t.scale) == (r.shape, r.axes, r.init, r.scale)
            assert str(t.dtype).split(".")[-1] == np.dtype(r.dtype).name
        assert Model(t_cfg).param_count() == RModel(r_cfg).param_count()


def test_qwen3_4b_full_width_param_count():
    """About 4.02 B parameters, 8.0 GB in bfloat16 (the serving path's model)."""
    n = Model(get_config("qwen3_4b")).param_count()
    assert n == RModel(r_get_config("qwen3_4b")).param_count()
    assert 4.0e9 < n < 4.05e9


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_specs(arch):
    model = Model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0))
    specs = model.param_specs()
    for p, s in zip(C.tree_leaves(params), C.tree_leaves(specs, C.is_spec_leaf), strict=True):
        assert tuple(p.shape) == s.shape and p.dtype == s.dtype
        if s.init == "zeros":
            assert not bool(p.any())
        else:
            assert bool(p.to(torch.float32).std() > 0)
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(C.tree_leaves(params), C.tree_leaves(again)))
    emb = params["embed"].to(torch.float32)
    assert 0.015 < float(emb.std()) < 0.025  # small_normal, std 0.02


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_primitives_match_reference(dt):
    rng = np.random.default_rng(5)
    jx, tx = _both(rng.standard_normal((2, 7, 4, 16), dtype=np.float32), dt)
    js, ts = _both(rng.standard_normal((16,), dtype=np.float32) * 0.1, "f32")
    _close(C.rms_norm(tx, ts), RC.rms_norm(jx, js), dt)
    pos = rng.integers(0, 4096, (2, 7))
    _close(C.rope(tx, torch.from_numpy(pos), 1e6), RC.rope(jx, jnp.asarray(pos), 1e6), dt)
    jg, tg = _both(rng.standard_normal((2, 7, 4, 16), dtype=np.float32), dt)
    for name in ("swiglu", "relu2", "gelu"):
        _close(C.activation(name, tx, tg), RC.activation(name, jx, jg), dt)
    qp, kp = np.arange(5, 12), np.arange(0, 12)
    for w in (0, 3):
        assert np.array_equal(
            C.causal_window_mask(torch.from_numpy(qp), torch.from_numpy(kp), w).numpy(),
            np.asarray(RC.causal_window_mask(jnp.asarray(qp), jnp.asarray(kp), w)))
    jl, tl = _both(rng.standard_normal((2, 5, 40), dtype=np.float32) * 3, dt)
    labels = rng.integers(0, 33, (2, 5))
    _close(C.cross_entropy(tl, torch.from_numpy(labels), 33),
           RC.cross_entropy(jl, jnp.asarray(labels), 33), dt)
    with pytest.raises(ValueError):
        C.activation("tanh", tx)


# ---------------------------------------------------------------------------
# Blocks, forward, decode, prefill against the reference
# ---------------------------------------------------------------------------


def _layer0(params, jax_tree: bool):
    period = params["stack"]["period"][0]
    if jax_tree:
        return jax.tree.map(lambda a: a[0], period)
    return C.tree_map(lambda a: a[0], period)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(arch, dt):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    cfg = r_model.cfg
    rng = np.random.default_rng(6)
    jx, tx = _both(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32), dt)
    rp, tp = _layer0(r_params, True), _layer0(t_params, False)
    _close(A.attn_block(tp["mixer"], tx, t_model.cfg),
           RA.attn_block(rp["mixer"], jx, cfg), dt)
    _close(T.mlp_block(tp["mlp"], tx, t_model.cfg), RT.mlp_block(rp["mlp"], jx, cfg), dt)
    # attn_block routes through the flash kernel's ops.mha (ROADMAP §C)
    pos = torch.arange(S)[None, :]
    q, k, v = A._project_qkv(tp["mixer"], C.rms_norm(tx, tp["mixer"]["norm"]), t_model.cfg, pos)
    from repro_torch.kernels.flash_attention import flash_attention as FA

    want = torch.einsum("bshk,hkd->bsd", FA.flash_attention_plain(q, k, v),
                        tp["mixer"]["wo"])
    assert torch.equal(A.attn_block(tp["mixer"], tx, t_model.cfg), want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_prefill_step_match_reference(arch, dt):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    toks = _tokens(r_model.cfg, (B, S))
    want, _ = r_model.apply(r_params, jnp.asarray(toks))
    got, aux = t_model.apply(t_params, torch.from_numpy(toks))
    assert tuple(got.shape) == (B, S, r_model.cfg.vocab) and got.dtype == DT[dt][1]
    assert set(aux) == {"load_balance", "router_z"}
    _close(got, want, dt)
    r_last = r_make_prefill_step(r_model)(r_params, {"tokens": jnp.asarray(toks)})
    t_last = make_prefill_step(t_model)(t_params, {"tokens": torch.from_numpy(toks)})
    assert tuple(t_last.shape) == (B, r_model.cfg.vocab)
    _close(t_last, r_last, dt)
    assert torch.equal(t_last, got[:, -1, :])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS + ("qwen3_4b-direct",))
def test_decode_matches_reference(arch, dt):
    """Six teacher-forced decode steps: logits every step, then the cache
    (``-direct``: with ``decode_direct_attn``, the unchunked decode
    attention)."""
    arch, _, direct = arch.partition("-")
    kw = {"decode_direct_attn": True} if direct else {}
    r_model, r_params, t_model, t_params = _pair(arch, dt, **kw)
    toks = _tokens(r_model.cfg, (B, 6), seed=2)
    r_cache = r_model.init_cache(B, 8)
    t_cache = t_model.init_cache(B, 8, "cpu")
    step = make_decode_step(t_model)
    for i in range(6):
        want, r_cache = r_model.decode(r_params, jnp.asarray(toks[:, i:i + 1]), r_cache)
        got, t_cache = step(t_params, torch.from_numpy(toks[:, i:i + 1]), t_cache)
        assert tuple(got.shape) == (B, 1, r_model.cfg.vocab)
        _close(got, want, dt)
    assert int(t_cache["len"]) == int(r_cache["len"]) == 6
    assert t_cache["len"].device.type == "cpu"
    for key in ("k", "v"):
        assert t_cache["kv"][key].dtype == DT[dt][1]
        _close(t_cache["kv"][key], r_cache["kv"][key], dt)
    assert np.array_equal(t_cache["kv"]["pos"].numpy(), np.asarray(r_cache["kv"]["pos"]))


@pytest.mark.parametrize("direct", [False, True], ids=["chunked", "direct"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sliding_window_ring_decode_matches_reference(dt, direct):
    """qwen3-4b smoke with every block 'swa' (window 4): the full forward
    masks a trailing window, and decode keeps a 4-slot ring buffer; decode
    attention through ``mha_chunked`` or, with ``decode_direct_attn``, the
    unchunked grouped-head softmax."""
    r_model, r_params, t_model, t_params = _pair("qwen3_4b", dt, block_kind="swa",
                                                  window_size=4, decode_direct_attn=direct)
    toks = _tokens(r_model.cfg, (B, 10), seed=3)
    want, _ = r_model.apply(r_params, jnp.asarray(toks))
    got, _ = t_model.apply(t_params, torch.from_numpy(toks))
    _close(got, want, dt)
    r_cache = r_model.init_cache(B, 16)
    t_cache = t_model.init_cache(B, 16, "cpu")
    assert tuple(t_cache["kv"]["k"].shape) == (2, B, 4, 2, 16)
    for i in range(10):
        want, r_cache = r_model.decode(r_params, jnp.asarray(toks[:, i:i + 1]), r_cache)
        got, t_cache = t_model.decode(t_params, torch.from_numpy(toks[:, i:i + 1]), t_cache)
        _close(got, want, dt)
    assert np.array_equal(t_cache["kv"]["pos"].numpy(), np.asarray(r_cache["kv"]["pos"]))


def test_decode_matches_forward_dense():
    """Decode path must agree with the full forward on a dense arch (the
    port's mirror of ``tests/test_arch_smoke.py``; weights from the port's
    own seeded init, tolerance 0.05 as there)."""
    cfg = get_smoke_config("qwen3_4b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(cfg, (1, 6), seed=2))
    full_logits, _ = model.apply(params, tokens)
    cache = model.init_cache(1, max_len=8, device="cpu")
    outs = []
    for i in range(6):
        logits, cache = model.decode(params, tokens[:, i:i + 1], cache)
        outs.append(logits[:, 0])
    dec_logits = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(full_logits), _np(dec_logits), rtol=0.05, atol=0.05)


def test_decode_does_not_write_its_input_cache():
    _, _, t_model, t_params = _pair("qwen3_4b", "f32")
    cache = t_model.init_cache(B, 8, "cpu")
    tok = torch.zeros((B, 1), dtype=torch.int64)
    _, new = t_model.decode(t_params, tok, cache)
    assert not bool(cache["kv"]["k"].any()) and int(cache["len"]) == 0
    assert bool(new["kv"]["k"].any()) and int(new["len"]) == 1


def test_later_slices_raise_naming_them():
    """What the enc-dec / VLM and training slices brought equals the
    reference; a block kind the zoo does not have still raises, naming it."""
    for arch in ("seamless_m4t_large_v2", "internvl2_26b"):
        assert dataclasses.asdict(get_smoke_config(arch)) == {
            **dataclasses.asdict(r_get_smoke_config(arch)),
            "param_dtype": torch.bfloat16, "opt_dtype": torch.float32}
    cfg = get_smoke_config("qwen3_4b")
    with pytest.raises(ValueError, match="'conv'"):  # a kind the zoo does not have
        Model(dataclasses.replace(cfg, block_kind="conv")).param_specs()
    encdec = dataclasses.replace(cfg, encoder_layers=2)
    r_encdec = dataclasses.replace(r_get_smoke_config("qwen3_4b"), encoder_layers=2)
    assert Model(encdec).param_count() == RModel(r_encdec).param_count()
    assert set(Model(encdec).param_specs()) == set(RModel(r_encdec).param_specs())
    r_model, r_params, model, params = _pair("qwen3_4b", "f32")
    toks = _tokens(cfg, (B, S))
    batch = {"tokens": toks, "labels": _tokens(cfg, (B, S), seed=2)}
    np.testing.assert_allclose(
        float(model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})),
        float(r_model.loss(r_params, {k: jnp.asarray(v) for k, v in batch.items()})),
        rtol=1e-4)
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    chunked = dataclasses.replace(model.cfg, loss_chunk=5)
    np.testing.assert_allclose(
        float(T.chunked_xent(params, torch.from_numpy(hidden), torch.from_numpy(toks), chunked)),
        float(RT.chunked_xent(r_params, jnp.asarray(hidden), jnp.asarray(toks),
                              dataclasses.replace(r_model.cfg, loss_chunk=5))), rtol=1e-4)
    with pytest.raises(ValueError, match="frames"):
        Model(dataclasses.replace(model.cfg, encoder_layers=2)).apply(
            {}, torch.zeros((1, 2), dtype=torch.int64))
