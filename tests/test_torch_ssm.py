"""The port's SSM and hybrid families (repro_torch.models.ssm, .recurrent,
the 'mamba' and 'rglru' block kinds, the falcon-mamba-7b and
recurrentgemma-2b configs) held against repro on the CPU, with the
reference's weights carried across by ``params_from_jax``: configs and
parameter specs field for field, the log-depth scan against
``jax.lax.associative_scan``, ``ssm_block`` and ``rglru_block``, both
decode blocks for six steps from a zero cache, ``Model.apply`` and
``make_prefill_step``, six decode steps of the whole model with their
heterogeneous cache, the serve loop token for token; plus the port's
mirrors of ``tests/test_arch_smoke.py``'s forward and decode cases for the
two archs (the train case is in ``tests/test_torch_train.py``) and of
``test_decode_matches_forward_dense``, and decode against the forward past
recurrentgemma's window (the ring cache wrapping).

Tolerances (``rtol`` = ``atol``), as ``tests/test_torch_models.py``: 1e-4
with ``param_dtype=float32``; 0.05 in bfloat16, where the two frameworks
round at different sites.  The scan itself is the reference's recursion
and equals it bit for bit in float32 on the CPU."""

from __future__ import annotations

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as RS
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.launch.steps import make_prefill_step as r_make_prefill_step
from repro.models import recurrent as RR
from repro.models import ssm as RSSM
from repro.models.model import Model as RModel
from repro_torch.configs import ARCHS as T_ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import common as C
from repro_torch.models import recurrent as R
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, params_from_jax

ARCHS = ("falcon_mamba_7b", "recurrentgemma_2b")
BLOCK = {"falcon_mamba_7b": "mamba", "recurrentgemma_2b": "rglru"}
TOL = {"f32": 1e-4, "bf16": 0.05}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S_LEN = 2, 16


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
    t_params = params_from_jax(jax.tree.map(np.asarray, r_params), "cpu")
    return r_model, r_params, Model(t_cfg), t_params


@functools.lru_cache(maxsize=None)
def _r_decode(arch: str, dt: str):
    """The reference's ``Model.decode`` under ``jax.jit``, as its serve
    loop runs it."""
    return jax.jit(_pair(arch, dt)[0].decode)


def _tokens(cfg, shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _both(a: np.ndarray, dt: str):
    """One numpy array as (jax array, torch tensor) with equal bits."""
    j = jnp.asarray(a).astype(DT[dt][0])
    return j, C.tensor_from_numpy(np.asarray(j), "cpu")


def _by_path(tree, path=()) -> dict:
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


def _layer0_mixer(params, r: bool):
    stack = params["stack"]
    p = stack["period"][0]["mixer"]
    if r:
        return jax.tree.map(lambda a: a[0], p)
    return C.tree_map(lambda a: a[0], p)


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_reference(arch):
    assert arch in T_ARCHS
    for t_cfg, r_cfg in ((get_config(arch), r_get_config(arch)),
                         (get_smoke_config(arch), r_get_smoke_config(arch))):
        for f in dataclasses.fields(r_cfg):
            if f.name in ("ssm", "recurrent"):
                r_sub, t_sub = getattr(r_cfg, f.name), getattr(t_cfg, f.name)
                assert (t_sub is None) == (r_sub is None), f.name
                if r_sub is not None:
                    assert dataclasses.astuple(t_sub) == dataclasses.astuple(r_sub)
            elif f.name not in ("param_dtype", "opt_dtype"):
                assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
        assert t_cfg.pattern == r_cfg.pattern
        assert (t_cfg.param_dtype, t_cfg.opt_dtype) == (torch.bfloat16, torch.float32)
        t_specs = _by_path(Model(t_cfg).param_specs())
        r_specs = _by_path(RModel(r_cfg).param_specs())
        assert list(t_specs) == list(r_specs)
        for path, r in r_specs.items():
            t = t_specs[path]
            assert (t.shape, t.axes, t.init, t.scale) == (r.shape, r.axes, r.init, r.scale)
            assert str(t.dtype).split(".")[-1] == np.dtype(r.dtype).name, path
        assert Model(t_cfg).param_count() == RModel(r_cfg).param_count()
    get_config(arch.replace("_", "-"))  # the hyphenated id


def test_full_width_param_counts():
    """falcon-mamba-7b: 7,006,326,784 parameters (13.05 GiB in bf16);
    recurrentgemma-2b: 2,894,481,920 (tied embeddings)."""
    assert Model(get_config("falcon_mamba_7b")).param_count() == 7_006_326_784
    assert Model(get_config("recurrentgemma_2b")).param_count() == 2_894_481_920
    mixer = Model(get_config("falcon_mamba_7b")).param_specs()["stack"]["period"][0]["mixer"]
    assert mixer["w_x"].shape == (64, 8192, 256 + 32)  # dt_rank ceil(4096 / 16) = 256
    assert {k for k, s in mixer.items() if s.dtype == torch.float32} == \
        {"norm", "dt_bias", "a_log", "d_skip"}


# ---------------------------------------------------------------------------
# The scan and the primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 33, 100])
def test_linear_scan_matches_associative_scan(s):
    """The port's scan is the reference's recursion: bit for bit against
    ``jax.lax.associative_scan`` in float32, and within rounding of the
    plain sequential loop."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.3, 1.0, (2, s, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, s, 3, 4)).astype(np.float32)

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a2 * a1, a2 * b1 + b2

    want = np.asarray(jax.lax.associative_scan(
        combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)[1])
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    got = C.linear_scan_(ta, tb)
    assert got is tb and torch.equal(ta, torch.from_numpy(a))  # b overwritten, a read
    np.testing.assert_array_equal(got.numpy(), want)
    h = np.zeros_like(b[:, 0])
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_and_softplus_match_reference(dt):
    rng = np.random.default_rng(3)
    xj, xt = _both(rng.normal(size=(2, 9, 8)), dt)
    wj, wt = _both(rng.normal(size=(4, 8)) * 0.1, dt)
    bj, bt = _both(rng.normal(size=(8,)), dt)
    got = SSM.causal_conv(xt, wt, bt)
    assert got.dtype == DT[dt][1]
    _close(got, RSSM._causal_conv(xj, wj, bj), dt)
    _close(R.causal_conv(xt, wt, bt), RR._causal_conv(xj, wj, bj), dt)
    # softplus past F.softplus's threshold of 20, and deep negative
    x = np.array([-90.0, -30.0, -1.5, 0.0, 0.7, 19.0, 21.0, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(SSM.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-30)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_reference(arch, dt):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    rp, tp = _layer0_mixer(r_params, True), _layer0_mixer(t_params, False)
    f32 = {"mamba": ("dt_bias", "a_log", "d_skip", "norm"), "rglru": ("lam", "norm")}
    for name in f32[BLOCK[arch]]:  # params_from_jax keeps each leaf's dtype
        assert tp[name].dtype == torch.float32, name
    assert tp["w_out"].dtype == DT[dt][1]
    xj, xt = _both(np.random.default_rng(4).normal(size=(B, S_LEN, r_model.cfg.d_model)), dt)
    if arch == "falcon_mamba_7b":
        want = RSSM.ssm_block(rp, xj, r_model.cfg)
        got = SSM.ssm_block(tp, xt, t_model.cfg)
    else:
        want = RR.rglru_block(rp, xj, r_model.cfg)
        got = R.rglru_block(tp, xt, t_model.cfg)
    assert tuple(got.shape) == (B, S_LEN, r_model.cfg.d_model) and got.dtype == DT[dt][1]
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_block_matches_reference(arch, dt):
    """Six one-token steps of the decode block from a zero cache: output and
    both states every step; the states passed in are not written."""
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    rp, tp = _layer0_mixer(r_params, True), _layer0_mixer(t_params, False)
    r_cfg, t_cfg = r_model.cfg, t_model.cfg
    if arch == "falcon_mamba_7b":
        r_c = RSSM.init_ssm_cache(r_cfg, B, 1)
        t_c = SSM.init_ssm_cache(t_cfg, B, 1)
        r_state, t_state = (r_c["conv"][0], r_c["ssm"][0]), (t_c["conv"][0], t_c["ssm"][0])
        r_fn, t_fn = RSSM.ssm_decode_block, SSM.ssm_decode_block
    else:
        r_c = RR.init_rglru_cache(r_cfg, B, 1)
        t_c = R.init_rglru_cache(t_cfg, B, 1)
        r_state, t_state = (r_c["conv"][0], r_c["h"][0]), (t_c["conv"][0], t_c["h"][0])
        r_fn, t_fn = RR.rglru_decode_block, R.rglru_decode_block
    assert t_state[1].dtype == torch.float32 and t_state[0].dtype == DT[dt][1]
    xs = np.random.default_rng(5).normal(size=(6, B, 1, r_cfg.d_model))
    for i in range(6):
        xj, xt = _both(xs[i], dt)
        before = [t.clone() for t in t_state]
        want, *r_state = r_fn(rp, xj, *r_state, r_cfg)
        got, *new = t_fn(tp, xt, *t_state, t_cfg)
        assert all(torch.equal(a, b) for a, b in zip(before, t_state))
        t_state = tuple(new)
        _close(got, want, dt)
        for g, w in zip(t_state, r_state):
            assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
            _close(g, w, dt)


# ---------------------------------------------------------------------------
# Model, prefill step, decode, serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_prefill_step_match_reference(arch, dt):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    toks = _tokens(r_model.cfg, (B, S_LEN))
    want, _ = r_model.apply(r_params, jnp.asarray(toks))
    got, aux = t_model.apply(t_params, torch.from_numpy(toks))
    assert tuple(got.shape) == (B, S_LEN, r_model.cfg.vocab) and got.dtype == DT[dt][1]
    assert float(aux["load_balance"]) == float(aux["router_z"]) == 0.0
    _close(got, want, dt)
    r_last = r_make_prefill_step(r_model)(r_params, {"tokens": jnp.asarray(toks)})
    t_last = make_prefill_step(t_model)(t_params, {"tokens": torch.from_numpy(toks)})
    _close(t_last, r_last, dt)
    assert torch.equal(t_last, got[:, -1, :])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dt):
    """Six teacher-forced decode steps: logits every step, then every leaf
    of the heterogeneous cache (kv only for attention layers, ssm / rec by
    their kind's own layer counter)."""
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    toks = _tokens(r_model.cfg, (B, 6), seed=2)
    r_cache = r_model.init_cache(B, 8)
    t_cache = t_model.init_cache(B, 8, "cpu")
    assert sorted(t_cache) == sorted(r_cache)
    step, r_step = make_decode_step(t_model), _r_decode(arch, dt)
    for i in range(6):
        want, r_cache = r_step(r_params, jnp.asarray(toks[:, i:i + 1]), r_cache)
        got, t_cache = step(t_params, torch.from_numpy(toks[:, i:i + 1]), t_cache)
        assert tuple(got.shape) == (B, 1, r_model.cfg.vocab)
        _close(got, want, dt)
    assert int(t_cache["len"]) == int(r_cache["len"]) == 6
    r_leaves, t_leaves = _by_path(r_cache), _by_path(t_cache)
    assert list(t_leaves) == list(r_leaves)
    for path, w in r_leaves.items():
        g = t_leaves[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name, path
        if path[-1] == "pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif path != ("len",):
            _close(g, w, dt)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_does_not_write_its_input_cache(arch):
    _, _, t_model, t_params = _pair(arch, "f32")
    cache = t_model.init_cache(B, 8, "cpu")
    tok = torch.zeros((B, 1), dtype=torch.int64)
    _, new = t_model.decode(t_params, tok, cache)
    old_leaves, new_leaves = _by_path(cache), _by_path(new)
    for path, t in old_leaves.items():
        if path == ("len",):
            continue
        assert not bool(t.any()) if path[-1] != "pos" else bool((t == -1).all()), path
    assert int(cache["len"]) == 0 and int(new["len"]) == 1
    state = ("ssm", "ssm") if arch == "falcon_mamba_7b" else ("rec", "h")
    assert bool(new_leaves[state].any())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_serve_matches_reference_token_for_token(arch, monkeypatch):
    """The serve loop's defaults on the float32 smoke config with the
    reference loop's own weights: the same requests, the same tokens (one
    cache and one ``len`` shared by all slots in both, the SSM and RG-LRU
    states included)."""
    args = argparse.Namespace(arch=arch, smoke=True, requests=8, batch=4, max_new=16,
                              max_len=64, seed=0, study=None, device="cpu")
    r_cfg = dataclasses.replace(r_get_smoke_config(arch), param_dtype=jnp.float32)
    monkeypatch.setattr(RS, "get_smoke_config", lambda name: r_cfg)
    want = RS.serve(args)
    r_params = RModel(r_cfg).init(jax.random.key(0))  # what RS.serve draws
    t_cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=torch.float32)
    monkeypatch.setattr(S, "get_smoke_config", lambda name: t_cfg)
    got = S.serve(args, params=params_from_jax(jax.tree.map(np.asarray, r_params), "cpu"))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert (g.rid, g.prompt, g.max_new, g.done) == (w.rid, w.prompt, w.max_new, w.done)
        assert g.out == w.out, f"request {g.rid}"


def test_decode_matches_forward_past_the_window():
    """recurrentgemma's attention layers are all sliding-window, so its KV
    cache is a ring of ``window`` slots: 48 teacher-forced decode steps at
    window 32 (the ring wraps) against the full forward, float32."""
    _, _, t_model, t_params = _pair("recurrentgemma_2b", "f32")
    cfg = t_model.cfg
    assert T._ring_cache(cfg) and cfg.window_size == 32
    toks = torch.from_numpy(_tokens(cfg, (1, 48), seed=7))
    full, _ = t_model.apply(t_params, toks)
    cache = t_model.init_cache(1, 64, "cpu")
    assert cache["kv"]["k"].shape[2] == 32 and cache["kv"]["k"].shape[0] == 1
    outs = []
    for i in range(48):
        logits, cache = t_model.decode(t_params, toks[:, i:i + 1], cache)
        outs.append(logits[:, 0])
    assert sorted(cache["kv"]["pos"].tolist()) == list(range(16, 48))
    _close(torch.stack(outs, dim=1), full, "f32")


# ---------------------------------------------------------------------------
# Mirrors of tests/test_arch_smoke.py (the port's own init)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(cfg, (B, S_LEN)))
    logits, aux = model.apply(params, tokens)
    assert tuple(logits.shape) == (B, S_LEN, cfg.vocab)
    assert not bool(torch.isnan(logits.to(torch.float32)).any())
    assert all(bool(torch.isfinite(v)) for v in aux.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(B, max_len=32, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int64)
    for _ in range(3):
        logits, cache = model.decode(params, tok, cache)
        assert tuple(logits.shape) == (B, 1, cfg.vocab)
        assert not bool(torch.isnan(logits.to(torch.float32)).any())
        tok = torch.argmax(logits[:, :, : cfg.vocab_size], dim=-1)
    assert int(cache["len"]) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's mirror of ``test_decode_matches_forward_dense`` on the
    two archs, at its tolerance (bf16 smoke weights, the port's init)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(cfg, (1, 6), seed=2))
    full, _ = model.apply(params, tokens)
    cache = model.init_cache(1, max_len=8, device="cpu")
    outs = []
    for i in range(6):
        logits, cache = model.decode(params, tokens[:, i:i + 1], cache)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(_np(full), _np(torch.stack(outs, dim=1)), rtol=0.05, atol=0.05)
