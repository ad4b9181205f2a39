"""The port's MoE family (repro_torch.models.moe, the 'moe' block kind, the
qwen2-moe-a2.7b and moonshot-v1-16b-a3b configs) held against repro on the
CPU, with the reference's weights carried across by ``params_from_jax``:
configs and parameter specs field for field, ``_routing`` (padded experts
included), ``moe_block`` under each dispatch setting (``sort``, ``cumsum``
and ``ep``, which without a mesh is the local formulation in both packages)
and both ``moe_combine_f32`` settings — outputs, aux losses, the kept
(token, expert, rank) set and the dropped count at a capacity that drops —,
``Model.apply`` with its aux, ``make_prefill_step``, six decode steps with
their cache, and the serve driver token for token; plus the port's mirrors
of ``tests/test_arch_smoke.py``'s MoE cases (the forward; the loss and its
gradient are in ``tests/test_torch_train.py``) and ``test_decode_step``.

Tolerances (``rtol`` = ``atol``), as ``tests/test_torch_models.py``: 1e-4
with ``param_dtype=float32``; 0.05 in bfloat16.  Routing is exact: the
same experts in the same order."""

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
from repro.models import moe as RM
from repro.models.model import Model as RModel
from repro_torch.configs import ARCHS as T_ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models.model import Model, params_from_jax

ARCHS = ("qwen2_moe_a2_7b", "moonshot_v1_16b_a3b")
DISPATCH = ("sort", "cumsum", "ep")
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
def _pair(arch: str, dt: str, **kw):
    """(reference model, its params from jax.random.key(0), port model,
    the same params as tensors)."""
    r_cfg = dataclasses.replace(r_get_smoke_config(arch), param_dtype=DT[dt][0], **kw)
    t_cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=DT[dt][1], **kw)
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


def _layer0_moe(params, jax_tree: bool):
    period = params["stack"]["period"][0]
    if jax_tree:
        return jax.tree.map(lambda a: a[0], period)["moe"]
    return C.tree_map(lambda a: a[0], period)["moe"]


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_reference(arch):
    assert arch in T_ARCHS
    for t_cfg, r_cfg in ((get_config(arch), r_get_config(arch)),
                         (get_smoke_config(arch), r_get_smoke_config(arch))):
        for f in dataclasses.fields(r_cfg):
            if f.name == "moe":
                assert dataclasses.astuple(t_cfg.moe) == dataclasses.astuple(r_cfg.moe)
                assert t_cfg.moe.num_routed_padded == r_cfg.moe.num_routed_padded
            elif f.name not in ("param_dtype", "opt_dtype"):
                assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
        assert t_cfg.pattern == r_cfg.pattern == ("moe",) * r_cfg.num_layers
        t_specs = _by_path(Model(t_cfg).param_specs())
        r_specs = _by_path(RModel(r_cfg).param_specs())
        assert list(t_specs) == list(r_specs)
        for path, r in r_specs.items():
            t = t_specs[path]
            assert (t.shape, t.axes, t.init, t.scale) == (r.shape, r.axes, r.init, r.scale)
            assert str(t.dtype).split(".")[-1] == np.dtype(r.dtype).name, path
        assert Model(t_cfg).param_count() == RModel(r_cfg).param_count()
    get_config(arch.replace("_", "-").replace("2-7b", "2.7b"))  # the hyphenated id


def test_full_width_param_counts():
    """qwen2-moe-a2.7b: 14,835,091,456 parameters (27.63 GiB in bf16);
    moonshot-v1-16b-a3b: 28,552,923,136."""
    assert Model(get_config("qwen2_moe_a2_7b")).param_count() == 14_835_091_456
    assert Model(get_config("moonshot_v1_16b_a3b")).param_count() == 28_552_923_136
    experts = Model(get_config("qwen2_moe_a2_7b")).param_specs()["stack"]["period"][0]["moe"]
    assert experts["we_in"].shape == (24, 64, 2048, 1408)
    assert experts["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_specs(arch):
    model = Model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0))
    specs = model.param_specs()
    for p, s in zip(C.tree_leaves(params), C.tree_leaves(specs, C.is_spec_leaf), strict=True):
        assert tuple(p.shape) == s.shape and p.dtype == s.dtype
    router = params["stack"]["period"][0]["moe"]["router"]
    assert router.dtype == torch.float32
    assert 0.5 * 0.02 / 8 < float(router.std()) < 1.5 * 0.02 / 8  # small_normal 0.02/sqrt(d)


def test_large_leaves_draw_in_slices(monkeypatch):
    """A leaf past the draw chunk is drawn a slice of its leading axis at a
    time from the one generator: same shape, dtype and scale, the same
    numbers each time."""
    spec = C.ParamSpec((6, 5, 40), (None, None, None), torch.bfloat16)
    whole = C._materialize(spec, torch.Generator().manual_seed(3))
    monkeypatch.setattr(C, "_DRAW_CHUNK", 2 * 5 * 40)
    a = C._materialize(spec, torch.Generator().manual_seed(3))
    b = C._materialize(spec, torch.Generator().manual_seed(3))
    assert a.shape == whole.shape and a.dtype == whole.dtype == torch.bfloat16
    assert torch.equal(a, b)
    std = (1.0 / (6 * 5)) ** 0.5
    assert 0.8 * std < float(a.float().std()) < 1.2 * std


# ---------------------------------------------------------------------------
# Routing and the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,k,real", [(8, 2, 8), (64, 4, 60), (16, 6, 13)])
def test_routing_matches_reference(e, k, real):
    logits = np.random.default_rng(e + k).standard_normal((200, e)).astype(np.float32) * 2
    gates, top_w, top_e = M._routing(torch.from_numpy(logits), e, k, real)
    r_gates, r_w, r_e = RM._routing(jnp.asarray(logits), e, k, real)
    assert top_e.dtype == torch.int64
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(r_e))
    np.testing.assert_allclose(top_w.numpy(), np.asarray(r_w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gates.numpy(), np.asarray(r_gates), rtol=1e-6, atol=1e-6)
    assert int(top_e.max()) < real  # padded experts never picked
    assert bool((gates[:, real:] == 0).all())
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("combine_f32", [True, False], ids=["f32combine", "dtcombine"])
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dt, dispatch, combine_f32):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    kw = dict(moe_dispatch=dispatch, moe_combine_f32=combine_f32)
    r_cfg = dataclasses.replace(r_model.cfg, **kw)
    t_cfg = dataclasses.replace(t_model.cfg, **kw)
    x = np.random.default_rng(6).standard_normal((B, S_LEN, r_cfg.d_model), dtype=np.float32)
    jx, tx = _both(x, dt)
    want, r_aux = RM.moe_block(_layer0_moe(r_params, True), jx, r_cfg)
    got, t_aux = M.moe_block(_layer0_moe(t_params, False), tx, t_cfg)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, want, dt)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(t_aux[key]), float(r_aux[key]), rtol=1e-5)


def _reference_kept(top_e: np.ndarray, e: int, cap: int, dispatch: str) -> set:
    """The reference's kept (token, expert, rank) triples, written out from
    ``repro.models.moe.moe_block``'s two rank computations (jnp)."""
    te = jnp.asarray(top_e)
    t, k = top_e.shape
    if dispatch == "cumsum":
        onehot = jax.nn.one_hot(te, e, dtype=jnp.int32).sum(1)
        pos = jnp.cumsum(onehot, axis=0) - onehot
        rank = np.asarray(jnp.take_along_axis(pos, te, axis=1))
        return {(i, int(top_e[i, j]), int(rank[i, j]))
                for i in range(t) for j in range(k) if rank[i, j] < cap}
    flat_e = te.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se, stok = flat_e[order], jnp.repeat(jnp.arange(t), k)[order]
    seg = jnp.searchsorted(se, jnp.arange(e), side="left")
    rank = np.asarray(jnp.arange(t * k) - seg[se])
    se, stok = np.asarray(se), np.asarray(stok)
    return {(int(stok[i]), int(se[i]), int(rank[i])) for i in range(t * k) if rank[i] < cap}


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_kept_set_and_drops_match_reference(dispatch):
    """At capacity factor 0.5 the hot experts drop: the port's kept set and
    dropped count under each dispatch equal the reference's, the sort and
    cumsum ranks keep the same set, and the block's output still matches."""
    cf = 0.5
    r_model, r_params, t_model, t_params = _pair("qwen2_moe_a2_7b", "f32")
    moe = dataclasses.replace(t_model.cfg.moe, capacity_factor=cf)
    t_cfg = dataclasses.replace(t_model.cfg, moe=moe, moe_dispatch=dispatch)
    r_cfg = dataclasses.replace(r_model.cfg, moe_dispatch=dispatch,
                                moe=dataclasses.replace(r_model.cfg.moe, capacity_factor=cf))
    t = 4 * 64
    e, k = moe.num_routed_padded, moe.top_k
    cap = M.capacity(moe, t)
    assert cap == max(8, int(cf * t * k / e)) == 32
    logits = np.random.default_rng(9).standard_normal((t, e)).astype(np.float32)
    _, _, top_e = M._routing(torch.from_numpy(logits), e, k, moe.num_experts)
    tok, exp, rank, pair, by_token = M.dispatch_plan(top_e, e, dispatch)
    keep = rank < cap
    kept = {tuple(map(int, r)) for r in torch.stack([tok, exp, rank], 1)[keep]}
    want = _reference_kept(top_e.numpy(), e, cap, "cumsum" if dispatch == "cumsum" else "sort")
    assert kept == want
    assert t * k - len(kept) == int((~keep).sum()) > 0
    assert kept == _reference_kept(top_e.numpy(), e, cap, "sort")  # both ranks agree
    # every pair once; the plan's pair index, token and expert agree
    assert sorted(pair.tolist()) == list(range(t * k))
    assert torch.equal(top_e.reshape(-1)[pair], exp) and torch.equal(pair // k, tok)
    assert sorted(by_token.reshape(-1).tolist()) == list(range(t * k))
    assert bool((tok[by_token] == torch.arange(t)[:, None]).all())
    # the block at this capacity
    x = np.random.default_rng(10).standard_normal((4, 64, t_cfg.d_model), dtype=np.float32)
    jx, tx = _both(x, "f32")
    want_out, _ = RM.moe_block(_layer0_moe(r_params, True), jx, r_cfg)
    got_out, _ = M.moe_block(_layer0_moe(t_params, False), tx, t_cfg)
    _close(got_out, want_out, "f32")


def test_sort_combines_in_ascending_expert_order():
    """The sort dispatch sums a token's contributions in ascending expert
    id, the cumsum dispatch in top-k order (no scatter-add)."""
    top_e = torch.tensor([[3, 0, 2], [1, 2, 0]])
    tok, exp, _, _, by_sort = M.dispatch_plan(top_e, 4, "sort")
    assert exp[by_sort].tolist() == [[0, 2, 3], [0, 1, 2]]
    assert tok[by_sort].tolist() == [[0, 0, 0], [1, 1, 1]]
    *_, by_cumsum = M.dispatch_plan(top_e, 4, "cumsum")
    assert by_cumsum.tolist() == [[0, 1, 2], [3, 4, 5]]


# ---------------------------------------------------------------------------
# Model, prefill step, decode, serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_prefill_step_match_reference(arch, dt):
    r_model, r_params, t_model, t_params = _pair(arch, dt)
    moe = _layer0_moe(t_params, False)  # params_from_jax keeps each leaf's dtype
    assert moe["router"].dtype == moe["norm"].dtype == torch.float32
    assert moe["we_in"].dtype == moe["ws_out"].dtype == DT[dt][1]
    toks = _tokens(r_model.cfg, (B, S_LEN))
    want, r_aux = r_model.apply(r_params, jnp.asarray(toks))
    got, t_aux = t_model.apply(t_params, torch.from_numpy(toks))
    assert tuple(got.shape) == (B, S_LEN, r_model.cfg.vocab) and got.dtype == DT[dt][1]
    _close(got, want, dt)
    for key in ("load_balance", "router_z"):
        assert t_aux[key].dtype == torch.float32 and t_aux[key].shape == ()
        np.testing.assert_allclose(float(t_aux[key]), float(r_aux[key]), rtol=1e-4)
    assert float(t_aux["load_balance"]) > 0.5  # ~1 for a balanced router
    r_last = r_make_prefill_step(r_model)(r_params, {"tokens": jnp.asarray(toks)})
    t_last = make_prefill_step(t_model)(t_params, {"tokens": torch.from_numpy(toks)})
    _close(t_last, r_last, dt)
    assert torch.equal(t_last, got[:, -1, :])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dt):
    """Six teacher-forced decode steps (the MoE FFN after each layer's
    attention, at decode's own capacity): logits every step, then the
    cache."""
    r_model, r_params, t_model, t_params = _pair(arch, dt)
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
    for key in ("k", "v"):
        assert t_cache["kv"][key].dtype == DT[dt][1]
        _close(t_cache["kv"][key], r_cache["kv"][key], dt)


def test_serve_matches_reference_token_for_token(monkeypatch):
    """The serve loop's defaults on the float32 qwen2-moe smoke config with
    the reference loop's own weights: the same requests, the same tokens."""
    arch = "qwen2-moe-a2.7b"
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


# ---------------------------------------------------------------------------
# Mirrors of tests/test_arch_smoke.py's MoE cases (the port's own init)
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
