"""The port's training path held against repro on the CPU: the new
``_jaxrandom`` draws (``fold_in``, ``randint``, ``bernoulli``) and
``data.pipeline.host_batch`` bit for bit; the attention gradient (B7
forward, ``mha_chunked`` differentiated in the backward); ``Model.loss``,
dense and ``chunked_xent``, and its gradient against
``jax.value_and_grad`` over all ten architectures; remat on and off;
``optim.adamw`` over several steps with float32 and bfloat16 moments;
``checkpoint.manager`` (a checkpoint written by either package restores
into the other's tree bit for bit); ``make_train_step`` against the
reference's; and the mirrors of ``tests/test_substrate.py``'s data /
AdamW / checkpoint cases, ``tests/test_arch_smoke.py``'s train-grads case
and ``tests/test_train_e2e.py``'s two train cases on the port.

Gradients in float32 are held leaf by leaf to 1e-4 of the leaf's largest
reference entry (and 1e-4 relative); the loss to 1e-4.  The port's
forward attention is B7's plain version (float32 probabilities) where the
reference's is ``mha_chunked``, so the two agree to rounding.  The
architectures' weights come from the port's seeded init and cross to the
reference as numpy arrays (bit for bit, the inverse of
``params_from_jax``): the reference's own init costs more CPU time than
the comparison.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import os
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.manager import CheckpointManager as RCheckpointManager
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import host_batch as r_host_batch
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import attention as RA
from repro.models.frontends import synth_embeddings as r_synth_embeddings
from repro.models.model import Model as RModel
from repro.optim import adamw as radamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models.model import Model, params_from_jax
from repro_torch.optim import adamw
from repro_torch.sim import _jaxrandom

B, S = 2, 16
GRAD_TOL = 1e-4


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


def _to_jax(tree):
    """A tree of tensors as jax arrays of the same bits (bfloat16 through
    its 16-bit patterns)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())
    return C.tree_map(one, tree)


def _jax_order(tree) -> list:
    """The leaves of a tree of tensors in the reference's order (sorted
    dict keys)."""
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _grad_close(got, want):
    want = _np(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, rtol=GRAD_TOL, atol=GRAD_TOL * scale)


# ---------------------------------------------------------------------------
# jax.random draws and the data pipeline, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_jaxrandom_draws_match_jax_bit_for_bit(seed):
    k, kk = jax.random.key(seed), _jaxrandom.key(seed)
    for d in (0, 1, 7, 123_456, 2**32 - 1):
        assert tuple(np.asarray(jax.random.key_data(jax.random.fold_in(k, d)))) == \
            tuple(_jaxrandom.fold_in(kk, d))
    for shape, lo, hi in [((5, 1), 0, 13), ((3, 7), 0, 92_553), ((4_097,), 0, 151_936),
                          ((64,), -5, 2**31 - 1), ((4,), 3, 3)]:
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = _jaxrandom.randint(kk, shape, lo, hi)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for p in (0.15, 0.5, 0.999):
        assert np.array_equal(_jaxrandom.bernoulli(kk, p, (33, 17)),
                              np.asarray(jax.random.bernoulli(k, p, (33, 17))))


@pytest.mark.parametrize("kw", [dict(vocab_size=100, seq_len=32, global_batch=8),
                                dict(vocab_size=151_936, seq_len=64, global_batch=4,
                                     num_hosts=2, host_id=1, seed=3)])
def test_host_batch_matches_reference_bit_for_bit(kw):
    for step in (0, 5, 17):
        want = r_host_batch(RDataConfig(**kw), step)
        got = host_batch(DataConfig(**kw), step, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (k, step)


def test_data_deterministic():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8)
    assert torch.equal(host_batch(cfg, 5, "cpu")["tokens"], host_batch(cfg, 5, "cpu")["tokens"])


def test_data_differs_by_step_and_host():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8, num_hosts=2)
    a = host_batch(cfg, 1, "cpu")["tokens"]
    assert not torch.equal(a, host_batch(cfg, 2, "cpu")["tokens"])
    c = host_batch(DataConfig(vocab_size=100, seq_len=32, global_batch=8, num_hosts=2,
                              host_id=1), 1, "cpu")["tokens"]
    assert not torch.equal(a, c)


def test_data_labels_are_shifted_tokens():
    b = host_batch(DataConfig(vocab_size=100, seq_len=32, global_batch=4), 0, "cpu")
    assert b["tokens"].shape == (4, 32) and b["labels"].shape == (4, 32)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# The attention gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(sq=16, sk=16, hq=4, hkv=2, causal=True, window=0),
    dict(sq=40, sk=40, hq=4, hkv=1, causal=True, window=7),
    dict(sq=16, sk=5, hq=4, hkv=4, causal=False, window=0)], ids=["gqa", "window", "cross"])
def test_flash_mha_gradient_is_mha_chunked_gradient(case):
    """The autograd function's forward is B7 (its plain version here); its
    gradient is ``mha_chunked``'s, the reference's ``jax.grad`` of it."""
    rng = np.random.default_rng(0)
    d = 16
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in (
        (2, case["sq"], case["hq"], d), (2, case["sk"], case["hkv"], d),
        (2, case["sk"], case["hkv"], d)))
    g = rng.standard_normal((2, case["sq"], case["hq"], d), dtype=np.float32)
    kw = dict(causal=case["causal"], window=case["window"])
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.flash_mha(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "_FlashMHABackward"
    from repro_torch.kernels.flash_attention import flash_attention as FA
    assert torch.equal(out, FA.flash_attention_plain(tq, tk, tv, **kw))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    cq, ck, cv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = torch.autograd.grad(A.mha_chunked(cq, ck, cv, **kw), (cq, ck, cv),
                               torch.from_numpy(g))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ref = jax.jit(lambda q, k, v, g: jax.vjp(lambda *x: RA.mha_chunked(*x, **kw),
                                             q, k, v)[1](g))
    for a, b in zip(got, ref(*map(jnp.asarray, (q, k, v, g)))):
        _grad_close(a, b)


# ---------------------------------------------------------------------------
# Model.loss and its gradient against jax.value_and_grad, every architecture
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _f32_pair(arch: str, **kw):
    """(reference model, port model, the port's seeded float32 params, the
    same params as jax arrays, a batch for each)."""
    r_cfg = dataclasses.replace(r_get_smoke_config(arch), param_dtype=jnp.float32, **kw)
    t_cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=torch.float32, **kw)
    t_model = Model(t_cfg)
    t_params = t_model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, t_cfg.vocab_size, (2, B, S), dtype=np.int32)
    r_batch = {"tokens": jnp.asarray(toks[0]), "labels": jnp.asarray(toks[1])}
    if t_cfg.encoder_layers > 0 or t_cfg.frontend is not None:
        key = "frames" if t_cfg.encoder_layers > 0 else "prefix_embeds"
        r_batch[key] = r_synth_embeddings(r_cfg, B, jax.random.key(2), S)
    t_batch = {k: torch.from_numpy(np.array(v)) if v.dtype == jnp.int32
               else C.tensor_from_numpy(np.asarray(v), "cpu") for k, v in r_batch.items()}
    return RModel(r_cfg), t_model, t_params, _to_jax(t_params), r_batch, t_batch


def _value_and_grad(model, params, batch):
    leaves = [p.detach().requires_grad_() for p in C.tree_leaves(params)]
    it = iter(leaves)
    loss = model.loss(C.tree_map(lambda _: next(it), params), batch)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def _check_loss_and_grads(arch: str, **kw):
    r_model, t_model, t_params, r_params, r_batch, t_batch = _f32_pair(arch, **kw)
    want, r_grads = jax.jit(jax.value_and_grad(r_model.loss))(r_params, r_batch)
    got, grads = _value_and_grad(t_model, t_params, t_batch)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4, atol=1e-4)
    it = iter(grads)
    grads = _jax_order(C.tree_map(lambda p: next(it), t_params))
    r_leaves = jax.tree.leaves(r_grads)
    assert len(grads) == len(r_leaves)
    for g, rg in zip(grads, r_leaves):
        assert g is not None and tuple(g.shape) == rg.shape
        _grad_close(g, rg)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_value_and_grad(arch):
    _check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_26b"])
def test_chunked_xent_loss_and_grads_match_value_and_grad(arch):
    """``chunked_xent`` (chunks of 5 over 16 positions: a padded last
    chunk; internvl2's padded vocabulary masked) against the reference's."""
    _check_loss_and_grads(arch, loss_chunk=5)
    _, t_model, t_params, _, _, t_batch = _f32_pair(arch, loss_chunk=5)
    dense = Model(dataclasses.replace(t_model.cfg, loss_chunk=0))
    np.testing.assert_allclose(float(t_model.loss(t_params, t_batch)),
                               float(dense.loss(t_params, t_batch)), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_train_step_grads(arch):
    """``tests/test_arch_smoke.py::test_train_step_grads`` on the port (the
    bfloat16 smoke config): a finite loss, every gradient finite, and for
    the port every leaf reached (the SSM and hybrid scans included)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    _, _, _, _, _, f32_batch = _f32_pair(arch)
    batch = {k: v.to(cfg.param_dtype) if v.is_floating_point() else v
             for k, v in f32_batch.items()}
    loss, grads = _value_and_grad(model, params, batch)
    assert bool(torch.isfinite(loss))
    assert all(g is not None and bool(torch.isfinite(g.to(torch.float32)).all()) for g in grads)
    assert any(bool((g != 0).any()) for g in grads)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "seamless_m4t_large_v2", "recurrentgemma_2b",
                                  "qwen2_moe_a2_7b"])
def test_remat_on_and_off_give_equal_grads(arch, policy):
    """Both of the reference's remat policies give remat off's loss and
    gradients bit for bit."""
    _, t_model, t_params, _, _, t_batch = _f32_pair(arch)
    on = Model(dataclasses.replace(t_model.cfg, remat=True, remat_policy=policy))
    off = Model(dataclasses.replace(t_model.cfg, remat=False))
    l_on, g_on = _value_and_grad(on, t_params, t_batch)
    l_off, g_off = _value_and_grad(off, t_params, t_batch)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


class _KeptStorages(TorchDispatchMode):
    """Weak references to the storage of every op's output while active."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t.untyped_storage()))
        return out


def _kept_storage_count(model, params, batch) -> int:
    """Storages made by ``model.loss``'s forward that are still alive once
    it returns, while its loss (and so the autograd graph) is held: what
    the backward keeps, remat's saved products included."""
    leaves = [p.detach().requires_grad_() for p in C.tree_leaves(params)]
    with _KeptStorages() as mode:
        loss = model.loss(C.tree_unflatten(params, leaves), batch)
    gc.collect()
    ids = {id(s) for s in (r() for r in mode.refs) if s is not None}
    del loss
    return len(ids)


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen2_moe_a2_7b"])
def test_remat_dots_saves_the_unbatched_products(arch):
    """``"dots"`` keeps the projections' outputs (``einsum`` reaches them as
    a batch-of-one ``bmm``), so the forward leaves strictly more tensors
    alive for the backward than ``"nothing"`` does (counted by storage),
    and an unknown policy string saves what ``"nothing"`` saves, as in the
    reference."""
    _, t_model, t_params, _, _, t_batch = _f32_pair(arch)
    count = {pol: _kept_storage_count(
        Model(dataclasses.replace(t_model.cfg, remat=True, remat_policy=pol)), t_params, t_batch)
        for pol in ("nothing", "dots", "no-such-policy")}
    assert count["dots"] > count["nothing"]
    assert count["no-such-policy"] == count["nothing"]
    _, grads = _value_and_grad(Model(dataclasses.replace(t_model.cfg, remat=True,
                                                         remat_policy="no-such-policy")),
                               t_params, t_batch)
    _, want = _value_and_grad(Model(dataclasses.replace(t_model.cfg, remat=False)),
                              t_params, t_batch)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_linear_scan_grad_path_is_bit_for_bit():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0, 1, (2, 37, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 3, 4)).astype(np.float32))
    want = C.linear_scan_(a, b.clone())
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = C.linear_scan_(ag, bg)
    assert got is not bg and torch.equal(got, want) and torch.equal(bg, b)
    got.sum().backward()
    assert bool(torch.isfinite(ag.grad).all()) and bool((bg.grad != 0).all())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_steps_match_reference(moments):
    mdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[moments]
    rng = np.random.default_rng(0)
    r_params = {"a": jnp.asarray(rng.standard_normal((8, 5)), jnp.bfloat16),
                "b": [jnp.asarray(rng.standard_normal((7,)), jnp.float32),
                      jnp.asarray(rng.standard_normal((3, 4)), jnp.float32)]}
    r_cfg = radamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10, moment_dtype=mdt[0])
    t_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10, moment_dtype=mdt[1])
    t_params = params_from_jax(jax.tree.map(np.asarray, r_params), "cpu")
    r_state, t_state = radamw.init(r_params, r_cfg), adamw.init(t_params, t_cfg)
    assert t_state["mu"]["a"].dtype == mdt[1] and t_state["step"].dtype == torch.int32
    for i in range(6):
        r_grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape) * (30 if i == 2 else 1), p.dtype), r_params)
        t_grads = params_from_jax(jax.tree.map(np.asarray, r_grads), "cpu")
        r_params, r_state, r_m = radamw.step(r_params, r_grads, r_state, r_cfg)
        t_m = adamw.step_(t_params, t_grads, t_state, t_cfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(t_m[k]), float(r_m[k]), rtol=1e-6)
    assert int(t_state["step"]) == int(r_state["step"]) == 6
    for got, want in zip(_jax_order([t_params, t_state["mu"], t_state["nu"]]),
                         jax.tree.leaves([r_params, r_state["mu"], r_state["nu"]])):
        assert got.dtype == {jnp.bfloat16: torch.bfloat16,
                             jnp.float32: torch.float32}[want.dtype.type]
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)


def test_adamw_reduces_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.ones((4, 4)) * 3.0}
    state = adamw.init(params, cfg)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(50):
        adamw.step_(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 0.1 * l0


def test_adamw_clips():
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros((2,))}
    m = adamw.step_(params, {"w": torch.tensor([1e6, 1e6])}, adamw.init(params, cfg), cfg)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_adamw_moment_dtype_policy():
    cfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    state = adamw.init({"w": torch.zeros((2, 2), dtype=torch.bfloat16)}, cfg)
    assert state["mu"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _state_tree():
    """A train-state-shaped tree, keys out of sorted order: bfloat16,
    float32 and int32 leaves in dicts and lists."""
    rng = np.random.default_rng(9)
    return {"params": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
                       "b": [jnp.asarray(rng.standard_normal((5,)), jnp.float32),
                             jnp.asarray(rng.standard_normal((2, 2)), jnp.bfloat16)]},
            "opt": {"step": jnp.asarray(7, jnp.int32),
                    "mu": {"z": jnp.asarray(rng.standard_normal((4,)), jnp.float32)}}}


def _port_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)) if a.dtype == jnp.int32
                        else C.tensor_from_numpy(np.asarray(a), "cpu"), tree)


def _equal_bits(got_tree, want_tree):
    got = jax.tree.leaves(got_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = jax.tree.leaves(want_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a if isinstance(a, torch.Tensor) else _port_tree(a)
        b = b if isinstance(b, torch.Tensor) else _port_tree(b)
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype ==
                                                  torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype ==
                                                  torch.bfloat16 else b)


def test_checkpoint_crosses_packages_bit_for_bit(tmp_path):
    ref_tree = _state_tree()
    port_tree = _port_tree(ref_tree)
    RCheckpointManager(str(tmp_path / "r")).save(3, ref_tree, blocking=True)
    got = CheckpointManager(str(tmp_path / "r")).restore(3, C.tree_map(torch.zeros_like,
                                                                      port_tree))
    _equal_bits(got, port_tree)
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(4, port_tree, blocking=True)
    want_manifest = (tmp_path / "r" / "step_000000003" / "manifest.json").read_text()
    got_manifest = (tmp_path / "t" / "step_000000004" / "manifest.json").read_text()
    assert got_manifest == want_manifest.replace('"step": 3', '"step": 4')
    back = RCheckpointManager(str(tmp_path / "t")).restore(4, ref_tree)
    _equal_bits(_port_tree(back), port_tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)}}
    mgr.save(7, tree, blocking=True)
    assert mgr.latest_step() == 7
    out = mgr.restore(7, tree)
    assert torch.equal(out["a"], torch.arange(10)) and out["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros((2,))}, blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(1000)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_async_snapshot_survives_in_place_update(tmp_path, monkeypatch):
    """An async save holds the values the tree had when ``save`` returned:
    the file writes are held back until the train step has updated the
    parameters, the moments and the step counter in place."""
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1)
    params = {"w": torch.ones((3, 4)), "b": torch.ones((4,), dtype=torch.bfloat16)}
    state = adamw.init(params, cfg)
    adamw.step_(params, C.tree_map(torch.ones_like, params), state, cfg)
    tree = {"params": params, "opt": state}
    want = C.tree_map(torch.clone, tree)
    updated, save = threading.Event(), np.save

    def held_save(*a, **kw):
        assert updated.wait(timeout=30)
        return save(*a, **kw)

    monkeypatch.setattr(np, "save", held_save)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    adamw.step_(params, C.tree_map(torch.ones_like, params), state, cfg)
    assert not torch.equal(params["w"], want["params"]["w"])
    updated.set()
    mgr.wait()
    _equal_bits(mgr.restore(1, tree), want)


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp directory must never be visible as a restorable step."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_000000099.tmp")
    assert mgr.all_steps() == []


# ---------------------------------------------------------------------------
# The train step and the trainer
# ---------------------------------------------------------------------------


def test_train_step_matches_reference():
    """Three ``make_train_step`` steps (float32 qwen3-4b smoke, AdamW)
    against the reference's jitted ones: losses, gradient norms, and every
    parameter and moment after the last step."""
    r_model, t_model, t_params, r_params, _, _ = _f32_pair("qwen3_4b")
    t_params = C.tree_map(torch.clone, t_params)  # the step updates in place
    r_opt = radamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    t_opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    r_step = jax.jit(r_make_train_step(r_model, r_opt))
    t_step = make_train_step(t_model, t_opt)
    r_state, t_state = radamw.init(r_params, r_opt), adamw.init(t_params, t_opt)
    data = RDataConfig(vocab_size=t_model.cfg.vocab_size, seq_len=S, global_batch=B)
    for step in range(3):
        r_params, r_state, r_m = r_step(r_params, r_state, r_host_batch(data, step))
        t_m = t_step(t_params, t_state, host_batch(
            DataConfig(**dataclasses.asdict(data)), step, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(t_m[k]), float(r_m[k]), rtol=1e-4)
    # Adam's normalized step turns a rounding-level gradient difference on a
    # near-zero entry into a part of a step: parameters are held to a
    # twentieth of the learning rate, the moments as gradients are
    for got, want in zip(_jax_order(t_params), jax.tree.leaves(r_params), strict=True):
        np.testing.assert_allclose(_np(got), _np(want), rtol=GRAD_TOL, atol=0.05 * t_opt.lr)
    for got, want in zip(_jax_order([t_state["mu"], t_state["nu"]]),
                         jax.tree.leaves([r_state["mu"], r_state["nu"]]), strict=True):
        assert tuple(got.shape) == want.shape
        _grad_close(got, want)


def _train_args(tmp_path, **kw):
    base = dict(arch="qwen3-4b", smoke=True, steps=24, batch=2, seq=64, lr=5e-3, seed=0,
                log_every=100, ckpt_dir=str(tmp_path), ckpt_every=8, fail_at=None,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@functools.lru_cache(maxsize=None)
def _clean_run(tmp_root: str) -> dict:
    from repro_torch.launch.train import run
    return run(_train_args(tmp_root))


def test_train_reduces_loss(tmp_path_factory):
    out = _clean_run(str(tmp_path_factory.getbasetemp() / "clean"))
    assert out["last_loss"] < out["first_loss"]


def test_train_failure_restart(tmp_path, tmp_path_factory):
    """Injected failure at step 16 -> the restart restores step 8's
    checkpoint and finishes all 24 steps, tracking the clean run within the
    reference test's band."""
    from repro_torch.launch.train import run
    clean = _clean_run(str(tmp_path_factory.getbasetemp() / "clean"))
    out = run(_train_args(tmp_path / "b", fail_at=16))
    assert out["restored_step"] == 8
    assert clean["restored_step"] is None
    assert len(out["losses"]) == 24 - 8
    np.testing.assert_allclose(out["losses"], clean["losses"][8:], rtol=0.05, atol=0.05)
