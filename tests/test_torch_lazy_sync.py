"""LazySync on the port (repro_torch.core.lazy_sync), on the CPU.

* Every test of ``tests/test_lazy_sync.py``, mirrored on the port (same
  names with a ``test_port_`` prefix): exactness at commit boundaries, no
  false negatives, the pin and streak rules, the reconcile budget.
* Parity with ``repro``: the same numpy-seeded touched ids and gradients
  and the same params (carried across with ``params_from_jax``) through
  ``sync_step`` for nine steps (two commit intervals and a bit) in
  float32 and in bfloat16, the working dtype.  ``rows``, ``valid``, the
  conflict mask, ``streak``, ``step`` and every metric must be equal; the
  params must be equal bit for bit on every row but row 0 in both dtypes
  (the port runs the reference's float32 arithmetic in the reference's
  order).  Row 0 is where the reference's reconcile can leave a stale
  value (see ``test_row0_merged_where_reference_leaves_it_stale``), so it
  is held to a numpy replay of the port's formula instead, also exactly.
* The port's own contract: materialized replicas, no writes to inputs,
  out-of-range ids raise, the host-side step counter, the config registry.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.core import lazy_sync as R
from repro_torch.configs import ALIASES, ARCHS, get_config, get_smoke_config
from repro_torch.core.lazy_sync import (
    LazyEmbed,
    LazySyncConfig,
    init_state,
    params_from_jax,
)

LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
BF16 = ml_dtypes.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def setup():
    mcfg = get_smoke_config("qwen3_4b")
    cfg = LazySyncConfig(num_groups=4, commit_interval=4,
                         max_reconcile_rows=128, embed_lr=0.1)
    emb = LazyEmbed(mcfg, cfg)
    params = emb.init(torch.Generator().manual_seed(0))
    state = init_state(cfg, mcfg.vocab, "cpu")
    return mcfg, cfg, emb, params, state


def _rand_touch_grads(mcfg, cfg, seed, t=16):
    rng = np.random.default_rng(seed)
    touched = rng.integers(0, mcfg.vocab, size=(cfg.num_groups, t)).astype(np.int32)
    g = (rng.normal(size=(cfg.num_groups, t, mcfg.d_model)) * 0.1).astype(np.float32)
    grads = np.zeros((cfg.num_groups, mcfg.vocab, mcfg.d_model), np.float32)
    for gi in range(cfg.num_groups):
        np.add.at(grads[gi], touched[gi], g[gi])
    return torch.from_numpy(touched), torch.from_numpy(grads)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _zero_grads(mcfg, cfg):
    return torch.zeros((cfg.num_groups, mcfg.vocab, mcfg.d_model))


def _stack(*rows):
    return torch.stack([torch.as_tensor(r, dtype=torch.int32) for r in rows])


def _full(n, v):
    return torch.full((n,), v, dtype=torch.int32)


def _arange(a, b):
    return torch.arange(a, b, dtype=torch.int32)


# ---------------------------------------------------------------------------
# tests/test_lazy_sync.py, mirrored on the port
# ---------------------------------------------------------------------------


def test_port_commit_equals_dense_sgd(setup):
    mcfg, cfg, emb, params, state = setup
    dense = _f32(params["base"])
    for step in range(cfg.commit_interval):
        touched, grads = _rand_touch_grads(mcfg, cfg, 1 + step)
        dense = dense - cfg.embed_lr * grads.numpy().sum(0)
        params, state, _ = emb.sync_step(params, state, touched, grads)
    np.testing.assert_allclose(_f32(params["base"]), dense, rtol=2e-2, atol=2e-2)
    for g in range(cfg.num_groups):
        np.testing.assert_allclose(_f32(params["table"][g]), dense,
                                   rtol=2e-2, atol=2e-2)


def test_port_conflict_no_false_negatives(setup):
    mcfg, cfg, emb, params, state = setup
    shared_row = 7
    touched = _stack(_full(8, shared_row), _full(8, shared_row),
                     _arange(100, 108), _arange(200, 208))
    rows, valid = emb.detect_conflicts(touched, emb.signatures(touched))
    assert bool(((rows == shared_row) & valid).any())


def test_port_reconciled_row_exact(setup):
    mcfg, cfg, emb, params, state = setup
    row = 3
    touched = torch.full((cfg.num_groups, 4), row, dtype=torch.int32)
    grads = _zero_grads(mcfg, cfg)
    deltas = np.arange(1, cfg.num_groups + 1, dtype=np.float32)
    for g in range(cfg.num_groups):
        grads[g, row] = float(deltas[g])
    expect = _f32(params["base"][row]) - cfg.embed_lr * deltas.sum()
    params, state, m = emb.sync_step(params, state, touched, grads)
    assert int(m["lazy_conflict_rows"]) >= 1
    np.testing.assert_allclose(_f32(params["base"][row]), expect, rtol=2e-2, atol=2e-2)


def test_port_pinned_row_forced_into_reconcile(setup):
    mcfg, cfg, emb, params, state = setup
    row = 11
    touched = _stack(_full(8, row), _arange(100, 108), _arange(200, 208),
                     _arange(300, 308))
    streak = state["streak"].clone()
    streak[row] = cfg.pin_streak
    state = {**state, "streak": streak}
    grads = _zero_grads(mcfg, cfg)
    grads[0, row] = 1.0
    expect = _f32(params["base"][row]) - cfg.embed_lr
    params2, state2, m = emb.sync_step(params, state, touched, grads)
    assert int(m["lazy_pinned"]) >= 1
    np.testing.assert_allclose(_f32(params2["base"][row]), expect, rtol=2e-2, atol=2e-2)


def test_port_unpinned_single_writer_stays_lazy(setup):
    mcfg, cfg, emb, params, state = setup
    row = 11
    touched = _stack(_full(8, row), _arange(100, 108), _arange(200, 208),
                     _arange(300, 308))
    grads = _zero_grads(mcfg, cfg)
    grads[0, row] = 1.0
    base_before = _f32(params["base"][row])
    params2, _, m = emb.sync_step(params, state, touched, grads)
    assert int(m["lazy_pinned"]) == 0
    np.testing.assert_array_equal(_f32(params2["base"][row]), base_before)


def test_port_streak_counts_steps_not_duplicates(setup):
    mcfg, cfg, emb, params, state = setup
    row = 7
    touched = _stack(_full(8, row), _full(8, row), _arange(100, 108),
                     _arange(200, 208))
    grads = _zero_grads(mcfg, cfg)
    for step in range(2):
        params, state, m = emb.sync_step(params, state, touched, grads)
        assert int(state["streak"][row]) == step + 1


def test_port_streak_resets_on_nonconflicting_touch(setup):
    mcfg, cfg, emb, params, state = setup
    row = 7
    conflicting = _stack(_full(8, row), _full(8, row), _arange(100, 108),
                         _arange(200, 208))
    solo = _stack(_full(8, row), _arange(300, 308), _arange(100, 108),
                  _arange(200, 208))
    grads = _zero_grads(mcfg, cfg)
    params, state, _ = emb.sync_step(params, state, conflicting, grads)
    assert int(state["streak"][row]) == 1
    params, state, _ = emb.sync_step(params, state, solo, grads)
    assert int(state["streak"][row]) == 0
    params, state, _ = emb.sync_step(params, state, conflicting, grads)
    assert int(state["streak"][row]) == 1


def test_port_pinned_row_survives_budget_pressure(setup):
    mcfg, cfg, emb, params, state = setup
    cfg = dataclasses.replace(cfg, num_groups=2, max_reconcile_rows=4)
    emb = LazyEmbed(mcfg, cfg)
    pinned_row = 5
    touched = _stack(torch.cat([_full(4, pinned_row), _arange(100, 116)]),
                     torch.cat([_arange(300, 304), _arange(100, 116)]))
    state = init_state(cfg, mcfg.vocab, "cpu")
    state["streak"][pinned_row] = cfg.pin_streak
    sigs = emb.signatures(touched)
    pinned_mask = state["streak"][touched.reshape(-1).long()] >= cfg.pin_streak
    rows, valid = emb.detect_conflicts(touched, sigs, force=pinned_mask)
    assert rows.shape[0] == cfg.max_reconcile_rows
    assert bool(((rows == pinned_row) & valid).any())


def test_port_duplicate_pinned_entries_cannot_crowd_out_other_pins(setup):
    mcfg, cfg, emb, params, state = setup
    cfg = dataclasses.replace(cfg, num_groups=2, max_reconcile_rows=4)
    emb = LazyEmbed(mcfg, cfg)
    params = emb.init(torch.Generator().manual_seed(0))
    a, b = 5, 6
    touched = _stack(torch.cat([_full(4, a), _full(1, b), _arange(100, 111)]),
                     torch.cat([_arange(300, 305), _arange(100, 111)]))
    state = init_state(cfg, mcfg.vocab, "cpu")
    state["streak"][a] = cfg.pin_streak
    state["streak"][b] = cfg.pin_streak
    params, state, m = emb.sync_step(params, state, touched,
                                     _zero_grads(mcfg, cfg))
    assert int(m["lazy_pinned"]) == 2
    assert int(state["streak"][a]) >= cfg.pin_streak
    assert int(state["streak"][b]) >= cfg.pin_streak


def test_port_fused_kernel_conflict_path_matches(setup):
    """The port always detects on packed signatures (the fused detector's
    path); ``use_kernel`` is kept for field parity and changes nothing, and
    the result equals the reference's unfused jnp path."""
    mcfg, cfg, emb, params, state = setup
    emb_k = LazyEmbed(mcfg, dataclasses.replace(cfg, use_kernel=True))
    touched, _ = _rand_touch_grads(mcfg, cfg, 9)
    sigs = emb.signatures(touched)
    rows, valid = emb.detect_conflicts(touched, sigs)
    rows_k, valid_k = emb_k.detect_conflicts(touched, sigs)
    assert torch.equal(rows, rows_k) and torch.equal(valid, valid_k)
    r_emb = R.LazyEmbed(r_get_smoke_config("qwen3_4b"),
                        R.LazySyncConfig(num_groups=4, commit_interval=4,
                                         max_reconcile_rows=128, embed_lr=0.1))
    r_t = jnp.asarray(touched.numpy())
    r_rows, r_valid = r_emb.detect_conflicts(r_t, r_emb.signatures(r_t))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))


def test_port_bytes_savings(setup):
    mcfg, cfg, emb, params, state = setup
    touched, grads = _rand_touch_grads(mcfg, cfg, 3)
    params, state, m = emb.sync_step(params, state, touched, grads)
    assert float(m["lazy_bytes"]) < 0.3 * float(m["dense_bytes"])


# ---------------------------------------------------------------------------
# Parity with repro through sync_step
# ---------------------------------------------------------------------------


def _zipf_touch(rng, vocab, g, t):
    """Skewed ids, floor(V * u**3) as the capture draws them: the hot end
    (row 0 included) is touched by several groups every step."""
    u = rng.random((g, t))
    return np.minimum((vocab * u ** 3).astype(np.int64), vocab - 1).astype(np.int32)


def _sparse_grads(rng, touched, vocab, d):
    g, t = touched.shape
    grads = np.zeros((g, vocab, d), np.float32)
    vals = (rng.normal(size=(g, t, d)) * 0.1).astype(np.float32)
    for gi in range(g):
        np.add.at(grads[gi], touched[gi], vals[gi])
    return grads


def _cast(x: np.ndarray, dtype) -> np.ndarray:
    """Round float32 values to the working dtype, as float32."""
    return x.astype(dtype).astype(np.float32) if dtype is BF16 else x


def _merge_np(rows_g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The port's merge formula in numpy float32: acc over groups from 0 up,
    then base + acc."""
    acc = np.zeros_like(b)
    for g in range(rows_g.shape[0]):
        acc = acc + (rows_g[g] - b)
    return b + acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_step_matches_reference(dtype):
    jdt, tdt, ndt = {"float32": (jnp.float32, torch.float32, np.float32),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}[dtype]
    r_mcfg = dataclasses.replace(r_get_smoke_config("qwen3_4b"), param_dtype=jdt)
    t_mcfg = dataclasses.replace(get_smoke_config("qwen3_4b"), param_dtype=tdt)
    kw = dict(num_groups=4, commit_interval=4, max_reconcile_rows=64, embed_lr=0.1)
    r_emb, t_emb = R.LazyEmbed(r_mcfg, R.LazySyncConfig(**kw)), \
        LazyEmbed(t_mcfg, LazySyncConfig(**kw))
    vocab, d, g = t_mcfg.vocab, t_mcfg.d_model, 4
    r_params = r_emb.init(jax.random.key(0))
    t_params = params_from_jax({k: np.asarray(v) for k, v in r_params.items()}, "cpu")
    r_state, t_state = R.init_state(r_emb.cfg, vocab), init_state(t_emb.cfg, vocab, "cpu")
    # numpy replay of row 0 under the port's formula
    t0 = np.asarray(r_params["table"][:, 0]).astype(np.float32)
    b0 = np.asarray(r_params["base"][0]).astype(np.float32)
    rng = np.random.default_rng(42)
    commits, row0_merged = 0, 0
    for step in range(9):
        touched = _zipf_touch(rng, vocab, g, 24)
        grads = _sparse_grads(rng, touched, vocab, d)
        r_t, t_t = jnp.asarray(touched), torch.from_numpy(touched)
        # the reconcile set and conflict mask, from the same pre-step inputs
        r_pinned = r_state["streak"][r_t.reshape(-1)] >= r_emb.cfg.pin_streak
        t_pinned = t_state["streak"][t_t.reshape(-1).long()] >= t_emb.cfg.pin_streak
        r_rows, r_valid, r_mask = r_emb.detect_conflicts(
            r_t, r_emb.signatures(r_t), force=r_pinned, with_mask=True)
        t_rows, t_valid, t_mask = t_emb.detect_conflicts(
            t_t, t_emb.signatures(t_t), force=t_pinned, with_mask=True)
        np.testing.assert_array_equal(t_rows.numpy(), np.asarray(r_rows))
        np.testing.assert_array_equal(t_valid.numpy(), np.asarray(r_valid))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(r_mask))

        r_params, r_state, r_m = r_emb.sync_step(r_params, r_state, r_t,
                                                 jnp.asarray(grads))
        t_params, t_state, t_m = t_emb.sync_step(t_params, t_state, t_t,
                                                 torch.from_numpy(grads))
        assert int(t_state["step"]) == int(r_state["step"]) == step + 1
        np.testing.assert_array_equal(t_state["streak"].numpy(),
                                      np.asarray(r_state["streak"]))
        assert set(t_m) == set(r_m)
        for k in r_m:
            assert int(t_m[k]) == int(r_m[k]), (step, k)

        # row 0 under the port's formula
        t0 = _cast(t0 - grads[:, 0] * np.float32(0.1), ndt)
        merged_rows = t_rows.numpy()[t_valid.numpy()]
        if 0 in merged_rows:
            row0_merged += 1
            b0 = _cast(_merge_np(t0, b0), ndt)
            t0 = np.broadcast_to(b0, t0.shape).copy()
        if bool(t_m["lazy_commit"]):
            commits += 1
            b0 = _cast(_merge_np(t0, b0), ndt)
            t0 = np.broadcast_to(b0, t0.shape).copy()
        np.testing.assert_array_equal(_f32(t_params["base"][0]), b0)
        np.testing.assert_array_equal(_f32(t_params["table"][:, 0]), t0)
        # every other row: bit for bit the reference's
        for k in ("table", "base"):
            r_arr = np.asarray(r_params[k]).astype(np.float32)
            t_arr = _f32(t_params[k])
            np.testing.assert_array_equal(t_arr[..., 1:, :], r_arr[..., 1:, :],
                                          err_msg=f"{k} at step {step}")
    assert commits == 2 and row0_merged >= 2  # the data exercises both


def test_row0_merged_where_reference_leaves_it_stale():
    """All four groups touch row 0, no other row conflicts, budget 16: the
    only valid budget slot is row 0 and the 15 invalid slots also map to
    row 0.  The reference's duplicate-index scatter lets a stale slot win,
    so its base[0] stays the old base; the port scatters only the valid
    row and gives base + sum_g (table_g - base)."""
    kw = dict(num_groups=4, max_reconcile_rows=16, embed_lr=0.1)
    r_mcfg = dataclasses.replace(r_get_smoke_config("qwen3_4b"), param_dtype=jnp.float32)
    t_mcfg = dataclasses.replace(get_smoke_config("qwen3_4b"), param_dtype=torch.float32)
    r_emb, t_emb = R.LazyEmbed(r_mcfg, R.LazySyncConfig(**kw)), \
        LazyEmbed(t_mcfg, LazySyncConfig(**kw))
    vocab, d = t_mcfg.vocab, t_mcfg.d_model
    touched = np.stack([np.array([0] + list(range(100 * g + 1, 100 * g + 8)))
                        for g in range(1, 5)]).astype(np.int32)
    rng = np.random.default_rng(0)
    grads = _sparse_grads(rng, touched, vocab, d)
    r_params = r_emb.init(jax.random.key(0))
    t_params = params_from_jax({k: np.asarray(v) for k, v in r_params.items()}, "cpu")
    base0 = np.asarray(r_params["base"][0])
    r_t, t_t = jnp.asarray(touched), torch.from_numpy(touched)
    r_rows, r_valid = r_emb.detect_conflicts(r_t, r_emb.signatures(r_t))
    t_rows, t_valid = t_emb.detect_conflicts(t_t, t_emb.signatures(t_t))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(r_valid))
    assert t_rows.numpy()[t_valid.numpy()].tolist() == [0]
    assert int((~t_valid).sum()) == 15

    r_new, _, _ = r_emb.sync_step(r_params, R.init_state(r_emb.cfg, vocab), r_t,
                                  jnp.asarray(grads))
    t_new, _, _ = t_emb.sync_step(t_params, init_state(t_emb.cfg, vocab, "cpu"), t_t,
                                  torch.from_numpy(grads))
    table0 = np.asarray(r_params["table"][:, 0]) - grads[:, 0] * np.float32(0.1)
    want = _merge_np(table0, base0)
    assert not np.allclose(want, base0)
    # the reference leaves row 0 stale in base and in every replica keeps
    # its own speculative value
    np.testing.assert_array_equal(np.asarray(r_new["base"][0]), base0)
    np.testing.assert_array_equal(np.asarray(r_new["table"][:, 0]), table0)
    # the port merges it
    np.testing.assert_array_equal(t_new["base"][0].numpy(), want)
    for g in range(4):
        np.testing.assert_array_equal(t_new["table"][g, 0].numpy(), want)
    # every other row agrees
    np.testing.assert_array_equal(t_new["base"][1:].numpy(), np.asarray(r_new["base"][1:]))
    np.testing.assert_array_equal(t_new["table"][:, 1:].numpy(),
                                  np.asarray(r_new["table"][:, 1:]))


@pytest.mark.parametrize("bad", [-1, 512, 10**6])
def test_out_of_range_ids_raise(setup, bad):
    """The reference drops out-of-range scatters and clamps its gathers;
    the port refuses such ids."""
    mcfg, cfg, emb, params, state = setup
    assert mcfg.vocab == 512
    touched = torch.zeros((cfg.num_groups, 4), dtype=torch.int32)
    touched[2, 1] = bad
    with pytest.raises(ValueError, match=r"\[0, 512\)"):
        emb.sync_step(params, state, touched, _zero_grads(mcfg, cfg))
    with pytest.raises(ValueError, match=r"\[0, 512\)"):
        emb.detect_conflicts(touched, emb.signatures(touched))
    # the reference runs on without a word
    r_emb = R.LazyEmbed(r_get_smoke_config("qwen3_4b"), R.LazySyncConfig())
    r_emb.detect_conflicts(jnp.asarray(touched.numpy()),
                           r_emb.signatures(jnp.asarray(touched.numpy())))


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------


def test_replicas_are_materialized_and_inputs_untouched(setup):
    """init and commit give G separate replicas (not expand views), and no
    method writes the tensors it was given."""
    mcfg, cfg, emb, params, state = setup
    assert all(s != 0 for s in params["table"].stride())
    snap = {k: v.clone() for k, v in params.items()}
    streak = state["streak"].clone()
    for step in range(cfg.commit_interval):
        touched, grads = _rand_touch_grads(mcfg, cfg, 20 + step)
        new, new_state, m = emb.sync_step(params, state, touched, grads)
        for k in params:
            assert torch.equal(params[k], snap[k])
        assert torch.equal(state["streak"], streak)
        params, state = new, new_state
        snap = {k: v.clone() for k, v in params.items()}
        streak = state["streak"].clone()
    assert bool(m["lazy_commit"])
    table = params["table"]
    assert all(s != 0 for s in table.stride())
    before = table[1, 5].clone()
    table[0, 5] += 1.0
    assert torch.equal(table[1, 5], before)


def test_commit_runs_the_merge_over_every_row(setup, monkeypatch):
    mcfg, cfg, emb, params, state = setup
    calls = []
    real = LM.lazy_merge

    def spy(rows, base, valid):
        calls.append((tuple(rows.shape), bool(valid.all())))
        return real(rows, base, valid)

    monkeypatch.setattr(LM, "lazy_merge", spy)
    emb.commit(params)
    assert calls == [((cfg.num_groups, mcfg.vocab, mcfg.d_model), True)]
    touched, grads = _rand_touch_grads(mcfg, cfg, 5)
    calls.clear()
    emb.sync_step(params, state, touched, grads)
    budget = min(cfg.max_reconcile_rows, touched.numel())
    assert calls[0][0] == (cfg.num_groups, budget, mcfg.d_model)


def test_step_counter_stays_on_the_host(setup):
    mcfg, cfg, emb, params, state = setup
    assert state["step"].device.type == "cpu" and state["step"].dtype == torch.int32
    touched, grads = _rand_touch_grads(mcfg, cfg, 4)
    for step in range(cfg.commit_interval + 1):
        params, state, m = emb.sync_step(params, state, touched, grads)
        assert int(state["step"]) == step + 1
        assert bool(m["lazy_commit"]) == ((step + 1) % cfg.commit_interval == 0)


def test_init_state_defaults_to_cuda():
    """``device=None`` means the card, as for every entry point of the
    port; without one it raises instead of carrying on on the CPU."""
    cfg = LazySyncConfig()
    if torch.cuda.is_available():
        assert init_state(cfg, 64)["streak"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(cfg, 64)
    assert init_state(cfg, 64, "cpu")["streak"].device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_keeps_every_bit(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    mcfg = dataclasses.replace(r_get_smoke_config("qwen3_4b"), param_dtype=jdt)
    r_params = R.LazyEmbed(mcfg, R.LazySyncConfig()).init(jax.random.key(3))
    np_params = {k: np.asarray(v) for k, v in r_params.items()}
    t_params = params_from_jax(np_params, "cpu")
    for k, a in np_params.items():
        t = t_params[k]
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == a.shape
        assert t.is_contiguous()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(TypeError):
        params_from_jax({"base": np.zeros(3, np.float64)}, "cpu")


def test_lookup_and_logits_match_reference():
    r_emb = R.LazyEmbed(r_get_smoke_config("qwen3_4b"), R.LazySyncConfig())
    t_emb = LazyEmbed(get_smoke_config("qwen3_4b"), LazySyncConfig())
    r_params = r_emb.init(jax.random.key(1))
    t_params = params_from_jax({k: np.asarray(v) for k, v in r_params.items()}, "cpu")
    tokens = np.random.default_rng(0).integers(0, 512, size=(4, 2, 5)).astype(np.int32)
    r_x = r_emb.lookup(r_params, jnp.asarray(tokens))
    t_x = t_emb.lookup(t_params, torch.from_numpy(tokens))
    assert t_x.dtype == torch.bfloat16 and tuple(t_x.shape) == (4, 2, 5, 64)
    np.testing.assert_array_equal(_f32(t_x), np.asarray(r_x).astype(np.float32))
    r_l = np.asarray(r_emb.logits(r_params, r_x)).astype(np.float32)
    t_l = _f32(t_emb.logits(t_params, t_x))
    assert t_l.shape == (4, 2, 5, 512)
    # bf16 products summed over d = 64 in two frameworks: bf16 rounding of
    # the result (2**-8 relative) plus accumulation order
    np.testing.assert_allclose(t_l, r_l, rtol=1e-2, atol=1e-2)


def test_param_specs_match_reference():
    r_specs = R.LazyEmbed(r_get_config("qwen3_4b"), R.LazySyncConfig()).param_specs()
    t_specs = LazyEmbed(get_config("qwen3_4b"), LazySyncConfig()).param_specs()
    assert set(r_specs) == set(t_specs) == {"table", "base"}
    for k in r_specs:
        r, t = r_specs[k], t_specs[k]
        assert (t.shape, t.axes, t.init, t.scale) == (r.shape, r.axes, r.init, r.scale)
        assert t.dtype == torch.bfloat16
    assert t_specs["table"].shape == (4, 151_936, 2560)


def test_config_registry_matches_reference():
    from repro.configs import ALIASES as R_ALIASES
    from repro.configs import ARCHS as R_ARCHS

    assert ARCHS == R_ARCHS and ALIASES == R_ALIASES
    for get_t, get_r in ((get_config, r_get_config),
                         (get_smoke_config, r_get_smoke_config)):
        for name in ("qwen3_4b", "qwen3-4b"):
            t, r = get_t(name), get_r(name)
            for f in dataclasses.fields(r):
                if f.name in ("param_dtype", "opt_dtype"):
                    continue
                assert getattr(t, f.name) == getattr(r, f.name), f.name
            assert (t.vocab, t.pattern, t.homogeneous, t.q_per_kv()) == \
                (r.vocab, r.pattern, r.homogeneous, r.q_per_kv())
            assert (t.param_dtype, t.opt_dtype) == (torch.bfloat16, torch.float32)
    t, r = get_config("seamless_m4t_large_v2"), r_get_config("seamless_m4t_large_v2")
    for f in dataclasses.fields(r):
        if f.name not in ("param_dtype", "opt_dtype"):
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    with pytest.raises(KeyError):
        get_config("no-such-arch")
