"""The port's token-serving loop (repro_torch.launch.serve) held against
repro.launch.serve on the CPU: with the float32 smoke config and the very
weights the reference's loop draws from ``jax.random.key(0)`` (carried
across by ``params_from_jax``), both serve the same requests in the same
order with the same token lists — teacher-forced prompt steps, greedy
tokens, slot refills at the shared cache position and the max-len cut
included.  Float32 keeps the argmax of the two packages' logits (equal to
~1e-6) apart from ties.  Also the request draw, the CLI, and the
``ValueError``/``RuntimeError`` of what the port does not do."""

from __future__ import annotations

import argparse
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as RS
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models.model import Model as RModel
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as S
from repro_torch.models.model import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _args(arch="qwen3-4b", **kw):
    base = dict(arch=arch, smoke=True, requests=8, batch=4, max_new=16, max_len=64,
                seed=0, study=None, device="cpu")
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-4b", {}),                                    # the loop's defaults
    ("qwen3-4b", dict(requests=5, batch=2, max_new=6, max_len=24, seed=3)),
    ("nemotron-4-340b", dict(requests=6, batch=3, max_new=8, max_len=40, seed=1)),
], ids=["defaults", "small-batch", "nemotron-untied"])
def test_serve_matches_reference_token_for_token(monkeypatch, arch, kw):
    r_cfg = dataclasses.replace(r_get_smoke_config(arch), param_dtype=jnp.float32)
    monkeypatch.setattr(RS, "get_smoke_config", lambda name: r_cfg)
    want = RS.serve(_args(arch, **kw))
    r_params = RModel(r_cfg).init(jax.random.key(0))  # what RS.serve draws
    t_cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=torch.float32)
    monkeypatch.setattr(S, "get_smoke_config", lambda name: t_cfg)
    got = S.serve(_args(arch, **kw),
                  params=params_from_jax(jax.tree.map(np.asarray, r_params), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.prompt, g.max_new, g.done) == (w.rid, w.prompt, w.max_new, w.done)
        assert g.out == w.out, f"request {g.rid}"


@pytest.mark.parametrize("seed", [0, 7])
def test_make_requests_matches_reference(seed):
    cfg, r_cfg = get_smoke_config("qwen3_4b"), r_get_smoke_config("qwen3_4b")
    got = S.make_requests(cfg, 9, seed, max_new=5)
    want = RS.make_requests(r_cfg, 9, seed, max_new=5)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]


def test_serve_defaults_and_own_init():
    """With its own seeded init (bfloat16 smoke config) the loop serves
    every request, each with its prompt's teacher-forced steps plus up to
    ``max_new`` tokens in the vocabulary, deterministically."""
    a = S.serve(_args())
    b = S.serve(_args())
    assert len(a) == 8 and sorted(r.rid for r in a) == list(range(8))
    assert [r.out for r in a] == [r.out for r in b]
    vocab = get_smoke_config("qwen3_4b").vocab_size
    for r in a:
        assert r.done and len(r.prompt) < len(r.out) <= len(r.prompt) + 16
        assert all(0 <= t < vocab for t in r.out)


def test_cli_main(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--requests", "3", "--batch", "2",
                                      "--max-new", "4", "--max-len", "32", "--device", "cpu"])
    S.main()
    assert "served 3 requests" in capsys.readouterr().out


def test_study_and_missing_card_raise():
    with pytest.raises(ValueError, match="serve slice.*A10"):
        S.serve(_args(study="specs.json"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            S.serve(_args(device=None))


@pytest.mark.parametrize("flag,value", [
    ("cache_dir", "journal"), ("deadline_s", 10.0), ("max_queue", 8),
    ("chaos_rate", 0.1), ("coalesce", True), ("adaptive", True)])
def test_study_only_options_raise_when_set(flag, value):
    """The study service's options are parsed for flag parity but modify
    nothing here: set away from their defaults they raise, naming the
    flag; at their defaults (as main() parses them) the loop runs."""
    with pytest.raises(ValueError, match=f"--{flag.replace('_', '-')}: .*serve slice"):
        S.serve(_args(**{flag: value}))
    S.serve(_args(requests=1, batch=1, max_new=1, max_len=8, **{flag: S.STUDY_OPTIONS[flag]}))
