"""The port's token-serving loop (repro_torch.launch.serve) held against
repro.launch.serve on the CPU: with the float32 smoke config and the very
weights the reference's loop draws from ``jax.random.key(0)`` (carried
across by ``params_from_jax``), both serve the same requests in the same
order with the same token lists — teacher-forced prompt steps, greedy
tokens, slot refills at the shared cache position and the max-len cut
included.  Float32 keeps the argmax of the two packages' logits (equal to
~1e-6) apart from ties.  Also the request draw, the CLI, the
``RuntimeError`` without a card, and the study service's front door
(``--study``): a spec file answered, the reference's per-request lines and
totals, and each study option reaching the server's config."""

from __future__ import annotations

import argparse
import dataclasses
import json
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


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.serve(_args(device=None))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.serve_study(_args(device=None, **STUDY_DEFAULTS, study=_spec_file()))


SMALL = dict(num_kernels=3, windows_per_kernel=2)
SPECS = [{"workloads": [{"app": "pagerank", "graph": "arxiv", "scale": 0.4, **SMALL}],
          "mechanisms": ["cpu", "lazypim"], "threads": 16},
         {"workloads": [{"app": "htap128", "scale": 0.004, **SMALL}],
          "mechanisms": ["cpu", "lazypim"], "threads": 16,
          "hw_grid": {"offchip_bw_gbs": [16.0, 32.0]}}]
# the study service's options, at main()'s defaults
STUDY_DEFAULTS = dict(cache_dir=None, deadline_s=300.0, max_queue=64, chaos_rate=0.0,
                      coalesce=False, adaptive=False)


def _spec_file(tmp_path=None):
    import pathlib
    import tempfile

    path = pathlib.Path(tmp_path or tempfile.mkdtemp()) / "specs.json"
    path.write_text(json.dumps(SPECS))
    return str(path)


def test_main_study_answers_a_spec_file(tmp_path, monkeypatch, capsys):
    """``--study`` serves the file's specs on the CPU with ``--device cpu``:
    one line a request, the totals, and the JSON line of the warm replay and
    the builds and binds; a second launch on the same ``--cache-dir`` warms
    from the first one's manifest."""
    argv = ["serve", "--study", _spec_file(tmp_path), "--device", "cpu",
            "--cache-dir", str(tmp_path / "cache"), "--coalesce"]
    monkeypatch.setattr(sys, "argv", argv)
    S.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("req 0: ok engine=coalesced attempts=1 ")
    assert out[1].startswith("req 1: ok engine=coalesced attempts=1 ")
    assert out[2] == "served 2 requests: {'ok': 2}"
    first = json.loads(out[-1])["serve_study"]
    assert first["device"] == "cpu" and first["warmed_entries"] == 0
    S.main()
    second = json.loads(capsys.readouterr().out.splitlines()[-1])["serve_study"]
    assert second["statuses"] == {"ok": 2} and second["warmed_entries"] == 4


def test_serve_study_lines_match_reference(tmp_path, capsys):
    """The per-request lines (latency aside) and the totals equal the
    reference's ``serve_study`` on the same file, coalesced and not."""
    import re

    for coalesce in (False, True):
        kw = dict(STUDY_DEFAULTS, study=_spec_file(tmp_path), coalesce=coalesce)
        want = [r.status for r in RS.serve_study(_args(**kw))]
        ref = capsys.readouterr().out.splitlines()
        got = [r.status for r in S.serve_study(_args(**kw))]
        out = capsys.readouterr().out.splitlines()
        assert got == want == ["ok", "ok"]
        strip = [re.sub(r" \d+ ms", "", line) for line in ref]
        assert [re.sub(r" \d+ ms", "", line) for line in out[:len(ref)]] == strip


@pytest.mark.parametrize("flag,value,field", [
    ("cache_dir", "journal", "cache_dir"), ("deadline_s", 10.0, "default_deadline_s"),
    ("max_queue", 8, "max_queue"), ("chaos_rate", 0.1, "fault_rate"),
    ("coalesce", True, "coalesce"), ("adaptive", True, "adaptive")])
def test_study_option_reaches_the_server(monkeypatch, tmp_path, flag, value, field):
    """Each study-service option set away from its default reaches the
    ``ServeConfig`` that ``serve_study`` builds (``--chaos-rate`` the chaos
    monkey's config; ``--adaptive`` implies coalescing), with the device."""
    import repro_torch.serve as SV

    seen = []

    class Capture(SV.StudyServer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            seen.append(self)

    monkeypatch.setattr(SV, "StudyServer", Capture)
    if flag == "cache_dir":
        value = str(tmp_path / value)
    kw = dict(STUDY_DEFAULTS, study=_spec_file(tmp_path), **{flag: value})
    S.serve_study(_args(**kw))
    cfg = seen[0].cfg
    assert cfg.device == "cpu"
    got = seen[0].chaos.cfg.fault_rate if flag == "chaos_rate" else getattr(cfg, field)
    assert got == value
    if flag == "adaptive":
        assert cfg.coalesce
