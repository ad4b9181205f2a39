"""Fuzz, on the port: malformed study specs always fail with a naming
ValueError and never reach the engine (no trace synthesis, no dispatch),
mirroring ``tests/test_study_fuzz.py`` with the same menu and the same
``hypothesis`` / ``_fallback_hypothesis`` guard.  Held to ``repro``: the
port's ``build_study`` refuses exactly the specs the reference refuses, and
plans the same lane count for the ones both take."""

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _fallback_hypothesis import given, settings, st

from repro.serve.chaos import ChaosConfig as RChaosConfig
from repro.serve.chaos import ChaosMonkey as RChaosMonkey
from repro.serve.request import build_study as r_build_study
from repro_torch.serve.request import build_study as t_build_study
from repro_torch.sim import engine as _engine

CPU = "cpu"


def build_study(spec):
    return t_build_study(spec, CPU)

GOOD = {
    "workloads": ["pagerank-arxiv",
                  {"app": "htap128", "scale": 0.004, "num_kernels": 3}],
    "mechanisms": ["cpu", "cg", "lazypim"],
    "threads": 16,
    "hw_grid": {"offchip_bw_gbs": [16.0, 32.0]},
}


def _corrupt(spec: dict, which: int, salt: int) -> object:
    """Deterministic malformed-spec menu; ``salt`` varies the payload."""
    bad = {k: (list(v) if isinstance(v, list) else
               dict(v) if isinstance(v, dict) else v)
           for k, v in spec.items()}
    which %= 12
    if which == 0:      # unknown workload name
        bad["workloads"].append(f"bogus-app-{salt}")
    elif which == 1:    # unknown mechanism
        bad["mechanisms"].append(f"warp{salt}")
    elif which == 2:    # workload dict without 'app'
        bad["workloads"].append({"graph": "arxiv"})
    elif which == 3:    # non-string app
        bad["workloads"].append({"app": salt})
    elif which == 4:    # non-JSON-able per-entry signature spec
        bad["workloads"].append({"app": "htap128", "spec": {"sig_bits": 64}})
    elif which == 5:    # wrong-typed threads
        bad["threads"] = "sixteen"
    elif which == 6:    # unknown top-level key
        bad[f"shards_{salt}"] = 4
    elif which == 7:    # no workloads at all
        del bad["workloads"]
    elif which == 8:    # empty workload axis
        bad["workloads"] = []
    elif which == 9:    # unknown HWParams field in the grid
        bad["hw_grid"] = {f"warp_speed_{salt}": [1, 2]}
    elif which == 10:   # empty hw grid
        bad["hw_grid"] = {}
    else:               # spec is not a dict at all
        return salt
    return bad


@pytest.fixture
def engine_tripwire(monkeypatch):
    """Any dispatch or trace synthesis during admission is a test failure."""
    def boom(*a, **k):
        raise AssertionError("malformed spec reached the engine")
    monkeypatch.setattr(_engine, "_sweep_accs", boom)
    monkeypatch.setattr(_engine, "run_mechanism", boom)
    monkeypatch.setattr(_engine, "run_all", boom)
    monkeypatch.setattr("repro_torch.sim.study.make_trace", boom)


def test_malformed_specs_raise_naming_value_error(engine_tripwire):
    @settings(max_examples=60)
    @given(st.integers(min_value=0, max_value=2**31 - 1),
           st.integers(min_value=0, max_value=999))
    def prop(which, salt):
        bad = _corrupt(GOOD, which, salt)
        with pytest.raises(ValueError) as exc:
            build_study(bad)
        # The error must *name* the offense, not just refuse: a client can
        # act on it without reading server code.
        assert len(str(exc.value)) > 10

    prop()


def test_every_menu_entry_is_actually_malformed(engine_tripwire):
    for which in range(12):
        with pytest.raises(ValueError):
            build_study(_corrupt(GOOD, which, salt=7))


def test_good_spec_builds_without_touching_engine(engine_tripwire):
    study = build_study(GOOD)
    # Admission-side planning (lane count) must also stay synthesis-free.
    assert study.num_points == 2 * 2 * 1


def test_chaos_admission_corruptions_are_rejected(engine_tripwire):
    """The chaos monkey's own admission-class corruptions trip the same
    validation wall (malformed -> ValueError; oversized -> lane bound)."""
    from repro_torch.serve.chaos import ChaosConfig, ChaosMonkey

    monkey = ChaosMonkey(ChaosConfig(seed=11, fault_rate=1.0,
                                     classes=("malformed_spec",)))
    for rid in range(20):
        with pytest.raises(ValueError):
            build_study(monkey.corrupt_spec(rid, GOOD))

    monkey = ChaosMonkey(ChaosConfig(seed=11, fault_rate=1.0,
                                     classes=("oversized",)))
    study = build_study(monkey.corrupt_spec(0, GOOD))
    assert study.num_points > 4096  # admission bound catches it pre-synthesis


def _refuses(build, spec):
    try:
        build(spec)
    except ValueError:
        return True
    return False


def test_refuses_exactly_what_the_reference_refuses(engine_tripwire):
    """Every menu entry at a spread of salts, the chaos monkey's admission
    corruptions and the good spec: refused by both packages or by neither;
    where both build, the same lane count."""
    specs = [_corrupt(GOOD, which, salt) for which in range(12) for salt in (0, 7, 999)]
    for seed in (0, 11):
        for kind in ("malformed_spec", "oversized"):
            t = RChaosMonkey(RChaosConfig(seed=seed, fault_rate=1.0, classes=(kind,)))
            specs += [t.corrupt_spec(rid, GOOD) for rid in range(8)]
    specs.append(GOOD)
    for spec in specs:
        refused = _refuses(r_build_study, spec)
        assert _refuses(build_study, spec) == refused, spec
        if not refused:
            assert build_study(spec).num_points == r_build_study(spec).num_points
