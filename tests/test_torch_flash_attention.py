"""The port's flash attention (B7) on the CPU: the plain version beside the
CUDA kernel held against ``repro``'s Pallas kernel in interpret mode and
against the chunked-softmax oracle of both packages, over the reference's
sweep (``tests/test_kernel_flash_attention.py``: MHA, GQA, MQA, the ragged
200, float32 and bfloat16, windows 64 / 128 / 256, non-causal), plus a
non-causal ragged key tail that the Pallas kernel refuses and the port
masks.  The wrapper's CUDA branch is driven through fake libraries: it
routes bfloat16 calls with D in {64, 96, 128, 192, 256} to the sm90 kernel
and every other
call to the general one, launches or raises and never runs the plain
version or the other route.

Tolerances: against the Pallas kernel, whose float32 math the plain
version repeats, 1e-5 in float32 and one bfloat16 ulp (2**-7 relative) in
bfloat16, where only the sums' order differs before the output is rounded;
against ``mha_chunked``, which rounds the probabilities to bfloat16 before
the PV product, the reference's own 2e-3 (float32) and 2e-2 (bfloat16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as r_ref
from repro.models.attention import mha_chunked as r_mha_chunked
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import mha_chunked
from repro_torch.models.common import tensor_from_numpy

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
REF_TOL = {"f32": 2e-3, "bf16": 2e-2}
PALLAS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2.0**-7, atol=1e-6)}
# Port mha_chunked against the reference's: in bfloat16 the probabilities
# are rounded to bfloat16 from float32 exponentials that may differ in their
# last bit, which moves a probability by one bfloat16 ulp (2**-8 relative)
# and an output by up to about that much of |v|.
CHUNKED_TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2.0**-7, atol=2e-3)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk(b, sq, sk, hq, hkv, d, dt, seed=0):
    """The same q, k, v in both packages: numpy normals, rounded by jnp to
    the dtype, carried to torch bit for bit."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(DTYPES[dt][0])
          for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    return jx, [tensor_from_numpy(np.asarray(a), "cpu") for a in jx]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _check(dt, shape, causal=True, window=0, pallas=True):
    (jq, jk, jv), (q, k, v) = _mk(*shape, dt)
    got = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == DTYPES[dt][1] and got.shape == q.shape
    if pallas:
        want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                      interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), **PALLAS_TOL[dt])
    tol = REF_TOL[dt]
    np.testing.assert_allclose(_np(got), _np(r_ref(jq, jk, jv, causal=causal, window=window)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(flash_attention_ref(q, k, v, causal=causal, window=window)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [
    (1, 128, 128, 4, 4, 64),     # MHA, single tile
    (2, 256, 256, 4, 2, 64),     # GQA 2:1
    (1, 384, 384, 8, 1, 32),     # MQA, non-square-tile seq
    (1, 200, 200, 4, 2, 64),     # ragged (padding path)
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_and_ref_causal(shape, dt):
    _check(dt, shape)


@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sliding_window(window, dt):
    _check(dt, (1, 256, 256, 4, 2, 64), window=window)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_noncausal(dt):
    _check(dt, (1, 128, 256, 4, 4, 64), causal=False)


@pytest.mark.parametrize("sk", [1, 200, 333])
def test_noncausal_ragged_tail_is_masked(sk):
    """Sk not a multiple of 128 without a causal mask: the Pallas kernel
    asserts, the port masks keys at or past Sk (the oracle's behaviour)."""
    _check("f32", (2, 96, sk, 4, 2, 32), causal=False, pallas=False)
    with pytest.raises(AssertionError):
        _check("f32", (1, 8, sk, 2, 1, 32), causal=False)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=48, kv_chunk=64),
    dict(causal=False, kv_chunk=100),
    dict(causal=True, q_offset=37, kv_chunk=4096, kv_valid_len=38),
], ids=["causal", "window", "noncausal-chunk100", "decode"])
def test_mha_chunked_matches_reference(dt, kw):
    """The port's ``mha_chunked`` (the oracle and the decode attention)
    repeats the reference's math, bfloat16 rounding of P included."""
    sq = 1 if "q_offset" in kw else 160
    (jq, jk, jv), (q, k, v) = _mk(2, sq, 160, 4, 2, 32, dt, seed=3)
    got = mha_chunked(q, k, v, **kw)
    want = r_mha_chunked(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **CHUNKED_TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mha_chunked_ring_positions_match_reference(dt):
    """Ring-buffer decode: per-slot absolute positions, -1 for empty slots."""
    (jq, jk, jv), (q, k, v) = _mk(1, 1, 64, 4, 1, 32, dt, seed=4)
    pos = np.full((64,), -1, np.int32)
    pos[:40] = np.arange(60, 100)
    kw = dict(causal=True, window=32, q_offset=99, kv_chunk=4096)
    got = mha_chunked(q, k, v, k_positions=torch.from_numpy(pos), **kw)
    want = r_mha_chunked(jq, jk, jv, k_positions=jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **CHUNKED_TOL[dt])


def test_fully_masked_rows_are_zero():
    """A query row with no key (Sq > Sk under a narrow window) outputs 0."""
    _, (q, k, v) = _mk(1, 40, 8, 2, 1, 16, "f32")
    out = FA.flash_attention_plain(q, k, v, causal=True, window=4)
    assert torch.equal(out[:, 12:], torch.zeros_like(out[:, 12:]))
    assert bool((out[:, :8] != 0).any())


def test_ops_mha_on_cpu_is_the_plain_version():
    reset_launch_counts()
    _, (q, k, v) = _mk(1, 70, 70, 4, 2, 16, "bf16")
    assert torch.equal(ops.mha(q, k, v, causal=True, window=32),
                       FA.flash_attention_plain(q, k, v, causal=True, window=32))
    # non-contiguous inputs are made contiguous by ops.mha
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(ops.mha(qt, k, v), FA.flash_attention_plain(q, k, v))
    assert launch_counts()["flash_attention"] == 0


class _FakeLib:
    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.rc
        return launch


@pytest.mark.parametrize("rc", [0, 700])
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_cuda_path_launches_kernel_or_raises_never_plain(monkeypatch, rc, dtype, code,
                                                         causal, window):
    """With the tensors treated as CUDA tensors the wrapper goes to its
    kernel: a clean launch counts once, a launch error raises; the plain
    version is never touched."""
    fake = _FakeLib(rc)
    monkeypatch.setattr(FA, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(FA, "_lib", lambda: fake)
    monkeypatch.setattr(FA, "_lib_sm90", lambda: fake)
    monkeypatch.setattr(FA, "_stream", lambda t: 0)
    monkeypatch.setattr(FA, "flash_attention_plain", None)  # any use would fail
    FA.reset_launch_counts()
    q = torch.zeros((2, 130, 8, 64), dtype=dtype)
    k = torch.zeros((2, 200, 2, 64), dtype=dtype)
    if rc:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            FA.flash_attention(q, k, k.clone(), causal=causal, window=window)
    else:
        out = FA.flash_attention(q, k, k.clone(), causal=causal, window=window)
        assert out.shape == q.shape and out.dtype == dtype
    assert len(fake.calls) == 1
    name, launched = fake.calls[0]
    assert name == ("flash_attention_sm90_launch" if dtype == torch.bfloat16
                    else "flash_attention_launch")  # bf16 at D = 64 takes the sm90 route
    assert launched[4:10] == (2, 130, 200, 8, 2, 64)
    assert launched[10].value == pytest.approx(64 ** -0.5)
    assert launched[11:14] == (int(causal), window, code)
    assert FA.launch_counts() == {"flash_attention": 0 if rc else 1}
    FA.reset_launch_counts()


@pytest.mark.parametrize("d,dtype", [(24, torch.bfloat16), (336, torch.bfloat16),
                                     (224, torch.float32)])
def test_cuda_path_refuses_head_dims_the_kernel_cannot_tile(monkeypatch, d, dtype):
    """A head dim the kernel cannot tile (not a multiple of 16, or tiles
    past a block's shared memory) is refused by the CUDA launcher itself
    (``cudaErrorInvalidValue``, 1; the limits are tested on the card): the
    wrapper passes the head dim through, raises on the refusal, counts no
    launch and never runs the plain version instead."""
    fake = _FakeLib(1)
    monkeypatch.setattr(FA, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(FA, "_lib", lambda: fake)
    monkeypatch.setattr(FA, "_stream", lambda t: 0)
    plain = FA.flash_attention_plain
    monkeypatch.setattr(FA, "flash_attention_plain", None)  # any use would fail
    FA.reset_launch_counts()
    q = torch.zeros((1, 4, 2, d), dtype=dtype)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        FA.flash_attention(q, q.clone(), q.clone())
    assert [args[9] for _, args in fake.calls] == [d]
    assert FA.launch_counts() == {"flash_attention": 0}
    # the plain version takes any head dim
    assert plain(q, q.clone(), q.clone()).shape == q.shape


ROUTE_DIMS = (16, 64, 96, 128, 192, 256, 320)
SM90_DIMS = (64, 96, 128, 192, 256)  # the zoo's published head dims


def _fake_routes(monkeypatch, rc=0):
    """A fake library per route; the plain version made unusable."""
    fakes = {"general": _FakeLib(rc), "sm90": _FakeLib(rc)}
    monkeypatch.setattr(FA, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(FA, "_lib", lambda: fakes["general"])
    monkeypatch.setattr(FA, "_lib_sm90", lambda: fakes["sm90"])
    monkeypatch.setattr(FA, "_stream", lambda t: 0)
    monkeypatch.setattr(FA, "flash_attention_plain", None)  # any use would fail
    FA.reset_launch_counts()
    return fakes


@pytest.mark.parametrize("d", ROUTE_DIMS)
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_route_by_dtype_and_head_dim(monkeypatch, d, dtype, code):
    """bf16 with D in SM90_HEAD_DIMS launches the sm90 entry point, every
    other call (float32, bf16 at D = 16 or 320) the general one, with
    today's arguments; each launch counts once in ``launch_counts`` and once
    under its route."""
    fakes = _fake_routes(monkeypatch)
    assert FA.SM90_HEAD_DIMS == frozenset(SM90_DIMS)
    want = "sm90" if dtype == torch.bfloat16 and d in SM90_DIMS else "general"
    assert FA._route_for(dtype, d) == want
    q = torch.zeros((2, 130, 8, d), dtype=dtype)
    k = torch.zeros((2, 200, 2, d), dtype=dtype)
    out = FA.flash_attention(q, k, k.clone(), causal=True, window=48)
    assert out.shape == q.shape and out.dtype == dtype
    other = "general" if want == "sm90" else "sm90"
    assert fakes[other].calls == []
    [(name, args)] = fakes[want].calls
    assert name == {"general": "flash_attention_launch",
                    "sm90": "flash_attention_sm90_launch"}[want]
    assert args[3] == out.data_ptr()
    assert args[4:10] == (2, 130, 200, 8, 2, d)
    assert args[10].value == pytest.approx(d ** -0.5)
    assert args[11:14] == (1, 48, code)
    assert FA.route_counts() == {"general": int(want == "general"), "sm90": int(want == "sm90")}
    assert sum(FA.route_counts().values()) == FA.launch_counts()["flash_attention"] == 1
    FA.reset_launch_counts()


@pytest.mark.parametrize("route,dtype,d", [("general", torch.float32, 128),
                                           ("general", torch.bfloat16, 16),
                                           ("sm90", torch.bfloat16, 128),
                                           ("sm90", torch.bfloat16, 96)])
def test_refused_launch_raises_and_counts_nothing(monkeypatch, route, dtype, d):
    """A launch error on either route raises; nothing is counted and the
    other route (and the plain version) is never tried instead."""
    fakes = _fake_routes(monkeypatch, rc=700)
    q = torch.zeros((1, 64, 4, d), dtype=dtype)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        FA.flash_attention(q, q.clone(), q.clone())
    assert len(fakes[route].calls) == 1
    assert fakes["sm90" if route == "general" else "general"].calls == []
    assert FA.launch_counts() == {"flash_attention": 0}
    assert FA.route_counts() == {"general": 0, "sm90": 0}


def test_route_counts_add_up_over_mixed_calls(monkeypatch):
    fakes = _fake_routes(monkeypatch)
    for dtype, d in [(torch.bfloat16, 128), (torch.float32, 128), (torch.bfloat16, 64),
                     (torch.bfloat16, 16), (torch.bfloat16, 128)]:
        q = torch.zeros((1, 8, 2, d), dtype=dtype)
        FA.flash_attention(q, q.clone(), q.clone())
    assert FA.route_counts() == {"general": 2, "sm90": 3}
    assert FA.launch_counts() == {"flash_attention": 5}
    assert (len(fakes["general"].calls), len(fakes["sm90"].calls)) == (2, 3)
    # an empty batch launches nothing on either route
    FA.flash_attention(*[torch.zeros((0, 8, 2, 128), dtype=torch.bfloat16)] * 3)
    assert FA.route_counts() == {"general": 2, "sm90": 3}
    FA.reset_launch_counts()
    assert FA.route_counts() == {"general": 0, "sm90": 0}


def test_forced_route(monkeypatch):
    """The private ``_flash_attention(route=...)`` forces the general kernel
    on a call the sm90 one covers; the sm90 route refuses what it does not
    cover, before any launch.  The public wrapper takes no route."""
    fakes = _fake_routes(monkeypatch)
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    FA._flash_attention(q, q.clone(), q.clone(), route="general")
    assert [n for n, _ in fakes["general"].calls] == ["flash_attention_launch"]
    for dtype, d in [(torch.float32, 128), (torch.bfloat16, 16), (torch.bfloat16, 320)]:
        x = torch.zeros((1, 8, 2, d), dtype=dtype)
        with pytest.raises(ValueError, match="sm90 route"):
            FA._flash_attention(x, x.clone(), x.clone(), route="sm90")
    with pytest.raises(ValueError, match="route"):
        FA._flash_attention(q, q.clone(), q.clone(), route="fast")
    with pytest.raises(TypeError, match="route"):
        FA.flash_attention(q, q.clone(), q.clone(), route="general")
    assert fakes["sm90"].calls == []
    assert FA.route_counts() == {"general": 1, "sm90": 0}
    FA.reset_launch_counts()


def test_cpu_path_counts_no_launch():
    FA.reset_launch_counts()
    _, (q, k, v) = _mk(1, 16, 16, 2, 1, 16, "f32")
    FA.flash_attention(q, k, v)
    assert FA.launch_counts() == {"flash_attention": 0}


def test_wrapper_checks_arguments():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.to(torch.bfloat16), k.to(torch.bfloat16))
    with pytest.raises(TypeError):
        FA.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="4 dims"):
        FA.flash_attention(q[0], k, k)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, k[:, :4])
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(torch.zeros((1, 8, 3, 16)), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, k, window=-1)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, k.to("meta"))
    jax.clear_caches()
