"""The LazySync row merge (B6): the plain PyTorch version of the port's
``lazy_merge`` wrapper against repro's ``lazy_merge_ref`` and its Pallas
kernel in interpret mode, at the shapes and dtypes of
``tests/test_kernel_lazy_merge.py``, plus the wrapper's dispatch rule
(plain version for CPU tensors; kernel or error for CUDA tensors).

Tolerance: the port sums ``rows_g - base`` in float32 from group 0 up,
as the reference's reduction does on these inputs, so the results are
expected to be equal; the check allows 1e-6 relative (f32 rounding of a
different summation order), never more."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lazy_merge.lazy_merge import lazy_merge_pallas
from repro.kernels.lazy_merge.ref import lazy_merge_ref as r_ref
from repro_torch.kernels.lazy_merge import lazy_merge as ops_lazy_merge
from repro_torch.kernels.lazy_merge.ref import lazy_merge_ref as t_ref

LM = importlib.import_module("repro_torch.kernels.lazy_merge.lazy_merge")
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(g, r, d, dtype, seed=0):
    """numpy-seeded (rows, base, valid), as numpy float32 values already
    rounded to ``dtype`` (bf16 via ml_dtypes), for both packages."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(g, r, d)).astype(np.float32)
    base = rng.normal(size=(r, d)).astype(np.float32)
    valid = rng.random(r) < 0.5
    if dtype == "bf16":
        rows = rows.astype(jnp.bfloat16)
        base = base.astype(jnp.bfloat16)
    return rows, base, valid


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("g,r,d", [(2, 64, 64), (4, 128, 128), (8, 200, 96),
                                   (16, 37, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_reference_and_pallas(g, r, d, dtype):
    rows, base, valid = _inputs(g, r, d, dtype)
    want = np.asarray(r_ref(jnp.asarray(rows), jnp.asarray(base), jnp.asarray(valid)))
    pallas = np.asarray(lazy_merge_pallas(jnp.asarray(rows), jnp.asarray(base),
                                          jnp.asarray(valid), interpret=True))
    got = LM.lazy_merge(_torch(rows), _torch(base), torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (r, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=0)
    # invalid rows are the base, exactly
    np.testing.assert_array_equal(got.numpy()[~valid],
                                  base.astype(np.float32)[~valid])
    # the port's own oracle and its dispatch agree with the plain version
    np.testing.assert_allclose(
        t_ref(_torch(rows), _torch(base), torch.from_numpy(valid)).numpy(),
        got.numpy(), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(
        ops_lazy_merge(_torch(rows), _torch(base), torch.from_numpy(valid)).numpy(),
        got.numpy())


@pytest.mark.parametrize("g", [1, 3, 6])
@pytest.mark.parametrize("seed", [0, 7])
def test_linear_update_exactness(g, seed):
    """base + sum of per-group deltas == merge of per-group updated rows."""
    rng = np.random.default_rng(seed)
    r, d = 16, 32
    base = rng.normal(size=(r, d)).astype(np.float32)
    deltas = rng.normal(size=(g, r, d)).astype(np.float32)
    rows = base[None] + deltas
    out = LM.lazy_merge(torch.from_numpy(rows), torch.from_numpy(base),
                        torch.ones(r, dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(), base + deltas.sum(0),
                               rtol=1e-4, atol=1e-4)


def test_none_and_all_valid_and_empty():
    rows, base, _ = _inputs(3, 20, 7, "f32")
    t_rows, t_base = _torch(rows), _torch(base)
    none = LM.lazy_merge(t_rows, t_base, torch.zeros(20, dtype=torch.bool))
    np.testing.assert_array_equal(none.numpy(), base)
    every = LM.lazy_merge(t_rows, t_base, torch.ones(20, dtype=torch.bool))
    np.testing.assert_allclose(every.numpy(), base + (rows - base[None]).sum(0),
                               rtol=1e-6, atol=1e-6)
    assert LM.lazy_merge(t_rows[:, :0], t_base[:0],
                         torch.zeros(0, dtype=torch.bool)).shape == (0, 7)


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
def test_cuda_path_launches_kernel_or_raises_never_plain(monkeypatch, rc, dtype, code):
    """With the tensors treated as CUDA tensors the wrapper goes to its
    kernel: a clean launch counts once, a launch error raises; the plain
    version is never touched."""
    fake = _FakeLib(rc)
    monkeypatch.setattr(LM, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(LM, "_lib", lambda: fake)
    monkeypatch.setattr(LM, "_stream", lambda t: 0)
    monkeypatch.setattr(LM, "lazy_merge_plain", None)  # any use would fail
    LM.reset_launch_counts()
    rows = torch.zeros((4, 5, 9), dtype=dtype)
    args = (rows, torch.zeros((5, 9), dtype=dtype), torch.ones(5, dtype=torch.bool))
    if rc:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            LM.lazy_merge(*args)
    else:
        LM.lazy_merge(*args)
    assert len(fake.calls) == 1
    name, launched = fake.calls[0]
    assert name == "lazy_merge_launch" and launched[4:8] == (4, 5, 9, code)
    assert LM.launch_counts() == {"lazy_merge": 0 if rc else 1}
    LM.reset_launch_counts()


def test_cpu_path_counts_no_launch():
    LM.reset_launch_counts()
    rows, base, valid = _inputs(2, 8, 8, "f32")
    LM.lazy_merge(_torch(rows), _torch(base), torch.from_numpy(valid))
    assert LM.launch_counts() == {"lazy_merge": 0}


def test_wrapper_checks_arguments():
    rows = torch.zeros((2, 4, 8))
    base = torch.zeros((4, 8))
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        LM.lazy_merge(rows, base.to(torch.bfloat16), valid)
    with pytest.raises(TypeError):
        LM.lazy_merge(rows.to(torch.float64), base.to(torch.float64), valid)
    with pytest.raises(TypeError):
        LM.lazy_merge(rows, base, valid.to(torch.int32))
    with pytest.raises(ValueError):
        LM.lazy_merge(rows, base[:3], valid)
    with pytest.raises(ValueError):
        LM.lazy_merge(rows[:, :, ::2], base[:, ::2], valid)  # not contiguous
    with pytest.raises(ValueError):
        LM.lazy_merge(rows, base, valid.to("meta"))
