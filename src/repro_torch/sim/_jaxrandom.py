"""Host copy of the reference's ``jax.random`` float32 normal draws, in
numpy: ``key``, ``split``, ``fold_in``, ``normal``, ``randint`` and
``bernoulli`` give the bits that ``jax.random.key(seed)``,
``jax.random.split``, ``jax.random.fold_in``, ``jax.random.normal(key,
shape, "float32")``, ``jax.random.randint(key, shape, lo, hi)`` (int32) and
``jax.random.bernoulli(key, p, shape)`` give on an x86-64 CPU with FMA
(``jax_threefry_partitionable`` on, the default), so a port module can
draw the reference's parameters, frontend embeddings and data without JAX
(``repro_torch.capture.moe_experts._params``,
``repro_torch.models.frontends.synth_embeddings``,
``repro_torch.data.pipeline.host_batch``).

* **Keys and bits.** A key is two uint32 words (``key(s)`` is ``(0, s)``
  for 0 <= s < 2^32).  ``split`` and the random bits are Threefry-2x32
  (:func:`repro_torch.sim._traceref.threefry2x32`) of the counter pair
  (0, i) for the flat index i; a split key is the pair of output words,
  the bits of a draw their XOR.  ``fold_in(k, d)`` is Threefry of (0, d),
  the key ``split`` gives at index d.
* **Integers.** ``randint`` draws two words a value from the two halves of
  a split key and reduces them modulo the span in uint32 arithmetic (the
  high word's remainder times 2^32 mod span, plus the low one's).
* **Uniform.** The top 23 bits as a float in [1, 2), minus 1, scaled to
  [nextafter(-1, 0), 1) and clamped below.
* **Normal.** ``sqrt(2) * erf_inv(u)`` with XLA's single-precision
  ``erf_inv`` (Giles' polynomial in ``w = -log1p(-u^2)``, one set of nine
  coefficients each side of w = 5) and XLA's CPU ``log1p`` (a Cephes
  rational form for |x| < sqrt(2) - 1, else ``log(1 + x)`` through a
  range-reduced polynomial).  The CPU code generator contracts each
  multiply feeding only an add into a fused multiply-add; :func:`_fma`
  computes those roundings exactly (the float64 sum of the exact product,
  rounded to odd, then to float32), and the other steps are plain float32
  operations in XLA's order.  ``numpy.log1p`` rounds differently (1-2 ulp
  on about 1.4 % of the draws).
"""

from __future__ import annotations

import numpy as np

from repro_torch.sim._traceref import threefry2x32

_F = np.float32


def _f(bits: int) -> np.float32:
    """A float32 constant from its bit pattern."""
    return np.array(bits, np.uint32).view(_F)[()]


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once. The product of two float32 is
    exact in float64; the float64 sum is made round-to-odd from its exact
    error (TwoSum), so its rounding to float32 is the correct one."""
    a, b, c = (np.asarray(v, _F).astype(np.float64) for v in (a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        p = a * b
        s = p + c
        bp = s - c
        err = (p - (s - bp)) + (c - bp)
        odd = (s.view(np.uint64) & np.uint64(1)) == 1
        toward = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
        inexact = np.isfinite(err) & (err != 0) & ~odd
        return np.where(inexact, toward, s).astype(_F)


_MIN_NORMAL = _f(0x00800000)
_SQRT_HALF = _f(0x3F3504F3)
# Cephes logf: the three interleaved polynomials and the split ln 2
_LOG_P = ((_f(0x3D9021BB), _f(0xBDEBD1B8), _f(0x3DEF251A)),
          (_f(0xBDFE5D4F), _f(0x3E11E9BF), _f(0xBE2AAE50)),
          (_f(0x3E4CCEAC), _f(0xBE7FFFFC), _f(0x3EAAAAAA)))
_LN2_LO, _LN2_HI = _f(0xB95E8083), _f(0x3F318000)
# Cephes log1p for |x| < sqrt(2) - 1: numerator and denominator
_LOG1P_THRESHOLD = _f(0x3ED413CD)
_LOG1P_DEN = tuple(_f(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                                   0x43586D8A, 0x42707982))
_LOG1P_NUM = tuple(_f(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                                   0x4273CC76, 0x426473AD, 0x41A05101))
# Giles' erf_inv, w < 5 and w >= 5
_ERFINV_LT5 = tuple(_f(b) for b in (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1,
                                    0x396532DB, 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63,
                                    0x3FC02E2F))
_ERFINV_GE5 = tuple(_f(b) for b in (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7,
                                    0x3BBC127B, 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB,
                                    0x40354F7E))
_SQRT2 = _f(0x3FB504F3)


def _log(y: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` on the CPU, for ``log1p``'s large arguments."""
    m_bits = np.maximum(y, _MIN_NORMAL).view(np.uint32)
    e = ((m_bits >> np.uint32(23)).astype(np.int32) - 127).astype(_F) + _F(1)
    m = ((m_bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(_F)
    low = m < _SQRT_HALF
    e = e - np.where(low, _F(1), _F(0))
    x = (m + _F(-1)) + np.where(low, m, _F(0))
    x2 = x * x
    x3 = x2 * x
    pa, pb, pc = (_fma(_fma(x, c0, c1), x, c2) for c0, c1, c2 in _LOG_P)
    poly = _fma(_fma(_fma(pa, x3, pb), x3, pc), x3, e * _LN2_LO)
    r = _fma(e, _LN2_HI, _fma(-x2, _F(0.5), x) + poly)
    bits = np.where((y <= 0) | np.isnan(y), np.uint32(0xFFFFFFFF), r.view(np.uint32))
    bits = np.where(y == 0, np.uint32(0xFF800000), bits)
    bits = np.where(y == np.inf, np.uint32(0x7F800000), bits)
    return bits.view(_F)


def log1p(x) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU, bit for bit."""
    x = np.asarray(x, _F)
    with np.errstate(invalid="ignore", over="ignore"):  # the unused branch
        x2 = x * x
        zero = x * _F(0)
        den = zero + _F(1)
        for c in _LOG1P_DEN:
            den = _fma(den, x, c)
        num = zero + _LOG1P_NUM[0]
        for c in _LOG1P_NUM[1:]:
            num = _fma(num, x, c)
        small = x + _fma(x2, _F(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < _LOG1P_THRESHOLD, small, _log(x + _F(1)))


def erf_inv(u) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on the CPU, bit for bit."""
    u = np.asarray(u, _F)
    lg = log1p(u * -u)
    lt = lg > _F(-5)
    w = np.where(lt, _F(-2.5) - lg, np.sqrt(-lg) + _F(-3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, lo, hi))
    return u * np.where(np.abs(u) == _F(1), _F(np.inf), p)


def key(seed: int) -> tuple[np.uint32, np.uint32]:
    """``jax.random.key(seed)``'s two words, for 0 <= seed < 2^32."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return np.uint32(0), np.uint32(seed)


def _bits2(k, n: int) -> tuple[np.ndarray, np.ndarray]:
    return threefry2x32(k[0], k[1], np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def split(k, num: int = 2) -> list[tuple[np.uint32, np.uint32]]:
    """``jax.random.split(k, num)``."""
    x0, x1 = _bits2(k, num)
    return [(x0[i], x1[i]) for i in range(num)]


def fold_in(k, data: int) -> tuple[np.uint32, np.uint32]:
    """``jax.random.fold_in(k, data)`` for 0 <= data < 2^32."""
    x0, x1 = threefry2x32(k[0], k[1], np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return x0[0], x1[0]


def _bits(k, shape: tuple[int, ...]) -> np.ndarray:
    """The 32 random bits a value of a draw of ``shape`` (flat)."""
    x0, x1 = _bits2(k, int(np.prod(shape, dtype=np.int64)))
    return x0 ^ x1


def _uniform01(k, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(k, shape, "float32")`` in [0, 1), flat."""
    return ((_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F) - _F(1)


def randint(k, shape: tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32)."""
    k1, k2 = split(k)
    hi, lo = _bits(k1, shape), _bits(k2, shape)
    span = np.uint32(maxval - minval if maxval > minval else 1)
    mult = np.uint32(2**16) % span
    with np.errstate(over="ignore"):
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int32(minval) + off.astype(np.int32)).reshape(shape)


def bernoulli(k, p: float, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)``: a float32 uniform below p."""
    return (_uniform01(k, shape) < _F(p)).reshape(shape)


def normal(k, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(k, shape, "float32")``."""
    f = _uniform01(k, shape)
    lo = np.nextafter(_F(-1), _F(0))
    u = np.maximum(lo, _fma(f, _F(2), lo))
    return (erf_inv(u) * _SQRT2).reshape(shape)
