"""float32 ``log``, ``log1p``, ``exp`` and ``erf_inv`` as XLA's CPU backend
computes them, operation for operation.

XLA lowers ``log`` on the CPU to a Cephes-style polynomial (the argument
split into mantissa and exponent) and ``log1p`` to a Cephes rational
approximation below ``sqrt(2) - 1`` and ``log(1 + x)`` above it; neither
is the correctly rounded logarithm ``torch.log`` gives.  ``exp`` is the
Cephes polynomial on the argument reduced by ``ln 2``.  ``erf_inv`` is
Giles' polynomial in ``w = -log1p(-x * x)``.  Every multiply and add here
rounds on its own, so these equal the reference compiled without fused
multiply-add bit for bit (``tests/test_torch_random.py``,
``tests/test_torch_nn.py``); the CUDA kernel's ``xla_log`` is the same
sequence.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(c) -> float:
    """``c`` rounded to float32 (a Python float, which torch applies in
    float32), as the reference's float32 constants are."""
    return float(np.float32(c))


_LOG_P = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = f32(-2.12194440e-4), f32(0.693359375)
_SQRTHF = f32(0.707106781186547524)
_MIN_NORM = float(np.finfo(np.float32).tiny)
# log1p's rational approximation, highest power first
_L1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_L1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_L1P_SMALL = f32(0.41421356237309504880)
# exp (Cephes): the argument's range, log2(e), and the polynomial of the
# reduced argument, highest power first
_EXP_HI, _EXP_LO = f32(88.3762626647950), f32(-88.3762626647949)
_LOG2E = f32(1.44269504088896341)
_EXP_P = tuple(f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
# erf_inv (Giles): coefficients for w < 5, then for w >= 5
_EI_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_EI_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 natural logarithm (finite positive inputs; zero
    gives -inf, negatives and NaN give NaN, as ``log`` does)."""
    x = x.to(torch.float32)
    t = torch.clamp(x, min=_MIN_NORM)
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = t * p[0] + p[1]
    y1 = t * p[3] + p[4]
    y2 = t * p[6] + p[7]
    y = y * t + p[2]
    y1 = y1 * t + p[5]
    y2 = y2 * t + p[8]
    y = y * x3 + y1
    y = y * x3 + y2
    y = y * x3
    y = y + _LOG_Q1 * e
    t = t - f32(0.5) * x2
    t = t + y
    t = t + _LOG_Q2 * e
    # XLA's CPU code treats subnormal inputs as zero
    t = torch.where((x >= 0.0) & (x < _MIN_NORM), -float("inf"), t)
    t = torch.where(x == float("inf"), float("inf"), t)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), t)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 exponential for inputs in (-87, 87), where the
    result is a normal float32 (XLA's edges of overflow and underflow
    differ); NaN passes through."""
    x = x.to(torch.float32)
    t = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.floor(t * _LOG2E + f32(0.5))
    r = (t - fx * _LOG_Q2) - fx * _LOG_Q1
    z = r * r
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = y * r + c
    y = (y * z + r) + 1.0
    pow2n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(torch.isnan(x), x, y * pow2n)


def _poly(x, coeffs):
    r = torch.zeros_like(x)
    for c in coeffs:
        r = r * x + f32(c)
    return r


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``."""
    x = x.to(torch.float32)
    x2 = x * x
    small = (x * x2) * (_poly(x, _L1P_NUM) / _poly(x, _L1P_DEN))
    small = x + (f32(-0.5) * x2 + small)
    return torch.where(x.abs() < _L1P_SMALL, small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function (``chlo.erf_inv``)."""
    x = x.to(torch.float32)
    w = -log1p(x * -x)
    lt = w < 5.0

    def coeff(i):
        return torch.where(lt, f32(_EI_LT5[i]), f32(_EI_GE5[i]))

    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = coeff(0)
    for i in range(1, 9):
        p = coeff(i) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)
