"""The port's traffic module against repro's, on the CPU.

``blocked_cumsum`` must equal XLA's jitted CPU cumsum bitwise.  Arrival
tables drawn from the same key must have equal ``row``, ``tenant``,
``burst`` and ``priority``; the arrival clock and the deadlines agree to
2 ULP (measured: 2 ULP at most; the gaps go through ``log1p``, whose XLA
CPU version differs from torch's by one ULP on about a tenth of inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.soc import traffic as jt
from repro_torch import random as prng
from repro_torch.soc import traffic as tt

MAX_ULP = 2

SPECS = [
    dict(rate=1e-4, mix=(0.7, 0.3), deadline=(5000.0, 0.0),
         priority=(1.0, 0.25), backoff=300.0, overload_frac=0.35,
         prio_reserve=0.25, seed=3),
    dict(rate=3e-3, burst_rate=6.0, p_burst=0.1, p_calm=0.3,
         mix=(1.0, 2.0, 0.5), deadline=800.0, seed=11),
]


@pytest.mark.parametrize("n", [1, 7, 16, 17, 255, 256, 1000, 1024, 4096])
def test_blocked_cumsum_equals_xla(n):
    x = np.random.default_rng(n).exponential(1e3, n).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    got = tt.blocked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if n >= 256:   # the order matters: a left-to-right sum differs
        assert not np.array_equal(np.cumsum(x, dtype=np.float32), want)


def test_blocked_cumsum_batched():
    x = np.random.default_rng(5).exponential(1.0, (3, 300)).astype(
        np.float32)
    got = tt.blocked_cumsum(torch.from_numpy(x)).numpy()
    for row in range(3):
        np.testing.assert_array_equal(
            got[row], np.asarray(jax.jit(jnp.cumsum)(x[row])))


def _ulps(a, b):
    a = np.asarray(a, np.float64)
    return np.max(np.abs(a - b) / np.spacing(np.abs(a).astype(np.float32)))


@pytest.mark.parametrize("spec", range(len(SPECS)))
@pytest.mark.parametrize("n,rows,t0", [(1024, 700, 0.0), (96, 37, 5e4)])
def test_sample_arrivals_matches_reference(spec, n, rows, t0):
    kw = SPECS[spec]
    want = jax.jit(lambda s: jt.sample_arrivals(s, n, rows, t0))(
        jt.bursty(**kw))
    got = tt.sample_arrivals(tt.bursty(**kw), n, rows, t0)
    for f in ("row", "tenant", "burst", "priority"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("t_arr", "deadline"):
        assert _ulps(getattr(want, f), getattr(got, f).numpy()) <= MAX_ULP
    assert bool((got.row >= 0).all() and (got.row < rows).all())
    assert bool((torch.diff(got.t_arr) >= 0).all())


def test_spec_constructors_and_chunk_key():
    for kw in SPECS:
        j, t = jt.bursty(**kw), tt.bursty(**kw)
        for f in jt.TrafficSpec._fields:
            np.testing.assert_array_equal(
                prng.key_to_numpy(t.key) if f == "key"
                else getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                err_msg=f)
    j = jt.chunk_key(jt.poisson(1e-3, deadline=(50.0, 0.0), seed=2), 3)
    t = tt.chunk_key(tt.poisson(1e-3, deadline=(50.0, 0.0), seed=2), 3)
    np.testing.assert_array_equal(prng.key_to_numpy(t.key),
                                  np.asarray(j.key))
    np.testing.assert_array_equal(t.mix.numpy(), np.asarray(j.mix))
    assert float(t.burst_rate) == 1.0
