"""repro_torch.random (threefry-2x32) against jax.random, bit for bit.

``gumbel`` goes through ``log`` twice; XLA's CPU log and torch's log are
not the same approximation (torch's is correctly rounded on ~all inputs,
XLA's on ~86%), so gumbel is held to 2 ULP of max(|x|, 1): measured max
absolute gap 4.8e-7 over 2160 draws (an elementwise ULP count is
meaningless where gumbel crosses zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import qlearn as jq
from repro_torch import random as prng
from repro_torch.core import qlearn as tq

SEEDS = [0, 1, 11, 123456, 4294967295]
SHAPES = [(), (5,), (540,), (540, 4), (3, 7)]


def _jkey(seed):
    return jax.random.PRNGKey(np.uint32(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bitwise(seed):
    jk, tk = _jkey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), prng.key_to_numpy(tk))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)),
                                      prng.key_to_numpy(prng.split(tk, num)))
    for data in (0, 7, 2**31 + 5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)),
            prng.key_to_numpy(prng.fold_in(tk, data)))
    # key_from_numpy round-trips a JAX key's words
    np.testing.assert_array_equal(
        prng.key_to_numpy(prng.key_from_numpy(np.asarray(jk))),
        np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bitwise(seed, shape):
    ju = np.asarray(jax.random.uniform(_jkey(seed), shape))
    tu = prng.uniform(prng.PRNGKey(seed), shape).numpy()
    assert ju.shape == tu.shape and ju.dtype == tu.dtype
    assert ju.tobytes() == tu.tobytes()


def test_batched_keys_bitwise():
    seeds = np.arange(6, dtype=np.uint32) + 5
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    tk = prng.PRNGKey(seeds)
    np.testing.assert_array_equal(np.asarray(jk), prng.key_to_numpy(tk))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jk)),
        prng.key_to_numpy(prng.split(tk, 3)))
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 4)))(jk))
    assert ju.tobytes() == prng.uniform(tk, (9, 4)).numpy().tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(540,), (540, 4)])
def test_gumbel_within_2ulp(seed, shape):
    jg = np.asarray(jax.random.gumbel(_jkey(seed), shape))
    tg = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert np.all(np.abs(jg - tg) <= 2 * ulp)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_select_noise_matches(seed):
    jn = jq.sample_select_noise(_jkey(seed), (540,), 4)
    tn = tq.sample_select_noise(prng.PRNGKey(seed), (540,), 4)
    assert (np.asarray(jn.u_explore).tobytes()
            == tn.u_explore.numpy().tobytes())
    for a, b in ((jn.g_pick, tn.g_pick), (jn.g_tie, tn.g_tie)):
        a = np.asarray(a)
        ulp = np.spacing(np.maximum(np.abs(a), 1.0).astype(np.float32))
        assert np.all(np.abs(a - b.numpy()) <= 2 * ulp)
        # the argmax the episode takes over the noise row agrees
        np.testing.assert_array_equal(a.argmax(-1), b.numpy().argmax(-1))
