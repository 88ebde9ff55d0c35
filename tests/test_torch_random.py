"""repro_torch.random (threefry-2x32) against jax.random, bit for bit;
``normal`` and ``repro_torch.xla_math`` bitwise against the reference
compiled without fused multiply-add.

``gumbel`` goes through ``log`` twice, each as XLA computes it on the CPU
(``repro_torch.xla_math.log``): bitwise the reference compiled without
fused multiply-add, and within 2 ULP of max(|x|, 1) of the FMA build,
whose log polynomial is contracted (an elementwise ULP count is
meaningless where gumbel crosses zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


GUMBEL_SHAPES = [(540,), (540, 4)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", GUMBEL_SHAPES)
def test_gumbel_within_2ulp(seed, shape, nofma_normals):
    """Bitwise the no-FMA reference; within 2 ULP of the FMA build."""
    tg = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    assert tg.tobytes() == nofma_normals[f"gumbel/{seed}/{shape}"].tobytes()
    jg = np.asarray(jax.random.gumbel(_jkey(seed), shape))
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


# ------------------------------------------------------------------ normal
NORMAL_SHAPES = [(14, 16), (16, 16), (1000,)]


def reference_normals() -> dict:
    """``jax.random.normal``, ``jax.random.gumbel`` and XLA's ``log``/
    ``log1p``/``erf_inv`` on fixed inputs, as numpy (computed without FMA by the test below)."""
    out = {}
    for seed in SEEDS:
        for shape in NORMAL_SHAPES:
            out[f"normal/{seed}/{shape}"] = np.asarray(
                jax.random.normal(_jkey(seed), shape))
        for shape in GUMBEL_SHAPES:
            out[f"gumbel/{seed}/{shape}"] = np.asarray(
                jax.random.gumbel(_jkey(seed), shape))
    x = _math_inputs()
    out["log"] = np.asarray(jax.jit(jnp.log)(x))
    out["log1p"] = np.asarray(jax.jit(jnp.log1p)(x - 1.0))
    out["erf_inv"] = np.asarray(jax.jit(jax.lax.erf_inv)(
        np.clip(x - 1.0, -0.9999, 0.9999)))
    return out


def _math_inputs():
    rng = np.random.default_rng(5)
    return np.concatenate([
        rng.uniform(0.0, 2.0, 20000), np.exp(rng.uniform(-80, 80, 2000)),
        [0.0, 1.0, 2.0, np.inf, 1e-40]]).astype(np.float32)


@pytest.fixture(scope="module")
def nofma_normals(tmp_path_factory):
    from test_torch_serve import reference_without_fma
    return reference_without_fma("test_torch_random", "reference_normals",
                                 tmp_path_factory.mktemp("nofma"))[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_reference(seed, nofma_normals):
    """``normal`` is bitwise the reference compiled without fused
    multiply-add; against the FMA build (whose erf_inv polynomial and log
    are contracted) within 2 ULP of max(|x|, 1): measured max absolute
    gap 4.8e-7 over 103,380 draws."""
    for shape in NORMAL_SHAPES:
        got = prng.normal(prng.PRNGKey(seed), shape).numpy()
        assert got.tobytes() == nofma_normals[
            f"normal/{seed}/{shape}"].tobytes()
        want = np.asarray(jax.random.normal(_jkey(seed), shape))
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert np.all(np.abs(want - got) <= 2 * ulp)


def test_xla_math_bitwise_without_fma(nofma_normals):
    """XLA's CPU log (Cephes, subnormals as zero), log1p and erf_inv, op
    for op: bitwise the no-FMA build on 22,005 inputs, edge cases
    included."""
    from repro_torch import xla_math
    x = torch.from_numpy(_math_inputs())
    for name, fn, arg in (
            ("log", xla_math.log, x), ("log1p", xla_math.log1p, x - 1.0),
            ("erf_inv", xla_math.erf_inv,
             torch.clamp(x - 1.0, -0.9999, 0.9999))):
        got = fn(arg).numpy()
        np.testing.assert_array_equal(got, nofma_normals[name],
                                      err_msg=name)
