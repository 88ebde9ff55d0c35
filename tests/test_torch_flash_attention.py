"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's: the plain version (the kernel's oracle and CPU
path) against ``repro.kernels.flash_attention.ref.attention_ref`` on every
shape x feature x dtype of ``tests/test_kernels.py``, some of them also
against the Pallas kernel in interpret mode, the decode shapes (one query
row against 1, 37 and 129 keys), and the cache-slice attention the
models' decode takes against the reference's masked full-cache
``attention_scores``.

Tolerances are the reference's own: rtol = atol = 2e-5 in float32 and
2e-2 in bfloat16.  The CUDA kernel's own test against the plain version
needs the card and no JAX, so it lives in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import attention as j_attn
from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as t_attn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [
    # (B, H, Hkv, Sq, Skv, hd), as tests/test_kernels.py
    (1, 4, 4, 128, 128, 64),     # MHA
    (2, 8, 2, 128, 128, 64),     # GQA 4:1
    (1, 4, 1, 256, 256, 128),    # MQA
    (1, 2, 2, 128, 384, 64),     # cross-length (prefill-with-prefix)
]
FEATS = [dict(causal=True), dict(causal=True, window=64),
         dict(causal=True, softcap=50.0), dict(causal=False)]
DECODE = [(2, 8, 2, 1, skv, 64) for skv in (1, 37, 129)]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(shape, dtype, seed=0):
    """(q, k, v) in the models' (B, S, H, hd) layout, for JAX and torch."""
    b, h, hkv, sq, skv, hd = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, sq, h, hd)), rng.normal(size=(b, skv, hkv, hd)),
            rng.normal(size=(b, skv, hkv, hd))]
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) for a in arrs]
    # the same rounded values on both sides
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _ref_both(shape, dtype, feat):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype)
    want = j_ref(*(jnp.swapaxes(x, 1, 2) for x in (jq, jk, jv)), **feat)
    got = attention_ref(*(x.transpose(1, 2) for x in (tq, tk, tv)), **feat)
    return got, want


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + DECODE)
@pytest.mark.parametrize("feat", FEATS)
def test_ref_matches_reference_ref(shape, dtype, feat):
    got, want = _ref_both(shape, dtype, feat)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,feat", [
    (SHAPES[1], FEATS[0]), (SHAPES[0], FEATS[1]), (SHAPES[3], FEATS[2]),
    (SHAPES[1], FEATS[3])])
def test_ops_matches_pallas_interpret(shape, dtype, feat):
    """``ops.flash_attention`` on CPU tensors (the plain version, models'
    layout) against the Pallas kernel run in interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype)
    want = j_flash(jq, jk, jv, block_q=64, block_kv=64, interpret=True,
                   **feat)
    before = ops.launches
    got = ops.flash_attention(tq, tk, tv, **feat)
    assert ops.launches == before   # the CPU path launches nothing
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("skv", [1, 37, 129])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cache_slice_equals_masked_full_cache(skv, dtype):
    """Decode attends to the cache's first ``pos + 1`` rows with one
    end-aligned query row; the reference masks the whole cache past
    ``pos`` instead.  The two are one function."""
    s_max = 160
    (jq, jk, jv), (tq, tk, tv) = _inputs((2, 8, 2, 1, s_max, 64), dtype, 3)
    pos = skv - 1
    want = j_attn.attention_scores(jq, jk, jv, causal_offset=pos,
                                   kv_len_valid=pos + 1)
    got = ops.flash_attention(tq, tk[:, :skv], tv[:, :skv], causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("case", [
    dict(causal_offset=0), dict(causal_offset=0, window=16, cap=30.0),
    dict(causal_offset=5, kv_len_valid=40),
    dict(causal_offset=0, kv_len_valid=9, rolling=True)])
def test_attention_scores_matches_reference(case):
    """The models' plain ``attention_scores`` (kept beside the kernel
    path) against the reference's."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((2, 8, 2, 32, 48, 32), "float32",
                                         4)
    if case["causal_offset"] == 0 and "kv_len_valid" not in case:
        jk, jv, tk, tv = jk[:, :32], jv[:, :32], tk[:, :32], tv[:, :32]
    want = j_attn.attention_scores(jq, jk, jv, **case)
    got = t_attn.attention_scores(tq, tk, tv, **case)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_kernel_wrapper_refuses_cpu_tensors_and_missing_nvcc(
        monkeypatch, tmp_path):
    """The CUDA wrapper takes no CPU tensor (``ops`` sends those to the
    plain version), and the build raises when no ``nvcc`` is found."""
    _, (tq, tk, tv) = _inputs(SHAPES[0], "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention(tq, tk, tv)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.find_nvcc()
