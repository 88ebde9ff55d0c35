"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's: the plain version (the kernel's oracle and CPU
path) against ``repro.kernels.flash_attention.ref.attention_ref`` on every
shape x feature x dtype of ``tests/test_kernels.py``, some of them also
against the Pallas kernel in interpret mode, the decode shapes (one query
row against 1, 37 and 129 keys), and the cache-slice attention the
models' decode takes against the reference's masked full-cache
``attention_scores``.

Tolerances are the reference's own: rtol = atol = 2e-5 in float32 and
2e-2 in bfloat16.  The CUDA kernels' own tests against the plain version
need the card and no JAX, so they live in ``tests/test_torch_cuda.py``.

The CUDA wrapper's dispatch is plain Python and runs here: ``kernel.plan``
on the serving paths' shapes and on edge shapes (the body, the split
count, every key in exactly one non-empty split).  So do the split
decode's arithmetic, mirrored in plain PyTorch (``ref.split_decode_ref``:
split, then merge in split order), against both plain attentions at
float32 1e-6, and the card's coverage probe (``ref.probe_*``) on the plain
version, where a key left out of the mask must show.
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
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, probe_expected, probe_faults, probe_inputs, probe_keys,
    split_decode_ref, visible as ref_visible)
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


# ------------------------------------------------- the kernels' dispatch
# (B, H, Hkv, Sq, Skv, hd, window) of the serving paths: Qwen3-8B,
# granite-moe-3b-a800m and recurrentgemma-9b, prefill and decode
PATH_SHAPES = {
    "qwen3 prefill": ((4, 32, 8, 2048, 2048, 128, 0), "tc_prefill", 1),
    "qwen3 decode": ((4, 32, 8, 1, 2049, 128, 0), "split_decode", 9),
    "qwen3 last decode": ((4, 32, 8, 1, 2080, 128, 0), "split_decode", 9),
    "granite prefill": ((4, 24, 8, 2048, 2048, 64, 0), "tc_prefill", 1),
    "granite decode": ((4, 24, 8, 1, 2049, 64, 0), "split_decode", 9),
    "recurrentgemma prefill": ((4, 16, 1, 2048, 2048, 256, 2048),
                               "tc_prefill", 1),
    "recurrentgemma ring decode": ((4, 16, 1, 1, 2048, 256, 0),
                                   "split_decode", 32),
    "gemma-2 local prefill": ((1, 16, 8, 4608, 4608, 256, 4096),
                              "tc_prefill", 1),
}
# edge shapes: float32 never takes the tensor cores; bf16 at head dims 16
# and 32, or with rows between a decode block and a tensor-core tile,
# takes the float32 body
EDGE_SHAPES = {
    "one key": ((2, 8, 2, 1, 1, 64, 0), "bfloat16", "split_decode", 1),
    "short prompt over a cache": ((1, 2, 1, 5, 5, 32, 0), "bfloat16",
                                  "split_decode", 1),
    "64 decode rows": ((1, 16, 1, 4, 300, 256, 0), "bfloat16",
                       "split_decode", 3),
    "65 rows, too few for a tile": ((1, 13, 1, 5, 300, 64, 0), "bfloat16",
                                    "fp32_prefill", 1),
    "head dim 16": ((2, 4, 4, 128, 128, 16, 0), "bfloat16", "fp32_prefill",
                    1),
    "float32 prefill": ((4, 32, 8, 2048, 2048, 128, 0), "float32",
                        "fp32_prefill", 1),
    "float32 decode": ((4, 32, 8, 1, 2049, 128, 0), "float32",
                       "split_decode", 9),
    "rows not a tile multiple": ((1, 4, 2, 96, 300, 256, 0), "bfloat16",
                                 "tc_prefill", 1),
    "windowed decode": ((2, 8, 2, 1, 500, 64, 100), "bfloat16",
                        "split_decode", 1),
    "windowed decode, long window": ((2, 8, 2, 1, 5000, 64, 1000),
                                     "bfloat16", "split_decode", 8),
    "many kv heads": ((8, 64, 64, 1, 4096, 128, 0), "bfloat16",
                      "split_decode", 1),
}


def _plan(shape, dtype):
    b, h, hkv, sq, skv, hd, window = shape
    return kernel.plan((b, sq, h, hd), (b, skv, hkv, hd), dtype,
                       window=window)


def _assert_splits_cover(shape, p):
    """Every key some row sees lies in exactly one split; none is empty."""
    b, h, hkv, sq, skv, hd, window = shape
    want = ref_visible(sq, skv, window=window).any(dim=0).nonzero()[:, 0]
    assert (p.kv_lo, p.kv_hi) == (int(want[0]), int(want[-1]) + 1)
    seen = []
    for s in range(p.splits):
        lo = p.kv_lo + s * p.chunk
        keys = list(range(lo, min(lo + p.chunk, p.kv_hi)))
        assert keys, f"split {s} of {p} is empty"
        seen += keys
    assert seen == want.tolist()


@pytest.mark.parametrize("name", list(PATH_SHAPES))
def test_plan_on_the_serving_paths(name):
    shape, body, splits = PATH_SHAPES[name]
    p = _plan(shape, torch.bfloat16)
    assert (p.body, p.splits) == (body, splits)
    if body == "split_decode":
        _assert_splits_cover(shape, p)
        # the grid covers the 132 SMs at least twice, or every split
        # holds the fewest keys a split may
        b, hkv = shape[0], shape[2]
        assert (p.splits * b * hkv >= 2 * kernel.H100_SMS
                or p.chunk == kernel.MIN_SPLIT_KEYS)


@pytest.mark.parametrize("name", list(EDGE_SHAPES))
def test_plan_on_edge_shapes(name):
    shape, dtype, body, splits = EDGE_SHAPES[name]
    p = _plan(shape, DTYPES[dtype][1])
    assert (p.body, p.splits) == (body, splits)
    if body == "split_decode":
        _assert_splits_cover(shape, p)


# the split decode's coverage probes on the card (chip_smoke.py and
# tests/test_torch_cuda.py): every one of them must take split_decode
DECODE_PROBE_SHAPES = (
    [(4, 32, 8, sq, 2049, 128, 0) for sq in (1, 4, 7)]
    + [(b, 24, 8, sq, 2049, 64, 0) for b in (2, 4) for sq in (1, 4, 7)]
    + [(2, 32, 8, sq, 2049, 128, 0) for sq in (1, 4, 7)]
    + [(4, 16, 1, sq, 2048, 256, 0) for sq in (1, 4)]
    + [(1, 16, 8, sq, 4608, 256, 4096) for sq in (1, 4, 7)]
    + [(2, 16, 1, 1, 700, 256, 0), (2, 16, 1, 4, 2048, 256, 0),
       (1, 16, 8, 1, 1100, 256, 1000), (1, 16, 8, 7, 1100, 256, 1000),
       (1, 12, 4, 5, 333, 64, 100)])


@pytest.mark.parametrize("shape", DECODE_PROBE_SHAPES)
def test_plan_of_the_decode_probes(shape):
    p = _plan(shape, torch.bfloat16)
    assert p.body == "split_decode"
    assert shape[5] in kernel.TC_HEAD_DIMS     # the tensor-core split
    _assert_splits_cover(shape, p)


@pytest.mark.parametrize("skv", [1, 2, 31, 63, 64, 65, 127, 2049, 4096])
@pytest.mark.parametrize("b,hkv", [(1, 1), (4, 1), (4, 8), (64, 8)])
@pytest.mark.parametrize("window", [0, 16])
def test_split_keys_cover_every_key_once(skv, b, hkv, window):
    p = kernel.Plan("split_decode", *kernel.split_keys(b, hkv, 1, skv,
                                                       window))
    _assert_splits_cover((b, hkv, hkv, 1, skv, 64, window), p)
    assert p.chunk >= kernel.MIN_SPLIT_KEYS
    assert p.chunk % kernel.SPLIT_ALIGN == 0


# --------------------------------- the split decode's arithmetic, mirrored
MIRROR_FEATS = [dict(), dict(window=16), dict(softcap=30.0)]


def _mirror_inputs(b, hkv, group, sq, skv, hd, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, sq, hkv * group, hd)),
            rng.normal(size=(b, skv, hkv, hd)),
            rng.normal(size=(b, skv, hkv, hd))]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


def _mirror(q, k, v, splits_of=None, **feat):
    """The split mirror in the models' layout, split as the plan splits."""
    b, sq, _, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    splits, chunk, lo, hi = (splits_of or kernel.split_keys)(
        b, hkv, sq, skv, feat.get("window", 0))
    out = split_decode_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), splits=splits, chunk=chunk,
                           kv_lo=lo, kv_hi=hi, **feat)
    return out.transpose(1, 2), (splits, hi - lo)


@pytest.mark.parametrize("feat", MIRROR_FEATS, ids=["plain", "window",
                                                    "softcap"])
@pytest.mark.parametrize("sq", [1, 2, 7])
@pytest.mark.parametrize("group", [1, 3, 4, 16])
@pytest.mark.parametrize("skv", [1, 63, 64, 65, 2049])
def test_split_mirror_matches_both_refs(skv, group, sq, feat):
    """Split, then merge in split order: the plain attention and the
    reference's, at float32 1e-6."""
    if sq > skv:
        sq = skv
    # few (batch row, kv head) pairs, so long rows take many splits
    q, k, v = _mirror_inputs(1, 2, group, sq, skv, 32, skv + 7 * group + sq)
    got, (splits, n) = _mirror(q, k, v, **feat)
    # rows of 64 keys or more are split
    assert (splits > 1) == (n >= 2 * kernel.MIN_SPLIT_KEYS)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), **feat).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    j_want = j_ref(*(jnp.swapaxes(jnp.asarray(x.numpy()), 1, 2)
                     for x in (q, k, v)), **feat)
    np.testing.assert_allclose(got.numpy(), _np(jnp.swapaxes(j_want, 1, 2)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos", [5, 63, 64, 200])
@pytest.mark.parametrize("group", [1, 16])
def test_split_mirror_reads_a_ring(pos, group):
    """Decode at position ``pos`` over a 64-row ring (written in place by
    the models' ``ring_write``, read as its first ``min(pos + 1, 64)``
    rows) against the reference's rolling full-ring attention."""
    size, b, hkv, hd = 64, 2, 1, 32
    q, k, v = _mirror_inputs(b, hkv, group, 1, pos + 1, hd, pos + group)
    k_ring = torch.zeros((b, size, hkv, hd))
    v_ring = torch.zeros((b, size, hkv, hd))
    t_attn.ring_write(k_ring, k, 0)
    t_attn.ring_write(v_ring, v, 0)
    n = min(pos + 1, size)
    got, _ = _mirror(q, k_ring[:, :n], v_ring[:, :n])
    want = j_attn.attention_scores(
        *(jnp.asarray(x.numpy()) for x in (q, k_ring, v_ring)),
        causal_offset=0, kv_len_valid=n, rolling=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,window", [
    ((2, 8, 2, 40, 40, 16), 0), ((1, 4, 1, 7, 70, 32), 16),
    ((2, 6, 3, 130, 130, 16), 64), ((2, 12, 4, 7, 70, 16), 0),
    ((1, 16, 1, 4, 90, 32), 0), ((2, 6, 3, 1, 65, 16), 20)])
def test_coverage_probe_sees_a_dropped_key(shape, window):
    """The card's coverage probe on the plain version: no fault, and a
    key removed from the mask shows up as faults."""
    b, h, hkv, sq, skv, hd = shape
    feat = dict(causal=True, window=window)
    passes = -(-skv // (b * hkv * hd))
    for sweep in range(passes):
        keys = probe_keys(b, hkv, hd, skv, sweep)
        q, k, v = probe_inputs(b, h, hkv, sq, skv, hd, keys, torch.bfloat16)
        out = ops.flash_attention(q, k, v, **feat)
        want = probe_expected(keys, sq, skv, h, **feat)
        assert probe_faults(out, want) == 0
        # drop the probe key of column 0 (batch row 0, kv head 0)
        j = int(keys[0, 0, 0])
        if j >= 0 and bool(ref_visible(sq, skv, **feat)[-1, j]):
            v2 = v.clone()
            v2[0, j, 0, 0] = 0
            assert probe_faults(ops.flash_attention(q, k, v2, **feat),
                                want) > 0


@pytest.mark.parametrize("shape", [(2, 32, 8, 7, 300, 128),
                                   (2, 16, 1, 4, 256, 256),
                                   (2, 24, 8, 1, 129, 64)])
def test_row_mapping_check_sees_a_swap(shape):
    """The card's q x 4 decode check on the plain version: it passes, and
    an output whose rows took another query head's (same kv head) or
    another query row's output fails bf16's 2e-2."""
    b, h, hkv, sq, skv, hd = shape
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    q = (4 * q.float()).to(torch.bfloat16)
    want = ops.flash_attention(q, k, v).float()
    close = lambda got: bool(
        ((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())
    assert close(ops.flash_attention(q, k, v).float())
    assert not close(want[:, :, [1, 0] + list(range(2, h))])
    if sq > 1:
        assert not close(want[:, [1, 0] + list(range(2, sq))])
